// SHA-256 compression over pre-padded messages, one CUDA thread per message.
//
// Replaces the Pallas kernel plenum_tpu/ops/sha256_pallas.py::_sha256_kernel
// (built by _build_sha256, entered through sha256_blocks). Same function:
// words [B, nblocks, 16] big-endian uint32 (from pad_messages) plus the
// per-message block count nvalid [B] give the digest state [B, 8] uint32.
// The TPU kernel ran every row through all `nblocks` blocks and masked the
// state of rows whose message had ended; here each thread simply loops over
// its own min(nvalid[i], nblocks) blocks, which gives the same digest.
//
// Bound on this card: operations. A compression is ~2,000 32-bit integer
// ops (64 rounds of Sigma/Ch/Maj/adds plus 48 schedule words) for 64 bytes
// read, far above the H100's ~5 int32 ops per byte of memory bandwidth.
// Design: the 8 state words and a rolling 16-word schedule window live in
// registers (the 64 rounds are fully unrolled so every window index is a
// compile-time constant), K sits in __constant__ memory (uniform index
// across the warp: a broadcast), rotations are single funnel shifts, and
// each block's 64 bytes are read as four 16-byte loads.
#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

__constant__ uint32_t SHA256_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One compression of `w` (16 message words, consumed as the schedule
// window) into `st`.
__device__ __forceinline__ void sha256_compress_block(uint32_t st[8],
                                                      uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + SHA256_K[t] + wt;
    uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The digest state of message `i`: its first min(nvalid, nblocks) blocks.
// `words` points at the message's first block (nblocks * 16 words, 16-byte
// aligned).
__device__ __forceinline__ void sha256_message(const uint4* words, int nvalid,
                                               int nblocks, uint32_t st[8]) {
  st[0] = 0x6a09e667; st[1] = 0xbb67ae85; st[2] = 0x3c6ef372;
  st[3] = 0xa54ff53a; st[4] = 0x510e527f; st[5] = 0x9b05688c;
  st[6] = 0x1f83d9ab; st[7] = 0x5be0cd19;
  int nb = nvalid < nblocks ? nvalid : nblocks;
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4 v = words[blk * 4 + q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    sha256_compress_block(st, w);
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(256)
sha256_compress_kernel(const uint4* __restrict__ words,
                       const int32_t* __restrict__ nvalid,
                       uint4* __restrict__ out, int B, int nblocks) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t st[8];
  sha256_message(words + (size_t)i * nblocks * 4, nvalid[i], nblocks, st);
  out[2 * (size_t)i] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * (size_t)i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// words: [B, nblocks, 16] uint32; nvalid: [B] int32; out: [B, 8] uint32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sha256_compress(const void* words, const void* nvalid,
                               void* out, int B, int nblocks, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  int blocks = (B + threads - 1) / threads;
  sha256_compress_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (const int32_t*)nvalid, (uint4*)out, B, nblocks);
  return (int)cudaGetLastError();
}
#endif
