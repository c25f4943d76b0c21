// SHA3-256 on the card, one CUDA thread per message, with two entry points
// that share the absorb and the permutation (sha3_message):
//
// sha3_ragged: raw messages → [B, 32] digests.
// sha3_ragged_eq: raw messages and [B, 32] expected digests → [B] verdicts
// (1 where the digest equals its ref); only the verdict leaves the card.
//
// Replaces the XLA device program plenum_tpu/ops/sha3.py::_sha3_blocks
// (on _keccak_f / _keccak_round) and its fused compare
// plenum_tpu/ops/trie_jax.py::_sha3_blocks_eq, which hash the MPT node
// levels of the state engine. The JAX program took host-padded half-lane
// words [B, nblocks, 17, 2] uint32 (pad_sha3_messages: nblocks rounded up
// to a power of two, the batch padded to a power of two for XLA's compile
// cache) and split every 64-bit lane into (hi, lo) uint32 halves, because
// the TPU's vector unit is 32-bit. Here the input is the flat byte buffer
// of all messages and their offsets [B + 1]; each thread pads its own
// message in registers (0x06 after the last byte, 0x80 in the last byte
// of the 136-byte rate, the two may share a byte), absorbs exactly
// len / 136 + 1 blocks, and keeps the 25 lanes as native 64-bit values.
// The launch takes exactly B rows.
//
// Bound on this card: operations. A Keccak-f[1600] permutation is 24
// rounds of theta, rho, pi, chi and iota over 25 64-bit lanes, ~4,600
// 32-bit instructions (each 64-bit xor or and-not is two LOP3s, each
// rotation two funnel shifts) for 136 bytes read. The MPT levels it
// serves are 128 to a few thousand rows of 1-block leaves and ~4-block
// branch nodes, so a launch is latency-bound and fills only part of the
// card; this first kernel keeps the whole state in registers (every lane
// index is a compile-time constant: the lane loops are unrolled, the
// round loop is not) and reads the message bytewise.
#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define SHA3_RATE 136
#define SHA3_THREADS 128

#ifdef __CUDACC__
__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// n is a compile-time constant in 1..63 at every use
#define ROTL(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
  uint64_t b[25], c[5], d[5];
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    // theta
#pragma unroll
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ ROTL(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    // rho and pi: b[y + 5 * ((2x + 3y) % 5)] = rotl(a[x + 5y], rho[x][y])
    b[0] = a[0];
    b[16] = ROTL(a[5], 36);
    b[7] = ROTL(a[10], 3);
    b[23] = ROTL(a[15], 41);
    b[14] = ROTL(a[20], 18);
    b[10] = ROTL(a[1], 1);
    b[1] = ROTL(a[6], 44);
    b[17] = ROTL(a[11], 10);
    b[8] = ROTL(a[16], 45);
    b[24] = ROTL(a[21], 2);
    b[20] = ROTL(a[2], 62);
    b[11] = ROTL(a[7], 6);
    b[2] = ROTL(a[12], 43);
    b[18] = ROTL(a[17], 15);
    b[9] = ROTL(a[22], 61);
    b[5] = ROTL(a[3], 28);
    b[21] = ROTL(a[8], 55);
    b[12] = ROTL(a[13], 25);
    b[3] = ROTL(a[18], 21);
    b[19] = ROTL(a[23], 56);
    b[15] = ROTL(a[4], 27);
    b[6] = ROTL(a[9], 20);
    b[22] = ROTL(a[14], 39);
    b[13] = ROTL(a[19], 8);
    b[4] = ROTL(a[24], 14);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; x++)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    // iota
    a[0] ^= KECCAK_RC[r];
  }
}

// Lane `lane` (0..16) of block `blk` of the padded message msg[0:len]:
// eight bytes little-endian, the message's own where they exist, then
// 0x06 at offset len and 0x80 xored into the rate's last byte of the
// last block (offset `last`).
__device__ __forceinline__ uint64_t padded_lane(const uint8_t* msg,
                                                int64_t len, int64_t last,
                                                int64_t pos) {
  uint64_t v = 0;
  if (pos + 8 <= len) {
#pragma unroll
    for (int k = 0; k < 8; k++) v |= (uint64_t)msg[pos + k] << (8 * k);
    return v;
  }
#pragma unroll
  for (int k = 0; k < 8; k++) {
    int64_t p = pos + k;
    uint32_t byte = p < len ? msg[p] : 0u;
    if (p == len) byte ^= 0x06u;
    if (p == last) byte ^= 0x80u;
    v |= (uint64_t)byte << (8 * k);
  }
  return v;
}

// SHA3-256 of msg[0:len]: absorbs len / 136 + 1 blocks; the digest is
// lanes 0..3, little-endian.
__device__ __forceinline__ void sha3_message(const uint8_t* msg, int64_t len,
                                             uint64_t a[25]) {
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0;
  int64_t nblocks = len / SHA3_RATE + 1;
  int64_t last = nblocks * SHA3_RATE - 1;
  for (int64_t blk = 0; blk < nblocks; blk++) {
    int64_t base = blk * SHA3_RATE;
#pragma unroll
    for (int l = 0; l < SHA3_RATE / 8; l++)
      a[l] ^= padded_lane(msg, len, last, base + 8 * l);
    keccak_f(a);
  }
}

__global__ void __launch_bounds__(SHA3_THREADS)
sha3_ragged_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ offsets,
                   uint64_t* __restrict__ out, int B) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int64_t lo = offsets[i];
  uint64_t a[25];
  sha3_message(data + lo, offsets[i + 1] - lo, a);
#pragma unroll
  for (int l = 0; l < 4; l++) out[4 * (size_t)i + l] = a[l];
}

__global__ void __launch_bounds__(SHA3_THREADS)
sha3_ragged_eq_kernel(const uint8_t* __restrict__ data,
                      const int64_t* __restrict__ offsets,
                      const uint64_t* __restrict__ refs,
                      uint8_t* __restrict__ ok, int B) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int64_t lo = offsets[i];
  uint64_t a[25];
  sha3_message(data + lo, offsets[i + 1] - lo, a);
  uint64_t diff = 0;
#pragma unroll
  for (int l = 0; l < 4; l++) diff |= a[l] ^ refs[4 * (size_t)i + l];
  ok[i] = diff == 0;
}

// data: [nbytes] uint8; offsets: [B + 1] int64, 0 <= offsets[i] <=
// offsets[i + 1] <= nbytes (the wrapper checks); out: [B, 32] uint8,
// 8-byte aligned. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int sha3_ragged(const void* data, const void* offsets, void* out,
                           int B, void* stream) {
  if (B <= 0) return 0;
  int blocks = (B + SHA3_THREADS - 1) / SHA3_THREADS;
  sha3_ragged_kernel<<<blocks, SHA3_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)offsets, (uint64_t*)out, B);
  return (int)cudaGetLastError();
}

// As sha3_ragged, with refs: [B, 32] uint8, 8-byte aligned, and ok: [B]
// bytes (a torch.bool tensor), 1 where the digest equals its ref.
extern "C" int sha3_ragged_eq(const void* data, const void* offsets,
                              const void* refs, void* ok, int B,
                              void* stream) {
  if (B <= 0) return 0;
  int blocks = (B + SHA3_THREADS - 1) / SHA3_THREADS;
  sha3_ragged_eq_kernel<<<blocks, SHA3_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)offsets, (const uint64_t*)refs,
      (uint8_t*)ok, B);
  return (int)cudaGetLastError();
}
#endif
