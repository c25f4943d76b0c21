// SHA-256 on the card, with four entry points that share the compression
// (sha256_compress_block_t, its adds routed by what bounds each kernel):
//
// sha256_compress: pre-padded messages, one thread per message (see
// sha256_compress_kernel). Replaces the Pallas kernel
// plenum_tpu/ops/sha256_pallas.py::_sha256_kernel (built by
// _build_sha256, entered through sha256_blocks). Same function: words
// [B, nblocks, 16] big-endian uint32 (from pad_messages) plus the
// per-message block count nvalid [B] give the digest state [B, 8] uint32.
// The TPU kernel ran every row through all `nblocks` blocks and masked the
// state of rows whose message had ended; here each thread compresses its
// own min(nvalid[i], nblocks) blocks, which gives the same digest. Since
// the Merkle levels moved to sha256_node_levels nothing on the port's
// paths calls it; it stays as the literal counterpart of the TPU kernel.
//
// sha256_ragged: raw messages, padded here. The input is the flat byte
// buffer of all messages, their offsets [B + 1] and an optional one-byte
// domain prefix (RFC 6962's 0x00 for leaves, 0x01 for nodes). The TPU
// path padded every message on the host to a power-of-two block bucket
// (its compile cache needed one shape); the host then spent more time
// padding and copying the padded words than the card spent hashing them.
// Here each thread builds its message's blocks in registers: the prefix,
// the bytes realigned from aligned 32-bit loads (__funnelshift_r, then a
// __byte_perm to big-endian), 0x80, zeros and the 64-bit bit length, and
// hashes exactly ceil((prefix + len + 9) / 64) blocks. The bytes reach
// the threads through shared memory, staged by the warp with coalesced
// 16-byte loads (see sha256_ragged_kernel). Offsets are checked here, not
// by a read-back before the launch: a row whose offsets are negative,
// decreasing or past nbytes sets the error word in the output's 16-byte
// tail and is hashed as empty; no load leaves data[0:nbytes]. With
// big_endian it writes each digest as its 32 big-endian bytes instead (the
// leaf level of a device Merkle tree, in place).
//
// sha256_node_levels: the RFC 6962 tree levels above a level of 32-byte
// digests, up to NODE_LEVELS levels a launch (see
// sha256_node_levels_kernel).
//
// sha256_append_groups: the new parents of every level of an append to a
// growing tree, in groups of up to APPEND_LEVELS_MAX levels, written in
// place, windows at any offset; one C call enqueues every launch (see
// sha256_append_levels_kernel).
//
// Bound on this card: operations. A compression is ~1,400 32-bit integer
// instructions (64 rounds of Sigma/Ch/Maj/adds plus 48 schedule words) for
// 64 bytes read, far above the H100's ~10 int32 operations per byte of
// memory bandwidth. The 8 state words and a rolling 16-word schedule
// window live in registers (the 64 rounds are fully unrolled so every
// window index is a compile-time constant), K sits in __constant__ memory
// (uniform index across the warp: a broadcast), rotations are single
// funnel shifts.
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

// 1, kept where the compiler cannot see it: a multiply-add by it is an
// IMAD, which issues on the FMA pipe, beside the ALU pipe that runs the
// IADD3, LOP3 and SHF of the rounds.
__constant__ uint32_t SHA256_ONE = 1;

// a + b as an IMAD (a * 1 + b) on the FMA pipe.
__device__ __forceinline__ uint32_t add_fma(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(SHA256_ONE),
      "r"(b));
  return r;
#else
  return a * SHA256_ONE + b;
#endif
}

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// Which adds of the compression go to the FMA pipe as IMADs (add_fma):
// ADDS_ALU none (the compiler's three-input IADD3s on the ALU pipe, beside
// 6 SHF and 4 LOP3 a round); ADDS_ALL every add but h + K (e = d + t1,
// a = t1 + S0 + maj, t1's other adds and the schedule's three a word). A
// round's SHF and LOP3 cannot move, so the ALU pipe keeps at least 10
// instructions a round.
//
// Each kernel routes its adds by what bounds it, as
// plenum_tpu_torch/sha256_ceilings.py measured on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md): a launch of many messages is bound by the ALU
// pipe's issue, and moving every add to the FMA pipe cut sha256_compress
// from 0.095 to 0.080 ms at 2^19 messages x 2 blocks and sha256_ragged by
// 16%, so both use ADDS_ALL; one node hash on one warp is bound by its
// dependent chain, which an IMAD's longer latency lengthens (2.8 us a
// node with the adds on the ALU, 3.6 with IMADs), so the Merkle levels
// and the append use ADDS_ALU (sha256_compress_block).
enum { ADDS_ALU = 0, ADDS_ALL = 1 };

// One compression of `w` (16 message words, consumed as the schedule
// window) into `st`, its adds routed by ADDS.
template <int ADDS>
__device__ __forceinline__ void sha256_compress_block_t(uint32_t st[8],
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
      if (ADDS == ADDS_ALL)
        wt = add_fma(add_fma(add_fma(w[t & 15], s0), w[(t - 7) & 15]), s1);
      else
        wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    if (ADDS == ADDS_ALL) {
      const uint32_t t1 =
          add_fma(add_fma(add_fma(h + SHA256_K[t], wt), S1), ch);
      h = g; g = f; f = e;
      e = add_fma(d, t1);
      d = c; c = b; b = a; a = add_fma(add_fma(t1, S0), maj);
    } else {
      const uint32_t t1 = h + S1 + ch + SHA256_K[t] + wt;
      h = g; g = f; f = e;
      e = d + t1;
      d = c; c = b; b = a; a = t1 + S0 + maj;
    }
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// One compression with the adds on the ALU: a node hash's.
__device__ __forceinline__ void sha256_compress_block(uint32_t st[8],
                                                      uint32_t w[16]) {
  sha256_compress_block_t<ADDS_ALU>(st, w);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// The big-endian words of the 32-byte digest at `p` (16-byte aligned).
__device__ __forceinline__ void load_digest(const uint8_t* p, uint32_t d[8]) {
  const uint4 a = __ldg((const uint4*)p), b = __ldg((const uint4*)p + 1);
  d[0] = bswap32(a.x); d[1] = bswap32(a.y); d[2] = bswap32(a.z);
  d[3] = bswap32(a.w); d[4] = bswap32(b.x); d[5] = bswap32(b.y);
  d[6] = bswap32(b.z); d[7] = bswap32(b.w);
}

// The digest state `st` stored as its 32 big-endian bytes at `p`.
__device__ __forceinline__ void store_digest(uint8_t* p, const uint32_t st[8]) {
  ((uint4*)p)[0] = make_uint4(bswap32(st[0]), bswap32(st[1]), bswap32(st[2]),
                              bswap32(st[3]));
  ((uint4*)p)[1] = make_uint4(bswap32(st[4]), bswap32(st[5]), bswap32(st[6]),
                              bswap32(st[7]));
}

#define RAGGED_THREADS 256
#define STAGE_VECS 5       // 80 bytes: one block's 64 bytes at any 16-byte phase

// The 16 bytes at `a` (a multiple of 16) of a buffer of `nbytes` bytes,
// little-endian words; bytes outside the buffer read as zero.
__device__ __forceinline__ uint4 load16(const uint8_t* data, int64_t a,
                                        int64_t nbytes) {
  if (a >= 0 && a + 16 <= nbytes) return __ldg((const uint4*)(data + a));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (a + b >= 0 && a + b < nbytes)
      w[b >> 2] |= (uint32_t)data[a + b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Thread i hashes prefix || data[offsets[i]:offsets[i + 1]] (no prefix when
// prefix < 0) into row i of `out`: the digest state's 8 words, or with
// big_endian its 32 big-endian bytes (a digest as the Merkle levels hold
// it, so that a tree's leaf level is written in place); invalid offsets set
// *err and hash the row as empty. Byte p of its padded message is
// data[origin + p] for p in
// [plen, total). Block by block, the warp first stages the next 80 aligned
// bytes of each of its 32 messages in shared memory, five lanes to a
// message with one 16-byte load each, six messages per load instruction:
// neighbouring lanes read neighbouring addresses. Then each thread reads
// its own 17 words back, realigns them to its message with a funnel shift,
// turns them big-endian and masks in the prefix, 0x80 and the bit length.
__global__ void __launch_bounds__(RAGGED_THREADS)
sha256_ragged_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
                     const int64_t* __restrict__ offsets, int prefix,
                     uint4* __restrict__ out, uint32_t* __restrict__ err,
                     int B, int big_endian) {
  __shared__ uint4 stage[RAGGED_THREADS][STAGE_VECS];
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x - lane;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < B;      // lanes past B take part in the staging
  int64_t start = live ? offsets[i] : 0;
  int64_t end = live ? offsets[i + 1] : 0;
  if (start < 0 || end < start || end > nbytes) {
    atomicOr(err, 1u);            // reported by the host's copy of the tail
    start = end = 0;
  }
  const int64_t plen = prefix >= 0 ? 1 : 0;
  const int64_t total = plen + end - start;    // message bytes hashed
  const int nb = live ? (int)((total + 9 + 63) / 64) : 0;
  int nb_warp = nb;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    nb_warp = max(nb_warp, __shfl_xor_sync(0xffffffffu, nb_warp, o));
  const int64_t origin = start - plen;
  const int64_t base16 = origin & ~(int64_t)15;
  const int phase = (int)(origin - base16);
  const int q = lane % STAGE_VECS, mo = lane / STAGE_VECS;

  uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  for (int blk = 0; blk < nb_warp; ++blk) {
    for (int j = 0; j < 32; j += 6) {
      const int m = j + mo;
      const int src = m < 32 ? m : 31;
      const int64_t b_m = __shfl_sync(0xffffffffu, base16, src);
      const int nb_m = __shfl_sync(0xffffffffu, nb, src);
      if (mo < 6 && m < 32 && blk < nb_m)
        stage[warp0 + m][q] = load16(data, b_m + 64 * blk + 16 * q, nbytes);
    }
    __syncwarp();
    if (blk < nb) {
      const uint32_t* sw = (const uint32_t*)&stage[threadIdx.x][0];
      const int wo = phase >> 2, sh = phase & 3;
      uint32_t L[17];
#pragma unroll
      for (int k = 0; k < 17; ++k) L[k] = sw[wo + k];
      const int64_t p_blk = 64 * (int64_t)blk;
      uint32_t w[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int64_t p0 = p_blk + 4 * k;
        uint32_t le = __funnelshift_r(L[k], L[k + 1], 8 * sh);
        uint32_t be = __byte_perm(le, 0, 0x0123);
        // keep the bytes b (0 = most significant) with p0 + b in
        // [plen, total)
        int64_t ks = plen - p0, ke = total - p0;
        int kstart = ks < 0 ? 0 : (ks > 4 ? 4 : (int)ks);
        int kend = ke < 0 ? 0 : (ke > 4 ? 4 : (int)ke);
        be &= (uint32_t)(0xFFFFFFFFull >> (8 * kstart));
        be &= (uint32_t)((0xFFFFFFFFull << 32) >> (8 * kend));
        if (plen && p0 == 0) be |= (uint32_t)prefix << 24;
        if (ke >= 0 && ke < 4) be |= 0x80u << (24 - 8 * ke);
        w[k] = be;
      }
      if (blk == nb - 1) {
        uint64_t bits = (uint64_t)total * 8;
        w[14] = (uint32_t)(bits >> 32);
        w[15] = (uint32_t)bits;
      }
      sha256_compress_block_t<ADDS_ALL>(st, w);
    }
    __syncwarp();
  }
  if (live && big_endian) {
    store_digest((uint8_t*)(out + 2 * (size_t)i), st);
  } else if (live) {
    out[2 * (size_t)i] = make_uint4(st[0], st[1], st[2], st[3]);
    out[2 * (size_t)i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
  }
}

#define NODE_THREADS 256
#define NODE_LEVELS 9    // levels a launch climbs: a CTA's 512 children → 1

// st = H(0x01 || l || r) for the big-endian digest words l and r. Block 1
// is the prefix byte and the first 63 message bytes, each word shifted by
// one byte (as plenum_tpu/ops/merkle.py::_node_blocks forms it); block 2
// is r's last byte, 0x80, zeros and the bit length 520, written as
// literals so that nvcc folds the zero words out of the rounds and the
// schedule.
__device__ __forceinline__ void node_block1(const uint32_t l[8],
                                            const uint32_t r[8],
                                            uint32_t w[16]) {
  w[0] = (0x01u << 24) | (l[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; ++k) w[k] = __funnelshift_r(l[k], l[k - 1], 8);
  w[8] = __funnelshift_r(r[0], l[7], 8);
#pragma unroll
  for (int k = 1; k < 8; ++k) w[8 + k] = __funnelshift_r(r[k], r[k - 1], 8);
}

__device__ __forceinline__ void sha256_node(const uint32_t l[8],
                                            const uint32_t r[8],
                                            uint32_t st[8]) {
  st[0] = 0x6a09e667; st[1] = 0xbb67ae85; st[2] = 0x3c6ef372;
  st[3] = 0xa54ff53a; st[4] = 0x510e527f; st[5] = 0x9b05688c;
  st[6] = 0x1f83d9ab; st[7] = 0x5be0cd19;
  uint32_t w[16];
  node_block1(l, r, w);
  sha256_compress_block(st, w);
  uint32_t tail[16] = {(r[7] << 24) | 0x00800000u, 0, 0, 0, 0, 0, 0, 0,
                       0, 0, 0, 0, 0, 0, 0, 65 * 8};
  sha256_compress_block(st, tail);
}

// Levels 1..levels (levels <= NODE_LEVELS) above the n digests at `in`
// ([n, 32] bytes, 16-byte aligned): parent i of a level of m nodes is
// H(0x01 || child 2i || child 2i + 1) for i < m / 2 (an odd last child has
// no parent), so level k holds n >> k nodes. `out` receives the levels one
// after another as 32-byte big-endian digests.
//
// Replaces the Merkle level build of the JAX package: the Pallas kernel
// plenum_tpu/ops/sha256_pallas.py::_sha256_kernel at nblocks = 2, fed by
// plenum_tpu/ops/merkle.py::_node_blocks / _hash_pairs one level at a
// time inside _build_levels_from_digest_bytes. The port's first version
// built the two blocks of every pair as int64 tensors on the card (~2 GB
// of passes at the 2^19-pair level, about ten times the compression they
// fed) and launched sha256_compress once per level with a copy in and out
// each time.
//
// Design. A CTA of 256 threads owns 512 consecutive children, so its
// subtree depends on no other CTA. Thread t reads children 2t and 2t + 1
// (64 bytes, four 16-byte loads; neighbouring threads read neighbouring
// spans), forms both blocks in registers and writes parent t to the
// global output and to shared memory. Then 128 threads hash the next
// level from shared memory, 64 the one after, and so on up to nine
// levels: the parents never leave the SM between levels. Shared memory
// holds the words transposed, sh[word][parent], in two buffers used by
// turns: a thread reads word j of its two children as one 8-byte load
// (children 2t and 2t + 1 sit side by side), which a half-warp serves
// without a bank conflict, and it writes its parent word by word at
// consecutive addresses. Below 32 parents a level is one warp, which
// needs only __syncwarp; the other warps return.
//
// Bound: operations. A node is two compressions (2 x 1,384 instructions in
// the fewest Hopper instructions) for 64 bytes read and 32 written. The
// upper levels of a CTA run on ever fewer threads, and a level's latency
// (two dependent compressions) is then exposed. The CTAs of one wave
// reach those levels together, so a launch of many waves would pay that
// tail once a wave: the wrapper (ops/sha256.py, node_level_split) climbs
// only two levels a launch while the grid spans more than one wave of
// resident CTAs, and up to nine once it fits in one. For 2^20 leaves that
// is levels 1-2, 3-11 and 12-20.
__global__ void __launch_bounds__(NODE_THREADS)
sha256_node_levels_kernel(const uint8_t* __restrict__ in, int64_t n,
                          uint8_t* __restrict__ out, int levels) {
  __shared__ uint32_t sh[2][8][NODE_THREADS];
  const int t = threadIdx.x;
  uint32_t l[8], r[8], st[8];
  int64_t count = n >> 1;                 // nodes of the level being hashed
  int64_t p = (int64_t)blockIdx.x * NODE_THREADS + t;
  if (p < count) {
    load_digest(in + 64 * p, l);
    load_digest(in + 64 * p + 32, r);
    sha256_node(l, r, st);
    store_digest(out + 32 * p, st);
#pragma unroll
    for (int j = 0; j < 8; ++j) sh[0][j][t] = st[j];
  }
  out += 32 * count;
  for (int k = 2; k <= levels; ++k) {
    const int width = NODE_THREADS >> (k - 1);   // this CTA's parents
    if (2 * width > 32)
      __syncthreads();            // level k - 1 was written by several warps
    else
      __syncwarp();
    if (width <= 32 && t >= 32) return;   // warp-uniform
    const int rd = k & 1;                 // level k - 1 sits in sh[rd]
    count >>= 1;
    p = (int64_t)blockIdx.x * width + t;
    if (t < width && p < count) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 v = *(const uint2*)&sh[rd][j][2 * t];
        l[j] = v.x;
        r[j] = v.y;
      }
      sha256_node(l, r, st);
      store_digest(out + 32 * p, st);
#pragma unroll
      for (int j = 0; j < 8; ++j) sh[rd ^ 1][j][t] = st[j];
    }
    out += 32 * count;
  }
}

// CTAs of a sha256_node_levels launch over n children.
inline int node_levels_grid(int64_t n) {
  return (int)(((n >> 1) + NODE_THREADS - 1) / NODE_THREADS);
}

#define APPEND_LEVELS_MAX 16   // parent levels of one group of an append
#define APPEND_LAUNCH_LEVELS 9 // levels one launch climbs: 256 parents → 1
#define APPEND_WIDTH 256       // level-1 parents a CTA owns, at most
#define APPEND_THREADS 128     // threads of an append CTA

// The windows of one append launch: level[0] is the child level, level[j]
// (1 <= j <= levels <= APPEND_LAUNCH_LEVELS) the parent level j above it,
// each [rows, 32] bytes of big-endian digests; the new parents of level j
// are [p0[j], end[j]). A CTA owns `slots` consecutive level-`levels`
// ancestors from slot0 + slots * blockIdx.x on, so `slots << (levels - 1)`
// consecutive level-1 parents, aligned: every new parent below those
// ancestors, at every level.
struct AppendWindows {
  uint8_t* level[APPEND_LAUNCH_LEVELS + 1];
  int64_t p0[APPEND_LAUNCH_LEVELS + 1];
  int64_t end[APPEND_LAUNCH_LEVELS + 1];
  int64_t slot0;
  int levels, slots;
};

// The big-endian words of the 32-byte digest at `p` (16-byte aligned),
// read through L2 (__ldcg): what a launch still running when this one
// started wrote there is not in this SM's L1.
__device__ __forceinline__ void load_digest_cg(const uint8_t* p,
                                               uint32_t d[8]) {
  const uint4 a = __ldcg((const uint4*)p), b = __ldcg((const uint4*)p + 1);
  d[0] = bswap32(a.x); d[1] = bswap32(a.y); d[2] = bswap32(a.z);
  d[3] = bswap32(a.w); d[4] = bswap32(b.x); d[5] = bswap32(b.y);
  d[6] = bswap32(b.z); d[7] = bswap32(b.w);
}

// Programmatic dependent launch (sm_90): let the next launch of the stream
// start its CTAs now, and wait for the launch before this one (its writes
// done and visible). Outside a dependent launch the wait returns at once.
__device__ __forceinline__ void launch_dependents() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}
__device__ __forceinline__ void wait_prerequisite() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// Appends the new parents of up to APPEND_LAUNCH_LEVELS tree levels in one
// launch, each written in place into its level: parent p of level j is
// H(0x01 || child 2p || child 2p + 1) of level j - 1.
//
// Replaces the incremental append of the JAX package: the Pallas kernel
// plenum_tpu/ops/sha256_pallas.py::_sha256_kernel at nblocks = 2, fed by
// plenum_tpu/ops/merkle.py::_append_levels_fused (K levels a dispatch,
// each level's new nodes gathered from the one below and scattered into
// its level array) and _append_level_step (one level).
//
// Bound: latency. An append of a 3PC batch is far below a wave of the
// card (1,706 leaves onto 2^20: 1,700 nodes on 10 levels, 2 x 1,384
// instructions a node, an operations bound of 0.00014 ms), so its time
// is the levels times the latency of one level, plus its launches. One
// node hash on one warp takes ~2.8 us with the adds on the ALU, 3.6 with
// them on IMADs (plenum_tpu_torch/sha256_ceilings.py on an NVIDIA H100
// 80GB HBM3 at 700 W, PERF.md), so the
// node hash keeps them on the ALU (ADDS_ALU). chip_smoke.py prints
// the floor, levels x a node hash + launches x an empty launch, beside
// the kernel. Its first form paid two L2 round trips a level (each
// level's children read back through L2), and a level of 256 nodes put
// two warps on each SM sub-partition (the latency of two node hashes).
//
// Design. Every child of a new parent is new at the level below, but for
// one: when a level's window starts at an odd index, the left child of
// the first new parent above it is a stored node that no thread of the
// launch writes. So a CTA that owns a run of level-K ancestors owns every
// new node below them and climbs its levels alone, as
// sha256_node_levels_kernel does: its level-1 parents read their children
// from global memory (16-byte loads, neighbouring threads on neighbouring
// spans), and every parent goes once to its level in global memory and
// once to shared memory, in the transposed sh[word][node] layout with two
// buffers used by turns; levels 2..K read only shared memory. Node p of a
// level sits at index p - base, base = s_lo << (K - j) being the CTA's
// aligned first slot, so windows that start mid-range need no other
// indexing. The stored left siblings, one a level at most, are read with
// level 1's children into a small shared array, where the thread of the
// first new parent above takes its left child: no global load waits
// between levels.
//
// A CTA has APPEND_THREADS = 128 threads, four warps, one on each of the
// SM's sub-partitions: a level of 128 nodes then costs one warp's node
// hash, where 256 threads put two warps' worth on each (the latency of
// two node hashes). A CTA owns 128 level-1 parents for K <= 8 and 256 for
// K = 9 (two a thread at level 1). Below 32 nodes a level is one warp,
// synchronised by __syncwarp; the other warps return.
//
// The C entry enqueues an append's launches back to back with
// programmatic dependent launch: each launch lets the next start at once,
// and that one waits for it before it reads anything (through L2,
// __ldcg: the launch before wrote its level 0), so a launch's start
// overlaps the last levels of the one before.
//
// A group of more than APPEND_LAUNCH_LEVELS levels (K up to
// APPEND_LEVELS_MAX = 16) would give a CTA 2^(K - 1) level-1 parents, too
// many for shared memory, so the C entry splits such a group into
// launches of at most nine levels: only for K > 9 does an append launch
// more often than it has groups.
__global__ void __launch_bounds__(APPEND_THREADS)
sha256_append_levels_kernel(AppendWindows a) {
  __shared__ uint32_t sh[2][8][APPEND_WIDTH];
  __shared__ uint32_t stored[APPEND_LAUNCH_LEVELS][8];
  launch_dependents();
  const int t = threadIdx.x;
  const int K = a.levels;
  const int64_t s_lo = a.slot0 + (int64_t)blockIdx.x * a.slots;
  wait_prerequisite();            // level 0 may be the launch before's
  // stored[j]: the stored left child (level j) of level j + 1's first new
  // parent, if that child lies below this CTA's ancestors and before
  // level j's window; first read at level j + 1, after a barrier
  if (t >= 1 && t < K) {
    const int64_t c = 2 * a.p0[t + 1];
    if (c < a.p0[t] && c >> (K - t) >= s_lo && c >> (K - t) < s_lo + a.slots)
      load_digest_cg(a.level[t] + 32 * c, stored[t]);
  }
  const int w1 = a.slots << (K - 1);      // this CTA's level-1 slots
  for (int i = t; i < w1; i += APPEND_THREADS) {
    const int64_t p = (s_lo << (K - 1)) + i;
    if (p >= a.p0[1] && p < a.end[1]) {
      uint32_t l[8], r[8], st[8];
      load_digest_cg(a.level[0] + 64 * p, l);
      load_digest_cg(a.level[0] + 64 * p + 32, r);
      sha256_node(l, r, st);
      store_digest(a.level[1] + 32 * p, st);
#pragma unroll
      for (int k = 0; k < 8; ++k) sh[1][k][i] = st[k];
    }
  }
  for (int j = 2; j <= K; ++j) {
    const int width = w1 >> (j - 1);      // this CTA's slots of level j
    const int rd = (j - 1) & 1;           // level j - 1 sits in sh[rd]
    if (2 * width > 32)
      __syncthreads();            // level j - 1 was written by several warps
    else
      __syncwarp();
    if (width <= 32 && t >= 32) return;   // warp-uniform
    const int64_t p = (s_lo << (K - j)) + t;
    if (t < width && p >= a.p0[j] && p < a.end[j]) {
      uint32_t l[8], r[8], st[8];
      const bool left_stored = 2 * p < a.p0[j - 1];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint2 v = *(const uint2*)&sh[rd][k][2 * t];
        l[k] = left_stored ? stored[j - 1][k] : v.x;
        r[k] = v.y;
      }
      sha256_node(l, r, st);
      store_digest(a.level[j] + 32 * p, st);
#pragma unroll
      for (int k = 0; k < 8; ++k) sh[rd ^ 1][k][t] = st[k];
    }
  }
}

// The windows of one launch of `levels` (1..APPEND_LAUNCH_LEVELS) parent
// levels: level[0] the child level, level[j] parent level j with new
// parents [p0[j - 1], p0[j - 1] + cnt[j - 1]). → the CTAs of the launch (0:
// nothing to do).
inline int append_windows(uint8_t* const* level, const int64_t* p0,
                          const int64_t* cnt, int levels, AppendWindows* a) {
  a->level[0] = level[0];
  for (int j = 1; j <= levels; ++j) {
    a->level[j] = level[j];
    a->p0[j] = p0[j - 1];
    a->end[j] = p0[j - 1] + cnt[j - 1];
  }
  a->levels = levels;
  if (cnt[0] <= 0) return 0;
  const int up = levels - 1;
  a->slots = (1 << up) < APPEND_THREADS ? APPEND_THREADS >> up : 1;
  a->slot0 = a->p0[1] >> up;
  const int64_t slots = ((a->end[1] - 1) >> up) - a->slot0 + 1;
  return (int)((slots + a->slots - 1) / a->slots);
}

// Calls launch(grid, windows) for each launch of an append: `levels`
// holds 1 + L level pointers (the first group's child level, then parent
// levels 1..L), p0s and cnts the L windows, group_levels the levels of
// each of `groups` groups (summing to L); a group of more than
// APPEND_LAUNCH_LEVELS levels is split. → the first nonzero result of
// launch, else 0; *launches counts the launches made.
template <class Launch>
inline int append_groups_each(uint8_t* const* levels, const int64_t* p0s,
                              const int64_t* cnts, const int* group_levels,
                              int groups, Launch launch, int* launches) {
  int at = 0;
  *launches = 0;
  for (int g = 0; g < groups; ++g) {
    const int k = group_levels[g];
    if (k < 1 || k > APPEND_LEVELS_MAX) return -1;
    for (int done = 0; done < k; done += APPEND_LAUNCH_LEVELS) {
      const int n = k - done < APPEND_LAUNCH_LEVELS ? k - done
                                                    : APPEND_LAUNCH_LEVELS;
      AppendWindows a;
      const int grid = append_windows(levels + at, p0s + at, cnts + at, n,
                                      &a);
      at += n;
      if (grid == 0) continue;
      const int e = launch(grid, a);
      if (e != 0) return e;
      ++*launches;
    }
  }
  return 0;
}

#define COMPRESS_THREADS 256

// The digest state of B pre-padded messages, one thread per message, each
// loading its own message's blocks as four 16-byte loads a block.
//
// Bound: operations, 1,384 instructions a block in the fewest Hopper
// instructions (chip_smoke.py). What the card issues of them was measured
// first (plenum_tpu_torch/sha256_ceilings.py on an NVIDIA H100 80GB HBM3
// at 700 W, PERF.md): SHF, LOP3 and
// IADD3 share the ALU pipe at 64 lanes a clock per SM, and IMAD issues on
// the FMA pipe beside it, so the compression routes its adds to IMADs
// (ADDS_ALL) and the ALU keeps its SHF and LOP3 (the compression's mix
// then issues 95-96 lane-instructions a clock per SM, against 68). The
// loads are not what holds it back: a thread's 64-byte block lies in one
// 128-byte line, which its four loads share through L1, and staging the
// messages through shared memory with coalesced asynchronous copies (one
// CTA a tile or a persistent wave) measured 5-10% slower, its copies,
// swizzled reads and barriers adding instructions to an issue-bound loop.
template <int ADDS>
__global__ void __launch_bounds__(COMPRESS_THREADS)
sha256_compress_kernel(const uint4* __restrict__ words,
                       const int32_t* __restrict__ nvalid,
                       uint4* __restrict__ out, int B, int nblocks) {
  const int i = blockIdx.x * COMPRESS_THREADS + threadIdx.x;
  if (i >= B) return;
  uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  const uint4* msg = words + (size_t)i * nblocks * 4;
  const int nb = nvalid[i] < nblocks ? nvalid[i] : nblocks;
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = msg[blk * 4 + q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    sha256_compress_block_t<ADDS>(st, w);
  }
  out[2 * (size_t)i] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * (size_t)i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

inline int compress_grid(int B) {
  return (B + COMPRESS_THREADS - 1) / COMPRESS_THREADS;
}

#ifdef __CUDACC__
// words: [B, nblocks, 16] uint32, 16-byte aligned; nvalid: [B] int32;
// out: [B, 8] uint32. One launch on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int sha256_compress(const void* words, const void* nvalid,
                               void* out, int B, int nblocks, void* stream) {
  if (B <= 0 || nblocks <= 0) return 0;
  sha256_compress_kernel<ADDS_ALL>
      <<<compress_grid(B), COMPRESS_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint4*)words, (const int32_t*)nvalid, (uint4*)out, B,
          nblocks);
  return (int)cudaGetLastError();
}

// data: [nbytes] uint8, 16-byte aligned; offsets: [B + 1] int64; prefix:
// -1 or a byte; out: [B, 32] bytes, 16-byte aligned: each row the digest
// state ([8] uint32) or, with big_endian, the digest's 32 big-endian bytes
// (a device Merkle tree's leaf level, in place); err: 16 bytes whose first
// uint32 is the error word (zeroed here, then 1 if a row's offsets are
// negative, decreasing or past nbytes). Launches on `stream` without
// synchronising and returns the CUDA error of the launch (0 on success).
extern "C" int sha256_ragged(const void* data, int64_t nbytes,
                             const void* offsets, int prefix, void* out,
                             void* err, int B, int big_endian,
                             void* stream) {
  cudaError_t e = cudaMemsetAsync(err, 0, 16, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  int blocks = (B + RAGGED_THREADS - 1) / RAGGED_THREADS;
  sha256_ragged_kernel<<<blocks, RAGGED_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, nbytes, (const int64_t*)offsets, prefix,
      (uint4*)out, (uint32_t*)err, B, big_endian);
  return (int)cudaGetLastError();
}

// *ctas = the CTAs of sha256_node_levels_kernel that the current device
// holds at once (one wave). Returns the CUDA error (0 on success).
extern "C" int sha256_node_levels_wave(int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sha256_node_levels_kernel, NODE_THREADS, 0);
  *ctas = sms * per_sm;
  return (int)e;
}

// in: [n, 32] uint8 digests, 16-byte aligned; out: the n >> 1, n >> 2, ...
// nodes of levels 1..levels (1 <= levels <= NODE_LEVELS), 32 bytes each,
// one level after another. One launch on `stream`, without synchronising;
// returns its CUDA error (0 on success).
extern "C" int sha256_node_levels(const void* in, int64_t n, void* out,
                                  int levels, void* stream) {
  if (levels < 1 || levels > NODE_LEVELS) return (int)cudaErrorInvalidValue;
  if (n < 2) return 0;
  sha256_node_levels_kernel<<<node_levels_grid(n), NODE_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)in, n, (uint8_t*)out, levels);
  return (int)cudaGetLastError();
}

// One launch of sha256_append_levels_kernel on `stream`, with programmatic
// dependent launch. → its CUDA error.
inline int append_launch(int grid, const AppendWindows& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(APPEND_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, sha256_append_levels_kernel, a);
}

// The launches of an append, enqueued back to back on `stream` without
// synchronising: levels holds 1 + L device pointers (the first group's
// child level, then parent levels 1..L, each [*, 32] digests, 16-byte
// aligned); p0s, cnts: host arrays, the window of new parents of each
// parent level (cnts[0] >= 1, each window's children in the window below
// or stored before it); group_levels: the levels of each of `groups`
// groups (1..APPEND_LEVELS_MAX each, summing to L), a group of more than
// nine levels being split. *launches receives the launches made. Returns
// the first CUDA error (0 on success).
extern "C" int sha256_append_groups(void* const* levels, const int64_t* p0s,
                                    const int64_t* cnts,
                                    const int* group_levels, int groups,
                                    void* stream, int* launches) {
  const int e = append_groups_each(
      (uint8_t* const*)levels, p0s, cnts, group_levels, groups,
      [stream](int grid, const AppendWindows& a) {
        return append_launch(grid, a, (cudaStream_t)stream);
      },
      launches);
  return e < 0 ? (int)cudaErrorInvalidValue : e;
}
#endif
