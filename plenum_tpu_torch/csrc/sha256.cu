// SHA-256 on the card, with three entry points that share the compression
// (sha256_compress_block):
//
// sha256_compress: pre-padded messages, one thread per message. Replaces
// the Pallas kernel plenum_tpu/ops/sha256_pallas.py::_sha256_kernel (built
// by _build_sha256, entered through sha256_blocks). Same function: words
// [B, nblocks, 16] big-endian uint32 (from pad_messages) plus the
// per-message block count nvalid [B] give the digest state [B, 8] uint32.
// The TPU kernel ran every row through all `nblocks` blocks and masked the
// state of rows whose message had ended; here each thread loops over its
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
// sha256_append_levels: the new parents of up to APPEND_LEVELS_MAX levels
// of a growing tree, written in place, windows at any offset (see
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
      sha256_compress_block(st, w);
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

#define APPEND_LEVELS_MAX 16   // parent levels one append launch climbs

// The windows of one append launch: level[0] is the child level, level[j]
// (1 <= j <= levels) the parent level j above it, each [rows, 32] bytes of
// big-endian digests; the new parents of level j are [p0[j], end[j]). A
// CTA owns `slots` consecutive level-`levels` ancestors from slot0 + slots
// * blockIdx.x on: every new parent below them, at every level.
struct AppendWindows {
  uint8_t* level[APPEND_LEVELS_MAX + 1];
  int64_t p0[APPEND_LEVELS_MAX + 1];
  int64_t end[APPEND_LEVELS_MAX + 1];
  int64_t slot0;
  int levels, slots;
};

// The big-endian words of the 32-byte digest at `p` (16-byte aligned),
// read through L2: the digest may have been written by another thread of
// the block in this launch, which the read-only path (__ldg) would not see.
__device__ __forceinline__ void load_digest_cg(const uint8_t* p, uint32_t d[8]) {
  const uint4 a = __ldcg((const uint4*)p), b = __ldcg((const uint4*)p + 1);
  d[0] = bswap32(a.x); d[1] = bswap32(a.y); d[2] = bswap32(a.z);
  d[3] = bswap32(a.w); d[4] = bswap32(b.x); d[5] = bswap32(b.y);
  d[6] = bswap32(b.z); d[7] = bswap32(b.w);
}

// Appends the new parents of up to APPEND_LEVELS_MAX tree levels in one
// launch, each written in place into its level: parent p of level j is
// H(0x01 || child 2p || child 2p + 1) of level j - 1.
//
// Replaces the incremental append of the JAX package: the Pallas kernel
// plenum_tpu/ops/sha256_pallas.py::_sha256_kernel at nblocks = 2, fed by
// plenum_tpu/ops/merkle.py::_append_levels_fused (K levels a dispatch,
// each level's new nodes gathered from the one below and scattered into
// its level array) and _append_level_step (one level).
//
// Design. An append's windows are not aligned at 0: when a level's
// window starts at an odd index, the left child of its first parent is a
// stored node that no thread of this launch writes, and is read from the
// child level as it is. Every other child of a new parent is new at the
// level below, and lies under the same level-K ancestor; so a CTA that
// owns a run of level-K ancestors owns every new node below them and
// climbs its levels alone: hash its parents of level j, __syncthreads,
// hash those of level j + 1 from them. Between levels the digests go
// through global memory (read back through L2: L1 and the read-only path
// are not coherent with other threads' stores), since an append's windows
// are small and its levels few. A CTA owns 256 >> (K - 1) ancestors, 256
// parents of level 1 (one a thread), more for K > 9.
//
// Bound: operations, 2 x 1,384 instructions a node. An append of a 3PC
// batch is far below a wave of the card (1,706 leaves onto 2^20: 1,700
// nodes on 10 levels, a bound of 0.00014 ms), so the latency of a level
// (two dependent compressions and their loads) times the levels of a
// launch sets its time: 0.0424 ms for that append's three launches, one
// level of one node 0.0053 ms (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py phase 8).
__global__ void __launch_bounds__(NODE_THREADS)
sha256_append_levels_kernel(AppendWindows a) {
  const int64_t s_lo = a.slot0 + (int64_t)blockIdx.x * a.slots;
  const int64_t s_hi = s_lo + a.slots;
  for (int j = 1; j <= a.levels; ++j) {
    if (j > 1) __syncthreads();           // level j - 1 was written above
    const int up = a.levels - j;          // parent p lies under p >> up
    const int64_t lo = max(a.p0[j], s_lo << up);
    const int64_t hi = min(a.end[j], s_hi << up);
    const uint8_t* child = a.level[j - 1];
    uint8_t* parent = a.level[j];
    for (int64_t p = lo + threadIdx.x; p < hi; p += blockDim.x) {
      uint32_t l[8], r[8], st[8];
      load_digest_cg(child + 64 * p, l);
      load_digest_cg(child + 64 * p + 32, r);
      sha256_node(l, r, st);
      store_digest(parent + 32 * p, st);
    }
  }
}

// The launch parameters of an append of `levels` parent levels above
// `child`: parents[j - 1] is level j, whose new parents are p0s[j - 1] and
// the cnts[j - 1] after it. → the CTAs of the launch (0: nothing to do).
inline int append_windows(const void* child, const void* const* parents,
                          const int64_t* p0s, const int64_t* cnts,
                          int levels, AppendWindows* a) {
  a->level[0] = (uint8_t*)child;
  for (int j = 1; j <= levels; ++j) {
    a->level[j] = (uint8_t*)parents[j - 1];
    a->p0[j] = p0s[j - 1];
    a->end[j] = p0s[j - 1] + cnts[j - 1];
  }
  a->levels = levels;
  if (cnts[0] <= 0) return 0;
  const int up = levels - 1;
  a->slots = up < 8 ? NODE_THREADS >> up : 1;
  a->slot0 = a->p0[1] >> up;
  const int64_t slots = ((a->end[1] - 1) >> up) - a->slot0 + 1;
  return (int)((slots + a->slots - 1) / a->slots);
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

// child: [*, 32] digests of the level below the first parent level;
// parents: `levels` device pointers (1 <= levels <= APPEND_LEVELS_MAX), the
// parent levels, each [*, 32]; p0s, cnts: host arrays, the window of new
// parents of each (cnts[0] >= cnts[1] >= ..., each window's children in
// the window below or stored before it). Every pointer 16-byte aligned.
// One launch on `stream`, without synchronising; returns its CUDA error
// (0 on success).
extern "C" int sha256_append_levels(const void* child,
                                    const void* const* parents,
                                    const int64_t* p0s, const int64_t* cnts,
                                    int levels, void* stream) {
  if (levels < 1 || levels > APPEND_LEVELS_MAX)
    return (int)cudaErrorInvalidValue;
  AppendWindows a;
  const int grid = append_windows(child, parents, p0s, cnts, levels, &a);
  if (grid == 0) return 0;
  sha256_append_levels_kernel<<<grid, NODE_THREADS, 0,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
