// SHA3-256 on the card, with two entry points that share the staging and
// the permutation (sha3_kernel):
//
// sha3_ragged: raw messages → [B, 32] digests.
// sha3_ragged_eq: raw messages and [B, 32] expected digests → [B] verdicts
// (1 where the digest equals its ref); only the verdict leaves the card.
//
// Replaces the XLA device program plenum_tpu/ops/sha3.py::_sha3_blocks
// (on _keccak_f / _keccak_round) and its fused compare
// plenum_tpu/ops/trie_jax.py::_sha3_blocks_eq, which hash the MPT node
// levels of the state engine. The JAX program took host-padded half-lane
// words [B, nblocks, 17, 2] uint32 (nblocks and the batch rounded up to
// powers of two for XLA's compile cache) and split every 64-bit lane into
// (hi, lo) uint32 halves for the TPU's 32-bit vector unit. Here the input
// is the flat byte buffer of all messages and their offsets [B + 1]; the
// card pads (0x06 after the last byte, 0x80 in the last byte of the
// 136-byte rate, the two may share a byte) and absorbs exactly
// len / 136 + 1 blocks of each message. The launch takes exactly B rows.
//
// Bound on this card: operations. A Keccak-f[1600] permutation is 24
// rounds over 25 64-bit lanes, ~4,600 32-bit instructions for 136 bytes
// read. The state engine's levels are 148 to ~3,200 rows of 1 to 4
// blocks (leaves and ~530-byte branch nodes): at one thread per message
// that is a dozen blocks of 128 threads on 132 SMs, each thread a serial
// chain of 24-round permutations, so a launch is latency-bound; a level
// of 65,536 rows fills the card and is bound by the instruction rate.
// Hence two layouts of one kernel, picked by the wrapper from B
// (ops/sha3.py, GROUP_MAX_ROWS):
//
// - lanes = 5: a group of five lanes per message, lane x owning column x
//   (five 64-bit lanes, ten registers), six messages per warp (lanes 30
//   and 31 only stage). theta's column parity is local, D takes two
//   shuffles, chi two per row, pi five. pi maps the state's rows across
//   lanes, which with a plain layout would need register indices that
//   depend on the lane; instead register k of lane x holds row
//   (k + s * x) mod 5, and pi takes layout s to layout 3 + 2 / s (mod 5),
//   so that every shuffle sends and receives a register whose index is a
//   compile-time constant: layouts 3, 2, 4, 1 run four rounds and end in
//   the plain layout 0, which a rotation of the five registers by 3x
//   (three selects of the five) turns into layout 3 again. rho's rotation
//   amounts, and pi's source lanes, differ per lane and are packed into
//   registers once (6 and 5 bits a field).
// - lanes = 1: one thread per message, the 25 lanes in registers (every
//   lane index a compile-time constant; the round loop is not unrolled),
//   the fewest instructions per message for levels that fill the card.
//
// Either way the bytes reach the lanes through shared memory: block by
// block, the warp stages the 160 aligned bytes that hold each of its
// messages' next 136 with 16-byte loads, ten lanes to a message and three
// messages per load instruction, neighbouring lanes on neighbouring
// addresses; each lane then reads its 64-bit lanes back, realigned with
// funnel shifts and with the padding masked in. A group absorbs only its
// own message's blocks; the warp stages until its longest message ends.
// Lanes past B compute a clamped copy of the last row and never write.
//
// Offsets are checked here, not by a read-back before the launch: a row
// whose offsets are negative, decreasing or past nbytes sets the error
// word in the output's 16-byte tail and is hashed as empty, and no load
// leaves data[0:nbytes]. The host reads the word with the results.
//
// ptxas (sm_90a): five lanes 96 registers and 4,224 bytes of shared
// memory, one lane 80 registers and 22,528 bytes; no stack frame and no
// spills in any of the four entries. On an NVIDIA H100 80GB HBM3 at
// 700 W, kernel alone: 0.0146 ms for the pool's 1,706-row level of
// 2-block nodes (the earlier one-thread kernel without staging 0.0205 ms;
// bound 0.00047 ms), 0.0549 ms for 65,536 such rows in one thread each
// (the earlier kernel 0.0574 ms; bound 0.018 ms). A group of 25 lanes
// with the state in shared memory was tried and lost at both shapes
// (0.0168 and 0.357 ms). PERF.md has the tables.
#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#define SHA3_RATE 136
#define SHA3_THREADS 128
#define SHA3_WARPS (SHA3_THREADS / 32)
#define STAGE_VECS 10      // 160 bytes: one 136-byte block at any 16-byte phase
#define FULL_MASK 0xffffffffu

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

// rho's rotation of lane (x, y): walk (1, 0) → (y, 2x + 3y), offsets
// (t + 1)(t + 2) / 2 mod 64.
__host__ __device__ constexpr int rho_offset(int x, int y) {
  int cx = 1, cy = 0;
  for (int t = 0; t < 24; ++t) {
    if (cx == x && cy == y) return ((t + 1) * (t + 2) / 2) % 64;
    int nx = cy, ny = (2 * cx + 3 * cy) % 5;
    cx = nx;
    cy = ny;
  }
  return 0;
}

// 1 / s mod 5
__host__ __device__ constexpr int inv5(int s) {
  return s == 1 ? 1 : s == 2 ? 3 : s == 3 ? 2 : 4;
}

// The rotation amounts of column x's five registers in layout s, 6 bits
// each: register k holds row (k + s x) mod 5.
__host__ __device__ constexpr uint32_t rho_pack(int x, int s) {
  uint32_t p = 0;
  for (int k = 0; k < 5; ++k)
    p |= (uint32_t)rho_offset(x, (k + s * x) % 5) << (6 * k);
  return p;
}

template <int S>
__device__ __forceinline__ uint32_t rho_pack_of(int x) {
  constexpr uint32_t p0 = rho_pack(0, S), p1 = rho_pack(1, S),
                     p2 = rho_pack(2, S), p3 = rho_pack(3, S),
                     p4 = rho_pack(4, S);
  return x == 0 ? p0 : x == 1 ? p1 : x == 2 ? p2 : x == 3 ? p3 : p4;
}

// pi's source lanes for column x in layout s, 5 bits each: in shuffle c
// lane x reads register c of column (x - c) / s (mod 5) of its group.
template <int S>
__device__ __forceinline__ uint32_t pi_pack_of(int x, int g0) {
  uint32_t p = 0;
#pragma unroll
  for (int c = 0; c < 5; ++c)
    p |= (uint32_t)(g0 + (x + 5 - c) * inv5(S) % 5) << (5 * c);
  return p;
}

// Rotate left by n in 0..63, n known only at run time.
__device__ __forceinline__ uint64_t rotl_var(uint64_t v, uint32_t n) {
  uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32), s = n & 31;
  uint32_t h = (n & 32) ? lo : hi, l = (n & 32) ? hi : lo;
  return ((uint64_t)__funnelshift_l(l, h, s) << 32) | __funnelshift_l(h, l, s);
}

// Keccak-f[1600] in one thread: lane x + 5y is a[x + 5y].
__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
  uint64_t b[25], c[5], d[5];
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
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
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; x++)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    a[0] ^= KECCAK_RC[r];
  }
}

// What a lane of a five-lane group needs besides its registers.
struct Group5 {
  unsigned mask;        // the group's five lanes
  int up1, up2, dn1;    // the lanes of columns x + 1, x + 2, x - 1
  bool lead;            // column 0: takes iota
  uint32_t rho[4];      // rho_pack for layouts 3, 2, 4, 1
  uint32_t pi[4];       // pi_pack for layouts 3, 2, 4, 1
};

// One round on a group in layout S (register k of column x holds row
// (k + S x) mod 5); leaves layout T = 3 + 2 / S.
template <int S>
__device__ __forceinline__ void round5(uint64_t a[5], const Group5& g,
                                       uint32_t rho, uint32_t pi,
                                       uint64_t rc) {
  constexpr int IS = inv5(S);
  constexpr int T = (3 + 2 * IS) % 5;
  // theta
  uint64_t c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4];
  uint64_t cm = __shfl_sync(g.mask, c, g.dn1);
  uint64_t cp = __shfl_sync(g.mask, c, g.up1);
  uint64_t d = cm ^ ROTL(cp, 1);
  // rho
#pragma unroll
  for (int k = 0; k < 5; ++k) a[k] = rotl_var(a[k] ^ d, (rho >> (6 * k)) & 63);
  // pi: register c of column (X - c) / S lands in register -2c / S of X
  uint64_t b[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    b[(25 - 2 * IS * k % 5) % 5] =
        __shfl_sync(g.mask, a[k], (pi >> (5 * k)) & 31);
  // chi, in layout T: row k + T X of column X + 1 is its register k - T
  uint64_t n1[5], n2[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    n1[k] = __shfl_sync(g.mask, b[(k + 5 - T) % 5], g.up1);
    n2[k] = __shfl_sync(g.mask, b[(k + 10 - 2 * T) % 5], g.up2);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) a[k] = b[k] ^ (~n1[k] & n2[k]);
  // iota: row 0 of column 0 is register 0 in every layout
  a[0] ^= g.lead ? rc : 0;
}

// Rotate the five registers by r in 0..4: a[k] ← a[(k + r) mod 5], as
// conditional rotations by 1, 2 and 4 (selects, no indexing by r).
__device__ __forceinline__ void rotate_regs(uint64_t a[5], int r) {
#pragma unroll
  for (int bit = 0; bit < 3; ++bit) {
    const bool on = (r >> bit) & 1;
    const int by = 1 << bit;
    uint64_t t[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) t[k] = a[(k + by) % 5];
#pragma unroll
    for (int k = 0; k < 5; ++k) a[k] = on ? t[k] : a[k];
  }
}

// Keccak-f[1600] on a five-lane group, in and out of layout 0 (register
// y of column x holds lane x + 5y).
__device__ __forceinline__ void keccak_f5(uint64_t a[5], const Group5& g,
                                          int skew) {
#pragma unroll 1
  for (int q = 0; q < 24; q += 4) {
    rotate_regs(a, skew);    // layout 0 → 3
    round5<3>(a, g, g.rho[0], g.pi[0], KECCAK_RC[q]);
    round5<2>(a, g, g.rho[1], g.pi[1], KECCAK_RC[q + 1]);
    round5<4>(a, g, g.rho[2], g.pi[2], KECCAK_RC[q + 2]);
    round5<1>(a, g, g.rho[3], g.pi[3], KECCAK_RC[q + 3]);
  }
}

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

// Lane L (0..16) of block blk (of nb) of a message of len bytes, from the
// staged window w (the 160 bytes from the block's start rounded down to
// 16; the block starts at byte ph of it): the message's own bytes, 0x06
// after its last, 0x80 in the rate's last byte of the last block.
__device__ __forceinline__ uint64_t staged_lane(const uint32_t* w, int ph,
                                                int L, int64_t len, int blk,
                                                int nb) {
  const int at = ph + 8 * L, wo = at >> 2, sh = 8 * (at & 3);
  const uint32_t lo = __funnelshift_r(w[wo], w[wo + 1], sh);
  const uint32_t hi = __funnelshift_r(w[wo + 1], w[wo + 2], sh);
  uint64_t v = ((uint64_t)hi << 32) | lo;
  const int64_t k = len - (int64_t)SHA3_RATE * blk - 8 * L;  // bytes left
  if (k < 8) {
    v = k <= 0 ? 0 : v & ((1ull << (8 * k)) - 1);
    if (k >= 0) v ^= 0x06ull << (8 * k);
  }
  if (L == 16 && blk == nb - 1) v ^= 0x80ull << 56;
  return v;
}

// Messages per warp for `lanes` lanes per message.
__host__ __device__ constexpr int sha3_msgs_per_warp(int lanes) {
  return lanes == 1 ? 32 : 6;
}

__host__ __device__ constexpr int sha3_grid(int lanes, int B) {
  return (B + SHA3_WARPS * sha3_msgs_per_warp(lanes) - 1) /
         (SHA3_WARPS * sha3_msgs_per_warp(lanes));
}

// G lanes per message (1 or 5). Row i is data[offsets[i]:offsets[i + 1]];
// EQ: out[i] = 1 where its digest equals refs' row i, else out is [B, 4]
// uint64 digests. *err |= 1 for a row with invalid offsets.
template <int G, bool EQ>
__global__ void __launch_bounds__(SHA3_THREADS)
sha3_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
            const int64_t* __restrict__ offsets,
            const uint64_t* __restrict__ refs, uint8_t* __restrict__ out,
            uint32_t* __restrict__ err, int B) {
  constexpr int M = sha3_msgs_per_warp(G);
  __shared__ uint4 stage[SHA3_WARPS][M][STAGE_VECS];
  __shared__ int64_t s_start[SHA3_WARPS][M];
  __shared__ int64_t s_len[SHA3_WARPS][M];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * SHA3_WARPS + warp) * M;
  if (first >= B) return;                 // the whole warp
  if (lane < M) {                         // lane j reads message j's offsets
    const int row = min(first + lane, B - 1);
    int64_t lo = offsets[row], hi = offsets[row + 1];
    if (lo < 0 || hi < lo || hi > nbytes) {
      atomicOr(err, 1u);
      lo = hi = 0;
    }
    s_start[warp][lane] = lo;
    s_len[warp][lane] = hi - lo;
  }
  __syncwarp();
  const int m = G == 1 ? lane : lane / 5;     // this lane's message
  const int x = G == 1 ? 0 : lane % 5;        // and column
  const bool member = G == 1 || lane < 5 * M;
  const int nb = member ? (int)(s_len[warp][m] / SHA3_RATE) + 1 : 0;
  int nb_warp = nb;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    nb_warp = max(nb_warp, __shfl_xor_sync(FULL_MASK, nb_warp, o));

  Group5 g;
  int skew = 0;
  if constexpr (G == 5) {
    const int g0 = lane - x;
    g.mask = 0x1fu << g0;
    g.up1 = g0 + (x + 1) % 5;
    g.up2 = g0 + (x + 2) % 5;
    g.dn1 = g0 + (x + 4) % 5;
    g.lead = x == 0;
    g.rho[0] = rho_pack_of<3>(x);
    g.rho[1] = rho_pack_of<2>(x);
    g.rho[2] = rho_pack_of<4>(x);
    g.rho[3] = rho_pack_of<1>(x);
    g.pi[0] = pi_pack_of<3>(x, g0);
    g.pi[1] = pi_pack_of<2>(x, g0);
    g.pi[2] = pi_pack_of<4>(x, g0);
    g.pi[3] = pi_pack_of<1>(x, g0);
    skew = 3 * x % 5;
  }
  uint64_t a[G == 1 ? 25 : 5];
#pragma unroll
  for (int i = 0; i < (G == 1 ? 25 : 5); ++i) a[i] = 0;

  for (int blk = 0; blk < nb_warp; ++blk) {
#pragma unroll
    for (int j = 0; j < M; j += 3) {
      const int mm = j + lane / STAGE_VECS, q = lane % STAGE_VECS;
      if (lane < 3 * STAGE_VECS && mm < M &&
          blk <= s_len[warp][mm] / SHA3_RATE) {
        const int64_t at =
            (s_start[warp][mm] + (int64_t)SHA3_RATE * blk) & ~(int64_t)15;
        stage[warp][mm][q] = load16(data, at + 16 * q, nbytes);
      }
    }
    __syncwarp();
    if (blk < nb) {
      const int64_t start = s_start[warp][m], len = s_len[warp][m];
      const uint32_t* w = (const uint32_t*)stage[warp][m];
      const int ph = (int)((start + (int64_t)SHA3_RATE * blk) & 15);
      if constexpr (G == 1) {
#pragma unroll
        for (int L = 0; L < 17; ++L) a[L] ^= staged_lane(w, ph, L, len, blk, nb);
        keccak_f(a);
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          if (x + 5 * y < 17)
            a[y] ^= staged_lane(w, ph, x + 5 * y, len, blk, nb);
        keccak_f5(a, g, skew);
      }
    }
    __syncwarp();
  }

  const int row = first + m;
  const bool live = member && row < B;
  if constexpr (G == 1) {
    if (!live) return;
    if constexpr (EQ) {
      uint64_t diff = 0;
#pragma unroll
      for (int l = 0; l < 4; ++l) diff |= a[l] ^ refs[4 * (size_t)row + l];
      out[row] = diff == 0;
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l)
        ((uint64_t*)out)[4 * (size_t)row + l] = a[l];
    }
  } else {
    // column x < 4 holds digest lane x in register 0 (layout 0)
    if constexpr (EQ) {
      const bool bad = live && x < 4 && (a[0] ^ refs[4 * (size_t)row + x]);
      const unsigned votes = __ballot_sync(FULL_MASK, bad);
      if (live && x == 0) out[row] = ((votes >> lane) & 0xfu) == 0;
    } else {
      if (live && x < 4) ((uint64_t*)out)[4 * (size_t)row + x] = a[0];
    }
  }
}

#ifdef __CUDACC__
template <bool EQ>
static int sha3_launch(const void* data, int64_t nbytes, const void* offsets,
                       const void* refs, void* out, size_t payload, int B,
                       int lanes, cudaStream_t stream) {
  if (B <= 0) return 0;
  uint32_t* err = (uint32_t*)((uint8_t*)out + payload);
  cudaError_t e = cudaMemsetAsync(err, 0, 16, stream);
  if (e != cudaSuccess) return (int)e;
  const int grid = sha3_grid(lanes, B);
  const auto* d = (const uint8_t*)data;
  const auto* o = (const int64_t*)offsets;
  const auto* r = (const uint64_t*)refs;
  if (lanes == 5)
    sha3_kernel<5, EQ><<<grid, SHA3_THREADS, 0, stream>>>(
        d, nbytes, o, r, (uint8_t*)out, err, B);
  else if (lanes == 1)
    sha3_kernel<1, EQ><<<grid, SHA3_THREADS, 0, stream>>>(
        d, nbytes, o, r, (uint8_t*)out, err, B);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// data: [nbytes] uint8, 16-byte aligned; offsets: [B + 1] int64; out:
// B * 32 digest bytes, 8-byte aligned, then a 16-byte tail whose first
// uint32 is the error word (zeroed here, then 1 if a row's offsets are
// invalid); lanes: 1 or 5 per message. Launches on `stream` without
// synchronising and returns the CUDA error of the launch (0 on success).
extern "C" int sha3_ragged(const void* data, int64_t nbytes,
                           const void* offsets, void* out, int B, int lanes,
                           void* stream) {
  return sha3_launch<false>(data, nbytes, offsets, nullptr, out,
                            32 * (size_t)B, B, lanes, (cudaStream_t)stream);
}

// As sha3_ragged, with refs: [B, 32] uint8, 8-byte aligned, and ok: B
// verdict bytes rounded up to 16, then the 16-byte tail.
extern "C" int sha3_ragged_eq(const void* data, int64_t nbytes,
                              const void* offsets, const void* refs, void* ok,
                              int B, int lanes, void* stream) {
  return sha3_launch<true>(data, nbytes, offsets, refs, ok,
                           ((size_t)B + 15) / 16 * 16, B, lanes,
                           (cudaStream_t)stream);
}
#endif
