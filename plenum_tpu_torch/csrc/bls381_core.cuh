// The BLS12-381 arithmetic that the kernels of bls381.cu (the pairing),
// bls381_agg.cu (the G1 and G2 aggregates) and bls381_msm.cu (the G1 MSM)
// share: the field core, fp2, fixed powers by a sliding window, the
// variable-time inversion, decompression of packed points, the lane groups
// (trios, sextets) that split a chain's products over lanes, the RCB
// additions and the normalized stores. Each of the three sources builds
// into a library of its own (ops/cuda_lib.py), all at once; the host build
// (bls381_host.cpp) includes all three.
//
// The formulas are those of the port's host library, csrc/bls12_381.c:
// Montgomery arithmetic mod q with R = 2^384, the fp2 tower over u^2 = -1.
// Exact departures: fixed powers go by a sliding window (POW_WINDOW bits,
// POW_WINDOW_FP2 in fp2; the square roots); inversion is Fermat's
// (a^(q-2), the pairing and the MSM) or Bernstein-Yang's safegcd in its
// variable-time form (the aggregates, whose inputs are public); the G2
// square root computes both candidates and selects, as the JAX tower does
// (plenum_tpu/ops/bls381_tower.py:290), or goes by the norm (the
// aggregates); the multiply by 3b in the RCB additions is additions.
//
// Packed inputs keep the JAX package's layout (its pack_compressed and
// pack_g2_compressed): an x coordinate as 32 limbs of 12 bits in int32, in
// the standard domain, x < q checked on the host, and three flags a point
// (the sign bit, infinity, a valid encoding).
//
// The field core is 12 x 32-bit limbs, the card's multiplier width: the
// Montgomery multiply interleaves its rows (CIOS) and keeps two
// accumulators, the products of even and of odd limbs, each row one carry
// chain of mad.lo.cc / madc.hi.cc per accumulator (two chains in flight);
// the squaring computes each cross product once into two accumulators,
// doubles, adds the diagonal and reduces. Every value that leaves the core
// is fully reduced (< q). Under #ifndef __CUDA_ARCH__ the same chains run
// as portable C with the carry flag emulated, so the host build runs the
// card's algorithm, limb for limb; the PTX path runs only on the card
// (plenum_tpu_torch/bls_field_core.py holds its chains against Python
// integers there). Every function is inlined into its kernel.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#else
// host build (csrc/bls381_host.cpp, behind cuda_host_shim.h)
typedef void* cudaStream_t;
static inline int cudaGetLastError() { return 0; }
#define LAUNCH(kernel, grid, block, stream, ...) \
  host_launch((grid), (block), kernel, __VA_ARGS__)
#endif

// the host build counts every Montgomery multiply, apart the squarings
// among them, and the inversion's 32 x 32-bit multiply-adds (a 64-bit
// product counted as two, as ops/bls381.py prices a multiply)
#ifdef BLS381_COUNT_MULS
#include <atomic>
static std::atomic<unsigned long long> bls_fp_muls{0}, bls_fp_sqrs{0},
    bls_int_mads{0};
#define COUNT_MUL() bls_fp_muls.fetch_add(1, std::memory_order_relaxed)
#define COUNT_SQR() bls_fp_sqrs.fetch_add(1, std::memory_order_relaxed)
#define COUNT_MADS(n) bls_int_mads.fetch_add(n, std::memory_order_relaxed)
#else
#define COUNT_MUL()
#define COUNT_SQR()
#define COUNT_MADS(n)
#endif

#define HD __host__ __device__
#define HDI __host__ __device__ __forceinline__

typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

#define NW 12                 // 32-bit limbs of a field element
#define BLS_LIMBS12 32        // 12-bit limbs of a packed coordinate

#define LINES_THREADS 64
#define LANES 6               // lanes of one job in the Miller and final
#define JOBS_PER_WARP 5       //   exponentiation launches
#define JOB_WARPS 2
#define JOB_THREADS (32 * JOB_WARPS)
#define JOBS_PER_BLOCK (JOBS_PER_WARP * JOB_WARPS)
#define MILLER_STEPS 68       // 63 doublings and 5 additions
#define AGG_PREP_THREADS 64   // the aggregates' decompression launch
#define AGG_STORE_THREADS 128 //   and their normalization: a warp a job
#define POW_WINDOW 5          // the sliding window of a fixed power in fp,
#define POW_WINDOW_FP2 4      //   in fp2 (its table as large as fp's)
#define POW_TABLE (1 << (POW_WINDOW - 1))          // its odd powers
#define POW_TABLE_FP2 (1 << (POW_WINDOW_FP2 - 1))
#define MSM_THREADS 128
#define MSM_BUCKET_THREADS 256
#define MSM_WINDOW_THREADS 256

// ------------------------------------------------------------ constants

#define Q0 0xb9feffffffffaaabULL
#define Q1 0x1eabfffeb153ffffULL
#define Q2 0x6730d2a0f6b0f624ULL
#define Q3 0x64774b84f38512bfULL
#define Q4 0x4b1ba7b6434bacd7ULL
#define Q5 0x1a0111ea397fe69aULL
#define LO(x) ((u32)(x))
#define HI(x) ((u32)((x) >> 32))
#define Q_WORDS \
  { LO(Q0), HI(Q0), LO(Q1), HI(Q1), LO(Q2), HI(Q2), \
    LO(Q3), HI(Q3), LO(Q4), HI(Q4), LO(Q5), HI(Q5) }
#define N0W 0xfffcfffdu       // -q^-1 mod 2^32
#define X_ABS 0xd201000000010000ULL

struct alignas(16) fp { u32 l[NW]; };
struct fp2 { fp c0, c1; };
struct fp4 { fp2 x, y; };      // x + y s, s^2 = xi = 1 + u
struct fp12p { fp4 p[3]; };    // p0 + p1 w + p2 w^2, w^3 = s

// an element from six 64-bit limbs (little-endian)
HDI fp fp_make(u64 a0, u64 a1, u64 a2, u64 a3, u64 a4, u64 a5) {
  fp r;
  const u64 v[6] = {a0, a1, a2, a3, a4, a5};
#pragma unroll
  for (int k = 0; k < 6; k++) {
    r.l[2 * k] = (u32)v[k];
    r.l[2 * k + 1] = (u32)(v[k] >> 32);
  }
  return r;
}

#define FP_ZERO fp_make(0, 0, 0, 0, 0, 0)
#define FP_RAW_ONE fp_make(1, 0, 0, 0, 0, 0)
// 1 in the Montgomery domain (R = 2^384), R^2 mod q
#define FP_ONE fp_make(0x760900000002fffdULL, 0xebf4000bc40c0002ULL, \
  0x5f48985753c758baULL, 0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, \
  0x15f65ec3fa80e493ULL)
#define FP_FOUR fp_make(0xaa270000000cfff3ULL, 0x53cc0032fc34000aULL, \
  0x478fe97a6b0a807fULL, 0xb1d37ebee6ba24d7ULL, 0x8ec9733bbf78ab2fULL, \
  0x09d645513d83de7eULL)
#define FP_R2 fp_make(0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, \
  0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, \
  0x11988fe592cae3aaULL)
// -1 in the Montgomery domain
#define FP_NEG_ONE fp_make(0x43f5fffffffcaaaeULL, 0x32b7fff2ed47fffdULL, \
  0x07e83a49a2e99d69ULL, 0xeca8f3318332bb7aULL, 0xef148d1ea0f4c069ULL, \
  0x040ab3263eff0206ULL)
// (q - 1) / 2, standard domain: y is "big" above it
#define FP_HALF fp_make(0xdcff7fffffffd555ULL, 0x0f55ffff58a9ffffULL, \
  0xb39869507b587b12ULL, 0xb23ba5c279c2895fULL, 0x258dd3db21a5d66bULL, \
  0x0d0088f51cbff34dULL)
// exponents: (q + 1) / 4 (the G1 square root), (q - 3) / 4 and
// (q - 1) / 2 (the fp2 square root), q - 2 (inversion)
#define EXP_SQRT fp_make(0xee7fbfffffffeaabULL, 0x07aaffffac54ffffULL, \
  0xd9cc34a83dac3d89ULL, 0xd91dd2e13ce144afULL, 0x92c6e9ed90d2eb35ULL, \
  0x0680447a8e5ff9a6ULL)
#define EXP_SQRT34 fp_make(0xee7fbfffffffeaaaULL, 0x07aaffffac54ffffULL, \
  0xd9cc34a83dac3d89ULL, 0xd91dd2e13ce144afULL, 0x92c6e9ed90d2eb35ULL, \
  0x0680447a8e5ff9a6ULL)
#define EXP_HALF FP_HALF
#define EXP_INV fp_make(0xb9feffffffffaaa9ULL, Q1, Q2, Q3, Q4, Q5)

// ----------------------------------------------------- carry chains
// One PTX instruction each on the card (asm volatile keeps their order, so
// the carry flag CC.CF flows from one to the next); on the host the same
// chain with the flag in a thread-local word.

#ifndef __CUDA_ARCH__
static thread_local u32 host_cf;
#endif

#ifdef __CUDA_ARCH__
#define PTX2(op, d, a, b) \
  asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b))
#define PTX3(op, d, a, b, c) \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c))
#endif

HDI u32 add_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX2("add.cc.u32", d, a, b);
  return d;
#else
  const u64 s = (u64)a + b;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

HDI u32 addc_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX2("addc.cc.u32", d, a, b);
  return d;
#else
  const u64 s = (u64)a + b + host_cf;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

HDI u32 addc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX2("addc.u32", d, a, b);
  return d;
#else
  return a + b + host_cf;
#endif
}

HDI u32 sub_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX2("sub.cc.u32", d, a, b);
  return d;
#else
  host_cf = a < b;
  return a - b;
#endif
}

HDI u32 subc_cc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX2("subc.cc.u32", d, a, b);
  return d;
#else
  const u64 d = (u64)a - b - host_cf;
  host_cf = (u32)(d >> 63);
  return (u32)d;
#endif
}

HDI u32 subc(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX2("subc.u32", d, a, b);
  return d;
#else
  return a - b - host_cf;
#endif
}

HDI u32 mad_lo_cc(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX3("mad.lo.cc.u32", d, a, b, c);
  return d;
#else
  const u64 s = (u64)(u32)((u64)a * b) + c;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

HDI u32 madc_lo_cc(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX3("madc.lo.cc.u32", d, a, b, c);
  return d;
#else
  const u64 s = (u64)(u32)((u64)a * b) + c + host_cf;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

HDI u32 madc_hi_cc(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX3("madc.hi.cc.u32", d, a, b, c);
  return d;
#else
  const u64 s = (((u64)a * b) >> 32) + c + host_cf;
  host_cf = (u32)(s >> 32);
  return (u32)s;
#endif
}

HDI u32 madc_hi(u32 a, u32 b, u32 c) {
#ifdef __CUDA_ARCH__
  u32 d;
  PTX3("madc.hi.u32", d, a, b, c);
  return d;
#else
  return (u32)(((u64)a * b) >> 32) + c + host_cf;
#endif
}

HDI u32 mul_hi(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (u32)(((u64)a * b) >> 32);
#endif
}

// -------------------------------------------------------------------- fp
// Every value is canonical (< q).

HDI bool fp_is_zero(const fp* a) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) acc |= a->l[i];
  return acc == 0;
}

HDI bool fp_eq(const fp* a, const fp* b) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) acc |= a->l[i] ^ b->l[i];
  return acc == 0;
}

// a > b as integers (both standard-domain values)
HDI bool fp_gt(const fp* a, const fp* b) {
  for (int i = NW - 1; i >= 0; i--) {
    if (a->l[i] != b->l[i]) return a->l[i] > b->l[i];
  }
  return false;
}

// t < 2q -> t mod q, in place
HDI void reduce_once(u32* t) {
  const u32 q[NW] = Q_WORDS;
  u32 d[NW];
  d[0] = sub_cc(t[0], q[0]);
#pragma unroll
  for (int k = 1; k < NW; k++) d[k] = subc_cc(t[k], q[k]);
  const u32 below = subc(0u, 0u);      // all ones when t < q
#pragma unroll
  for (int k = 0; k < NW; k++) t[k] = (t[k] & below) | (d[k] & ~below);
}

HDI void fp_add(fp* r, const fp* a, const fp* b) {
  u32 t[NW];
  t[0] = add_cc(a->l[0], b->l[0]);
#pragma unroll
  for (int k = 1; k < NW; k++) t[k] = addc_cc(a->l[k], b->l[k]);
  reduce_once(t);                      // a + b < 2q < 2^382: no carry out
#pragma unroll
  for (int k = 0; k < NW; k++) r->l[k] = t[k];
}

HDI void fp_sub(fp* r, const fp* a, const fp* b) {
  const u32 q[NW] = Q_WORDS;
  u32 t[NW];
  t[0] = sub_cc(a->l[0], b->l[0]);
#pragma unroll
  for (int k = 1; k < NW; k++) t[k] = subc_cc(a->l[k], b->l[k]);
  const u32 under = subc(0u, 0u);      // all ones when a < b: add q back
  t[0] = add_cc(t[0], q[0] & under);
#pragma unroll
  for (int k = 1; k < NW; k++) t[k] = addc_cc(t[k], q[k] & under);
#pragma unroll
  for (int k = 0; k < NW; k++) r->l[k] = t[k];
}

HDI void fp_neg(fp* r, const fp* a) {
  const u32 q[NW] = Q_WORDS;
  u32 t[NW], nz = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) nz |= a->l[k];
  const u32 keep = nz ? 0xffffffffu : 0u;   // -0 = 0
  t[0] = sub_cc(q[0], a->l[0]);
#pragma unroll
  for (int k = 1; k < NW; k++) t[k] = subc_cc(q[k], a->l[k]);
#pragma unroll
  for (int k = 0; k < NW; k++) r->l[k] = t[k] & keep;
}

// a / 2 mod q (a + q when a is odd, then a shift; a + q < 2^382)
HDI void fp_half(fp* r, const fp* a) {
  const u32 q[NW] = Q_WORDS;
  const u32 odd = 0u - (a->l[0] & 1u);
  u32 t[NW];
  t[0] = add_cc(a->l[0], q[0] & odd);
#pragma unroll
  for (int k = 1; k < NW; k++) t[k] = addc_cc(a->l[k], q[k] & odd);
#pragma unroll
  for (int k = 0; k < NW - 1; k++) r->l[k] = (t[k] >> 1) | (t[k + 1] << 31);
  r->l[NW - 1] = t[NW - 1] >> 1;
}

// Montgomery multiply a b R^-1 mod q. The running value is E + 2^32 O:
// E holds words 0..11, O words 1..12. A row adds a b_i (the even limbs'
// products into E, the odd limbs' into O: each a carry chain of disjoint
// (lo, hi) pairs), then m q with m = E[0] n0, which clears word 0; the
// division by 2^32 swaps the two arrays' roles, and the next row's chain
// into O carries E's word 1 across and shifts E down two words.
HDI void mont_first_row(u32* E, u32* O, const u32* a, u32 b0) {
#pragma unroll
  for (int j = 0; j < NW; j += 2) {
    E[j] = a[j] * b0;
    E[j + 1] = mul_hi(a[j], b0);
    O[j] = a[j + 1] * b0;
    O[j + 1] = mul_hi(a[j + 1], b0);
  }
}

HDI void mont_row(u32* E, u32* O, const u32* a, u32 bi) {
  // E: the new low array (the last row's O); O: the last row's E, whose
  // word 0 is zero
  E[0] = add_cc(E[0], O[1]);
#pragma unroll
  for (int k = 0; k < NW - 2; k += 2) {
    O[k] = madc_lo_cc(a[k + 1], bi, O[k + 2]);
    O[k + 1] = madc_hi_cc(a[k + 1], bi, O[k + 3]);
  }
  O[NW - 2] = madc_lo_cc(a[NW - 1], bi, 0u);
  O[NW - 1] = madc_hi(a[NW - 1], bi, 0u);
  E[0] = mad_lo_cc(a[0], bi, E[0]);
  E[1] = madc_hi_cc(a[0], bi, E[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    E[j] = madc_lo_cc(a[j], bi, E[j]);
    E[j + 1] = madc_hi_cc(a[j], bi, E[j + 1]);
  }
  O[NW - 1] = addc(O[NW - 1], 0u);
}

HDI void mont_reduce_row(u32* E, u32* O) {
  const u32 q[NW] = Q_WORDS;
  const u32 m = E[0] * N0W;
  O[0] = mad_lo_cc(q[1], m, O[0]);
  O[1] = madc_hi_cc(q[1], m, O[1]);
#pragma unroll
  for (int j = 3; j < NW; j += 2) {
    O[j - 1] = madc_lo_cc(q[j], m, O[j - 1]);
    O[j] = madc_hi_cc(q[j], m, O[j]);
  }
  E[0] = mad_lo_cc(q[0], m, E[0]);     // O's chain ends without a carry
  E[1] = madc_hi_cc(q[0], m, E[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    E[j] = madc_lo_cc(q[j], m, E[j]);
    E[j + 1] = madc_hi_cc(q[j], m, E[j + 1]);
  }
  O[NW - 1] = addc(O[NW - 1], 0u);
}

HDI void fp_mul(fp* r, const fp* pa, const fp* pb) {
  COUNT_MUL();
  const fp a = *pa, b = *pb;
  u32 A0[NW], A1[NW];
  mont_first_row(A0, A1, a.l, b.l[0]);
  mont_reduce_row(A0, A1);
#pragma unroll
  for (int i = 1; i < NW; i += 2) {
    mont_row(A1, A0, a.l, b.l[i]);
    mont_reduce_row(A1, A0);
    if (i + 1 < NW) {
      mont_row(A0, A1, a.l, b.l[i + 1]);
      mont_reduce_row(A0, A1);
    }
  }
  u32 t[NW];                           // A0 + A1 / 2^32 < 2q
  t[0] = add_cc(A0[0], A1[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; k++) t[k] = addc_cc(A0[k], A1[k + 1]);
  t[NW - 1] = addc(A0[NW - 1], 0u);
  reduce_once(t);
#pragma unroll
  for (int k = 0; k < NW; k++) r->l[k] = t[k];
}

// Montgomery square: the 66 cross products once, into two accumulators (a
// row's products a_i a_j with j - i odd land their low words on odd
// positions, with j - i even on even ones: each row is two chains of
// disjoint pairs), doubled, the diagonal added, then the low half reduced
// (12 rows of m q) and the high half added.
HDI void fp_sqr(fp* r, const fp* pa) {
  COUNT_MUL();
  COUNT_SQR();
  const fp a = *pa;
  const u32 q[NW] = Q_WORDS;
  u32 Od[2 * NW], Ev[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; k++) Od[k] = Ev[k] = 0;
#pragma unroll
  for (int i = 0; i < NW - 1; i++) {
#pragma unroll
    for (int par = 1; par <= 2; par++) {
      u32* acc = par == 1 ? Od : Ev;
      const int j0 = i + par;
      if (j0 >= NW) continue;
      acc[i + j0] = mad_lo_cc(a.l[i], a.l[j0], acc[i + j0]);
      acc[i + j0 + 1] = madc_hi_cc(a.l[i], a.l[j0], acc[i + j0 + 1]);
      int last = j0;
#pragma unroll
      for (int j = j0 + 2; j < NW; j += 2) {
        acc[i + j] = madc_lo_cc(a.l[i], a.l[j], acc[i + j]);
        acc[i + j + 1] = madc_hi_cc(a.l[i], a.l[j], acc[i + j + 1]);
        last = j;
      }
      acc[i + last + 2] = addc(acc[i + last + 2], 0u);
    }
  }
  u32 T[2 * NW];
  T[0] = add_cc(Od[0], Ev[0]);
#pragma unroll
  for (int k = 1; k < 2 * NW - 1; k++) T[k] = addc_cc(Od[k], Ev[k]);
  T[2 * NW - 1] = addc(Od[2 * NW - 1], Ev[2 * NW - 1]);
#pragma unroll
  for (int k = 2 * NW - 1; k > 0; k--) T[k] = (T[k] << 1) | (T[k - 1] >> 31);
  T[0] <<= 1;
  T[0] = mad_lo_cc(a.l[0], a.l[0], T[0]);
  T[1] = madc_hi_cc(a.l[0], a.l[0], T[1]);
#pragma unroll
  for (int i = 1; i < NW; i++) {
    T[2 * i] = madc_lo_cc(a.l[i], a.l[i], T[2 * i]);
    T[2 * i + 1] = madc_hi_cc(a.l[i], a.l[i], T[2 * i + 1]);
  }
  // reduce the low half: t = (T_lo + M q) / R <= q
  u32 t[NW + 1];
#pragma unroll
  for (int k = 0; k < NW; k++) t[k] = T[k];
  t[NW] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const u32 m = t[0] * N0W;
    t[0] = mad_lo_cc(q[0], m, t[0]);
    t[1] = madc_hi_cc(q[0], m, t[1]);
#pragma unroll
    for (int j = 2; j < NW; j += 2) {
      t[j] = madc_lo_cc(q[j], m, t[j]);
      t[j + 1] = madc_hi_cc(q[j], m, t[j + 1]);
    }
    t[NW] = addc(t[NW], 0u);
    t[1] = mad_lo_cc(q[1], m, t[1]);
    t[2] = madc_hi_cc(q[1], m, t[2]);
#pragma unroll
    for (int j = 3; j < NW - 1; j += 2) {
      t[j] = madc_lo_cc(q[j], m, t[j]);
      t[j + 1] = madc_hi_cc(q[j], m, t[j + 1]);
    }
    t[NW - 1] = madc_lo_cc(q[NW - 1], m, t[NW - 1]);
    t[NW] = madc_hi(q[NW - 1], m, t[NW]);
#pragma unroll
    for (int k = 0; k < NW; k++) t[k] = t[k + 1];   // t[0] was cleared
    t[NW] = 0;
  }
  // + T_hi (< q): < 2q
  t[0] = add_cc(t[0], T[NW]);
#pragma unroll
  for (int k = 1; k < NW - 1; k++) t[k] = addc_cc(t[k], T[NW + k]);
  t[NW - 1] = addc(t[NW - 1], T[2 * NW - 1]);
  reduce_once(t);
#pragma unroll
  for (int k = 0; k < NW; k++) r->l[k] = t[k];
}

// a^e for a public exponent e (standard-domain limbs), square-and-multiply
// from the top bit (Fermat's inversion: the pairing's final
// exponentiation, the MSM's normalization)
HDI void fp_pow(fp* r, const fp* a, const fp* e) {
  const fp base = *a;
  fp acc = base;
  bool started = false;
  for (int i = NW - 1; i >= 0; i--) {
    const u32 w = e->l[i];
    for (int b = 31; b >= 0; b--) {
      if (started) fp_sqr(&acc, &acc);
      if ((w >> b) & 1) {
        if (started) fp_mul(&acc, &acc, &base);
        started = true;
      }
    }
  }
  *r = acc;
}

HDI void fp_inv(fp* r, const fp* a) {
  const fp e = EXP_INV;
  fp_pow(r, a, &e);
}

HDI u32 exp_bits(const fp* e, int lo, int len) {
  const int w = lo >> 5;
  u64 v = e->l[w];
  if (w + 1 < NW) v |= (u64)e->l[w + 1] << 32;
  return (u32)(v >> (lo & 31)) & ((1u << len) - 1);
}

// The window's width: POW_WINDOW bits in fp, POW_WINDOW_FP2 in fp2, so
// that either table of odd powers takes 768 B
template <class F> struct window_bits { static constexpr int w = POW_WINDOW; };
template <> struct window_bits<fp2> {
  static constexpr int w = POW_WINDOW_FP2;
};
static_assert(POW_TABLE_FP2 * sizeof(fp2) == POW_TABLE * sizeof(fp),
              "the fp2 table fits a thread's fp table");

// a^e for a public exponent e > 0 by a sliding window of up to W bits over
// the odd powers a, a^3, .., a^(2^W - 1), which it writes to `tab` (2^(W-1)
// entries): for the square roots' exponents about 376 squarings and 81
// products at W = 5, 85 at W = 4, against 378 and 228 square-and-multiply
// (ops/bls381.py window_cost counts this loop). The exponent is the same
// on every lane, so the branches are uniform. K runs the products:
// fp_ops, or for fp2 solo or a trio.
template <class F, class K>
HDI void pow_window(F* r, const F* a, const fp* e, const K& k, F* tab) {
  constexpr int W = window_bits<F>::w;
  F a2, acc;
  tab[0] = *a;
  k.sqr(&a2, a);
#pragma unroll 1
  for (int i = 1; i < (1 << (W - 1)); i++)
    k.mul(&tab[i], &tab[i - 1], &a2);
  int bit = 32 * NW - 1;
  while (!exp_bits(e, bit, 1)) bit--;
  bool started = false;
#pragma unroll 1
  while (bit >= 0) {
    if (!exp_bits(e, bit, 1)) {
      k.sqr(&acc, &acc);
      bit--;
      continue;
    }
    int lo = bit - W + 1 < 0 ? 0 : bit - W + 1;
    while (!exp_bits(e, lo, 1)) lo++;
    const u32 v = exp_bits(e, lo, bit - lo + 1);
    if (started) {
#pragma unroll 1
      for (int s = lo; s <= bit; s++) k.sqr(&acc, &acc);
      k.mul(&acc, &acc, &tab[v >> 1]);
    } else {
      acc = tab[v >> 1];
      started = true;
    }
    bit = lo - 1;
  }
  *r = acc;
}

// the same with the table on the thread's stack (768 B). The driver holds
// 1 KB of stack for every thread the card can hold and grows that for a
// kernel whose frame is larger: the pairing's lines kernel, whose frame
// holds more, gives a slice of shared memory instead
template <class F, class K>
HDI void pow_window(F* r, const F* a, const fp* e, const K& k) {
  F tab[1 << (window_bits<F>::w - 1)];
  pow_window(r, a, e, k, tab);
}

// a chain of fp products on one thread
struct fp_ops {
  HDI void mul(fp* r, const fp* a, const fp* b) const { fp_mul(r, a, b); }
  HDI void sqr(fp* r, const fp* a) const { fp_sqr(r, a); }
};

HDI void fp_to_mont(fp* r, const fp* raw) {
  const fp r2 = FP_R2;
  fp_mul(r, raw, &r2);
}

HDI void fp_from_mont(fp* r, const fp* a) {
  const fp one = FP_RAW_ONE;
  fp_mul(r, a, &one);
}

// 32 limbs of 12 bits (int32, standard domain) <-> 12 words of 32 bits
HDI void fp_from_limbs12(fp* r, const int32_t* x) {
#pragma unroll
  for (int i = 0; i < NW; i++) r->l[i] = 0;
#pragma unroll
  for (int k = 0; k < BLS_LIMBS12; k++) {
    const u32 v = (u32)x[k] & 0xfff;
    const int bit = 12 * k, w = bit >> 5, s = bit & 31;
    r->l[w] |= v << s;
    if (s > 20 && w + 1 < NW) r->l[w + 1] |= v >> (32 - s);
  }
}

HDI void fp_to_limbs12(int32_t* out, const fp* a) {
#pragma unroll
  for (int k = 0; k < BLS_LIMBS12; k++) {
    const int bit = 12 * k, w = bit >> 5, s = bit & 31;
    u32 v = a->l[w] >> s;
    if (s > 20 && w + 1 < NW) v |= a->l[w + 1] << (32 - s);
    out[k] = (int32_t)(v & 0xfff);
  }
}

// 3b = 12 as additions
HDI void fp_mul12(fp* r, const fp* a) {
  fp t2, t4, t8;
  fp_add(&t2, a, a);
  fp_add(&t4, &t2, &t2);
  fp_add(&t8, &t4, &t4);
  fp_add(r, &t8, &t4);
}

// ------------------------------------------------------------------- fp2
// fp2 = fp[u] / (u^2 + 1)

HDI void fp2_add(fp2* r, const fp2* a, const fp2* b) {
  fp_add(&r->c0, &a->c0, &b->c0);
  fp_add(&r->c1, &a->c1, &b->c1);
}

HDI void fp2_sub(fp2* r, const fp2* a, const fp2* b) {
  fp_sub(&r->c0, &a->c0, &b->c0);
  fp_sub(&r->c1, &a->c1, &b->c1);
}

HDI void fp2_neg(fp2* r, const fp2* a) {
  fp_neg(&r->c0, &a->c0);
  fp_neg(&r->c1, &a->c1);
}

HDI void fp2_mul(fp2* r, const fp2* a, const fp2* b) {
  fp t0, t1, t2, t3;
  fp_add(&t2, &a->c0, &a->c1);
  fp_add(&t3, &b->c0, &b->c1);
  fp_mul(&t0, &a->c0, &b->c0);
  fp_mul(&t1, &a->c1, &b->c1);
  fp_mul(&t2, &t2, &t3);
  fp_sub(&t2, &t2, &t0);
  fp_sub(&r->c1, &t2, &t1);
  fp_sub(&r->c0, &t0, &t1);
}

// the complex squaring: (a0 + a1)(a0 - a1), 2 a0 a1
HDI void fp2_sqr(fp2* r, const fp2* a) {
  fp s, d, t;
  fp_add(&s, &a->c0, &a->c1);
  fp_sub(&d, &a->c0, &a->c1);
  fp_mul(&t, &a->c0, &a->c1);
  fp_mul(&r->c0, &s, &d);
  fp_add(&r->c1, &t, &t);
}

HDI void fp2_conj(fp2* r, const fp2* a) {
  r->c0 = a->c0;
  fp_neg(&r->c1, &a->c1);
}

HDI void fp2_inv(fp2* r, const fp2* a) {
  fp t0, t1;
  fp_sqr(&t0, &a->c0);
  fp_sqr(&t1, &a->c1);
  fp_add(&t0, &t0, &t1);
  fp_inv(&t0, &t0);
  fp_mul(&r->c0, &a->c0, &t0);
  fp_mul(&t1, &a->c1, &t0);
  fp_neg(&r->c1, &t1);
}

// xi = 1 + u
HDI void fp2_mul_xi(fp2* r, const fp2* a) {
  fp t0;
  fp_sub(&t0, &a->c0, &a->c1);
  fp_add(&r->c1, &a->c0, &a->c1);
  r->c0 = t0;
}

HDI void fp2_mul12(fp2* r, const fp2* a) {
  fp_mul12(&r->c0, &a->c0);
  fp_mul12(&r->c1, &a->c1);
}

HDI bool fp2_is_zero(const fp2* a) {
  return fp_is_zero(&a->c0) && fp_is_zero(&a->c1);
}

HDI bool fp2_eq(const fp2* a, const fp2* b) {
  return fp_eq(&a->c0, &b->c0) && fp_eq(&a->c1, &b->c1);
}

HDI void fp2_zero(fp2* r) {
  r->c0 = FP_ZERO;
  r->c1 = FP_ZERO;
}

// How a chain of fp2 products runs: on one thread (solo), or each product
// split over the three lanes of a trio; a thread's products are one chain
// of carry flags, so a lane each is what runs three at once.
struct solo {
  HDI void mul(fp2* r, const fp2* a, const fp2* b) const { fp2_mul(r, a, b); }
  HDI void sqr(fp2* r, const fp2* a) const { fp2_sqr(r, a); }
  HDI void mul1(fp* r, const fp* a, const fp* b) const { fp_mul(r, a, b); }
};

// an element from lane src of `mask` (the host build: one exchange)
__device__ __forceinline__ fp shfl_fp(u32 mask, const fp& v, int src) {
#if defined(CUDA_HOST_SHIM) && !defined(__CUDA_ARCH__)
  return host_shfl_value(mask, v, src);
#else
  fp r;
#pragma unroll
  for (int i = 0; i < NW; i++) r.l[i] = __shfl_sync(mask, v.l[i], src);
  return r;
#endif
}

// A group of lanes of one warp: lane l of the lanes base .. base + size - 1
// (mask). A pair holds one G2 key in the aggregates' decompression (a
// candidate root a lane); a trio splits each fp2 product of a chain (lane
// 0 a0 b0, lane 1 a1 b1, lane 2 (a0 + a1)(b0 + b1); a squaring over lanes
// 0 and 1), exchanging the three results by shuffles, so that a chain's
// products run three at once (bls381.cu's lines, a G2 key's decompression).
struct lane_span {
  int l, base;
  u32 mask;
};

template <int SIZE>
__device__ __forceinline__ lane_span lane_group() {
  lane_span g;
  const int lane = threadIdx.x & 31;
  g.l = lane % SIZE;
  g.base = lane - g.l;
  g.mask = ((1u << SIZE) - 1) << g.base;
  return g;
}

// lane j's part of the product a b: of fp the product; of fp2 (Karatsuba
// over three lanes) a0 b0, a1 b1 or (a0 + a1)(b0 + b1)
HDI fp part_mul(int, const fp& a, const fp& b) {
  fp t;
  fp_mul(&t, &a, &b);
  return t;
}

HDI fp part_mul(int j, const fp2& a, const fp2& b) {
  fp x, y, t;
  if (j == 2) {
    fp_add(&x, &a.c0, &a.c1);
    fp_add(&y, &b.c0, &b.c1);
  } else {
    x = j ? a.c1 : a.c0;
    y = j ? b.c1 : b.c0;
  }
  fp_mul(&t, &x, &y);
  return t;
}

struct trio : lane_span {
  __device__ void mul(fp2* r, const fp2* a, const fp2* b) const {
    const fp t = part_mul(l, *a, *b);
    const fp t0 = shfl_fp(mask, t, base), t1 = shfl_fp(mask, t, base + 1);
    fp t2 = shfl_fp(mask, t, base + 2);
    fp_sub(&t2, &t2, &t0);
    fp_sub(&r->c1, &t2, &t1);
    fp_sub(&r->c0, &t0, &t1);
  }
  __device__ void sqr(fp2* r, const fp2* a) const {
    fp x, y, t = FP_ZERO;
    if (l == 0) {
      fp_add(&x, &a->c0, &a->c1);
      fp_sub(&y, &a->c0, &a->c1);
    } else {
      x = a->c0;
      y = a->c1;
    }
    if (l < 2) fp_mul(&t, &x, &y);
    const fp t0 = shfl_fp(mask, t, base), t1 = shfl_fp(mask, t, base + 1);
    r->c0 = t0;
    fp_add(&r->c1, &t1, &t1);
  }
  __device__ void mul1(fp* r, const fp* a, const fp* b) const {
    fp t = FP_ZERO;
    if (l == 0) fp_mul(&t, a, b);
    *r = shfl_fp(mask, t, base);
  }
};

__device__ __forceinline__ trio lane_trio() {
  trio t;
  static_cast<lane_span&>(t) = lane_group<3>();
  return t;
}

// The square root of crypto/bls12_381.py Fq2.sqrt (q = 3 mod 4), both
// candidates computed and selected as the JAX tower's fp2_sqrt does; ok is
// root^2 == a. tab: its powers' table (POW_TABLE_FP2 entries).
template <class K>
HDI bool fp2_sqrt(fp2* root, const fp2* a, const K& k, fp2* tab) {
  const fp e34 = EXP_SQRT34, ehalf = EXP_HALF;
  fp2 a1, alpha, x0, t, cand, ux0;
  pow_window(&a1, a, &e34, k, tab);      // a^((q-3)/4)
  k.sqr(&alpha, &a1);
  k.mul(&alpha, &alpha, a);              // a1^2 a
  k.mul(&x0, &a1, a);                    // a1 a
  const fp neg1 = FP_NEG_ONE, one = FP_ONE;
  const bool is_neg1 = fp_eq(&alpha.c0, &neg1) && fp_is_zero(&alpha.c1);
  fp_neg(&ux0.c0, &x0.c1);               // u x0
  ux0.c1 = x0.c0;
  t = alpha;
  fp_add(&t.c0, &t.c0, &one);            // alpha + 1
  pow_window(&cand, &t, &ehalf, k, tab);
  k.mul(&cand, &cand, &x0);
  *root = is_neg1 ? ux0 : cand;
  k.sqr(&t, root);
  return fp2_eq(&t, a);
}

// ------------------------------------------------------ decompression

// crypto/bls12_381.py g1_decompress on a packed point: → ok (a valid
// encoding, and on the curve unless at infinity); (x, y) Montgomery when
// ok and not at infinity. Every valid finite point pays the same work, on
// the curve or not. tab: the square root's table (POW_TABLE entries).
HDI bool g1_decompress(fp* x, fp* y, const int32_t* x12, u8 sign, u8 inf,
                       u8 valid, fp* tab) {
  if (!valid) return false;
  if (inf) return true;
  fp raw, yy, t;
  const fp e = EXP_SQRT, half = FP_HALF, four = FP_FOUR;
  fp_from_limbs12(&raw, x12);
  fp_to_mont(x, &raw);
  fp_sqr(&yy, x);
  fp_mul(&yy, &yy, x);
  fp_add(&yy, &yy, &four);               // x^3 + 4
  pow_window(y, &yy, &e, fp_ops(), tab);
  fp_sqr(&t, y);
  const bool on_curve = fp_eq(&t, &yy);
  fp_from_mont(&t, y);
  if (fp_gt(&t, &half) != (sign != 0)) fp_neg(y, y);
  return on_curve;
}

// the same with the table on the thread's stack
HDI bool g1_decompress(fp* x, fp* y, const int32_t* x12, u8 sign, u8 inf,
                       u8 valid) {
  fp tab[POW_TABLE];
  return g1_decompress(x, y, x12, sign, inf, valid, tab);
}

// y's sign rule of crypto/bls12_381.py g2_decompress: (c1, c0) against
// -y's, lexicographically; y Montgomery, negated in place when its "big"
// does not match the flag (K: the two conversions' products)
template <class K>
HDI void g2_sign(fp2* y, u8 sign, const K& k) {
  const fp half = FP_HALF, one = FP_RAW_ONE;
  fp y0, y1;
  k.mul1(&y0, &y->c0, &one);             // from the Montgomery domain
  k.mul1(&y1, &y->c1, &one);
  const bool big = fp_is_zero(&y1) ? fp_gt(&y0, &half) : fp_gt(&y1, &half);
  if (big != (sign != 0)) fp2_neg(y, y);
}

// x from its packed limbs to the Montgomery domain, and y^2 = x^3 + 4(1 + u)
template <class K>
HDI void g2_rhs(fp2* x, fp2* yy, const int32_t* c1, const int32_t* c0,
                const K& k) {
  fp raw;
  const fp four = FP_FOUR, r2 = FP_R2;
  fp_from_limbs12(&raw, c0);
  k.mul1(&x->c0, &raw, &r2);
  fp_from_limbs12(&raw, c1);
  k.mul1(&x->c1, &raw, &r2);
  k.sqr(yy, x);
  k.mul(yy, yy, x);
  fp_add(&yy->c0, &yy->c0, &four);
  fp_add(&yy->c1, &yy->c1, &four);
}

// crypto/bls12_381.py g2_decompress: x = c0 + c1 u on y^2 = x^3 + 4(1 + u),
// the root by fp2_sqrt (the pairing's lines, on a trio; tab as there)
template <class K>
HDI bool g2_decompress(fp2* x, fp2* y, const int32_t* c1, const int32_t* c0,
                       u8 sign, u8 inf, u8 valid, const K& k, fp2* tab) {
  if (!valid) return false;
  if (inf) return true;
  fp2 yy;
  g2_rhs(x, &yy, c1, c0, k);
  const bool on_curve = fp2_sqrt(y, &yy, k, tab);
  g2_sign(y, sign, k);
  return on_curve;
}

// The same on a pair of lanes, the root by the norm (all in fp): for
// a = c0 + c1 u, s = (c0^2 + c1^2)^((q+1)/4); lane l takes the candidate
// t = (c0 + s) / 2 (lane 0) or (c0 - s) / 2 (lane 1), w = t^((q-3)/4),
// root (t w, c1 w / 2), since t w^2 = 1 when t is a square. Exactly one
// candidate is a square when a is one and c1 != 0; when c1 = 0 a candidate
// is 0, and that lane takes t = -c0 with the root (0, t w). A lane keeps
// its root when it squares to a, lane 0's first. Two fixed powers in a row,
// each on fp, against fp2_sqrt's two in fp2.
__device__ __forceinline__ bool g2_decompress_norm(
    fp2* x, fp2* y, const int32_t* c1, const int32_t* c0, u8 sign, u8 inf,
    u8 valid, const lane_span& g) {
  if (!valid) return false;
  if (inf) return true;
  const fp e = EXP_SQRT, e34 = EXP_SQRT34;
  fp2 a, r, sq;
  fp n, s, t, w;
  g2_rhs(x, &a, c1, c0, solo());
  fp_sqr(&n, &a.c0);
  fp_sqr(&t, &a.c1);
  fp_add(&n, &n, &t);                    // the norm
  pow_window(&s, &n, &e, fp_ops());
  if (g.l) fp_sub(&t, &a.c0, &s);
  else fp_add(&t, &a.c0, &s);
  fp_half(&t, &t);
  const bool rot = fp_is_zero(&t);
  if (rot) fp_neg(&t, &a.c0);
  pow_window(&w, &t, &e34, fp_ops());
  fp_mul(&r.c0, &t, &w);
  fp_mul(&r.c1, &a.c1, &w);
  fp_half(&r.c1, &r.c1);
  if (rot) {
    r.c1 = r.c0;
    r.c0 = FP_ZERO;
  }
  fp2_sqr(&sq, &r);
  const u32 votes = (__ballot_sync(g.mask, fp2_eq(&sq, &a)) >> g.base) & 3u;
  const int src = g.base + (votes & 1u ? 0 : 1);
  y->c0 = shfl_fp(g.mask, r.c0, src);
  y->c1 = shfl_fp(g.mask, r.c1, src);
  g2_sign(y, sign, solo());
  return votes != 0;
}

// ------------------------------------------- inversion by safegcd
// Bernstein and Yang's safegcd in its variable-time form, as libsecp256k1's
// modinv32_var has it, on 13 signed 30-bit limbs for the 381-bit q: a
// batch of 30 divsteps on the low words gives a transition matrix (entries
// within 2^30), which then updates f and g (exactly, divided by 2^30) and
// d and e (mod q), until g = 0; then f = +-1 and d = +-a^-1. It runs on
// public values (the aggregates of shares and keys). A batch costs 264
// multiply-adds (d, e and f, g at full length) against a Montgomery
// multiply's 588, and a 381-bit q takes at least 13 batches: after N
// divsteps the integer matrix 2^N T has entries within 2^N, and its row
// that sends g to 0 is a multiple of (a, -q).

#define SG_LIMBS 13
#define SG_M30 0x3fffffff
#define SG_QINV30 0x30003u      // q^-1 mod 2^30
struct s30 { int32_t v[SG_LIMBS]; };

HDI s30 sg_q() {
  const s30 q = {{0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e,
                  0x034a83da, 0x112bf673, 0x12e13ce1, 0x2cd76477, 0x1ed90d2e,
                  0x29a4b1ba, 0x3a8e5ff9, 0x001a0111}};
  return q;
}

// 30 divsteps on the low words of f (odd) and g from eta = -delta: the
// matrix (u v; q r) with 2^30 (f', g') = (u f + v g, q f + r g). Zeros of g
// go at once; an odd g loses up to 8 low bits a step by a multiple of f
// (f's inverse mod 2^8 by two Newton steps).
HDI int32_t sg_divsteps(int32_t eta, u32 f, u32 g, int32_t* t) {
  u32 u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (;;) {
    const u32 z = g | (0xffffffffu << i);
#ifdef __CUDA_ARCH__
    const int zeros = __ffs(z) - 1;
#else
    const int zeros = __builtin_ctz(z);
#endif
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {
      u32 tmp;
      eta = -eta;
      tmp = f; f = g; g = 0u - tmp;
      tmp = u; u = q; q = 0u - tmp;
      tmp = v; v = r; r = 0u - tmp;
    }
    const int limit = eta + 1 > i ? i : eta + 1;
    const u32 m = (0xffffffffu >> (32 - limit)) & 255u;
    u32 fi = f;                          // f^-1 mod 8, then mod 2^12
    fi *= 2u - f * fi;
    fi *= 2u - f * fi;
    const u32 w = (g * (0u - fi)) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return eta;
}

// (d, e) <- (t (d, e) + q (md, me)) / 2^30, md and me chosen so that the
// low 30 bits vanish and d, e stay within (-2q, q)
HDI void sg_update_de(s30* d, s30* e, const int32_t* t) {
  COUNT_MADS(2 * (6 * SG_LIMBS + 2));
  const s30 mq = sg_q();
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d->v[SG_LIMBS - 1] >> 31, se = e->v[SG_LIMBS - 1] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d->v[0] + (int64_t)v * e->v[0];
  int64_t ce = (int64_t)q * d->v[0] + (int64_t)r * e->v[0];
  md -= (int32_t)((SG_QINV30 * (u32)cd + (u32)md) & SG_M30);
  me -= (int32_t)((SG_QINV30 * (u32)ce + (u32)me) & SG_M30);
  cd += (int64_t)mq.v[0] * md;
  ce += (int64_t)mq.v[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < SG_LIMBS; i++) {
    cd += (int64_t)u * d->v[i] + (int64_t)v * e->v[i];
    ce += (int64_t)q * d->v[i] + (int64_t)r * e->v[i];
    cd += (int64_t)mq.v[i] * md;
    ce += (int64_t)mq.v[i] * me;
    d->v[i - 1] = (int32_t)cd & SG_M30;
    cd >>= 30;
    e->v[i - 1] = (int32_t)ce & SG_M30;
    ce >>= 30;
  }
  d->v[SG_LIMBS - 1] = (int32_t)cd;
  e->v[SG_LIMBS - 1] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30, exact
HDI void sg_update_fg(s30* f, s30* g, const int32_t* t) {
  COUNT_MADS(2 * 4 * SG_LIMBS);
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f->v[0] + (int64_t)v * g->v[0];
  int64_t cg = (int64_t)q * f->v[0] + (int64_t)r * g->v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < SG_LIMBS; i++) {
    cf += (int64_t)u * f->v[i] + (int64_t)v * g->v[i];
    cg += (int64_t)q * f->v[i] + (int64_t)r * g->v[i];
    f->v[i - 1] = (int32_t)cf & SG_M30;
    cf >>= 30;
    g->v[i - 1] = (int32_t)cg & SG_M30;
    cg >>= 30;
  }
  f->v[SG_LIMBS - 1] = (int32_t)cf;
  g->v[SG_LIMBS - 1] = (int32_t)cg;
}

// d in (-2q, q), negated when sign < 0 → [0, q), limbs within [0, 2^30)
HDI void sg_normalize(s30* d, int32_t sign) {
  const s30 mq = sg_q();
  int32_t add = d->v[SG_LIMBS - 1] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < SG_LIMBS; i++) {
    d->v[i] += mq.v[i] & add;
    d->v[i] = (d->v[i] ^ neg) - neg;
  }
#pragma unroll
  for (int i = 0; i < SG_LIMBS - 1; i++) {
    d->v[i + 1] += d->v[i] >> 30;
    d->v[i] &= SG_M30;
  }
  add = d->v[SG_LIMBS - 1] >> 31;
#pragma unroll
  for (int i = 0; i < SG_LIMBS; i++) d->v[i] += mq.v[i] & add;
#pragma unroll
  for (int i = 0; i < SG_LIMBS - 1; i++) {
    d->v[i + 1] += d->v[i] >> 30;
    d->v[i] &= SG_M30;
  }
}

// r = a^-1 for a standard-domain a != 0 (variable time)
HDI void fp_inv_var(fp* r, const fp* a) {
  s30 d, e, f = sg_q(), g;
#pragma unroll
  for (int i = 0; i < SG_LIMBS; i++) {
    const int bit = 30 * i, w = bit >> 5;
    u64 v = a->l[w];
    if (w + 1 < NW) v |= (u64)a->l[w + 1] << 32;
    g.v[i] = (int32_t)((v >> (bit & 31)) & SG_M30);
    d.v[i] = e.v[i] = 0;
  }
  e.v[0] = 1;
  int32_t eta = -1, t[4];
#pragma unroll 1
  for (;;) {
    eta = sg_divsteps(eta, (u32)f.v[0], (u32)g.v[0], t);
    sg_update_de(&d, &e, t);
    sg_update_fg(&f, &g, t);
    int32_t nz = 0;
#pragma unroll
    for (int i = 0; i < SG_LIMBS; i++) nz |= g.v[i];
    if (nz == 0) break;
  }
  sg_normalize(&d, f.v[SG_LIMBS - 1]);
#pragma unroll
  for (int k = 0; k < NW; k++) r->l[k] = 0;
#pragma unroll
  for (int i = 0; i < SG_LIMBS; i++) {
    const int bit = 30 * i, w = bit >> 5, s = bit & 31;
    const u32 v = (u32)d.v[i];
    r->l[w] |= v << s;
    if (s > 2 && w + 1 < NW) r->l[w + 1] |= v >> (32 - s);
  }
}

// ---------------------------------------------- complete additions (RCB)
// Renes-Costello-Batina 2016, a = 0, the multiply by 3b as additions:
// complete addition (Alg. 7, 12 multiplies) and mixed addition of an
// affine point (Alg. 8, 11). Alg. 7 is the JAX tower's padd_rcb: one
// formula for every pair of points, the identity (0 : 1 : 0) included;
// Alg. 8 adds a finite affine point to any point (the curves here have odd
// order, so no point has y = 0). The lane-split forms (sx_*) follow.

HDI void f_add(fp* r, const fp* a, const fp* b) { fp_add(r, a, b); }
HDI void f_sub(fp* r, const fp* a, const fp* b) { fp_sub(r, a, b); }
HDI void f_mul(fp* r, const fp* a, const fp* b) { fp_mul(r, a, b); }
HDI void f_mul_b3(fp* r, const fp* a) { fp_mul12(r, a); }       // 3b = 12
HDI void f_add(fp2* r, const fp2* a, const fp2* b) { fp2_add(r, a, b); }
HDI void f_sub(fp2* r, const fp2* a, const fp2* b) { fp2_sub(r, a, b); }
HDI void f_mul(fp2* r, const fp2* a, const fp2* b) { fp2_mul(r, a, b); }
HDI void f_mul_b3(fp2* r, const fp2* a) {          // 3b' = 12 (1 + u)
  fp2 t;
  fp2_mul_xi(&t, a);
  fp2_mul12(r, &t);
}
template <class F>
struct proj { F X, Y, Z; };

template <class F>
struct aff { F x, y; };

// p + (x, y, 1) for a finite affine point, on one thread (the MSM's
// buckets)
HDI void rcb_madd(proj<fp>* r, const proj<fp>* p, const fp* x, const fp* y) {
  fp t0, t1, t2, t3, t4, X3, Y3, Z3;
  f_mul(&t0, &p->X, x);
  f_mul(&t1, &p->Y, y);
  f_add(&t3, x, y);
  f_add(&t4, &p->X, &p->Y);
  f_mul(&t3, &t3, &t4);
  f_add(&t4, &t0, &t1);
  f_sub(&t3, &t3, &t4);
  f_mul(&t4, y, &p->Z);
  f_add(&t4, &t4, &p->Y);
  f_mul(&Y3, x, &p->Z);
  f_add(&Y3, &Y3, &p->X);
  f_add(&X3, &t0, &t0);
  f_add(&t0, &X3, &t0);
  f_mul_b3(&t2, &p->Z);
  f_add(&Z3, &t1, &t2);
  f_sub(&t1, &t1, &t2);
  f_mul_b3(&Y3, &Y3);
  f_mul(&X3, &t4, &Y3);
  f_mul(&t2, &t3, &t1);
  f_sub(&X3, &t2, &X3);
  f_mul(&Y3, &Y3, &t0);
  f_mul(&t1, &t1, &Z3);
  f_add(&Y3, &t1, &Y3);
  f_mul(&t0, &t0, &t3);
  f_mul(&Z3, &Z3, &t4);
  f_add(&Z3, &Z3, &t0);
  r->X = X3;
  r->Y = Y3;
  r->Z = Z3;
}

HDI void set_identity(proj<fp>* p) {
  p->X = FP_ZERO;
  p->Y = FP_ONE;
  p->Z = FP_ZERO;
}

HDI void set_identity(proj<fp2>* p) {
  fp2_zero(&p->X);
  fp2_zero(&p->Y);
  fp2_zero(&p->Z);
  p->Y.c0 = FP_ONE;
}

// ------------------------------------------------------------- sextets
// A sextet: the lanes of a warp that hold the same point and split each
// level of an RCB formula's independent products, product i on its own
// lanes, sharing them by shuffles: an addition or a mixed addition is two
// levels (five or six products, then six), a doubling two levels of four
// (its squarings as products). A product of fp takes one lane (six lanes a
// sextet, five sextets a warp), a product of fp2 three (a trio: a0 b0,
// a1 b1, (a0 + a1)(b0 + b1); eighteen lanes a sextet, one a warp). A
// lane's products are one chain of carry flags, so the lanes run them at
// once: an addition takes two multiplies' latency, not twelve.

template <class F> struct parts;
template <> struct parts<fp> { static constexpr int n = 1; };
template <> struct parts<fp2> { static constexpr int n = 3; };

// A sextet of trios combines its products' parts in shared memory (its
// sx_buf): each component once, on one lane, where shuffling the parts to
// every lane had each lane combine all of them. A product of fp lies
// whole on one lane and moves by shuffles (no buffer).
template <class F> struct sx_buf {};
template <> struct sx_buf<fp2> {
  fp part[18];
  fp2 m[6];
};

struct sextet : lane_span {
  void* buf;
};

template <class F = fp>
__device__ __forceinline__ sextet lane_sextet(sx_buf<F>* buf = nullptr) {
  sextet g;
  static_cast<lane_span&>(g) = lane_group<6 * parts<F>::n>();
  g.buf = buf;
  return g;
}

// the sextet's index in the block, or -1 for the lanes past the warp's last
template <class F = fp>
__device__ __forceinline__ int sextet_index() {
  constexpr int size = 6 * parts<F>::n, per = 32 / size;
  const int lane = threadIdx.x & 31;
  return lane >= per * size ? -1 : (threadIdx.x >> 5) * per + lane / size;
}

// m[k] for k < N from the lanes' parts t (lane l the part of product
// l / P): fp by shuffles; fp2 through the sextet's buffer, lane 2k + c
// combining component c of product k (c0 = t0 - t1, c1 = t2 - t0 - t1)
template <int N>
__device__ __forceinline__ void gather(const sextet& g, fp* m, const fp& t) {
#pragma unroll
  for (int k = 0; k < N; k++) m[k] = shfl_fp(g.mask, t, g.base + k);
}

template <int N>
__device__ __forceinline__ void gather(const sextet& g, fp2* m,
                                       const fp& t) {
  sx_buf<fp2>* b = (sx_buf<fp2>*)g.buf;
  b->part[g.l] = t;
  __syncwarp(g.mask);
  if (g.l < 2 * N) {
    const int k = g.l >> 1;
    fp r;
    if (g.l & 1) {
      fp_sub(&r, &b->part[3 * k + 2], &b->part[3 * k]);
      fp_sub(&b->m[k].c1, &r, &b->part[3 * k + 1]);
    } else {
      fp_sub(&b->m[k].c0, &b->part[3 * k], &b->part[3 * k + 1]);
    }
  }
  __syncwarp(g.mask);
#pragma unroll
  for (int k = 0; k < N; k++) m[k] = b->m[k];
}

// m[i] = x y for i < N, where ops(i, &x, &y) gives product i's operands
// (each lane asks only for its own product's). A lane reads the buffer's
// products before its next level's part can land (the __syncwarp after
// the parts), and combines the parts before any lane writes new ones.
template <int N, class F, class Ops>
__device__ __forceinline__ void sx_level(const sextet& g, F* m,
                                         const Ops& ops) {
  constexpr int P = parts<F>::n;
  const int i = g.l / P;
  F x, y;
  ops(i < N ? i : 0, &x, &y);
  fp t = FP_ZERO;
  if (i < N) t = part_mul(g.l % P, x, y);
  gather<N>(g, m, t);
}

// a ? b : c, on every limb
template <class F>
HDI F pick(bool a, const F& b, const F& c) { return a ? b : c; }

// a coordinate of p (i < 3) or the sum X + Y, Y + Z, X + Z (i = 3, 4, 5)
template <class F>
HDI void coord_sum(F* r, const proj<F>* p, int i) {
  *r = pick(i == 0 || i == 3 || i == 5, p->X, pick(i == 2, p->Z, p->Y));
  if (i >= 3) {
    const F b = pick(i == 3, p->Y, p->Z);
    f_add(r, r, &b);
  }
}

// the second level of Alg. 7 and 8 from (t0, t1, t3, t4, Y3, Z3):
// X3 = t3 t1 - t4 Y3, Y3 = t1 Z3 + Y3 t0, Z3 = Z3 t4 + t0 t3
template <class F>
__device__ __forceinline__ void sx_add_tail(const sextet& g, proj<F>* r,
                                            const F& t0, const F& t1,
                                            const F& t3, const F& t4,
                                            const F& Y3, const F& Z3) {
  F m[6];
  sx_level<6>(g, m, [&](int i, F* x, F* y) {
    *x = pick(i == 0, t4, pick(i == 1, t3, pick(i == 2, Y3,
         pick(i == 3, t1, pick(i == 4, t0, Z3)))));
    *y = pick(i == 0, Y3, pick(i == 1, t1, pick(i == 2, t0,
         pick(i == 3, Z3, pick(i == 4, t3, t4)))));
  });
  f_sub(&r->X, &m[1], &m[0]);
  f_add(&r->Y, &m[3], &m[2]);
  f_add(&r->Z, &m[5], &m[4]);
}

// rcb_add (RCB Alg. 7) in two levels of six products
template <class F>
__device__ __forceinline__ void sx_add(const sextet& g, proj<F>* r,
                                       const proj<F>* p, const proj<F>* q) {
  F m[6], t0, t1, t2, t3, t4, Y3, Z3, u;
  sx_level<6>(g, m, [&](int i, F* x, F* y) {
    coord_sum(x, p, i);
    coord_sum(y, q, i);
  });
  t0 = m[0]; t1 = m[1]; t2 = m[2];
  f_add(&u, &t0, &t1); f_sub(&t3, &m[3], &u);
  f_add(&u, &t1, &t2); f_sub(&t4, &m[4], &u);
  f_add(&u, &t0, &t2); f_sub(&Y3, &m[5], &u);
  f_add(&u, &t0, &t0); f_add(&t0, &u, &t0);            // 3 t0
  f_mul_b3(&t2, &t2);
  f_add(&Z3, &t1, &t2); f_sub(&t1, &t1, &t2);
  f_mul_b3(&Y3, &Y3);
  sx_add_tail(g, r, t0, t1, t3, t4, Y3, Z3);
}

// p + a for a finite affine a (RCB Alg. 8) in two levels: five products,
// then six
template <class F>
__device__ __forceinline__ void sx_madd(const sextet& g, proj<F>* r,
                                        const proj<F>* p, const aff<F>* a) {
  F m[5], t0, t1, t2, t3, t4, Y3, Z3, u;
  sx_level<5>(g, m, [&](int i, F* x, F* y) {
    // (X, x), (Y, y), (X + Y, x + y), (Z, y), (Z, x)
    *x = pick(i == 0, p->X, pick(i == 1, p->Y, p->Z));
    *y = pick(i == 1 || i == 3, a->y, a->x);
    if (i == 2) {
      f_add(x, &p->X, &p->Y);
      f_add(y, &a->x, &a->y);
    }
  });
  t0 = m[0]; t1 = m[1];
  f_add(&u, &t0, &t1); f_sub(&t3, &m[2], &u);
  f_add(&t4, &m[3], &p->Y);
  f_add(&Y3, &m[4], &p->X);
  f_add(&u, &t0, &t0); f_add(&t0, &u, &t0);            // 3 t0
  f_mul_b3(&t2, &p->Z);
  f_add(&Z3, &t1, &t2); f_sub(&t1, &t1, &t2);
  f_mul_b3(&Y3, &Y3);
  sx_add_tail(g, r, t0, t1, t3, t4, Y3, Z3);
}

// the doubling (RCB Alg. 9, a = 0) in two levels of four products
__device__ __forceinline__ void sx_dbl(const sextet& g, proj<fp>* r,
                                       const proj<fp>* p) {
  fp m[4], t0, t2, Z3, Y3, u;
  sx_level<4>(g, m, [&](int i, fp* x, fp* y) {
    // Y^2, Y Z, Z^2, X Y
    *x = pick(i == 2, p->Z, pick(i == 3, p->X, p->Y));
    *y = pick(i == 0 || i == 3, p->Y, p->Z);
  });
  t0 = m[0];
  fp_add(&Z3, &t0, &t0); fp_add(&Z3, &Z3, &Z3); fp_add(&Z3, &Z3, &Z3);
  fp_mul12(&t2, &m[2]);
  fp_add(&Y3, &t0, &t2);
  fp_add(&u, &t2, &t2); fp_add(&u, &u, &t2);           // 3 t2
  fp_sub(&t0, &t0, &u);
  const fp t1 = m[1], xy = m[3];
  sx_level<4>(g, m, [&](int i, fp* x, fp* y) {
    // X3 = t2 Z3, Z3 = t1 Z3, Y3 = t0 Y3, t0 X Y
    *x = pick(i == 0, t2, pick(i == 1, t1, t0));
    *y = pick(i <= 1, Z3, pick(i == 2, Y3, xy));
  });
  fp_add(&r->Y, &m[0], &m[2]);
  fp_add(&r->X, &m[3], &m[3]);
  r->Z = m[1];
}

// ------------------------------------------------------------- stores

// Normalized standard-domain coordinates: (x, y, 1), or (0, 1, 0) for the
// identity, as 12-bit limbs; Z inverted by Fermat (the MSM).
HDI void store_g1(int32_t* X, int32_t* Y, int32_t* Z, const proj<fp>* p) {
  fp x = FP_ZERO, y = FP_RAW_ONE, z = FP_ZERO;
  if (!fp_is_zero(&p->Z)) {
    fp zi;
    fp_inv(&zi, &p->Z);
    fp_mul(&x, &p->X, &zi);
    fp_mul(&y, &p->Y, &zi);
    fp_from_mont(&x, &x);
    fp_from_mont(&y, &y);
    z = FP_RAW_ONE;
  }
  fp_to_limbs12(X, &x);
  fp_to_limbs12(Y, &y);
  fp_to_limbs12(Z, &z);
}

// The same by safegcd (the aggregates): z = Z from the Montgomery domain,
// its inverse in the standard domain, and a Montgomery product of X with
// it is X / z in the standard domain already.
HDI void normalize_g1(int32_t* X, int32_t* Y, int32_t* Z,
                      const proj<fp>* p) {
  fp x = FP_ZERO, y = FP_RAW_ONE, z = FP_ZERO;
  if (!fp_is_zero(&p->Z)) {
    fp_from_mont(&z, &p->Z);
    fp_inv_var(&z, &z);
    fp_mul(&x, &p->X, &z);
    fp_mul(&y, &p->Y, &z);
    z = FP_RAW_ONE;
  }
  fp_to_limbs12(X, &x);
  fp_to_limbs12(Y, &y);
  fp_to_limbs12(Z, &z);
}

// over fp2, [2][32] limbs each (c0, then c1): 1 / Z = conj(Z) / N(Z), the
// norm N(Z) = Z0^2 + Z1^2 inverted as above
HDI void normalize_g2(int32_t* X, int32_t* Y, int32_t* Z,
                      const proj<fp2>* p) {
  fp2 x, y, z;
  fp2_zero(&x);
  fp2_zero(&z);
  y = x;
  y.c0 = FP_RAW_ONE;
  if (!fp2_is_zero(&p->Z)) {
    fp n, t;
    fp2 zi;
    fp_sqr(&n, &p->Z.c0);
    fp_sqr(&t, &p->Z.c1);
    fp_add(&n, &n, &t);
    fp_from_mont(&n, &n);
    fp_inv_var(&n, &n);
    fp_mul(&zi.c0, &p->Z.c0, &n);        // standard domain
    fp_mul(&t, &p->Z.c1, &n);
    fp_neg(&zi.c1, &t);
    fp2_mul(&x, &p->X, &zi);
    fp2_mul(&y, &p->Y, &zi);
    z.c0 = FP_RAW_ONE;
  }
  fp_to_limbs12(X, &x.c0);
  fp_to_limbs12(X + BLS_LIMBS12, &x.c1);
  fp_to_limbs12(Y, &y.c0);
  fp_to_limbs12(Y + BLS_LIMBS12, &y.c1);
  fp_to_limbs12(Z, &z.c0);
  fp_to_limbs12(Z + BLS_LIMBS12, &z.c1);
}

static inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }
