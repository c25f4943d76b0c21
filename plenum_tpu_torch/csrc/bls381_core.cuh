// The BLS12-381 arithmetic that the kernels of bls381.cu (the pairing),
// bls381_agg.cu (the G1 and G2 aggregates) and bls381_msm.cu (the G1 MSM)
// share: the field core, fp2, decompression of packed points, the RCB
// additions and the normalized stores. Each of the three sources builds
// into a library of its own (ops/cuda_lib.py), all at once; the host build
// (bls381_host.cpp) includes all three.
//
// The formulas are those of the port's host library, csrc/bls12_381.c:
// Montgomery arithmetic mod q with R = 2^384, the fp2 tower over u^2 = -1.
// Exact departures: inversion is Fermat's (a^(q-2)); the G2 square root
// computes both candidates and selects, as the JAX tower does
// (plenum_tpu/ops/bls381_tower.py:290); the multiply by 3b in the RCB
// additions is additions.
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

// the host build counts every Montgomery multiply, and apart the squarings
// among them
#ifdef BLS381_COUNT_MULS
#include <atomic>
static std::atomic<unsigned long long> bls_fp_muls{0}, bls_fp_sqrs{0};
#define COUNT_MUL() bls_fp_muls.fetch_add(1, std::memory_order_relaxed)
#define COUNT_SQR() bls_fp_sqrs.fetch_add(1, std::memory_order_relaxed)
#else
#define COUNT_MUL()
#define COUNT_SQR()
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
#define AGG_THREADS 128       // a power of two: the tree sum halves it
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
// from the top bit
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
// split over the three lanes of a trio (bls381.cu's lines kernel); a
// thread's products are one chain of carry flags, so a lane each is what
// runs three at once.
struct solo {
  HDI void mul(fp2* r, const fp2* a, const fp2* b) const { fp2_mul(r, a, b); }
  HDI void sqr(fp2* r, const fp2* a) const { fp2_sqr(r, a); }
  HDI void mul1(fp* r, const fp* a, const fp* b) const { fp_mul(r, a, b); }
};

template <class K = solo>
HDI void fp2_pow(fp2* r, const fp2* a, const fp* e, const K& k = K()) {
  const fp2 base = *a;
  fp2 acc = base;
  bool started = false;
  for (int i = NW - 1; i >= 0; i--) {
    const u32 w = e->l[i];
    for (int b = 31; b >= 0; b--) {
      if (started) k.sqr(&acc, &acc);
      if ((w >> b) & 1) {
        if (started) k.mul(&acc, &acc, &base);
        started = true;
      }
    }
  }
  *r = acc;
}

// The square root of crypto/bls12_381.py Fq2.sqrt (q = 3 mod 4), both
// candidates computed and selected as the JAX tower's fp2_sqrt does; ok is
// root^2 == a.
template <class K = solo>
HDI bool fp2_sqrt(fp2* root, const fp2* a, const K& k = K()) {
  const fp e34 = EXP_SQRT34, ehalf = EXP_HALF;
  fp2 a1, alpha, x0, t, cand, ux0;
  fp2_pow(&a1, a, &e34, k);              // a^((q-3)/4)
  k.sqr(&alpha, &a1);
  k.mul(&alpha, &alpha, a);              // a1^2 a
  k.mul(&x0, &a1, a);                    // a1 a
  const fp neg1 = FP_NEG_ONE, one = FP_ONE;
  const bool is_neg1 = fp_eq(&alpha.c0, &neg1) && fp_is_zero(&alpha.c1);
  fp_neg(&ux0.c0, &x0.c1);               // u x0
  ux0.c1 = x0.c0;
  t = alpha;
  fp_add(&t.c0, &t.c0, &one);            // alpha + 1
  fp2_pow(&cand, &t, &ehalf, k);
  k.mul(&cand, &cand, &x0);
  *root = is_neg1 ? ux0 : cand;
  k.sqr(&t, root);
  return fp2_eq(&t, a);
}

// ------------------------------------------------------ decompression

// crypto/bls12_381.py g1_decompress on a packed point: → ok (a valid
// encoding, and on the curve unless at infinity); (x, y) Montgomery when
// ok and not at infinity. Every valid finite point pays the same work, on
// the curve or not.
HDI bool g1_decompress(fp* x, fp* y, const int32_t* x12, u8 sign, u8 inf,
                       u8 valid) {
  if (!valid) return false;
  if (inf) return true;
  fp raw, yy, t;
  const fp e = EXP_SQRT, half = FP_HALF, four = FP_FOUR;
  fp_from_limbs12(&raw, x12);
  fp_to_mont(x, &raw);
  fp_sqr(&yy, x);
  fp_mul(&yy, &yy, x);
  fp_add(&yy, &yy, &four);               // x^3 + 4
  fp_pow(y, &yy, &e);
  fp_sqr(&t, y);
  const bool on_curve = fp_eq(&t, &yy);
  fp_from_mont(&t, y);
  if (fp_gt(&t, &half) != (sign != 0)) fp_neg(y, y);
  return on_curve;
}

// crypto/bls12_381.py g2_decompress: x = c0 + c1 u on y^2 = x^3 + 4(1 + u);
// the sign is y's (c1, c0) against -y's, lexicographically
template <class K = solo>
HDI bool g2_decompress(fp2* x, fp2* y, const int32_t* c1, const int32_t* c0,
                       u8 sign, u8 inf, u8 valid, const K& k = K()) {
  if (!valid) return false;
  if (inf) return true;
  fp raw, y0, y1;
  const fp half = FP_HALF, four = FP_FOUR, r2 = FP_R2, one = FP_RAW_ONE;
  fp_from_limbs12(&raw, c0);
  k.mul1(&x->c0, &raw, &r2);             // to the Montgomery domain
  fp_from_limbs12(&raw, c1);
  k.mul1(&x->c1, &raw, &r2);
  fp2 yy;
  k.sqr(&yy, x);
  k.mul(&yy, &yy, x);
  fp_add(&yy.c0, &yy.c0, &four);         // + 4 (1 + u)
  fp_add(&yy.c1, &yy.c1, &four);
  const bool on_curve = fp2_sqrt(y, &yy, k);
  k.mul1(&y0, &y->c0, &one);             // from the Montgomery domain
  k.mul1(&y1, &y->c1, &one);
  const bool big = fp_is_zero(&y1) ? fp_gt(&y0, &half) : fp_gt(&y1, &half);
  if (big != (sign != 0)) fp2_neg(y, y);
  return on_curve;
}

// ---------------------------------------------- complete additions (RCB)
// Renes-Costello-Batina 2016, a = 0, the multiply by 3b as additions:
// complete addition (Alg. 7, 12 multiplies) and mixed addition of an
// affine point (Alg. 8, 11); bls381_msm.cu splits Alg. 7 and the doubling
// (Alg. 9) over lanes. Alg. 7 is the JAX tower's padd_rcb: one formula for
// every pair of points, the identity (0 : 1 : 0) included.

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
HDI void rcb_add(proj<F>* r, const proj<F>* p, const proj<F>* q) {
  F t0, t1, t2, t3, t4, X3, Y3, Z3, u;
  f_mul(&t0, &p->X, &q->X);
  f_mul(&t1, &p->Y, &q->Y);
  f_mul(&t2, &p->Z, &q->Z);
  f_add(&t3, &p->X, &p->Y);
  f_add(&t4, &q->X, &q->Y);
  f_mul(&t3, &t3, &t4);
  f_add(&t4, &t0, &t1);
  f_sub(&t3, &t3, &t4);
  f_add(&t4, &p->Y, &p->Z);
  f_add(&X3, &q->Y, &q->Z);
  f_mul(&t4, &t4, &X3);
  f_add(&X3, &t1, &t2);
  f_sub(&t4, &t4, &X3);
  f_add(&X3, &p->X, &p->Z);
  f_add(&Y3, &q->X, &q->Z);
  f_mul(&X3, &X3, &Y3);
  f_add(&Y3, &t0, &t2);
  f_sub(&Y3, &X3, &Y3);
  f_add(&X3, &t0, &t0);
  f_add(&t0, &X3, &t0);
  f_mul_b3(&t2, &t2);
  f_add(&Z3, &t1, &t2);
  f_sub(&t1, &t1, &t2);
  f_mul_b3(&Y3, &Y3);
  f_mul(&X3, &t4, &Y3);
  f_mul(&u, &t3, &t1);
  f_sub(&X3, &u, &X3);
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

// p + (x, y, 1) for a finite affine point
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

// Normalized standard-domain coordinates: (x, y, 1), or (0, 1, 0) for the
// identity, as 12-bit limbs.
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

// the same for fp2 coordinates, [2][32] limbs each (c0, then c1)
HDI void store_g2(int32_t* X, int32_t* Y, int32_t* Z, const proj<fp2>* p) {
  fp2 x, y, z;
  fp2_zero(&x);
  fp2_zero(&z);
  y = x;
  y.c0 = FP_RAW_ONE;
  if (!fp2_is_zero(&p->Z)) {
    fp2 zi;
    fp2_inv(&zi, &p->Z);
    fp2_mul(&x, &p->X, &zi);
    fp2_mul(&y, &p->Y, &zi);
    fp_from_mont(&x.c0, &x.c0);
    fp_from_mont(&x.c1, &x.c1);
    fp_from_mont(&y.c0, &y.c0);
    fp_from_mont(&y.c1, &y.c1);
    z.c0 = FP_RAW_ONE;
  }
  fp_to_limbs12(X, &x.c0);
  fp_to_limbs12(X + BLS_LIMBS12, &x.c1);
  fp_to_limbs12(Y, &y.c0);
  fp_to_limbs12(Y + BLS_LIMBS12, &y.c1);
  fp_to_limbs12(Z, &z.c0);
  fp_to_limbs12(Z + BLS_LIMBS12, &z.c1);
}

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

static inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }
