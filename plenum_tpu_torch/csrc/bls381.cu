// BLS12-381 on the card: batched pairing-product checks, G1 and G2 share
// aggregation, and a G1 multi-scalar multiply.
//
// Replaces the JAX package's XLA device programs (not Pallas kernels):
//   bls_pairing       <- _pairing_kernel       plenum_tpu/ops/bls381_pairing.py:241
//   bls_g1_aggregate  <- _aggregate_kernel     plenum_tpu/ops/bls381_jax.py:363
//   bls_g2_aggregate  <- _g2_aggregate_kernel  plenum_tpu/ops/bls381_pairing.py:342
//   bls_g1_msm        <- _msm_kernel           plenum_tpu/ops/bls381_pairing.py:285
// with the JAX tower's fp2 square root and G2 decompression
// (plenum_tpu/ops/bls381_tower.py:290, :497) and its complete additions
// (:563) as device code here.
//
// The field and tower formulas are those of the port's host library,
// csrc/bls12_381.c (6 x 64-bit Montgomery limbs, CIOS; the fp2/fp6/fp12
// tower; the optimal-ate Miller loop with M-twist lines multiplied in
// sparse (mul_by_014); the final exponentiation f^(3(q^4-q^2+1)/r) through
// the Hayashida-Hayasaka-Teruya chain with cyclotomic squarings), so the
// card's verdicts are the host's bit for bit. Three does not divide r, so
// an is-one verdict equals the JAX package's exponent (q^12-1)/r. Two
// departures, both exact: inversion is Fermat's (a^(q-2), no data-dependent
// loop) where the host uses the binary extended Euclid, and the G2 square
// root always computes both candidates and selects, as the JAX tower does.
//
// Packed inputs keep the JAX package's layout (its pack_compressed and
// pack_g2_compressed): an x coordinate as 32 limbs of 12 bits in int32, in
// the standard domain, x < q checked on the host, and three flags a point
// (the sign bit, infinity, a valid encoding). Outputs are its shapes too,
// with every point normalized to Z in {0, 1} (one inversion a job), so the
// kernel and its plain version give equal tensors.
//
// Bound: operations, counted for the function and not for this schedule
// (ops/bls381.py COST and the *_cost functions): each distinct point
// decompressed once, a G2 point's Miller lines once, one Miller accumulator
// a job, mixed additions, the bucket method for the MSM; a Montgomery
// multiply priced at 588 32-bit multiply-adds and a squaring at 456. The
// host build counts this schedule's multiplies and squarings
// (bls381_host), which tests/test_torch_bls381.py holds against the same
// pieces.

// Design, first and simple: the arithmetic is the host library's on 64-bit
// limbs (__umul64hi for the high half; the card multiplies 32-bit words, so
// each 64-bit product is several IMADs), one thread per independent piece
// of work, the big tower functions out of line so that the compile stays
// short; their operands live in local memory (the L1). Pairing: one thread
// per (job, pair) decompresses both points and runs the Miller loop into a
// scratch fp12, then one thread per job multiplies its pairs' values and
// runs the final exponentiation (two launches, one C entry). Aggregates: a
// block per job, a thread per share (striding past the block), a tree sum
// in shared memory. MSM: a thread per point (w = 4 table, Horner over 64
// nibbles), a tree sum per block, then one block sums the blocks'.
// Nothing allocates in a kernel; the wrapper gives the scratch.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BLS_NOINLINE __noinline__
#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#else
// host build (csrc/bls381_host.cpp, behind cuda_host_shim.h)
#define BLS_NOINLINE __attribute__((noinline))
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
#define HDN __host__ __device__ BLS_NOINLINE

typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

#define NL 6
#define BLS_LIMBS12 32        // 12-bit limbs of a packed coordinate

#define PAIR_THREADS 64
#define FINAL_THREADS 64
#define AGG_THREADS 128       // a power of two: the tree sum halves it
#define MSM_THREADS 64

HDI u64 mulhi64(u64 a, u64 b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// ------------------------------------------------------------ constants

#define Q0 0xb9feffffffffaaabULL
#define Q1 0x1eabfffeb153ffffULL
#define Q2 0x6730d2a0f6b0f624ULL
#define Q3 0x64774b84f38512bfULL
#define Q4 0x4b1ba7b6434bacd7ULL
#define Q5 0x1a0111ea397fe69aULL
#define N0 0x89f3fffcfffcfffdULL
#define X_ABS 0xd201000000010000ULL

struct fp { u64 l[NL]; };
struct fp2 { fp c0, c1; };
struct fp6 { fp2 c0, c1, c2; };
struct fp12 { fp6 c0, c1; };

HDI fp fp_make(u64 a0, u64 a1, u64 a2, u64 a3, u64 a4, u64 a5) {
  fp r;
  r.l[0] = a0; r.l[1] = a1; r.l[2] = a2;
  r.l[3] = a3; r.l[4] = a4; r.l[5] = a5;
  return r;
}

#define FP_ZERO fp_make(0, 0, 0, 0, 0, 0)
#define FP_RAW_ONE fp_make(1, 0, 0, 0, 0, 0)
// 1, 4 and 12 in the Montgomery domain (R = 2^384), R^2 mod q
#define FP_ONE fp_make(0x760900000002fffdULL, 0xebf4000bc40c0002ULL, \
  0x5f48985753c758baULL, 0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, \
  0x15f65ec3fa80e493ULL)
#define FP_FOUR fp_make(0xaa270000000cfff3ULL, 0x53cc0032fc34000aULL, \
  0x478fe97a6b0a807fULL, 0xb1d37ebee6ba24d7ULL, 0x8ec9733bbf78ab2fULL, \
  0x09d645513d83de7eULL)
#define FP_TWELVE fp_make(0x447600000027552eULL, 0xdcb8009a43480020ULL, \
  0x6f7ee9ce4a6e8b59ULL, 0xb10330b7c0a95bc6ULL, 0x6140b1fcfb1e54b7ULL, \
  0x0381be097f0bb4e1ULL)
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

// -------------------------------------------------------------------- fp
// Every value is canonical (< q): the sums and the CIOS product end with
// one conditional subtraction (q < 2^382 = R / 4).

HDI bool fp_is_zero(const fp* a) {
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= a->l[i];
  return acc == 0;
}

HDI bool fp_eq(const fp* a, const fp* b) {
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= a->l[i] ^ b->l[i];
  return acc == 0;
}

// a > b as integers (both standard-domain values)
HDI bool fp_gt(const fp* a, const fp* b) {
  for (int i = NL - 1; i >= 0; i--) {
    if (a->l[i] != b->l[i]) return a->l[i] > b->l[i];
  }
  return false;
}

HDI bool geq_q(const u64* t) {
  const u64 q[NL] = {Q0, Q1, Q2, Q3, Q4, Q5};
  for (int i = NL - 1; i >= 0; i--) {
    if (t[i] != q[i]) return t[i] > q[i];
  }
  return true;
}

HDI void sub_q(u64* t) {
  const u64 q[NL] = {Q0, Q1, Q2, Q3, Q4, Q5};
  u64 br = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    u64 d = t[i] - q[i];
    u64 b1 = t[i] < q[i];
    u64 d2 = d - br;
    u64 b2 = d < br;
    t[i] = d2;
    br = b1 | b2;
  }
}

HDI void fp_add(fp* r, const fp* a, const fp* b) {
  u64 t[NL], c = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    u64 s = a->l[i] + b->l[i];
    u64 c1 = s < a->l[i];
    u64 s2 = s + c;
    u64 c2 = s2 < s;
    t[i] = s2;
    c = c1 | c2;
  }
  if (c || geq_q(t)) sub_q(t);
#pragma unroll
  for (int i = 0; i < NL; i++) r->l[i] = t[i];
}

HDI void fp_sub(fp* r, const fp* a, const fp* b) {
  const u64 q[NL] = {Q0, Q1, Q2, Q3, Q4, Q5};
  u64 t[NL], br = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    u64 d = a->l[i] - b->l[i];
    u64 b1 = a->l[i] < b->l[i];
    u64 d2 = d - br;
    u64 b2 = d < br;
    t[i] = d2;
    br = b1 | b2;
  }
  if (br) {
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
      u64 s = t[i] + q[i];
      u64 c1 = s < t[i];
      u64 s2 = s + c;
      u64 c2 = s2 < s;
      t[i] = s2;
      c = c1 | c2;
    }
  }
#pragma unroll
  for (int i = 0; i < NL; i++) r->l[i] = t[i];
}

HDI void fp_neg(fp* r, const fp* a) {
  if (fp_is_zero(a)) {
    *r = *a;
    return;
  }
  fp q = fp_make(Q0, Q1, Q2, Q3, Q4, Q5);
  fp_sub(r, &q, a);
}

// lo + carry-out of a * b + t + c
HDI void mac(u64& lo, u64& c, u64 a, u64 b, u64 t) {
  u64 p = a * b, h = mulhi64(a, b);
  p += t;
  h += p < t;
  p += c;
  h += p < c;
  lo = p;
  c = h;
}

// CIOS Montgomery multiplication, csrc/bls12_381.c fp_mul
HDN void fp_mul(fp* r, const fp* a, const fp* b) {
  COUNT_MUL();
  const u64 q[NL] = {Q0, Q1, Q2, Q3, Q4, Q5};
  u64 t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    u64 c = 0;
    const u64 bi = b->l[i];
#pragma unroll
    for (int j = 0; j < NL; j++) mac(t[j], c, a->l[j], bi, t[j]);
    u64 s = t[NL] + c;
    t[NL + 1] = s < c;
    t[NL] = s;
    const u64 m = t[0] * N0;
    c = 0;
    u64 low;
    mac(low, c, m, q[0], t[0]);
#pragma unroll
    for (int j = 1; j < NL; j++) mac(t[j - 1], c, m, q[j], t[j]);
    s = t[NL] + c;
    t[NL - 1] = s;
    t[NL] = t[NL + 1] + (s < c);
    t[NL + 1] = 0;
  }
  if (t[NL] || geq_q(t)) sub_q(t);
#pragma unroll
  for (int i = 0; i < NL; i++) r->l[i] = t[i];
}

HDI void fp_sqr(fp* r, const fp* a) {
  COUNT_SQR();
  fp_mul(r, a, a);
}

// a^e for a public exponent e (standard-domain limbs), square-and-multiply
// from the top bit
HDN void fp_pow(fp* r, const fp* a, const fp* e) {
  fp acc = *a;
  bool started = false;
  for (int i = NL - 1; i >= 0; i--) {
    for (int b = 63; b >= 0; b--) {
      if (started) fp_sqr(&acc, &acc);
      if ((e->l[i] >> b) & 1) {
        if (started) fp_mul(&acc, &acc, a);
        started = true;
      }
    }
  }
  *r = acc;
}

HDI void fp_inv(fp* r, const fp* a) {
  fp e = EXP_INV;
  fp_pow(r, a, &e);
}

HDI void fp_to_mont(fp* r, const fp* raw) {
  fp r2 = FP_R2;
  fp_mul(r, raw, &r2);
}

HDI void fp_from_mont(fp* r, const fp* a) {
  fp one = FP_RAW_ONE;
  fp_mul(r, a, &one);
}

// 32 limbs of 12 bits (int32, standard domain) <-> 6 x 64 bits
HDI void fp_from_limbs12(fp* r, const int32_t* x) {
#pragma unroll
  for (int i = 0; i < NL; i++) r->l[i] = 0;
  for (int k = 0; k < BLS_LIMBS12; k++) {
    const u64 v = (u64)(u32)x[k] & 0xfff;
    const int bit = 12 * k, w = bit >> 6, s = bit & 63;
    r->l[w] |= v << s;
    if (s > 52 && w + 1 < NL) r->l[w + 1] |= v >> (64 - s);
  }
}

HDI void fp_to_limbs12(int32_t* out, const fp* a) {
  for (int k = 0; k < BLS_LIMBS12; k++) {
    const int bit = 12 * k, w = bit >> 6, s = bit & 63;
    u64 v = a->l[w] >> s;
    if (s > 52 && w + 1 < NL) v |= a->l[w + 1] << (64 - s);
    out[k] = (int32_t)(v & 0xfff);
  }
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

HDN void fp2_mul(fp2* r, const fp2* a, const fp2* b) {
  fp t0, t1, t2, t3;
  fp_mul(&t0, &a->c0, &b->c0);
  fp_mul(&t1, &a->c1, &b->c1);
  fp_add(&t2, &a->c0, &a->c1);
  fp_add(&t3, &b->c0, &b->c1);
  fp_mul(&t2, &t2, &t3);
  fp_sub(&t2, &t2, &t0);
  fp_sub(&t2, &t2, &t1);
  fp_sub(&r->c0, &t0, &t1);
  r->c1 = t2;
}

HDN void fp2_sqr(fp2* r, const fp2* a) {
  fp s, d, t;
  fp_add(&s, &a->c0, &a->c1);
  fp_sub(&d, &a->c0, &a->c1);
  fp_mul(&t, &a->c0, &a->c1);
  fp_mul(&r->c0, &s, &d);
  fp_add(&r->c1, &t, &t);
}

HDI void fp2_mul_fp(fp2* r, const fp2* a, const fp* b) {
  fp_mul(&r->c0, &a->c0, b);
  fp_mul(&r->c1, &a->c1, b);
}

HDI void fp2_conj(fp2* r, const fp2* a) {
  r->c0 = a->c0;
  fp_neg(&r->c1, &a->c1);
}

HDN void fp2_inv(fp2* r, const fp2* a) {
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
HDI void fp2_mul_nonres(fp2* r, const fp2* a) {
  fp t0;
  fp_sub(&t0, &a->c0, &a->c1);
  fp_add(&r->c1, &a->c0, &a->c1);
  r->c0 = t0;
}

HDI bool fp2_is_zero(const fp2* a) {
  return fp_is_zero(&a->c0) && fp_is_zero(&a->c1);
}

HDI bool fp2_eq(const fp2* a, const fp2* b) {
  return fp_eq(&a->c0, &b->c0) && fp_eq(&a->c1, &b->c1);
}

HDN void fp2_pow(fp2* r, const fp2* a, const fp* e) {
  fp2 acc = *a;
  bool started = false;
  for (int i = NL - 1; i >= 0; i--) {
    for (int b = 63; b >= 0; b--) {
      if (started) fp2_sqr(&acc, &acc);
      if ((e->l[i] >> b) & 1) {
        if (started) fp2_mul(&acc, &acc, a);
        started = true;
      }
    }
  }
  *r = acc;
}

// The square root of crypto/bls12_381.py Fq2.sqrt (q = 3 mod 4), both
// candidates computed and selected as the JAX tower's fp2_sqrt does; ok is
// root^2 == a.
HDN bool fp2_sqrt(fp2* root, const fp2* a) {
  fp e34 = EXP_SQRT34, ehalf = EXP_HALF;
  fp2 a1, alpha, x0, t, cand, ux0;
  fp2_pow(&a1, a, &e34);                 // a^((q-3)/4)
  fp2_sqr(&alpha, &a1);
  fp2_mul(&alpha, &alpha, a);            // a1^2 a
  fp2_mul(&x0, &a1, a);                  // a1 a
  fp neg1 = FP_NEG_ONE, one = FP_ONE;
  const bool is_neg1 = fp_eq(&alpha.c0, &neg1) && fp_is_zero(&alpha.c1);
  fp_neg(&ux0.c0, &x0.c1);               // u x0
  ux0.c1 = x0.c0;
  t = alpha;
  fp_add(&t.c0, &t.c0, &one);            // alpha + 1
  fp2_pow(&cand, &t, &ehalf);
  fp2_mul(&cand, &cand, &x0);
  *root = is_neg1 ? ux0 : cand;
  fp2_sqr(&t, root);
  return fp2_eq(&t, a);
}

// ------------------------------------------------------------------- fp6
// fp6 = fp2[v] / (v^3 - xi)

HDI void fp6_add(fp6* r, const fp6* a, const fp6* b) {
  fp2_add(&r->c0, &a->c0, &b->c0);
  fp2_add(&r->c1, &a->c1, &b->c1);
  fp2_add(&r->c2, &a->c2, &b->c2);
}

HDI void fp6_sub(fp6* r, const fp6* a, const fp6* b) {
  fp2_sub(&r->c0, &a->c0, &b->c0);
  fp2_sub(&r->c1, &a->c1, &b->c1);
  fp2_sub(&r->c2, &a->c2, &b->c2);
}

HDI void fp6_neg(fp6* r, const fp6* a) {
  fp2_neg(&r->c0, &a->c0);
  fp2_neg(&r->c1, &a->c1);
  fp2_neg(&r->c2, &a->c2);
}

HDN void fp6_mul(fp6* r, const fp6* a, const fp6* b) {
  fp2 t0, t1, t2, s, u0, u1, u2, v0, v1;
  fp2_mul(&t0, &a->c0, &b->c0);
  fp2_mul(&t1, &a->c1, &b->c1);
  fp2_mul(&t2, &a->c2, &b->c2);
  fp2_add(&u0, &a->c1, &a->c2);
  fp2_add(&u1, &b->c1, &b->c2);
  fp2_mul(&s, &u0, &u1);
  fp2_sub(&s, &s, &t1);
  fp2_sub(&s, &s, &t2);
  fp2_mul_nonres(&s, &s);
  fp2_add(&u0, &s, &t0);
  fp2_add(&v0, &a->c0, &a->c1);
  fp2_add(&v1, &b->c0, &b->c1);
  fp2_mul(&s, &v0, &v1);
  fp2_sub(&s, &s, &t0);
  fp2_sub(&s, &s, &t1);
  fp2_mul_nonres(&v0, &t2);
  fp2_add(&u1, &s, &v0);
  fp2_add(&v0, &a->c0, &a->c2);
  fp2_add(&v1, &b->c0, &b->c2);
  fp2_mul(&s, &v0, &v1);
  fp2_sub(&s, &s, &t0);
  fp2_sub(&s, &s, &t2);
  fp2_add(&u2, &s, &t1);
  r->c0 = u0;
  r->c1 = u1;
  r->c2 = u2;
}

HDI void fp6_mul_nonres(fp6* r, const fp6* a) {
  fp2 t;
  fp2_mul_nonres(&t, &a->c2);
  r->c2 = a->c1;
  r->c1 = a->c0;
  r->c0 = t;
}

HDN void fp6_inv(fp6* r, const fp6* a) {
  fp2 A, B, C, t0, t1, F;
  fp2_sqr(&t0, &a->c0);
  fp2_mul(&t1, &a->c1, &a->c2);
  fp2_mul_nonres(&t1, &t1);
  fp2_sub(&A, &t0, &t1);
  fp2_sqr(&t0, &a->c2);
  fp2_mul_nonres(&t0, &t0);
  fp2_mul(&t1, &a->c0, &a->c1);
  fp2_sub(&B, &t0, &t1);
  fp2_sqr(&t0, &a->c1);
  fp2_mul(&t1, &a->c0, &a->c2);
  fp2_sub(&C, &t0, &t1);
  fp2_mul(&t0, &a->c2, &B);
  fp2_mul(&t1, &a->c1, &C);
  fp2_add(&t0, &t0, &t1);
  fp2_mul_nonres(&t0, &t0);
  fp2_mul(&t1, &a->c0, &A);
  fp2_add(&F, &t0, &t1);
  fp2_inv(&F, &F);
  fp2_mul(&r->c0, &A, &F);
  fp2_mul(&r->c1, &B, &F);
  fp2_mul(&r->c2, &C, &F);
}

HDI bool fp6_is_zero(const fp6* a) {
  return fp2_is_zero(&a->c0) && fp2_is_zero(&a->c1) && fp2_is_zero(&a->c2);
}

// ------------------------------------------------------------------ fp12
// fp12 = fp6[w] / (w^2 - v)

HDN void fp12_mul(fp12* r, const fp12* a, const fp12* b) {
  fp6 t0, t1, t2, t3;
  fp6_mul(&t0, &a->c0, &b->c0);
  fp6_mul(&t1, &a->c1, &b->c1);
  fp6_add(&t2, &a->c0, &a->c1);
  fp6_add(&t3, &b->c0, &b->c1);
  fp6_mul(&t2, &t2, &t3);
  fp6_sub(&t2, &t2, &t0);
  fp6_sub(&t2, &t2, &t1);
  fp6_mul_nonres(&t1, &t1);
  fp6_add(&r->c0, &t0, &t1);
  r->c1 = t2;
}

HDN void fp12_sqr(fp12* r, const fp12* a) {
  fp6 t, s0, s1, vt;
  fp6_mul(&t, &a->c0, &a->c1);
  fp6_add(&s0, &a->c0, &a->c1);
  fp6_mul_nonres(&s1, &a->c1);
  fp6_add(&s1, &s1, &a->c0);
  fp6_mul(&s0, &s0, &s1);
  fp6_sub(&s0, &s0, &t);
  fp6_mul_nonres(&vt, &t);
  fp6_sub(&r->c0, &s0, &vt);
  fp6_add(&r->c1, &t, &t);
}

HDI void fp12_conj(fp12* r, const fp12* a) {
  r->c0 = a->c0;
  fp6_neg(&r->c1, &a->c1);
}

HDN void fp12_inv(fp12* r, const fp12* a) {
  fp6 t0, t1;
  fp6_mul(&t0, &a->c0, &a->c0);
  fp6_mul(&t1, &a->c1, &a->c1);
  fp6_mul_nonres(&t1, &t1);
  fp6_sub(&t0, &t0, &t1);
  fp6_inv(&t0, &t0);
  fp6_mul(&r->c0, &a->c0, &t0);
  fp6_mul(&t1, &a->c1, &t0);
  fp6_neg(&r->c1, &t1);
}

HDI void fp12_one(fp12* r) {
  memset(r, 0, sizeof *r);
  r->c0.c0.c0 = FP_ONE;
}

HDI bool fp12_is_one(const fp12* a) {
  fp one = FP_ONE;
  if (!fp_eq(&a->c0.c0.c0, &one)) return false;
  if (!fp_is_zero(&a->c0.c0.c1)) return false;
  if (!fp2_is_zero(&a->c0.c1) || !fp2_is_zero(&a->c0.c2)) return false;
  return fp6_is_zero(&a->c1);
}

// gamma_k = xi^(k (q - 1) / 6), k = 1..5, Montgomery domain
HDI fp2 frob_gamma(int k) {
  fp2 g;
  switch (k) {
    case 1:
      g.c0 = fp_make(0x07089552b319d465ULL, 0xc6695f92b50a8313ULL,
                     0x97e83cccd117228fULL, 0xa35baecab2dc29eeULL,
                     0x1ce393ea5daace4dULL, 0x08f2220fb0fb66ebULL);
      g.c1 = fp_make(0xb2f66aad4ce5d646ULL, 0x5842a06bfc497cecULL,
                     0xcf4895d42599d394ULL, 0xc11b9cba40a8e8d0ULL,
                     0x2e3813cbe5a0de89ULL, 0x110eefda88847fafULL);
      break;
    case 2:
      g.c0 = FP_ZERO;
      g.c1 = fp_make(0xcd03c9e48671f071ULL, 0x5dab22461fcda5d2ULL,
                     0x587042afd3851b95ULL, 0x8eb60ebe01bacb9eULL,
                     0x03f97d6e83d050d2ULL, 0x18f0206554638741ULL);
      break;
    case 3:
      g.c0 = fp_make(0x7bcfa7a25aa30fdaULL, 0xdc17dec12a927e7cULL,
                     0x2f088dd86b4ebef1ULL, 0xd1ca2087da74d4a7ULL,
                     0x2da2596696cebc1dULL, 0x0e2b7eedbbfd87d2ULL);
      g.c1 = g.c0;
      break;
    case 4:
      g.c0 = fp_make(0x890dc9e4867545c3ULL, 0x2af322533285a5d5ULL,
                     0x50880866309b7e2cULL, 0xa20d1b8c7e881024ULL,
                     0x14e4f04fe2db9068ULL, 0x14e56d3f1564853aULL);
      g.c1 = FP_ZERO;
      break;
    default:
      g.c0 = fp_make(0x82d83cf50dbce43fULL, 0xa2813e53df9d018fULL,
                     0xc6f0caa53c65e181ULL, 0x7525cf528d50fe95ULL,
                     0x4a85ed50f4798a6bULL, 0x171da0fd6cf8eebdULL);
      g.c1 = fp_make(0x3726c30af242c66cULL, 0x7c2ac1aad1b6fe70ULL,
                     0xa04007fbba4b14a2ULL, 0xef517c3266341429ULL,
                     0x0095ba654ed2226bULL, 0x02e370eccc86f7ddULL);
      break;
  }
  return g;
}

// f^q: conjugate every coefficient, the one of w^k times gamma_k
// (c0 = w^0, w^2, w^4; c1 = w^1, w^3, w^5)
HDN void fp12_frob(fp12* r, const fp12* a) {
  fp2 t, g;
  fp2_conj(&t, &a->c0.c0);
  r->c0.c0 = t;
  fp2_conj(&t, &a->c0.c1); g = frob_gamma(2); fp2_mul(&r->c0.c1, &t, &g);
  fp2_conj(&t, &a->c0.c2); g = frob_gamma(4); fp2_mul(&r->c0.c2, &t, &g);
  fp2_conj(&t, &a->c1.c0); g = frob_gamma(1); fp2_mul(&r->c1.c0, &t, &g);
  fp2_conj(&t, &a->c1.c1); g = frob_gamma(3); fp2_mul(&r->c1.c1, &t, &g);
  fp2_conj(&t, &a->c1.c2); g = frob_gamma(5); fp2_mul(&r->c1.c2, &t, &g);
}

// ---------------------------------------------------------- Miller loop
// csrc/bls12_381.c lines 848-1026: T projective on the twist, lines of
// eprint 2010/354 Alg 26/27 multiplied in sparse.

struct g2p { fp2 X, Y, Z; };

HDN void fp6_mul_by_01(fp6* r, const fp6* s, const fp2* c0, const fp2* c1) {
  fp2 a_a, b_b, t1, t2, t3, u;
  fp2_mul(&a_a, &s->c0, c0);
  fp2_mul(&b_b, &s->c1, c1);
  fp2_add(&u, &s->c1, &s->c2);
  fp2_mul(&t1, &u, c1);
  fp2_sub(&t1, &t1, &b_b);
  fp2_mul_nonres(&t1, &t1);
  fp2_add(&t1, &t1, &a_a);
  fp2_add(&u, c0, c1);
  fp2_add(&t2, &s->c0, &s->c1);
  fp2_mul(&t2, &t2, &u);
  fp2_sub(&t2, &t2, &a_a);
  fp2_sub(&t2, &t2, &b_b);
  fp2_mul(&t3, &s->c2, c0);
  fp2_add(&t3, &t3, &b_b);
  r->c0 = t1;
  r->c1 = t2;
  r->c2 = t3;
}

HDN void fp6_mul_by_1(fp6* r, const fp6* s, const fp2* c1) {
  fp2 t0, t1, t2;
  fp2_mul(&t0, &s->c2, c1);
  fp2_mul_nonres(&t0, &t0);
  fp2_mul(&t1, &s->c0, c1);
  fp2_mul(&t2, &s->c1, c1);
  r->c0 = t0;
  r->c1 = t1;
  r->c2 = t2;
}

HDN void fp12_mul_by_014(fp12* f, const fp2* c0, const fp2* c1,
                         const fp2* c4) {
  fp6 aa, bb, t, o6;
  fp2 o;
  fp6_mul_by_01(&aa, &f->c0, c0, c1);
  fp6_mul_by_1(&bb, &f->c1, c4);
  fp2_add(&o, c1, c4);
  fp6_add(&t, &f->c1, &f->c0);
  fp6_mul_by_01(&t, &t, c0, &o);
  fp6_sub(&t, &t, &aa);
  fp6_sub(&t, &t, &bb);
  fp6_mul_nonres(&o6, &bb);
  fp6_add(&f->c0, &o6, &aa);
  f->c1 = t;
}

HDN void miller_dbl(g2p* r, fp2* l0, fp2* l1, fp2* l4) {
  fp2 tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, zsq, t;
  fp2_sqr(&tmp0, &r->X);
  fp2_sqr(&tmp1, &r->Y);
  fp2_sqr(&tmp2, &tmp1);
  fp2_add(&t, &tmp1, &r->X);
  fp2_sqr(&tmp3, &t);
  fp2_sub(&tmp3, &tmp3, &tmp0);
  fp2_sub(&tmp3, &tmp3, &tmp2);
  fp2_add(&tmp3, &tmp3, &tmp3);
  fp2_add(&tmp4, &tmp0, &tmp0);
  fp2_add(&tmp4, &tmp4, &tmp0);
  fp2_add(&tmp6, &r->X, &tmp4);
  fp2_sqr(&tmp5, &tmp4);
  fp2_sqr(&zsq, &r->Z);
  fp2_sub(&r->X, &tmp5, &tmp3);
  fp2_sub(&r->X, &r->X, &tmp3);
  fp2_add(&t, &r->Z, &r->Y);
  fp2_sqr(&t, &t);
  fp2_sub(&t, &t, &tmp1);
  fp2_sub(&r->Z, &t, &zsq);
  fp2_sub(&t, &tmp3, &r->X);
  fp2_mul(&r->Y, &t, &tmp4);
  fp2_add(&tmp2, &tmp2, &tmp2);
  fp2_add(&tmp2, &tmp2, &tmp2);
  fp2_add(&tmp2, &tmp2, &tmp2);
  fp2_sub(&r->Y, &r->Y, &tmp2);
  fp2_mul(&tmp3, &tmp4, &zsq);
  fp2_add(&tmp3, &tmp3, &tmp3);
  fp2_neg(&tmp3, &tmp3);
  fp2_sqr(&tmp6, &tmp6);
  fp2_sub(&tmp6, &tmp6, &tmp0);
  fp2_sub(&tmp6, &tmp6, &tmp5);
  fp2_add(&tmp1, &tmp1, &tmp1);
  fp2_add(&tmp1, &tmp1, &tmp1);
  fp2_sub(&tmp6, &tmp6, &tmp1);
  fp2_mul(&tmp0, &r->Z, &zsq);
  fp2_add(&tmp0, &tmp0, &tmp0);
  *l0 = tmp0;
  *l1 = tmp3;
  *l4 = tmp6;
}

HDN void miller_add(g2p* r, const fp2* qx, const fp2* qy, fp2* l0, fp2* l1,
                    fp2* l4) {
  fp2 zsq, ysq, t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, ztsq, t;
  fp2_sqr(&zsq, &r->Z);
  fp2_sqr(&ysq, qy);
  fp2_mul(&t0, &zsq, qx);
  fp2_add(&t, qy, &r->Z);
  fp2_sqr(&t1, &t);
  fp2_sub(&t1, &t1, &ysq);
  fp2_sub(&t1, &t1, &zsq);
  fp2_mul(&t1, &t1, &zsq);
  fp2_sub(&t2, &t0, &r->X);
  fp2_sqr(&t3, &t2);
  fp2_add(&t4, &t3, &t3);
  fp2_add(&t4, &t4, &t4);
  fp2_mul(&t5, &t4, &t2);
  fp2_sub(&t6, &t1, &r->Y);
  fp2_sub(&t6, &t6, &r->Y);
  fp2_mul(&t9, &t6, qx);
  fp2_mul(&t7, &t4, &r->X);
  fp2_sqr(&r->X, &t6);
  fp2_sub(&r->X, &r->X, &t5);
  fp2_sub(&r->X, &r->X, &t7);
  fp2_sub(&r->X, &r->X, &t7);
  fp2_add(&t, &r->Z, &t2);
  fp2_sqr(&t, &t);
  fp2_sub(&t, &t, &zsq);
  fp2_sub(&r->Z, &t, &t3);
  fp2_add(&t10, qy, &r->Z);
  fp2_sub(&t8, &t7, &r->X);
  fp2_mul(&t8, &t8, &t6);
  fp2_mul(&t0, &r->Y, &t5);
  fp2_add(&t0, &t0, &t0);
  fp2_sub(&r->Y, &t8, &t0);
  fp2_sqr(&t10, &t10);
  fp2_sub(&t10, &t10, &ysq);
  fp2_sqr(&ztsq, &r->Z);
  fp2_sub(&t10, &t10, &ztsq);
  fp2_add(&t9, &t9, &t9);
  fp2_sub(&t9, &t9, &t10);
  fp2_add(&t10, &r->Z, &r->Z);
  fp2_neg(&t6, &t6);
  fp2_add(&t1, &t6, &t6);
  *l0 = t10;
  *l1 = t1;
  *l4 = t9;
}

HDI void miller_ell(fp12* f, const fp2* l0, const fp2* l1, const fp2* l4,
                    const fp* px, const fp* py) {
  fp2 c0, c1;
  fp2_mul_fp(&c0, l0, py);
  fp2_mul_fp(&c1, l1, px);
  fp12_mul_by_014(f, l4, &c1, &c0);
}

// the Miller value of a live pair (neither point at infinity), conjugated
// since x < 0
HDN void miller(fp12* f, const fp* px, const fp* py, const fp2* qx,
                const fp2* qy) {
  fp12_one(f);
  g2p r;
  r.X = *qx;
  r.Y = *qy;
  memset(&r.Z, 0, sizeof r.Z);
  r.Z.c0 = FP_ONE;
  fp2 l0, l1, l4;
  for (int b = 62; b >= 0; b--) {     // below the top bit of X_ABS
    fp12_sqr(f, f);
    miller_dbl(&r, &l0, &l1, &l4);
    miller_ell(f, &l0, &l1, &l4, px, py);
    if ((X_ABS >> b) & 1) {
      miller_add(&r, qx, qy, &l0, &l1, &l4);
      miller_ell(f, &l0, &l1, &l4, px, py);
    }
  }
  fp12_conj(f, f);
}

// ----------------------------------------------- final exponentiation

HDI void fp4_sqr_parts(fp2* c0, fp2* c1, const fp2* a, const fp2* b) {
  fp2 t0, t1, t2;
  fp2_sqr(&t0, a);
  fp2_sqr(&t1, b);
  fp2_mul_nonres(&t2, &t1);
  fp2_add(c0, &t2, &t0);
  fp2_add(&t2, a, b);
  fp2_sqr(&t2, &t2);
  fp2_sub(&t2, &t2, &t0);
  fp2_sub(c1, &t2, &t1);
}

HDN void fp12_cyc_sqr(fp12* r, const fp12* f) {
  fp2 z0 = f->c0.c0, z4 = f->c0.c1, z3 = f->c0.c2;
  fp2 z2 = f->c1.c0, z1 = f->c1.c1, z5 = f->c1.c2;
  fp2 t0, t1, t2, t3;
  fp4_sqr_parts(&t0, &t1, &z0, &z1);
  fp2_sub(&z0, &t0, &z0);
  fp2_add(&z0, &z0, &z0);
  fp2_add(&z0, &z0, &t0);
  fp2_add(&z1, &t1, &z1);
  fp2_add(&z1, &z1, &z1);
  fp2_add(&z1, &z1, &t1);
  fp4_sqr_parts(&t0, &t1, &z2, &z3);
  fp4_sqr_parts(&t2, &t3, &z4, &z5);
  fp2_sub(&z4, &t0, &z4);
  fp2_add(&z4, &z4, &z4);
  fp2_add(&z4, &z4, &t0);
  fp2_add(&z5, &t1, &z5);
  fp2_add(&z5, &z5, &z5);
  fp2_add(&z5, &z5, &t1);
  fp2_mul_nonres(&t0, &t3);
  fp2_add(&z2, &t0, &z2);
  fp2_add(&z2, &z2, &z2);
  fp2_add(&z2, &z2, &t0);
  fp2_sub(&z3, &t2, &z3);
  fp2_add(&z3, &z3, &z3);
  fp2_add(&z3, &z3, &t2);
  r->c0.c0 = z0; r->c0.c1 = z4; r->c0.c2 = z3;
  r->c1.c0 = z2; r->c1.c1 = z1; r->c1.c2 = z5;
}

HDN void fp12_pow_u64_cyc(fp12* r, const fp12* a, u64 e) {
  fp12 acc;
  fp12_one(&acc);
  bool started = false;
  for (int b = 63; b >= 0; b--) {
    if (started) fp12_cyc_sqr(&acc, &acc);
    if ((e >> b) & 1) {
      if (!started) {
        acc = *a;
        started = true;
      } else {
        fp12_mul(&acc, &acc, a);
      }
    }
  }
  *r = acc;
}

HDI void fp12_pow_x_cyc(fp12* r, const fp12* a) {
  fp12 t;
  fp12_pow_u64_cyc(&t, a, X_ABS);
  fp12_conj(r, &t);
}

// csrc/bls12_381.c final_exp: f^(3 (q^4 - q^2 + 1) / r) after the easy part
HDN void final_exp(fp12* r, const fp12* f) {
  fp12 t0, t1, m, a, b, c;
  fp12_conj(&t0, f);
  fp12_inv(&t1, f);
  fp12_mul(&m, &t0, &t1);
  fp12_frob(&t0, &m);
  fp12_frob(&t0, &t0);
  fp12_mul(&m, &t0, &m);
  fp12_pow_u64_cyc(&a, &m, X_ABS + 1);
  fp12_conj(&a, &a);
  fp12_pow_u64_cyc(&t0, &a, X_ABS + 1);
  fp12_conj(&a, &t0);
  fp12_pow_x_cyc(&t0, &a);
  fp12_frob(&t1, &a);
  fp12_mul(&b, &t0, &t1);
  fp12_pow_x_cyc(&t0, &b);
  fp12_pow_x_cyc(&t0, &t0);
  fp12_frob(&t1, &b);
  fp12_frob(&t1, &t1);
  fp12_mul(&c, &t0, &t1);
  fp12_conj(&t0, &b);
  fp12_mul(&c, &c, &t0);
  fp12_cyc_sqr(&t0, &m);
  fp12_mul(&t0, &t0, &m);
  fp12_mul(r, &c, &t0);
}

// ------------------------------------------------------ decompression

// crypto/bls12_381.py g1_decompress on a packed point: → ok (a valid
// encoding, and on the curve unless at infinity); (x, y) Montgomery when
// ok and not at infinity. Every valid finite point pays the same work, on the
// curve or not.
HDN bool g1_decompress(fp* x, fp* y, const int32_t* x12, u8 sign, u8 inf,
                       u8 valid) {
  if (!valid) return false;
  if (inf) return true;
  fp raw, yy, four = FP_FOUR, e = EXP_SQRT, t, half = FP_HALF;
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
HDN bool g2_decompress(fp2* x, fp2* y, const int32_t* c1, const int32_t* c0,
                       u8 sign, u8 inf, u8 valid) {
  if (!valid) return false;
  if (inf) return true;
  fp raw, half = FP_HALF, y0, y1;
  fp_from_limbs12(&raw, c0);
  fp_to_mont(&x->c0, &raw);
  fp_from_limbs12(&raw, c1);
  fp_to_mont(&x->c1, &raw);
  fp2 yy;
  fp2_sqr(&yy, x);
  fp2_mul(&yy, &yy, x);
  fp four = FP_FOUR;
  fp_add(&yy.c0, &yy.c0, &four);         // + 4 (1 + u)
  fp_add(&yy.c1, &yy.c1, &four);
  const bool on_curve = fp2_sqrt(y, &yy);
  fp_from_mont(&y0, &y->c0);
  fp_from_mont(&y1, &y->c1);
  const bool big = fp_is_zero(&y1) ? fp_gt(&y0, &half) : fp_gt(&y1, &half);
  if (big != (sign != 0)) fp2_neg(y, y);
  return on_curve;
}

// ---------------------------------------------- complete additions (RCB)
// Renes-Costello-Batina 2016 Alg. 7 (a = 0), the JAX tower's padd_rcb: one
// formula for every pair of points, the identity (0 : 1 : 0) included.

HDI void f_add(fp* r, const fp* a, const fp* b) { fp_add(r, a, b); }
HDI void f_sub(fp* r, const fp* a, const fp* b) { fp_sub(r, a, b); }
HDI void f_mul(fp* r, const fp* a, const fp* b) { fp_mul(r, a, b); }
HDI void f_mul_b3(fp* r, const fp* a) {            // 3b = 12
  fp b3 = FP_TWELVE;
  fp_mul(r, a, &b3);
}
HDI void f_add(fp2* r, const fp2* a, const fp2* b) { fp2_add(r, a, b); }
HDI void f_sub(fp2* r, const fp2* a, const fp2* b) { fp2_sub(r, a, b); }
HDI void f_mul(fp2* r, const fp2* a, const fp2* b) { fp2_mul(r, a, b); }
HDI void f_mul_b3(fp2* r, const fp2* a) {          // 3b' = 12 (1 + u)
  fp2 b3;
  b3.c0 = FP_TWELVE;
  b3.c1 = FP_TWELVE;
  fp2_mul(r, a, &b3);
}

template <class F>
struct proj { F X, Y, Z; };

template <class F>
HDN void rcb_add(proj<F>* r, const proj<F>* p, const proj<F>* q) {
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

HDI void set_identity(proj<fp>* p) {
  p->X = FP_ZERO;
  p->Y = FP_ONE;
  p->Z = FP_ZERO;
}

HDI void set_identity(proj<fp2>* p) {
  memset(p, 0, sizeof *p);
  p->Y.c0 = FP_ONE;
}

// Normalized standard-domain coordinates: (x, y, 1), or (0, 1, 0) for the
// identity, as 12-bit limbs.
HDN void store_g1(int32_t* X, int32_t* Y, int32_t* Z, const proj<fp>* p) {
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
HDN void store_g2(int32_t* X, int32_t* Y, int32_t* Z, const proj<fp2>* p) {
  fp2 x, y, z;
  memset(&x, 0, sizeof x);
  memset(&z, 0, sizeof z);
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

// ------------------------------------------------------------- kernels

#define SLOT_OK 1        // both points decoded, the pair neutral or live
#define SLOT_LIVE 2      // ... and live: its Miller value is in the scratch

// Pairing, first launch: one thread per (job, pair) slot.
__global__ void __launch_bounds__(PAIR_THREADS)
bls_miller_kernel(const int32_t* g1x, const u8* g1s, const u8* g1i,
                  const u8* g1v, const int32_t* g2c1, const int32_t* g2c0,
                  const u8* g2s, const u8* g2i, const u8* g2v, int slots,
                  fp12* f_out, u8* state) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  fp px, py;
  fp2 qx, qy;
  const bool v1 = g1_decompress(&px, &py, g1x + (size_t)s * BLS_LIMBS12,
                                g1s[s], g1i[s], g1v[s]);
  const bool v2 = g2_decompress(&qx, &qy, g2c1 + (size_t)s * BLS_LIMBS12,
                                g2c0 + (size_t)s * BLS_LIMBS12, g2s[s],
                                g2i[s], g2v[s]);
  // a pair both at infinity is neutral; one at infinity fails the job
  const bool inf1 = g1i[s] != 0, inf2 = g2i[s] != 0;
  const bool ok = v1 && v2 && (inf1 == inf2);
  // both encodings valid and finite: the Miller loop runs (on a point off
  // the curve its value is of no use, and the job fails on `ok`), so the
  // work follows the packed flags alone
  const bool finite = g1v[s] && g2v[s] && !inf1 && !inf2;
  if (finite) {
    fp12 f;
    miller(&f, &px, &py, &qx, &qy);
    f_out[s] = f;
  }
  state[s] = (ok ? SLOT_OK : 0) | (ok && finite ? SLOT_LIVE : 0);
}

// Pairing, second launch: one thread per job, the product of its live
// pairs' values and the final exponentiation.
__global__ void __launch_bounds__(FINAL_THREADS)
bls_final_exp_kernel(const fp12* f_in, const u8* state, int B, int P,
                     u8* verdict, u8* decode_ok) {
  const int job = blockIdx.x * blockDim.x + threadIdx.x;
  if (job >= B) return;
  bool ok = true;
  int live = 0;
  fp12 f;
  for (int p = 0; p < P; p++) {
    const int s = job * P + p;
    ok = ok && (state[s] & SLOT_OK);
    if (state[s] & SLOT_LIVE) {
      if (live++ == 0) {
        f = f_in[s];
      } else {
        fp12_mul(&f, &f, &f_in[s]);
      }
    }
  }
  bool is_one = true;                  // an empty product is 1
  if (ok && live) {
    fp12 g;
    final_exp(&g, &f);
    is_one = fp12_is_one(&g);
  }
  verdict[job] = ok && is_one;
  decode_ok[job] = ok;
}

// G1 aggregate: a block per job, a thread per share.
__global__ void __launch_bounds__(AGG_THREADS)
bls_g1_aggregate_kernel(const int32_t* x12, const u8* sign, const u8* inf,
                        const u8* valid, int n, int32_t* X, int32_t* Y,
                        int32_t* Z, u8* ok_out) {
  __shared__ proj<fp> sh[AGG_THREADS];
  __shared__ u32 bad;
  const int job = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) bad = 0;
  __syncthreads();
  proj<fp> acc;
  set_identity(&acc);
  for (int j = tid; j < n; j += AGG_THREADS) {
    const size_t s = (size_t)job * n + j;
    proj<fp> p;
    if (!g1_decompress(&p.X, &p.Y, x12 + s * BLS_LIMBS12, sign[s], inf[s],
                       valid[s]))
      atomicOr(&bad, 1u);
    if (valid[s] && !inf[s]) {          // a job with a bad share is void
      p.Z = FP_ONE;
      rcb_add(&acc, &acc, &p);
    }
  }
  sh[tid] = acc;
  __syncthreads();
  for (int half = AGG_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) rcb_add(&sh[tid], &sh[tid], &sh[tid + half]);
    __syncthreads();
  }
  if (tid == 0) {
    if (bad) set_identity(&sh[0]);
    store_g1(X + (size_t)job * BLS_LIMBS12, Y + (size_t)job * BLS_LIMBS12,
             Z + (size_t)job * BLS_LIMBS12, &sh[0]);
    ok_out[job] = bad == 0;
  }
}

// G2 aggregate: the same over fp2.
__global__ void __launch_bounds__(AGG_THREADS)
bls_g2_aggregate_kernel(const int32_t* c1, const int32_t* c0, const u8* sign,
                        const u8* inf, const u8* valid, int n, int32_t* X,
                        int32_t* Y, int32_t* Z, u8* ok_out) {
  __shared__ proj<fp2> sh[AGG_THREADS];
  __shared__ u32 bad;
  const int job = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) bad = 0;
  __syncthreads();
  proj<fp2> acc;
  set_identity(&acc);
  for (int j = tid; j < n; j += AGG_THREADS) {
    const size_t s = (size_t)job * n + j;
    proj<fp2> p;
    if (!g2_decompress(&p.X, &p.Y, c1 + s * BLS_LIMBS12,
                       c0 + s * BLS_LIMBS12, sign[s], inf[s], valid[s]))
      atomicOr(&bad, 1u);
    if (valid[s] && !inf[s]) {
      memset(&p.Z, 0, sizeof p.Z);
      p.Z.c0 = FP_ONE;
      rcb_add(&acc, &acc, &p);
    }
  }
  sh[tid] = acc;
  __syncthreads();
  for (int half = AGG_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) rcb_add(&sh[tid], &sh[tid], &sh[tid + half]);
    __syncthreads();
  }
  if (tid == 0) {
    const size_t o = (size_t)job * 2 * BLS_LIMBS12;
    if (bad) set_identity(&sh[0]);
    store_g2(X + o, Y + o, Z + o, &sh[0]);
    ok_out[job] = bad == 0;
  }
}

// MSM, first launch: a thread per point, a w = 4 table and Horner over the
// 64 nibbles (most significant first), then a tree sum per block into
// partial[blockIdx.x]; an undecodable point sets *bad.
__global__ void __launch_bounds__(MSM_THREADS)
bls_msm_points_kernel(const int32_t* x12, const u8* sign, const u8* inf,
                      const u8* valid, const int32_t* digits, int N,
                      proj<fp>* partial, u32* bad) {
  __shared__ proj<fp> sh[MSM_THREADS];
  const int tid = threadIdx.x, i = blockIdx.x * MSM_THREADS + tid;
  proj<fp> acc;
  set_identity(&acc);
  if (i < N) {
    proj<fp> p;
    if (!g1_decompress(&p.X, &p.Y, x12 + (size_t)i * BLS_LIMBS12, sign[i],
                       inf[i], valid[i]))
      atomicOr(bad, 1u);
    if (valid[i] && !inf[i]) {
      p.Z = FP_ONE;
      proj<fp> tab[16];
      set_identity(&tab[0]);
      tab[1] = p;
      for (int k = 2; k < 16; k++) rcb_add(&tab[k], &tab[k - 1], &p);
      for (int w = 0; w < 64; w++) {
        for (int d = 0; d < 4; d++) rcb_add(&acc, &acc, &acc);
        rcb_add(&acc, &acc, &tab[digits[(size_t)i * 64 + w] & 15]);
      }
    }
  }
  sh[tid] = acc;
  __syncthreads();
  for (int half = MSM_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) rcb_add(&sh[tid], &sh[tid], &sh[tid + half]);
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x] = sh[0];
}

// MSM, second launch: one block sums the blocks' partial sums.
__global__ void __launch_bounds__(MSM_THREADS)
bls_msm_sum_kernel(const proj<fp>* partial, int nparts, const u32* bad,
                   int32_t* X, int32_t* Y, int32_t* Z, u8* ok_out) {
  __shared__ proj<fp> sh[MSM_THREADS];
  const int tid = threadIdx.x;
  proj<fp> acc;
  set_identity(&acc);
  for (int j = tid; j < nparts; j += MSM_THREADS)
    rcb_add(&acc, &acc, &partial[j]);
  sh[tid] = acc;
  __syncthreads();
  for (int half = MSM_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) rcb_add(&sh[tid], &sh[tid], &sh[tid + half]);
    __syncthreads();
  }
  if (tid == 0) {
    if (*bad) set_identity(&sh[0]);
    store_g1(X, Y, Z, &sh[0]);
    ok_out[0] = *bad == 0;
  }
}

// ------------------------------------------------------------ C entries
// Each launches on `stream`, reads nothing back and returns the CUDA error
// of its launches (0 when they were accepted).

extern "C" {

// scratch_f: B * P fp12 (576 bytes each); scratch_state: B * P bytes
int bls_pairing(const int32_t* g1x, const u8* g1s, const u8* g1i,
                const u8* g1v, const int32_t* g2c1, const int32_t* g2c0,
                const u8* g2s, const u8* g2i, const u8* g2v, int B, int P,
                void* scratch_f, u8* scratch_state, u8* verdict,
                u8* decode_ok, cudaStream_t stream) {
  if (B <= 0 || P <= 0) return 0;
  const int slots = B * P;
  fp12* f = (fp12*)scratch_f;
  LAUNCH(bls_miller_kernel, (slots + PAIR_THREADS - 1) / PAIR_THREADS,
         PAIR_THREADS, stream, g1x, g1s, g1i, g1v, g2c1, g2c0, g2s, g2i,
         g2v, slots, f, scratch_state);
  int err = cudaGetLastError();
  if (err) return err;
  LAUNCH(bls_final_exp_kernel, (B + FINAL_THREADS - 1) / FINAL_THREADS,
         FINAL_THREADS, stream, (const fp12*)f, (const u8*)scratch_state, B,
         P, verdict, decode_ok);
  return cudaGetLastError();
}

int bls_g1_aggregate(const int32_t* x12, const u8* sign, const u8* inf,
                     const u8* valid, int B, int n, int32_t* X, int32_t* Y,
                     int32_t* Z, u8* ok, cudaStream_t stream) {
  if (B <= 0) return 0;
  LAUNCH(bls_g1_aggregate_kernel, B, AGG_THREADS, stream, x12, sign, inf,
         valid, n, X, Y, Z, ok);
  return cudaGetLastError();
}

int bls_g2_aggregate(const int32_t* c1, const int32_t* c0, const u8* sign,
                     const u8* inf, const u8* valid, int B, int n, int32_t* X,
                     int32_t* Y, int32_t* Z, u8* ok, cudaStream_t stream) {
  if (B <= 0) return 0;
  LAUNCH(bls_g2_aggregate_kernel, B, AGG_THREADS, stream, c1, c0, sign, inf,
         valid, n, X, Y, Z, ok);
  return cudaGetLastError();
}

// the blocks of the first launch, for the scratch's size
int bls_msm_blocks(int N) { return (N + MSM_THREADS - 1) / MSM_THREADS; }

// scratch: bls_msm_blocks(N) * 144 bytes of partial sums, then a uint32
// flag that the caller has zeroed
int bls_g1_msm(const int32_t* x12, const u8* sign, const u8* inf,
               const u8* valid, const int32_t* digits, int N, void* scratch,
               int32_t* X, int32_t* Y, int32_t* Z, u8* ok,
               cudaStream_t stream) {
  if (N <= 0) return 0;
  const int blocks = bls_msm_blocks(N);
  proj<fp>* partial = (proj<fp>*)scratch;
  u32* bad = (u32*)(partial + blocks);
  LAUNCH(bls_msm_points_kernel, blocks, MSM_THREADS, stream, x12, sign, inf,
         valid, digits, N, partial, bad);
  int err = cudaGetLastError();
  if (err) return err;
  LAUNCH(bls_msm_sum_kernel, 1, MSM_THREADS, stream,
         (const proj<fp>*)partial, blocks, (const u32*)bad, X, Y, Z, ok);
  return cudaGetLastError();
}

}  // extern "C"
