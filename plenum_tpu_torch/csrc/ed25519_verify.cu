// Batched cofactorless ed25519 verification, one CUDA thread per signature.
//
// Replaces the Pallas kernel plenum_tpu/ops/ed25519_pallas.py::
// _verify_kernel_pallas (built by _build_verify, entered through
// verify_kernel). Same verdicts on the same inputs: decompress A and R
// (ref10 pow22523 chain), build the per-signature table d*(-A), d = 0..15,
// with T pre-scaled by 2d, run 64 windows of 4 doublings + one constant-base
// niels add + one table add, and compare [S]B + [k](-A) projectively with R
// in both coordinates. The host (plenum_tpu_torch/ops/ed25519.host_pack)
// keeps the canonicality checks (y >= p, s >= L) and k = SHA-512(R||A||M)
// mod L, as the JAX package does.
//
// The TPU kernel used 20 radix-2^13 int32 limbs because its vector unit has
// no wide multiply. Hopper has one, so a field element here is 5 limbs of
// 51 bits with 64x64->128-bit products (__umul64hi). Limb discipline: every
// add/sub/mul returns limbs < 2^52 (one carry pass); mul accepts limbs
// < 2^54, so the 128-bit column sums never overflow; fe_canon brings a
// value (< 2^255 + 19 < 2p after two carry passes) to [0, p) with one
// conditional subtract of p, the same test the TPU kernel's fcanon makes.
// Inputs arrive as the host's 20x13-bit limbs and 8 little-endian u32
// words per scalar; the 4-bit window digits are extracted here.
//
// Bound on this card: operations (~3,600 field multiplies per verify, each
// 25 64-bit products, for ~400 bytes read). The constant base table lives
// in __constant__ memory; the per-signature 16-point table lives in local
// memory (it spills; a later change may move it to shared memory).
#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

typedef uint64_t u64;

struct fe { u64 v[5]; };
struct ge { fe X, Y, Z, T; };
struct niels { fe sub, add, t2d; };

#define MASK51 0x7ffffffffffffULL

__constant__ fe FE_D2 = {{0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL, 0x6738cc7407977ULL, 0x2406d9dc56dffULL}};
__constant__ fe FE_SQRTM1 = {{0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL, 0x78595a6804c9eULL, 0x2b8324804fc1dULL}};
__constant__ fe FE_D = {{0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL, 0x739c663a03cbbULL, 0x52036cee2b6ffULL}};

// d*B for d = 0..15 in niels form (y - x, y + x, 2d*x*y), B the base point.
__constant__ niels BASE_NIELS[16] = {
    {{{0x0000000000001ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
     {{0x0000000000001ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
     {{0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}}},
    {{{0x03905d740913eULL, 0x0ba2817d673a2ULL, 0x23e2827f4e67cULL, 0x133d2e0c21a34ULL, 0x44fd2f9298f81ULL}},
     {{0x493c6f58c3b85ULL, 0x0df7181c325f7ULL, 0x0f50b0b3e4cb7ULL, 0x5329385a44c32ULL, 0x07cf9d3a33d4bULL}},
     {{0x11205877aaa68ULL, 0x479955893d579ULL, 0x50d66309b67a0ULL, 0x2d42d0dbee5eeULL, 0x6f117b689f0c6ULL}}},
    {{{0x1a56042b4d5a8ULL, 0x189cc159ed153ULL, 0x5b8deaa3cae04ULL, 0x2aaf04f11b5d8ULL, 0x6bb595a669c92ULL}},
     {{0x4e7fc933c71d7ULL, 0x2cf41feb6b244ULL, 0x7581c0a7d1a76ULL, 0x7172d534d32f0ULL, 0x590c063fa87d2ULL}},
     {{0x2a8b3a59b7a5fULL, 0x3abb359ef087fULL, 0x4f5a8c4db05afULL, 0x5b9a807d04205ULL, 0x701af5b13ea50ULL}}},
    {{{0x11fe8a4fcd265ULL, 0x7bcb8374faaccULL, 0x52f5af4ef4d4fULL, 0x5314098f98d10ULL, 0x2ab91587555bdULL}},
     {{0x5b0a84cee9730ULL, 0x61d10c97155e4ULL, 0x4059cc8096a10ULL, 0x47a608da8014fULL, 0x7a164e1b9a80fULL}},
     {{0x6933f0dd0d889ULL, 0x44386bb4c4295ULL, 0x3cb6d3162508cULL, 0x26368b872a2c6ULL, 0x5a2826af12b9bULL}}},
    {{{0x6050a056818bfULL, 0x62acc1f5532bfULL, 0x28141ccc9fa25ULL, 0x24d61f471e683ULL, 0x27933f4c7445aULL}},
     {{0x351b98efc099fULL, 0x68fbfa4a7050eULL, 0x42a49959d971bULL, 0x393e51a469efdULL, 0x680e910321e58ULL}},
     {{0x3fbe9c476ff09ULL, 0x0af6b982e4b42ULL, 0x0ad1251ba78e5ULL, 0x715aeedee7c88ULL, 0x7f9d0cbf63553ULL}}},
    {{{0x182c3a447d6baULL, 0x22964e536eff2ULL, 0x192821f540053ULL, 0x2f9f19e788e5cULL, 0x154a7e73eb1b5ULL}},
     {{0x2bc4408a5bb33ULL, 0x078ebdda05442ULL, 0x2ffb112354123ULL, 0x375ee8df5862dULL, 0x2945ccf146e20ULL}},
     {{0x3dbf1812a8285ULL, 0x0fa17ba3f9797ULL, 0x6f69cb49c3820ULL, 0x34d5a0db3858dULL, 0x43aabe696b3bbULL}}},
    {{{0x006b67b7d8ca4ULL, 0x084fa44e72933ULL, 0x1154ee55d6f8aULL, 0x4425d842e7390ULL, 0x38b64c41ae417ULL}},
     {{0x4eeeb77157131ULL, 0x1201915f10741ULL, 0x1669cda6c9c56ULL, 0x45ec032db346dULL, 0x51e57bb6a2cc3ULL}},
     {{0x4326702ea4b71ULL, 0x06834376030b5ULL, 0x0ef0512f9c380ULL, 0x0f1a9f2512584ULL, 0x10b8e91a9f0d6ULL}}},
    {{{0x72c9aaa3221b1ULL, 0x267774474f74dULL, 0x064b0e9b28085ULL, 0x3f04ef53b27c9ULL, 0x1d6edd5d2e531ULL}},
     {{0x25cd0944ea3bfULL, 0x75673b81a4d63ULL, 0x150b925d1c0d4ULL, 0x13f38d9294114ULL, 0x461bea69283c9ULL}},
     {{0x36dc801b8b3a2ULL, 0x0e0a7d4935e30ULL, 0x1deb7cecc0d7dULL, 0x053a94e20dd2cULL, 0x7a9fbb1c6a0f9ULL}}},
    {{{0x75dedf39234d9ULL, 0x01c36ab1f3c54ULL, 0x0f08fee58f5daULL, 0x0e19613a0d637ULL, 0x3a9024a1320e0ULL}},
     {{0x7596604dd3e8fULL, 0x6fc510e058b36ULL, 0x3670c8db2cc0dULL, 0x297d899ce332fULL, 0x0915e76061bceULL}},
     {{0x1f5d9c9a2911aULL, 0x7117994fafcf8ULL, 0x2d8a8cae28dc5ULL, 0x74ab1b2090c87ULL, 0x26907c5c2ecc4ULL}}},
    {{{0x6217e039d8064ULL, 0x6dea408337e6dULL, 0x57ac112628206ULL, 0x647cb65e30473ULL, 0x49c05a51fadc9ULL}},
     {{0x6678aa6a8632fULL, 0x5ea3788d8b365ULL, 0x21bd6d6994279ULL, 0x7ace75919e4e3ULL, 0x34b9ed338add7ULL}},
     {{0x4e8bf9045af1bULL, 0x514e33a45e0d6ULL, 0x7533c5b8bfe0fULL, 0x583557b7e14c9ULL, 0x73c172021b008ULL}}},
    {{{0x3558e227081ddULL, 0x6ccb53e05eebeULL, 0x770e56013e060ULL, 0x3814239cba2faULL, 0x0353832c4950bULL}},
     {{0x593d2b360748eULL, 0x282c2fc0affe3ULL, 0x555191917d4d3ULL, 0x0f686aa81b1cdULL, 0x43ac7628aae59ULL}},
     {{0x52ae403d0f8d8ULL, 0x17a7e0c681a07ULL, 0x4c6d424743073ULL, 0x673ff8b4f87b3ULL, 0x0ec62af470bf4ULL}}},
    {{{0x75b0249864348ULL, 0x52ee11070262bULL, 0x237ae54fb5acdULL, 0x3bfd1d03aaab5ULL, 0x18ab598029d5cULL}},
     {{0x700848a802adeULL, 0x1e04605c4e5f7ULL, 0x5c0d01b9767fbULL, 0x7d7889f42388bULL, 0x4275aae2546d8ULL}},
     {{0x32cc5fd6089e9ULL, 0x426505c949b05ULL, 0x46a18880c7ad2ULL, 0x4a4221888ccdaULL, 0x3dc65522b53dfULL}}},
    {{{0x78375b53d54b9ULL, 0x219964b6490adULL, 0x3576f748ecafeULL, 0x176c426fdb72bULL, 0x7956ece28a602ULL}},
     {{0x58042a71e7539ULL, 0x2fb069a353c46ULL, 0x069be4e2378f7ULL, 0x6ac22f66e9738ULL, 0x078aafde8d3cdULL}},
     {{0x594d87f944553ULL, 0x47449c3017dd4ULL, 0x25d9187d9b368ULL, 0x0637fe5ac4d7aULL, 0x37c6a5151c83dULL}}},
    {{{0x7013b327fbf93ULL, 0x1336eeded6a0dULL, 0x2b565a2bbf3afULL, 0x253ce89591955ULL, 0x0267882d17602ULL}},
     {{0x0c222a2007f6dULL, 0x356b79bdb77eeULL, 0x41ee81efe12ceULL, 0x120a9bd07097dULL, 0x234fd7eec346fULL}},
     {{0x0a119732ea378ULL, 0x63bf1ba8e2a6cULL, 0x69f94cc90df9aULL, 0x431d1779bfc48ULL, 0x497ba6fdaa097ULL}}},
    {{{0x38a44d4171280ULL, 0x1fb6f94663bfbULL, 0x3b11ea739a6c8ULL, 0x06908972b78b7ULL, 0x2df0ea2c5b3c8ULL}},
     {{0x070ec3f213df2ULL, 0x00afdf530e4dfULL, 0x206f756009dffULL, 0x3180d23a60214ULL, 0x6eaf60b2464d1ULL}},
     {{0x1c5877a1e1b82ULL, 0x5b45537ea92d4ULL, 0x32c6eabc08e5fULL, 0x649ce0fefb81fULL, 0x24bf7e3cd8ba9ULL}}},
    {{{0x3cd86468ccf0bULL, 0x48553221ac081ULL, 0x6c9464b4e0a6eULL, 0x75fba84180403ULL, 0x43b5cd4218d05ULL}},
     {{0x6cc0313cfeaa0ULL, 0x1a313848da499ULL, 0x7cb534219230aULL, 0x39596dedefd60ULL, 0x61e22917f12deULL}},
     {{0x2762f9bd0b516ULL, 0x1c6e7fbddcbb3ULL, 0x75909c3ace2bdULL, 0x42101972d3ec9ULL, 0x511d61210ae4dULL}}}};

struct u128 { u64 lo, hi; };

__device__ __forceinline__ void mac(u128& acc, u64 a, u64 b) {
  u64 lo = a * b;
  u64 hi = __umul64hi(a, b);
  acc.lo += lo;
  acc.hi += hi + (acc.lo < lo ? 1 : 0);
}

__device__ __forceinline__ void add_small(u128& acc, u64 c) {
  acc.lo += c;
  acc.hi += (acc.lo < c ? 1 : 0);
}

__device__ __forceinline__ u64 shr51(const u128& acc) {
  return (acc.lo >> 51) | (acc.hi << 13);
}

__device__ __forceinline__ void fe_carry(fe& h) {
  u64 c;
  c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= MASK51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= MASK51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= MASK51; h.v[4] += c;
  c = h.v[4] >> 51; h.v[4] &= MASK51; h.v[0] += 19 * c;
}

__device__ __forceinline__ fe fe_const(u64 v0) {
  fe h;
  h.v[0] = v0; h.v[1] = 0; h.v[2] = 0; h.v[3] = 0; h.v[4] = 0;
  return h;
}

__device__ __forceinline__ fe fe_add(const fe& f, const fe& g) {
  fe h;
#pragma unroll
  for (int i = 0; i < 5; ++i) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
  return h;
}

// f - g computed as f + 4p - g: every limb of 4p exceeds any limb of g.
__device__ __forceinline__ fe fe_sub(const fe& f, const fe& g) {
  fe h;
  h.v[0] = f.v[0] + 0x1fffffffffffb4ULL - g.v[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) h.v[i] = f.v[i] + 0x1ffffffffffffcULL - g.v[i];
  fe_carry(h);
  return h;
}

__device__ __forceinline__ fe fe_neg(const fe& f) {
  return fe_sub(fe_const(0), f);
}

__device__ fe fe_mul(const fe& f, const fe& g) {
  u64 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
  u64 g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3], g4 = g.v[4];
  u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
  u128 r0 = {0, 0}, r1 = {0, 0}, r2 = {0, 0}, r3 = {0, 0}, r4 = {0, 0};
  mac(r0, f0, g0); mac(r0, f1, g4_19); mac(r0, f2, g3_19);
  mac(r0, f3, g2_19); mac(r0, f4, g1_19);
  mac(r1, f0, g1); mac(r1, f1, g0); mac(r1, f2, g4_19);
  mac(r1, f3, g3_19); mac(r1, f4, g2_19);
  mac(r2, f0, g2); mac(r2, f1, g1); mac(r2, f2, g0);
  mac(r2, f3, g4_19); mac(r2, f4, g3_19);
  mac(r3, f0, g3); mac(r3, f1, g2); mac(r3, f2, g1);
  mac(r3, f3, g0); mac(r3, f4, g4_19);
  mac(r4, f0, g4); mac(r4, f1, g3); mac(r4, f2, g2);
  mac(r4, f3, g1); mac(r4, f4, g0);
  fe h;
  u64 c;
  c = shr51(r0); h.v[0] = r0.lo & MASK51; add_small(r1, c);
  c = shr51(r1); h.v[1] = r1.lo & MASK51; add_small(r2, c);
  c = shr51(r2); h.v[2] = r2.lo & MASK51; add_small(r3, c);
  c = shr51(r3); h.v[3] = r3.lo & MASK51; add_small(r4, c);
  c = shr51(r4); h.v[4] = r4.lo & MASK51;
  h.v[0] += 19 * c;
  c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
  return h;
}

__device__ __forceinline__ fe fe_sq(const fe& f) { return fe_mul(f, f); }

__device__ fe fe_sqn(fe f, int n) {
  for (int i = 0; i < n; ++i) f = fe_sq(f);
  return f;
}

// Canonical representative in [0, p).
__device__ fe fe_canon(const fe& f) {
  fe h = f;
  fe_carry(h);
  fe_carry(h);
  // h < 2^255 + 19 < 2p: subtract p once iff h + 19 >= 2^255
  u64 q = (h.v[0] + 19) >> 51;
  q = (h.v[1] + q) >> 51;
  q = (h.v[2] + q) >> 51;
  q = (h.v[3] + q) >> 51;
  q = (h.v[4] + q) >> 51;
  h.v[0] += 19 * q;
  u64 c;
  c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= MASK51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= MASK51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= MASK51; h.v[4] += c;
  h.v[4] &= MASK51;
  return h;
}

__device__ __forceinline__ bool fe_iszero(const fe& f) {
  fe c = fe_canon(f);
  return (c.v[0] | c.v[1] | c.v[2] | c.v[3] | c.v[4]) == 0;
}

// 20 limbs of 13 bits (value < 2^260), as the host packs them.
__device__ fe fe_from_limbs13(const int32_t* limbs) {
  u64 w[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    u64 l = (u64)(uint32_t)limbs[i];
    int bit = 13 * i, word = bit >> 6, off = bit & 63;
    w[word] |= l << off;
    if (off > 51) w[word + 1] |= l >> (64 - off);
  }
  fe h;
  h.v[0] = w[0] & MASK51;
  h.v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
  h.v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
  h.v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
  h.v[4] = ((w[3] >> 12) | (w[4] << 52)) & MASK51;
  // bits >= 255 (none for canonical y < p) fold back as x19
  h.v[0] += 19 * ((w[3] >> 63) | (w[4] << 1));
  fe_carry(h);
  return h;
}

// x^((p-5)/8): the ref10 pow22523 addition chain.
__device__ fe fe_pow_p58(const fe& x) {
  fe z2 = fe_sq(x);
  fe z9 = fe_mul(fe_sqn(z2, 2), x);
  fe z11 = fe_mul(z9, z2);
  fe z22 = fe_sq(z11);
  fe z_5_0 = fe_mul(z22, z9);
  fe z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0);
  fe z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0);
  fe z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0);
  fe z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0);
  fe z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0);
  fe z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0);
  fe z_250_0 = fe_mul(fe_sqn(z_200_0, 50), z_50_0);
  return fe_mul(fe_sqn(z_250_0, 2), x);
}

// x from y and the sign bit; ok = false when y is not on the curve or
// x = 0 with the sign bit set (ed25519_pallas._decompress).
__device__ fe decompress(const fe& y, int sign, bool& ok) {
  fe one = fe_const(1);
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, one);
  fe v = fe_add(fe_mul(yy, FE_D), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
  fe vxx = fe_mul(v, fe_sq(x));
  bool is_root = fe_iszero(fe_sub(vxx, u));
  bool is_neg_root = fe_iszero(fe_add(vxx, u));
  if (is_neg_root && !is_root) x = fe_mul(x, FE_SQRTM1);
  ok = is_root || is_neg_root;
  fe xc = fe_canon(x);
  bool x_zero = (xc.v[0] | xc.v[1] | xc.v[2] | xc.v[3] | xc.v[4]) == 0;
  if (x_zero && sign == 1) ok = false;
  return ((int)(xc.v[0] & 1) != sign) ? fe_neg(xc) : xc;
}

__device__ ge ge_double(const ge& p) {
  fe A = fe_sq(p.X);
  fe B = fe_sq(p.Y);
  fe Zs = fe_sq(p.Z);
  fe C = fe_add(Zs, Zs);
  fe E = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), A), B);
  fe G = fe_sub(B, A);
  fe F = fe_sub(G, C);
  fe H = fe_sub(fe_neg(A), B);
  ge r;
  r.X = fe_mul(E, F); r.Y = fe_mul(G, H); r.Z = fe_mul(F, G); r.T = fe_mul(E, H);
  return r;
}

// Unified addition; q.T is pre-multiplied by 2d when t_prescaled.
__device__ ge ge_add(const ge& p, const ge& q, bool t_prescaled) {
  fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe C = t_prescaled ? fe_mul(p.T, q.T) : fe_mul(fe_mul(p.T, FE_D2), q.T);
  fe Dv = fe_mul(fe_add(p.Z, p.Z), q.Z);
  fe E = fe_sub(B, A);
  fe F = fe_sub(Dv, C);
  fe G = fe_add(Dv, C);
  fe H = fe_add(B, A);
  ge r;
  r.X = fe_mul(E, F); r.Y = fe_mul(G, H); r.Z = fe_mul(F, G); r.T = fe_mul(E, H);
  return r;
}

// Mixed addition with a constant niels point (Z2 = 1).
__device__ ge ge_add_niels(const ge& p, const niels& n) {
  fe A = fe_mul(fe_sub(p.Y, p.X), n.sub);
  fe B = fe_mul(fe_add(p.Y, p.X), n.add);
  fe C = fe_mul(p.T, n.t2d);
  fe Dv = fe_add(p.Z, p.Z);
  fe E = fe_sub(B, A);
  fe F = fe_sub(Dv, C);
  fe G = fe_add(Dv, C);
  fe H = fe_add(B, A);
  ge r;
  r.X = fe_mul(E, F); r.Y = fe_mul(G, H); r.Z = fe_mul(F, G); r.T = fe_mul(E, H);
  return r;
}

// The verdict for one signature: ay/ry 20 limbs each, s/k 8 LE u32 words.
__device__ bool verify_one(const int32_t* ay_l, int asign, const int32_t* ry_l,
                           int rsign, const uint32_t* s_w, const uint32_t* k_w) {
  fe ay = fe_from_limbs13(ay_l);
  fe ry = fe_from_limbs13(ry_l);
  bool ok_a, ok_r;
  fe ax = decompress(ay, asign, ok_a);
  fe rx = decompress(ry, rsign, ok_r);

  ge ident;
  ident.X = fe_const(0); ident.Y = fe_const(1);
  ident.Z = fe_const(1); ident.T = fe_const(0);

  // d * (-A), d = 0..15, extended coordinates
  ge na;
  na.X = fe_neg(ax); na.Y = ay; na.Z = fe_const(1); na.T = fe_mul(na.X, ay);
  ge tab[16];
  tab[0] = ident;
  tab[1] = na;
  for (int d = 2; d < 16; ++d)
    tab[d] = (d & 1) ? ge_add(tab[d - 1], na, false) : ge_double(tab[d >> 1]);
  for (int d = 0; d < 16; ++d) tab[d].T = fe_mul(tab[d].T, FE_D2);

  uint32_t s[8], k[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) { s[j] = s_w[j]; k[j] = k_w[j]; }

  ge acc = ident;
  for (int w = 63; w >= 0; --w) {
    acc = ge_double(acc);
    acc = ge_double(acc);
    acc = ge_double(acc);
    acc = ge_double(acc);
    int sd = (s[w >> 3] >> (4 * (w & 7))) & 15;
    int kd = (k[w >> 3] >> (4 * (w & 7))) & 15;
    acc = ge_add_niels(acc, BASE_NIELS[sd]);
    acc = ge_add(acc, tab[kd], true);
  }
  bool ok_x = fe_iszero(fe_sub(fe_mul(rx, acc.Z), acc.X));
  bool ok_y = fe_iszero(fe_sub(fe_mul(ry, acc.Z), acc.Y));
  return ok_a && ok_r && ok_x && ok_y;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128)
ed25519_verify_kernel(const int32_t* __restrict__ ay,
                      const int32_t* __restrict__ asign,
                      const int32_t* __restrict__ ry,
                      const int32_t* __restrict__ rsign,
                      const uint32_t* __restrict__ s_words,
                      const uint32_t* __restrict__ k_words,
                      int32_t* __restrict__ ok, int B) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  ok[i] = verify_one(ay + 20 * (size_t)i, asign[i], ry + 20 * (size_t)i,
                     rsign[i], s_words + 8 * (size_t)i,
                     k_words + 8 * (size_t)i) ? 1 : 0;
}

// ay, ry: [B, 20] int32 limbs; asign, rsign: [B] int32; s_words, k_words:
// [B, 8] uint32; ok: [B] int32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int ed25519_verify(const void* ay, const void* asign,
                              const void* ry, const void* rsign,
                              const void* s_words, const void* k_words,
                              void* ok, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  int blocks = (B + threads - 1) / threads;
  ed25519_verify_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ay, (const int32_t*)asign, (const int32_t*)ry,
      (const int32_t*)rsign, (const uint32_t*)s_words,
      (const uint32_t*)k_words, (int32_t*)ok, B);
  return (int)cudaGetLastError();
}
#endif
