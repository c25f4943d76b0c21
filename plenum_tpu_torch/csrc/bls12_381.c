/* BLS12-381 native arithmetic — the framework's scalar-floor pairing path.
 *
 * Fills the role Hyperledger Ursa (Rust) plays for the reference
 * (crypto/bls/indy_crypto/bls_crypto_indy_crypto.py): field towers,
 * curve groups and the pairing in portable C (uint128 limb arithmetic,
 * Montgomery multiplication). Python (crypto/bls_native.py)
 * orchestrates hashing/serialization and falls back to the pure-Python
 * module when no C compiler is available.
 *
 * Conventions at the ABI boundary:
 *  - field elements: 48-byte big-endian integers (non-Montgomery)
 *  - G1 point: 96 bytes x||y, all-zero = infinity
 *  - G2 point: 192 bytes x.c0||x.c1||y.c0||y.c1, all-zero = infinity
 *  - scalars: 32-byte big-endian
 *  - the final exponentiation computes f^(3·(q^4-q^2+1)/r) via the
 *    Hayashida–Hayasaka–Teruya decomposition (x-1)^2(x+q)(x^2+q^2-1)+3 —
 *    a fixed cube power of the standard ate pairing, so products and
 *    is-one checks are unchanged (3 does not divide r).
 */
#include <stdint.h>
#include <string.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef uint8_t u8;

#define NL 6

static const u64 Qm[NL] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const u64 R2[NL] = {
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
    0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};
static const u64 N0 = 0x89f3fffcfffcfffdULL;
static const u64 ONE_M[NL] = {
    0x760900000002fffdULL, 0xebf4000bc40c0002ULL, 0x5f48985753c758baULL,
    0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL};
static const u64 X_ABS = 0xd201000000010000ULL;

/* ------------------------------------------------------------------ fp */

typedef struct { u64 l[NL]; } fp;

static const fp FP_ZERO = {{0, 0, 0, 0, 0, 0}};

static int fp_is_zero(const fp *a) {
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= a->l[i];
    return acc == 0;
}

static int fp_eq(const fp *a, const fp *b) {
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= a->l[i] ^ b->l[i];
    return acc == 0;
}

static int fp_geq_q(const u64 *t) {
    for (int i = NL - 1; i >= 0; i--) {
        if (t[i] > Qm[i]) return 1;
        if (t[i] < Qm[i]) return 0;
    }
    return 1;
}

static void fp_add(fp *r, const fp *a, const fp *b) {
    u128 c = 0;
    u64 t[NL];
    for (int i = 0; i < NL; i++) {
        c += (u128)a->l[i] + b->l[i];
        t[i] = (u64)c;
        c >>= 64;
    }
    if (c || fp_geq_q(t)) {
        u128 br = 0;
        for (int i = 0; i < NL; i++) {
            u128 d = (u128)t[i] - Qm[i] - br;
            t[i] = (u64)d;
            br = (d >> 64) & 1;
        }
    }
    memcpy(r->l, t, sizeof t);
}

static void fp_sub(fp *r, const fp *a, const fp *b) {
    u128 br = 0;
    u64 t[NL];
    for (int i = 0; i < NL; i++) {
        u128 d = (u128)a->l[i] - b->l[i] - br;
        t[i] = (u64)d;
        br = (d >> 64) & 1;
    }
    if (br) {
        u128 c = 0;
        for (int i = 0; i < NL; i++) {
            c += (u128)t[i] + Qm[i];
            t[i] = (u64)c;
            c >>= 64;
        }
    }
    memcpy(r->l, t, sizeof t);
}

static void fp_neg(fp *r, const fp *a) {
    if (fp_is_zero(a)) { *r = *a; return; }
    u128 br = 0;
    for (int i = 0; i < NL; i++) {
        u128 d = (u128)Qm[i] - a->l[i] - br;
        r->l[i] = (u64)d;
        br = (d >> 64) & 1;
    }
}

/* CIOS Montgomery multiplication (Q < 2^382 = R/4 ⇒ one final sub). */
static void fp_mul(fp *r, const fp *a, const fp *b) {
    u64 t[NL + 2];
    memset(t, 0, sizeof t);
    for (int i = 0; i < NL; i++) {
        u128 c = 0;
        for (int j = 0; j < NL; j++) {
            c += (u128)a->l[j] * b->l[i] + t[j];
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[NL];
        t[NL] = (u64)c;
        t[NL + 1] = (u64)(c >> 64);
        u64 m = t[0] * N0;
        c = (u128)m * Qm[0] + t[0];
        c >>= 64;
        for (int j = 1; j < NL; j++) {
            c += (u128)m * Qm[j] + t[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[NL];
        t[NL - 1] = (u64)c;
        t[NL] = t[NL + 1] + (u64)(c >> 64);
        t[NL + 1] = 0;
    }
    if (t[NL] || fp_geq_q(t)) {
        u128 br = 0;
        for (int i = 0; i < NL; i++) {
            u128 d = (u128)t[i] - Qm[i] - br;
            t[i] = (u64)d;
            br = (d >> 64) & 1;
        }
    }
    memcpy(r->l, t, NL * sizeof(u64));
}

static void fp_sqr(fp *r, const fp *a) { fp_mul(r, a, a); }

/* ---- raw (non-Montgomery) 6-limb helpers for ext-gcd inversion ---- */

static int raw_is_one(const u64 *a) {
    if (a[0] != 1) return 0;
    for (int i = 1; i < NL; i++) if (a[i]) return 0;
    return 1;
}

static int raw_geq(const u64 *a, const u64 *b) {
    for (int i = NL - 1; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static void raw_sub(u64 *r, const u64 *a, const u64 *b) {
    u128 br = 0;
    for (int i = 0; i < NL; i++) {
        u128 d = (u128)a[i] - b[i] - br;
        r[i] = (u64)d;
        br = (d >> 64) & 1;
    }
}

static void raw_shr1(u64 *a) {
    for (int i = 0; i < NL - 1; i++)
        a[i] = (a[i] >> 1) | (a[i + 1] << 63);
    a[NL - 1] >>= 1;
}

static void raw_half_mod_q(u64 *a) {
    /* a/2 mod q: if odd, add q first (q odd ⇒ a+q even; carry bit
     * shifts back in) */
    if (a[0] & 1) {
        u128 c = 0;
        for (int i = 0; i < NL; i++) {
            c += (u128)a[i] + Qm[i];
            a[i] = (u64)c;
            c >>= 64;
        }
        raw_shr1(a);
        if (c) a[NL - 1] |= 1ULL << 63;
    } else {
        raw_shr1(a);
    }
}

static void raw_sub_mod_q(u64 *r, const u64 *a, const u64 *b) {
    u128 br = 0;
    for (int i = 0; i < NL; i++) {
        u128 d = (u128)a[i] - b[i] - br;
        r[i] = (u64)d;
        br = (d >> 64) & 1;
    }
    if (br) {
        u128 c = 0;
        for (int i = 0; i < NL; i++) {
            c += (u128)r[i] + Qm[i];
            r[i] = (u64)c;
            c >>= 64;
        }
    }
}

/* Binary extended Euclid (variable-time — all inputs are public
 * consensus data). ~15x faster than Fermat exponentiation. */
static void fp_inv(fp *r, const fp *a) {
    fp one = {{1, 0, 0, 0, 0, 0}}, raw;
    fp_mul(&raw, a, &one);              /* from Montgomery */
    u64 u[NL], v[NL], x1[NL], x2[NL];
    memcpy(u, raw.l, sizeof u);
    memcpy(v, Qm, sizeof v);
    memset(x1, 0, sizeof x1); x1[0] = 1;
    memset(x2, 0, sizeof x2);
    if (fp_is_zero(&raw)) { *r = FP_ZERO; return; }
    while (!raw_is_one(u) && !raw_is_one(v)) {
        while (!(u[0] & 1)) { raw_shr1(u); raw_half_mod_q(x1); }
        while (!(v[0] & 1)) { raw_shr1(v); raw_half_mod_q(x2); }
        if (raw_geq(u, v)) {
            raw_sub(u, u, v);
            raw_sub_mod_q(x1, x1, x2);
        } else {
            raw_sub(v, v, u);
            raw_sub_mod_q(x2, x2, x1);
        }
    }
    fp res;
    memcpy(res.l, raw_is_one(u) ? x1 : x2, sizeof res.l);
    fp r2m; memcpy(r2m.l, R2, sizeof R2);
    fp_mul(r, &res, &r2m);              /* back to Montgomery */
}

static void fp_from_bytes(fp *r, const u8 *in48) {
    fp raw;
    for (int i = 0; i < NL; i++) {
        u64 v = 0;
        for (int j = 0; j < 8; j++)
            v = (v << 8) | in48[(NL - 1 - i) * 8 + j];
        raw.l[i] = v;
    }
    fp r2; memcpy(r2.l, R2, sizeof R2);
    fp_mul(r, &raw, &r2);   /* to Montgomery */
}

static void fp_to_bytes(u8 *out48, const fp *a) {
    fp one = {{1, 0, 0, 0, 0, 0}}, raw;
    fp_mul(&raw, a, &one);  /* from Montgomery */
    for (int i = 0; i < NL; i++) {
        u64 v = raw.l[NL - 1 - i];
        for (int j = 0; j < 8; j++)
            out48[i * 8 + j] = (u8)(v >> (56 - 8 * j));
    }
}

/* ----------------------------------------------------------------- fp2 */
/* fq2 = fp[u]/(u^2+1) */

typedef struct { fp c0, c1; } fp2;

static void fp2_add(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_add(&r->c0, &a->c0, &b->c0);
    fp_add(&r->c1, &a->c1, &b->c1);
}

static void fp2_sub(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_sub(&r->c0, &a->c0, &b->c0);
    fp_sub(&r->c1, &a->c1, &b->c1);
}

static void fp2_neg(fp2 *r, const fp2 *a) {
    fp_neg(&r->c0, &a->c0);
    fp_neg(&r->c1, &a->c1);
}

static void fp2_mul(fp2 *r, const fp2 *a, const fp2 *b) {
    fp t0, t1, t2, t3;
    fp_mul(&t0, &a->c0, &b->c0);
    fp_mul(&t1, &a->c1, &b->c1);
    fp_add(&t2, &a->c0, &a->c1);
    fp_add(&t3, &b->c0, &b->c1);
    fp_mul(&t2, &t2, &t3);      /* (a0+a1)(b0+b1) */
    fp_sub(&t2, &t2, &t0);
    fp_sub(&t2, &t2, &t1);      /* a0b1 + a1b0 */
    fp_sub(&r->c0, &t0, &t1);
    r->c1 = t2;
}

static void fp2_sqr(fp2 *r, const fp2 *a) {
    /* complex squaring: (a0+a1u)² = (a0+a1)(a0−a1) + 2a0a1·u —
     * 2 base mults instead of fp2_mul's 3 */
    fp s, d, t;
    fp_add(&s, &a->c0, &a->c1);
    fp_sub(&d, &a->c0, &a->c1);
    fp_mul(&t, &a->c0, &a->c1);
    fp_mul(&r->c0, &s, &d);
    fp_add(&r->c1, &t, &t);
}

static void fp2_mul_fp(fp2 *r, const fp2 *a, const fp *b) {
    fp_mul(&r->c0, &a->c0, b);
    fp_mul(&r->c1, &a->c1, b);
}

static void fp2_conj(fp2 *r, const fp2 *a) {
    r->c0 = a->c0;
    fp_neg(&r->c1, &a->c1);
}

static void fp2_inv(fp2 *r, const fp2 *a) {
    fp t0, t1;
    fp_sqr(&t0, &a->c0);
    fp_sqr(&t1, &a->c1);
    fp_add(&t0, &t0, &t1);      /* c0^2 + c1^2 */
    fp_inv(&t0, &t0);
    fp_mul(&r->c0, &a->c0, &t0);
    fp_mul(&t1, &a->c1, &t0);
    fp_neg(&r->c1, &t1);
}

/* ξ = 1 + u */
static void fp2_mul_nonres(fp2 *r, const fp2 *a) {
    fp t0;
    fp_sub(&t0, &a->c0, &a->c1);
    fp_add(&r->c1, &a->c0, &a->c1);
    r->c0 = t0;
}

static int fp2_is_zero(const fp2 *a) {
    return fp_is_zero(&a->c0) && fp_is_zero(&a->c1);
}

static int fp2_eq(const fp2 *a, const fp2 *b) {
    return fp_eq(&a->c0, &b->c0) && fp_eq(&a->c1, &b->c1);
}

/* ----------------------------------------------------------------- fp6 */
/* fq6 = fq2[v]/(v^3 - ξ) */

typedef struct { fp2 c0, c1, c2; } fp6;

static void fp6_add(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2_add(&r->c0, &a->c0, &b->c0);
    fp2_add(&r->c1, &a->c1, &b->c1);
    fp2_add(&r->c2, &a->c2, &b->c2);
}

static void fp6_sub(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2_sub(&r->c0, &a->c0, &b->c0);
    fp2_sub(&r->c1, &a->c1, &b->c1);
    fp2_sub(&r->c2, &a->c2, &b->c2);
}

static void fp6_neg(fp6 *r, const fp6 *a) {
    fp2_neg(&r->c0, &a->c0);
    fp2_neg(&r->c1, &a->c1);
    fp2_neg(&r->c2, &a->c2);
}

static void fp6_mul(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2 t0, t1, t2, s, u0, u1, u2;
    fp2_mul(&t0, &a->c0, &b->c0);
    fp2_mul(&t1, &a->c1, &b->c1);
    fp2_mul(&t2, &a->c2, &b->c2);
    /* c0 = t0 + ξ((a1+a2)(b1+b2) - t1 - t2) */
    fp2_add(&u0, &a->c1, &a->c2);
    fp2_add(&u1, &b->c1, &b->c2);
    fp2_mul(&s, &u0, &u1);
    fp2_sub(&s, &s, &t1);
    fp2_sub(&s, &s, &t2);
    fp2_mul_nonres(&s, &s);
    fp2_add(&u0, &s, &t0);
    /* c1 = (a0+a1)(b0+b1) - t0 - t1 + ξ t2 */
    fp2 v0, v1;
    fp2_add(&v0, &a->c0, &a->c1);
    fp2_add(&v1, &b->c0, &b->c1);
    fp2_mul(&s, &v0, &v1);
    fp2_sub(&s, &s, &t0);
    fp2_sub(&s, &s, &t1);
    fp2_mul_nonres(&v0, &t2);
    fp2_add(&u1, &s, &v0);
    /* c2 = (a0+a2)(b0+b2) - t0 - t2 + t1 */
    fp2_add(&v0, &a->c0, &a->c2);
    fp2_add(&v1, &b->c0, &b->c2);
    fp2_mul(&s, &v0, &v1);
    fp2_sub(&s, &s, &t0);
    fp2_sub(&s, &s, &t2);
    fp2_add(&u2, &s, &t1);
    r->c0 = u0; r->c1 = u1; r->c2 = u2;
}

static void fp6_mul_nonres(fp6 *r, const fp6 *a) {
    /* ×v: (c0, c1, c2) -> (ξ c2, c0, c1) */
    fp2 t;
    fp2_mul_nonres(&t, &a->c2);
    r->c2 = a->c1;
    r->c1 = a->c0;
    r->c0 = t;
}

static void fp6_inv(fp6 *r, const fp6 *a) {
    /* standard tower inversion */
    fp2 A, B, C, t0, t1, t2, F;
    fp2_sqr(&t0, &a->c0);
    fp2_mul(&t1, &a->c1, &a->c2);
    fp2_mul_nonres(&t2, &t1);
    fp2_sub(&A, &t0, &t2);                 /* c0^2 - ξ c1 c2 */
    fp2_sqr(&t0, &a->c2);
    fp2_mul_nonres(&t0, &t0);
    fp2_mul(&t1, &a->c0, &a->c1);
    fp2_sub(&B, &t0, &t1);                 /* ξ c2^2 - c0 c1 */
    fp2_sqr(&t0, &a->c1);
    fp2_mul(&t1, &a->c0, &a->c2);
    fp2_sub(&C, &t0, &t1);                 /* c1^2 - c0 c2 */
    fp2_mul(&t0, &a->c2, &B);
    fp2_mul(&t1, &a->c1, &C);
    fp2_add(&t0, &t0, &t1);
    fp2_mul_nonres(&t0, &t0);
    fp2_mul(&t1, &a->c0, &A);
    fp2_add(&F, &t0, &t1);                 /* c0 A + ξ(c2 B + c1 C) */
    fp2_inv(&F, &F);
    fp2_mul(&r->c0, &A, &F);
    fp2_mul(&r->c1, &B, &F);
    fp2_mul(&r->c2, &C, &F);
}

static int fp6_is_zero(const fp6 *a) {
    return fp2_is_zero(&a->c0) && fp2_is_zero(&a->c1) && fp2_is_zero(&a->c2);
}

/* ---------------------------------------------------------------- fp12 */
/* fq12 = fq6[w]/(w^2 - v) */

typedef struct { fp6 c0, c1; } fp12;

static void fp12_mul(fp12 *r, const fp12 *a, const fp12 *b) {
    fp6 t0, t1, t2, t3;
    fp6_mul(&t0, &a->c0, &b->c0);
    fp6_mul(&t1, &a->c1, &b->c1);
    fp6_add(&t2, &a->c0, &a->c1);
    fp6_add(&t3, &b->c0, &b->c1);
    fp6_mul(&t2, &t2, &t3);
    fp6_sub(&t2, &t2, &t0);
    fp6_sub(&t2, &t2, &t1);                /* a0 b1 + a1 b0 */
    fp6_mul_nonres(&t1, &t1);
    fp6_add(&r->c0, &t0, &t1);
    r->c1 = t2;
}

static void fp12_sqr(fp12 *r, const fp12 *a) {
    /* Karatsuba-style: (c0 + c1 w)², w² = v —
     * 2 fp6_muls instead of fp12_mul's 3 */
    fp6 t, s0, s1;
    fp6_mul(&t, &a->c0, &a->c1);
    fp6_add(&s0, &a->c0, &a->c1);
    fp6_mul_nonres(&s1, &a->c1);
    fp6_add(&s1, &s1, &a->c0);
    fp6_mul(&s0, &s0, &s1);             /* (c0+c1)(c0+v c1) */
    fp6_sub(&s0, &s0, &t);
    fp6 vt;
    fp6_mul_nonres(&vt, &t);
    fp6_sub(&r->c0, &s0, &vt);
    fp6_add(&r->c1, &t, &t);
}

static void fp12_conj(fp12 *r, const fp12 *a) {
    r->c0 = a->c0;
    fp6_neg(&r->c1, &a->c1);
}

static void fp12_inv(fp12 *r, const fp12 *a) {
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

static void fp12_one(fp12 *r) {
    memset(r, 0, sizeof *r);
    memcpy(r->c0.c0.c0.l, ONE_M, sizeof ONE_M);
}

static int fp12_is_one(const fp12 *a) {
    fp one;
    memcpy(one.l, ONE_M, sizeof ONE_M);
    if (!fp_eq(&a->c0.c0.c0, &one)) return 0;
    if (!fp_is_zero(&a->c0.c0.c1)) return 0;
    if (!fp2_is_zero(&a->c0.c1) || !fp2_is_zero(&a->c0.c2)) return 0;
    return fp6_is_zero(&a->c1);
}

/* -------------------------------------------------------- frobenius */

static fp2 FROB_G[6];       /* γ_k = ξ^(k(q-1)/6), k = 0..5 */
static int frob_ready = 0;

/* fq2 pow by big-endian byte exponent */
static void fp2_pow_bytes(fp2 *r, const fp2 *a, const u8 *e, int elen) {
    fp2 acc;
    memset(&acc, 0, sizeof acc);
    memcpy(acc.c0.l, ONE_M, sizeof ONE_M);
    for (int i = 0; i < elen; i++) {
        for (int b = 7; b >= 0; b--) {
            fp2_sqr(&acc, &acc);
            if ((e[i] >> b) & 1) fp2_mul(&acc, &acc, a);
        }
    }
    *r = acc;
}

static void frob_init(void) {
    if (frob_ready) return;
    /* (q-1)/6 as 48-byte BE: computed from Q limbs */
    u8 e[48];
    /* q-1 then divide by 6 via simple big-int ops on bytes */
    u64 limbs[NL];
    memcpy(limbs, Qm, sizeof Qm);
    limbs[0] -= 1;                       /* q-1 (no borrow: low limb odd) */
    /* divide by 6, big-endian long division over 64-bit limbs */
    u128 rem = 0;
    u64 quot[NL];
    for (int i = NL - 1; i >= 0; i--) {
        u128 cur = (rem << 64) | limbs[i];
        quot[i] = (u64)(cur / 6);
        rem = cur % 6;
    }
    for (int i = 0; i < NL; i++) {
        u64 v = quot[NL - 1 - i];
        for (int j = 0; j < 8; j++)
            e[i * 8 + j] = (u8)(v >> (56 - 8 * j));
    }
    fp2 xi;
    memset(&xi, 0, sizeof xi);
    memcpy(xi.c0.l, ONE_M, sizeof ONE_M);  /* ξ = 1 + u */
    memcpy(xi.c1.l, ONE_M, sizeof ONE_M);
    fp2 g1;
    fp2_pow_bytes(&g1, &xi, e, 48);
    memset(&FROB_G[0], 0, sizeof(fp2));
    memcpy(FROB_G[0].c0.l, ONE_M, sizeof ONE_M);
    FROB_G[1] = g1;
    for (int k = 2; k < 6; k++)
        fp2_mul(&FROB_G[k], &FROB_G[k - 1], &g1);
    frob_ready = 1;
}

/* f^q: conjugate every fq2 coefficient, multiply coefficient of w^k by
 * γ_k. Basis map: c0 = (w^0, w^2, w^4), c1 = (w^1, w^3, w^5). */
static void fp12_frob(fp12 *r, const fp12 *a) {
    fp2 t;
    fp2_conj(&t, &a->c0.c0); r->c0.c0 = t;
    fp2_conj(&t, &a->c0.c1); fp2_mul(&r->c0.c1, &t, &FROB_G[2]);
    fp2_conj(&t, &a->c0.c2); fp2_mul(&r->c0.c2, &t, &FROB_G[4]);
    fp2_conj(&t, &a->c1.c0); fp2_mul(&r->c1.c0, &t, &FROB_G[1]);
    fp2_conj(&t, &a->c1.c1); fp2_mul(&r->c1.c1, &t, &FROB_G[3]);
    fp2_conj(&t, &a->c1.c2); fp2_mul(&r->c1.c2, &t, &FROB_G[5]);
}

/* ------------------------------------------------------------- groups */

typedef struct { fp x, y; int inf; } g1;
typedef struct { fp2 x, y; int inf; } g2;

static void g1_add_aff(g1 *r, const g1 *p, const g1 *q) {
    if (p->inf) { *r = *q; return; }
    if (q->inf) { *r = *p; return; }
    fp lam, t0, t1;
    if (fp_eq(&p->x, &q->x)) {
        fp ysum;
        fp_add(&ysum, &p->y, &q->y);
        if (fp_is_zero(&ysum)) { r->inf = 1; r->x = FP_ZERO; r->y = FP_ZERO; return; }
        fp_sqr(&t0, &p->x);
        fp_add(&t1, &t0, &t0);
        fp_add(&t0, &t1, &t0);          /* 3x² */
        fp_add(&t1, &p->y, &p->y);
        fp_inv(&t1, &t1);
        fp_mul(&lam, &t0, &t1);
    } else {
        fp_sub(&t0, &q->y, &p->y);
        fp_sub(&t1, &q->x, &p->x);
        fp_inv(&t1, &t1);
        fp_mul(&lam, &t0, &t1);
    }
    fp x3, y3;
    fp_sqr(&x3, &lam);
    fp_sub(&x3, &x3, &p->x);
    fp_sub(&x3, &x3, &q->x);
    fp_sub(&t0, &p->x, &x3);
    fp_mul(&y3, &lam, &t0);
    fp_sub(&y3, &y3, &p->y);
    r->x = x3; r->y = y3; r->inf = 0;
}

/* Jacobian coordinates for inversion-free scalar multiplication
 * (a = 0 curve): one field inversion at the very end. */
typedef struct { fp X, Y, Z; } g1j;   /* Z = 0 ⇒ infinity */

static void g1j_dbl(g1j *r, const g1j *p) {
    if (fp_is_zero(&p->Z)) { *r = *p; return; }
    fp A, B, C, D, E, F, t0, t1;
    fp_sqr(&A, &p->X);
    fp_sqr(&B, &p->Y);
    fp_sqr(&C, &B);
    fp_add(&t0, &p->X, &B);
    fp_sqr(&t0, &t0);
    fp_sub(&t0, &t0, &A);
    fp_sub(&t0, &t0, &C);
    fp_add(&D, &t0, &t0);               /* 2((X+B)²−A−C) */
    fp_add(&E, &A, &A);
    fp_add(&E, &E, &A);                 /* 3A */
    fp_sqr(&F, &E);
    fp_sub(&t0, &F, &D);
    fp_sub(&r->X, &t0, &D);             /* F − 2D */
    fp_sub(&t0, &D, &r->X);
    fp_mul(&t0, &E, &t0);
    fp_add(&t1, &C, &C);
    fp_add(&t1, &t1, &t1);
    fp_add(&t1, &t1, &t1);              /* 8C */
    fp_mul(&C, &p->Y, &p->Z);
    fp_sub(&r->Y, &t0, &t1);
    fp_add(&r->Z, &C, &C);              /* 2YZ */
}

/* mixed addition r = p + (x2, y2) affine (madd-2007-bl) */
static void g1j_madd(g1j *r, const g1j *p, const fp *x2, const fp *y2) {
    if (fp_is_zero(&p->Z)) {
        r->X = *x2; r->Y = *y2;
        memcpy(r->Z.l, ONE_M, sizeof ONE_M);
        return;
    }
    fp Z1Z1, U2, S2, H, HH, I, J, rr, V, t0, t1;
    fp_sqr(&Z1Z1, &p->Z);
    fp_mul(&U2, x2, &Z1Z1);
    fp_mul(&S2, y2, &p->Z);
    fp_mul(&S2, &S2, &Z1Z1);
    fp_sub(&H, &U2, &p->X);
    fp_sub(&t0, &S2, &p->Y);
    if (fp_is_zero(&H)) {
        if (fp_is_zero(&t0)) { g1j_dbl(r, p); return; }
        r->X = FP_ZERO; r->Y = FP_ZERO; r->Z = FP_ZERO;  /* infinity */
        return;
    }
    fp_sqr(&HH, &H);
    fp_add(&I, &HH, &HH);
    fp_add(&I, &I, &I);                 /* 4HH */
    fp_mul(&J, &H, &I);
    fp_add(&rr, &t0, &t0);              /* 2(S2−Y1) */
    fp_mul(&V, &p->X, &I);
    fp_sqr(&t0, &rr);
    fp_sub(&t0, &t0, &J);
    fp_sub(&t0, &t0, &V);
    fp_sub(&r->X, &t0, &V);             /* rr²−J−2V */
    fp_sub(&t0, &V, &r->X);
    fp_mul(&t0, &rr, &t0);
    fp_mul(&t1, &p->Y, &J);
    fp_add(&t1, &t1, &t1);
    fp_sub(&r->Y, &t0, &t1);            /* rr(V−X3)−2Y1J */
    fp_add(&t0, &p->Z, &H);
    fp_sqr(&t0, &t0);
    fp_sub(&t0, &t0, &Z1Z1);
    fp_sub(&r->Z, &t0, &HH);            /* (Z1+H)²−Z1Z1−HH */
}

static void g1_mul_scalar(g1 *r, const g1 *p, const u8 *k32) {
    if (p->inf) { *r = *p; return; }
    g1j acc = {FP_ZERO, FP_ZERO, FP_ZERO};
    int started = 0;
    for (int i = 0; i < 32; i++) {       /* big-endian, MSB first */
        for (int b = 7; b >= 0; b--) {
            if (started) g1j_dbl(&acc, &acc);
            if ((k32[i] >> b) & 1) {
                g1j_madd(&acc, &acc, &p->x, &p->y);
                started = 1;
            }
        }
    }
    if (!started || fp_is_zero(&acc.Z)) {
        r->inf = 1; r->x = FP_ZERO; r->y = FP_ZERO;
        return;
    }
    fp zi, zi2, zi3;
    fp_inv(&zi, &acc.Z);
    fp_sqr(&zi2, &zi);
    fp_mul(&zi3, &zi2, &zi);
    fp_mul(&r->x, &acc.X, &zi2);
    fp_mul(&r->y, &acc.Y, &zi3);
    r->inf = 0;
}

static void g2_add_aff(g2 *r, const g2 *p, const g2 *q) {
    if (p->inf) { *r = *q; return; }
    if (q->inf) { *r = *p; return; }
    fp2 lam, t0, t1;
    if (fp2_eq(&p->x, &q->x)) {
        fp2 ysum;
        fp2_add(&ysum, &p->y, &q->y);
        if (fp2_is_zero(&ysum)) { memset(r, 0, sizeof *r); r->inf = 1; return; }
        fp2_sqr(&t0, &p->x);
        fp2_add(&t1, &t0, &t0);
        fp2_add(&t0, &t1, &t0);
        fp2_add(&t1, &p->y, &p->y);
        fp2_inv(&t1, &t1);
        fp2_mul(&lam, &t0, &t1);
    } else {
        fp2_sub(&t0, &q->y, &p->y);
        fp2_sub(&t1, &q->x, &p->x);
        fp2_inv(&t1, &t1);
        fp2_mul(&lam, &t0, &t1);
    }
    fp2 x3, y3;
    fp2_sqr(&x3, &lam);
    fp2_sub(&x3, &x3, &p->x);
    fp2_sub(&x3, &x3, &q->x);
    fp2_sub(&t0, &p->x, &x3);
    fp2_mul(&y3, &lam, &t0);
    fp2_sub(&y3, &y3, &p->y);
    r->x = x3; r->y = y3; r->inf = 0;
}

typedef struct { fp2 X, Y, Z; } g2j;

static void g2j_dbl(g2j *r, const g2j *p) {
    if (fp2_is_zero(&p->Z)) { *r = *p; return; }
    fp2 A, B, C, D, E, F, t0, t1;
    fp2_sqr(&A, &p->X);
    fp2_sqr(&B, &p->Y);
    fp2_sqr(&C, &B);
    fp2_add(&t0, &p->X, &B);
    fp2_sqr(&t0, &t0);
    fp2_sub(&t0, &t0, &A);
    fp2_sub(&t0, &t0, &C);
    fp2_add(&D, &t0, &t0);
    fp2_add(&E, &A, &A);
    fp2_add(&E, &E, &A);
    fp2_sqr(&F, &E);
    fp2_sub(&t0, &F, &D);
    fp2_sub(&r->X, &t0, &D);
    fp2_sub(&t0, &D, &r->X);
    fp2_mul(&t0, &E, &t0);
    fp2_add(&t1, &C, &C);
    fp2_add(&t1, &t1, &t1);
    fp2_add(&t1, &t1, &t1);
    fp2_mul(&C, &p->Y, &p->Z);
    fp2_sub(&r->Y, &t0, &t1);
    fp2_add(&r->Z, &C, &C);
}

static void g2j_madd(g2j *r, const g2j *p, const fp2 *x2, const fp2 *y2) {
    if (fp2_is_zero(&p->Z)) {
        r->X = *x2; r->Y = *y2;
        memset(&r->Z, 0, sizeof r->Z);
        memcpy(r->Z.c0.l, ONE_M, sizeof ONE_M);
        return;
    }
    fp2 Z1Z1, U2, S2, H, HH, I, J, rr, V, t0, t1;
    fp2_sqr(&Z1Z1, &p->Z);
    fp2_mul(&U2, x2, &Z1Z1);
    fp2_mul(&S2, y2, &p->Z);
    fp2_mul(&S2, &S2, &Z1Z1);
    fp2_sub(&H, &U2, &p->X);
    fp2_sub(&t0, &S2, &p->Y);
    if (fp2_is_zero(&H)) {
        if (fp2_is_zero(&t0)) { g2j_dbl(r, p); return; }
        memset(r, 0, sizeof *r);
        return;
    }
    fp2_sqr(&HH, &H);
    fp2_add(&I, &HH, &HH);
    fp2_add(&I, &I, &I);
    fp2_mul(&J, &H, &I);
    fp2_add(&rr, &t0, &t0);
    fp2_mul(&V, &p->X, &I);
    fp2_sqr(&t0, &rr);
    fp2_sub(&t0, &t0, &J);
    fp2_sub(&t0, &t0, &V);
    fp2_sub(&r->X, &t0, &V);
    fp2_sub(&t0, &V, &r->X);
    fp2_mul(&t0, &rr, &t0);
    fp2_mul(&t1, &p->Y, &J);
    fp2_add(&t1, &t1, &t1);
    fp2_sub(&r->Y, &t0, &t1);
    fp2_add(&t0, &p->Z, &H);
    fp2_sqr(&t0, &t0);
    fp2_sub(&t0, &t0, &Z1Z1);
    fp2_sub(&r->Z, &t0, &HH);
}

static void g2_mul_scalar(g2 *r, const g2 *p, const u8 *k32) {
    if (p->inf) { *r = *p; return; }
    g2j acc;
    memset(&acc, 0, sizeof acc);
    int started = 0;
    for (int i = 0; i < 32; i++) {
        for (int b = 7; b >= 0; b--) {
            if (started) g2j_dbl(&acc, &acc);
            if ((k32[i] >> b) & 1) {
                g2j_madd(&acc, &acc, &p->x, &p->y);
                started = 1;
            }
        }
    }
    if (!started || fp2_is_zero(&acc.Z)) {
        memset(r, 0, sizeof *r);
        r->inf = 1;
        return;
    }
    fp2 zi, zi2, zi3;
    fp2_inv(&zi, &acc.Z);
    fp2_sqr(&zi2, &zi);
    fp2_mul(&zi3, &zi2, &zi);
    fp2_mul(&r->x, &acc.X, &zi2);
    fp2_mul(&r->y, &acc.Y, &zi3);
    r->inf = 0;
}

/* ------------------------------------------------------------ pairing */

/* Optimized ate Miller loop: T stays PROJECTIVE in Fp2 on the twist (no
 * inversions in the loop — the old affine-in-fp12 version paid one
 * ext-gcd fp12 inversion per step), line evaluations are sparse fp12
 * elements multiplied in via mul_by_014 (~1/4 of a full fp12_mul).
 * Doubling/addition step formulas: eprint 2010/354 Alg 26/27 (the
 * zkcrypto/blst lineage for this exact curve/tower). Per-step values
 * differ from the Python reference's affine loop by subfield
 * normalization factors, which VANISH in the final exponentiation —
 * so pairing outputs after final_exp are bit-identical to
 * crypto/bls12_381.py (asserted by tests/test_bls_native.py). */

/* fp6 sparse: self * (c0 + c1 v) */
static void fp6_mul_by_01(fp6 *r, const fp6 *s, const fp2 *c0,
                          const fp2 *c1) {
    fp2 a_a, b_b, t1, t2, t3, u;
    fp2_mul(&a_a, &s->c0, c0);
    fp2_mul(&b_b, &s->c1, c1);
    fp2_add(&u, &s->c1, &s->c2);
    fp2_mul(&t1, &u, c1);
    fp2_sub(&t1, &t1, &b_b);
    fp2_mul_nonres(&t1, &t1);
    fp2_add(&t1, &t1, &a_a);            /* c0 s0 + ξ c1 s2 */
    fp2_add(&u, c0, c1);
    fp2_add(&t2, &s->c0, &s->c1);
    fp2_mul(&t2, &t2, &u);
    fp2_sub(&t2, &t2, &a_a);
    fp2_sub(&t2, &t2, &b_b);            /* c0 s1 + c1 s0 */
    fp2_mul(&t3, &s->c2, c0);
    fp2_add(&t3, &t3, &b_b);            /* c0 s2 + c1 s1 */
    r->c0 = t1; r->c1 = t2; r->c2 = t3;
}

/* fp6 sparse: self * (c1 v) */
static void fp6_mul_by_1(fp6 *r, const fp6 *s, const fp2 *c1) {
    fp2 t0, t1, t2;
    fp2_mul(&t0, &s->c2, c1);
    fp2_mul_nonres(&t0, &t0);
    fp2_mul(&t1, &s->c0, c1);
    fp2_mul(&t2, &s->c1, c1);
    r->c0 = t0; r->c1 = t1; r->c2 = t2;
}

/* f *= (c0 + c1 v) + (c4 v) w — the shape of an M-twist line */
static void fp12_mul_by_014(fp12 *f, const fp2 *c0, const fp2 *c1,
                            const fp2 *c4) {
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

typedef struct { fp2 X, Y, Z; } g2p;

/* eprint 2010/354 Alg 26: projective doubling + tangent-line coeffs */
static void miller_dbl(g2p *r, fp2 *l0, fp2 *l1, fp2 *l4) {
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
    *l0 = tmp0; *l1 = tmp3; *l4 = tmp6;
}

/* eprint 2010/354 Alg 27: mixed addition + secant-line coeffs */
static void miller_add(g2p *r, const g2 *q, fp2 *l0, fp2 *l1, fp2 *l4) {
    fp2 zsq, ysq, t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, ztsq, t;
    fp2_sqr(&zsq, &r->Z);
    fp2_sqr(&ysq, &q->y);
    fp2_mul(&t0, &zsq, &q->x);
    fp2_add(&t, &q->y, &r->Z);
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
    fp2_mul(&t9, &t6, &q->x);
    fp2_mul(&t7, &t4, &r->X);
    fp2_sqr(&r->X, &t6);
    fp2_sub(&r->X, &r->X, &t5);
    fp2_sub(&r->X, &r->X, &t7);
    fp2_sub(&r->X, &r->X, &t7);
    fp2_add(&t, &r->Z, &t2);
    fp2_sqr(&t, &t);
    fp2_sub(&t, &t, &zsq);
    fp2_sub(&r->Z, &t, &t3);
    fp2_add(&t10, &q->y, &r->Z);
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
    *l0 = t10; *l1 = t1; *l4 = t9;
}

/* line eval at P + sparse accumulate: f *= l4 + (l1·xp) v + (l0·yp) v w */
static void miller_ell(fp12 *f, const fp2 *l0, const fp2 *l1,
                       const fp2 *l4, const g1 *p) {
    fp2 c0, c1;
    fp2_mul_fp(&c0, l0, &p->y);
    fp2_mul_fp(&c1, l1, &p->x);
    fp12_mul_by_014(f, l4, &c1, &c0);
}

static void miller(fp12 *f, const g1 *p, const g2 *q) {
    fp12_one(f);
    if (p->inf || q->inf) return;
    g2p r;
    r.X = q->x;
    r.Y = q->y;
    memset(&r.Z, 0, sizeof r.Z);
    memcpy(r.Z.c0.l, ONE_M, sizeof ONE_M);
    fp2 l0, l1, l4;
    int started = 0;
    for (int b = 63; b >= 0; b--) {
        if (!started) {
            if ((X_ABS >> b) & 1) started = 1;  /* skip leading bit */
            continue;
        }
        fp12_sqr(f, f);
        miller_dbl(&r, &l0, &l1, &l4);
        miller_ell(f, &l0, &l1, &l4, p);
        if ((X_ABS >> b) & 1) {
            miller_add(&r, q, &l0, &l1, &l4);
            miller_ell(f, &l0, &l1, &l4, p);
        }
    }
    /* x < 0: f = conj(f) */
    fp12_conj(f, f);
}


/* final exponentiation: f^(3·(q^4-q^2+1)/r) via HHT:
 * (x-1)^2 (x+q) (x^2+q^2-1) + 3, x = -X_ABS */
/* Granger-Scott cyclotomic squaring (valid once in the cyclotomic
 * subgroup, i.e. after the easy part of final exp): 3 "fp4 squarings"
 * ≈ 9 fp2 mults vs fp12_sqr's ~24 */
static void fp4_sqr_parts(fp2 *c0, fp2 *c1, const fp2 *a, const fp2 *b) {
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

static void fp12_cyc_sqr(fp12 *r, const fp12 *f) {
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

/* pow within the cyclotomic subgroup (hard part of final exp) */
static void fp12_pow_u64_cyc(fp12 *r, const fp12 *a, u64 e) {
    fp12 acc;
    fp12_one(&acc);
    int started = 0;
    for (int b = 63; b >= 0; b--) {
        if (started) fp12_cyc_sqr(&acc, &acc);
        if ((e >> b) & 1) {
            if (!started) { acc = *a; started = 1; }
            else fp12_mul(&acc, &acc, a);
        }
    }
    if (!started) fp12_one(&acc);
    *r = acc;
}

static void fp12_pow_x_cyc(fp12 *r, const fp12 *a) {
    fp12 t;
    fp12_pow_u64_cyc(&t, a, X_ABS);
    fp12_conj(r, &t);
}

static void final_exp(fp12 *r, const fp12 *f) {
    frob_init();
    fp12 t0, t1, m;
    /* easy: f^(q^6-1) = conj(f) * f^-1 ; then ^(q^2+1) */
    fp12_conj(&t0, f);
    fp12_inv(&t1, f);
    fp12_mul(&m, &t0, &t1);
    fp12_frob(&t0, &m);
    fp12_frob(&t0, &t0);
    fp12_mul(&m, &t0, &m);         /* m = f^((q^6-1)(q^2+1)) */

    /* hard: m^((x-1)^2 (x+q) (x^2+q^2-1)) * m^3 — all exponentiations
     * run in the cyclotomic subgroup (Granger-Scott squarings) */
    fp12 a, b, c;
    /* a = m^(x-1); x-1 = -(X_ABS+1) → pow by X_ABS+1 then conj */
    fp12_pow_u64_cyc(&a, &m, X_ABS + 1);
    fp12_conj(&a, &a);
    fp12_pow_u64_cyc(&t0, &a, X_ABS + 1);
    fp12_conj(&a, &t0);            /* a = m^((x-1)^2) (sign squares away:
                                      (-(X+1))² = (X+1)² — conj twice = id,
                                      so conj applied twice is identity;
                                      keep both conjs for clarity) */
    /* b = a^(x+q) = a^x * frob(a) */
    fp12_pow_x_cyc(&t0, &a);
    fp12_frob(&t1, &a);
    fp12_mul(&b, &t0, &t1);
    /* c = b^(x²+q²-1) = (b^x)^x * frob²(b) * conj(b) */
    fp12_pow_x_cyc(&t0, &b);
    fp12_pow_x_cyc(&t0, &t0);
    fp12_frob(&t1, &b);
    fp12_frob(&t1, &t1);
    fp12_mul(&c, &t0, &t1);
    fp12_conj(&t0, &b);
    fp12_mul(&c, &c, &t0);
    /* result = c * m² * m */
    fp12_cyc_sqr(&t0, &m);
    fp12_mul(&t0, &t0, &m);
    fp12_mul(r, &c, &t0);
}

/* fp pow by big-endian bytes (for sqrt) */
static void fp_pow_bytes(fp *r, const fp *a, const u8 *e, int elen) {
    fp acc;
    memcpy(acc.l, ONE_M, sizeof ONE_M);
    for (int i = 0; i < elen; i++) {
        for (int b = 7; b >= 0; b--) {
            fp_sqr(&acc, &acc);
            if ((e[i] >> b) & 1) fp_mul(&acc, &acc, a);
        }
    }
    *r = acc;
}

/* ---------------------------------------------------------------- ABI */

static void g1_from_bytes(g1 *r, const u8 *in96) {
    int zero = 1;
    for (int i = 0; i < 96; i++) if (in96[i]) { zero = 0; break; }
    if (zero) { r->x = FP_ZERO; r->y = FP_ZERO; r->inf = 1; return; }
    fp_from_bytes(&r->x, in96);
    fp_from_bytes(&r->y, in96 + 48);
    r->inf = 0;
}

static void g1_to_bytes(u8 *out96, const g1 *p) {
    if (p->inf) { memset(out96, 0, 96); return; }
    fp_to_bytes(out96, &p->x);
    fp_to_bytes(out96 + 48, &p->y);
}

static void g2_from_bytes(g2 *r, const u8 *in192) {
    int zero = 1;
    for (int i = 0; i < 192; i++) if (in192[i]) { zero = 0; break; }
    if (zero) { memset(r, 0, sizeof *r); r->inf = 1; return; }
    fp_from_bytes(&r->x.c0, in192);
    fp_from_bytes(&r->x.c1, in192 + 48);
    fp_from_bytes(&r->y.c0, in192 + 96);
    fp_from_bytes(&r->y.c1, in192 + 144);
    r->inf = 0;
}

static void g2_to_bytes(u8 *out192, const g2 *p) {
    if (p->inf) { memset(out192, 0, 192); return; }
    fp_to_bytes(out192, &p->x.c0);
    fp_to_bytes(out192 + 48, &p->x.c1);
    fp_to_bytes(out192 + 96, &p->y.c0);
    fp_to_bytes(out192 + 144, &p->y.c1);
}

void b_g1_add(const u8 *a, const u8 *b, u8 *out) {
    g1 p, q, r;
    g1_from_bytes(&p, a);
    g1_from_bytes(&q, b);
    g1_add_aff(&r, &p, &q);
    g1_to_bytes(out, &r);
}

void b_g1_mul(const u8 *p96, const u8 *k32, u8 *out) {
    g1 p, r;
    g1_from_bytes(&p, p96);
    g1_mul_scalar(&r, &p, k32);
    g1_to_bytes(out, &r);
}

void b_g2_add(const u8 *a, const u8 *b, u8 *out) {
    g2 p, q, r;
    g2_from_bytes(&p, a);
    g2_from_bytes(&q, b);
    g2_add_aff(&r, &p, &q);
    g2_to_bytes(out, &r);
}

void b_g2_mul(const u8 *p192, const u8 *k32, u8 *out) {
    g2 p, r;
    g2_from_bytes(&p, p192);
    g2_mul_scalar(&r, &p, k32);
    g2_to_bytes(out, &r);
}

/* ZCash-compressed G1 (48 B) → affine 96 B. Returns 0 ok, 1 infinity,
 * -1 invalid. Must match crypto/bls12_381.py g1_decompress exactly. */
int b_g1_decompress(const u8 *in48, u8 *out96) {
    u8 flags = in48[0];
    if (!(flags & 0x80)) return -1;
    if (flags & 0x40) {
        if (in48[0] != 0xC0) return -1;
        for (int i = 1; i < 48; i++) if (in48[i]) return -1;
        memset(out96, 0, 96);
        return 1;
    }
    u8 xb[48];
    memcpy(xb, in48, 48);
    xb[0] &= 0x1F;
    /* x < q? compare big-endian bytes against q */
    static const u8 QB[48] = {
        0x1a, 0x01, 0x11, 0xea, 0x39, 0x7f, 0xe6, 0x9a, 0x4b, 0x1b, 0xa7,
        0xb6, 0x43, 0x4b, 0xac, 0xd7, 0x64, 0x77, 0x4b, 0x84, 0xf3, 0x85,
        0x12, 0xbf, 0x67, 0x30, 0xd2, 0xa0, 0xf6, 0xb0, 0xf6, 0x24, 0x1e,
        0xab, 0xff, 0xfe, 0xb1, 0x53, 0xff, 0xff, 0xb9, 0xfe, 0xff, 0xff,
        0xff, 0xff, 0xaa, 0xab};
    int lt = 0;
    for (int i = 0; i < 48; i++) {
        if (xb[i] < QB[i]) { lt = 1; break; }
        if (xb[i] > QB[i]) { lt = 0; break; }
    }
    if (!lt) return -1;
    fp x, yy, y, t;
    fp_from_bytes(&x, xb);
    fp_sqr(&yy, &x);
    fp_mul(&yy, &yy, &x);
    fp four;
    memcpy(four.l, ONE_M, sizeof ONE_M);
    fp_add(&four, &four, &four);
    fp_add(&four, &four, &four);
    fp_add(&yy, &yy, &four);            /* x^3 + 4 */
    /* y = yy^((q+1)/4); (q+1)/4 as bytes: q+1 then >>2 */
    u64 qp1[NL];
    memcpy(qp1, Qm, sizeof Qm);
    qp1[0] += 1;                        /* no carry: low limb < 2^64-1 */
    for (int i = 0; i < NL - 1; i++)
        qp1[i] = (qp1[i] >> 2) | (qp1[i + 1] << 62);
    qp1[NL - 1] >>= 2;
    u8 e[48];
    for (int i = 0; i < NL; i++) {
        u64 v = qp1[NL - 1 - i];
        for (int j = 0; j < 8; j++)
            e[i * 8 + j] = (u8)(v >> (56 - 8 * j));
    }
    fp_pow_bytes(&y, &yy, e, 48);
    fp_sqr(&t, &y);
    if (!fp_eq(&t, &yy)) return -1;     /* not on curve */
    /* sign: y > (q-1)/2 ⇔ raw(y) > (q-1)/2 */
    u8 yb[48];
    fp_to_bytes(yb, &y);
    static const u8 QH[48] = {          /* (q-1)/2 big-endian */
        0x0d, 0x00, 0x88, 0xf5, 0x1c, 0xbf, 0xf3, 0x4d, 0x25, 0x8d, 0xd3,
        0xdb, 0x21, 0xa5, 0xd6, 0x6b, 0xb2, 0x3b, 0xa5, 0xc2, 0x79, 0xc2,
        0x89, 0x5f, 0xb3, 0x98, 0x69, 0x50, 0x7b, 0x58, 0x7b, 0x12, 0x0f,
        0x55, 0xff, 0xff, 0x58, 0xa9, 0xff, 0xff, 0xdc, 0xff, 0x7f, 0xff,
        0xff, 0xff, 0xd5, 0x55};
    int big = 0;
    for (int i = 0; i < 48; i++) {
        if (yb[i] > QH[i]) { big = 1; break; }
        if (yb[i] < QH[i]) { big = 0; break; }
    }
    int want_big = (flags >> 5) & 1;
    if (big != want_big) fp_neg(&y, &y);
    fp_to_bytes(out96, &x);
    fp_to_bytes(out96 + 48, &y);
    return 0;
}

/* Aggregate n compressed G1 signatures with Jacobian accumulation and a
 * single final inversion — the per-add fp_inv in g1_add_aff is what
 * made scalar aggregation pay ~an inversion per share. Returns 0 ok,
 * -1 if any share is invalid. out96 = affine x||y (zeros = infinity).
 * Reference: create_multi_sig in
 * crypto/bls/indy_crypto/bls_crypto_indy_crypto.py:99. */
int b_g1_aggregate(int n, const u8 *sigs48, u8 *out96) {
    g1j acc = {FP_ZERO, FP_ZERO, FP_ZERO};
    u8 tmp[96];
    for (int i = 0; i < n; i++) {
        int rc = b_g1_decompress(sigs48 + (size_t)i * 48, tmp);
        if (rc < 0) return -1;
        if (rc == 1) continue;          /* infinity share */
        fp x, y;
        fp_from_bytes(&x, tmp);
        fp_from_bytes(&y, tmp + 48);
        g1j_madd(&acc, &acc, &x, &y);
    }
    if (fp_is_zero(&acc.Z)) { memset(out96, 0, 96); return 0; }
    fp zi, zi2, zi3, x, y;
    fp_inv(&zi, &acc.Z);
    fp_sqr(&zi2, &zi);
    fp_mul(&zi3, &zi2, &zi);
    fp_mul(&x, &acc.X, &zi2);
    fp_mul(&y, &acc.Y, &zi3);
    fp_to_bytes(out96, &x);
    fp_to_bytes(out96 + 48, &y);
    return 0;
}

/* Aggregate n AFFINE points (96-byte x||y each, zeros = infinity) with
 * Jacobian accumulation and one final inversion. The consensus path
 * decompresses each share once at COMMIT-validation time; ordering then
 * aggregates the cached points here without paying the per-share sqrt
 * again. out96 = affine x||y (zeros = infinity). */
void b_g1_aggregate_affine(int n, const u8 *pts96, u8 *out96) {
    g1j acc = {FP_ZERO, FP_ZERO, FP_ZERO};
    for (int i = 0; i < n; i++) {
        g1 p;
        g1_from_bytes(&p, pts96 + (size_t)i * 96);
        if (p.inf) continue;
        g1j_madd(&acc, &acc, &p.x, &p.y);
    }
    if (fp_is_zero(&acc.Z)) { memset(out96, 0, 96); return; }
    fp zi, zi2, zi3, x, y;
    fp_inv(&zi, &acc.Z);
    fp_sqr(&zi2, &zi);
    fp_mul(&zi3, &zi2, &zi);
    fp_mul(&x, &acc.X, &zi2);
    fp_mul(&y, &acc.Y, &zi3);
    fp_to_bytes(out96, &x);
    fp_to_bytes(out96 + 48, &y);
}

/* ∏ e(P_i, Q_i) == 1 ? (one shared final exponentiation) */
/* ------------------------------------------------------------------ */
/* SHA-256 (FIPS 180-4) — needed by the hash-to-curve construction,    */
/* which must be bit-identical to crypto/bls12_381.py hash_to_g1       */
/* ------------------------------------------------------------------ */

typedef uint32_t u32;
typedef struct { u32 h[8]; u64 len; u8 buf[64]; size_t buflen; } sha_ctx;

static const u32 SK256[64] = {
    0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,
    0x923f82a4,0xab1c5ed5,0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,
    0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,0xe49b69c1,0xefbe4786,
    0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
    0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,
    0x06ca6351,0x14292967,0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,
    0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,0xa2bfe8a1,0xa81a664b,
    0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
    0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,
    0x5b9cca4f,0x682e6ff3,0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,
    0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2
};
#define SROR(x,n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha_init(sha_ctx *c) {
    c->h[0]=0x6a09e667; c->h[1]=0xbb67ae85; c->h[2]=0x3c6ef372;
    c->h[3]=0xa54ff53a; c->h[4]=0x510e527f; c->h[5]=0x9b05688c;
    c->h[6]=0x1f83d9ab; c->h[7]=0x5be0cd19; c->len=0; c->buflen=0;
}

static void sha_block(sha_ctx *c, const u8 *p) {
    u32 w[64], a,b2,cc,d,e,f,g,h2,t1,t2;
    int i;
    for (i = 0; i < 16; i++)
        w[i] = ((u32)p[4*i]<<24)|((u32)p[4*i+1]<<16)
             | ((u32)p[4*i+2]<<8)|(u32)p[4*i+3];
    for (i = 16; i < 64; i++) {
        u32 s0 = SROR(w[i-15],7)^SROR(w[i-15],18)^(w[i-15]>>3);
        u32 s1 = SROR(w[i-2],17)^SROR(w[i-2],19)^(w[i-2]>>10);
        w[i] = w[i-16]+s0+w[i-7]+s1;
    }
    a=c->h[0]; b2=c->h[1]; cc=c->h[2]; d=c->h[3];
    e=c->h[4]; f=c->h[5]; g=c->h[6]; h2=c->h[7];
    for (i = 0; i < 64; i++) {
        u32 S1 = SROR(e,6)^SROR(e,11)^SROR(e,25);
        u32 ch = (e&f)^((~e)&g);
        t1 = h2+S1+ch+SK256[i]+w[i];
        u32 S0 = SROR(a,2)^SROR(a,13)^SROR(a,22);
        u32 mj = (a&b2)^(a&cc)^(b2&cc);
        t2 = S0+mj;
        h2=g; g=f; f=e; e=d+t1; d=cc; cc=b2; b2=a; a=t1+t2;
    }
    c->h[0]+=a; c->h[1]+=b2; c->h[2]+=cc; c->h[3]+=d;
    c->h[4]+=e; c->h[5]+=f; c->h[6]+=g; c->h[7]+=h2;
}

static void sha_update(sha_ctx *c, const u8 *p, size_t n) {
    c->len += n;
    if (c->buflen) {
        size_t take = 64 - c->buflen;
        if (take > n) take = n;
        memcpy(c->buf + c->buflen, p, take);
        c->buflen += take; p += take; n -= take;
        if (c->buflen == 64) { sha_block(c, c->buf); c->buflen = 0; }
    }
    while (n >= 64) { sha_block(c, p); p += 64; n -= 64; }
    if (n) { memcpy(c->buf, p, n); c->buflen = n; }
}

static void sha_final(sha_ctx *c, u8 out[32]) {
    u64 bits = c->len * 8;
    u8 pad = 0x80, z = 0, lb[8];
    int i;
    sha_update(c, &pad, 1);
    while (c->buflen != 56) sha_update(c, &z, 1);
    for (i = 0; i < 8; i++) lb[i] = (u8)(bits >> (56 - 8*i));
    sha_update(c, lb, 8);
    for (i = 0; i < 8; i++) {
        out[4*i]   = (u8)(c->h[i] >> 24);
        out[4*i+1] = (u8)(c->h[i] >> 16);
        out[4*i+2] = (u8)(c->h[i] >> 8);
        out[4*i+3] = (u8)(c->h[i]);
    }
}

/* fixed-exponent Montgomery pow over raw little-endian u64 limbs */
static void fp_pow_limbs(fp *r, const fp *a, const u64 *e, int nlimbs) {
    fp acc;
    int started = 0;
    memcpy(acc.l, ONE_M, sizeof ONE_M);
    for (int i = nlimbs - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) fp_sqr(&acc, &acc);
            if ((e[i] >> b) & 1) {
                if (!started) { acc = *a; started = 1; }
                else fp_mul(&acc, &acc, a);
            }
        }
    }
    *r = acc;
}

/* hash-to-curve: bit-identical to bls12_381.py hash_to_g1 (try-and-
 * increment over SHA-256, sqrt by (Q+1)/4, smaller root, cofactor
 * cleared by (1+X_ABS)^2/3). Returns 0 ok / -1 if the cofactor mul
 * lands at infinity (the Python path retries ctr in that case too). */
int b_hash_to_g1(const u8 *msg, int msg_len, const u8 *dst, int dst_len,
                 u8 *out96) {
    u64 sqrt_e[NL];      /* (Q+1)/4 */
    u8 cof[32];          /* (1+X_ABS)^2 / 3, big-endian 32 bytes */
    {
        /* (Q+1)/4: Q is odd, Q+1 even; shift the raw modulus right 2 */
        u64 t[NL];
        memcpy(t, Qm, sizeof t);
        t[0] += 1;                   /* Q odd => no carry chain needed */
        for (int i = 0; i < NL; i++) {
            u64 lo = t[i] >> 2;
            if (i + 1 < NL) lo |= t[i + 1] << 62;
            sqrt_e[i] = lo;
        }
        /* cofactor (1+X_ABS)^2/3 fits 128 bits */
        unsigned __int128 c = (unsigned __int128)(X_ABS + 1)
            * (X_ABS + 1) / 3;
        memset(cof, 0, sizeof cof);
        for (int i = 0; i < 16; i++)
            cof[31 - i] = (u8)(c >> (8 * i));
    }
    for (u32 ctr = 0; ; ctr++) {
        u8 d1[32], d2[32], xb[48], ctr_be[4];
        sha_ctx c;
        fp x, yy, y, y2, t;
        ctr_be[0] = (u8)(ctr >> 24); ctr_be[1] = (u8)(ctr >> 16);
        ctr_be[2] = (u8)(ctr >> 8); ctr_be[3] = (u8)ctr;
        sha_init(&c);
        sha_update(&c, dst, (size_t)dst_len);
        sha_update(&c, ctr_be, 4);
        sha_update(&c, msg, (size_t)msg_len);
        sha_final(&c, d1);
        sha_init(&c);
        { u8 one = 1; sha_update(&c, &one, 1); }
        sha_update(&c, d1, 32);
        sha_final(&c, d2);
        memcpy(xb, d1, 32);
        memcpy(xb + 32, d2, 16);
        /* 48-byte big-endian value mod Q — raw reduce then Montgomery */
        {
            /* 48-byte value < 2^384; 2^384/Q < 8, so loop-subtract Q
               (tracked with one overflow limb) until below it */
            u64 v[NL + 1];
            memset(v, 0, sizeof v);
            for (int i = 0; i < 48; i++) {
                int limb = (47 - i) / 8, byte = (47 - i) % 8;
                v[limb] |= (u64)xb[i] << (8 * byte);
            }
            for (;;) {
                int ge;
                if (v[NL] != 0) {
                    ge = 1;
                } else {
                    ge = 1;
                    for (int i = NL - 1; i >= 0; i--) {
                        if (v[i] != Qm[i]) { ge = v[i] > Qm[i]; break; }
                    }
                }
                if (!ge) break;
                unsigned __int128 br = 0;
                for (int i = 0; i < NL; i++) {
                    unsigned __int128 dd = (unsigned __int128)v[i]
                        - Qm[i] - br;
                    v[i] = (u64)dd;
                    br = (dd >> 64) & 1;
                }
                v[NL] -= (u64)br;
            }
            u8 canon[48];
            for (int i = 0; i < 48; i++) {
                int limb = (47 - i) / 8, byte = (47 - i) % 8;
                canon[i] = (u8)(v[limb] >> (8 * byte));
            }
            fp_from_bytes(&x, canon);
        }
        /* yy = x^3 + 4 */
        fp_sqr(&t, &x);
        fp_mul(&yy, &t, &x);
        {
            fp four;
            memcpy(four.l, ONE_M, sizeof ONE_M);
            fp_add(&four, &four, &four);
            fp_add(&four, &four, &four);
            fp_add(&yy, &yy, &four);
        }
        fp_pow_limbs(&y, &yy, sqrt_e, NL);
        fp_sqr(&y2, &y);
        if (memcmp(y2.l, yy.l, sizeof yy.l) != 0)
            continue;  /* not a QR: next counter */
        /* smaller of y, Q-y by canonical value */
        {
            u8 yb[48], nyb[48];
            fp ny;
            fp_neg(&ny, &y);
            fp_to_bytes(yb, &y);
            fp_to_bytes(nyb, &ny);
            if (memcmp(nyb, yb, 48) < 0) y = ny;
        }
        {
            g1 p, r;
            p.x = x; p.y = y; p.inf = 0;
            g1_mul_scalar(&r, &p, cof);
            if (r.inf) continue;  /* mirror the Python retry */
            g1_to_bytes(out96, &r);
            return 0;
        }
    }
}

/* ------------------------------------------------------------------ */
/* prepared pairings: precomputed line coefficients for a fixed Q      */
/*                                                                     */
/* A validator verifies every multi-sig against the SAME two G2        */
/* arguments — the group generator and the pool's aggregated key       */
/* (cached per participant set). The Miller doubling/addition chain    */
/* depends only on Q, so its (l0,l1,l4) line coefficients can be       */
/* computed once per Q and replayed: the per-verify loop then costs    */
/* one shared fp12 squaring chain plus sparse line evaluations.        */
/* ------------------------------------------------------------------ */

/* doubling steps (63) + addition steps (popcount(X_ABS)-1) */
#define MILLER_SLOTS 68
/* each slot: 3 fp2 = 6 fp = 36 u64 (Montgomery form, opaque blob) */
#define PREP_SIZE (MILLER_SLOTS * 3 * sizeof(fp2))

int b_prep_size(void) { return (int)PREP_SIZE; }

int b_miller_precompute(const u8 *g2b, u8 *out) {
    g2 q;
    fp2 *slots = (fp2 *)out;
    g2p r;
    int slot = 0;
    g2_from_bytes(&q, g2b);
    if (q.inf) return -1;
    r.X = q.x;
    r.Y = q.y;
    memset(&r.Z, 0, sizeof r.Z);
    memcpy(r.Z.c0.l, ONE_M, sizeof ONE_M);
    {
        int started = 0;
        for (int b = 63; b >= 0; b--) {
            if (!started) {
                if ((X_ABS >> b) & 1) started = 1;
                continue;
            }
            miller_dbl(&r, &slots[slot * 3], &slots[slot * 3 + 1],
                       &slots[slot * 3 + 2]);
            slot++;
            if ((X_ABS >> b) & 1) {
                miller_add(&r, &q, &slots[slot * 3],
                           &slots[slot * 3 + 1], &slots[slot * 3 + 2]);
                slot++;
            }
        }
    }
    return slot == MILLER_SLOTS ? 0 : -1;
}

/* shared-squaring multi-Miller over prepared lines: ONE fp12 squaring
 * chain for all n pairs (the plain path squares per pair), sparse line
 * evaluation per pair per step. preps = n blobs of PREP_SIZE. */
int b_multi_pairing_is_one_prepared(int n, const u8 *g1s,
                                    const u8 *preps) {
    fp12 f;
    g1 ps[8];
    int live[8];
    int slot = 0;
    if (n < 1 || n > 8) return 0;
    for (int i = 0; i < n; i++) {
        g1_from_bytes(&ps[i], g1s + (size_t)i * 96);
        live[i] = !ps[i].inf;
    }
    fp12_one(&f);
    {
        int started = 0;
        for (int b = 63; b >= 0; b--) {
            if (!started) {
                if ((X_ABS >> b) & 1) started = 1;
                continue;
            }
            fp12_sqr(&f, &f);
            for (int i = 0; i < n; i++) {
                const fp2 *ln = (const fp2 *)(preps + (size_t)i * PREP_SIZE)
                    + (size_t)slot * 3;
                if (live[i])
                    miller_ell(&f, &ln[0], &ln[1], &ln[2], &ps[i]);
            }
            slot++;
            if ((X_ABS >> b) & 1) {
                for (int i = 0; i < n; i++) {
                    const fp2 *ln = (const fp2 *)(preps
                        + (size_t)i * PREP_SIZE) + (size_t)slot * 3;
                    if (live[i])
                        miller_ell(&f, &ln[0], &ln[1], &ln[2], &ps[i]);
                }
                slot++;
            }
        }
    }
    /* x < 0: conj, exactly as miller() does */
    fp12_conj(&f, &f);
    final_exp(&f, &f);
    return fp12_is_one(&f);
}

int b_multi_pairing_is_one(int n, const u8 *g1s, const u8 *g2s) {
    fp12 acc, fi;
    fp12_one(&acc);
    for (int i = 0; i < n; i++) {
        g1 p;
        g2 q;
        g1_from_bytes(&p, g1s + (size_t)i * 96);
        g2_from_bytes(&q, g2s + (size_t)i * 192);
        miller(&fi, &p, &q);
        fp12_mul(&acc, &acc, &fi);
    }
    final_exp(&acc, &acc);
    return fp12_is_one(&acc);
}

/* raw pairing output (final-exponentiated, cube-power convention),
 * serialized as 12×48 bytes — for cross-checking/testing only */
void b_pairing(const u8 *g1b, const u8 *g2b, u8 *out576) {
    g1 p;
    g2 q;
    fp12 f;
    g1_from_bytes(&p, g1b);
    g2_from_bytes(&q, g2b);
    miller(&f, &p, &q);
    final_exp(&f, &f);
    const fp *coeffs[12] = {
        &f.c0.c0.c0, &f.c0.c0.c1, &f.c0.c1.c0, &f.c0.c1.c1,
        &f.c0.c2.c0, &f.c0.c2.c1, &f.c1.c0.c0, &f.c1.c0.c1,
        &f.c1.c1.c0, &f.c1.c1.c1, &f.c1.c2.c0, &f.c1.c2.c1};
    for (int i = 0; i < 12; i++)
        fp_to_bytes(out576 + i * 48, coeffs[i]);
}
