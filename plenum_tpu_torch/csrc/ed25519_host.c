/* ed25519 (RFC 8032) verification of one signature on the host: the
 * propagate gate's and the "cpu" provider's check, crypto/ed25519.py::verify.
 *
 * Fills the role OpenSSL and libsodium play for the reference (its
 * ScalarVerifier runs `cryptography`'s Ed25519): a node verifies each
 * request its peers relay before its own client's copy arrives, one at a
 * time on its prod loop. Python hashes (SHA-512 of R || A || M, reduced
 * mod L) and checks S < L; this file decodes A and R and tests
 * [S]B == R + [k]A, cofactorless, by the same rules as the Python version,
 * which stays as the fallback when no C compiler is available and as the
 * reference the tests hold this file against:
 *  - a point's y must be canonical (y < p), (y^2 - 1) / (d y^2 + 1) a
 *    square, and x = 0 must not come with the sign bit set;
 *  - the two sides are compared projectively (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1).
 * Field elements are five 51-bit limbs; points are extended twisted Edwards
 * coordinates with the Python version's addition and doubling formulas.
 * Nothing here is constant time: every input is public.
 */
#include <stdint.h>
#include <string.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef struct { u64 v[5]; } fe;
typedef struct { fe x, y, z, t; } pt;

#define M51 ((1ULL << 51) - 1)

static const uint8_t D_BYTES[32] = {
    0xa3, 0x78, 0x59, 0x13, 0xca, 0x4d, 0xeb, 0x75, 0xab, 0xd8, 0x41, 0x41,
    0x4d, 0x0a, 0x70, 0x00, 0x98, 0xe8, 0x79, 0x77, 0x79, 0x40, 0xc7, 0x8c,
    0x73, 0xfe, 0x6f, 0x2b, 0xee, 0x6c, 0x03, 0x52};
static const uint8_t D2_BYTES[32] = {
    0x59, 0xf1, 0xb2, 0x26, 0x94, 0x9b, 0xd6, 0xeb, 0x56, 0xb1, 0x83, 0x82,
    0x9a, 0x14, 0xe0, 0x00, 0x30, 0xd1, 0xf3, 0xee, 0xf2, 0x80, 0x8e, 0x19,
    0xe7, 0xfc, 0xdf, 0x56, 0xdc, 0xd9, 0x06, 0x24};
static const uint8_t SQRTM1_BYTES[32] = {
    0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4, 0x78, 0xe4, 0x2f, 0xad,
    0x06, 0x18, 0x43, 0x2f, 0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00, 0x4d, 0x2b,
    0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b};
static const uint8_t GX_BYTES[32] = {
    0x1a, 0xd5, 0x25, 0x8f, 0x60, 0x2d, 0x56, 0xc9, 0xb2, 0xa7, 0x25, 0x95,
    0x60, 0xc7, 0x2c, 0x69, 0x5c, 0xdc, 0xd6, 0xfd, 0x31, 0xe2, 0xa4, 0xc0,
    0xfe, 0x53, 0x6e, 0xcd, 0xd3, 0x36, 0x69, 0x21};
static const uint8_t GY_BYTES[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66};

static u64 load64_le(const uint8_t *p) {
    u64 r = 0;
    for (int i = 7; i >= 0; i--) r = (r << 8) | p[i];
    return r;
}

static void store64_le(uint8_t *p, u64 x) {
    for (int i = 0; i < 8; i++) p[i] = (uint8_t)(x >> (8 * i));
}

/* the low 255 bits of s (bit 255 is the caller's) */
static void fe_frombytes(fe *h, const uint8_t *s) {
    u64 t0 = load64_le(s), t1 = load64_le(s + 8), t2 = load64_le(s + 16),
        t3 = load64_le(s + 24);
    h->v[0] = t0 & M51;
    h->v[1] = ((t0 >> 51) | (t1 << 13)) & M51;
    h->v[2] = ((t1 >> 38) | (t2 << 26)) & M51;
    h->v[3] = ((t2 >> 25) | (t3 << 39)) & M51;
    h->v[4] = (t3 >> 12) & M51;
}

/* limbs below 2^51 + 2^18 after one pass, from limbs below 2^63 */
static void fe_carry(fe *h) {
    u64 c;
    for (int i = 0; i < 4; i++) {
        c = h->v[i] >> 51;
        h->v[i] &= M51;
        h->v[i + 1] += c;
    }
    c = h->v[4] >> 51;
    h->v[4] &= M51;
    h->v[0] += 19 * c;
}

/* the canonical 32 bytes of h mod p (bit 255 clear) */
static void fe_tobytes(uint8_t *s, const fe *h) {
    fe t = *h;
    fe_carry(&t);
    fe_carry(&t);
    u64 q = (t.v[0] + 19) >> 51;
    for (int i = 1; i < 5; i++) q = (t.v[i] + q) >> 51;
    t.v[0] += 19 * q;
    for (int i = 0; i < 4; i++) {
        t.v[i + 1] += t.v[i] >> 51;
        t.v[i] &= M51;
    }
    t.v[4] &= M51;
    store64_le(s, t.v[0] | (t.v[1] << 51));
    store64_le(s + 8, (t.v[1] >> 13) | (t.v[2] << 38));
    store64_le(s + 16, (t.v[2] >> 26) | (t.v[3] << 25));
    store64_le(s + 24, (t.v[3] >> 39) | (t.v[4] << 12));
}

static void fe_add(fe *h, const fe *f, const fe *g) {
    for (int i = 0; i < 5; i++) h->v[i] = f->v[i] + g->v[i];
    fe_carry(h);
}

/* f - g + 4p, so that no limb goes below zero */
static void fe_sub(fe *h, const fe *f, const fe *g) {
    h->v[0] = f->v[0] + 0x1FFFFFFFFFFFB4ULL - g->v[0];
    for (int i = 1; i < 5; i++)
        h->v[i] = f->v[i] + 0x1FFFFFFFFFFFFCULL - g->v[i];
    fe_carry(h);
}

static void fe_mul(fe *h, const fe *f, const fe *g) {
    u64 f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3], f4 = f->v[4];
    u64 g0 = g->v[0], g1 = g->v[1], g2 = g->v[2], g3 = g->v[3], g4 = g->v[4];
    u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
    u128 r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19
        + (u128)f3 * g2_19 + (u128)f4 * g1_19;
    u128 r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19
        + (u128)f3 * g3_19 + (u128)f4 * g2_19;
    u128 r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0
        + (u128)f3 * g4_19 + (u128)f4 * g3_19;
    u128 r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1
        + (u128)f3 * g0 + (u128)f4 * g4_19;
    u128 r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2
        + (u128)f3 * g1 + (u128)f4 * g0;
    r1 += (u64)(r0 >> 51);
    r2 += (u64)(r1 >> 51);
    r3 += (u64)(r2 >> 51);
    r4 += (u64)(r3 >> 51);
    u64 c = (u64)(r4 >> 51);
    h->v[0] = ((u64)r0 & M51) + 19 * c;
    h->v[1] = (u64)r1 & M51;
    h->v[2] = (u64)r2 & M51;
    h->v[3] = (u64)r3 & M51;
    h->v[4] = (u64)r4 & M51;
    fe_carry(h);
}

static void fe_sqn(fe *h, const fe *f, int n) {
    fe_mul(h, f, f);
    for (int i = 1; i < n; i++) fe_mul(h, h, h);
}

/* z^((p - 5) / 8) = z^(2^252 - 3) */
static void fe_pow22523(fe *out, const fe *z) {
    fe t0, t1, t2;
    fe_sqn(&t0, z, 1);
    fe_sqn(&t1, &t0, 2);
    fe_mul(&t1, z, &t1);
    fe_mul(&t0, &t0, &t1);
    fe_sqn(&t0, &t0, 1);
    fe_mul(&t0, &t1, &t0);          /* 2^5 - 1 */
    fe_sqn(&t1, &t0, 5);
    fe_mul(&t0, &t1, &t0);          /* 2^10 - 1 */
    fe_sqn(&t1, &t0, 10);
    fe_mul(&t1, &t1, &t0);          /* 2^20 - 1 */
    fe_sqn(&t2, &t1, 20);
    fe_mul(&t1, &t2, &t1);          /* 2^40 - 1 */
    fe_sqn(&t1, &t1, 10);
    fe_mul(&t0, &t1, &t0);          /* 2^50 - 1 */
    fe_sqn(&t1, &t0, 50);
    fe_mul(&t1, &t1, &t0);          /* 2^100 - 1 */
    fe_sqn(&t2, &t1, 100);
    fe_mul(&t1, &t2, &t1);          /* 2^200 - 1 */
    fe_sqn(&t1, &t1, 50);
    fe_mul(&t0, &t1, &t0);          /* 2^250 - 1 */
    fe_sqn(&t0, &t0, 2);
    fe_mul(out, &t0, z);            /* 2^252 - 3 */
}

static int fe_eq(const fe *f, const fe *g) {
    uint8_t a[32], b[32];
    fe_tobytes(a, f);
    fe_tobytes(b, g);
    return memcmp(a, b, 32) == 0;
}

static int fe_iszero(const fe *f) {
    static const uint8_t zero[32];
    uint8_t a[32];
    fe_tobytes(a, f);
    return memcmp(a, zero, 32) == 0;
}

/* crypto/ed25519.py::_pt_decompress; 0 when the encoding is refused */
static int pt_decompress(pt *p, const uint8_t *s) {
    uint8_t canon[32], ybytes[32];
    memcpy(ybytes, s, 32);
    ybytes[31] &= 0x7F;
    int sign = s[31] >> 7;
    fe y, d, u, v, v3, x, vxx, one = {{1, 0, 0, 0, 0}};
    fe_frombytes(&y, ybytes);
    fe_tobytes(canon, &y);
    if (memcmp(canon, ybytes, 32) != 0) return 0;       /* y >= p */
    fe_frombytes(&d, D_BYTES);
    fe_mul(&u, &y, &y);
    fe_mul(&v, &d, &u);
    fe_sub(&u, &u, &one);                                /* y^2 - 1 */
    fe_add(&v, &v, &one);                                /* d y^2 + 1 */
    fe_mul(&v3, &v, &v);
    fe_mul(&v3, &v3, &v);                                /* v^3 */
    fe_mul(&x, &v3, &v3);
    fe_mul(&x, &x, &v);
    fe_mul(&x, &x, &u);                                  /* u v^7 */
    fe_pow22523(&x, &x);
    fe_mul(&x, &x, &v3);
    fe_mul(&x, &x, &u);                                  /* u v^3 (u v^7)^e */
    fe_mul(&vxx, &x, &x);
    fe_mul(&vxx, &vxx, &v);
    if (!fe_eq(&vxx, &u)) {
        fe zero = {{0, 0, 0, 0, 0}}, neg_u;
        fe_sub(&neg_u, &zero, &u);
        if (!fe_eq(&vxx, &neg_u)) return 0;              /* not a square */
        fe sqrtm1;
        fe_frombytes(&sqrtm1, SQRTM1_BYTES);
        fe_mul(&x, &x, &sqrtm1);
    }
    if (fe_iszero(&x) && sign) return 0;
    fe_tobytes(canon, &x);
    if ((canon[0] & 1) != sign) {
        fe zero = {{0, 0, 0, 0, 0}};
        fe_sub(&x, &zero, &x);
    }
    p->x = x;
    p->y = y;
    p->z = one;
    fe_mul(&p->t, &x, &y);
    return 1;
}

/* crypto/ed25519.py::_pt_add (add-2008-hwcd-3, k = 2d) */
static void pt_add(pt *r, const pt *p, const pt *q, const fe *d2) {
    fe a, b, c, d, e, f, g, h, t;
    fe_sub(&a, &p->y, &p->x);
    fe_sub(&t, &q->y, &q->x);
    fe_mul(&a, &a, &t);
    fe_add(&b, &p->y, &p->x);
    fe_add(&t, &q->y, &q->x);
    fe_mul(&b, &b, &t);
    fe_mul(&c, &p->t, d2);
    fe_mul(&c, &c, &q->t);
    fe_mul(&d, &p->z, &q->z);
    fe_add(&d, &d, &d);
    fe_sub(&e, &b, &a);
    fe_sub(&f, &d, &c);
    fe_add(&g, &d, &c);
    fe_add(&h, &b, &a);
    fe_mul(&r->x, &e, &f);
    fe_mul(&r->y, &g, &h);
    fe_mul(&r->z, &f, &g);
    fe_mul(&r->t, &e, &h);
}

/* crypto/ed25519.py::_pt_double (dbl-2008-hwcd, a = -1) */
static void pt_double(pt *r, const pt *p) {
    fe a, b, c, e, f, g, h, t, zero = {{0, 0, 0, 0, 0}};
    fe_mul(&a, &p->x, &p->x);
    fe_mul(&b, &p->y, &p->y);
    fe_mul(&c, &p->z, &p->z);
    fe_add(&c, &c, &c);
    fe_add(&t, &p->x, &p->y);
    fe_mul(&e, &t, &t);
    fe_sub(&e, &e, &a);
    fe_sub(&e, &e, &b);
    fe_sub(&g, &b, &a);
    fe_sub(&f, &g, &c);
    fe_sub(&h, &zero, &a);
    fe_sub(&h, &h, &b);
    fe_mul(&r->x, &e, &f);
    fe_mul(&r->y, &g, &h);
    fe_mul(&r->z, &f, &g);
    fe_mul(&r->t, &e, &h);
}

/* [k]p for a 32-byte little-endian k, most significant bit first */
static void pt_mul(pt *r, const uint8_t *k, const pt *p, const fe *d2) {
    pt q = {{{0, 0, 0, 0, 0}}, {{1, 0, 0, 0, 0}}, {{1, 0, 0, 0, 0}},
            {{0, 0, 0, 0, 0}}};
    for (int i = 255; i >= 0; i--) {
        pt_double(&q, &q);
        if ((k[i >> 3] >> (i & 7)) & 1) pt_add(&q, &q, p, d2);
    }
    *r = q;
}

/* 1 when [s]B == R + [k]A for the encodings a (A) and r (R) and the
 * 32-byte little-endian scalars s and k (the caller checks s < L and
 * reduces k mod L); 0 otherwise, a refused encoding of A or R included. */
int ed25519_verify_host(const uint8_t *a, const uint8_t *r, const uint8_t *s,
                        const uint8_t *k) {
    pt A, R, B, lhs, rhs;
    fe d2, l, m;
    if (!pt_decompress(&A, a) || !pt_decompress(&R, r)) return 0;
    fe_frombytes(&d2, D2_BYTES);
    fe_frombytes(&B.x, GX_BYTES);
    fe_frombytes(&B.y, GY_BYTES);
    B.z = (fe){{1, 0, 0, 0, 0}};
    fe_mul(&B.t, &B.x, &B.y);
    pt_mul(&lhs, s, &B, &d2);
    pt_mul(&rhs, k, &A, &d2);
    pt_add(&rhs, &R, &rhs, &d2);
    fe_mul(&l, &lhs.x, &rhs.z);
    fe_mul(&m, &rhs.x, &lhs.z);
    if (!fe_eq(&l, &m)) return 0;
    fe_mul(&l, &lhs.y, &rhs.z);
    fe_mul(&m, &rhs.y, &lhs.z);
    return fe_eq(&l, &m);
}
