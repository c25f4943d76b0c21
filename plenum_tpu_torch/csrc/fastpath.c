/* fastpath.c — CPython extension for the consensus per-request hot path.
 *
 * The profile of the ordering pipeline (see docs/performance.md) is flat
 * Python: canonical serialization (digests), strict deep-equality
 * (propagate dedup), base58, and sha256 plumbing dominate once signature
 * verification is off the host. This module collapses those into single
 * C calls:
 *
 *   canonical_json(obj)    -> bytes   == json.dumps(obj, sort_keys=True,
 *                                        separators=(',',':'),
 *                                        ensure_ascii=False).encode()
 *   digest_hex(obj)        -> str     == sha256(canonical_json(obj)).hexdigest()
 *   canonical_msgpack(obj) -> bytes   == msgpack.packb(_sort_deep(obj),
 *                                                      use_bin_type=True)
 *   msgpack_digest_hex(obj)-> str     == sha256(canonical_msgpack(obj)).hexdigest()
 *   deep_eq(a, b)          -> bool    == serializers-strict deep equality
 *                                        (types must match at every node)
 *   b58encode(bytes)       -> str
 *   b58decode(str|bytes)   -> bytes
 *   sha256(bytes)          -> bytes
 *   sha256_hex(bytes)      -> str
 *
 * Exact byte-compatibility with the Python implementations is asserted
 * by tests/test_torch_native.py over randomized nested structures —
 * consensus digests and merkle roots depend on it.
 *
 * Reference equivalence: indy-plenum leans on C extensions for the same
 * reason (msgpack C packer, libsodium, rocksdb); this file is the
 * framework's own native layer for the remaining Python-bound costs.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* SHA-256 (FIPS 180-4), small-message oriented                        */
/* ------------------------------------------------------------------ */

typedef struct {
    uint32_t h[8];
    uint64_t len;
    uint8_t buf[64];
    size_t buflen;
} sha256_ctx;

static const uint32_t K256[64] = {
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

#define ROR(x,n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_init(sha256_ctx *c) {
    c->h[0]=0x6a09e667; c->h[1]=0xbb67ae85; c->h[2]=0x3c6ef372;
    c->h[3]=0xa54ff53a; c->h[4]=0x510e527f; c->h[5]=0x9b05688c;
    c->h[6]=0x1f83d9ab; c->h[7]=0x5be0cd19;
    c->len = 0; c->buflen = 0;
}

static void sha256_block(sha256_ctx *c, const uint8_t *p) {
    uint32_t w[64];
    uint32_t a,b,d,e,f,g,h,t1,t2,cc;
    int i;
    for (i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4*i] << 24) | ((uint32_t)p[4*i+1] << 16) |
               ((uint32_t)p[4*i+2] << 8) | (uint32_t)p[4*i+3];
    for (i = 16; i < 64; i++) {
        uint32_t s0 = ROR(w[i-15],7) ^ ROR(w[i-15],18) ^ (w[i-15] >> 3);
        uint32_t s1 = ROR(w[i-2],17) ^ ROR(w[i-2],19) ^ (w[i-2] >> 10);
        w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    a=c->h[0]; b=c->h[1]; cc=c->h[2]; d=c->h[3];
    e=c->h[4]; f=c->h[5]; g=c->h[6]; h=c->h[7];
    for (i = 0; i < 64; i++) {
        uint32_t S1 = ROR(e,6) ^ ROR(e,11) ^ ROR(e,25);
        uint32_t ch = (e & f) ^ ((~e) & g);
        t1 = h + S1 + ch + K256[i] + w[i];
        uint32_t S0 = ROR(a,2) ^ ROR(a,13) ^ ROR(a,22);
        uint32_t mj = (a & b) ^ (a & cc) ^ (b & cc);
        t2 = S0 + mj;
        h=g; g=f; f=e; e=d+t1; d=cc; cc=b; b=a; a=t1+t2;
    }
    c->h[0]+=a; c->h[1]+=b; c->h[2]+=cc; c->h[3]+=d;
    c->h[4]+=e; c->h[5]+=f; c->h[6]+=g; c->h[7]+=h;
}

static void sha256_update(sha256_ctx *c, const uint8_t *p, size_t n) {
    c->len += n;
    if (c->buflen) {
        size_t take = 64 - c->buflen;
        if (take > n) take = n;
        memcpy(c->buf + c->buflen, p, take);
        c->buflen += take; p += take; n -= take;
        if (c->buflen == 64) { sha256_block(c, c->buf); c->buflen = 0; }
    }
    while (n >= 64) { sha256_block(c, p); p += 64; n -= 64; }
    if (n) { memcpy(c->buf, p, n); c->buflen = n; }
}

static void sha256_final(sha256_ctx *c, uint8_t out[32]) {
    uint64_t bitlen = c->len * 8;
    uint8_t pad = 0x80;
    uint8_t lenb[8];
    int i;
    sha256_update(c, &pad, 1);
    while (c->buflen != 56) {
        uint8_t z = 0;
        sha256_update(c, &z, 1);
    }
    for (i = 0; i < 8; i++) lenb[i] = (uint8_t)(bitlen >> (56 - 8*i));
    sha256_update(c, lenb, 8);
    for (i = 0; i < 8; i++) {
        out[4*i]   = (uint8_t)(c->h[i] >> 24);
        out[4*i+1] = (uint8_t)(c->h[i] >> 16);
        out[4*i+2] = (uint8_t)(c->h[i] >> 8);
        out[4*i+3] = (uint8_t)(c->h[i]);
    }
}

static const char HEXD[] = "0123456789abcdef";

static PyObject *hex_str(const uint8_t *d, size_t n) {
    char tmp[128];
    size_t i;
    if (n > 64) return NULL;
    for (i = 0; i < n; i++) {
        tmp[2*i] = HEXD[d[i] >> 4];
        tmp[2*i+1] = HEXD[d[i] & 15];
    }
    return PyUnicode_FromStringAndSize(tmp, (Py_ssize_t)(2 * n));
}

/* ------------------------------------------------------------------ */
/* growable byte buffer                                                */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *p;
    size_t len, cap;
    uint8_t stack[4096];
} buf_t;

static void buf_init(buf_t *b) {
    b->p = b->stack; b->len = 0; b->cap = sizeof(b->stack);
}

static void buf_free(buf_t *b) {
    if (b->p != b->stack) PyMem_Free(b->p);
}

static int buf_grow(buf_t *b, size_t need) {
    size_t ncap = b->cap * 2;
    uint8_t *np;
    while (ncap < b->len + need) ncap *= 2;
    if (b->p == b->stack) {
        np = PyMem_Malloc(ncap);
        if (!np) { PyErr_NoMemory(); return -1; }
        memcpy(np, b->stack, b->len);
    } else {
        np = PyMem_Realloc(b->p, ncap);
        if (!np) { PyErr_NoMemory(); return -1; }
    }
    b->p = np; b->cap = ncap;
    return 0;
}

static inline int buf_put(buf_t *b, const void *src, size_t n) {
    if (b->len + n > b->cap && buf_grow(b, n) < 0) return -1;
    memcpy(b->p + b->len, src, n);
    b->len += n;
    return 0;
}

static inline int buf_putc(buf_t *b, uint8_t c) {
    if (b->len + 1 > b->cap && buf_grow(b, 1) < 0) return -1;
    b->p[b->len++] = c;
    return 0;
}

/* ------------------------------------------------------------------ */
/* sorted-key iteration helper                                         */
/*                                                                     */
/* Python's sorted(dict) sorts str keys by code point, which equals    */
/* byte order of their UTF-8 encodings.  Small dicts (requests have    */
/* 4-8 keys) — insertion sort on an index array.                       */
/* ------------------------------------------------------------------ */

typedef struct {
    const char *u8;   /* UTF-8 bytes of the key */
    Py_ssize_t u8len;
    PyObject *key;
    PyObject *val;
} kv_t;

static int cmp_kv(const kv_t *a, const kv_t *b) {
    Py_ssize_t n = a->u8len < b->u8len ? a->u8len : b->u8len;
    int c = memcmp(a->u8, b->u8, (size_t)n);
    if (c) return c;
    return (a->u8len > b->u8len) - (a->u8len < b->u8len);
}

/* Collect dict items with UTF-8 keys, sorted.  Returns count or -1.
 * Caller must PyMem_Free(*out).  All keys must be str. */
static Py_ssize_t dict_sorted_items(PyObject *d, kv_t **out) {
    Py_ssize_t n = PyDict_Size(d), i, j, pos = 0;
    kv_t *items = PyMem_Malloc((size_t)(n > 0 ? n : 1) * sizeof(kv_t));
    PyObject *k, *v;
    if (!items) { PyErr_NoMemory(); return -1; }
    i = 0;
    while (PyDict_Next(d, &pos, &k, &v)) {
        if (!PyUnicode_Check(k)) {
            PyMem_Free(items);
            PyErr_SetString(PyExc_TypeError, "non-str dict key");
            return -1;
        }
        items[i].u8 = PyUnicode_AsUTF8AndSize(k, &items[i].u8len);
        if (!items[i].u8) { PyMem_Free(items); return -1; }
        items[i].key = k; items[i].val = v;
        i++;
    }
    for (i = 1; i < n; i++) {
        kv_t tmp = items[i];
        for (j = i - 1; j >= 0 && cmp_kv(&items[j], &tmp) > 0; j--)
            items[j + 1] = items[j];
        items[j + 1] = tmp;
    }
    *out = items;
    return n;
}

/* ------------------------------------------------------------------ */
/* canonical JSON                                                      */
/* ------------------------------------------------------------------ */

static int json_write(buf_t *b, PyObject *o, int depth, int ascii);

/* ensure_ascii=True string writer: non-ASCII code points become \uXXXX
 * (surrogate pairs above the BMP) — byte-identical to json.dumps's
 * default mode, which the state-value serializer uses. */
static int json_write_str_ascii(buf_t *b, PyObject *s) {
    Py_ssize_t n, i;
    int kind;
    const void *data;
    if (PyUnicode_READY(s) < 0) return -1;
    n = PyUnicode_GET_LENGTH(s);
    kind = PyUnicode_KIND(s);
    data = PyUnicode_DATA(s);
    if (buf_putc(b, '"') < 0) return -1;
    for (i = 0; i < n; i++) {
        Py_UCS4 c = PyUnicode_READ(kind, data, i);
        if (c == '"') { if (buf_put(b, "\\\"", 2) < 0) return -1; }
        else if (c == '\\') { if (buf_put(b, "\\\\", 2) < 0) return -1; }
        else if (c == '\b') { if (buf_put(b, "\\b", 2) < 0) return -1; }
        else if (c == '\f') { if (buf_put(b, "\\f", 2) < 0) return -1; }
        else if (c == '\n') { if (buf_put(b, "\\n", 2) < 0) return -1; }
        else if (c == '\r') { if (buf_put(b, "\\r", 2) < 0) return -1; }
        else if (c == '\t') { if (buf_put(b, "\\t", 2) < 0) return -1; }
        else if (c >= 0x20 && c < 0x7f) {
            if (buf_putc(b, (uint8_t)c) < 0) return -1;
        } else if (c <= 0xffff) {
            char esc[7];
            snprintf(esc, sizeof esc, "\\u%04x", (unsigned)c);
            if (buf_put(b, esc, 6) < 0) return -1;
        } else {
            char esc[13];
            Py_UCS4 v = c - 0x10000;
            snprintf(esc, sizeof esc, "\\u%04x\\u%04x",
                     (unsigned)(0xd800 + (v >> 10)),
                     (unsigned)(0xdc00 + (v & 0x3ff)));
            if (buf_put(b, esc, 12) < 0) return -1;
        }
    }
    return buf_putc(b, '"');
}

static int json_write_str(buf_t *b, PyObject *s) {
    Py_ssize_t n, i, run;
    const char *u = PyUnicode_AsUTF8AndSize(s, &n);
    if (!u) return -1;
    if (buf_putc(b, '"') < 0) return -1;
    run = 0;
    for (i = 0; i < n; i++) {
        uint8_t c = (uint8_t)u[i];
        if (c == '"' || c == '\\' || c < 0x20) {
            if (run && buf_put(b, u + i - run, (size_t)run) < 0) return -1;
            run = 0;
            switch (c) {
            case '"':  if (buf_put(b, "\\\"", 2) < 0) return -1; break;
            case '\\': if (buf_put(b, "\\\\", 2) < 0) return -1; break;
            case '\b': if (buf_put(b, "\\b", 2) < 0) return -1; break;
            case '\f': if (buf_put(b, "\\f", 2) < 0) return -1; break;
            case '\n': if (buf_put(b, "\\n", 2) < 0) return -1; break;
            case '\r': if (buf_put(b, "\\r", 2) < 0) return -1; break;
            case '\t': if (buf_put(b, "\\t", 2) < 0) return -1; break;
            default: {
                char esc[7];
                esc[0]='\\'; esc[1]='u'; esc[2]='0'; esc[3]='0';
                esc[4]=HEXD[c >> 4]; esc[5]=HEXD[c & 15];
                if (buf_put(b, esc, 6) < 0) return -1;
            }
            }
        } else {
            run++;
        }
    }
    if (run && buf_put(b, u + n - run, (size_t)run) < 0) return -1;
    return buf_putc(b, '"');
}

static int json_write_long(buf_t *b, PyObject *o) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(o, &overflow);
    char tmp[24];
    if (!overflow) {
        if (v == -1 && PyErr_Occurred()) return -1;
        snprintf(tmp, sizeof tmp, "%lld", v);
        return buf_put(b, tmp, strlen(tmp));
    }
    /* arbitrary precision: fall back to str() */
    {
        PyObject *s = PyObject_Str(o);
        Py_ssize_t n;
        const char *u;
        int rc;
        if (!s) return -1;
        u = PyUnicode_AsUTF8AndSize(s, &n);
        rc = u ? buf_put(b, u, (size_t)n) : -1;
        Py_DECREF(s);
        return rc;
    }
}

static int json_write_float(buf_t *b, PyObject *o) {
    double v = PyFloat_AS_DOUBLE(o);
    char *s;
    int rc;
    if (v != v) return buf_put(b, "NaN", 3);
    if (v > 1e308 * 10) {} /* silence pedantic warnings */
    if (Py_IS_INFINITY(v))
        return v > 0 ? buf_put(b, "Infinity", 8)
                     : buf_put(b, "-Infinity", 9);
    s = PyOS_double_to_string(v, 'r', 0, Py_DTSF_ADD_DOT_0, NULL);
    if (!s) return -1;
    rc = buf_put(b, s, strlen(s));
    PyMem_Free(s);
    return rc;
}

static int json_write(buf_t *b, PyObject *o, int depth, int ascii) {
    if (depth > 100) {
        /* TypeError on purpose: callers catch TypeError and fall back to
         * the Python serializers, which handle deep nesting — raising a
         * different type here would make C-equipped nodes diverge from
         * fallback nodes on client-controlled inputs. */
        PyErr_SetString(PyExc_TypeError,
                        "structure too deep for native fastpath");
        return -1;
    }
    if (o == Py_None) return buf_put(b, "null", 4);
    if (o == Py_True) return buf_put(b, "true", 4);
    if (o == Py_False) return buf_put(b, "false", 5);
    if (PyUnicode_Check(o))
        return ascii ? json_write_str_ascii(b, o) : json_write_str(b, o);
    if (PyLong_Check(o)) return json_write_long(b, o);
    if (PyFloat_Check(o)) return json_write_float(b, o);
    if (PyDict_Check(o)) {
        kv_t *items;
        Py_ssize_t n = dict_sorted_items(o, &items), i;
        if (n < 0) return -1;
        if (buf_putc(b, '{') < 0) { PyMem_Free(items); return -1; }
        for (i = 0; i < n; i++) {
            int krc;
            if (i && buf_putc(b, ',') < 0) { PyMem_Free(items); return -1; }
            krc = ascii ? json_write_str_ascii(b, items[i].key)
                        : json_write_str(b, items[i].key);
            if (krc < 0 ||
                buf_putc(b, ':') < 0 ||
                json_write(b, items[i].val, depth + 1, ascii) < 0) {
                PyMem_Free(items);
                return -1;
            }
        }
        PyMem_Free(items);
        return buf_putc(b, '}');
    }
    if (PyList_Check(o) || PyTuple_Check(o)) {
        Py_ssize_t n = PySequence_Size(o), i;
        if (buf_putc(b, '[') < 0) return -1;
        for (i = 0; i < n; i++) {
            PyObject *it = PySequence_GetItem(o, i);
            int rc;
            if (!it) return -1;
            if (i && buf_putc(b, ',') < 0) { Py_DECREF(it); return -1; }
            rc = json_write(b, it, depth + 1, ascii);
            Py_DECREF(it);
            if (rc < 0) return -1;
        }
        return buf_putc(b, ']');
    }
    PyErr_Format(PyExc_TypeError, "unsupported type for canonical json: %s",
                 Py_TYPE(o)->tp_name);
    return -1;
}

/* ------------------------------------------------------------------ */
/* canonical msgpack (== msgpack.packb(_sort_deep(x), use_bin_type=1)) */
/* ------------------------------------------------------------------ */

static int mp_write(buf_t *b, PyObject *o, int depth);

static int mp_write_u16(buf_t *b, uint8_t tag, uint32_t v) {
    uint8_t t[3] = { tag, (uint8_t)(v >> 8), (uint8_t)v };
    return buf_put(b, t, 3);
}

static int mp_write_u32(buf_t *b, uint8_t tag, uint32_t v) {
    uint8_t t[5] = { tag, (uint8_t)(v >> 24), (uint8_t)(v >> 16),
                     (uint8_t)(v >> 8), (uint8_t)v };
    return buf_put(b, t, 5);
}

static int mp_write_str(buf_t *b, PyObject *s) {
    Py_ssize_t n;
    const char *u = PyUnicode_AsUTF8AndSize(s, &n);
    if (!u) return -1;
    if (n < 32) {
        if (buf_putc(b, (uint8_t)(0xa0 | n)) < 0) return -1;
    } else if (n < 256) {
        uint8_t t[2] = { 0xd9, (uint8_t)n };
        if (buf_put(b, t, 2) < 0) return -1;
    } else if (n < 65536) {
        if (mp_write_u16(b, 0xda, (uint32_t)n) < 0) return -1;
    } else {
        if (mp_write_u32(b, 0xdb, (uint32_t)n) < 0) return -1;
    }
    return buf_put(b, u, (size_t)n);
}

static int mp_write_long(buf_t *b, PyObject *o) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(o, &overflow);
    if (overflow > 0) {
        /* uint64 range? */
        unsigned long long uv = PyLong_AsUnsignedLongLong(o);
        uint8_t t[9];
        int i;
        if (uv == (unsigned long long)-1 && PyErr_Occurred()) return -1;
        t[0] = 0xcf;
        for (i = 0; i < 8; i++) t[1+i] = (uint8_t)(uv >> (56 - 8*i));
        return buf_put(b, t, 9);
    }
    if (overflow < 0) {
        PyErr_SetString(PyExc_OverflowError, "int out of msgpack range");
        return -1;
    }
    if (v == -1 && PyErr_Occurred()) return -1;
    if (v >= 0) {
        if (v < 0x80) return buf_putc(b, (uint8_t)v);
        if (v < 0x100) {
            uint8_t t[2] = { 0xcc, (uint8_t)v };
            return buf_put(b, t, 2);
        }
        if (v < 0x10000) return mp_write_u16(b, 0xcd, (uint32_t)v);
        if (v < 0x100000000LL) return mp_write_u32(b, 0xce, (uint32_t)v);
        {
            uint8_t t[9];
            int i;
            t[0] = 0xcf;
            for (i = 0; i < 8; i++)
                t[1+i] = (uint8_t)((unsigned long long)v >> (56 - 8*i));
            return buf_put(b, t, 9);
        }
    }
    if (v >= -32) return buf_putc(b, (uint8_t)(0xe0 | (v + 32)));
    if (v >= -128) {
        uint8_t t[2] = { 0xd0, (uint8_t)(int8_t)v };
        return buf_put(b, t, 2);
    }
    if (v >= -32768) return mp_write_u16(b, 0xd1, (uint16_t)(int16_t)v);
    if (v >= -2147483648LL) return mp_write_u32(b, 0xd2, (uint32_t)(int32_t)v);
    {
        uint8_t t[9];
        int i;
        t[0] = 0xd3;
        for (i = 0; i < 8; i++)
            t[1+i] = (uint8_t)((unsigned long long)v >> (56 - 8*i));
        return buf_put(b, t, 9);
    }
}

static int mp_write(buf_t *b, PyObject *o, int depth) {
    if (depth > 100) {
        /* TypeError on purpose: callers catch TypeError and fall back to
         * the Python serializers, which handle deep nesting — raising a
         * different type here would make C-equipped nodes diverge from
         * fallback nodes on client-controlled inputs. */
        PyErr_SetString(PyExc_TypeError,
                        "structure too deep for native fastpath");
        return -1;
    }
    if (o == Py_None) return buf_putc(b, 0xc0);
    if (o == Py_True) return buf_putc(b, 0xc3);
    if (o == Py_False) return buf_putc(b, 0xc2);
    if (PyUnicode_Check(o)) return mp_write_str(b, o);
    if (PyLong_Check(o)) return mp_write_long(b, o);
    if (PyFloat_Check(o)) {
        double v = PyFloat_AS_DOUBLE(o);
        uint64_t bits;
        uint8_t t[9];
        int i;
        memcpy(&bits, &v, 8);
        t[0] = 0xcb;
        for (i = 0; i < 8; i++) t[1+i] = (uint8_t)(bits >> (56 - 8*i));
        return buf_put(b, t, 9);
    }
    if (PyBytes_Check(o)) {
        Py_ssize_t n = PyBytes_GET_SIZE(o);
        if (n < 256) {
            uint8_t t[2] = { 0xc4, (uint8_t)n };
            if (buf_put(b, t, 2) < 0) return -1;
        } else if (n < 65536) {
            if (mp_write_u16(b, 0xc5, (uint32_t)n) < 0) return -1;
        } else {
            if (mp_write_u32(b, 0xc6, (uint32_t)n) < 0) return -1;
        }
        return buf_put(b, PyBytes_AS_STRING(o), (size_t)n);
    }
    if (PyDict_Check(o)) {
        kv_t *items;
        Py_ssize_t n = dict_sorted_items(o, &items), i;
        if (n < 0) return -1;
        if (n < 16) {
            if (buf_putc(b, (uint8_t)(0x80 | n)) < 0) goto fail;
        } else if (n < 65536) {
            if (mp_write_u16(b, 0xde, (uint32_t)n) < 0) goto fail;
        } else {
            if (mp_write_u32(b, 0xdf, (uint32_t)n) < 0) goto fail;
        }
        for (i = 0; i < n; i++) {
            if (mp_write_str(b, items[i].key) < 0 ||
                mp_write(b, items[i].val, depth + 1) < 0)
                goto fail;
        }
        PyMem_Free(items);
        return 0;
    fail:
        PyMem_Free(items);
        return -1;
    }
    if (PyList_Check(o) || PyTuple_Check(o)) {
        Py_ssize_t n = PySequence_Size(o), i;
        if (n < 16) {
            if (buf_putc(b, (uint8_t)(0x90 | n)) < 0) return -1;
        } else if (n < 65536) {
            if (mp_write_u16(b, 0xdc, (uint32_t)n) < 0) return -1;
        } else {
            if (mp_write_u32(b, 0xdd, (uint32_t)n) < 0) return -1;
        }
        for (i = 0; i < n; i++) {
            PyObject *it = PySequence_GetItem(o, i);
            int rc;
            if (!it) return -1;
            rc = mp_write(b, it, depth + 1);
            Py_DECREF(it);
            if (rc < 0) return -1;
        }
        return 0;
    }
    PyErr_Format(PyExc_TypeError,
                 "unsupported type for canonical msgpack: %s",
                 Py_TYPE(o)->tp_name);
    return -1;
}

/* ------------------------------------------------------------------ */
/* strict deep equality                                                */
/* ------------------------------------------------------------------ */

static int deep_eq_impl(PyObject *a, PyObject *b, int depth) {
    /* -1 error, 0 unequal, 1 equal */
    if (depth > 100) {
        /* TypeError on purpose: callers catch TypeError and fall back to
         * the Python serializers, which handle deep nesting — raising a
         * different type here would make C-equipped nodes diverge from
         * fallback nodes on client-controlled inputs. */
        PyErr_SetString(PyExc_TypeError,
                        "structure too deep for native fastpath");
        return -1;
    }
    if (Py_TYPE(a) != Py_TYPE(b)) return 0;
    if (a == b) return 1;
    if (PyDict_Check(a)) {
        Py_ssize_t pos = 0;
        PyObject *k, *v;
        if (PyDict_Size(a) != PyDict_Size(b)) return 0;
        while (PyDict_Next(a, &pos, &k, &v)) {
            PyObject *bv = PyDict_GetItemWithError(b, k);
            int rc;
            if (!bv) return PyErr_Occurred() ? -1 : 0;
            rc = deep_eq_impl(v, bv, depth + 1);
            if (rc != 1) return rc;
        }
        return 1;
    }
    if (PyList_Check(a) || PyTuple_Check(a)) {
        Py_ssize_t n = PySequence_Size(a), i;
        if (n != PySequence_Size(b)) return 0;
        for (i = 0; i < n; i++) {
            PyObject *x = PySequence_GetItem(a, i);
            PyObject *y = PySequence_GetItem(b, i);
            int rc;
            if (!x || !y) { Py_XDECREF(x); Py_XDECREF(y); return -1; }
            rc = deep_eq_impl(x, y, depth + 1);
            Py_DECREF(x); Py_DECREF(y);
            if (rc != 1) return rc;
        }
        return 1;
    }
    return PyObject_RichCompareBool(a, b, Py_EQ);
}

/* ------------------------------------------------------------------ */
/* base58 (bitcoin alphabet)                                           */
/* ------------------------------------------------------------------ */

static const char B58A[] =
    "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz";

static int8_t B58I[256];

static void b58_init_index(void) {
    int i;
    memset(B58I, -1, sizeof B58I);
    for (i = 0; i < 58; i++) B58I[(uint8_t)B58A[i]] = (int8_t)i;
}

/* ------------------------------------------------------------------ */
/* module functions                                                    */
/* ------------------------------------------------------------------ */

static PyObject *py_canonical_json(PyObject *self, PyObject *arg) {
    buf_t b;
    PyObject *out;
    buf_init(&b);
    if (json_write(&b, arg, 0, 0) < 0) { buf_free(&b); return NULL; }
    out = PyBytes_FromStringAndSize((const char *)b.p, (Py_ssize_t)b.len);
    buf_free(&b);
    return out;
}

static PyObject *py_canonical_json_ascii(PyObject *self, PyObject *arg) {
    buf_t b;
    PyObject *out;
    buf_init(&b);
    if (json_write(&b, arg, 0, 1) < 0) { buf_free(&b); return NULL; }
    out = PyBytes_FromStringAndSize((const char *)b.p, (Py_ssize_t)b.len);
    buf_free(&b);
    return out;
}

static PyObject *py_digest_hex(PyObject *self, PyObject *arg) {
    buf_t b;
    sha256_ctx c;
    uint8_t d[32];
    buf_init(&b);
    if (json_write(&b, arg, 0, 0) < 0) { buf_free(&b); return NULL; }
    sha256_init(&c);
    sha256_update(&c, b.p, b.len);
    sha256_final(&c, d);
    buf_free(&b);
    return hex_str(d, 32);
}

static PyObject *py_canonical_msgpack(PyObject *self, PyObject *arg) {
    buf_t b;
    PyObject *out;
    buf_init(&b);
    if (mp_write(&b, arg, 0) < 0) { buf_free(&b); return NULL; }
    out = PyBytes_FromStringAndSize((const char *)b.p, (Py_ssize_t)b.len);
    buf_free(&b);
    return out;
}

static PyObject *py_msgpack_digest_hex(PyObject *self, PyObject *arg) {
    buf_t b;
    sha256_ctx c;
    uint8_t d[32];
    buf_init(&b);
    if (mp_write(&b, arg, 0) < 0) { buf_free(&b); return NULL; }
    sha256_init(&c);
    sha256_update(&c, b.p, b.len);
    sha256_final(&c, d);
    buf_free(&b);
    return hex_str(d, 32);
}

static PyObject *py_deep_eq(PyObject *self, PyObject *args) {
    PyObject *a, *b;
    int rc;
    if (!PyArg_ParseTuple(args, "OO", &a, &b)) return NULL;
    rc = deep_eq_impl(a, b, 0);
    if (rc < 0) return NULL;
    if (rc) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static PyObject *py_sha256(PyObject *self, PyObject *arg) {
    Py_buffer view;
    sha256_ctx c;
    uint8_t d[32];
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    sha256_init(&c);
    sha256_update(&c, view.buf, (size_t)view.len);
    sha256_final(&c, d);
    PyBuffer_Release(&view);
    return PyBytes_FromStringAndSize((const char *)d, 32);
}

static PyObject *py_sha256_hex(PyObject *self, PyObject *arg) {
    Py_buffer view;
    sha256_ctx c;
    uint8_t d[32];
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    sha256_init(&c);
    sha256_update(&c, view.buf, (size_t)view.len);
    sha256_final(&c, d);
    PyBuffer_Release(&view);
    return hex_str(d, 32);
}

static PyObject *py_b58encode(PyObject *self, PyObject *arg) {
    Py_buffer view;
    const uint8_t *data;
    size_t n, pad = 0, i, outlen = 0, cap;
    uint8_t *digits;
    PyObject *out;
    char *s;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    data = view.buf;
    n = (size_t)view.len;
    while (pad < n && data[pad] == 0) pad++;
    /* big-base conversion over a byte-digit accumulator:
     * out grows at most ceil(n * 1.366) digits */
    cap = (n - pad) * 137 / 100 + 2;
    digits = PyMem_Malloc(cap);
    if (!digits) { PyBuffer_Release(&view); return PyErr_NoMemory(); }
    for (i = pad; i < n; i++) {
        uint32_t carry = data[i];
        size_t j;
        for (j = 0; j < outlen; j++) {
            uint32_t t = ((uint32_t)digits[j] << 8) + carry;
            digits[j] = (uint8_t)(t % 58);
            carry = t / 58;
        }
        while (carry) {
            digits[outlen++] = (uint8_t)(carry % 58);
            carry /= 58;
        }
    }
    PyBuffer_Release(&view);
    out = PyUnicode_New((Py_ssize_t)(pad + outlen), 127);
    if (!out) { PyMem_Free(digits); return NULL; }
    s = (char *)PyUnicode_DATA(out);
    for (i = 0; i < pad; i++) s[i] = '1';
    for (i = 0; i < outlen; i++)
        s[pad + i] = B58A[digits[outlen - 1 - i]];
    PyMem_Free(digits);
    return out;
}

static PyObject *py_b58decode(PyObject *self, PyObject *arg) {
    const char *s;
    Py_ssize_t n;
    size_t pad = 0, outlen = 0, i, cap;
    uint8_t *bytes_acc;
    PyObject *out, *tmp = NULL;
    if (PyBytes_Check(arg)) {
        s = PyBytes_AS_STRING(arg);
        n = PyBytes_GET_SIZE(arg);
    } else if (PyUnicode_Check(arg)) {
        s = PyUnicode_AsUTF8AndSize(arg, &n);
        if (!s) return NULL;
    } else {
        PyErr_SetString(PyExc_TypeError, "b58decode needs str or bytes");
        return NULL;
    }
    while (pad < (size_t)n && s[pad] == '1') pad++;
    cap = (size_t)n * 733 / 1000 + 2;  /* log(58)/log(256) ~ 0.7326 */
    bytes_acc = PyMem_Malloc(cap);
    if (!bytes_acc) return PyErr_NoMemory();
    for (i = 0; i < (size_t)n; i++) {
        int8_t d = B58I[(uint8_t)s[i]];
        uint32_t carry;
        size_t j;
        if (d < 0) {
            /* a byte of a non-ASCII character is no code point of its
               own, and '%c' of a negative char raises OverflowError:
               name it by value */
            uint8_t c = (uint8_t)s[i];
            PyMem_Free(bytes_acc);
            if (c < 0x80)
                PyErr_Format(PyExc_ValueError,
                             "Invalid base58 character: '%c'", c);
            else
                PyErr_Format(PyExc_ValueError,
                             "Invalid base58 byte: 0x%x", (unsigned)c);
            return NULL;
        }
        carry = (uint32_t)d;
        for (j = 0; j < outlen; j++) {
            uint32_t t = (uint32_t)bytes_acc[j] * 58 + carry;
            bytes_acc[j] = (uint8_t)t;
            carry = t >> 8;
        }
        while (carry) {
            bytes_acc[outlen++] = (uint8_t)carry;
            carry >>= 8;
        }
    }
    out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(pad + outlen));
    if (out) {
        uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
        memset(p, 0, pad);
        for (i = 0; i < outlen; i++)
            p[pad + i] = bytes_acc[outlen - 1 - i];
    }
    PyMem_Free(bytes_acc);
    (void)tmp;
    return out;
}

/* ------------------------------------------------------------------ */
/* client request envelope validation                                  */
/* ------------------------------------------------------------------ */

/* decoded byte length of a base58 string, or -1 on a bad char /
   oversize input. Mirrors Base58Field (fields.py:123) without
   allocating the decoded bytes. */
static int b58_decoded_len(const char *s, Py_ssize_t n) {
    uint8_t acc[64];
    size_t outlen = 0, pad = 0, j;
    Py_ssize_t i;
    if (n > 88) return -1; /* longer than any 64-byte encoding */
    while ((Py_ssize_t)pad < n && s[pad] == '1') pad++;
    for (i = 0; i < n; i++) {
        int8_t d = B58I[(uint8_t)s[i]];
        uint32_t carry;
        if (d < 0) return -1;
        carry = (uint32_t)d;
        for (j = 0; j < outlen; j++) {
            uint32_t t = (uint32_t)acc[j] * 58 + carry;
            acc[j] = (uint8_t)t;
            carry = t >> 8;
        }
        while (carry) {
            if (outlen >= sizeof acc) return -1;
            acc[outlen++] = (uint8_t)carry;
            carry >>= 8;
        }
    }
    return (int)(pad + outlen);
}

/* identifier: str whose b58 decoding is 16 or 32 bytes */
static int valid_identifier(PyObject *o) {
    const char *s;
    Py_ssize_t n;
    int len;
    if (!PyUnicode_Check(o)) return 0;
    s = PyUnicode_AsUTF8AndSize(o, &n);
    if (!s) { PyErr_Clear(); return 0; }
    len = b58_decoded_len(s, n);
    return len == 16 || len == 32;
}

/* signature: non-empty str of at most 512 chars (SignatureField) */
static int valid_signature(PyObject *o) {
    if (!PyUnicode_Check(o)) return 0;
    return PyUnicode_GET_LENGTH(o) > 0 && PyUnicode_GET_LENGTH(o) <= 512;
}

static int nonneg_int(PyObject *o) {
    int overflow;
    long long v;
    if (!PyLong_Check(o) || PyBool_Check(o)) return 0;
    v = PyLong_AsLongLongAndOverflow(o, &overflow);
    if (overflow > 0) return 1;   /* huge positive is still non-negative */
    if (overflow < 0) return 0;
    return v >= 0;
}

/* validate_client_request(dct, protocol_version) ->
     None : envelope definitely valid (the overwhelmingly common case)
     True : not provably valid here -- run the Python validator, which
            either passes or raises with its exact error message.
   Mirrors ClientMessageValidator.validate + _validate_taa
   (common/messages/client_request.py); never produces error text, so
   clients always see the Python path's messages. */
static PyObject *py_validate_client_request(PyObject *self, PyObject *args) {
    PyObject *dct, *op, *idr, *req_id, *sig, *sigs, *pv, *taa;
    long protocol_version;
    if (!PyArg_ParseTuple(args, "Ol", &dct, &protocol_version))
        return NULL;
    if (!PyDict_Check(dct)) Py_RETURN_TRUE;
    idr = PyDict_GetItemString(dct, "identifier");
    req_id = PyDict_GetItemString(dct, "reqId");
    op = PyDict_GetItemString(dct, "operation");
    if (!op || !PyDict_Check(op)) Py_RETURN_TRUE;
    if (!PyDict_GetItemString(op, "type")) Py_RETURN_TRUE;
    if (!req_id || !nonneg_int(req_id)) Py_RETURN_TRUE;
    sigs = PyDict_GetItemString(dct, "signatures");
    if (sigs == Py_None) sigs = NULL;
    if (idr == Py_None) idr = NULL;
    if (!idr && !sigs) Py_RETURN_TRUE;
    if (idr && !valid_identifier(idr)) Py_RETURN_TRUE;
    if (sigs) {
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        if (!PyDict_Check(sigs) || PyDict_GET_SIZE(sigs) == 0)
            Py_RETURN_TRUE;
        while (PyDict_Next(sigs, &pos, &k, &v)) {
            if (!valid_identifier(k) || !valid_signature(v))
                Py_RETURN_TRUE;
        }
    }
    sig = PyDict_GetItemString(dct, "signature");
    if (sig && sig != Py_None && !valid_signature(sig)) Py_RETURN_TRUE;
    pv = PyDict_GetItemString(dct, "protocolVersion");
    if (pv && pv != Py_None) {
        long got;
        if (!PyLong_Check(pv) || PyBool_Check(pv)) Py_RETURN_TRUE;
        got = PyLong_AsLong(pv);
        if (PyErr_Occurred()) { PyErr_Clear(); Py_RETURN_TRUE; }
        if (got != protocol_version) Py_RETURN_TRUE;
    }
    taa = PyDict_GetItemString(dct, "taaAcceptance");
    if (taa && taa != Py_None) {
        PyObject *v;
        Py_ssize_t i, tn;
        const char *ds;
        if (!PyDict_Check(taa)) Py_RETURN_TRUE;
        v = PyDict_GetItemString(taa, "taaDigest");
        if (!v || !PyUnicode_Check(v)) Py_RETURN_TRUE;
        ds = PyUnicode_AsUTF8AndSize(v, &tn);
        if (!ds) { PyErr_Clear(); Py_RETURN_TRUE; }
        if (tn != 64) Py_RETURN_TRUE;
        for (i = 0; i < tn; i++) {
            char c = ds[i];
            if (!((c >= '0' && c <= '9') || (c >= 'a' && c <= 'f')
                  || (c >= 'A' && c <= 'F')))
                Py_RETURN_TRUE;
        }
        v = PyDict_GetItemString(taa, "mechanism");
        if (!v || !PyUnicode_Check(v) || PyUnicode_GET_LENGTH(v) == 0
            || PyUnicode_GET_LENGTH(v) > 256)
            Py_RETURN_TRUE;
        v = PyDict_GetItemString(taa, "time");
        if (!v || !nonneg_int(v)) Py_RETURN_TRUE;
    }
    Py_RETURN_NONE;
}

/* one JSON `"key":value` pair (comma-prefixed unless first) */
static int put_kv_json(buf_t *b, const char *key, PyObject *val,
                       int *first) {
    if (!*first && buf_putc(b, ',') < 0) return -1;
    *first = 0;
    if (buf_putc(b, '"') < 0) return -1;
    if (buf_put(b, key, strlen(key)) < 0) return -1;
    if (buf_put(b, "\":", 2) < 0) return -1;
    return json_write(b, val, 1, 0);
}

/* request_intake(dct, protocol_version) ->
     None                       : envelope not provably valid (use the
                                  Python validate + digest path)
     (digest_hex, payload_digest_hex, signing_bytes)
   One boundary crossing for the whole client-request intake prep:
   envelope validation + the two canonical-JSON digests + the signing
   bytes. Byte-identical to Request.getDigest / getPayloadDigest /
   serialize_msg_for_signing(signingPayloadState()) — the payload JSON
   IS the signing bytes, so payload_digest is its sha256. */
static PyObject *py_request_intake(PyObject *self, PyObject *args) {
    PyObject *dct, *valid, *vargs;
    PyObject *idr, *req_id, *op, *pv, *taa, *end_, *sig, *sigs;
    buf_t pb, db;
    sha256_ctx c;
    uint8_t md[32];
    PyObject *dig = NULL, *pdig = NULL, *ser = NULL, *out = NULL;
    PyObject *pv_default = NULL;
    int first;
    long protocol_version;
    if (!PyArg_ParseTuple(args, "Ol", &dct, &protocol_version))
        return NULL;
    /* reuse the validator: only a provably valid envelope proceeds */
    vargs = Py_BuildValue("(Ol)", dct, protocol_version);
    if (!vargs) return NULL;
    valid = py_validate_client_request(self, vargs);
    Py_DECREF(vargs);
    if (!valid) return NULL;
    if (valid != Py_None) { Py_DECREF(valid); Py_RETURN_NONE; }
    Py_DECREF(valid);
    idr = PyDict_GetItemString(dct, "identifier");
    req_id = PyDict_GetItemString(dct, "reqId");
    op = PyDict_GetItemString(dct, "operation");
    pv = PyDict_GetItemString(dct, "protocolVersion");
    taa = PyDict_GetItemString(dct, "taaAcceptance");
    end_ = PyDict_GetItemString(dct, "endorser");
    sig = PyDict_GetItemString(dct, "signature");
    sigs = PyDict_GetItemString(dct, "signatures");
    if (!idr) idr = Py_None;
    if (!pv) {
        /* ABSENT key defaults to the current protocol version
           (Request.from_dict d.get('protocolVersion', CURRENT));
           an explicit None stays omitted from the payload */
        pv_default = PyLong_FromLong(protocol_version);
        if (!pv_default) return NULL;
        pv = pv_default;
    }
    /* payload JSON == signing bytes (sorted keys; identifier/operation/
       reqId always present, optionals only when non-None) */
    buf_init(&pb);
    first = 1;
    if (buf_putc(&pb, '{') < 0) goto fail;
    if (end_ && end_ != Py_None
        && put_kv_json(&pb, "endorser", end_, &first) < 0) goto fail;
    if (put_kv_json(&pb, "identifier", idr, &first) < 0) goto fail;
    if (put_kv_json(&pb, "operation", op, &first) < 0) goto fail;
    if (pv && pv != Py_None
        && put_kv_json(&pb, "protocolVersion", pv, &first) < 0) goto fail;
    if (put_kv_json(&pb, "reqId", req_id, &first) < 0) goto fail;
    if (taa && taa != Py_None
        && put_kv_json(&pb, "taaAcceptance", taa, &first) < 0) goto fail;
    if (buf_putc(&pb, '}') < 0) goto fail;
    /* digest JSON: payload keys + signature(s), still sorted */
    buf_init(&db);
    first = 1;
    if (buf_putc(&db, '{') < 0) goto fail2;
    if (end_ && end_ != Py_None
        && put_kv_json(&db, "endorser", end_, &first) < 0) goto fail2;
    if (put_kv_json(&db, "identifier", idr, &first) < 0) goto fail2;
    if (put_kv_json(&db, "operation", op, &first) < 0) goto fail2;
    if (pv && pv != Py_None
        && put_kv_json(&db, "protocolVersion", pv, &first) < 0) goto fail2;
    if (put_kv_json(&db, "reqId", req_id, &first) < 0) goto fail2;
    if (sig && sig != Py_None
        && put_kv_json(&db, "signature", sig, &first) < 0) goto fail2;
    if (sigs && sigs != Py_None
        && put_kv_json(&db, "signatures", sigs, &first) < 0) goto fail2;
    if (taa && taa != Py_None
        && put_kv_json(&db, "taaAcceptance", taa, &first) < 0) goto fail2;
    if (buf_putc(&db, '}') < 0) goto fail2;
    sha256_init(&c);
    sha256_update(&c, db.p, db.len);
    sha256_final(&c, md);
    dig = hex_str(md, 32);
    sha256_init(&c);
    sha256_update(&c, pb.p, pb.len);
    sha256_final(&c, md);
    pdig = hex_str(md, 32);
    ser = PyBytes_FromStringAndSize((const char *)pb.p,
                                    (Py_ssize_t)pb.len);
    if (dig && pdig && ser)
        out = PyTuple_Pack(3, dig, pdig, ser);
    Py_XDECREF(dig); Py_XDECREF(pdig); Py_XDECREF(ser);
    Py_XDECREF(pv_default);
    buf_free(&db);
    buf_free(&pb);
    return out;
fail2:
    buf_free(&db);
fail:
    Py_XDECREF(pv_default);
    buf_free(&pb);
    return NULL;
}

static PyMethodDef methods[] = {
    {"validate_client_request", py_validate_client_request, METH_VARARGS,
     "client request envelope check -> None | error str | True"},
    {"request_intake", py_request_intake, METH_VARARGS,
     "validate + digest pair + signing bytes in one pass -> "
     "None | (digest_hex, payload_digest_hex, signing_bytes)"},
    {"canonical_json", py_canonical_json, METH_O,
     "json.dumps(x, sort_keys=True, separators=(',',':'),"
     " ensure_ascii=False).encode() in one C pass"},
    {"canonical_json_ascii", py_canonical_json_ascii, METH_O,
     "json.dumps(x, sort_keys=True, separators=(',',':')).encode()"
     " (ensure_ascii=True) in one C pass"},
    {"digest_hex", py_digest_hex, METH_O,
     "sha256(canonical_json(x)).hexdigest()"},
    {"canonical_msgpack", py_canonical_msgpack, METH_O,
     "msgpack.packb(_sort_deep(x), use_bin_type=True) in one C pass"},
    {"msgpack_digest_hex", py_msgpack_digest_hex, METH_O,
     "sha256(canonical_msgpack(x)).hexdigest()"},
    {"deep_eq", py_deep_eq, METH_VARARGS,
     "type-strict deep equality (serializer-faithful)"},
    {"sha256", py_sha256, METH_O, "sha256 digest bytes"},
    {"sha256_hex", py_sha256_hex, METH_O, "sha256 hexdigest str"},
    {"b58encode", py_b58encode, METH_O, "base58 encode -> str"},
    {"b58decode", py_b58decode, METH_O, "base58 decode -> bytes"},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastpath",
    "native hot-path helpers (canonical serialization, digests, base58)",
    -1, methods
};

PyMODINIT_FUNC PyInit_fastpath(void) {
    b58_init_index();
    return PyModule_Create(&moduledef);
}
