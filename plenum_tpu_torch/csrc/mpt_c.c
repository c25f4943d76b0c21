/* mpt_c.c — native Merkle Patricia Trie (the state-trie hot path).
 *
 * Same node format as the Python reference implementation in
 * plenum_tpu_torch/state/trie.py (which mirrors the reference's
 * state/trie/pruning_trie.py semantics): sha3-256 node hashing,
 * RLP node encoding, hex-prefix paths, inline refs for nodes whose
 * encoding is < 32 bytes, nothing deleted on update (old roots stay
 * readable).  Roots are REQUIRED to match the Python trie bit-for-bit —
 * they are consensus state — and tests/test_torch_native.py cross-checks
 * every operation against the Python implementation.
 *
 * The store is an in-process hash table (sha3 → node blob) with a
 * drain() API: Python persists newly created nodes into the durable KV
 * after each operation, and a miss callback hydrates nodes lazily from
 * that KV after a restart.  All per-node work (RLP decode/encode, sha3,
 * nibble walking) stays in C; Python only crosses the boundary once per
 * trie operation.
 *
 * API (all roots are 32-byte sha3 digests):
 *   h = new(miss_callback or None)
 *   set(h, root, key, value)   -> new_root          (empty value deletes)
 *   delete(h, root, key)       -> new_root
 *   get(h, root, key)          -> bytes | None
 *   proof(h, root, key)        -> [node_blob, ...]  (SPV proof path)
 *   items(h, root)             -> [(key, value), ...]
 *   drain(h)                   -> [(hash32, blob), ...] new since last drain
 *   put_node(h, hash32, blob)                       (bulk hydration)
 *   blank_root()               -> the empty-trie root
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Keccak / SHA3-256                                                   */
/* ------------------------------------------------------------------ */

static const uint64_t KRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL
};

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static void keccakf(uint64_t st[25]) {
    int round, i, j;
    uint64_t t, bc[5];
    static const int rotc[24] = {
        1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
        27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44
    };
    static const int piln[24] = {
        10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
        15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1
    };
    for (round = 0; round < 24; round++) {
        /* theta */
        for (i = 0; i < 5; i++)
            bc[i] = st[i] ^ st[i+5] ^ st[i+10] ^ st[i+15] ^ st[i+20];
        for (i = 0; i < 5; i++) {
            t = bc[(i+4) % 5] ^ ROTL64(bc[(i+1) % 5], 1);
            for (j = 0; j < 25; j += 5) st[j+i] ^= t;
        }
        /* rho + pi */
        t = st[1];
        for (i = 0; i < 24; i++) {
            j = piln[i];
            bc[0] = st[j];
            st[j] = ROTL64(t, rotc[i]);
            t = bc[0];
        }
        /* chi */
        for (j = 0; j < 25; j += 5) {
            for (i = 0; i < 5; i++) bc[i] = st[j+i];
            for (i = 0; i < 5; i++)
                st[j+i] ^= (~bc[(i+1) % 5]) & bc[(i+2) % 5];
        }
        /* iota */
        st[0] ^= KRC[round];
    }
}

#define SHA3_RATE 136  /* sha3-256: (1600 - 2*256)/8 */

static void sha3_256(uint8_t out[32], const uint8_t *in, size_t len) {
    uint64_t st[25];
    uint8_t tmp[SHA3_RATE];
    size_t i;
    memset(st, 0, sizeof st);
    while (len >= SHA3_RATE) {
        for (i = 0; i < SHA3_RATE / 8; i++) {
            uint64_t v;
            memcpy(&v, in + 8*i, 8);
            st[i] ^= v;       /* little-endian host assumed (x86/arm) */
        }
        keccakf(st);
        in += SHA3_RATE; len -= SHA3_RATE;
    }
    memset(tmp, 0, sizeof tmp);
    memcpy(tmp, in, len);
    tmp[len] = 0x06;           /* SHA3 domain padding */
    tmp[SHA3_RATE - 1] |= 0x80;
    for (i = 0; i < SHA3_RATE / 8; i++) {
        uint64_t v;
        memcpy(&v, tmp + 8*i, 8);
        st[i] ^= v;
    }
    keccakf(st);
    memcpy(out, st, 32);
}

/* ------------------------------------------------------------------ */
/* arena allocator (reset after every top-level operation)             */
/* ------------------------------------------------------------------ */

typedef struct arena_block {
    struct arena_block *next;
    size_t used, cap;
    /* data follows */
} arena_block;

typedef struct {
    arena_block *head;
} arena_t;

#define ARENA_BLOCK 65536

static void *arena_alloc(arena_t *a, size_t n) {
    arena_block *b = a->head;
    void *p;
    n = (n + 15) & ~(size_t)15;
    if (!b || b->used + n > b->cap) {
        size_t cap = n > ARENA_BLOCK ? n : ARENA_BLOCK;
        arena_block *nb = malloc(sizeof(arena_block) + cap);
        if (!nb) return NULL;
        nb->next = a->head; nb->used = 0; nb->cap = cap;
        a->head = nb;
        b = nb;
    }
    p = (char *)(b + 1) + b->used;
    b->used += n;
    return p;
}

static void arena_reset(arena_t *a) {
    arena_block *b = a->head, *n;
    /* keep the newest block for reuse, free the rest */
    if (b) {
        b->used = 0;
        n = b->next; b->next = NULL;
        while (n) {
            arena_block *nx = n->next;
            free(n);
            n = nx;
        }
    }
}

static void arena_destroy(arena_t *a) {
    arena_block *b = a->head;
    while (b) {
        arena_block *n = b->next;
        free(b);
        b = n;
    }
    a->head = NULL;
}

/* ------------------------------------------------------------------ */
/* item model: bytes or list                                           */
/* ------------------------------------------------------------------ */

typedef struct item {
    int is_list;
    /* bytes */
    const uint8_t *b; size_t blen;
    /* list */
    struct item **kids; size_t n;
} item_t;

static item_t *item_bytes(arena_t *a, const uint8_t *b, size_t n) {
    item_t *it = arena_alloc(a, sizeof(item_t));
    if (!it) return NULL;
    it->is_list = 0; it->b = b; it->blen = n; it->kids = NULL; it->n = 0;
    return it;
}

static item_t *item_list(arena_t *a, size_t n) {
    item_t *it = arena_alloc(a, sizeof(item_t));
    if (!it) return NULL;
    it->is_list = 1; it->b = NULL; it->blen = 0; it->n = n;
    it->kids = arena_alloc(a, n * sizeof(item_t *));
    if (!it->kids && n) return NULL;
    memset(it->kids, 0, n * sizeof(item_t *));
    return it;
}

static int item_is_blank(const item_t *it) {
    return !it->is_list && it->blen == 0;
}

/* ------------------------------------------------------------------ */
/* RLP encode/decode over items                                        */
/* ------------------------------------------------------------------ */

static size_t rlp_enc_size(const item_t *it) {
    if (!it->is_list) {
        size_t n = it->blen;
        if (n == 1 && it->b[0] < 0x80) return 1;
        if (n < 56) return 1 + n;
        { size_t l = n, ll = 0; while (l) { ll++; l >>= 8; }
          return 1 + ll + n; }
    } else {
        size_t body = 0, i;
        for (i = 0; i < it->n; i++) body += rlp_enc_size(it->kids[i]);
        if (body < 56) return 1 + body;
        { size_t l = body, ll = 0; while (l) { ll++; l >>= 8; }
          return 1 + ll + body; }
    }
}

static uint8_t *rlp_enc_write(const item_t *it, uint8_t *p) {
    if (!it->is_list) {
        size_t n = it->blen;
        if (n == 1 && it->b[0] < 0x80) { *p++ = it->b[0]; return p; }
        if (n < 56) { *p++ = (uint8_t)(0x80 + n); }
        else {
            size_t l = n, ll = 0;
            uint8_t lenb[8];
            while (l) { lenb[ll++] = (uint8_t)l; l >>= 8; }
            *p++ = (uint8_t)(0xB7 + ll);
            { size_t i; for (i = 0; i < ll; i++) *p++ = lenb[ll-1-i]; }
        }
        if (n) memcpy(p, it->b, n);
        return p + n;
    } else {
        size_t body = 0, i;
        for (i = 0; i < it->n; i++) body += rlp_enc_size(it->kids[i]);
        if (body < 56) { *p++ = (uint8_t)(0xC0 + body); }
        else {
            size_t l = body, ll = 0;
            uint8_t lenb[8];
            while (l) { lenb[ll++] = (uint8_t)l; l >>= 8; }
            *p++ = (uint8_t)(0xF7 + ll);
            { size_t j; for (j = 0; j < ll; j++) *p++ = lenb[ll-1-j]; }
        }
        for (i = 0; i < it->n; i++) p = rlp_enc_write(it->kids[i], p);
        return p;
    }
}

/* encode into arena; returns buffer + sets *out_len */
static uint8_t *rlp_encode_arena(arena_t *a, const item_t *it,
                                 size_t *out_len) {
    size_t n = rlp_enc_size(it);
    uint8_t *buf = arena_alloc(a, n);
    if (!buf) return NULL;
    rlp_enc_write(it, buf);
    *out_len = n;
    return buf;
}

/* decode; data must outlive the items (views) */
static item_t *rlp_dec_at(arena_t *a, const uint8_t *d, size_t *pos,
                          size_t end, int depth) {
    uint8_t b0;
    if (*pos >= end || depth > 64) return NULL;
    b0 = d[*pos];
    if (b0 < 0x80) {
        item_t *it = item_bytes(a, d + *pos, 1);
        (*pos)++;
        return it;
    }
    if (b0 < 0xB8) {
        size_t n = b0 - 0x80;
        item_t *it;
        if (*pos + 1 + n > end) return NULL;
        it = item_bytes(a, d + *pos + 1, n);
        *pos += 1 + n;
        return it;
    }
    if (b0 < 0xC0) {
        size_t ll = b0 - 0xB7, n = 0, i;
        item_t *it;
        if (*pos + 1 + ll > end) return NULL;
        for (i = 0; i < ll; i++) n = (n << 8) | d[*pos + 1 + i];
        if (*pos + 1 + ll + n > end) return NULL;
        it = item_bytes(a, d + *pos + 1 + ll, n);
        *pos += 1 + ll + n;
        return it;
    }
    {
        size_t body_start, body_end, n = 0, ll, i;
        size_t cnt = 0, p2;
        item_t *it;
        if (b0 < 0xF8) {
            n = b0 - 0xC0;
            body_start = *pos + 1;
        } else {
            ll = b0 - 0xF7;
            if (*pos + 1 + ll > end) return NULL;
            for (i = 0; i < ll; i++) n = (n << 8) | d[*pos + 1 + i];
            body_start = *pos + 1 + ll;
        }
        body_end = body_start + n;
        if (body_end > end) return NULL;
        /* count children */
        p2 = body_start;
        while (p2 < body_end) {
            uint8_t c = d[p2];
            if (c < 0x80) p2 += 1;
            else if (c < 0xB8) p2 += 1 + (size_t)(c - 0x80);
            else if (c < 0xC0) {
                size_t cl = c - 0xB7, cn = 0;
                if (p2 + 1 + cl > body_end) return NULL;
                for (i = 0; i < cl; i++) cn = (cn << 8) | d[p2 + 1 + i];
                p2 += 1 + cl + cn;
            } else if (c < 0xF8) p2 += 1 + (size_t)(c - 0xC0);
            else {
                size_t cl = c - 0xF7, cn = 0;
                if (p2 + 1 + cl > body_end) return NULL;
                for (i = 0; i < cl; i++) cn = (cn << 8) | d[p2 + 1 + i];
                p2 += 1 + cl + cn;
            }
            cnt++;
        }
        if (p2 != body_end) return NULL;
        it = item_list(a, cnt);
        if (!it) return NULL;
        p2 = body_start;
        for (i = 0; i < cnt; i++) {
            it->kids[i] = rlp_dec_at(a, d, &p2, body_end, depth + 1);
            if (!it->kids[i]) return NULL;
        }
        *pos = body_end;
        return it;
    }
}

static item_t *rlp_decode_arena(arena_t *a, const uint8_t *d, size_t len) {
    size_t pos = 0;
    item_t *it = rlp_dec_at(a, d, &pos, len, 0);
    if (!it || pos != len) return NULL;
    return it;
}

/* ------------------------------------------------------------------ */
/* node store: open-addressing hash table sha3 → blob                  */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t hash[32];
    uint8_t *blob;      /* malloc'd */
    uint32_t len;
    uint8_t used;
    uint8_t fresh;      /* not yet drained to the durable KV */
    uint64_t last_used; /* access tick, drives eviction */
} slot_t;

typedef struct {
    slot_t *slots;
    size_t cap;         /* power of two */
    size_t count;
    size_t max_nodes;   /* eviction threshold; 0 = unbounded (no KV) */
    uint64_t tick;      /* monotonic access counter */
    PyObject *miss_cb;  /* optional: hash -> blob (durable KV fetch) */
    arena_t arena;
    /* list of fresh hashes for drain() */
    uint8_t (*fresh)[32];
    size_t fresh_n, fresh_cap;
    /* set_many batching: while 1, ref_node keeps nodes as in-memory
       lists instead of hashing/storing them, so path nodes shared by
       the batch's keys are encoded+hashed ONCE at commit instead of
       once per key */
    int deferred;
} mpt_t;

static uint64_t hash64(const uint8_t *h) {
    uint64_t v;
    memcpy(&v, h, 8);
    return v;
}

static int store_grow(mpt_t *m) {
    size_t ncap = m->cap * 2, i;
    slot_t *ns = calloc(ncap, sizeof(slot_t));
    if (!ns) return -1;
    for (i = 0; i < m->cap; i++) {
        if (m->slots[i].used) {
            size_t j = hash64(m->slots[i].hash) & (ncap - 1);
            while (ns[j].used) j = (j + 1) & (ncap - 1);
            ns[j] = m->slots[i];
        }
    }
    free(m->slots);
    m->slots = ns; m->cap = ncap;
    return 0;
}

static slot_t *store_find(mpt_t *m, const uint8_t hash[32]) {
    size_t i = hash64(hash) & (m->cap - 1);
    while (m->slots[i].used) {
        if (memcmp(m->slots[i].hash, hash, 32) == 0) {
            m->slots[i].last_used = ++m->tick;
            return &m->slots[i];
        }
        i = (i + 1) & (m->cap - 1);
    }
    return NULL;
}

/* Every drained/hydrated node is recoverable from the durable KV via the
 * miss callback, so when the in-process store outgrows max_nodes we drop
 * the least-recently-touched non-fresh half.  Fresh (not yet drained)
 * nodes are never evicted.  This bounds a long-running validator's RAM
 * where the Python backend leaned on its capped decode cache. */
static void store_evict(mpt_t *m) {
    size_t i, kept = 0;
    uint64_t sum = 0, threshold;
    size_t evictable = 0;
    slot_t *ns;
    for (i = 0; i < m->cap; i++) {
        if (m->slots[i].used && !m->slots[i].fresh) {
            sum += m->slots[i].last_used;
            evictable++;
        }
    }
    if (!evictable) return;
    threshold = sum / evictable;  /* ~median by mean: drops roughly half */
    ns = calloc(m->cap, sizeof(slot_t));
    if (!ns) return;  /* allocation pressure: skip eviction this round */
    for (i = 0; i < m->cap; i++) {
        if (!m->slots[i].used) continue;
        if (!m->slots[i].fresh && m->slots[i].last_used <= threshold) {
            free(m->slots[i].blob);
            continue;
        }
        {
            size_t j = hash64(m->slots[i].hash) & (m->cap - 1);
            while (ns[j].used) j = (j + 1) & (m->cap - 1);
            ns[j] = m->slots[i];
            kept++;
        }
    }
    free(m->slots);
    m->slots = ns;
    m->count = kept;
}

static int store_put(mpt_t *m, const uint8_t hash[32],
                     const uint8_t *blob, size_t len, int fresh) {
    size_t i;
    if ((m->count + 1) * 4 > m->cap * 3 && store_grow(m) < 0) return -1;
    i = hash64(hash) & (m->cap - 1);
    while (m->slots[i].used) {
        if (memcmp(m->slots[i].hash, hash, 32) == 0) return 0; /* have it */
        i = (i + 1) & (m->cap - 1);
    }
    m->slots[i].blob = malloc(len ? len : 1);
    if (!m->slots[i].blob) return -1;
    memcpy(m->slots[i].blob, blob, len);
    m->slots[i].len = (uint32_t)len;
    memcpy(m->slots[i].hash, hash, 32);
    m->slots[i].used = 1;
    m->slots[i].fresh = (uint8_t)fresh;
    m->slots[i].last_used = ++m->tick;
    m->count++;
    if (fresh) {
        if (m->fresh_n == m->fresh_cap) {
            size_t nc = m->fresh_cap ? m->fresh_cap * 2 : 256;
            void *np = realloc(m->fresh, nc * 32);
            if (!np) return -1;
            m->fresh = np; m->fresh_cap = nc;
        }
        memcpy(m->fresh[m->fresh_n++], hash, 32);
    }
    return 0;
}

/* fetch blob; on miss, consult the Python miss callback (hydration).
 * Returns 0 on success. Sets Python error on failure. */
static int store_get(mpt_t *m, const uint8_t hash[32],
                     const uint8_t **blob, size_t *len) {
    slot_t *s = store_find(m, hash);
    if (s) { *blob = s->blob; *len = s->len; return 0; }
    if (m->miss_cb && m->miss_cb != Py_None) {
        PyObject *arg = PyBytes_FromStringAndSize((const char *)hash, 32);
        PyObject *res;
        if (!arg) return -1;
        res = PyObject_CallFunctionObjArgs(m->miss_cb, arg, NULL);
        Py_DECREF(arg);
        if (!res) return -1;
        if (res == Py_None) {
            Py_DECREF(res);
        } else {
            char *buf;
            Py_ssize_t blen;
            if (PyBytes_AsStringAndSize(res, &buf, &blen) < 0) {
                Py_DECREF(res);
                return -1;
            }
            /* hydrate (not fresh: it came FROM the durable store) */
            if (store_put(m, hash, (const uint8_t *)buf, (size_t)blen,
                          0) < 0) {
                Py_DECREF(res);
                PyErr_NoMemory();
                return -1;
            }
            Py_DECREF(res);
            s = store_find(m, hash);
            *blob = s->blob; *len = s->len;
            return 0;
        }
    }
    {
        char hex[65];
        static const char *H = "0123456789abcdef";
        int i;
        for (i = 0; i < 32; i++) {
            hex[2*i] = H[hash[i] >> 4];
            hex[2*i+1] = H[hash[i] & 15];
        }
        hex[64] = 0;
        PyErr_Format(PyExc_KeyError, "missing trie node %s", hex);
        return -1;
    }
}

/* ------------------------------------------------------------------ */
/* trie algorithms (mirror state/trie.py)                              */
/* ------------------------------------------------------------------ */

static uint8_t BLANK_ROOT_HASH[32];
static int blank_root_ready = 0;

static void ensure_blank_root(void) {
    if (!blank_root_ready) {
        uint8_t enc = 0x80;  /* rlp(b"") */
        sha3_256(BLANK_ROOT_HASH, &enc, 1);
        blank_root_ready = 1;
    }
}

/* load a ref item (inline list / 32-byte hash / blank) into a node */
static item_t *load_ref(mpt_t *m, arena_t *a, item_t *ref) {
    const uint8_t *blob;
    size_t len;
    item_t *node;
    if (ref->is_list) return ref;
    if (ref->blen == 0) return ref;  /* blank */
    if (ref->blen == 32) {
        if (store_get(m, ref->b, &blob, &len) < 0) return NULL;
        node = rlp_decode_arena(a, blob, len);
        if (!node) PyErr_SetString(PyExc_ValueError, "corrupt trie node");
        return node;
    }
    node = rlp_decode_arena(a, ref->b, ref->blen);
    if (!node) PyErr_SetString(PyExc_ValueError, "corrupt inline node");
    return node;
}

/* persist node; return inline item if encoding < 32 bytes else hash item */
static item_t *ref_node(mpt_t *m, arena_t *a, item_t *node) {
    size_t enc_len;
    uint8_t *enc;
    uint8_t *h;
    item_t *out;
    if (item_is_blank(node)) return node;
    if (m->deferred) return node;  /* batch mode: ref-ify at commit */
    enc = rlp_encode_arena(a, node, &enc_len);
    if (!enc) { PyErr_NoMemory(); return NULL; }
    if (enc_len < 32) return node;
    h = arena_alloc(a, 32);
    if (!h) { PyErr_NoMemory(); return NULL; }
    sha3_256(h, enc, enc_len);
    if (store_put(m, h, enc, enc_len, 1) < 0) {
        PyErr_NoMemory();
        return NULL;
    }
    out = item_bytes(a, h, 32);
    return out;
}

/* hex-prefix helpers over nibble arrays */
static item_t *hp_encode_item(arena_t *a, const uint8_t *nib, size_t n,
                              int terminal) {
    size_t total = (n + 2) / 2 + ((n % 2) ? 0 : 0);
    uint8_t *out;
    item_t *it;
    size_t outlen, i;
    int flags = terminal ? 2 : 0;
    if (n % 2 == 1) {
        flags |= 1;
        outlen = (n + 1) / 2;
        out = arena_alloc(a, outlen);
        if (!out) { PyErr_NoMemory(); return NULL; }
        out[0] = (uint8_t)((flags << 4) | nib[0]);
        for (i = 1; i < outlen; i++)
            out[i] = (uint8_t)((nib[2*i-1] << 4) | nib[2*i]);
    } else {
        outlen = n / 2 + 1;
        out = arena_alloc(a, outlen);
        if (!out) { PyErr_NoMemory(); return NULL; }
        out[0] = (uint8_t)(flags << 4);
        for (i = 1; i < outlen; i++)
            out[i] = (uint8_t)((nib[2*i-2] << 4) | nib[2*i-1]);
    }
    (void)total;
    it = item_bytes(a, out, outlen);
    return it;
}

/* decode hex-prefix item -> nibble array (arena), length, terminal flag */
static uint8_t *hp_decode_item(arena_t *a, const item_t *hp,
                               size_t *out_n, int *terminal) {
    size_t total = hp->blen * 2, i;
    uint8_t *nib, flags, skip;
    if (hp->blen == 0) { PyErr_SetString(PyExc_ValueError, "bad hp"); return NULL; }
    nib = arena_alloc(a, total ? total : 1);
    if (!nib) { PyErr_NoMemory(); return NULL; }
    for (i = 0; i < hp->blen; i++) {
        nib[2*i] = hp->b[i] >> 4;
        nib[2*i+1] = hp->b[i] & 15;
    }
    flags = nib[0];
    *terminal = (flags & 2) != 0;
    skip = (flags & 1) ? 1 : 2;
    *out_n = total - skip;
    return nib + skip;
}

/* branch helper: item is a branch iff list of 17 */
#define IS_BRANCH(it) ((it)->is_list && (it)->n == 17)
#define IS_PAIR(it)   ((it)->is_list && (it)->n == 2)

static item_t *blank_item(arena_t *a) {
    return item_bytes(a, NULL, 0);
}

/* forward decls */
static item_t *trie_update(mpt_t *m, arena_t *a, item_t *node,
                           const uint8_t *nib, size_t nlen,
                           const uint8_t *val, size_t vlen);
static item_t *trie_delete_node(mpt_t *m, arena_t *a, item_t *node,
                                const uint8_t *nib, size_t nlen,
                                int *changed);

static item_t *make_leaf(arena_t *a, const uint8_t *nib, size_t nlen,
                         int terminal, const uint8_t *val, size_t vlen) {
    item_t *l = item_list(a, 2);
    if (!l) { PyErr_NoMemory(); return NULL; }
    l->kids[0] = hp_encode_item(a, nib, nlen, terminal);
    if (!l->kids[0]) return NULL;
    l->kids[1] = item_bytes(a, val, vlen);
    if (!l->kids[1]) { PyErr_NoMemory(); return NULL; }
    return l;
}

static item_t *trie_update(mpt_t *m, arena_t *a, item_t *node,
                           const uint8_t *nib, size_t nlen,
                           const uint8_t *val, size_t vlen) {
    if (item_is_blank(node))
        return make_leaf(a, nib, nlen, 1, val, vlen);
    if (IS_BRANCH(node)) {
        item_t *nn = item_list(a, 17);
        size_t i;
        if (!nn) { PyErr_NoMemory(); return NULL; }
        for (i = 0; i < 17; i++) nn->kids[i] = node->kids[i];
        if (nlen == 0) {
            nn->kids[16] = item_bytes(a, val, vlen);
            if (!nn->kids[16]) { PyErr_NoMemory(); return NULL; }
        } else {
            item_t *child = load_ref(m, a, node->kids[nib[0]]);
            item_t *sub, *r;
            if (!child) return NULL;
            sub = trie_update(m, a, child, nib + 1, nlen - 1, val, vlen);
            if (!sub) return NULL;
            r = ref_node(m, a, sub);
            if (!r) return NULL;
            nn->kids[nib[0]] = r;
        }
        return nn;
    }
    /* leaf or extension */
    {
        size_t plen, common = 0;
        int terminal;
        uint8_t *path = hp_decode_item(a, node->kids[0], &plen, &terminal);
        item_t *branch, *out;
        if (!path) return NULL;
        while (common < plen && common < nlen && path[common] == nib[common])
            common++;
        if (terminal && plen == nlen && common == plen) {
            /* exact leaf overwrite */
            item_t *l = item_list(a, 2);
            if (!l) { PyErr_NoMemory(); return NULL; }
            l->kids[0] = node->kids[0];
            l->kids[1] = item_bytes(a, val, vlen);
            if (!l->kids[1]) { PyErr_NoMemory(); return NULL; }
            return l;
        }
        if (!terminal && common == plen) {
            item_t *child = load_ref(m, a, node->kids[1]);
            item_t *sub, *r, *l;
            if (!child) return NULL;
            sub = trie_update(m, a, child, nib + common, nlen - common,
                              val, vlen);
            if (!sub) return NULL;
            r = ref_node(m, a, sub);
            if (!r) return NULL;
            l = item_list(a, 2);
            if (!l) { PyErr_NoMemory(); return NULL; }
            l->kids[0] = node->kids[0];
            l->kids[1] = r;
            return l;
        }
        /* split */
        branch = item_list(a, 17);
        if (!branch) { PyErr_NoMemory(); return NULL; }
        {
            size_t i;
            for (i = 0; i < 17; i++) {
                branch->kids[i] = blank_item(a);
                if (!branch->kids[i]) { PyErr_NoMemory(); return NULL; }
            }
        }
        {
            const uint8_t *old_rest = path + common;
            size_t old_n = plen - common;
            if (terminal) {
                if (old_n) {
                    item_t *l = item_list(a, 2);
                    item_t *r;
                    if (!l) { PyErr_NoMemory(); return NULL; }
                    l->kids[0] = hp_encode_item(a, old_rest + 1, old_n - 1, 1);
                    if (!l->kids[0]) return NULL;
                    l->kids[1] = node->kids[1];
                    r = ref_node(m, a, l);
                    if (!r) return NULL;
                    branch->kids[old_rest[0]] = r;
                } else {
                    branch->kids[16] = node->kids[1];
                }
            } else {
                if (old_n > 1) {
                    item_t *l = item_list(a, 2);
                    item_t *r;
                    if (!l) { PyErr_NoMemory(); return NULL; }
                    l->kids[0] = hp_encode_item(a, old_rest + 1, old_n - 1, 0);
                    if (!l->kids[0]) return NULL;
                    l->kids[1] = node->kids[1];
                    r = ref_node(m, a, l);
                    if (!r) return NULL;
                    branch->kids[old_rest[0]] = r;
                } else {
                    branch->kids[old_rest[0]] = node->kids[1];
                }
            }
        }
        {
            const uint8_t *new_rest = nib + common;
            size_t new_n = nlen - common;
            if (new_n) {
                item_t *l = make_leaf(a, new_rest + 1, new_n - 1, 1,
                                      val, vlen);
                item_t *r;
                if (!l) return NULL;
                r = ref_node(m, a, l);
                if (!r) return NULL;
                branch->kids[new_rest[0]] = r;
            } else {
                branch->kids[16] = item_bytes(a, val, vlen);
                if (!branch->kids[16]) { PyErr_NoMemory(); return NULL; }
            }
        }
        if (common) {
            item_t *r = ref_node(m, a, branch);
            item_t *l;
            if (!r) return NULL;
            l = item_list(a, 2);
            if (!l) { PyErr_NoMemory(); return NULL; }
            l->kids[0] = hp_encode_item(a, nib, common, 0);
            if (!l->kids[0]) return NULL;
            l->kids[1] = r;
            out = l;
        } else {
            out = branch;
        }
        return out;
    }
}

/* merge path prefix onto child (mirror _merge_extension) */
static item_t *merge_extension(mpt_t *m, arena_t *a, const uint8_t *path,
                               size_t plen, item_t *child) {
    if (item_is_blank(child)) return child;
    if (IS_BRANCH(child)) {
        item_t *r = ref_node(m, a, child);
        item_t *l;
        if (!r) return NULL;
        l = item_list(a, 2);
        if (!l) { PyErr_NoMemory(); return NULL; }
        l->kids[0] = hp_encode_item(a, path, plen, 0);
        if (!l->kids[0]) return NULL;
        l->kids[1] = r;
        return l;
    }
    {
        size_t sublen;
        int terminal;
        uint8_t *sub = hp_decode_item(a, child->kids[0], &sublen, &terminal);
        uint8_t *joined;
        item_t *l;
        if (!sub) return NULL;
        joined = arena_alloc(a, plen + sublen ? plen + sublen : 1);
        if (!joined) { PyErr_NoMemory(); return NULL; }
        memcpy(joined, path, plen);
        memcpy(joined + plen, sub, sublen);
        l = item_list(a, 2);
        if (!l) { PyErr_NoMemory(); return NULL; }
        l->kids[0] = hp_encode_item(a, joined, plen + sublen, terminal);
        if (!l->kids[0]) return NULL;
        l->kids[1] = child->kids[1];
        return l;
    }
}

static item_t *normalize_branch(mpt_t *m, arena_t *a, item_t *node) {
    size_t occupied[16], nocc = 0, i;
    int has_value = !item_is_blank(node->kids[16]);
    for (i = 0; i < 16; i++)
        if (!item_is_blank(node->kids[i])) occupied[nocc++] = i;
    if (nocc + (has_value ? 1 : 0) > 1) return node;
    if (has_value) {
        item_t *l = item_list(a, 2);
        if (!l) { PyErr_NoMemory(); return NULL; }
        l->kids[0] = hp_encode_item(a, NULL, 0, 1);
        if (!l->kids[0]) return NULL;
        l->kids[1] = node->kids[16];
        return l;
    }
    if (!nocc) return blank_item(a);
    {
        uint8_t pi = (uint8_t)occupied[0];
        item_t *child = load_ref(m, a, node->kids[pi]);
        if (!child) return NULL;
        return merge_extension(m, a, &pi, 1, child);
    }
}

static item_t *trie_delete_node(mpt_t *m, arena_t *a, item_t *node,
                                const uint8_t *nib, size_t nlen,
                                int *changed) {
    if (item_is_blank(node)) return node;
    if (IS_BRANCH(node)) {
        item_t *nn = item_list(a, 17);
        size_t i;
        if (!nn) { PyErr_NoMemory(); return NULL; }
        for (i = 0; i < 17; i++) nn->kids[i] = node->kids[i];
        if (nlen == 0) {
            nn->kids[16] = blank_item(a);
            if (!nn->kids[16]) { PyErr_NoMemory(); return NULL; }
        } else {
            item_t *child = load_ref(m, a, node->kids[nib[0]]);
            item_t *sub, *r;
            if (!child) return NULL;
            sub = trie_delete_node(m, a, child, nib + 1, nlen - 1, changed);
            if (!sub) return NULL;
            r = ref_node(m, a, sub);
            if (!r) return NULL;
            nn->kids[nib[0]] = r;
        }
        return normalize_branch(m, a, nn);
    }
    {
        size_t plen;
        int terminal;
        uint8_t *path = hp_decode_item(a, node->kids[0], &plen, &terminal);
        if (!path) return NULL;
        if (terminal) {
            if (plen == nlen && memcmp(path, nib, nlen) == 0) {
                *changed = 1;
                return blank_item(a);
            }
            return node;
        }
        if (nlen < plen || memcmp(path, nib, plen) != 0) return node;
        {
            item_t *child = load_ref(m, a, node->kids[1]);
            item_t *sub;
            if (!child) return NULL;
            sub = trie_delete_node(m, a, child, nib + plen, nlen - plen,
                                   changed);
            if (!sub) return NULL;
            if (item_is_blank(sub)) return blank_item(a);
            return merge_extension(m, a, path, plen, sub);
        }
    }
}

/* get: returns 0 found / 1 not found / -1 error; value view into arena */
static int trie_get(mpt_t *m, arena_t *a, item_t *node,
                    const uint8_t *nib, size_t nlen,
                    const uint8_t **val, size_t *vlen) {
    for (;;) {
        if (item_is_blank(node)) return 1;
        if (IS_BRANCH(node)) {
            if (nlen == 0) {
                if (item_is_blank(node->kids[16])) return 1;
                *val = node->kids[16]->b;
                *vlen = node->kids[16]->blen;
                return 0;
            }
            node = load_ref(m, a, node->kids[nib[0]]);
            if (!node) return -1;
            nib++; nlen--;
            continue;
        }
        {
            size_t plen;
            int terminal;
            uint8_t *path = hp_decode_item(a, node->kids[0], &plen,
                                           &terminal);
            if (!path) return -1;
            if (terminal) {
                if (plen == nlen && memcmp(path, nib, nlen) == 0) {
                    *val = node->kids[1]->b;
                    *vlen = node->kids[1]->blen;
                    return 0;
                }
                return 1;
            }
            if (nlen < plen || memcmp(path, nib, plen) != 0) return 1;
            node = load_ref(m, a, node->kids[1]);
            if (!node) return -1;
            nib += plen; nlen -= plen;
        }
    }
}

/* ------------------------------------------------------------------ */
/* Python object plumbing                                              */
/* ------------------------------------------------------------------ */

static void mpt_capsule_destructor(PyObject *cap) {
    mpt_t *m = PyCapsule_GetPointer(cap, "mpt_c.handle");
    size_t i;
    if (!m) return;
    for (i = 0; i < m->cap; i++)
        if (m->slots[i].used) free(m->slots[i].blob);
    free(m->slots);
    free(m->fresh);
    Py_XDECREF(m->miss_cb);
    arena_destroy(&m->arena);
    free(m);
}

static mpt_t *get_handle(PyObject *cap) {
    return PyCapsule_GetPointer(cap, "mpt_c.handle");
}

static PyObject *py_new(PyObject *self, PyObject *args) {
    PyObject *cb = Py_None;
    unsigned long long max_nodes = 1ULL << 18;
    mpt_t *m;
    if (!PyArg_ParseTuple(args, "|OK", &cb, &max_nodes)) return NULL;
    m = calloc(1, sizeof(mpt_t));
    if (!m) return PyErr_NoMemory();
    m->max_nodes = (size_t)max_nodes;
    m->cap = 1 << 12;
    m->slots = calloc(m->cap, sizeof(slot_t));
    if (!m->slots) { free(m); return PyErr_NoMemory(); }
    Py_INCREF(cb);
    m->miss_cb = cb;
    ensure_blank_root();
    return PyCapsule_New(m, "mpt_c.handle", mpt_capsule_destructor);
}

static PyObject *py_blank_root(PyObject *self, PyObject *noarg) {
    ensure_blank_root();
    return PyBytes_FromStringAndSize((const char *)BLANK_ROOT_HASH, 32);
}

/* load root item: BLANK if root == BLANK_ROOT */
static item_t *load_root(mpt_t *m, arena_t *a, const uint8_t *root) {
    if (memcmp(root, BLANK_ROOT_HASH, 32) == 0)
        return blank_item(a);
    {
        item_t ref;
        ref.is_list = 0; ref.b = root; ref.blen = 32;
        ref.kids = NULL; ref.n = 0;
        return load_ref(m, a, &ref);
    }
}

static void key_nibbles(arena_t *a, const uint8_t *key, size_t klen,
                        uint8_t **nib, size_t *nlen) {
    uint8_t *n = arena_alloc(a, klen * 2 ? klen * 2 : 1);
    size_t i;
    if (!n) { *nib = NULL; return; }
    for (i = 0; i < klen; i++) {
        n[2*i] = key[i] >> 4;
        n[2*i+1] = key[i] & 15;
    }
    *nib = n;
    *nlen = klen * 2;
}

/* store root node (always by hash, even when small — _set_root) */
static PyObject *finish_root(mpt_t *m, arena_t *a, item_t *node) {
    size_t enc_len;
    uint8_t *enc;
    uint8_t h[32];
    PyObject *out;
    if (item_is_blank(node)) {
        item_t *blank = blank_item(a);
        if (!blank) { PyErr_NoMemory(); return NULL; }
        node = blank;
    }
    enc = rlp_encode_arena(a, node, &enc_len);
    if (!enc) { PyErr_NoMemory(); return NULL; }
    sha3_256(h, enc, enc_len);
    if (store_put(m, h, enc, enc_len, 1) < 0) return PyErr_NoMemory();
    out = PyBytes_FromStringAndSize((const char *)h, 32);
    return out;
}

static PyObject *py_set(PyObject *self, PyObject *args) {
    PyObject *cap;
    Py_buffer root, key, val;
    mpt_t *m;
    PyObject *out = NULL;
    if (!PyArg_ParseTuple(args, "Oy*y*y*", &cap, &root, &key, &val))
        return NULL;
    m = get_handle(cap);
    if (!m || root.len != 32) {
        PyErr_SetString(PyExc_ValueError, "bad handle or root");
        goto done;
    }
    {
        arena_t *a = &m->arena;
        item_t *node = load_root(m, a, root.buf);
        uint8_t *nib;
        size_t nlen;
        item_t *nroot;
        if (!node) goto done;
        if (val.len == 0) {
            /* empty value == delete (mirror Trie.set) */
            int changed = 0;
            key_nibbles(a, key.buf, (size_t)key.len, &nib, &nlen);
            if (!nib) { PyErr_NoMemory(); goto done; }
            nroot = trie_delete_node(m, a, node, nib, nlen, &changed);
        } else {
            key_nibbles(a, key.buf, (size_t)key.len, &nib, &nlen);
            if (!nib) { PyErr_NoMemory(); goto done; }
            nroot = trie_update(m, a, node, nib, nlen, val.buf,
                                (size_t)val.len);
        }
        if (!nroot) goto done;
        out = finish_root(m, a, nroot);
    }
done:
    if (m) arena_reset(&m->arena);
    PyBuffer_Release(&root);
    PyBuffer_Release(&key);
    PyBuffer_Release(&val);
    return out;
}

/* post-order ref-ification of a deferred subtree: children first, so
   every parent is encoded over its kids' final (hash/inline) form.
   Only list items can be deferred nodes — bytes kids are values,
   hashes, or hex-prefix paths and are left untouched. */
static int commit_kids(mpt_t *m, arena_t *a, item_t *node) {
    size_t i;
    if (!node->is_list) return 0;
    for (i = 0; i < node->n; i++) {
        item_t *kid = node->kids[i];
        if (kid && kid->is_list && !item_is_blank(kid)) {
            item_t *r;
            if (commit_kids(m, a, kid) < 0) return -1;
            r = ref_node(m, a, kid);
            if (!r) return -1;
            node->kids[i] = r;
        }
    }
    return 0;
}

/* set_many(h, root, [(key, value), ...]) -> new root.
   One deferred pass: updates build an in-memory node tree (no hashing,
   no stores), then the final tree is committed bottom-up — upper path
   nodes shared by the batch hash once instead of once per key. Empty
   value deletes, matching set(). Intermediate roots are not stored
   (only the batch's FINAL root is a readable snapshot). */
static PyObject *py_set_many(PyObject *self, PyObject *args) {
    PyObject *cap, *pairs, *fast = NULL;
    Py_buffer root;
    mpt_t *m;
    PyObject *out = NULL;
    Py_ssize_t i, npairs;
    if (!PyArg_ParseTuple(args, "Oy*O", &cap, &root, &pairs))
        return NULL;
    m = get_handle(cap);
    if (!m || root.len != 32) {
        PyErr_SetString(PyExc_ValueError, "bad handle or root");
        goto done;
    }
    fast = PySequence_Fast(pairs, "set_many needs a sequence of pairs");
    if (!fast) goto done;
    npairs = PySequence_Fast_GET_SIZE(fast);
    {
        arena_t *a = &m->arena;
        item_t *node = load_root(m, a, root.buf);
        if (!node) goto done;
        m->deferred = 1;
        for (i = 0; i < npairs; i++) {
            PyObject *pair = PySequence_Fast_GET_ITEM(fast, i);
            PyObject *ko, *vo;
            const uint8_t *kb, *vb;
            Py_ssize_t klen, vlen;
            uint8_t *nib;
            size_t nlen;
            if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
                PyErr_SetString(PyExc_TypeError,
                                "set_many pairs must be (key, value)");
                m->deferred = 0;
                goto done;
            }
            ko = PyTuple_GET_ITEM(pair, 0);
            vo = PyTuple_GET_ITEM(pair, 1);
            if (!PyBytes_Check(ko) || !PyBytes_Check(vo)) {
                PyErr_SetString(PyExc_TypeError,
                                "set_many keys/values must be bytes");
                m->deferred = 0;
                goto done;
            }
            kb = (const uint8_t *)PyBytes_AS_STRING(ko);
            klen = PyBytes_GET_SIZE(ko);
            vb = (const uint8_t *)PyBytes_AS_STRING(vo);
            vlen = PyBytes_GET_SIZE(vo);
            key_nibbles(a, kb, (size_t)klen, &nib, &nlen);
            if (!nib) { PyErr_NoMemory(); m->deferred = 0; goto done; }
            if (vlen == 0) {
                int changed = 0;
                node = trie_delete_node(m, a, node, nib, nlen, &changed);
            } else {
                node = trie_update(m, a, node, nib, nlen, vb,
                                   (size_t)vlen);
            }
            if (!node) { m->deferred = 0; goto done; }
        }
        m->deferred = 0;
        if (commit_kids(m, a, node) < 0) goto done;
        out = finish_root(m, a, node);
    }
done:
    if (m) arena_reset(&m->arena);
    Py_XDECREF(fast);
    PyBuffer_Release(&root);
    return out;
}

static PyObject *py_delete(PyObject *self, PyObject *args) {
    PyObject *cap;
    Py_buffer root, key;
    mpt_t *m;
    PyObject *out = NULL;
    if (!PyArg_ParseTuple(args, "Oy*y*", &cap, &root, &key)) return NULL;
    m = get_handle(cap);
    if (!m || root.len != 32) {
        PyErr_SetString(PyExc_ValueError, "bad handle or root");
        goto done;
    }
    {
        arena_t *a = &m->arena;
        item_t *node = load_root(m, a, root.buf);
        uint8_t *nib;
        size_t nlen;
        item_t *nroot;
        int changed = 0;
        if (!node) goto done;
        key_nibbles(a, key.buf, (size_t)key.len, &nib, &nlen);
        if (!nib) { PyErr_NoMemory(); goto done; }
        nroot = trie_delete_node(m, a, node, nib, nlen, &changed);
        if (!nroot) goto done;
        out = finish_root(m, a, nroot);
    }
done:
    if (m) arena_reset(&m->arena);
    PyBuffer_Release(&root);
    PyBuffer_Release(&key);
    return out;
}

static PyObject *py_get(PyObject *self, PyObject *args) {
    PyObject *cap;
    Py_buffer root, key;
    mpt_t *m;
    PyObject *out = NULL;
    if (!PyArg_ParseTuple(args, "Oy*y*", &cap, &root, &key)) return NULL;
    m = get_handle(cap);
    if (!m || root.len != 32) {
        PyErr_SetString(PyExc_ValueError, "bad handle or root");
        goto done;
    }
    {
        arena_t *a = &m->arena;
        item_t *node = load_root(m, a, root.buf);
        uint8_t *nib;
        size_t nlen;
        const uint8_t *val;
        size_t vlen;
        int rc;
        if (!node) goto done;
        key_nibbles(a, key.buf, (size_t)key.len, &nib, &nlen);
        if (!nib) { PyErr_NoMemory(); goto done; }
        rc = trie_get(m, a, node, nib, nlen, &val, &vlen);
        if (rc < 0) goto done;
        if (rc == 1) {
            out = Py_None;
            Py_INCREF(out);
        } else {
            /* mirror Python: empty value at a branch slot is None, and
             * values are returned as-is otherwise */
            if (vlen == 0) { out = Py_None; Py_INCREF(out); }
            else out = PyBytes_FromStringAndSize((const char *)val,
                                                 (Py_ssize_t)vlen);
        }
    }
done:
    if (m) arena_reset(&m->arena);
    PyBuffer_Release(&root);
    PyBuffer_Release(&key);
    return out;
}

static PyObject *py_proof(PyObject *self, PyObject *args) {
    PyObject *cap;
    Py_buffer root, key;
    mpt_t *m;
    PyObject *out = NULL;
    if (!PyArg_ParseTuple(args, "Oy*y*", &cap, &root, &key)) return NULL;
    m = get_handle(cap);
    if (!m || root.len != 32) {
        PyErr_SetString(PyExc_ValueError, "bad handle or root");
        goto done;
    }
    {
        arena_t *a = &m->arena;
        uint8_t *nib;
        size_t nlen;
        item_t *node;
        PyObject *lst = PyList_New(0);
        if (!lst) goto done;
        if (memcmp(root.buf, BLANK_ROOT_HASH, 32) == 0) {
            out = lst;
            goto done;
        }
        node = load_root(m, a, root.buf);
        if (!node) { Py_DECREF(lst); goto done; }
        key_nibbles(a, key.buf, (size_t)key.len, &nib, &nlen);
        if (!nib) { Py_DECREF(lst); PyErr_NoMemory(); goto done; }
        for (;;) {
            size_t enc_len;
            uint8_t *enc = rlp_encode_arena(a, node, &enc_len);
            PyObject *pb;
            if (!enc) { Py_DECREF(lst); PyErr_NoMemory(); goto done; }
            pb = PyBytes_FromStringAndSize((const char *)enc,
                                           (Py_ssize_t)enc_len);
            if (!pb || PyList_Append(lst, pb) < 0) {
                Py_XDECREF(pb); Py_DECREF(lst); goto done;
            }
            Py_DECREF(pb);
            if (item_is_blank(node)) break;
            if (IS_BRANCH(node)) {
                item_t *ref;
                if (nlen == 0) break;
                ref = node->kids[nib[0]];
                nib++; nlen--;
                if (item_is_blank(ref)) break;
                node = load_ref(m, a, ref);
                if (!node) { Py_DECREF(lst); goto done; }
                continue;
            }
            {
                size_t plen;
                int terminal;
                uint8_t *path = hp_decode_item(a, node->kids[0], &plen,
                                               &terminal);
                if (!path) { Py_DECREF(lst); goto done; }
                if (terminal || nlen < plen ||
                    memcmp(path, nib, plen) != 0)
                    break;
                nib += plen; nlen -= plen;
                node = load_ref(m, a, node->kids[1]);
                if (!node) { Py_DECREF(lst); goto done; }
            }
        }
        out = lst;
    }
done:
    if (m) arena_reset(&m->arena);
    PyBuffer_Release(&root);
    PyBuffer_Release(&key);
    return out;
}

/* recursive walk for items() */
#define WALK_PREFIX_MAX 1024

static int walk_node(mpt_t *m, arena_t *a, item_t *node,
                     uint8_t *prefix, size_t plen, PyObject *lst) {
    if (item_is_blank(node)) return 0;
    if (plen + 64 > WALK_PREFIX_MAX) {
        PyErr_SetString(PyExc_ValueError, "trie key too deep for walk");
        return -1;
    }
    if (IS_BRANCH(node)) {
        size_t i;
        if (!item_is_blank(node->kids[16])) {
            PyObject *k, *v, *t;
            uint8_t *kb = arena_alloc(a, plen / 2 ? plen / 2 : 1);
            if (!kb) { PyErr_NoMemory(); return -1; }
            for (i = 0; i < plen / 2; i++)
                kb[i] = (uint8_t)((prefix[2*i] << 4) | prefix[2*i+1]);
            k = PyBytes_FromStringAndSize((const char *)kb,
                                          (Py_ssize_t)(plen / 2));
            v = PyBytes_FromStringAndSize(
                (const char *)node->kids[16]->b,
                (Py_ssize_t)node->kids[16]->blen);
            if (!k || !v) { Py_XDECREF(k); Py_XDECREF(v); return -1; }
            t = PyTuple_Pack(2, k, v);
            Py_DECREF(k); Py_DECREF(v);
            if (!t || PyList_Append(lst, t) < 0) {
                Py_XDECREF(t);
                return -1;
            }
            Py_DECREF(t);
        }
        for (i = 0; i < 16; i++) {
            if (!item_is_blank(node->kids[i])) {
                item_t *child = load_ref(m, a, node->kids[i]);
                if (!child) return -1;
                prefix[plen] = (uint8_t)i;
                if (walk_node(m, a, child, prefix, plen + 1, lst) < 0)
                    return -1;
            }
        }
        return 0;
    }
    {
        size_t sublen, i;
        int terminal;
        uint8_t *sub = hp_decode_item(a, node->kids[0], &sublen, &terminal);
        if (!sub) return -1;
        if (plen + sublen + 1 > WALK_PREFIX_MAX) {
            PyErr_SetString(PyExc_ValueError, "trie key too deep for walk");
            return -1;
        }
        memcpy(prefix + plen, sub, sublen);
        if (terminal) {
            size_t tot = plen + sublen;
            uint8_t *kb = arena_alloc(a, tot / 2 ? tot / 2 : 1);
            PyObject *k, *v, *t;
            if (!kb) { PyErr_NoMemory(); return -1; }
            for (i = 0; i < tot / 2; i++)
                kb[i] = (uint8_t)((prefix[2*i] << 4) | prefix[2*i+1]);
            k = PyBytes_FromStringAndSize((const char *)kb,
                                          (Py_ssize_t)(tot / 2));
            v = PyBytes_FromStringAndSize((const char *)node->kids[1]->b,
                                          (Py_ssize_t)node->kids[1]->blen);
            if (!k || !v) { Py_XDECREF(k); Py_XDECREF(v); return -1; }
            t = PyTuple_Pack(2, k, v);
            Py_DECREF(k); Py_DECREF(v);
            if (!t || PyList_Append(lst, t) < 0) {
                Py_XDECREF(t);
                return -1;
            }
            Py_DECREF(t);
            return 0;
        }
        {
            item_t *child = load_ref(m, a, node->kids[1]);
            if (!child) return -1;
            return walk_node(m, a, child, prefix, plen + sublen, lst);
        }
    }
}

static PyObject *py_items(PyObject *self, PyObject *args) {
    PyObject *cap;
    Py_buffer root;
    mpt_t *m;
    PyObject *out = NULL;
    if (!PyArg_ParseTuple(args, "Oy*", &cap, &root)) return NULL;
    m = get_handle(cap);
    if (!m || root.len != 32) {
        PyErr_SetString(PyExc_ValueError, "bad handle or root");
        goto done;
    }
    {
        arena_t *a = &m->arena;
        item_t *node = load_root(m, a, root.buf);
        uint8_t *prefix = arena_alloc(a, 1024);  /* keys are short here */
        PyObject *lst;
        if (!node || !prefix) goto done;
        lst = PyList_New(0);
        if (!lst) goto done;
        if (walk_node(m, a, node, prefix, 0, lst) < 0) {
            Py_DECREF(lst);
            goto done;
        }
        out = lst;
    }
done:
    if (m) arena_reset(&m->arena);
    PyBuffer_Release(&root);
    return out;
}

static PyObject *py_drain(PyObject *self, PyObject *args) {
    PyObject *cap;
    mpt_t *m;
    PyObject *lst;
    size_t i;
    if (!PyArg_ParseTuple(args, "O", &cap)) return NULL;
    m = get_handle(cap);
    if (!m) { PyErr_SetString(PyExc_ValueError, "bad handle"); return NULL; }
    lst = PyList_New(0);
    if (!lst) return NULL;
    for (i = 0; i < m->fresh_n; i++) {
        slot_t *s = store_find(m, m->fresh[i]);
        PyObject *h, *b, *t;
        if (!s || !s->fresh) continue;  /* already drained (dup) */
        s->fresh = 0;
        h = PyBytes_FromStringAndSize((const char *)s->hash, 32);
        b = PyBytes_FromStringAndSize((const char *)s->blob,
                                      (Py_ssize_t)s->len);
        if (!h || !b) { Py_XDECREF(h); Py_XDECREF(b); Py_DECREF(lst); return NULL; }
        t = PyTuple_Pack(2, h, b);
        Py_DECREF(h); Py_DECREF(b);
        if (!t || PyList_Append(lst, t) < 0) {
            Py_XDECREF(t); Py_DECREF(lst);
            return NULL;
        }
        Py_DECREF(t);
    }
    m->fresh_n = 0;
    /* Evict ONLY here, between trie operations: during an operation the
     * arena holds item views into slot blobs, and freeing one mid-walk
     * would be a use-after-free.  After drain() every remaining node is
     * recoverable via the miss callback. */
    if (m->max_nodes && m->count > m->max_nodes &&
        m->miss_cb && m->miss_cb != Py_None)
        store_evict(m);
    return lst;
}

static PyObject *py_put_node(PyObject *self, PyObject *args) {
    PyObject *cap;
    Py_buffer hash, blob;
    mpt_t *m;
    if (!PyArg_ParseTuple(args, "Oy*y*", &cap, &hash, &blob)) return NULL;
    m = get_handle(cap);
    if (!m || hash.len != 32) {
        PyBuffer_Release(&hash);
        PyBuffer_Release(&blob);
        PyErr_SetString(PyExc_ValueError, "bad handle or hash");
        return NULL;
    }
    if (store_put(m, hash.buf, blob.buf, (size_t)blob.len, 0) < 0) {
        PyBuffer_Release(&hash);
        PyBuffer_Release(&blob);
        return PyErr_NoMemory();
    }
    PyBuffer_Release(&hash);
    PyBuffer_Release(&blob);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"new", py_new, METH_VARARGS,
     "new(miss_cb=None, max_nodes=2**18) -> handle; max_nodes=0 disables\n"
     "eviction (only safe without a durable KV backing the miss_cb)"},
    {"blank_root", py_blank_root, METH_NOARGS, "empty-trie root hash"},
    {"set", py_set, METH_VARARGS, "set(h, root, key, value) -> new root"},
    {"set_many", py_set_many, METH_VARARGS,
     "set_many(h, root, [(key, value), ...]) -> new root; one deferred-"
     "hash pass (empty value deletes)"},
    {"delete", py_delete, METH_VARARGS, "delete(h, root, key) -> new root"},
    {"get", py_get, METH_VARARGS, "get(h, root, key) -> bytes | None"},
    {"proof", py_proof, METH_VARARGS, "proof(h, root, key) -> [blob]"},
    {"items", py_items, METH_VARARGS, "items(h, root) -> [(k, v)]"},
    {"drain", py_drain, METH_VARARGS,
     "drain(h) -> [(hash, blob)] created since last drain"},
    {"put_node", py_put_node, METH_VARARGS, "put_node(h, hash, blob)"},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "mpt_c",
    "native Merkle Patricia Trie (state hot path)", -1, methods
};

PyMODINIT_FUNC PyInit_mpt_c(void) {
    ensure_blank_root();
    return PyModule_Create(&moduledef);
}
