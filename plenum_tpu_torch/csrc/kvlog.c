/* kvlog — log-structured KV engine (the framework's RocksDB-lite).
 *
 * Fills the native-storage role the reference delegates to RocksDB/
 * LevelDB (storage/kv_store_rocksdb.py:15): values live ON DISK; only
 * a compact open-addressing index (key bytes + value offset/length)
 * stays in memory. On-disk format is IDENTICAL to the pure-Python
 * KeyValueStorageFile (.kvlog):
 *
 *   record  = [klen u32 LE][vlen u32 LE][key][value]
 *   delete  = [klen u32 LE][0xFFFFFFFF][key]
 *   batch   = [0xFFFFFFFE u32][body u32 LE][records...]
 *
 * so the two backends open each other's files. Crash safety: a torn
 * tail (or torn batch body) is truncated on open. Compaction rewrites
 * live records to <path>.compact and renames it into place.
 *
 * Exported API (ctypes, see plenum_tpu_torch/storage/kv_native.py):
 *   kv_open/kv_close/kv_flush
 *   kv_put/kv_get/kv_remove  (get copies into caller buffer; returns
 *                             needed length so callers can retry)
 *   kv_batch_begin/kv_batch_end  (frames puts/removes atomically)
 *   kv_count / kv_keys_size / kv_keys  (index snapshot for iteration)
 *   kv_compact
 */
#define _POSIX_C_SOURCE 200809L  /* fileno, ftruncate, strdup under c11 */
#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define TOMBSTONE 0xFFFFFFFFu
#define BATCH_MARK 0xFFFFFFFEu

typedef struct {
    uint8_t *key;        /* arena pointer */
    uint32_t klen;
    uint64_t voff;       /* value offset in file */
    uint32_t vlen;
    uint8_t used;        /* 0 empty, 1 used, 2 deleted slot */
} slot_t;

typedef struct kvdb {
    FILE *f;             /* append handle */
    FILE *rf;            /* persistent read handle */
    char *path;
    slot_t *slots;
    uint64_t cap;        /* power of two */
    uint64_t count;      /* live keys */
    uint64_t tomb;       /* deleted slots */
    uint64_t file_size;  /* logical end of valid log */
    uint64_t garbage;    /* bytes of dead records (for compaction) */
    /* batch state */
    uint8_t *batch_buf;
    uint64_t batch_len, batch_cap;
    int in_batch;
} kvdb;

static uint64_t fnv1a(const uint8_t *p, uint32_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (uint32_t i = 0; i < n; i++) { h ^= p[i]; h *= 1099511628211ULL; }
    return h;
}

static int grow(kvdb *db);

static slot_t *find_slot(kvdb *db, const uint8_t *key, uint32_t klen,
                         int for_insert) {
    uint64_t mask = db->cap - 1;
    uint64_t i = fnv1a(key, klen) & mask;
    slot_t *first_tomb = NULL;
    for (;;) {
        slot_t *s = &db->slots[i];
        if (s->used == 0)
            return (for_insert && first_tomb) ? first_tomb : s;
        if (s->used == 2) {
            if (for_insert && !first_tomb) first_tomb = s;
        } else if (s->klen == klen && memcmp(s->key, key, klen) == 0) {
            return s;
        }
        i = (i + 1) & mask;
    }
}

static int index_put(kvdb *db, const uint8_t *key, uint32_t klen,
                     uint64_t voff, uint32_t vlen) {
    if ((db->count + db->tomb + 1) * 4 >= db->cap * 3)
        if (grow(db) != 0) return -1;
    slot_t *s = find_slot(db, key, klen, 1);
    if (s->used == 1) {
        db->garbage += 8 + s->klen + s->vlen;  /* old record now dead */
        s->voff = voff; s->vlen = vlen;
        return 0;
    }
    uint8_t *copy = malloc(klen ? klen : 1);
    if (!copy) return -1;
    memcpy(copy, key, klen);
    if (s->used == 2) db->tomb--;
    s->key = copy; s->klen = klen; s->voff = voff; s->vlen = vlen;
    s->used = 1;
    db->count++;
    return 0;
}

static void index_del(kvdb *db, const uint8_t *key, uint32_t klen) {
    slot_t *s = find_slot(db, key, klen, 0);
    if (s->used == 1) {
        db->garbage += 8 + s->klen + s->vlen + 8 + klen; /* rec + tomb */
        free(s->key);
        s->key = NULL; s->used = 2;
        db->count--; db->tomb++;
    }
}

static int grow(kvdb *db) {
    uint64_t old_cap = db->cap;
    slot_t *old = db->slots;
    uint64_t ncap = db->cap * 2;
    slot_t *ns = calloc(ncap, sizeof(slot_t));
    if (!ns) return -1;
    db->slots = ns; db->cap = ncap; db->tomb = 0;
    for (uint64_t i = 0; i < old_cap; i++) {
        if (old[i].used == 1) {
            slot_t *s = find_slot(db, old[i].key, old[i].klen, 1);
            *s = old[i];
        }
    }
    free(old);
    return 0;
}

static uint32_t rd_u32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8)
         | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

static void wr_u32(uint8_t *p, uint32_t v) {
    p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
    p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

/* apply records in data[lo, hi); base = file offset of data[0] */
static void apply_records(kvdb *db, const uint8_t *data, uint64_t lo,
                          uint64_t hi, uint64_t base) {
    uint64_t pos = lo;
    while (pos + 8 <= hi) {
        uint32_t klen = rd_u32(data + pos);
        uint32_t vlen = rd_u32(data + pos + 4);
        if (vlen == TOMBSTONE) {
            if (pos + 8 + klen > hi) break;
            index_del(db, data + pos + 8, klen);
            pos += 8 + klen;
        } else {
            if (pos + 8 + (uint64_t)klen + vlen > hi) break;
            index_put(db, data + pos + 8, klen,
                      base + pos + 8 + klen, vlen);
            pos += 8 + (uint64_t)klen + vlen;
        }
    }
}

kvdb *kv_open(const char *path) {
    kvdb *db = calloc(1, sizeof(kvdb));
    if (!db) return NULL;
    db->cap = 1024;
    db->slots = calloc(db->cap, sizeof(slot_t));
    db->path = strdup(path);
    if (!db->slots || !db->path) goto fail;

    FILE *rf = fopen(path, "rb");
    uint64_t valid_end = 0;
    if (rf) {
        fseek(rf, 0, SEEK_END);
        long sz = ftell(rf);
        fseek(rf, 0, SEEK_SET);
        uint8_t *data = malloc(sz > 0 ? (size_t)sz : 1);
        if (!data) { fclose(rf); goto fail; }
        if (sz > 0 && fread(data, 1, (size_t)sz, rf) != (size_t)sz) {
            free(data); fclose(rf); goto fail;
        }
        fclose(rf);
        uint64_t pos = 0, n = (uint64_t)sz;
        while (pos + 8 <= n) {
            uint32_t klen = rd_u32(data + pos);
            uint32_t vlen = rd_u32(data + pos + 4);
            if (klen == BATCH_MARK) {
                if (pos + 8 + vlen > n) break;          /* torn batch */
                apply_records(db, data, pos + 8, pos + 8 + vlen, 0);
                pos += 8 + vlen;
            } else {
                uint64_t body = klen +
                    (vlen == TOMBSTONE ? 0 : (uint64_t)vlen);
                if (pos + 8 + body > n) break;          /* torn tail */
                apply_records(db, data, pos, pos + 8 + body, 0);
                pos += 8 + body;
            }
            valid_end = pos;
        }
        free(data);
        if (valid_end < n) {  /* drop the torn tail */
            FILE *tf = fopen(path, "rb+");
            if (tf) {
                int fd = fileno(tf);
                if (ftruncate(fd, (long)valid_end) != 0) { /* best effort */ }
                fclose(tf);
            }
        }
    }
    db->file_size = valid_end;
    db->f = fopen(path, "ab+");
    if (!db->f) goto fail;
    db->rf = fopen(path, "rb");
    if (!db->rf) { fclose(db->f); goto fail; }
    return db;
fail:
    if (db) { free(db->slots); free(db->path); free(db); }
    return NULL;
}

void kv_flush(kvdb *db) { if (db->f) fflush(db->f); }

void kv_close(kvdb *db) {
    if (!db) return;
    if (db->f) fclose(db->f);
    if (db->rf) fclose(db->rf);
    for (uint64_t i = 0; i < db->cap; i++)
        if (db->slots[i].used == 1) free(db->slots[i].key);
    free(db->slots);
    free(db->batch_buf);
    free(db->path);
    free(db);
}

static int emit(kvdb *db, const uint8_t *rec, uint64_t len) {
    if (db->in_batch) {
        if (db->batch_len + len > db->batch_cap) {
            uint64_t ncap = db->batch_cap ? db->batch_cap * 2 : 4096;
            while (ncap < db->batch_len + len) ncap *= 2;
            uint8_t *nb = realloc(db->batch_buf, ncap);
            if (!nb) return -1;
            db->batch_buf = nb; db->batch_cap = ncap;
        }
        memcpy(db->batch_buf + db->batch_len, rec, len);
        db->batch_len += len;
        return 0;
    }
    if (fwrite(rec, 1, len, db->f) != len) return -1;
    return 0;
}

int kv_put(kvdb *db, const uint8_t *key, uint32_t klen,
           const uint8_t *val, uint32_t vlen) {
    if (vlen >= BATCH_MARK) return -1;
    uint8_t hdr[8];
    wr_u32(hdr, klen); wr_u32(hdr + 4, vlen);
    /* value offset once the record lands in the file */
    uint64_t voff;
    if (db->in_batch) {
        /* position = file_size + 8 (batch hdr) + batch_len + 8 + klen */
        voff = db->file_size + 8 + db->batch_len + 8 + klen;
    } else {
        voff = db->file_size + 8 + klen;
    }
    if (emit(db, hdr, 8) != 0) return -1;
    if (emit(db, key, klen) != 0) return -1;
    if (emit(db, val, vlen) != 0) return -1;
    if (!db->in_batch) {
        db->file_size += 8 + (uint64_t)klen + vlen;
        fflush(db->f);  /* durability-on-return, like the Python backend */
    }
    return index_put(db, key, klen, voff, vlen);
}

int kv_remove(kvdb *db, const uint8_t *key, uint32_t klen) {
    /* removing an absent key is a no-op (matches the Python backend);
     * appending a tombstone for it would grow the log with bytes the
     * garbage counter never sees */
    if (!db->in_batch) {
        slot_t *s = find_slot(db, key, klen, 0);
        if (s->used != 1) return 0;
    }
    uint8_t hdr[8];
    wr_u32(hdr, klen); wr_u32(hdr + 4, TOMBSTONE);
    if (emit(db, hdr, 8) != 0) return -1;
    if (emit(db, key, klen) != 0) return -1;
    if (!db->in_batch) {
        db->file_size += 8 + klen;
        fflush(db->f);
    }
    index_del(db, key, klen);
    return 0;
}

/* → value length, copied into buf up to cap; -1 if absent */
long kv_get(kvdb *db, const uint8_t *key, uint32_t klen,
            uint8_t *buf, uint64_t cap) {
    slot_t *s = find_slot(db, key, klen, 0);
    if (s->used != 1) return -1;
    if (s->vlen <= cap && s->vlen > 0) {
        if (fseek(db->rf, (long)s->voff, SEEK_SET) != 0 ||
            fread(buf, 1, s->vlen, db->rf) != s->vlen)
            return -2;
    }
    return (long)s->vlen;
}

int kv_batch_begin(kvdb *db) {
    if (db->in_batch) return -1;
    db->in_batch = 1;
    db->batch_len = 0;
    return 0;
}

int kv_batch_end(kvdb *db) {
    if (!db->in_batch) return -1;
    db->in_batch = 0;
    uint8_t hdr[8];
    wr_u32(hdr, BATCH_MARK);
    wr_u32(hdr + 4, (uint32_t)db->batch_len);
    if (fwrite(hdr, 1, 8, db->f) != 8) return -1;
    if (db->batch_len &&
        fwrite(db->batch_buf, 1, db->batch_len, db->f) != db->batch_len)
        return -1;
    fflush(db->f);
    db->file_size += 8 + db->batch_len;
    return 0;
}

/* apply a pre-packed buffer of records (same wire format) as ONE
 * atomic batch frame: a single FFI call for the whole batch */
int kv_apply_packed(kvdb *db, const uint8_t *buf, uint64_t len) {
    if (db->in_batch) return -1;
    uint8_t hdr[8];
    wr_u32(hdr, BATCH_MARK);
    wr_u32(hdr + 4, (uint32_t)len);
    if (fwrite(hdr, 1, 8, db->f) != 8) return -1;
    if (len && fwrite(buf, 1, len, db->f) != len) return -1;
    fflush(db->f);  /* one flush per batch */
    /* index: records start at file_size + 8 */
    apply_records(db, buf, 0, len, db->file_size + 8);
    db->file_size += 8 + len;
    return 0;
}

uint64_t kv_count(kvdb *db) { return db->count; }

uint64_t kv_garbage(kvdb *db) { return db->garbage; }

/* size of the concatenated [klen u32][key] snapshot */
uint64_t kv_keys_size(kvdb *db) {
    uint64_t total = 0;
    for (uint64_t i = 0; i < db->cap; i++)
        if (db->slots[i].used == 1) total += 4 + db->slots[i].klen;
    return total;
}

void kv_keys(kvdb *db, uint8_t *buf) {
    uint64_t pos = 0;
    for (uint64_t i = 0; i < db->cap; i++) {
        slot_t *s = &db->slots[i];
        if (s->used != 1) continue;
        wr_u32(buf + pos, s->klen);
        memcpy(buf + pos + 4, s->key, s->klen);
        pos += 4 + s->klen;
    }
}

/* rewrite live records into <path>.compact, swap in, reopen */
int kv_compact(kvdb *db) {
    fflush(db->f);
    size_t plen = strlen(db->path);
    char *tmp = malloc(plen + 9);
    if (!tmp) return -1;
    memcpy(tmp, db->path, plen);
    memcpy(tmp + plen, ".compact", 9);
    FILE *out = fopen(tmp, "wb");
    FILE *in = fopen(db->path, "rb");
    if (!out || !in) {
        if (out) fclose(out);
        if (in) fclose(in);
        free(tmp);
        return -1;
    }
    uint64_t written = 0;
    uint8_t hdr[8];
    int ok = 1;
    uint8_t *vbuf = NULL;
    uint64_t vcap = 0;
    /* new offsets are applied to the index only AFTER the rename
     * succeeds — a failed swap must leave the old offsets valid */
    uint64_t *new_offs = calloc(db->cap, sizeof(uint64_t));
    if (!new_offs) { fclose(in); fclose(out); remove(tmp); free(tmp);
                     return -1; }
    for (uint64_t i = 0; ok && i < db->cap; i++) {
        slot_t *s = &db->slots[i];
        if (s->used != 1) continue;
        if (s->vlen > vcap) {
            uint8_t *nb = realloc(vbuf, s->vlen);
            if (!nb) { ok = 0; break; }
            vbuf = nb; vcap = s->vlen;
        }
        if (s->vlen > 0 &&
            (fseek(in, (long)s->voff, SEEK_SET) != 0 ||
             fread(vbuf, 1, s->vlen, in) != s->vlen)) { ok = 0; break; }
        wr_u32(hdr, s->klen); wr_u32(hdr + 4, s->vlen);
        if (fwrite(hdr, 1, 8, out) != 8 ||
            fwrite(s->key, 1, s->klen, out) != s->klen ||
            (s->vlen && fwrite(vbuf, 1, s->vlen, out) != s->vlen)) {
            ok = 0; break;
        }
        new_offs[i] = written + 8 + s->klen;
        written += 8 + (uint64_t)s->klen + s->vlen;
    }
    free(vbuf);
    fclose(in);
    if (fflush(out) != 0) ok = 0;
    fclose(out);
    if (!ok) { remove(tmp); free(tmp); free(new_offs); return -1; }
    fclose(db->f);
    fclose(db->rf);
    db->f = NULL;
    db->rf = NULL;
    if (rename(tmp, db->path) != 0) {
        /* failed swap: reopen the ORIGINAL log so the store stays
         * usable (old index offsets are untouched and still valid) */
        remove(tmp);
        free(tmp);
        free(new_offs);
        db->f = fopen(db->path, "ab+");
        db->rf = fopen(db->path, "rb");
        return -1;
    }
    free(tmp);
    for (uint64_t i = 0; i < db->cap; i++)
        if (db->slots[i].used == 1)
            db->slots[i].voff = new_offs[i];
    free(new_offs);
    db->f = fopen(db->path, "ab+");
    db->rf = fopen(db->path, "rb");
    db->file_size = written;
    db->garbage = 0;
    return (db->f && db->rf) ? 0 : -1;
}
