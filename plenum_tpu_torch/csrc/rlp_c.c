/* CPython extension: RLP encode/decode for MPT trie nodes.
 *
 * Exactly the dialect of plenum_tpu_torch/state/rlp.py (which remains the
 * reference implementation and fallback): items are bytes or nested
 * lists of items; canonicality is enforced on decode (no non-canonical
 * single bytes, no leading zeros in lengths, long forms only for
 * payloads >= 56). The trie walks call this on every node load/persist
 * — the hottest serialization path in the state layer (the reference
 * leans on C via its rlp/leveldb dependencies; SURVEY.md §2.9).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

/* ------------------------------------------------------------ encode */

/* growable output buffer */
typedef struct {
    char *buf;
    Py_ssize_t len, cap;
} Out;

static int out_reserve(Out *o, Py_ssize_t extra)
{
    if (o->len + extra <= o->cap)
        return 0;
    Py_ssize_t cap = o->cap ? o->cap : 256;
    while (cap < o->len + extra)
        cap *= 2;
    char *nb = PyMem_Realloc(o->buf, cap);
    if (!nb) {
        PyErr_NoMemory();
        return -1;
    }
    o->buf = nb;
    o->cap = cap;
    return 0;
}

static int out_put(Out *o, const char *data, Py_ssize_t n)
{
    if (out_reserve(o, n) < 0)
        return -1;
    memcpy(o->buf + o->len, data, n);
    o->len += n;
    return 0;
}

static int out_byte(Out *o, unsigned char b)
{
    return out_put(o, (const char *)&b, 1);
}

static int put_length(Out *o, Py_ssize_t n, unsigned char offset)
{
    if (n < 56)
        return out_byte(o, (unsigned char)(offset + n));
    unsigned char tmp[9];
    int nb = 0;
    Py_ssize_t v = n;
    while (v) {
        tmp[8 - nb] = (unsigned char)(v & 0xFF);
        v >>= 8;
        nb++;
    }
    if (out_byte(o, (unsigned char)(offset + 55 + nb)) < 0)
        return -1;
    return out_put(o, (const char *)(tmp + 9 - nb), nb);
}

#define RLP_MAX_DEPTH 64   /* LIST nesting bound; MUST equal rlp.py's
                            * MAX_DEPTH (backends must agree on what is
                            * encodable/decodable) */

static int encode_item(Out *o, PyObject *item, int depth)
{
    if (PyBytes_CheckExact(item)) {
        Py_ssize_t n = PyBytes_GET_SIZE(item);
        const char *p = PyBytes_AS_STRING(item);
        if (n == 1 && (unsigned char)p[0] < 0x80)
            return out_put(o, p, 1);
        if (put_length(o, n, 0x80) < 0)
            return -1;
        return out_put(o, p, n);
    }
    if (PyList_CheckExact(item) || PyTuple_CheckExact(item)) {
        if (depth >= RLP_MAX_DEPTH) {
            PyErr_SetString(PyExc_ValueError, "RLP nesting too deep");
            return -1;
        }
        /* encode children into a scratch buffer, then prefix.
         * Re-fetch size/item each iteration and hold a strong ref:
         * encoding a subclass child runs arbitrary Python code that
         * may mutate (realloc) the parent list under us. */
        Out body = {NULL, 0, 0};
        for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(item); i++) {
            PyObject *kid = PySequence_Fast_GET_ITEM(item, i);
            Py_INCREF(kid);
            int rc = encode_item(&body, kid, depth + 1);
            Py_DECREF(kid);
            if (rc < 0) {
                PyMem_Free(body.buf);
                return -1;
            }
        }
        int rc = put_length(o, body.len, 0xC0);
        if (rc == 0 && body.len)
            rc = out_put(o, body.buf, body.len);
        PyMem_Free(body.buf);
        return rc;
    }
    /* subclasses and bytearray: normalize, matching the Python
     * reference's isinstance fallback (exact-type checks above are a
     * fast path, not a contract change) */
    if (PyByteArray_Check(item) || PyBytes_Check(item)) {
        PyObject *b = PyBytes_FromObject(item);
        if (!b)
            return -1;
        int rc = encode_item(o, b, depth);
        Py_DECREF(b);
        return rc;
    }
    if (PyList_Check(item) || PyTuple_Check(item)) {
        PyObject *l = PySequence_List(item);
        if (!l)
            return -1;
        int rc = encode_item(o, l, depth);
        Py_DECREF(l);
        return rc;
    }
    PyErr_Format(PyExc_TypeError, "cannot RLP-encode %s",
                 Py_TYPE(item)->tp_name);
    return -1;
}

static PyObject *rlp_encode(PyObject *self, PyObject *arg)
{
    Out o = {NULL, 0, 0};
    if (encode_item(&o, arg, 0) < 0) {
        PyMem_Free(o.buf);
        return NULL;
    }
    PyObject *res = PyBytes_FromStringAndSize(o.buf, o.len);
    PyMem_Free(o.buf);
    return res;
}

/* ------------------------------------------------------------ decode */

static PyObject *decode_at(const unsigned char *d, Py_ssize_t *pos,
                           Py_ssize_t end, int depth);

static int read_len(const unsigned char *d, Py_ssize_t *pos,
                    Py_ssize_t end, int ln, Py_ssize_t minimum,
                    Py_ssize_t *out_n)
{
    if (*pos + 1 + ln > end) {
        PyErr_SetString(PyExc_ValueError, "truncated RLP");
        return -1;
    }
    if (d[*pos + 1] == 0) {
        PyErr_SetString(PyExc_ValueError, "leading zero in RLP length");
        return -1;
    }
    Py_ssize_t n = 0;
    for (int i = 0; i < ln; i++) {
        if (n > (PY_SSIZE_T_MAX >> 8)) {
            PyErr_SetString(PyExc_ValueError, "RLP length overflow");
            return -1;
        }
        n = (n << 8) | d[*pos + 1 + i];
    }
    if (n < minimum) {
        PyErr_SetString(PyExc_ValueError, "non-canonical RLP length");
        return -1;
    }
    *pos += 1 + ln;
    /* n > end - *pos, NOT *pos + n > end: attacker-chosen n near
     * PY_SSIZE_T_MAX must not overflow the signed addition (UB) */
    if (n > end - *pos) {
        PyErr_SetString(PyExc_ValueError, "truncated RLP");
        return -1;
    }
    *out_n = n;
    return 0;
}

static PyObject *decode_list(const unsigned char *d, Py_ssize_t *pos,
                             Py_ssize_t end, int depth)
{
    PyObject *out = PyList_New(0);
    if (!out)
        return NULL;
    while (*pos < end) {
        PyObject *item = decode_at(d, pos, end, depth);
        if (!item || PyList_Append(out, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(item);
    }
    return out;
}

static PyObject *decode_at(const unsigned char *d, Py_ssize_t *pos,
                           Py_ssize_t end, int depth)
{
    if (*pos >= end) {
        PyErr_SetString(PyExc_ValueError, "empty RLP");
        return NULL;
    }
    unsigned char b0 = d[*pos];
    if (b0 < 0x80) {
        PyObject *r = PyBytes_FromStringAndSize(
            (const char *)d + *pos, 1);
        *pos += 1;
        return r;
    }
    if (b0 < 0xB8) {        /* short string */
        Py_ssize_t n = b0 - 0x80;
        if (*pos + 1 + n > end) {
            PyErr_SetString(PyExc_ValueError, "truncated RLP");
            return NULL;
        }
        if (n == 1 && d[*pos + 1] < 0x80) {
            PyErr_SetString(PyExc_ValueError,
                            "non-canonical RLP single byte");
            return NULL;
        }
        PyObject *r = PyBytes_FromStringAndSize(
            (const char *)d + *pos + 1, n);
        *pos += 1 + n;
        return r;
    }
    if (b0 < 0xC0) {        /* long string */
        Py_ssize_t n;
        if (read_len(d, pos, end, b0 - 0xB7, 56, &n) < 0)
            return NULL;
        PyObject *r = PyBytes_FromStringAndSize((const char *)d + *pos, n);
        *pos += n;
        return r;
    }
    /* list forms: only lists carry nesting depth (mirrors rlp.py) */
    if (depth >= RLP_MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "RLP nesting too deep");
        return NULL;
    }
    if (b0 < 0xF8) {        /* short list */
        Py_ssize_t n = b0 - 0xC0;
        if (*pos + 1 + n > end) {
            PyErr_SetString(PyExc_ValueError, "truncated RLP");
            return NULL;
        }
        *pos += 1;
        Py_ssize_t sub_end = *pos + n;
        PyObject *r = decode_list(d, pos, sub_end, depth + 1);
        return r;
    }
    /* long list */
    Py_ssize_t n;
    if (read_len(d, pos, end, b0 - 0xF7, 56, &n) < 0)
        return NULL;
    Py_ssize_t sub_end = *pos + n;
    return decode_list(d, pos, sub_end, depth + 1);
}

static PyObject *rlp_decode(PyObject *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    Py_ssize_t pos = 0;
    PyObject *item = decode_at((const unsigned char *)view.buf, &pos,
                               view.len, 0);
    if (item && pos != view.len) {
        Py_DECREF(item);
        item = NULL;
        PyErr_SetString(PyExc_ValueError, "trailing RLP bytes");
    }
    PyBuffer_Release(&view);
    return item;
}

/* ------------------------------------------------------------ module */

static PyMethodDef Methods[] = {
    {"encode", rlp_encode, METH_O,
     "RLP-encode bytes / nested lists of bytes."},
    {"decode", rlp_decode, METH_O,
     "Decode canonical RLP into bytes / nested lists."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef Module = {
    PyModuleDef_HEAD_INIT, "rlp_c",
    "Native RLP codec for MPT trie nodes.", -1, Methods,
};

PyMODINIT_FUNC PyInit_rlp_c(void)
{
    return PyModule_Create(&Module);
}
