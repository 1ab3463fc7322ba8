/* cxdrpack — CPython extension: XDR packing as a compiled-spec interpreter.
 *
 * The Python codec layer (stellar_tpu/xdr/base.py) is declarative: every
 * type is a tree of struct/union/array/option/leaf codecs.  This module
 * interprets a compiled description of that tree in C, walking the same
 * Python object graph (PyObject_GetAttr per field) and emitting the same
 * octet stream — bit-exactness is enforced by the differential test
 * (tests/test_cxdrpack.py packs the fuzz generator's values both ways).
 *
 * The reference gets this for free from xdrpp's generated C++
 * (lib/xdrpp, src/Makefile.am:15-19); a Python-hosted framework has to buy
 * it back: at 5000-tx ledger close the pure-Python pack layer is ~1.2 s
 * of wall time (~9 packs/tx: history rows, meta, fee changes, bucket
 * entries).
 *
 * Failure contract: every malformed-value path raises the XdrError class
 * handed to compile(); unsupported codec shapes must be rejected at
 * compile time (pack assumes a well-formed program).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

enum {
    K_U32, K_I32, K_U64, K_I64, K_BOOL, K_ENUM,
    K_OPAQUE, K_VAROPAQUE, K_STRING,
    K_ARRAY, K_VARARRAY, K_OPTION, K_STRUCT, K_UNION, K_DEPTH
};

#define MAX_DEPTH_SLOTS 16

typedef struct {
    int kind;
    long long a;          /* n / maxlen / max_depth / default_void */
    int nchild;
    int *child;           /* node indices */
    PyObject **names;     /* struct: interned attr names (owned refs) */
    PyObject *members;    /* enum/union-switch: dict int -> enum member */
    PyObject *arms;       /* union: dict int -> child slot int (-1 = void) */
    int sw_kind;          /* union switch: 0 = enum, 1 = int32, 2 = uint32 */
    int depth_slot;       /* K_DEPTH */
    PyObject *cls;        /* struct/union: constructor for copy/unpack */
    int immutable;        /* copy may share the value (struct/union only) */
} Node;

typedef struct {
    Node *nodes;
    int n_nodes;
    int root;
    int n_depth_slots;
    PyObject *xdr_error;  /* owned: exception class to raise */
} Program;

typedef struct {
    char *buf;
    Py_ssize_t len, cap;
    Program *prog;
    int depths[MAX_DEPTH_SLOTS];
} Walk;

static int
ensure(Walk *w, Py_ssize_t extra)
{
    if (w->len + extra <= w->cap)
        return 0;
    Py_ssize_t ncap = w->cap ? w->cap * 2 : 256;
    while (ncap < w->len + extra)
        ncap *= 2;
    char *nbuf = PyMem_Realloc(w->buf, ncap);
    if (!nbuf) {
        PyErr_NoMemory();
        return -1;
    }
    w->buf = nbuf;
    w->cap = ncap;
    return 0;
}

static void
put_be32(char *p, unsigned int v)
{
    p[0] = (char)(v >> 24); p[1] = (char)(v >> 16);
    p[2] = (char)(v >> 8);  p[3] = (char)v;
}

static void
put_be64(char *p, unsigned long long v)
{
    put_be32(p, (unsigned int)(v >> 32));
    put_be32(p + 4, (unsigned int)v);
}

static int
xdr_err(Walk *w, const char *fmt, ...)
{
    char msg[256];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(msg, sizeof msg, fmt, ap);
    va_end(ap);
    PyErr_SetString(w->prog->xdr_error, msg);
    return -1;
}

/* Fetch an integer; IntEnum and bool are int subclasses so PyLong paths
 * cover every value the Python codec accepts. */
static int
as_longlong(Walk *w, PyObject *v, long long *out, const char *what)
{
    if (!PyLong_Check(v))
        return xdr_err(w, "%s: int expected, got %.80s", what,
                       Py_TYPE(v)->tp_name);
    long long x = PyLong_AsLongLong(v);
    if (x == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        return xdr_err(w, "%s: out of int64 range", what);
    }
    *out = x;
    return 0;
}

static int
as_ulonglong(Walk *w, PyObject *v, unsigned long long *out, const char *what)
{
    if (!PyLong_Check(v))
        return xdr_err(w, "%s: int expected, got %.80s", what,
                       Py_TYPE(v)->tp_name);
    unsigned long long x = PyLong_AsUnsignedLongLong(v);
    if (x == (unsigned long long)-1 && PyErr_Occurred()) {
        PyErr_Clear();
        return xdr_err(w, "%s: out of range", what);
    }
    *out = x;
    return 0;
}

static int pack_node(Walk *w, int idx, PyObject *val);

static int
pack_bytes_body(Walk *w, const char *data, Py_ssize_t n, int with_len)
{
    Py_ssize_t pad = (4 - (n % 4)) % 4;
    if (ensure(w, (with_len ? 4 : 0) + n + pad) < 0)
        return -1;
    if (with_len) {
        put_be32(w->buf + w->len, (unsigned int)n);
        w->len += 4;
    }
    memcpy(w->buf + w->len, data, n);
    w->len += n;
    memset(w->buf + w->len, 0, pad);
    w->len += pad;
    return 0;
}

static int
pack_node(Walk *w, int idx, PyObject *val)
{
    Node *nd = &w->prog->nodes[idx];
    switch (nd->kind) {
    case K_U32: {
        unsigned long long v;
        if (as_ulonglong(w, val, &v, "uint32") < 0)
            return -1;
        if (v > 0xFFFFFFFFULL)
            return xdr_err(w, "uint32 out of range: %llu", v);
        if (ensure(w, 4) < 0)
            return -1;
        put_be32(w->buf + w->len, (unsigned int)v);
        w->len += 4;
        return 0;
    }
    case K_I32: {
        long long v;
        if (as_longlong(w, val, &v, "int32") < 0)
            return -1;
        if (v < -2147483648LL || v > 2147483647LL)
            return xdr_err(w, "int32 out of range: %lld", v);
        if (ensure(w, 4) < 0)
            return -1;
        put_be32(w->buf + w->len, (unsigned int)(long)v);
        w->len += 4;
        return 0;
    }
    case K_U64: {
        unsigned long long v;
        if (as_ulonglong(w, val, &v, "uint64") < 0)
            return -1;
        if (ensure(w, 8) < 0)
            return -1;
        put_be64(w->buf + w->len, v);
        w->len += 8;
        return 0;
    }
    case K_I64: {
        long long v;
        if (as_longlong(w, val, &v, "int64") < 0)
            return -1;
        if (ensure(w, 8) < 0)
            return -1;
        put_be64(w->buf + w->len, (unsigned long long)v);
        w->len += 8;
        return 0;
    }
    case K_BOOL: {
        int t = PyObject_IsTrue(val);
        if (t < 0)
            return -1;
        if (ensure(w, 4) < 0)
            return -1;
        put_be32(w->buf + w->len, t ? 1u : 0u);
        w->len += 4;
        return 0;
    }
    case K_ENUM: {
        long long v;
        if (as_longlong(w, val, &v, "enum") < 0)
            return -1;
        int has = PyDict_Contains(nd->members, val);
        if (has < 0)
            return -1;
        if (!has)
            return xdr_err(w, "bad enum value %lld", v);
        if (ensure(w, 4) < 0)
            return -1;
        put_be32(w->buf + w->len, (unsigned int)(long)v);
        w->len += 4;
        return 0;
    }
    case K_OPAQUE: {
        Py_buffer b;
        if (PyObject_GetBuffer(val, &b, PyBUF_SIMPLE) < 0) {
            PyErr_Clear();
            return xdr_err(w, "opaque[%lld]: bytes expected, got %.80s",
                           nd->a, Py_TYPE(val)->tp_name);
        }
        if (b.len != nd->a) {
            PyBuffer_Release(&b);
            return xdr_err(w, "opaque[%lld] got %zd bytes", nd->a, b.len);
        }
        int rc = pack_bytes_body(w, b.buf, b.len, 0);
        PyBuffer_Release(&b);
        return rc;
    }
    case K_VAROPAQUE: {
        Py_buffer b;
        if (PyObject_GetBuffer(val, &b, PyBUF_SIMPLE) < 0) {
            PyErr_Clear();
            return xdr_err(w, "opaque<%lld>: bytes expected, got %.80s",
                           nd->a, Py_TYPE(val)->tp_name);
        }
        if (b.len > nd->a) {
            PyBuffer_Release(&b);
            return xdr_err(w, "opaque<%lld> got %zd bytes", nd->a, b.len);
        }
        int rc = pack_bytes_body(w, b.buf, b.len, 1);
        PyBuffer_Release(&b);
        return rc;
    }
    case K_STRING: {
        if (!PyUnicode_Check(val))
            return xdr_err(w, "string: str expected, got %.80s",
                           Py_TYPE(val)->tp_name);
        Py_ssize_t n;
        const char *s = PyUnicode_AsUTF8AndSize(val, &n);
        if (!s) {
            /* e.g. lone surrogates: match the Python path's XdrError */
            PyErr_Clear();
            return xdr_err(w, "invalid string value (not UTF-8 encodable)");
        }
        if (n > nd->a)
            return xdr_err(w, "string<%lld> got %zd bytes", nd->a, n);
        return pack_bytes_body(w, s, n, 1);
    }
    case K_ARRAY:
    case K_VARARRAY: {
        PyObject *seq = PySequence_Fast(val, "array value not a sequence");
        if (!seq) {
            PyErr_Clear();
            return xdr_err(w, "array: sequence expected, got %.80s",
                           Py_TYPE(val)->tp_name);
        }
        Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
        if (nd->kind == K_ARRAY ? (n != nd->a) : (n > nd->a)) {
            Py_DECREF(seq);
            return xdr_err(w, "array%s%lld%s got %zd elements",
                           nd->kind == K_ARRAY ? "[" : "<", nd->a,
                           nd->kind == K_ARRAY ? "]" : ">", n);
        }
        if (nd->kind == K_VARARRAY) {
            if (ensure(w, 4) < 0) {
                Py_DECREF(seq);
                return -1;
            }
            put_be32(w->buf + w->len, (unsigned int)n);
            w->len += 4;
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            if (pack_node(w, nd->child[0],
                          PySequence_Fast_GET_ITEM(seq, i)) < 0) {
                Py_DECREF(seq);
                return -1;
            }
        }
        Py_DECREF(seq);
        return 0;
    }
    case K_OPTION: {
        if (ensure(w, 4) < 0)
            return -1;
        if (val == Py_None) {
            put_be32(w->buf + w->len, 0);
            w->len += 4;
            return 0;
        }
        put_be32(w->buf + w->len, 1);
        w->len += 4;
        return pack_node(w, nd->child[0], val);
    }
    case K_STRUCT: {
        for (int i = 0; i < nd->nchild; i++) {
            PyObject *f = PyObject_GetAttr(val, nd->names[i]);
            if (!f) {
                PyErr_Clear();
                return xdr_err(w, "missing field %.100s",
                               PyUnicode_AsUTF8(nd->names[i]));
            }
            int rc = pack_node(w, nd->child[i], f);
            Py_DECREF(f);
            if (rc < 0)
                return -1;
        }
        return 0;
    }
    case K_UNION: {
        PyObject *disc = PyObject_GetAttr(val, w->prog->nodes[idx].names[0]);
        if (!disc) {
            PyErr_Clear();
            return xdr_err(w, "union value lacks .type");
        }
        long long dv;
        if (as_longlong(w, disc, &dv, "union discriminant") < 0) {
            Py_DECREF(disc);
            return -1;
        }
        if (nd->sw_kind == 0) {
            int has = PyDict_Contains(nd->members, disc);
            if (has < 0) {
                Py_DECREF(disc);
                return -1;
            }
            if (!has) {
                Py_DECREF(disc);
                return xdr_err(w, "bad union discriminant %lld", dv);
            }
        } else if (nd->sw_kind == 1
                       ? (dv < -2147483648LL || dv > 2147483647LL)
                       : (dv < 0 || dv > 4294967295LL)) {
            Py_DECREF(disc);
            return xdr_err(w, "discriminant out of range: %lld", dv);
        }
        if (ensure(w, 4) < 0) {
            Py_DECREF(disc);
            return -1;
        }
        put_be32(w->buf + w->len, (unsigned int)(long)dv);
        w->len += 4;
        PyObject *slot = PyDict_GetItemWithError(nd->arms, disc);
        Py_DECREF(disc);
        int child = -1;
        if (slot) {
            child = (int)PyLong_AsLong(slot);
        } else {
            if (PyErr_Occurred())
                return -1;
            if (!nd->a) /* a = default_void */
                return xdr_err(w, "bad union discriminant %lld", dv);
        }
        PyObject *v = PyObject_GetAttr(val, w->prog->nodes[idx].names[1]);
        if (!v) {
            PyErr_Clear();
            return xdr_err(w, "union value lacks .value");
        }
        int rc;
        if (child < 0) {
            rc = (v == Py_None)
                     ? 0
                     : xdr_err(w, "void union arm %lld carries a value", dv);
        } else {
            rc = pack_node(w, child, v);
        }
        Py_DECREF(v);
        return rc;
    }
    case K_DEPTH: {
        int *d = &w->depths[nd->depth_slot];
        if (++*d > nd->a) {
            --*d;
            return xdr_err(w, "recursion deeper than %lld", nd->a);
        }
        int rc = pack_node(w, nd->child[0], val);
        --*d;
        return rc;
    }
    }
    return xdr_err(w, "corrupt program: unknown node kind");
}

/* -- unpack (the from_xdr fast path) ----------------------------------- */
/* Mirrors XdrCodec.unpack_from semantics exactly: bounds checks, zero
 * padding, enum/bool/discriminant validation, UTF-8 strings, positional
 * construction of struct/union classes.  Returns a new reference or NULL
 * with XdrError set. */

typedef struct {
    const unsigned char *buf;
    Py_ssize_t len;
    Py_ssize_t off;
} Rd;

static PyObject *unpack_node(Walk *w, int idx, Rd *rd);

static int
rd_need(Walk *w, Rd *rd, Py_ssize_t n, const char *what)
{
    if (rd->off + n > rd->len)
        return xdr_err(w, "short buffer for %s", what);
    return 0;
}

static unsigned int
rd_be32(Rd *rd)
{
    const unsigned char *p = rd->buf + rd->off;
    rd->off += 4;
    return ((unsigned int)p[0] << 24) | ((unsigned int)p[1] << 16) |
           ((unsigned int)p[2] << 8) | (unsigned int)p[3];
}

static int
rd_pad_ok(Walk *w, Rd *rd, Py_ssize_t n)
{
    Py_ssize_t pad = (4 - (n % 4)) % 4;
    if (rd_need(w, rd, pad, "padding") < 0)
        return -1;
    for (Py_ssize_t i = 0; i < pad; i++) {
        if (rd->buf[rd->off + i])
            return xdr_err(w, "nonzero padding");
    }
    rd->off += pad;
    return 0;
}

static PyObject *
enum_member(Walk *w, PyObject *members, long v)
{
    PyObject *key = PyLong_FromLong(v);
    if (!key)
        return NULL;
    PyObject *m = PyDict_GetItemWithError(members, key);
    Py_DECREF(key);
    if (!m) {
        if (!PyErr_Occurred())
            xdr_err(w, "bad enum value %ld", v);
        return NULL;
    }
    Py_INCREF(m);
    return m;
}

static PyObject *
unpack_node(Walk *w, int idx, Rd *rd)
{
    Node *nd = &w->prog->nodes[idx];
    switch (nd->kind) {
    case K_U32: {
        if (rd_need(w, rd, 4, "uint32") < 0)
            return NULL;
        return PyLong_FromUnsignedLong(rd_be32(rd));
    }
    case K_I32: {
        if (rd_need(w, rd, 4, "int32") < 0)
            return NULL;
        return PyLong_FromLong((long)(int)rd_be32(rd));
    }
    case K_U64: {
        if (rd_need(w, rd, 8, "uint64") < 0)
            return NULL;
        unsigned long long hi = rd_be32(rd);
        unsigned long long lo = rd_be32(rd);
        return PyLong_FromUnsignedLongLong((hi << 32) | lo);
    }
    case K_I64: {
        if (rd_need(w, rd, 8, "int64") < 0)
            return NULL;
        unsigned long long hi = rd_be32(rd);
        unsigned long long lo = rd_be32(rd);
        return PyLong_FromLongLong((long long)((hi << 32) | lo));
    }
    case K_BOOL: {
        if (rd_need(w, rd, 4, "bool") < 0)
            return NULL;
        unsigned int v = rd_be32(rd);
        if (v > 1) {
            xdr_err(w, "bad bool discriminant %u", v);
            return NULL;
        }
        PyObject *out = v ? Py_True : Py_False;
        Py_INCREF(out);
        return out;
    }
    case K_ENUM: {
        if (rd_need(w, rd, 4, "enum") < 0)
            return NULL;
        return enum_member(w, nd->members, (long)(int)rd_be32(rd));
    }
    case K_OPAQUE: {
        if (rd_need(w, rd, nd->a, "opaque") < 0)
            return NULL;
        PyObject *out = PyBytes_FromStringAndSize(
            (const char *)rd->buf + rd->off, nd->a);
        rd->off += nd->a;
        if (out && rd_pad_ok(w, rd, nd->a) < 0) {
            Py_DECREF(out);
            return NULL;
        }
        return out;
    }
    case K_VAROPAQUE:
    case K_STRING: {
        if (rd_need(w, rd, 4, "length") < 0)
            return NULL;
        unsigned int n = rd_be32(rd);
        if (n > nd->a) {
            xdr_err(w, "opaque<%lld> length %u", nd->a, n);
            return NULL;
        }
        if (rd_need(w, rd, (Py_ssize_t)n, "var opaque") < 0)
            return NULL;
        PyObject *out;
        if (nd->kind == K_STRING) {
            out = PyUnicode_DecodeUTF8(
                (const char *)rd->buf + rd->off, n, NULL);
            if (!out) {
                PyErr_Clear();
                xdr_err(w, "invalid string bytes");
                return NULL;
            }
        } else {
            out = PyBytes_FromStringAndSize(
                (const char *)rd->buf + rd->off, n);
        }
        rd->off += n;
        if (out && rd_pad_ok(w, rd, n) < 0) {
            Py_DECREF(out);
            return NULL;
        }
        return out;
    }
    case K_ARRAY:
    case K_VARARRAY: {
        Py_ssize_t n;
        if (nd->kind == K_ARRAY) {
            n = nd->a;
        } else {
            if (rd_need(w, rd, 4, "array length") < 0)
                return NULL;
            unsigned int ln = rd_be32(rd);
            if (ln > nd->a) {
                xdr_err(w, "array<%lld> length %u", nd->a, ln);
                return NULL;
            }
            n = (Py_ssize_t)ln;
            /* hostile wire counts must fail as a SHORT BUFFER before the
             * list preallocation (every XDR element consumes >= 4 wire
             * bytes, so a count the buffer cannot possibly satisfy is
             * malformed — matching the incremental Python decoder, which
             * raises XdrError, never MemoryError, on count=0xFFFFFFFF).
             * The >=4 assumption is ENFORCED at compile time: _cspec_of
             * (xdr/base.py) raises _CUnsupported for any vararray whose
             * element's minimum wire size is under 4 bytes, keeping such
             * codecs on the Python path. */
            if (n > (rd->len - rd->off) / 4) {
                xdr_err(w, "short buffer for array of %zd elements", n);
                return NULL;
            }
        }
        PyObject *out = PyList_New(n);
        if (!out)
            return NULL;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *e = unpack_node(w, nd->child[0], rd);
            if (!e) {
                Py_DECREF(out);
                return NULL;
            }
            PyList_SET_ITEM(out, i, e);
        }
        return out;
    }
    case K_OPTION: {
        if (rd_need(w, rd, 4, "option flag") < 0)
            return NULL;
        unsigned int v = rd_be32(rd);
        if (v > 1) {
            xdr_err(w, "bad bool discriminant %u", v);
            return NULL;
        }
        if (!v)
            Py_RETURN_NONE;
        return unpack_node(w, nd->child[0], rd);
    }
    case K_STRUCT: {
        PyObject *args = PyTuple_New(nd->nchild);
        if (!args)
            return NULL;
        for (int i = 0; i < nd->nchild; i++) {
            PyObject *f = unpack_node(w, nd->child[i], rd);
            if (!f) {
                Py_DECREF(args);
                return NULL;
            }
            PyTuple_SET_ITEM(args, i, f);
        }
        PyObject *out = PyObject_CallObject(nd->cls, args);
        Py_DECREF(args);
        return out;
    }
    case K_UNION: {
        if (rd_need(w, rd, 4, "discriminant") < 0)
            return NULL;
        long dv = (long)(int)rd_be32(rd);
        PyObject *disc;
        if (nd->sw_kind == 0) {
            disc = enum_member(w, nd->members, dv);
            if (!disc)
                return NULL;
        } else if (nd->sw_kind == 2) {
            disc = PyLong_FromUnsignedLong((unsigned long)(unsigned int)dv);
        } else {
            disc = PyLong_FromLong(dv);
        }
        if (!disc)
            return NULL;
        PyObject *slot = PyDict_GetItemWithError(nd->arms, disc);
        int child = -2; /* -2 = missing */
        if (slot) {
            child = (int)PyLong_AsLong(slot);
        } else if (PyErr_Occurred()) {
            Py_DECREF(disc);
            return NULL;
        } else if (!nd->a) { /* not default_void */
            Py_DECREF(disc);
            xdr_err(w, "bad union discriminant %ld", dv);
            return NULL;
        }
        PyObject *v;
        if (child >= 0) {
            v = unpack_node(w, child, rd);
            if (!v) {
                Py_DECREF(disc);
                return NULL;
            }
        } else {
            v = Py_None;
            Py_INCREF(v);
        }
        PyObject *out = PyObject_CallFunctionObjArgs(nd->cls, disc, v, NULL);
        Py_DECREF(disc);
        Py_DECREF(v);
        return out;
    }
    case K_DEPTH: {
        int *d = &w->depths[nd->depth_slot];
        if (++*d > nd->a) {
            --*d;
            xdr_err(w, "recursion deeper than %lld", nd->a);
            return NULL;
        }
        PyObject *out = unpack_node(w, nd->child[0], rd);
        --*d;
        return out;
    }
    }
    xdr_err(w, "corrupt program: unknown node kind");
    return NULL;
}

/* -- structural copy (the xdr_copy fast path) -------------------------- */
/* Mirrors XdrCodec.copy semantics exactly: leaves are shared, containers
 * rebuilt, structs/unions rebuilt by POSITIONAL construction of the same
 * class (or shared when the codec is declared immutable).  Returns a new
 * reference, or NULL. */

static PyObject *copy_node(Walk *w, int idx, PyObject *val);

static PyObject *
copy_node(Walk *w, int idx, PyObject *val)
{
    Node *nd = &w->prog->nodes[idx];
    switch (nd->kind) {
    case K_U32: case K_I32: case K_U64: case K_I64: case K_BOOL:
    case K_ENUM: case K_OPAQUE: case K_VAROPAQUE: case K_STRING:
        Py_INCREF(val);
        return val;
    case K_OPTION:
        if (val == Py_None) {
            Py_RETURN_NONE;
        }
        return copy_node(w, nd->child[0], val);
    case K_ARRAY:
    case K_VARARRAY: {
        PyObject *seq = PySequence_Fast(val, "array value not a sequence");
        if (!seq)
            return NULL;
        Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
        PyObject *out = PyList_New(n);
        if (!out) {
            Py_DECREF(seq);
            return NULL;
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *c =
                copy_node(w, nd->child[0], PySequence_Fast_GET_ITEM(seq, i));
            if (!c) {
                Py_DECREF(seq);
                Py_DECREF(out);
                return NULL;
            }
            PyList_SET_ITEM(out, i, c);
        }
        Py_DECREF(seq);
        return out;
    }
    case K_STRUCT: {
        if (nd->immutable) {
            Py_INCREF(val);
            return val;
        }
        PyObject *args = PyTuple_New(nd->nchild);
        if (!args)
            return NULL;
        for (int i = 0; i < nd->nchild; i++) {
            PyObject *f = PyObject_GetAttr(val, nd->names[i]);
            if (!f) {
                Py_DECREF(args);
                return NULL;
            }
            PyObject *c = copy_node(w, nd->child[i], f);
            Py_DECREF(f);
            if (!c) {
                Py_DECREF(args);
                return NULL;
            }
            PyTuple_SET_ITEM(args, i, c);
        }
        PyObject *out = PyObject_CallObject(nd->cls, args);
        Py_DECREF(args);
        return out;
    }
    case K_UNION: {
        if (nd->immutable) {
            Py_INCREF(val);
            return val;
        }
        PyObject *disc = PyObject_GetAttr(val, nd->names[0]);
        if (!disc)
            return NULL;
        PyObject *v = PyObject_GetAttr(val, nd->names[1]);
        if (!v) {
            Py_DECREF(disc);
            return NULL;
        }
        PyObject *slot = PyDict_GetItemWithError(nd->arms, disc);
        PyObject *nv;
        if (slot && (int)PyLong_AsLong(slot) >= 0) {
            nv = copy_node(w, (int)PyLong_AsLong(slot), v);
            Py_DECREF(v);
            if (!nv) {
                Py_DECREF(disc);
                return NULL;
            }
        } else {
            if (!slot && PyErr_Occurred()) {
                Py_DECREF(disc);
                Py_DECREF(v);
                return NULL;
            }
            if (!slot && !nd->a) {
                Py_DECREF(v);
                long long dv = PyLong_AsLongLong(disc);
                Py_DECREF(disc);
                xdr_err(w, "bad union discriminant %lld", dv);
                return NULL;
            }
            /* void arm (explicit or default): Python copy yields None */
            Py_DECREF(v);
            nv = Py_None;
            Py_INCREF(nv);
        }
        PyObject *out =
            PyObject_CallFunctionObjArgs(nd->cls, disc, nv, NULL);
        Py_DECREF(disc);
        Py_DECREF(nv);
        return out;
    }
    case K_DEPTH: {
        int *d = &w->depths[nd->depth_slot];
        if (++*d > nd->a) {
            --*d;
            xdr_err(w, "recursion deeper than %lld", nd->a);
            return NULL;
        }
        PyObject *out = copy_node(w, nd->child[0], val);
        --*d;
        return out;
    }
    }
    xdr_err(w, "corrupt program: unknown node kind");
    return NULL;
}

/* -- hot-field accessors (getfield / setfield) ----------------------- */
/* Walk the compiled spec over RAW XDR BYTES, skipping everything that is
 * not on the requested field path, and read (or patch, for fixed-width
 * scalars) the terminal value without a full unpack.  Path steps are
 * ints interpreted per node kind: struct = field index, union = EXPECTED
 * discriminant (mismatch raises XdrError), array = element index.
 * Option and depth nodes are transparent (consume no step); an absent
 * option on the path yields None from getfield and XdrError from
 * setfield.  Skipping bounds-checks lengths/counts exactly like the
 * unpacker (incl. the hostile-count guard) but does NOT validate padding
 * content or UTF-8 — getfield is an accessor, not a validator; full
 * validation stays with unpack. */

#define MAX_FIELD_PATH 16

static int
skip_node(Walk *w, int idx, Rd *rd)
{
    Node *nd = &w->prog->nodes[idx];
    switch (nd->kind) {
    case K_U32: case K_I32: case K_BOOL: case K_ENUM:
        if (rd_need(w, rd, 4, "scalar") < 0)
            return -1;
        rd->off += 4;
        return 0;
    case K_U64: case K_I64:
        if (rd_need(w, rd, 8, "scalar") < 0)
            return -1;
        rd->off += 8;
        return 0;
    case K_OPAQUE: {
        Py_ssize_t n = nd->a + (4 - (nd->a % 4)) % 4;
        if (rd_need(w, rd, n, "opaque") < 0)
            return -1;
        rd->off += n;
        return 0;
    }
    case K_VAROPAQUE:
    case K_STRING: {
        if (rd_need(w, rd, 4, "length") < 0)
            return -1;
        unsigned int n = rd_be32(rd);
        if (n > nd->a)
            return xdr_err(w, "opaque<%lld> length %u", nd->a, n);
        Py_ssize_t body = (Py_ssize_t)n + (4 - (n % 4)) % 4;
        if (rd_need(w, rd, body, "var opaque") < 0)
            return -1;
        rd->off += body;
        return 0;
    }
    case K_ARRAY: {
        for (long long i = 0; i < nd->a; i++) {
            if (skip_node(w, nd->child[0], rd) < 0)
                return -1;
        }
        return 0;
    }
    case K_VARARRAY: {
        if (rd_need(w, rd, 4, "array length") < 0)
            return -1;
        unsigned int n = rd_be32(rd);
        if (n > nd->a)
            return xdr_err(w, "array<%lld> length %u", nd->a, n);
        if ((Py_ssize_t)n > (rd->len - rd->off) / 4)
            return xdr_err(w, "short buffer for array of %u elements", n);
        for (unsigned int i = 0; i < n; i++) {
            if (skip_node(w, nd->child[0], rd) < 0)
                return -1;
        }
        return 0;
    }
    case K_OPTION: {
        if (rd_need(w, rd, 4, "option flag") < 0)
            return -1;
        unsigned int v = rd_be32(rd);
        if (v > 1)
            return xdr_err(w, "bad bool discriminant %u", v);
        return v ? skip_node(w, nd->child[0], rd) : 0;
    }
    case K_STRUCT: {
        for (int i = 0; i < nd->nchild; i++) {
            if (skip_node(w, nd->child[i], rd) < 0)
                return -1;
        }
        return 0;
    }
    case K_UNION: {
        if (rd_need(w, rd, 4, "discriminant") < 0)
            return -1;
        long dv = (long)(int)rd_be32(rd);
        PyObject *key;
        if (nd->sw_kind == 2)
            key = PyLong_FromUnsignedLong((unsigned long)(unsigned int)dv);
        else
            key = PyLong_FromLong(dv);
        if (!key)
            return -1;
        if (nd->sw_kind == 0) {
            int has = PyDict_Contains(nd->members, key);
            if (has <= 0) {
                Py_DECREF(key);
                return has < 0 ? -1
                               : xdr_err(w, "bad enum value %ld", dv);
            }
        }
        PyObject *slot = PyDict_GetItemWithError(nd->arms, key);
        Py_DECREF(key);
        int child = -2;
        if (slot) {
            child = (int)PyLong_AsLong(slot);
        } else if (PyErr_Occurred()) {
            return -1;
        } else if (!nd->a) {
            return xdr_err(w, "bad union discriminant %ld", dv);
        }
        return child >= 0 ? skip_node(w, child, rd) : 0;
    }
    case K_DEPTH: {
        int *d = &w->depths[nd->depth_slot];
        if (++*d > nd->a) {
            --*d;
            return xdr_err(w, "recursion deeper than %lld", nd->a);
        }
        int rc = skip_node(w, nd->child[0], rd);
        --*d;
        return rc;
    }
    }
    return xdr_err(w, "corrupt program: unknown node kind");
}

/* Walk to the terminal node of `path`.  Returns the terminal node index
 * with rd->off at its first byte, -1 on error, or -2 when an ABSENT
 * option was hit on/at the end of the path (getfield returns None). */
static int
walk_path(Walk *w, Rd *rd, const long long *path, int n_path)
{
    int idx = w->prog->root;
    int step = 0;
    for (;;) {
        Node *nd = &w->prog->nodes[idx];
        switch (nd->kind) {
        case K_DEPTH:
            idx = nd->child[0];
            continue;
        case K_OPTION: {
            if (rd_need(w, rd, 4, "option flag") < 0)
                return -1;
            unsigned int v = rd_be32(rd);
            if (v > 1) {
                xdr_err(w, "bad bool discriminant %u", v);
                return -1;
            }
            if (!v)
                return -2; /* absent on path */
            idx = nd->child[0];
            continue;
        }
        case K_STRUCT: {
            if (step >= n_path)
                return idx;
            long long k = path[step++];
            if (k < 0 || k >= nd->nchild) {
                xdr_err(w, "field index %lld out of range", k);
                return -1;
            }
            for (long long i = 0; i < k; i++) {
                if (skip_node(w, nd->child[i], rd) < 0)
                    return -1;
            }
            idx = nd->child[(int)k];
            continue;
        }
        case K_UNION: {
            if (step >= n_path)
                return idx;
            long long want = path[step++];
            if (rd_need(w, rd, 4, "discriminant") < 0)
                return -1;
            long dv = (long)(int)rd_be32(rd);
            long long got =
                nd->sw_kind == 2
                    ? (long long)(unsigned long)(unsigned int)dv
                    : (long long)dv;
            if (got != want) {
                xdr_err(w, "union arm mismatch: value carries %lld,"
                           " path expects %lld", got, want);
                return -1;
            }
            PyObject *key = PyLong_FromLongLong(got);
            if (!key)
                return -1;
            PyObject *slot = PyDict_GetItemWithError(nd->arms, key);
            Py_DECREF(key);
            if (!slot) {
                if (PyErr_Occurred())
                    return -1;
                xdr_err(w, "bad union discriminant %lld", got);
                return -1;
            }
            int child = (int)PyLong_AsLong(slot);
            if (child < 0) {
                xdr_err(w, "void union arm %lld on field path", got);
                return -1;
            }
            idx = child;
            continue;
        }
        case K_ARRAY:
        case K_VARARRAY: {
            if (step >= n_path)
                return idx;
            long long k = path[step++];
            Py_ssize_t n;
            if (nd->kind == K_ARRAY) {
                n = nd->a;
            } else {
                if (rd_need(w, rd, 4, "array length") < 0)
                    return -1;
                unsigned int ln = rd_be32(rd);
                if (ln > nd->a) {
                    xdr_err(w, "array<%lld> length %u", nd->a, ln);
                    return -1;
                }
                if ((Py_ssize_t)ln > (rd->len - rd->off) / 4) {
                    xdr_err(w, "short buffer for array of %u elements", ln);
                    return -1;
                }
                n = (Py_ssize_t)ln;
            }
            if (k < 0 || k >= n) {
                xdr_err(w, "array index %lld out of range (%zd)", k, n);
                return -1;
            }
            for (long long i = 0; i < k; i++) {
                if (skip_node(w, nd->child[0], rd) < 0)
                    return -1;
            }
            idx = nd->child[0];
            continue;
        }
        default:
            if (step < n_path) {
                xdr_err(w, "field path descends into a scalar");
                return -1;
            }
            return idx;
        }
    }
}

static int
parse_path_arg(PyObject *path, long long *out, int *n_out)
{
    if (!PyTuple_Check(path)) {
        PyErr_SetString(PyExc_TypeError, "path must be a tuple of ints");
        return -1;
    }
    Py_ssize_t n = PyTuple_GET_SIZE(path);
    if (n > MAX_FIELD_PATH) {
        PyErr_SetString(PyExc_ValueError, "field path too deep");
        return -1;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        out[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(path, i));
        if (out[i] == -1 && PyErr_Occurred())
            return -1;
    }
    *n_out = (int)n;
    return 0;
}

static PyObject *
cxdr_getfield(PyObject *self, PyObject *args)
{
    PyObject *cap, *path;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "Oy*O", &cap, &data, &path))
        return NULL;
    Program *p = PyCapsule_GetPointer(cap, "cxdrpack.program");
    long long steps[MAX_FIELD_PATH];
    int n_steps;
    if (!p || parse_path_arg(path, steps, &n_steps) < 0) {
        PyBuffer_Release(&data);
        return NULL;
    }
    Walk w;
    memset(&w, 0, sizeof w);
    w.prog = p;
    Rd rd = {data.buf, data.len, 0};
    int idx = walk_path(&w, &rd, steps, n_steps);
    PyObject *out = NULL;
    if (idx == -2) {
        out = Py_None;
        Py_INCREF(out);
    } else if (idx >= 0) {
        Node *nd = &p->nodes[idx];
        switch (nd->kind) {
        case K_U32: case K_I32: case K_U64: case K_I64: case K_BOOL:
        case K_ENUM: case K_OPAQUE: case K_VAROPAQUE: case K_STRING:
            out = unpack_node(&w, idx, &rd);
            break;
        case K_UNION: {
            /* terminal union: the path addresses the DISCRIMINANT (as a
             * plain int) without descending into an arm — the hot
             * statement-type read on the trusted post-verify envelope
             * plane (walk_path left rd at the union's first byte) */
            if (rd_need(&w, &rd, 4, "discriminant") < 0)
                break;
            long dv = (long)(int)rd_be32(&rd);
            if (nd->sw_kind == 2)
                out = PyLong_FromUnsignedLong(
                    (unsigned long)(unsigned int)dv);
            else
                out = PyLong_FromLong(dv);
            break;
        }
        default:
            xdr_err(&w, "field path does not end at a scalar");
        }
    }
    PyBuffer_Release(&data);
    return out;
}

static PyObject *
cxdr_setfield(PyObject *self, PyObject *args)
{
    PyObject *cap, *path, *val;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "Oy*OO", &cap, &data, &path, &val))
        return NULL;
    Program *p = PyCapsule_GetPointer(cap, "cxdrpack.program");
    long long steps[MAX_FIELD_PATH];
    int n_steps;
    if (!p || parse_path_arg(path, steps, &n_steps) < 0) {
        PyBuffer_Release(&data);
        return NULL;
    }
    Walk w;
    memset(&w, 0, sizeof w);
    w.prog = p;
    Rd rd = {data.buf, data.len, 0};
    int idx = walk_path(&w, &rd, steps, n_steps);
    if (idx == -2) {
        xdr_err(&w, "cannot set a field behind an absent option");
        idx = -1;
    }
    if (idx < 0) {
        PyBuffer_Release(&data);
        return NULL;
    }
    /* fixed-width terminals only: the patch must not change the length */
    Node *nd = &p->nodes[idx];
    char patch[8];
    Py_ssize_t width = 0;
    switch (nd->kind) {
    case K_U32: {
        unsigned long long v;
        if (as_ulonglong(&w, val, &v, "uint32") < 0)
            break;
        if (v > 0xFFFFFFFFULL) {
            xdr_err(&w, "uint32 out of range: %llu", v);
            break;
        }
        put_be32(patch, (unsigned int)v);
        width = 4;
        break;
    }
    case K_I32: {
        long long v;
        if (as_longlong(&w, val, &v, "int32") < 0)
            break;
        if (v < -2147483648LL || v > 2147483647LL) {
            xdr_err(&w, "int32 out of range: %lld", v);
            break;
        }
        put_be32(patch, (unsigned int)(long)v);
        width = 4;
        break;
    }
    case K_U64: {
        unsigned long long v;
        if (as_ulonglong(&w, val, &v, "uint64") < 0)
            break;
        put_be64(patch, v);
        width = 8;
        break;
    }
    case K_I64: {
        long long v;
        if (as_longlong(&w, val, &v, "int64") < 0)
            break;
        put_be64(patch, (unsigned long long)v);
        width = 8;
        break;
    }
    case K_BOOL: {
        int t = PyObject_IsTrue(val);
        if (t < 0)
            break;
        put_be32(patch, t ? 1u : 0u);
        width = 4;
        break;
    }
    case K_ENUM: {
        long long v;
        if (as_longlong(&w, val, &v, "enum") < 0)
            break;
        int has = PyDict_Contains(nd->members, val);
        if (has < 0)
            break;
        if (!has) {
            xdr_err(&w, "bad enum value %lld", v);
            break;
        }
        put_be32(patch, (unsigned int)(long)v);
        width = 4;
        break;
    }
    case K_OPAQUE: {
        /* patched in place below from the buffer (can exceed 8 bytes) */
        Py_buffer b;
        if (PyObject_GetBuffer(val, &b, PyBUF_SIMPLE) < 0) {
            PyErr_Clear();
            xdr_err(&w, "opaque[%lld]: bytes expected, got %.80s",
                    nd->a, Py_TYPE(val)->tp_name);
            break;
        }
        if (b.len != nd->a) {
            PyBuffer_Release(&b);
            xdr_err(&w, "opaque[%lld] got %zd bytes", nd->a, b.len);
            break;
        }
        if (rd.off + nd->a > rd.len) {
            PyBuffer_Release(&b);
            xdr_err(&w, "short buffer for opaque");
            break;
        }
        PyObject *out = PyBytes_FromStringAndSize(
            (const char *)data.buf, data.len);
        if (out)
            memcpy(PyBytes_AS_STRING(out) + rd.off, b.buf, nd->a);
        PyBuffer_Release(&b);
        PyBuffer_Release(&data);
        return out;
    }
    default:
        xdr_err(&w, "setfield terminal must be a fixed-width scalar");
    }
    if (!width) {
        PyBuffer_Release(&data);
        return NULL;
    }
    if (rd.off + width > rd.len) {
        xdr_err(&w, "short buffer for scalar");
        PyBuffer_Release(&data);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)data.buf,
                                              data.len);
    if (out)
        memcpy(PyBytes_AS_STRING(out) + rd.off, patch, width);
    PyBuffer_Release(&data);
    return out;
}

/* ---------------------------------------------------------------- */

static void
program_free(Program *p)
{
    if (!p)
        return;
    for (int i = 0; i < p->n_nodes; i++) {
        Node *nd = &p->nodes[i];
        PyMem_Free(nd->child);
        if (nd->names) {
            for (int j = 0; j < nd->nchild; j++)
                Py_XDECREF(nd->names[j]);
            if (nd->kind == K_UNION) {
                Py_XDECREF(nd->names[0]);
                Py_XDECREF(nd->names[1]);
            }
            PyMem_Free(nd->names);
        }
        Py_XDECREF(nd->members);
        Py_XDECREF(nd->arms);
        Py_XDECREF(nd->cls);
    }
    PyMem_Free(p->nodes);
    Py_XDECREF(p->xdr_error);
    PyMem_Free(p);
}

static void
capsule_destroy(PyObject *cap)
{
    program_free(PyCapsule_GetPointer(cap, "cxdrpack.program"));
}

/* Parse one node spec tuple into nodes[i].  Returns 0 / -1. */
static int
parse_node(Program *p, int i, PyObject *spec, int *depth_counter)
{
    Node *nd = &p->nodes[i];
    if (!PyTuple_Check(spec) || PyTuple_GET_SIZE(spec) < 1) {
        PyErr_SetString(PyExc_ValueError, "node spec must be a tuple");
        return -1;
    }
    const char *tag = PyUnicode_AsUTF8(PyTuple_GET_ITEM(spec, 0));
    if (!tag)
        return -1;

#define REQ(n)                                                        \
    do {                                                              \
        if (PyTuple_GET_SIZE(spec) != (n)) {                          \
            PyErr_Format(PyExc_ValueError, "bad %s spec arity", tag); \
            return -1;                                                \
        }                                                             \
    } while (0)

    if (!strcmp(tag, "u32")) { REQ(1); nd->kind = K_U32; return 0; }
    if (!strcmp(tag, "i32")) { REQ(1); nd->kind = K_I32; return 0; }
    if (!strcmp(tag, "u64")) { REQ(1); nd->kind = K_U64; return 0; }
    if (!strcmp(tag, "i64")) { REQ(1); nd->kind = K_I64; return 0; }
    if (!strcmp(tag, "bool")) { REQ(1); nd->kind = K_BOOL; return 0; }
    if (!strcmp(tag, "enum")) {
        /* ("enum", members_dict) — the validation set is the dict's keys */
        REQ(2);
        nd->kind = K_ENUM;
        nd->members = PyTuple_GET_ITEM(spec, 1);
        if (!PyDict_Check(nd->members)) {
            PyErr_SetString(PyExc_ValueError, "enum members must be a dict");
            nd->members = NULL;
            return -1;
        }
        Py_INCREF(nd->members);
        return 0;
    }
    if (!strcmp(tag, "opaque") || !strcmp(tag, "varopaque") ||
        !strcmp(tag, "string")) {
        REQ(2);
        nd->kind = !strcmp(tag, "opaque")      ? K_OPAQUE
                   : !strcmp(tag, "varopaque") ? K_VAROPAQUE
                                               : K_STRING;
        nd->a = PyLong_AsLongLong(PyTuple_GET_ITEM(spec, 1));
        if (nd->a == -1 && PyErr_Occurred())
            return -1;
        return 0;
    }
    if (!strcmp(tag, "array") || !strcmp(tag, "vararray")) {
        REQ(3);
        nd->kind = !strcmp(tag, "array") ? K_ARRAY : K_VARARRAY;
        nd->a = PyLong_AsLongLong(PyTuple_GET_ITEM(spec, 1));
        if (nd->a == -1 && PyErr_Occurred())
            return -1;
        nd->child = PyMem_Malloc(sizeof(int));
        if (!nd->child)
            return -1;
        nd->nchild = 1;
        nd->child[0] = (int)PyLong_AsLong(PyTuple_GET_ITEM(spec, 2));
        return 0;
    }
    if (!strcmp(tag, "option")) {
        REQ(2);
        nd->kind = K_OPTION;
        nd->child = PyMem_Malloc(sizeof(int));
        if (!nd->child)
            return -1;
        nd->nchild = 1;
        nd->child[0] = (int)PyLong_AsLong(PyTuple_GET_ITEM(spec, 1));
        return 0;
    }
    if (!strcmp(tag, "struct")) {
        /* ("struct", names, kids, cls, immutable) */
        REQ(5);
        nd->kind = K_STRUCT;
        nd->cls = PyTuple_GET_ITEM(spec, 3);
        Py_INCREF(nd->cls);
        nd->immutable = (int)PyLong_AsLong(PyTuple_GET_ITEM(spec, 4));
        PyObject *names = PyTuple_GET_ITEM(spec, 1);
        PyObject *kids = PyTuple_GET_ITEM(spec, 2);
        int n = (int)PyTuple_GET_SIZE(names);
        nd->nchild = n;
        nd->child = PyMem_Malloc(sizeof(int) * (n ? n : 1));
        nd->names = PyMem_Calloc(n ? n : 1, sizeof(PyObject *));
        if (!nd->child || !nd->names)
            return -1;
        for (int j = 0; j < n; j++) {
            PyObject *nm = PyTuple_GET_ITEM(names, j);
            Py_INCREF(nm);
            PyUnicode_InternInPlace(&nm);
            nd->names[j] = nm;
            nd->child[j] = (int)PyLong_AsLong(PyTuple_GET_ITEM(kids, j));
        }
        return 0;
    }
    if (!strcmp(tag, "union")) {
        /* ("union", sw_spec, arms_dict, default_void, cls, immutable) */
        REQ(6);
        nd->kind = K_UNION;
        nd->cls = PyTuple_GET_ITEM(spec, 4);
        Py_INCREF(nd->cls);
        nd->immutable = (int)PyLong_AsLong(PyTuple_GET_ITEM(spec, 5));
        PyObject *sw = PyTuple_GET_ITEM(spec, 1);
        const char *swtag = PyUnicode_AsUTF8(PyTuple_GET_ITEM(sw, 0));
        if (!swtag)
            return -1;
        if (!strcmp(swtag, "enum")) {
            nd->sw_kind = 0;
            nd->members = PyTuple_GET_ITEM(sw, 1);
            if (!PyDict_Check(nd->members)) {
                PyErr_SetString(PyExc_ValueError,
                                "enum members must be a dict");
                nd->members = NULL;
                return -1;
            }
            Py_INCREF(nd->members);
        } else if (!strcmp(swtag, "i32")) {
            nd->sw_kind = 1;
        } else if (!strcmp(swtag, "u32")) {
            nd->sw_kind = 2;
        } else {
            PyErr_Format(PyExc_ValueError, "bad union switch %s", swtag);
            return -1;
        }
        PyObject *arms = PyTuple_GET_ITEM(spec, 2);
        if (!PyDict_Check(arms)) {
            PyErr_SetString(PyExc_ValueError, "union arms must be a dict");
            return -1;
        }
        Py_INCREF(arms);
        nd->arms = arms;
        nd->a = PyLong_AsLong(PyTuple_GET_ITEM(spec, 3)); /* default_void */
        /* names[0]=".type", names[1]=".value" */
        nd->nchild = 0;
        nd->names = PyMem_Calloc(2, sizeof(PyObject *));
        if (!nd->names)
            return -1;
        nd->names[0] = PyUnicode_InternFromString("type");
        nd->names[1] = PyUnicode_InternFromString("value");
        return (nd->names[0] && nd->names[1]) ? 0 : -1;
    }
    if (!strcmp(tag, "depth")) {
        REQ(3);
        nd->kind = K_DEPTH;
        nd->a = PyLong_AsLongLong(PyTuple_GET_ITEM(spec, 1));
        nd->child = PyMem_Malloc(sizeof(int));
        if (!nd->child)
            return -1;
        nd->nchild = 1;
        nd->child[0] = (int)PyLong_AsLong(PyTuple_GET_ITEM(spec, 2));
        if (*depth_counter >= MAX_DEPTH_SLOTS) {
            PyErr_SetString(PyExc_ValueError, "too many depth guards");
            return -1;
        }
        nd->depth_slot = (*depth_counter)++;
        return 0;
    }
    PyErr_Format(PyExc_ValueError, "unknown node tag %s", tag);
    return -1;
#undef REQ
}

static PyObject *
cxdr_compile(PyObject *self, PyObject *args)
{
    PyObject *defs, *xdr_error;
    int root;
    if (!PyArg_ParseTuple(args, "O!iO", &PyList_Type, &defs, &root,
                          &xdr_error))
        return NULL;
    int n = (int)PyList_GET_SIZE(defs);
    Program *p = PyMem_Calloc(1, sizeof(Program));
    if (!p)
        return PyErr_NoMemory();
    p->nodes = PyMem_Calloc(n ? n : 1, sizeof(Node));
    if (!p->nodes) {
        PyMem_Free(p);
        return PyErr_NoMemory();
    }
    p->n_nodes = n;
    p->root = root;
    Py_INCREF(xdr_error);
    p->xdr_error = xdr_error;
    int depth_counter = 0;
    for (int i = 0; i < n; i++) {
        if (parse_node(p, i, PyList_GET_ITEM(defs, i), &depth_counter) < 0) {
            program_free(p);
            return NULL;
        }
    }
    p->n_depth_slots = depth_counter;
    /* validate child indices so pack can skip bounds checks */
    for (int i = 0; i < n; i++) {
        Node *nd = &p->nodes[i];
        for (int j = 0; j < nd->nchild; j++) {
            if (nd->kind != K_UNION &&
                (nd->child[j] < 0 || nd->child[j] >= n)) {
                PyErr_SetString(PyExc_ValueError, "child index out of range");
                program_free(p);
                return NULL;
            }
        }
        if (nd->kind == K_UNION) {
            PyObject *k, *v;
            Py_ssize_t pos = 0;
            while (PyDict_Next(nd->arms, &pos, &k, &v)) {
                long c = PyLong_AsLong(v);
                if ((c < -1 || c >= n) ||
                    (c == -1 && PyErr_Occurred())) {
                    PyErr_SetString(PyExc_ValueError,
                                    "union arm index out of range");
                    program_free(p);
                    return NULL;
                }
            }
        }
    }
    if (root < 0 || root >= n) {
        PyErr_SetString(PyExc_ValueError, "root index out of range");
        program_free(p);
        return NULL;
    }
    return PyCapsule_New(p, "cxdrpack.program", capsule_destroy);
}

static PyObject *
cxdr_pack(PyObject *self, PyObject *args)
{
    PyObject *cap, *val;
    if (!PyArg_ParseTuple(args, "OO", &cap, &val))
        return NULL;
    Program *p = PyCapsule_GetPointer(cap, "cxdrpack.program");
    if (!p)
        return NULL;
    Walk w;
    memset(&w, 0, sizeof w);
    w.prog = p;
    if (pack_node(&w, p->root, val) < 0) {
        PyMem_Free(w.buf);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
}

/* pack_many(program, sequence, frames) -> bytes: every element packed
 * back-to-back into ONE buffer (one C entry, one bytes allocation for
 * the whole batch).  frames != 0 prefixes each record with the RFC 5531
 * record mark (len | 0x80000000) — the XDR file-stream framing, so a
 * bucket batch hashes and writes as a single buffer.  A malformed
 * element raises XdrError and the partial buffer is discarded. */
static PyObject *
cxdr_pack_many(PyObject *self, PyObject *args)
{
    PyObject *cap, *seq;
    int frames = 0;
    if (!PyArg_ParseTuple(args, "OO|i", &cap, &seq, &frames))
        return NULL;
    Program *p = PyCapsule_GetPointer(cap, "cxdrpack.program");
    if (!p)
        return NULL;
    PyObject *fast = PySequence_Fast(seq, "pack_many needs a sequence");
    if (!fast)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    Walk w;
    memset(&w, 0, sizeof w);
    w.prog = p;
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_ssize_t mark = w.len;
        if (frames) {
            if (ensure(&w, 4) < 0)
                goto fail;
            w.len += 4; /* record mark back-patched below */
        }
        if (pack_node(&w, p->root, PySequence_Fast_GET_ITEM(fast, i)) < 0)
            goto fail;
        if (frames) {
            Py_ssize_t body = w.len - mark - 4;
            if (body >= 0x80000000LL) {
                xdr_err(&w, "record too large");
                goto fail;
            }
            put_be32(w.buf + mark, (unsigned int)body | 0x80000000u);
        }
    }
    Py_DECREF(fast);
    PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
fail:
    Py_DECREF(fast);
    PyMem_Free(w.buf);
    return NULL;
}

static PyObject *
cxdr_copy(PyObject *self, PyObject *args)
{
    PyObject *cap, *val;
    if (!PyArg_ParseTuple(args, "OO", &cap, &val))
        return NULL;
    Program *p = PyCapsule_GetPointer(cap, "cxdrpack.program");
    if (!p)
        return NULL;
    Walk w;
    memset(&w, 0, sizeof w);
    w.prog = p;
    return copy_node(&w, p->root, val);
}

static PyObject *
cxdr_unpack(PyObject *self, PyObject *args)
{
    PyObject *cap;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "Oy*", &cap, &data))
        return NULL;
    Program *p = PyCapsule_GetPointer(cap, "cxdrpack.program");
    if (!p) {
        PyBuffer_Release(&data);
        return NULL;
    }
    Walk w;
    memset(&w, 0, sizeof w);
    w.prog = p;
    Rd rd = {data.buf, data.len, 0};
    PyObject *out = unpack_node(&w, p->root, &rd);
    if (out && rd.off != rd.len) {
        Py_DECREF(out);
        out = NULL;
        xdr_err(&w, "trailing bytes: consumed %zd of %zd", rd.off, rd.len);
    }
    PyBuffer_Release(&data);
    return out;
}

static PyMethodDef methods[] = {
    {"compile", cxdr_compile, METH_VARARGS,
     "compile(defs_list, root_index, xdr_error_cls) -> program capsule"},
    {"pack", cxdr_pack, METH_VARARGS,
     "pack(program, value) -> bytes"},
    {"pack_many", cxdr_pack_many, METH_VARARGS,
     "pack_many(program, sequence, frames=0) -> bytes: all elements"
     " packed into one buffer; frames prefixes RFC 5531 record marks"},
    {"copy", cxdr_copy, METH_VARARGS,
     "copy(program, value) -> structural copy sharing immutable subtrees"},
    {"unpack", cxdr_unpack, METH_VARARGS,
     "unpack(program, bytes) -> decoded value; XdrError on malformed or"
     " trailing bytes"},
    {"getfield", cxdr_getfield, METH_VARARGS,
     "getfield(program, bytes, path_tuple) -> scalar at the field path"
     " (None for an absent option); XdrError on malformed bytes, union"
     " arm mismatch, or a non-scalar path"},
    {"setfield", cxdr_setfield, METH_VARARGS,
     "setfield(program, bytes, path_tuple, value) -> new bytes with the"
     " fixed-width scalar at the field path patched in place"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_cxdrpack", NULL, -1, methods,
};

PyMODINIT_FUNC
PyInit__cxdrpack(void)
{
    return PyModule_Create(&moduledef);
}
