/* Native corpus packer (a copy of the JAX package's native/packer.c, so the
 * port imports nothing of that package).
 *
 * Parses a whitespace-tokenized text file of integer token sequences (the
 * on-disk caption format, data/io.py) into one contiguous padded int32
 * buffer and a lengths vector in a single pass, with no allocation per
 * token.
 *
 * A CPython extension; the wrapper in native/__init__.py turns the returned
 * bytes into numpy arrays and falls back to pure Python when the extension
 * is not built.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int32_t *data;
    size_t len;
    size_t cap;
} vec_i32;

static int vec_push(vec_i32 *v, int32_t x) {
    if (v->len == v->cap) {
        size_t ncap = v->cap ? v->cap * 2 : 4096;
        int32_t *nd = (int32_t *)realloc(v->data, ncap * sizeof(int32_t));
        if (!nd) return -1;
        v->data = nd;
        v->cap = ncap;
    }
    v->data[v->len++] = x;
    return 0;
}

/* pack_tokens(path: str, pad_multiple: int = 1)
 *   -> (padded: bytes, n: int, max_len: int, lengths: bytes, vocab_max: int)
 */
static PyObject *pack_tokens(PyObject *self, PyObject *args) {
    const char *path;
    Py_ssize_t pad_multiple = 1;
    if (!PyArg_ParseTuple(args, "s|n", &path, &pad_multiple)) return NULL;
    if (pad_multiple < 1) pad_multiple = 1;

    FILE *f = fopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }

    vec_i32 flat = {0}, lens = {0};
    int32_t cur_len = 0, vocab_max = 0;
    long cur_tok = -1; /* -1: not in a token */
    int in_line = 0;
    int err = 0;

    char buf[1 << 16];
    size_t got;
    Py_BEGIN_ALLOW_THREADS
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0 && !err) {
        for (size_t i = 0; i < got; i++) {
            unsigned char c = buf[i];
            if (c >= '0' && c <= '9') {
                cur_tok = (cur_tok < 0 ? 0 : cur_tok) * 10 + (c - '0');
                in_line = 1;
            } else {
                if (cur_tok >= 0) {
                    if (vec_push(&flat, (int32_t)cur_tok)) { err = 1; break; }
                    if (cur_tok > vocab_max) vocab_max = (int32_t)cur_tok;
                    cur_len++;
                    cur_tok = -1;
                }
                if (c == '\n') {
                    if (in_line) {
                        if (vec_push(&lens, cur_len)) { err = 1; break; }
                    }
                    cur_len = 0;
                    in_line = 0;
                }
            }
        }
    }
    /* trailing token / line without newline */
    if (!err && cur_tok >= 0) {
        if (vec_push(&flat, (int32_t)cur_tok)) err = 1;
        if (cur_tok > vocab_max) vocab_max = (int32_t)cur_tok;
        cur_len++;
        in_line = 1;
    }
    if (!err && in_line) {
        if (vec_push(&lens, cur_len)) err = 1;
    }
    Py_END_ALLOW_THREADS
    fclose(f);

    if (err) {
        free(flat.data);
        free(lens.data);
        return PyErr_NoMemory();
    }

    size_t n = lens.len;
    size_t max_len = 0;
    for (size_t i = 0; i < n; i++)
        if ((size_t)lens.data[i] > max_len) max_len = lens.data[i];
    max_len = ((max_len + pad_multiple - 1) / pad_multiple) * pad_multiple;
    if (max_len == 0) max_len = (size_t)pad_multiple;

    PyObject *padded = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(n * max_len * 4));
    if (!padded) {
        free(flat.data);
        free(lens.data);
        return NULL;
    }
    int32_t *out = (int32_t *)PyBytes_AS_STRING(padded);
    memset(out, 0, n * max_len * 4);
    size_t off = 0;
    for (size_t i = 0; i < n; i++) {
        memcpy(out + i * max_len, flat.data + off, (size_t)lens.data[i] * 4);
        off += (size_t)lens.data[i];
    }

    PyObject *lengths = PyBytes_FromStringAndSize((const char *)lens.data,
                                                  (Py_ssize_t)(n * 4));
    free(flat.data);
    free(lens.data);
    if (!lengths) {
        Py_DECREF(padded);
        return NULL;
    }

    PyObject *res = Py_BuildValue("(NnnNi)", padded, (Py_ssize_t)n,
                                  (Py_ssize_t)max_len, lengths, vocab_max);
    return res;
}

static PyMethodDef Methods[] = {
    {"pack_tokens", pack_tokens, METH_VARARGS,
     "Parse integer-token lines into (padded int32 bytes, n, max_len, "
     "lengths bytes, vocab_max)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_packer", "Native corpus packer", -1, Methods,
};

PyMODINIT_FUNC PyInit__packer(void) { return PyModule_Create(&moduledef); }
