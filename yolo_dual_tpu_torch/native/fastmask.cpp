// Fast parser for the JSON dense-mask records used by the semantic pipeline
// (the port's copy of yolo_dual_tpu/native/fastmask.cpp).
//
// The reference framework's data-side hot loop is JSON parsing of
// {"shape": [h, w], ..., "mask_data": [int, int, ...]} per sample
// (reference unet-lite/Resnet50/seg_diceloss_Resnet50.py:302-324 — SURVEY §3.1
// flags it as the known CPU bottleneck). This is the native-runtime analog of
// the reference's C++ tier: a single-pass scanner that extracts `shape` and
// decodes `mask_data` straight into a uint8 buffer, ~30-100x faster than
// json.loads for large masks.
//
// Exposed via the CPython C API (no pybind11 in this image):
//   fastmask.parse_mask_json(data: bytes) -> (height, width, mask: bytes)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

const char* find_key(const char* p, const char* end, const char* key) {
    size_t klen = strlen(key);
    const char* cur = p;
    while (cur + klen < end) {
        cur = (const char*)memchr(cur, '"', end - cur);
        if (!cur) return nullptr;
        ++cur;
        if ((size_t)(end - cur) >= klen && memcmp(cur, key, klen) == 0 && cur[klen] == '"') {
            return cur + klen + 1;  // past closing quote
        }
    }
    return nullptr;
}

const char* skip_to(const char* p, const char* end, char c) {
    while (p < end && *p != c) ++p;
    return p < end ? p + 1 : nullptr;
}

// parse ascii non-negative integer; returns next position
const char* parse_int(const char* p, const char* end, long* out) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r' || *p == ',')) ++p;
    if (p >= end) return nullptr;
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
    }
    *out = neg ? -v : v;
    return p;
}

PyObject* parse_mask_json(PyObject*, PyObject* args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
    const char* p = (const char*)buf.buf;
    const char* end = p + buf.len;

    long h = 0, w = 0;
    const char* sp = find_key(p, end, "shape");
    if (!sp) { PyBuffer_Release(&buf); PyErr_SetString(PyExc_ValueError, "no 'shape' key"); return nullptr; }
    sp = skip_to(sp, end, '[');
    if (!sp || !(sp = parse_int(sp, end, &h)) || !(sp = parse_int(sp, end, &w))) {
        PyBuffer_Release(&buf); PyErr_SetString(PyExc_ValueError, "bad 'shape'"); return nullptr;
    }
    if (h <= 0 || w <= 0 || h * w > (1L << 31)) {
        PyBuffer_Release(&buf); PyErr_SetString(PyExc_ValueError, "invalid mask shape"); return nullptr;
    }

    const char* mp = find_key(p, end, "mask_data");
    if (!mp) { PyBuffer_Release(&buf); PyErr_SetString(PyExc_ValueError, "no 'mask_data' key"); return nullptr; }
    mp = skip_to(mp, end, '[');
    if (!mp) { PyBuffer_Release(&buf); PyErr_SetString(PyExc_ValueError, "bad 'mask_data'"); return nullptr; }

    Py_ssize_t n = (Py_ssize_t)(h * w);
    PyObject* out = PyBytes_FromStringAndSize(nullptr, n);
    if (!out) { PyBuffer_Release(&buf); return nullptr; }
    uint8_t* dst = (uint8_t*)PyBytes_AS_STRING(out);

    Py_BEGIN_ALLOW_THREADS
    const char* cur = mp;
    for (Py_ssize_t i = 0; i < n && cur; ++i) {
        long v;
        cur = parse_int(cur, end, &v);
        if (!cur) { n = i; break; }
        dst[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&buf);
    if (n != (Py_ssize_t)(h * w)) {
        Py_DECREF(out);
        PyErr_SetString(PyExc_ValueError, "mask_data shorter than shape");
        return nullptr;
    }
    return Py_BuildValue("llN", h, w, out);
}

PyMethodDef methods[] = {
    {"parse_mask_json", parse_mask_json, METH_VARARGS,
     "parse_mask_json(data: bytes) -> (h, w, mask_bytes)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastmask", "fast JSON dense-mask parser",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_fastmask(void) { return PyModule_Create(&moduledef); }
