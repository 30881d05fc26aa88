// grok_tpu C ABI implementation: embeds (or attaches to) the CPython
// runtime and drives the grok_tpu package. Reference parity: grok.h/
// grok.cpp public API (codec objects, ref-counted images, stream write
// callbacks, message handlers), re-based on this framework's Python core.
//
// Threading model: gktpu_initialize() leaves the GIL released; every entry
// point takes it with PyGILState_Ensure, so the API is callable from any
// thread of a C host and from inside a Python host process alike.

#include "grok_tpu_c.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>
#include <unistd.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

PyObject* g_mod = nullptr;        // the grok_tpu module
bool g_we_initialized = false;    // we own the interpreter
PyThreadState* g_saved = nullptr; // main thread state while GIL released

thread_local std::string t_err;

gktpu_msg_fn g_info = nullptr, g_warn = nullptr, g_error = nullptr;
void* g_msg_user = nullptr;

void set_err_from_python() {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    t_err = "python error";
    if (value) {
        if (PyObject* s = PyObject_Str(value)) {
            if (const char* c = PyUnicode_AsUTF8(s)) t_err = c;
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

struct Gil {
    PyGILState_STATE st;
    Gil() { st = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(st); }
};

// repo root = the nearest ancestor of this .so's directory that holds the
// grok_tpu package (the library is built under native/build/<key>/)
std::string repo_root() {
    Dl_info info;
    if (dladdr((void*)&repo_root, &info) && info.dli_fname) {
        std::string p = info.dli_fname;
        for (auto cut = p.rfind('/'); cut != std::string::npos && cut > 0;
             cut = p.rfind('/')) {
            p.resize(cut);
            if (access((p + "/grok_tpu/__init__.py").c_str(), F_OK) == 0)
                return p;
        }
    }
    return ".";
}

// ---------------------------------------------------------------- images
}  // namespace

struct gktpu_image {
    std::atomic<int> refs{1};
    uint32_t w = 0, h = 0, nc = 0, prec = 8;
    int32_t sgnd = 0;
    int32_t** planes = nullptr;
};

namespace {

gktpu_image* image_alloc(uint32_t w, uint32_t h, uint32_t nc, uint32_t prec,
                         int32_t sgnd, bool zero) {
    if (!w || !h || !nc || nc > 16 || prec < 1 || prec > 16) return nullptr;
    auto* im = new gktpu_image();
    im->w = w;
    im->h = h;
    im->nc = nc;
    im->prec = prec;
    im->sgnd = sgnd ? 1 : 0;
    im->planes = new int32_t*[nc];
    for (uint32_t c = 0; c < nc; c++) {
        size_t n = (size_t)w * h;
        im->planes[c] = (int32_t*)(zero ? calloc(n, 4) : malloc(n * 4));
        if (!im->planes[c]) {
            for (uint32_t k = 0; k < c; k++) free(im->planes[k]);
            delete[] im->planes;
            delete im;
            return nullptr;
        }
    }
    return im;
}

// message handler trampoline: a Python callable that forwards to the C fn
PyObject* msg_trampoline(PyObject* self, PyObject* args) {
    const char* msg = nullptr;
    if (!PyArg_ParseTuple(args, "s", &msg)) return nullptr;
    auto which = (intptr_t)PyCapsule_GetPointer(self, nullptr);
    gktpu_msg_fn fn = which == 0 ? g_info : (which == 1 ? g_warn : g_error);
    if (fn) fn(msg, g_msg_user);
    Py_RETURN_NONE;
}

PyMethodDef g_msg_def = {"_gktpu_msg", msg_trampoline, METH_VARARGS, nullptr};

// build a Python CompressParams/DecompressParams from the C structs
PyObject* make_cparams(const gktpu_cparams* p) {
    PyObject* kwargs = PyDict_New();
    if (!kwargs) return nullptr;
    auto seti = [&](const char* k, long v) {
        PyObject* o = PyLong_FromLong(v);
        PyDict_SetItemString(kwargs, k, o);
        Py_DECREF(o);
    };
    seti("num_resolutions", p->num_resolutions ? p->num_resolutions : 6);
    if (p->cblk_w) seti("cblk_width", p->cblk_w);
    if (p->cblk_h) seti("cblk_height", p->cblk_h);
    if (p->irreversible) seti("irreversible", 1);
    if (p->ht) seti("ht", 1);
    if (p->mct >= 0) seti("mct", p->mct);
    if (p->cblk_style) seti("cblk_style", p->cblk_style);
    if (p->num_layers > 1) {
        seti("num_layers", p->num_layers);
        PyObject* rates = PyList_New(0);
        for (uint32_t i = 0; i < p->num_layers && i < 16; i++) {
            PyObject* r = PyFloat_FromDouble(p->layer_rates[i]);
            PyList_Append(rates, r);
            Py_DECREF(r);
        }
        PyDict_SetItemString(kwargs, "layer_rates", rates);
        Py_DECREF(rates);
    } else if (p->num_layers == 1 && p->layer_rates[0] > 0) {
        seti("num_layers", 1);
        PyObject* rates = Py_BuildValue("[d]", p->layer_rates[0]);
        PyDict_SetItemString(kwargs, "layer_rates", rates);
        Py_DECREF(rates);
    }
    if (p->progression[0]) {
        PyObject* o = PyUnicode_FromString(p->progression);
        PyDict_SetItemString(kwargs, "progression", o);
        Py_DECREF(o);
    }
    if (p->tile_w && p->tile_h) {
        PyObject* o = Py_BuildValue("(II)", p->tile_w, p->tile_h);
        PyDict_SetItemString(kwargs, "tile_size", o);
        Py_DECREF(o);
    }
    PyObject* cls = PyObject_GetAttrString(g_mod, "CompressParams");
    if (!cls) {
        Py_DECREF(kwargs);
        return nullptr;
    }
    PyObject* empty = PyTuple_New(0);
    PyObject* obj = PyObject_Call(cls, empty, kwargs);
    Py_DECREF(empty);
    Py_DECREF(cls);
    Py_DECREF(kwargs);
    return obj;
}

// numpy (h, w, nc) int32 array from the C image, via grok_tpu's numpy
PyObject* image_to_ndarray(const gktpu_image* img) {
    PyObject* np = PyImport_ImportModule("numpy");
    if (!np) return nullptr;
    PyObject* arr = nullptr;
    PyObject* planes = PyList_New(0);
    for (uint32_t c = 0; c < img->nc; c++) {
        PyObject* mv = PyMemoryView_FromMemory(
            (char*)img->planes[c], (Py_ssize_t)img->w * img->h * 4, PyBUF_READ);
        PyObject* flat = PyObject_CallMethod(np, "frombuffer", "Os", mv,
                                             "int32");
        Py_DECREF(mv);
        if (!flat) {
            Py_DECREF(planes);
            Py_DECREF(np);
            return nullptr;
        }
        PyObject* plane = PyObject_CallMethod(flat, "reshape", "(II)", img->h,
                                              img->w);
        Py_DECREF(flat);
        PyList_Append(planes, plane);
        Py_DECREF(plane);
    }
    arr = PyObject_CallMethod(np, "stack", "Oi", planes, -1);
    Py_DECREF(planes);
    Py_DECREF(np);
    return arr;  // (h, w, nc) int32, last axis stacked
}

PyObject* gk_image_from_c(const gktpu_image* img) {
    PyObject* arr = image_to_ndarray(img);
    if (!arr) return nullptr;
    PyObject* cls = PyObject_GetAttrString(g_mod, "Image");
    if (!cls) {
        Py_DECREF(arr);
        return nullptr;
    }
    PyObject* im = PyObject_CallMethod(cls, "from_array", "OII", arr,
                                       img->prec, img->sgnd);
    Py_DECREF(cls);
    Py_DECREF(arr);
    return im;
}

}  // namespace

// ------------------------------------------------------------ public API
extern "C" {

int gktpu_initialize(void) {
    if (g_mod) return 0;
    if (!Py_IsInitialized()) {
        PyConfig cfg;
        PyConfig_InitPythonConfig(&cfg);
        cfg.parse_argv = 0;
        cfg.install_signal_handlers = 0;
        PyStatus st = Py_InitializeFromConfig(&cfg);
        PyConfig_Clear(&cfg);
        if (PyStatus_Exception(st)) {
            t_err = "python runtime init failed";
            return 1;
        }
        g_we_initialized = true;
    }
    {
        Gil gil;
        // make the package importable from the repo that owns this .so
        PyObject* sys_path = PySys_GetObject("path");  // borrowed
        if (sys_path) {
            PyObject* root = PyUnicode_FromString(repo_root().c_str());
            bool have = false;
            for (Py_ssize_t i = 0; i < PyList_Size(sys_path); i++) {
                if (PyObject_RichCompareBool(PyList_GetItem(sys_path, i), root,
                                             Py_EQ) == 1) {
                    have = true;
                    break;
                }
            }
            if (!have) PyList_Append(sys_path, root);
            Py_DECREF(root);
        }
        g_mod = PyImport_ImportModule("grok_tpu");
        if (!g_mod) {
            set_err_from_python();
            return 1;
        }
    }
    if (g_we_initialized && !g_saved) g_saved = PyEval_SaveThread();
    return 0;
}

void gktpu_deinitialize(void) {
    if (!g_we_initialized) return;
    if (g_saved) {
        PyEval_RestoreThread(g_saved);
        g_saved = nullptr;
    }
    Py_XDECREF(g_mod);
    g_mod = nullptr;
    Py_FinalizeEx();
    g_we_initialized = false;
}

const char* gktpu_version(void) { return "grok_tpu 1.0 (C ABI)"; }

const char* gktpu_last_error(void) { return t_err.c_str(); }

int gktpu_set_msg_handlers(gktpu_msg_fn info, gktpu_msg_fn warn,
                           gktpu_msg_fn error, void* user) {
    if (gktpu_initialize()) return 1;
    Gil gil;
    g_info = info;
    g_warn = warn;
    g_error = error;
    g_msg_user = user;
    const char* setters[3] = {"set_info_handler", "set_warning_handler",
                              "set_error_handler"};
    gktpu_msg_fn fns[3] = {info, warn, error};
    for (int i = 0; i < 3; i++) {
        PyObject* handler;
        if (!fns[i]) {
            handler = Py_None;
            Py_INCREF(Py_None);
        } else {
            PyObject* cap =
                PyCapsule_New((void*)(intptr_t)i, nullptr, nullptr);
            handler = PyCFunction_New(&g_msg_def, cap);
            Py_DECREF(cap);
        }
        PyObject* r = PyObject_CallMethod(g_mod, setters[i], "O", handler);
        Py_DECREF(handler);
        if (!r) {
            set_err_from_python();
            return 1;
        }
        Py_DECREF(r);
    }
    return 0;
}

gktpu_image* gktpu_image_create(uint32_t w, uint32_t h, uint32_t nc,
                                uint32_t prec, int32_t sgnd) {
    return image_alloc(w, h, nc, prec, sgnd, true);
}

void gktpu_image_ref(gktpu_image* img) {
    if (img) img->refs.fetch_add(1, std::memory_order_relaxed);
}

void gktpu_image_unref(gktpu_image* img) {
    if (!img) return;
    if (img->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        for (uint32_t c = 0; c < img->nc; c++) free(img->planes[c]);
        delete[] img->planes;
        delete img;
    }
}

uint32_t gktpu_image_width(const gktpu_image* img) { return img ? img->w : 0; }
uint32_t gktpu_image_height(const gktpu_image* img) { return img ? img->h : 0; }
uint32_t gktpu_image_num_comps(const gktpu_image* img) {
    return img ? img->nc : 0;
}
uint32_t gktpu_image_prec(const gktpu_image* img) {
    return img ? img->prec : 0;
}
int32_t gktpu_image_sgnd(const gktpu_image* img) { return img ? img->sgnd : 0; }

int32_t* gktpu_image_comp_data(gktpu_image* img, uint32_t comp) {
    if (!img || comp >= img->nc) return nullptr;
    return img->planes[comp];
}

void gktpu_cparams_default(gktpu_cparams* p) {
    std::memset(p, 0, sizeof(*p));
    p->num_resolutions = 6;
    p->mct = -1;
    p->num_layers = 1;
}

void gktpu_dparams_default(gktpu_dparams* p) {
    std::memset(p, 0, sizeof(*p));
    p->tile = -1;
}

static int compress_common(const gktpu_image* img, const gktpu_cparams* params,
                           uint8_t** out, size_t* out_len) {
    PyObject* pyim = gk_image_from_c(img);
    if (!pyim) {
        set_err_from_python();
        return 1;
    }
    gktpu_cparams defaults;
    if (!params) {
        gktpu_cparams_default(&defaults);
        params = &defaults;
    }
    PyObject* pyparams = make_cparams(params);
    if (!pyparams) {
        Py_DECREF(pyim);
        set_err_from_python();
        return 1;
    }
    PyObject* blob = PyObject_CallMethod(g_mod, "compress", "OO", pyim,
                                         pyparams);
    Py_DECREF(pyparams);
    if (blob && params->jp2) {  // wrap in the JP2 container
        PyObject* jp2 = PyImport_ImportModule("grok_tpu.codestream.jp2");
        PyObject* wrapped =
            jp2 ? PyObject_CallMethod(jp2, "wrap_jp2", "OO", blob, pyim)
                : nullptr;
        Py_XDECREF(jp2);
        Py_DECREF(blob);
        blob = wrapped;
    }
    Py_DECREF(pyim);
    if (!blob) {
        set_err_from_python();
        return 1;
    }
    char* buf = nullptr;
    Py_ssize_t blen = 0;
    if (PyBytes_AsStringAndSize(blob, &buf, &blen) != 0) {
        Py_DECREF(blob);
        set_err_from_python();
        return 1;
    }
    *out = (uint8_t*)malloc((size_t)blen);
    if (!*out) {
        Py_DECREF(blob);
        t_err = "out of memory";
        return 1;
    }
    std::memcpy(*out, buf, (size_t)blen);
    *out_len = (size_t)blen;
    Py_DECREF(blob);
    return 0;
}

int gktpu_compress(const gktpu_image* img, const gktpu_cparams* params,
                   uint8_t** out, size_t* out_len) {
    if (!img || !out || !out_len) {
        t_err = "bad arguments";
        return 1;
    }
    if (gktpu_initialize()) return 1;
    Gil gil;
    return compress_common(img, params, out, out_len);
}

int gktpu_compress_stream(const gktpu_image* img, const gktpu_cparams* params,
                          gktpu_write_fn write, void* user) {
    if (!img || !write) {
        t_err = "bad arguments";
        return 1;
    }
    uint8_t* buf = nullptr;
    size_t len = 0;
    int rc = gktpu_compress(img, params, &buf, &len);
    if (rc) return rc;
    size_t off = 0;
    while (off < len) {
        size_t wrote = write(buf + off, len - off, user);
        if (wrote == 0) {
            free(buf);
            t_err = "stream write callback aborted";
            return 1;
        }
        off += wrote;
    }
    free(buf);
    return 0;
}

gktpu_image* gktpu_decompress(const uint8_t* data, size_t len,
                              const gktpu_dparams* params) {
    if (!data || !len) {
        t_err = "bad arguments";
        return nullptr;
    }
    if (gktpu_initialize()) return nullptr;
    Gil gil;
    PyObject* mv = PyMemoryView_FromMemory((char*)data, (Py_ssize_t)len,
                                           PyBUF_READ);
    if (!mv) {
        set_err_from_python();
        return nullptr;
    }
    PyObject* kwargs = PyDict_New();
    if (params) {
        auto seti = [&](const char* k, long v) {
            PyObject* o = PyLong_FromLong(v);
            PyDict_SetItemString(kwargs, k, o);
            Py_DECREF(o);
        };
        if (params->reduce) seti("reduce", params->reduce);
        if (params->layers > 0) seti("max_layers", params->layers);
        if (params->tile >= 0) seti("tile_index", params->tile);
        if (params->win_x1 > params->win_x0 &&
            params->win_y1 > params->win_y0) {
            PyObject* win =
                Py_BuildValue("(IIII)", params->win_x0, params->win_y0,
                              params->win_x1, params->win_y1);
            PyDict_SetItemString(kwargs, "window", win);
            Py_DECREF(win);
        }
    }
    PyObject* dcls = PyObject_GetAttrString(g_mod, "DecompressParams");
    PyObject* empty = dcls ? PyTuple_New(0) : nullptr;
    PyObject* dparams = dcls ? PyObject_Call(dcls, empty, kwargs) : nullptr;
    Py_XDECREF(empty);
    Py_XDECREF(dcls);
    Py_DECREF(kwargs);
    PyObject* pyim =
        dparams ? PyObject_CallMethod(g_mod, "decompress", "OO", mv, dparams)
                : nullptr;
    Py_XDECREF(dparams);
    Py_DECREF(mv);
    if (!pyim) {
        set_err_from_python();
        return nullptr;
    }

    // pull (h, w, nc) int32 array + precision/signedness
    PyObject* arr = PyObject_CallMethod(pyim, "to_array", nullptr);
    if (!arr) {
        Py_DECREF(pyim);
        set_err_from_python();
        return nullptr;
    }
    PyObject* np = PyImport_ImportModule("numpy");
    PyObject* a32 = PyObject_CallMethod(
        np, "ascontiguousarray", "Os", arr, "int32");
    Py_DECREF(np);
    Py_DECREF(arr);
    if (!a32) {
        Py_DECREF(pyim);
        set_err_from_python();
        return nullptr;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(a32, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) !=
        0) {
        Py_DECREF(a32);
        Py_DECREF(pyim);
        set_err_from_python();
        return nullptr;
    }
    uint32_t h = 0, w = 0, nc = 1;
    if (view.ndim == 2) {
        h = (uint32_t)view.shape[0];
        w = (uint32_t)view.shape[1];
    } else if (view.ndim == 3) {
        h = (uint32_t)view.shape[0];
        w = (uint32_t)view.shape[1];
        nc = (uint32_t)view.shape[2];
    }
    uint32_t prec = 8;
    int32_t sgnd = 0;
    if (PyObject* comps = PyObject_GetAttrString(pyim, "components")) {
        if (PySequence_Check(comps) && PySequence_Size(comps) > 0) {
            PyObject* c0 = PySequence_GetItem(comps, 0);
            if (PyObject* pr = PyObject_GetAttrString(c0, "prec")) {
                prec = (uint32_t)PyLong_AsLong(pr);
                Py_DECREF(pr);
            }
            if (PyObject* sg = PyObject_GetAttrString(c0, "signed")) {
                sgnd = PyObject_IsTrue(sg) ? 1 : 0;
                Py_DECREF(sg);
            }
            if (PyErr_Occurred()) PyErr_Clear();  // optional introspection
            Py_DECREF(c0);
        }
        Py_DECREF(comps);
    } else {
        PyErr_Clear();
    }

    gktpu_image* out = nullptr;
    if (h && w && nc && nc <= 16) {
        out = image_alloc(w, h, nc, prec ? prec : 8, sgnd, false);
        if (out) {
            const int32_t* src = (const int32_t*)view.buf;
            for (uint32_t c = 0; c < nc; c++) {
                int32_t* dst = out->planes[c];
                for (size_t i = 0; i < (size_t)w * h; i++)
                    dst[i] = src[i * nc + c];
            }
        }
    } else {
        t_err = "unexpected decoded array shape";
    }
    PyBuffer_Release(&view);
    Py_DECREF(a32);
    Py_DECREF(pyim);
    return out;
}

void gktpu_free(void* p) { free(p); }

}  // extern "C"
