// libyuliort.so — the C ABI surface of the renderer (YulioRT.h parity).
//
// The reference exports StartRT/WaitRT/StopRT/GetLastErrorRT/
// GetCurrentStatusRT from a Windows DLL (devices/renderer/YulioRT.h:53-57,
// renderer.cpp:1523-1656) so any host application can drive renders.
// This shim exports the same C surface from a Linux shared library by
// embedding CPython and forwarding to yulio_raytracer.api.session —
// the Python runtime IS the render device here (the JAX analog of the
// reference's in-process render threads).
//
// Host usage (see examples/rt_test_host.c):
//   - ensure PYTHONPATH contains the repo root (or install the package);
//   - optionally set YRT_FORCE_CPU=1 to pin the JAX CPU backend;
//   - dlopen("libyuliort.so") or link against it, call StartRT(...).
//
// Build: make -C native libyuliort.so

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

extern "C" {

// Mirrors Yulio::StatusRT (YulioRT.h:29-34).
typedef struct {
    int state;          // Yulio::StateRT
    float progress;     // [0.0, 1.0]
    int lastError;      // Yulio::ErrorCodeRT
} YrtStatusRT;

// Mirrors Yulio::ParamsRT (YulioRT.h:36-51); bools widened to int for a
// stable C ABI.
typedef struct {
    const char *renderer;        // "pathtracer"
    int size;                    // cube-face resolution (1536)
    int depth;                   // max bounces (10)
    float tMaxShadowRay;         // shadow-ray cap (120)
    int spp;                     // samples per pixel (256)
    float ambientlight[3];       // sky color
    float eyeSeparation;         // inches (2.5)
    int toeIn;                   // bool
    float zeroParallax;          // inches (75)
    int jpegQuality;             // 1-100 (90)
    int debug;                   // bool
    int threadsPriority;         // accepted for parity
    int waterMark;               // bool
    const char *faceCullingMode; // "default"|"forcesingle"|"forcedouble"
} YrtParamsRT;

}  // extern "C"

namespace {

std::once_flag g_init_once;
bool g_init_ok = false;

// Python objects owned forever (module-level singletons).
PyObject *g_session = nullptr;

struct Gil {
    PyGILState_STATE st;
    Gil() : st(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(st); }
};

void initialize() {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    Gil gil;
    // Optional CPU pinning before any jax backend use (tests and hosts
    // without a GPU).
    const char *force_cpu = std::getenv("YRT_FORCE_CPU");
    if (force_cpu && force_cpu[0] == '1') {
        PyRun_SimpleString(
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n");
    }
    g_session = PyImport_ImportModule("yulio_raytracer.api.session");
    if (!g_session) {
        PyErr_Print();
        g_init_ok = false;
        return;
    }
    // Drop the GIL held since Py_Initialize so render worker threads
    // (created inside session.StartRT) can run.
    g_init_ok = true;
}

bool ensure_init() {
    std::call_once(g_init_once, [] {
        initialize();
        if (Py_IsInitialized()) {
            // Release the main-thread GIL permanently; every entry point
            // re-acquires via PyGILState_Ensure.
            PyEval_SaveThread();
        }
    });
    return g_init_ok;
}

PyObject *build_params(const YrtParamsRT *p) {
    PyObject *cls = PyObject_GetAttrString(g_session, "ParamsRT");
    if (!cls) return nullptr;
    PyObject *kwargs = Py_BuildValue(
        "{s:s, s:i, s:i, s:f, s:i, s:(fff), s:f, s:O, s:f, s:i, s:O, "
        "s:i, s:O, s:s}",
        "renderer", p->renderer ? p->renderer : "pathtracer",
        "size", p->size,
        "depth", p->depth,
        "t_max_shadow_ray", p->tMaxShadowRay,
        "spp", p->spp,
        "ambientlight", p->ambientlight[0], p->ambientlight[1],
        p->ambientlight[2],
        "eye_separation", p->eyeSeparation,
        "toe_in", p->toeIn ? Py_True : Py_False,
        "zero_parallax", p->zeroParallax,
        "jpeg_quality", p->jpegQuality,
        "debug", p->debug ? Py_True : Py_False,
        "threads_priority", p->threadsPriority,
        "watermark", p->waterMark ? Py_True : Py_False,
        "face_culling_mode",
        p->faceCullingMode ? p->faceCullingMode : "default");
    if (!kwargs) {
        Py_DECREF(cls);
        return nullptr;
    }
    PyObject *empty = PyTuple_New(0);
    PyObject *obj = PyObject_Call(cls, empty, kwargs);
    Py_DECREF(empty);
    Py_DECREF(kwargs);
    Py_DECREF(cls);
    return obj;
}

bool call_bool(const char *name, PyObject *args) {
    PyObject *fn = PyObject_GetAttrString(g_session, name);
    if (!fn) {
        PyErr_Print();
        return false;
    }
    PyObject *r = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    if (!r) {
        PyErr_Print();
        return false;
    }
    bool ok = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return ok;
}

}  // namespace

extern "C" {

int StartRT(const char *colladaFile, const YrtParamsRT *params) {
    if (!ensure_init()) return 0;
    Gil gil;
    PyObject *p = params ? build_params(params) : Py_NewRef(Py_None);
    if (!p) {
        PyErr_Print();
        return 0;
    }
    PyObject *args = Py_BuildValue("(sO)", colladaFile, p);
    Py_DECREF(p);
    if (!args) return 0;
    bool ok = call_bool("StartRT", args);
    Py_DECREF(args);
    return ok ? 1 : 0;
}

int WaitRT(void) {
    if (!ensure_init()) return 0;
    Gil gil;
    PyObject *args = PyTuple_New(0);
    bool ok = call_bool("WaitRT", args);
    Py_DECREF(args);
    return ok ? 1 : 0;
}

int StopRT(int keepResults) {
    if (!ensure_init()) return 0;
    Gil gil;
    PyObject *args = Py_BuildValue("(O)",
                                   keepResults ? Py_True : Py_False);
    bool ok = call_bool("StopRT", args);
    Py_DECREF(args);
    return ok ? 1 : 0;
}

int GetLastErrorRT(void) {
    if (!ensure_init()) return 1000;  // UnknownError
    Gil gil;
    PyObject *fn = PyObject_GetAttrString(g_session, "GetLastErrorRT");
    if (!fn) return 1000;
    PyObject *r = PyObject_CallNoArgs(fn);
    Py_DECREF(fn);
    if (!r) {
        PyErr_Print();
        return 1000;
    }
    long code = PyLong_AsLong(r);
    Py_DECREF(r);
    return (int)code;
}

void GetCurrentStatusRT(YrtStatusRT *status) {
    if (!status) return;
    status->state = 0;
    status->progress = 0.0f;
    status->lastError = 0;
    if (!ensure_init()) {
        status->lastError = 5;  // FailedToPopulateStatus
        return;
    }
    Gil gil;
    PyObject *fn = PyObject_GetAttrString(g_session, "GetCurrentStatusRT");
    if (!fn) return;
    PyObject *r = PyObject_CallNoArgs(fn);
    Py_DECREF(fn);
    if (!r) {
        PyErr_Print();
        status->lastError = 5;
        return;
    }
    PyObject *st = PyObject_GetAttrString(r, "state");
    PyObject *pr = PyObject_GetAttrString(r, "progress");
    PyObject *le = PyObject_GetAttrString(r, "last_error");
    if (st) status->state = (int)PyLong_AsLong(st);
    if (pr) status->progress = (float)PyFloat_AsDouble(pr);
    if (le) status->lastError = (int)PyLong_AsLong(le);
    Py_XDECREF(st);
    Py_XDECREF(pr);
    Py_XDECREF(le);
    Py_DECREF(r);
}

}  // extern "C"
