// C-callable VisualOdometry for the PyTorch/CUDA port (counterpart of
// native/bpvo_vo_capi.cc; the foreign-binding analogue of the reference's
// MATLAB mex interface, matlab/vo_mex.cc + VoMex.m:1-52).  The library
// embeds CPython, drives the public `bpvo_tpu_torch.VisualOdometry` API and
// marshals frames in and poses out through plain C buffers.
//
//   bpvo_vo_t* h = bpvo_vo_create(K9, baseline, rows, cols, config_or_null);
//   bpvo_vo_add_frame(h, image_f32, disparity_f32, pose16, &is_keyframe);
//   bpvo_vo_destroy(h);
//
// bpvo_vo_create runs on the CUDA device; bpvo_vo_create_on names the
// device ("cpu" runs the plain versions).  Each frame is copied before
// add_frame returns: on the CPU the port's tensors would otherwise alias
// the caller's buffers, and a keyframe kept as a template would change when
// the caller reuses them for the next frame.
//
// When loaded INTO an existing Python process (ctypes), Py_IsInitialized()
// short-circuits the embedding and the calls ride the caller's interpreter.
// Every entry point takes the GIL with PyGILState_Ensure, so the handle may
// be driven from any host thread.  A standalone host needs the Python
// environment's site-packages and the repository root on PYTHONPATH.
//
// Build: python -m bpvo_tpu_torch.capi.build

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

std::string g_error;  // guarded by the GIL at every assignment site

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_error = "python error";
  if (type && PyType_Check(type)) {
    g_error = reinterpret_cast<PyTypeObject*>(type)->tp_name;
  }
  if (value) {
    if (PyObject* s = PyObject_Str(value)) {
      if (const char* c = PyUnicode_AsUTF8(s)) g_error += std::string(": ") + c;
      Py_DECREF(s);
    }
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// A numpy float32 (rows, cols) array holding a COPY of the caller's memory:
// np.frombuffer(memoryview).reshape(rows, cols).copy()
PyObject* f32_copy(PyObject* np, const float* data, int rows, int cols) {
  PyObject* mv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(data)),
      static_cast<Py_ssize_t>(rows) * cols * sizeof(float), PyBUF_READ);
  if (!mv) return nullptr;
  PyObject* flat = PyObject_CallMethod(np, "frombuffer", "Os", mv, "float32");
  Py_DECREF(mv);
  if (!flat) return nullptr;
  PyObject* view = PyObject_CallMethod(flat, "reshape", "(ii)", rows, cols);
  Py_DECREF(flat);
  if (!view) return nullptr;
  PyObject* arr = PyObject_CallMethod(view, "copy", nullptr);
  Py_DECREF(view);
  return arr;
}

// AlgorithmParameters.from_config(ConfigFile(path)), or None without a path
PyObject* load_params(const char* config_path) {
  if (!config_path || !config_path[0]) {
    Py_INCREF(Py_None);
    return Py_None;
  }
  PyObject* cfg_mod = PyImport_ImportModule("bpvo_tpu_torch.config");
  if (!cfg_mod) return nullptr;
  PyObject* params = nullptr;
  PyObject* cf = PyObject_CallMethod(cfg_mod, "ConfigFile", "s", config_path);
  if (cf) {
    PyObject* ap = PyObject_GetAttrString(cfg_mod, "AlgorithmParameters");
    if (ap) {
      params = PyObject_CallMethod(ap, "from_config", "O", cf);
      Py_DECREF(ap);
    }
    Py_DECREF(cf);
  }
  Py_DECREF(cfg_mod);
  return params;
}

struct Vo {
  PyObject* vo = nullptr;  // bpvo_tpu_torch.VisualOdometry instance
  PyObject* np = nullptr;  // numpy module
  int rows = 0, cols = 0;
};

}  // namespace

extern "C" {

typedef struct Vo bpvo_vo_t;

const char* bpvo_vo_last_error(void) { return g_error.c_str(); }

bpvo_vo_t* bpvo_vo_create_on(const float* K9, float baseline, int rows,
                             int cols, const char* config_path,
                             const char* device) {
  static std::once_flag init_once;
  std::call_once(init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // embedding owns the interpreter: release the GIL so every entry
      // point (including this thread's) acquires it via PyGILState_Ensure
      PyEval_SaveThread();
    }
  });
  if (!K9 || rows <= 0 || cols <= 0 || !device) {
    g_error = "bpvo_vo_create: K9 and device must be given, rows and cols "
              "positive";
    return nullptr;
  }

  PyGILState_STATE gil = PyGILState_Ensure();
  Vo* h = new Vo();
  h->rows = rows;
  h->cols = cols;
  do {
    h->np = PyImport_ImportModule("numpy");
    if (!h->np) break;
    PyObject* mod = PyImport_ImportModule("bpvo_tpu_torch");
    if (!mod) break;
    PyObject* params = load_params(config_path);
    if (!params) { Py_DECREF(mod); break; }

    PyObject* K = f32_copy(h->np, K9, 3, 3);
    PyObject* size = Py_BuildValue("(ii)", rows, cols);
    PyObject* bl = PyFloat_FromDouble(baseline);
    PyObject* cls = PyObject_GetAttrString(mod, "VisualOdometry");
    PyObject* args = (K && size && bl)
                         ? PyTuple_Pack(4, K, bl, size, params) : nullptr;
    PyObject* kw = Py_BuildValue("{s:s}", "device", device);
    if (cls && args && kw) h->vo = PyObject_Call(cls, args, kw);
    Py_XDECREF(kw);
    Py_XDECREF(args);
    Py_XDECREF(cls);
    Py_XDECREF(bl);
    Py_XDECREF(size);
    Py_XDECREF(K);
    Py_DECREF(params);
    Py_DECREF(mod);
  } while (false);

  if (!h->vo) {
    set_error_from_python();
    Py_XDECREF(h->np);
    delete h;
    PyGILState_Release(gil);
    return nullptr;
  }
  PyGILState_Release(gil);
  return h;
}

// K9: row-major 3x3 intrinsics.  config_path may be NULL (defaults) or a
// reference-format `Key = Value` file (conf/*.cfg parse unchanged).
bpvo_vo_t* bpvo_vo_create(const float* K9, float baseline, int rows, int cols,
                          const char* config_path) {
  return bpvo_vo_create_on(K9, baseline, rows, cols, config_path, "cuda");
}

// image/disparity: row-major float32 [rows*cols] (grayscale intensity /
// stereo disparity in pixels), copied before the call.  pose_out: row-major
// 4x4 relative motion wrt the previous frame (reference Result::pose, float64
// in Python, converted to float32).  is_keyframe may be NULL.
// Returns 0 on success, -1 on error (see bpvo_vo_last_error).
int bpvo_vo_add_frame(bpvo_vo_t* h, const float* image,
                      const float* disparity, float* pose_out,
                      int* is_keyframe) {
  if (!h || !h->vo) { g_error = "null handle"; return -1; }
  if (!image || !disparity) { g_error = "null image or disparity"; return -1; }
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  do {
    PyObject* img = f32_copy(h->np, image, h->rows, h->cols);
    if (!img) break;
    PyObject* dsp = f32_copy(h->np, disparity, h->rows, h->cols);
    if (!dsp) { Py_DECREF(img); break; }
    PyObject* res = PyObject_CallMethod(h->vo, "add_frame", "OO", img, dsp);
    Py_DECREF(dsp);
    Py_DECREF(img);
    if (!res) break;

    int ok = 1;
    if (pose_out) {
      ok = 0;
      PyObject* pose = PyObject_GetAttrString(res, "pose");
      PyObject* p32 = pose ? PyObject_CallMethod(
          h->np, "ascontiguousarray", "Os", pose, "float32") : nullptr;
      PyObject* bytes = p32 ? PyObject_CallMethod(p32, "tobytes", nullptr)
                            : nullptr;
      if (bytes) {
        if (PyBytes_GET_SIZE(bytes) ==
            16 * static_cast<Py_ssize_t>(sizeof(float))) {
          std::memcpy(pose_out, PyBytes_AS_STRING(bytes), 16 * sizeof(float));
          ok = 1;
        } else {
          PyErr_SetString(PyExc_ValueError, "Result.pose is not 4x4");
        }
      }
      Py_XDECREF(bytes);
      Py_XDECREF(p32);
      Py_XDECREF(pose);
    }
    if (ok && is_keyframe) {
      PyObject* kf = PyObject_GetAttrString(res, "is_keyframe");
      int truth = kf ? PyObject_IsTrue(kf) : -1;
      Py_XDECREF(kf);
      if (truth < 0) {
        ok = 0;
      } else {
        *is_keyframe = truth;
      }
    }
    Py_DECREF(res);
    if (ok) rc = 0;
  } while (false);
  if (rc != 0) set_error_from_python();
  PyGILState_Release(gil);
  return rc;
}

// Number of frames in the trajectory so far (reference Trajectory::size).
int bpvo_vo_trajectory_size(bpvo_vo_t* h) {
  if (!h || !h->vo) { g_error = "null handle"; return -1; }
  PyGILState_STATE gil = PyGILState_Ensure();
  int n = -1;
  PyObject* traj = PyObject_GetAttrString(h->vo, "trajectory");
  if (traj) {
    Py_ssize_t len = PyObject_Length(traj);
    if (len >= 0) n = static_cast<int>(len);
    Py_DECREF(traj);
  }
  if (n < 0) set_error_from_python();
  PyGILState_Release(gil);
  return n;
}

// Releases the VisualOdometry and, with it, the CUDA graphs its pose
// estimator holds; a garbage collection frees any that sit in reference
// cycles now, while the interpreter and the CUDA context are alive.
void bpvo_vo_destroy(bpvo_vo_t* h) {
  if (!h) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_XDECREF(h->vo);
  Py_XDECREF(h->np);
  if (PyObject* gc = PyImport_ImportModule("gc")) {
    PyObject* r = PyObject_CallMethod(gc, "collect", nullptr);
    Py_XDECREF(r);
    Py_DECREF(gc);
  }
  PyErr_Clear();
  PyGILState_Release(gil);
  delete h;
}

}  // extern "C"
