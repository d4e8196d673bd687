// libcxxnetwrapper.so — native C ABI for cxxnet_tpu_torch, the PyTorch/CUDA
// port of the framework.
//
// Mirrors the reference wrapper surface (wrapper/cxxnet_wrapper.h:29-225:
// CXNIO* iterator handles and CXNNet* net handles with identical
// signatures) so existing C/ctypes consumers can rebind.  The trainer is
// Python/PyTorch, so this library embeds CPython (initializing the
// interpreter when the host process has none, attaching via the GIL when
// loaded inside one) and forwards every call to the flat glue functions in
// cxxnet_tpu_torch/capi.py, which builds this file (capi.build_library).
// Returned pointers follow the reference contract: they stay valid only
// until the next call on the same handle (the handle owns the backing
// buffer).
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

typedef unsigned long cxx_ulong;  // NOLINT
typedef unsigned int cxx_uint;
typedef float cxx_real_t;

namespace {

PyObject* g_capi = nullptr;  // cxxnet_tpu_torch.capi module

// Error model matches the reference wrapper: utils::Error/Check print the
// message and terminate the process (src/utils/utils.h:108-148); callers
// validate inputs before crossing the ABI.
void Fatal(const char* msg) {
  if (PyErr_Occurred()) PyErr_Print();
  std::fprintf(stderr, "[cxxnetwrapper] %s\n", msg);
  std::fflush(stderr);
  std::abort();
}

// Ensure an interpreter exists.  Safe to call from any thread; leaves the
// GIL released.
void EnsurePython() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();  // release GIL acquired by initialization
    }
  });
}

// RAII GIL holder for every ABI entry point.
struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

PyObject* Capi() {
  if (g_capi == nullptr) {
    g_capi = PyImport_ImportModule("cxxnet_tpu_torch.capi");
    if (g_capi == nullptr) Fatal("cannot import cxxnet_tpu_torch.capi");
  }
  return g_capi;
}

// Call capi.<fn>(args...); returns a new reference or aborts.
PyObject* Call(const char* fn, PyObject* args) {
  PyObject* f = PyObject_GetAttrString(Capi(), fn);
  if (f == nullptr) Fatal(fn);
  PyObject* res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (res == nullptr) Fatal(fn);
  return res;
}

PyObject* MemView(const void* ptr, size_t nbytes) {
  PyObject* mv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<void*>(ptr)),
      static_cast<Py_ssize_t>(nbytes), PyBUF_READ);
  if (mv == nullptr) Fatal("memoryview");
  return mv;
}

PyObject* ShapeTuple(const cxx_uint* shape, int ndim) {
  PyObject* t = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    PyTuple_SET_ITEM(t, i, PyLong_FromUnsignedLong(shape[i]));
  }
  return t;
}

size_t NumElems(const cxx_uint* shape, int ndim) {
  size_t n = 1;
  for (int i = 0; i < ndim; ++i) n *= shape[i];
  return n;
}

// Copy a float32 ndarray (via buffer protocol) into `out`; returns the
// shape through oshape/ondim (up to 4 dims, left-padded contract handled
// Python-side).  Consumes the reference to `arr`.
void CopyArray(PyObject* arr, std::vector<float>* out, cxx_uint oshape[4],
               cxx_uint* ondim) {
  Py_buffer view;
  if (PyObject_GetBuffer(arr, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT)
      != 0) {
    Fatal("array buffer");
  }
  if (view.itemsize != sizeof(float)) Fatal("expected float32 array");
  size_t n = static_cast<size_t>(view.len) / sizeof(float);
  out->resize(n);
  std::memcpy(out->data(), view.buf, view.len);
  if (ondim != nullptr) {
    if (view.ndim > 4) Fatal("array rank > 4");
    *ondim = static_cast<cxx_uint>(view.ndim);
    for (int i = 0; i < view.ndim; ++i) {
      oshape[i] = static_cast<cxx_uint>(view.shape[i]);
    }
  }
  PyBuffer_Release(&view);
  Py_DECREF(arr);
}

struct IterHandle {
  PyObject* obj;
  std::vector<float> dbuf, lbuf;
};

struct NetHandle {
  PyObject* obj;
  std::vector<float> buf;
  std::string sbuf;
};

}  // namespace

extern "C" {

// ---- iterator API --------------------------------------------------------

void* CXNIOCreateFromConfig(const char* cfg) {
  EnsurePython();
  Gil gil;
  auto* h = new IterHandle();
  h->obj = Call("io_create", Py_BuildValue("(s)", cfg));
  return h;
}

int CXNIONext(void* handle) {
  Gil gil;
  auto* h = static_cast<IterHandle*>(handle);
  PyObject* r = Call("io_next", Py_BuildValue("(O)", h->obj));
  int ret = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return ret;
}

void CXNIOBeforeFirst(void* handle) {
  Gil gil;
  auto* h = static_cast<IterHandle*>(handle);
  Py_DECREF(Call("io_before_first", Py_BuildValue("(O)", h->obj)));
}

const cxx_real_t* CXNIOGetData(void* handle, cxx_uint oshape[4],
                               cxx_uint* ostride) {
  Gil gil;
  auto* h = static_cast<IterHandle*>(handle);
  PyObject* arr = Call("io_get_data", Py_BuildValue("(O)", h->obj));
  cxx_uint ndim = 0;
  CopyArray(arr, &h->dbuf, oshape, &ndim);
  *ostride = oshape[3];
  return h->dbuf.data();
}

const cxx_real_t* CXNIOGetLabel(void* handle, cxx_uint oshape[2],
                                cxx_uint* ostride) {
  Gil gil;
  auto* h = static_cast<IterHandle*>(handle);
  PyObject* arr = Call("io_get_label", Py_BuildValue("(O)", h->obj));
  cxx_uint shape4[4] = {0, 0, 0, 0};
  cxx_uint ndim = 0;
  CopyArray(arr, &h->lbuf, shape4, &ndim);
  oshape[0] = shape4[0];
  oshape[1] = shape4[1];
  *ostride = shape4[1];
  return h->lbuf.data();
}

void CXNIOFree(void* handle) {
  Gil gil;
  auto* h = static_cast<IterHandle*>(handle);
  Py_XDECREF(h->obj);
  delete h;
}

// ---- net API -------------------------------------------------------------

void* CXNNetCreate(const char* device, const char* cfg) {
  EnsurePython();
  Gil gil;
  auto* h = new NetHandle();
  h->obj = Call("net_create",
                Py_BuildValue("(ss)", device == nullptr ? "" : device, cfg));
  return h;
}

void CXNNetFree(void* handle) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  Py_XDECREF(h->obj);
  delete h;
}

void CXNNetSetParam(void* handle, const char* name, const char* val) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  Py_DECREF(Call("net_set_param", Py_BuildValue("(Oss)", h->obj, name, val)));
}

void CXNNetInitModel(void* handle) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  Py_DECREF(Call("net_init_model", Py_BuildValue("(O)", h->obj)));
}

void CXNNetSaveModel(void* handle, const char* fname) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  Py_DECREF(Call("net_save_model", Py_BuildValue("(Os)", h->obj, fname)));
}

void CXNNetLoadModel(void* handle, const char* fname) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  Py_DECREF(Call("net_load_model", Py_BuildValue("(Os)", h->obj, fname)));
}

void CXNNetStartRound(void* handle, int round) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  Py_DECREF(Call("net_start_round", Py_BuildValue("(Oi)", h->obj, round)));
}

void CXNNetSetWeight(void* handle, cxx_real_t* p_weight,
                     cxx_uint size_weight, const char* layer_name,
                     const char* wtag) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  PyObject* mv = MemView(p_weight, size_weight * sizeof(float));
  Py_DECREF(Call("net_set_weight",
                 Py_BuildValue("(ONIss)", h->obj, mv, size_weight,
                               layer_name, wtag)));
}

const cxx_real_t* CXNNetGetWeight(void* handle, const char* layer_name,
                                  const char* wtag, cxx_uint wshape[4],
                                  cxx_uint* out_dim) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  PyObject* arr = Call("net_get_weight",
                       Py_BuildValue("(Oss)", h->obj, layer_name, wtag));
  if (arr == Py_None) {
    Py_DECREF(arr);
    *out_dim = 0;
    return nullptr;
  }
  CopyArray(arr, &h->buf, wshape, out_dim);
  return h->buf.data();
}

void CXNNetUpdateIter(void* handle, void* data_handle) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  auto* it = static_cast<IterHandle*>(data_handle);
  Py_DECREF(Call("net_update_iter", Py_BuildValue("(OO)", h->obj, it->obj)));
}

void CXNNetUpdateBatch(void* handle, cxx_real_t* p_data,
                       const cxx_uint dshape[4], cxx_real_t* p_label,
                       const cxx_uint lshape[2]) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  PyObject* dmv = MemView(p_data, NumElems(dshape, 4) * sizeof(float));
  PyObject* lmv = MemView(p_label, NumElems(lshape, 2) * sizeof(float));
  Py_DECREF(Call("net_update_batch",
                 Py_BuildValue("(ONNNN)", h->obj, dmv, ShapeTuple(dshape, 4),
                               lmv, ShapeTuple(lshape, 2))));
}

const cxx_real_t* CXNNetPredictBatch(void* handle, cxx_real_t* p_data,
                                     const cxx_uint dshape[4],
                                     cxx_uint* out_size) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  PyObject* dmv = MemView(p_data, NumElems(dshape, 4) * sizeof(float));
  PyObject* arr = Call("net_predict_batch",
                       Py_BuildValue("(ONN)", h->obj, dmv,
                                     ShapeTuple(dshape, 4)));
  cxx_uint shape4[4] = {0, 0, 0, 0};
  cxx_uint ndim = 0;
  CopyArray(arr, &h->buf, shape4, &ndim);
  *out_size = static_cast<cxx_uint>(h->buf.size());
  return h->buf.data();
}

const cxx_real_t* CXNNetPredictIter(void* handle, void* data_handle,
                                    cxx_uint* out_size) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  auto* it = static_cast<IterHandle*>(data_handle);
  PyObject* arr = Call("net_predict_iter",
                       Py_BuildValue("(OO)", h->obj, it->obj));
  cxx_uint shape4[4] = {0, 0, 0, 0};
  cxx_uint ndim = 0;
  CopyArray(arr, &h->buf, shape4, &ndim);
  *out_size = static_cast<cxx_uint>(h->buf.size());
  return h->buf.data();
}

const cxx_real_t* CXNNetExtractBatch(void* handle, cxx_real_t* p_data,
                                     const cxx_uint dshape[4],
                                     const char* node_name,
                                     cxx_uint oshape[4]) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  PyObject* dmv = MemView(p_data, NumElems(dshape, 4) * sizeof(float));
  PyObject* arr = Call("net_extract_batch",
                       Py_BuildValue("(ONNs)", h->obj, dmv,
                                     ShapeTuple(dshape, 4), node_name));
  cxx_uint ndim = 0;
  CopyArray(arr, &h->buf, oshape, &ndim);
  return h->buf.data();
}

const cxx_real_t* CXNNetExtractIter(void* handle, void* data_handle,
                                    const char* node_name,
                                    cxx_uint oshape[4]) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  auto* it = static_cast<IterHandle*>(data_handle);
  PyObject* arr = Call("net_extract_iter",
                       Py_BuildValue("(OOs)", h->obj, it->obj, node_name));
  cxx_uint ndim = 0;
  CopyArray(arr, &h->buf, oshape, &ndim);
  return h->buf.data();
}

const char* CXNNetEvaluate(void* handle, void* data_handle,
                           const char* data_name) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  auto* it = static_cast<IterHandle*>(data_handle);
  PyObject* s = Call("net_evaluate",
                     Py_BuildValue("(OOs)", h->obj, it->obj, data_name));
  const char* c = PyUnicode_AsUTF8(s);
  h->sbuf = c == nullptr ? "" : c;
  Py_DECREF(s);
  return h->sbuf.c_str();
}

// The telemetry hub's JSON bodies (/statusz, /slos, /programs) as one
// string each, for an embedder that binds no HTTP port; valid until the
// next call on the handle.
static const char* NetJson(void* handle, const char* fn) {
  Gil gil;
  auto* h = static_cast<NetHandle*>(handle);
  PyObject* s = Call(fn, Py_BuildValue("(O)", h->obj));
  const char* c = PyUnicode_AsUTF8(s);
  h->sbuf = c == nullptr ? "" : c;
  Py_DECREF(s);
  return h->sbuf.c_str();
}

const char* CXNNetObsStats(void* handle) {
  return NetJson(handle, "net_obs_stats");
}

const char* CXNNetObsSlos(void* handle) {
  return NetJson(handle, "net_obs_slos");
}

const char* CXNNetObsPrograms(void* handle) {
  return NetJson(handle, "net_obs_programs");
}

}  // extern "C"
