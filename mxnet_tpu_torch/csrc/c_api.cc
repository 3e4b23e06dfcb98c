/*
 * Native C API of the PyTorch/CUDA port (twin of src/c_api/c_api.cc at the
 * repository's root; parity: reference src/c_api/c_api.cc +
 * c_api_error.cc + c_predict_api.cc).
 *
 * The graph layer is Python and the compute PyTorch on the card, so this
 * library embeds CPython and dispatches each C call to the flat shim
 * functions of mxnet_tpu_torch/capi.py.  What stays identical to the
 * reference is the *contract*: opaque handles, 0/-1 return codes,
 * thread-local MXGetLastError, API_BEGIN/API_END structure
 * (reference src/c_api/c_api_common.h).  Device type codes are checked on
 * the Python side: 1 cpu, 2 gpu, 3 cpu_pinned; any other code fails with
 * a named error.
 *
 * Handles are PyObject* (INCREF'd on creation, DECREF'd in MX*Free) — the
 * same ownership discipline the reference applies to its C++ objects.
 *
 * Built by mxnet_tpu_torch/ops/kernel_build.py (HostLibrary) with g++
 * against the headers of mxnet_tpu_torch/include and libpython.
 */
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "mxnet_tpu/c_api.h"
#include "mxnet_tpu/c_predict_api.h"

namespace {

thread_local std::string last_error;

/* per-thread scratch keeping returned pointers alive until the next call on
 * the same thread (the reference uses MXAPIThreadLocalEntry identically) */
struct ThreadLocalScratch {
  std::vector<std::string> strings;
  std::vector<const char *> cstrs;
  std::vector<mx_uint> shape;
  std::string json;
  std::vector<void *> handles;
  std::vector<int> in_types, out_types, aux_types;
  std::vector<uint64_t> index;
  /* shape-inference result arenas (three groups alive simultaneously) */
  struct ShapeArena {
    std::vector<std::vector<mx_uint>> dims;
    std::vector<mx_uint> ndims;
    std::vector<const mx_uint *> ptrs;
  } shapes_in, shapes_out, shapes_aux;
  /* second string-list arena: GetAtomicSymbolInfo returns three lists that
   * must stay alive simultaneously */
  std::vector<std::string> strings2, strings3;
  std::vector<const char *> cstrs2, cstrs3;
};
thread_local ThreadLocalScratch scratch;

std::once_flag init_flag;
PyObject *capi_module = nullptr;          // mxnet_tpu_torch.capi
PyThreadState *main_tstate = nullptr;
std::string init_error;                   // import failure diagnostic

std::string FetchPyError();

void EnsureRuntime() {
  std::call_once(init_flag, []() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL taken by Py_Initialize so API calls below can use
      // PyGILState_Ensure from any thread (standalone C++ programs)
      main_tstate = PyEval_SaveThread();
    }
    PyGILState_STATE g = PyGILState_Ensure();
    capi_module = PyImport_ImportModule("mxnet_tpu_torch.capi");
    if (capi_module == nullptr) {
      init_error = "cannot import mxnet_tpu_torch.capi (is the "
                   "repository's root on PYTHONPATH?): " + FetchPyError();
    }
    PyGILState_Release(g);
  });
}

std::string FetchPyError() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

class GILGuard {
 public:
  GILGuard() : state_(PyGILState_Ensure()) {}
  ~GILGuard() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

/* Call capi.<fn>(args...); returns new reference or nullptr (python error
 * pending).  The GIL must be held. */
PyObject *CallShim(const char *fn, PyObject *args) {
  if (capi_module == nullptr) {
    PyErr_SetString(PyExc_RuntimeError, init_error.empty()
                        ? "mxnet_tpu_torch.capi failed to import"
                        : init_error.c_str());
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(capi_module, fn);
  if (f == nullptr) return nullptr;
  PyObject *ret = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return ret;
}

PyObject *ShapeTuple(const mx_uint *shape, mx_uint ndim) {
  PyObject *t = PyTuple_New(ndim);
  for (mx_uint i = 0; i < ndim; ++i) {
    PyTuple_SET_ITEM(t, i, PyLong_FromUnsignedLong(shape[i]));
  }
  return t;
}

/* Marshal a python string list into an arena that outlives the call (the
 * reference uses MXAPIThreadLocalEntry identically).  Fails cleanly on a
 * non-string / non-UTF8-encodable element. */
int StrListOutArena(PyObject *list, mx_uint *out_size,
                    const char ***out_array,
                    std::vector<std::string> *strs,
                    std::vector<const char *> *cstrs) {
  Py_ssize_t n = PyList_Size(list);
  strs->clear();
  cstrs->clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char *s = PyUnicode_AsUTF8(PyList_GetItem(list, i));
    if (s == nullptr) {
      last_error = FetchPyError();
      return -1;
    }
    strs->emplace_back(s);
  }
  for (auto &s : *strs) cstrs->push_back(s.c_str());
  *out_size = static_cast<mx_uint>(n);
  *out_array = cstrs->data();
  return 0;
}

int StrListOut(PyObject *list, mx_uint *out_size, const char ***out_array) {
  return StrListOutArena(list, out_size, out_array, &scratch.strings,
                         &scratch.cstrs);
}

/* Copy one python unicode object into *dst.  A non-string (or
 * non-UTF8-encodable) object yields the clean -1 error path instead of
 * constructing a std::string from nullptr (UB). */
int StrOut(PyObject *s, std::string *dst) {
  const char *c = (s == nullptr) ? nullptr : PyUnicode_AsUTF8(s);
  if (c == nullptr) {
    last_error = FetchPyError();
    return -1;
  }
  dst->assign(c);
  return 0;
}

/* Python list from NDArrayHandle array; NULL entries become None. */
PyObject *NDList(mx_uint n, NDArrayHandle *h) {
  PyObject *l = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i) {
    PyObject *o = (h != nullptr && h[i] != nullptr)
        ? reinterpret_cast<PyObject *>(h[i]) : Py_None;
    Py_INCREF(o);
    PyList_SET_ITEM(l, i, o);
  }
  return l;
}

PyObject *StrList(mx_uint n, const char **s) {
  PyObject *l = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i) {
    PyList_SET_ITEM(l, i, PyUnicode_FromString(s != nullptr ? s[i] : ""));
  }
  return l;
}

PyObject *IntList(mx_uint n, const int *v) {
  PyObject *l = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i) {
    PyList_SET_ITEM(l, i, PyLong_FromLong(v[i]));
  }
  return l;
}

/* Copy a python list of NDArrays out as INCREF'd handles in scratch. */
int HandleListOut(PyObject *list, mx_uint *out_size, NDArrayHandle **out) {
  Py_ssize_t n = PyList_Size(list);
  scratch.handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GetItem(list, i);
    Py_INCREF(o);
    scratch.handles.push_back(o);
  }
  *out_size = static_cast<mx_uint>(n);
  *out = scratch.handles.data();
  return 0;
}

/* ------------------------------------------- KVStore updater C trampoline */
struct UpdaterClosure {
  MXKVStoreUpdater fn;
  void *handle;
};

void FreeUpdaterClosure(PyObject *cap) {
  delete reinterpret_cast<UpdaterClosure *>(
      PyCapsule_GetPointer(cap, "mxtpu_updater"));
}

PyObject *NativeCallUpdater(PyObject *, PyObject *args) {
  PyObject *cap = nullptr, *recv = nullptr, *local = nullptr;
  int key = 0;
  if (!PyArg_ParseTuple(args, "OiOO", &cap, &key, &recv, &local)) {
    return nullptr;
  }
  auto *c = reinterpret_cast<UpdaterClosure *>(
      PyCapsule_GetPointer(cap, "mxtpu_updater"));
  if (c == nullptr) return nullptr;
  /* synchronous call back into user C code; the MX* APIs it invokes
   * re-enter PyGILState_Ensure recursively on this thread, which is safe */
  c->fn(key, reinterpret_cast<NDArrayHandle>(recv),
        reinterpret_cast<NDArrayHandle>(local), c->handle);
  Py_RETURN_NONE;
}

PyMethodDef g_updater_def = {"call_updater", NativeCallUpdater, METH_VARARGS,
                             "bridge from python kvstore to the C updater"};

/* ------------------------------------------ executor monitor C trampoline */
struct MonitorClosure {
  ExecutorMonitorCallback fn;
  void *handle;
};

void FreeMonitorClosure(PyObject *cap) {
  delete reinterpret_cast<MonitorClosure *>(
      PyCapsule_GetPointer(cap, "mxtpu_monitor"));
}

PyObject *NativeCallMonitor(PyObject *, PyObject *args) {
  PyObject *cap = nullptr, *arr = nullptr;
  const char *name = nullptr;
  if (!PyArg_ParseTuple(args, "OsO", &cap, &name, &arr)) return nullptr;
  auto *c = reinterpret_cast<MonitorClosure *>(
      PyCapsule_GetPointer(cap, "mxtpu_monitor"));
  if (c == nullptr) return nullptr;
  /* ownership of one reference transfers to the callback, which frees it
   * with MXNDArrayFree (reference monitor protocol) */
  Py_INCREF(arr);
  c->fn(name, reinterpret_cast<NDArrayHandle>(arr), c->handle);
  Py_RETURN_NONE;
}

PyMethodDef g_monitor_def = {"call_monitor", NativeCallMonitor, METH_VARARGS,
                             "bridge from the executor monitor to C"};

/* ------------------------------------------- custom-op native trampolines */
void FreeCustomPropInfo(PyObject *cap) {
  auto *info = reinterpret_cast<CustomOpPropInfo *>(
      PyCapsule_GetPointer(cap, "mxtpu_custom_prop"));
  if (info != nullptr) {
    if (info->del != nullptr) info->del(info->p_del);
    delete info;
  }
}

void FreeCustomOpInfo(PyObject *cap) {
  auto *info = reinterpret_cast<CustomOpInfo *>(
      PyCapsule_GetPointer(cap, "mxtpu_custom_op"));
  if (info != nullptr) {
    if (info->del != nullptr) info->del(info->p_del);
    delete info;
  }
}

/* NULL-terminated char** from a prop list callback -> python list */
PyObject *NamesToList(char **names) {
  PyObject *l = PyList_New(0);
  for (int i = 0; names != nullptr && names[i] != nullptr; ++i) {
    PyObject *s = PyUnicode_FromString(names[i]);
    PyList_Append(l, s);
    Py_DECREF(s);
  }
  return l;
}

/* (cap, op_type, keys, vals) -> prop-info capsule */
PyObject *NativeCustomPropCreate(PyObject *, PyObject *args) {
  PyObject *cap = nullptr, *keys = nullptr, *vals = nullptr;
  const char *op_type = nullptr;
  if (!PyArg_ParseTuple(args, "OsOO", &cap, &op_type, &keys, &vals)) {
    return nullptr;
  }
  auto creator = reinterpret_cast<CustomOpPropCreator>(
      PyCapsule_GetPointer(cap, "mxtpu_custom_creator"));
  if (creator == nullptr) return nullptr;
  Py_ssize_t n = PyList_Size(keys);
  std::vector<std::string> kstr, vstr;
  std::vector<const char *> kptr, vptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char *k = PyUnicode_AsUTF8(PyList_GetItem(keys, i));
    const char *v = PyUnicode_AsUTF8(PyList_GetItem(vals, i));
    if (k == nullptr || v == nullptr) return nullptr;
    kstr.emplace_back(k);
    vstr.emplace_back(v);
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    kptr.push_back(kstr[i].c_str());
    vptr.push_back(vstr[i].c_str());
  }
  auto *info = new CustomOpPropInfo();
  std::memset(info, 0, sizeof(*info));
  if (!creator(op_type, static_cast<int>(n), kptr.data(), vptr.data(),
               info)) {
    delete info;
    PyErr_SetString(PyExc_RuntimeError, "CustomOpPropCreator failed");
    return nullptr;
  }
  return PyCapsule_New(info, "mxtpu_custom_prop", FreeCustomPropInfo);
}

/* (prop_cap, method, payload) -> method-specific result */
PyObject *NativeCustomPropCall(PyObject *, PyObject *args) {
  PyObject *cap = nullptr, *payload = nullptr;
  const char *method = nullptr;
  if (!PyArg_ParseTuple(args, "OsO", &cap, &method, &payload)) {
    return nullptr;
  }
  auto *info = reinterpret_cast<CustomOpPropInfo *>(
      PyCapsule_GetPointer(cap, "mxtpu_custom_prop"));
  if (info == nullptr) return nullptr;
  std::string m = method;
  if (m == "list_arguments" || m == "list_outputs" || m == "list_aux") {
    char **names = nullptr;
    bool ok = (m == "list_arguments")
        ? info->list_arguments(&names, info->p_list_arguments)
        : (m == "list_outputs")
            ? info->list_outputs(&names, info->p_list_outputs)
            : info->list_auxiliary_states(&names,
                                          info->p_list_auxiliary_states);
    if (!ok) {
      PyErr_SetString(PyExc_RuntimeError, "custom op list callback failed");
      return nullptr;
    }
    return NamesToList(names);
  }
  if (m == "infer_shape") {
    PyObject *in_shapes = PyTuple_GetItem(payload, 0);
    long num_out = PyLong_AsLong(PyTuple_GetItem(payload, 1));
    long num_aux = PyLong_AsLong(PyTuple_GetItem(payload, 2));
    Py_ssize_t nin = PyList_Size(in_shapes);
    size_t total = static_cast<size_t>(nin + num_out + num_aux);
    std::vector<std::vector<unsigned>> dims(nin);
    std::vector<int> ndims(total, 0);
    std::vector<unsigned *> shapes(total, nullptr);
    for (Py_ssize_t i = 0; i < nin; ++i) {
      PyObject *t = PyList_GetItem(in_shapes, i);
      Py_ssize_t nd = PyTuple_Size(t);
      for (Py_ssize_t j = 0; j < nd; ++j) {
        dims[i].push_back(static_cast<unsigned>(
            PyLong_AsUnsignedLong(PyTuple_GetItem(t, j))));
      }
      ndims[i] = static_cast<int>(nd);
      shapes[i] = dims[i].data();
    }
    if (!info->infer_shape(static_cast<int>(total), ndims.data(),
                           shapes.data(), info->p_infer_shape)) {
      PyErr_SetString(PyExc_RuntimeError, "custom op infer_shape failed");
      return nullptr;
    }
    PyObject *out = PyTuple_New(3);
    size_t ofs = 0;
    size_t counts[3] = {static_cast<size_t>(nin),
                        static_cast<size_t>(num_out),
                        static_cast<size_t>(num_aux)};
    for (int g = 0; g < 3; ++g) {
      PyObject *group = PyList_New(counts[g]);
      for (size_t i = 0; i < counts[g]; ++i, ++ofs) {
        PyObject *t = PyTuple_New(ndims[ofs]);
        for (int j = 0; j < ndims[ofs]; ++j) {
          PyTuple_SET_ITEM(t, j, PyLong_FromUnsignedLong(shapes[ofs][j]));
        }
        PyList_SET_ITEM(group, i, t);
      }
      PyTuple_SET_ITEM(out, g, group);  // steals the reference — no leak
    }
    return out;
  }
  if (m == "backward_deps") {
    std::vector<int> og, idt, odt;
    PyObject *lists[3] = {PyTuple_GetItem(payload, 0),
                          PyTuple_GetItem(payload, 1),
                          PyTuple_GetItem(payload, 2)};
    std::vector<int> *dsts[3] = {&og, &idt, &odt};
    for (int g = 0; g < 3; ++g) {
      Py_ssize_t n = PyList_Size(lists[g]);
      for (Py_ssize_t i = 0; i < n; ++i) {
        dsts[g]->push_back(static_cast<int>(
            PyLong_AsLong(PyList_GetItem(lists[g], i))));
      }
    }
    int num_deps = 0;
    int *rdeps = nullptr;
    if (!info->declare_backward_dependency(og.data(), idt.data(), odt.data(),
                                           &num_deps, &rdeps,
                                           info->p_declare_backward_dependency)) {
      PyErr_SetString(PyExc_RuntimeError, "custom op backward_deps failed");
      return nullptr;
    }
    PyObject *l = PyList_New(num_deps);
    for (int i = 0; i < num_deps; ++i) {
      PyList_SET_ITEM(l, i, PyLong_FromLong(rdeps[i]));
    }
    return l;
  }
  if (m == "create_operator") {
    const char *ctx = PyUnicode_AsUTF8(PyTuple_GetItem(payload, 0));
    PyObject *in_shapes = PyTuple_GetItem(payload, 1);
    PyObject *dtypes = PyTuple_GetItem(payload, 2);
    if (ctx == nullptr) return nullptr;
    Py_ssize_t nin = PyList_Size(in_shapes);
    std::vector<std::vector<unsigned>> dims(nin);
    std::vector<int> ndims(nin), dt(nin);
    std::vector<unsigned *> shapes(nin);
    for (Py_ssize_t i = 0; i < nin; ++i) {
      PyObject *t = PyList_GetItem(in_shapes, i);
      Py_ssize_t nd = PyTuple_Size(t);
      for (Py_ssize_t j = 0; j < nd; ++j) {
        dims[i].push_back(static_cast<unsigned>(
            PyLong_AsUnsignedLong(PyTuple_GetItem(t, j))));
      }
      ndims[i] = static_cast<int>(nd);
      shapes[i] = dims[i].data();
      dt[i] = static_cast<int>(PyLong_AsLong(PyList_GetItem(dtypes, i)));
    }
    auto *op = new CustomOpInfo();
    std::memset(op, 0, sizeof(*op));
    if (!info->create_operator(ctx, static_cast<int>(nin), shapes.data(),
                               ndims.data(), dt.data(), op,
                               info->p_create_operator)) {
      delete op;
      PyErr_SetString(PyExc_RuntimeError, "custom op create_operator failed");
      return nullptr;
    }
    return PyCapsule_New(op, "mxtpu_custom_op", FreeCustomOpInfo);
  }
  PyErr_SetString(PyExc_ValueError, "unknown custom-prop method");
  return nullptr;
}

/* (op_cap, kind, tensors, tags, reqs, is_train) -> None */
PyObject *NativeCustomOpCall(PyObject *, PyObject *args) {
  PyObject *cap = nullptr, *tensors = nullptr, *tags = nullptr,
           *reqs = nullptr;
  const char *kind = nullptr;
  int is_train = 0;
  if (!PyArg_ParseTuple(args, "OsOOOi", &cap, &kind, &tensors, &tags, &reqs,
                        &is_train)) {
    return nullptr;
  }
  auto *op = reinterpret_cast<CustomOpInfo *>(
      PyCapsule_GetPointer(cap, "mxtpu_custom_op"));
  if (op == nullptr) return nullptr;
  Py_ssize_t n = PyList_Size(tensors);
  std::vector<void *> ptrs(n);
  std::vector<int> tg(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    ptrs[i] = PyList_GetItem(tensors, i);  // borrowed PyObject* handles
    tg[i] = static_cast<int>(PyLong_AsLong(PyList_GetItem(tags, i)));
  }
  Py_ssize_t nr = PyList_Size(reqs);
  std::vector<int> rq(nr);
  for (Py_ssize_t i = 0; i < nr; ++i) {
    rq[i] = static_cast<int>(PyLong_AsLong(PyList_GetItem(reqs, i)));
  }
  bool ok = (std::string(kind) == "forward")
      ? op->forward(static_cast<int>(n), ptrs.data(), tg.data(), rq.data(),
                    is_train != 0, op->p_forward)
      : op->backward(static_cast<int>(n), ptrs.data(), tg.data(), rq.data(),
                     is_train != 0, op->p_backward);
  if (!ok) {
    PyErr_SetString(PyExc_RuntimeError, "custom op compute callback failed");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef g_custom_create_def = {
    "custom_prop_create", NativeCustomPropCreate, METH_VARARGS,
    "create a native CustomOpPropInfo from the registered creator"};
PyMethodDef g_custom_prop_def = {
    "custom_prop_call", NativeCustomPropCall, METH_VARARGS,
    "invoke a CustomOpPropInfo callback"};
PyMethodDef g_custom_op_def = {
    "custom_op_call", NativeCustomOpCall, METH_VARARGS,
    "invoke a CustomOpInfo forward/backward callback"};

/* stable operator-creator handles (PyUnicode op names, never freed) */
std::vector<PyObject *> g_creators;

}  // namespace

#define API_BEGIN()                \
  EnsureRuntime();                 \
  GILGuard gil_guard__;            \
  try {
#define API_END()                                  \
  }                                                \
  catch (const std::exception &e) {                \
    last_error = e.what();                         \
    return -1;                                     \
  }                                                \
  return 0;
#define CHECK_PY(expr)                  \
  if ((expr) == nullptr) {              \
    last_error = FetchPyError();        \
    return -1;                          \
  }

extern "C" {

const char *MXGetLastError() { return last_error.c_str(); }

int MXTPULibInit() {
  EnsureRuntime();
  GILGuard gil;
  if (capi_module == nullptr) {
    last_error = init_error;
    return -1;
  }
  return 0;
}

int MXNotifyShutdown() {
  API_BEGIN();
  PyObject *r = CallShim("nd_waitall", nullptr);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXRandomSeed(int seed) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(i)", seed);
  PyObject *r = CallShim("random_seed", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

/* ----------------------------------------------------------------- NDArray */
int MXNDArrayCreateNone(NDArrayHandle *out) {
  API_BEGIN();
  PyObject *r = CallShim("nd_create_none", nullptr);
  CHECK_PY(r);
  *out = r;  // keep the reference as the handle
  API_END();
}

int MXNDArrayCreate(const mx_uint *shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle *out) {
  (void)delay_alloc;  // PyTorch owns allocation; the hint is unused here
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Nii)", ShapeTuple(shape, ndim), dev_type,
                                 dev_id);
  PyObject *r = CallShim("nd_create", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;  // keep the reference as the handle
  API_END();
}

int MXNDArrayFree(NDArrayHandle handle) {
  API_BEGIN();
  Py_XDECREF(reinterpret_cast<PyObject *>(handle));
  API_END();
}

int MXNDArrayWaitToRead(NDArrayHandle handle) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_wait_to_read", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXNDArrayWaitToWrite(NDArrayHandle handle) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_wait_to_write", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t *out_size,
                          const char **out_buf) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_save_raw_bytes", args);
  Py_DECREF(args);
  CHECK_PY(r);
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    last_error = FetchPyError();
    return -1;
  }
  scratch.json.assign(buf, static_cast<size_t>(len));
  Py_DECREF(r);
  *out_size = scratch.json.size();
  *out_buf = scratch.json.data();
  API_END();
}

int MXNDArrayLoadFromRawBytes(const void *buf, size_t size,
                              NDArrayHandle *out) {
  API_BEGIN();
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(buf), static_cast<Py_ssize_t>(size));
  PyObject *args = Py_BuildValue("(N)", bytes);
  PyObject *r = CallShim("nd_load_from_raw_bytes", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXNDArrayGetData(NDArrayHandle handle, mx_float **out_pdata) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_get_data_f32", args);
  Py_DECREF(args);
  CHECK_PY(r);
  /* the shim stashes the bytes object on the NDArray, so the buffer
   * outlives this borrowed pointer for as long as the handle does */
  char *buf = nullptr;
  Py_ssize_t len = 0;
  int rc = PyBytes_AsStringAndSize(r, &buf, &len);
  Py_DECREF(r);
  if (rc != 0) {
    last_error = FetchPyError();
    return -1;
  }
  *out_pdata = reinterpret_cast<mx_float *>(buf);
  API_END();
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void *data,
                             size_t size) {
  API_BEGIN();
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data), size * sizeof(mx_float));
  PyObject *args = Py_BuildValue("(ON)",
                                 reinterpret_cast<PyObject *>(handle), bytes);
  PyObject *r = CallShim("nd_sync_copy_from", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void *data, size_t size) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_sync_copy_to", args);
  Py_DECREF(args);
  CHECK_PY(r);
  char *buf = nullptr;
  Py_ssize_t len = 0;
  PyBytes_AsStringAndSize(r, &buf, &len);
  size_t want = size * sizeof(mx_float);
  if (static_cast<size_t>(len) != want) {
    Py_DECREF(r);
    last_error = "MXNDArraySyncCopyToCPU: size mismatch (array has " +
                 std::to_string(len / sizeof(mx_float)) +
                 " elements, caller passed " + std::to_string(size) + ")";
    return -1;
  }
  std::memcpy(data, buf, want);
  Py_DECREF(r);
  API_END();
}

int MXNDArrayGetShape(NDArrayHandle handle, mx_uint *out_dim,
                      const mx_uint **out_pdata) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_get_shape", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_ssize_t n = PyTuple_Size(r);
  scratch.shape.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    scratch.shape.push_back(static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(r, i))));
  }
  Py_DECREF(r);
  *out_dim = static_cast<mx_uint>(n);
  *out_pdata = scratch.shape.data();
  API_END();
}

int MXNDArraySave(const char *fname, mx_uint num_args, NDArrayHandle *args_h,
                  const char **keys) {
  API_BEGIN();
  PyObject *handles = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    PyObject *o = reinterpret_cast<PyObject *>(args_h[i]);
    Py_INCREF(o);
    PyList_SET_ITEM(handles, i, o);
  }
  PyObject *names = PyList_New(0);
  if (keys != nullptr) {
    for (mx_uint i = 0; i < num_args; ++i) {
      PyObject *s = PyUnicode_FromString(keys[i]);
      PyList_Append(names, s);
      Py_DECREF(s);
    }
  }
  PyObject *args = Py_BuildValue("(sNN)", fname, handles, names);
  PyObject *r = CallShim("nd_save", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXNDArrayLoad(const char *fname, mx_uint *out_size,
                  NDArrayHandle **out_arr, mx_uint *out_name_size,
                  const char ***out_names) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(s)", fname);
  PyObject *r = CallShim("nd_load", args);
  Py_DECREF(args);
  CHECK_PY(r);
  PyObject *arrs = PyTuple_GetItem(r, 0);
  PyObject *names = PyTuple_GetItem(r, 1);
  Py_ssize_t n = PyList_Size(arrs);
  scratch.handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GetItem(arrs, i);
    Py_INCREF(o);
    scratch.handles.push_back(o);
  }
  *out_size = static_cast<mx_uint>(n);
  *out_arr = scratch.handles.data();
  if (StrListOut(names, out_name_size, out_names) != 0) {
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  API_END();
}

int MXNDArrayWaitAll() {
  API_BEGIN();
  PyObject *r = CallShim("nd_waitall", nullptr);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

/* ------------------------------------------------------------------ Symbol */
int MXListAllOpNames(mx_uint *out_size, const char ***out_array) {
  API_BEGIN();
  PyObject *r = CallShim("list_all_op_names", nullptr);
  CHECK_PY(r);
  if (StrListOut(r, out_size, out_array) != 0) {
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  API_END();
}

int MXSymbolCreateFromJSON(const char *json, SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(s)", json);
  PyObject *r = CallShim("symbol_create_from_json", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolCreateFromFile(const char *fname, SymbolHandle *out) {
  API_BEGIN();
  FILE *f = fopen(fname, "rb");
  if (f == nullptr) {
    last_error = std::string("cannot open ") + fname;
    return -1;
  }
  std::string json;
  char buf[4096];
  size_t got;
  while ((got = fread(buf, 1, sizeof(buf), f)) > 0) json.append(buf, got);
  fclose(f);
  PyObject *args = Py_BuildValue("(s)", json.c_str());
  PyObject *r = CallShim("symbol_create_from_json", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolSaveToJSON(SymbolHandle symbol, const char **out_json) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_save_to_json", args);
  Py_DECREF(args);
  CHECK_PY(r);
  int rc = StrOut(r, &scratch.json);
  Py_DECREF(r);
  if (rc != 0) return -1;
  *out_json = scratch.json.c_str();
  API_END();
}

int MXSymbolFree(SymbolHandle symbol) {
  API_BEGIN();
  Py_XDECREF(reinterpret_cast<PyObject *>(symbol));
  API_END();
}

static int SymbolStrList(const char *fn, SymbolHandle symbol,
                         mx_uint *out_size, const char ***out_array) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim(fn, args);
  Py_DECREF(args);
  CHECK_PY(r);
  if (StrListOut(r, out_size, out_array) != 0) {
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  API_END();
}

int MXSymbolListArguments(SymbolHandle symbol, mx_uint *out_size,
                          const char ***out_array) {
  return SymbolStrList("symbol_list_arguments", symbol, out_size, out_array);
}

int MXSymbolListOutputs(SymbolHandle symbol, mx_uint *out_size,
                        const char ***out_array) {
  return SymbolStrList("symbol_list_outputs", symbol, out_size, out_array);
}

int MXSymbolListAuxiliaryStates(SymbolHandle symbol, mx_uint *out_size,
                                const char ***out_array) {
  return SymbolStrList("symbol_list_auxiliary_states", symbol, out_size,
                       out_array);
}

/* ------------------------------------------------- NDArray (extended) */
int MXNDArrayCreateEx(const mx_uint *shape, mx_uint ndim, int dev_type,
                      int dev_id, int delay_alloc, int dtype,
                      NDArrayHandle *out) {
  (void)delay_alloc;
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Niii)", ShapeTuple(shape, ndim), dev_type,
                                 dev_id, dtype);
  PyObject *r = CallShim("nd_create_ex", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXNDArrayGetDType(NDArrayHandle handle, int *out_dtype) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_get_dtype", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out_dtype = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  API_END();
}

int MXNDArrayGetContext(NDArrayHandle handle, int *out_dev_type,
                        int *out_dev_id) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_get_context", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out_dev_type = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 0)));
  *out_dev_id = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
  Py_DECREF(r);
  API_END();
}

int MXNDArraySlice(NDArrayHandle handle, mx_uint begin, mx_uint end,
                   NDArrayHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(OII)",
                                 reinterpret_cast<PyObject *>(handle),
                                 begin, end);
  PyObject *r = CallShim("nd_slice", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXNDArrayAt(NDArrayHandle handle, mx_uint idx, NDArrayHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(OI)",
                                 reinterpret_cast<PyObject *>(handle), idx);
  PyObject *r = CallShim("nd_at", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXNDArrayReshape(NDArrayHandle handle, int ndim, const int *dims,
                     NDArrayHandle *out) {
  API_BEGIN();
  PyObject *shape = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    PyTuple_SET_ITEM(shape, i, PyLong_FromLong(dims[i]));
  }
  PyObject *args = Py_BuildValue("(ON)",
                                 reinterpret_cast<PyObject *>(handle), shape);
  PyObject *r = CallShim("nd_reshape", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXNDArraySyncCopyFromCPUEx(NDArrayHandle handle, const void *data,
                               size_t nbytes) {
  API_BEGIN();
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data), nbytes);
  PyObject *args = Py_BuildValue("(ON)",
                                 reinterpret_cast<PyObject *>(handle), bytes);
  PyObject *r = CallShim("nd_sync_copy_from_typed", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXNDArraySyncCopyToCPUEx(NDArrayHandle handle, void *data,
                             size_t nbytes) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("nd_sync_copy_to_typed", args);
  Py_DECREF(args);
  CHECK_PY(r);
  char *buf = nullptr;
  Py_ssize_t len = 0;
  PyBytes_AsStringAndSize(r, &buf, &len);
  if (static_cast<size_t>(len) != nbytes) {
    Py_DECREF(r);
    last_error = "MXNDArraySyncCopyToCPUEx: size mismatch (array has " +
                 std::to_string(len) + " bytes, caller passed " +
                 std::to_string(nbytes) + ")";
    return -1;
  }
  std::memcpy(data, buf, nbytes);
  Py_DECREF(r);
  API_END();
}

/* ------------------------------------------- op reflection + imperative */
int MXSymbolListAtomicSymbolCreators(mx_uint *out_size,
                                     AtomicSymbolCreator **out) {
  API_BEGIN();
  if (g_creators.empty()) {
    PyObject *r = CallShim("list_all_op_names", nullptr);
    CHECK_PY(r);
    Py_ssize_t n = PyList_Size(r);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject *s = PyList_GetItem(r, i);
      Py_INCREF(s);          // creator handles are stable for process life
      g_creators.push_back(s);
    }
    Py_DECREF(r);
  }
  *out_size = static_cast<mx_uint>(g_creators.size());
  *out = reinterpret_cast<AtomicSymbolCreator *>(g_creators.data());
  API_END();
}

int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                const char **name) {
  API_BEGIN();
  const char *s = PyUnicode_AsUTF8(reinterpret_cast<PyObject *>(creator));
  if (s == nullptr) {
    last_error = FetchPyError();
    return -1;
  }
  scratch.json = s;
  *name = scratch.json.c_str();
  API_END();
}

int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator,
                                const char **name, const char **description,
                                mx_uint *num_args, const char ***arg_names,
                                const char ***arg_type_infos,
                                const char ***arg_descriptions,
                                const char **key_var_num_args) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(creator));
  PyObject *r = CallShim("atomic_symbol_info", args);
  Py_DECREF(args);
  CHECK_PY(r);
  static thread_local std::string nm, doc, kv;
  if (StrOut(PyTuple_GetItem(r, 0), &nm) != 0 ||
      StrOut(PyTuple_GetItem(r, 1), &doc) != 0 ||
      StrOut(PyTuple_GetItem(r, 5), &kv) != 0) {
    Py_DECREF(r);
    return -1;
  }
  mx_uint n1 = 0, n2 = 0, n3 = 0;
  if (StrListOut(PyTuple_GetItem(r, 2), &n1, arg_names) != 0 ||
      StrListOutArena(PyTuple_GetItem(r, 3), &n2, arg_type_infos,
                      &scratch.strings2, &scratch.cstrs2) != 0 ||
      StrListOutArena(PyTuple_GetItem(r, 4), &n3, arg_descriptions,
                      &scratch.strings3, &scratch.cstrs3) != 0) {
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  *name = nm.c_str();
  *description = doc.c_str();
  *key_var_num_args = kv.c_str();
  *num_args = n1;
  API_END();
}

int MXImperativeInvoke(AtomicSymbolCreator creator, int num_inputs,
                       NDArrayHandle *inputs, int *num_outputs,
                       NDArrayHandle **outputs, int num_params,
                       const char **param_keys, const char **param_vals) {
  API_BEGIN();
  PyObject *outs_in = (*num_outputs > 0 && *outputs != nullptr)
      ? NDList(*num_outputs, *outputs) : PyList_New(0);
  PyObject *args = Py_BuildValue(
      "(ONNNN)", reinterpret_cast<PyObject *>(creator),
      NDList(num_inputs, inputs), StrList(num_params, param_keys),
      StrList(num_params, param_vals), outs_in);
  PyObject *r = CallShim("imperative_invoke", args);
  Py_DECREF(args);
  CHECK_PY(r);
  if (*num_outputs > 0 && *outputs != nullptr) {
    /* outputs were written in place; handles unchanged */
    Py_DECREF(r);
  } else {
    mx_uint n = 0;
    HandleListOut(r, &n, reinterpret_cast<NDArrayHandle **>(outputs));
    Py_DECREF(r);
    *num_outputs = static_cast<int>(n);
  }
  API_END();
}

/* ---------------------------------------------------- Symbol (extended) */
int MXSymbolCreateAtomicSymbol(AtomicSymbolCreator creator, mx_uint num_param,
                               const char **keys, const char **vals,
                               SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(ONN)",
                                 reinterpret_cast<PyObject *>(creator),
                                 StrList(num_param, keys),
                                 StrList(num_param, vals));
  PyObject *r = CallShim("symbol_create_atomic", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolCreateVariable(const char *name, SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(s)", name);
  PyObject *r = CallShim("symbol_create_variable", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle *symbols,
                        SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(N)", NDList(num_symbols, symbols));
  PyObject *r = CallShim("symbol_create_group", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolCompose(SymbolHandle sym, const char *name, mx_uint num_args,
                    const char **keys, SymbolHandle *args_h) {
  API_BEGIN();
  PyObject *key_list = (keys != nullptr) ? StrList(num_args, keys)
                                         : PyList_New(0);
  PyObject *args = Py_BuildValue("(OsNN)", reinterpret_cast<PyObject *>(sym),
                                 name != nullptr ? name : "",
                                 key_list, NDList(num_args, args_h));
  PyObject *r = CallShim("symbol_compose", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXSymbolCopy(SymbolHandle symbol, SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_copy", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolPrint(SymbolHandle symbol, const char **out_str) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_print", args);
  Py_DECREF(args);
  CHECK_PY(r);
  int rc = StrOut(r, &scratch.json);
  Py_DECREF(r);
  if (rc != 0) return -1;
  *out_str = scratch.json.c_str();
  API_END();
}

int MXSymbolGetAttr(SymbolHandle symbol, const char *key, const char **out,
                    int *success) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Os)", reinterpret_cast<PyObject *>(symbol),
                                 key);
  PyObject *r = CallShim("symbol_get_attr", args);
  Py_DECREF(args);
  CHECK_PY(r);
  if (r == Py_None) {
    *success = 0;
    *out = nullptr;
  } else {
    if (StrOut(r, &scratch.json) != 0) {
      Py_DECREF(r);
      return -1;
    }
    *out = scratch.json.c_str();
    *success = 1;
  }
  Py_DECREF(r);
  API_END();
}

int MXSymbolSetAttr(SymbolHandle symbol, const char *key, const char *value) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Oss)", reinterpret_cast<PyObject *>(symbol),
                                 key, value);
  PyObject *r = CallShim("symbol_set_attr", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXSymbolListAttr(SymbolHandle symbol, mx_uint *out_size,
                     const char ***out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_list_attr", args);
  Py_DECREF(args);
  CHECK_PY(r);
  mx_uint n = 0;
  if (StrListOut(r, &n, out) != 0) {
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  *out_size = n / 2;  // reference convention: pairs, size = pair count
  API_END();
}

int MXSymbolListAttrShallow(SymbolHandle symbol, mx_uint *out_size,
                            const char ***out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_list_attr_shallow", args);
  Py_DECREF(args);
  CHECK_PY(r);
  mx_uint n = 0;
  if (StrListOut(r, &n, out) != 0) {
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  *out_size = n / 2;  // reference convention: pairs, size = pair count
  API_END();
}

int MXSymbolGetName(SymbolHandle symbol, const char **out, int *success) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_get_name", args);
  Py_DECREF(args);
  CHECK_PY(r);
  if (r == Py_None) {
    *success = 0;
    *out = nullptr;
  } else {
    if (StrOut(r, &scratch.json) != 0) {
      Py_DECREF(r);
      return -1;
    }
    *out = scratch.json.c_str();
    *success = 1;
  }
  Py_DECREF(r);
  API_END();
}

int MXSymbolGetChildren(SymbolHandle symbol, SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_get_children", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolSaveToFile(SymbolHandle symbol, const char *fname) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Os)", reinterpret_cast<PyObject *>(symbol),
                                 fname);
  PyObject *r = CallShim("symbol_save_to_file", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXSymbolGetInternals(SymbolHandle symbol, SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(symbol));
  PyObject *r = CallShim("symbol_get_internals", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolGetOutput(SymbolHandle symbol, mx_uint index, SymbolHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(OI)", reinterpret_cast<PyObject *>(symbol),
                                 index);
  PyObject *r = CallShim("symbol_get_output", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXSymbolInferType(SymbolHandle sym, mx_uint num_args, const char **keys,
                      const int *arg_type_data, mx_uint *in_type_size,
                      const int **in_type_data, mx_uint *out_type_size,
                      const int **out_type_data, mx_uint *aux_type_size,
                      const int **aux_type_data, int *complete) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(ONN)", reinterpret_cast<PyObject *>(sym),
                                 StrList(num_args, keys),
                                 IntList(num_args, arg_type_data));
  PyObject *r = CallShim("symbol_infer_type", args);
  Py_DECREF(args);
  CHECK_PY(r);
  if (r == Py_None) {
    *complete = 0;
    *in_type_size = *out_type_size = *aux_type_size = 0;
    Py_DECREF(r);
    return 0;
  }
  auto fill = [](PyObject *list, std::vector<int> *dst, mx_uint *size,
                 const int **data) {
    Py_ssize_t n = PyList_Size(list);
    dst->clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      dst->push_back(static_cast<int>(PyLong_AsLong(PyList_GetItem(list, i))));
    }
    *size = static_cast<mx_uint>(n);
    *data = dst->data();
  };
  fill(PyTuple_GetItem(r, 0), &scratch.in_types, in_type_size, in_type_data);
  fill(PyTuple_GetItem(r, 1), &scratch.out_types, out_type_size,
       out_type_data);
  fill(PyTuple_GetItem(r, 2), &scratch.aux_types, aux_type_size,
       aux_type_data);
  *complete = 1;
  Py_DECREF(r);
  API_END();
}

static int InferShapeImpl(const char *shim, SymbolHandle sym,
                          mx_uint num_args, const char **keys,
                          const mx_uint *arg_ind_ptr,
                          const mx_uint *arg_shape_data,
                          mx_uint *in_shape_size,
                          const mx_uint **in_shape_ndim,
                          const mx_uint ***in_shape_data,
                          mx_uint *out_shape_size,
                          const mx_uint **out_shape_ndim,
                          const mx_uint ***out_shape_data,
                          mx_uint *aux_shape_size,
                          const mx_uint **aux_shape_ndim,
                          const mx_uint ***aux_shape_data, int *complete) {
  API_BEGIN();
  PyObject *names = StrList(num_args, keys);
  PyObject *shapes = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    mx_uint lo = arg_ind_ptr[i], hi = arg_ind_ptr[i + 1];
    PyObject *t = PyTuple_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j) {
      PyTuple_SET_ITEM(t, j - lo, PyLong_FromUnsignedLong(arg_shape_data[j]));
    }
    PyList_SET_ITEM(shapes, i, t);
  }
  PyObject *args = Py_BuildValue("(ONN)", reinterpret_cast<PyObject *>(sym),
                                 names, shapes);
  PyObject *r = CallShim(shim, args);
  Py_DECREF(args);
  CHECK_PY(r);
  if (r == Py_None) {
    *complete = 0;
    *in_shape_size = *out_shape_size = *aux_shape_size = 0;
    Py_DECREF(r);
    return 0;
  }
  auto fill = [](PyObject *tup, ThreadLocalScratch::ShapeArena *a,
                 mx_uint *size, const mx_uint **ndim,
                 const mx_uint ***data) {
    Py_ssize_t n = PyTuple_Size(tup);
    a->dims.assign(n, {});
    a->ndims.clear();
    a->ptrs.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject *s = PyTuple_GetItem(tup, i);
      Py_ssize_t d = PyTuple_Size(s);
      for (Py_ssize_t j = 0; j < d; ++j) {
        a->dims[i].push_back(static_cast<mx_uint>(
            PyLong_AsUnsignedLong(PyTuple_GetItem(s, j))));
      }
      a->ndims.push_back(static_cast<mx_uint>(d));
    }
    for (auto &v : a->dims) a->ptrs.push_back(v.data());
    *size = static_cast<mx_uint>(n);
    *ndim = a->ndims.data();
    *data = a->ptrs.data();
  };
  fill(PyTuple_GetItem(r, 0), &scratch.shapes_in, in_shape_size,
       in_shape_ndim, in_shape_data);
  fill(PyTuple_GetItem(r, 1), &scratch.shapes_out, out_shape_size,
       out_shape_ndim, out_shape_data);
  fill(PyTuple_GetItem(r, 2), &scratch.shapes_aux, aux_shape_size,
       aux_shape_ndim, aux_shape_data);
  /* the partial shim appends an explicit resolved-flag; the full shim
   * signalled incompleteness with None above */
  *complete = (PyTuple_Size(r) > 3)
      ? static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 3))) : 1;
  Py_DECREF(r);
  API_END();
}

int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args, const char **keys,
                       const mx_uint *arg_ind_ptr,
                       const mx_uint *arg_shape_data, mx_uint *in_shape_size,
                       const mx_uint **in_shape_ndim,
                       const mx_uint ***in_shape_data,
                       mx_uint *out_shape_size, const mx_uint **out_shape_ndim,
                       const mx_uint ***out_shape_data,
                       mx_uint *aux_shape_size, const mx_uint **aux_shape_ndim,
                       const mx_uint ***aux_shape_data, int *complete) {
  return InferShapeImpl("symbol_infer_shape", sym, num_args, keys,
                        arg_ind_ptr, arg_shape_data, in_shape_size,
                        in_shape_ndim, in_shape_data, out_shape_size,
                        out_shape_ndim, out_shape_data, aux_shape_size,
                        aux_shape_ndim, aux_shape_data, complete);
}

int MXSymbolInferShapePartial(
    SymbolHandle sym, mx_uint num_args, const char **keys,
    const mx_uint *arg_ind_ptr, const mx_uint *arg_shape_data,
    mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
    const mx_uint ***in_shape_data, mx_uint *out_shape_size,
    const mx_uint **out_shape_ndim, const mx_uint ***out_shape_data,
    mx_uint *aux_shape_size, const mx_uint **aux_shape_ndim,
    const mx_uint ***aux_shape_data, int *complete) {
  return InferShapeImpl("symbol_infer_shape_partial", sym, num_args, keys,
                        arg_ind_ptr, arg_shape_data, in_shape_size,
                        in_shape_ndim, in_shape_data, out_shape_size,
                        out_shape_ndim, out_shape_data, aux_shape_size,
                        aux_shape_ndim, aux_shape_data, complete);
}

int MXSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char **wrt,
                 SymbolHandle *out) {
  (void)sym;
  (void)num_wrt;
  (void)wrt;
  (void)out;
  last_error = "MXSymbolGrad is deprecated (reference parity): bind an "
               "executor and call MXExecutorBackward";
  return -1;
}

/* ---------------------------------------------------------------- Executor */
int MXExecutorBind(SymbolHandle symbol_handle, int dev_type, int dev_id,
                   mx_uint len, NDArrayHandle *in_args,
                   NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                   mx_uint aux_states_len, NDArrayHandle *aux_states,
                   ExecutorHandle *out) {
  API_BEGIN();
  PyObject *reqs = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i) {
    PyList_SET_ITEM(reqs, i, PyLong_FromUnsignedLong(grad_req_type[i]));
  }
  PyObject *args = Py_BuildValue(
      "(OiiNNNN)", reinterpret_cast<PyObject *>(symbol_handle), dev_type,
      dev_id, NDList(len, in_args), NDList(len, arg_grad_store), reqs,
      NDList(aux_states_len, aux_states));
  PyObject *r = CallShim("executor_bind", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXExecutorBindX(SymbolHandle symbol_handle, int dev_type, int dev_id,
                    mx_uint num_map_keys, const char **map_keys,
                    const int *map_dev_types, const int *map_dev_ids,
                    mx_uint len, NDArrayHandle *in_args,
                    NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                    mx_uint aux_states_len, NDArrayHandle *aux_states,
                    ExecutorHandle *out) {
  (void)map_keys;
  (void)map_dev_types;
  (void)map_dev_ids;
  if (num_map_keys != 0) {
    last_error = "MXExecutorBindX: group2ctx maps are not supported over "
                 "the C boundary; bind model-parallel graphs from Python";
    return -1;
  }
  return MXExecutorBind(symbol_handle, dev_type, dev_id, len, in_args,
                        arg_grad_store, grad_req_type, aux_states_len,
                        aux_states, out);
}

int MXExecutorBindEX(SymbolHandle symbol_handle, int dev_type, int dev_id,
                     mx_uint num_map_keys, const char **map_keys,
                     const int *map_dev_types, const int *map_dev_ids,
                     mx_uint len, NDArrayHandle *in_args,
                     NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                     mx_uint aux_states_len, NDArrayHandle *aux_states,
                     ExecutorHandle shared_exec, ExecutorHandle *out) {
  if (shared_exec != nullptr) {
    last_error = "MXExecutorBindEX: shared_exec memory sharing is not "
                 "kept here (bucketing shares parameters through "
                 "Module.bind(shared_module=)); pass NULL";
    return -1;
  }
  return MXExecutorBindX(symbol_handle, dev_type, dev_id, num_map_keys,
                         map_keys, map_dev_types, map_dev_ids, len, in_args,
                         arg_grad_store, grad_req_type, aux_states_len,
                         aux_states, out);
}

int MXExecutorFree(ExecutorHandle handle) {
  API_BEGIN();
  Py_XDECREF(reinterpret_cast<PyObject *>(handle));
  API_END();
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Oi)", reinterpret_cast<PyObject *>(handle),
                                 is_train);
  PyObject *r = CallShim("executor_forward", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                       NDArrayHandle *head_grads) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(ON)", reinterpret_cast<PyObject *>(handle),
                                 NDList(len, head_grads));
  PyObject *r = CallShim("executor_backward", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXExecutorOutputs(ExecutorHandle handle, mx_uint *out_size,
                      NDArrayHandle **out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("executor_outputs", args);
  Py_DECREF(args);
  CHECK_PY(r);
  HandleListOut(r, out_size, out);
  Py_DECREF(r);
  API_END();
}

int MXExecutorPrint(ExecutorHandle handle, const char **out_str) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("executor_print", args);
  Py_DECREF(args);
  CHECK_PY(r);
  int rc = StrOut(r, &scratch.json);
  Py_DECREF(r);
  if (rc != 0) return -1;
  *out_str = scratch.json.c_str();
  API_END();
}

int MXExecutorSetMonitorCallback(ExecutorHandle handle,
                                 ExecutorMonitorCallback callback,
                                 void *callback_handle) {
  API_BEGIN();
  auto *closure = new MonitorClosure{callback, callback_handle};
  PyObject *cap = PyCapsule_New(closure, "mxtpu_monitor", FreeMonitorClosure);
  if (cap == nullptr) {
    delete closure;
    last_error = FetchPyError();
    return -1;
  }
  PyObject *fn = PyCFunction_New(&g_monitor_def, nullptr);
  PyObject *args = Py_BuildValue("(ONN)",
                                 reinterpret_cast<PyObject *>(handle), fn,
                                 cap);
  PyObject *r = CallShim("executor_set_monitor", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXCustomOpRegister(const char *op_type, CustomOpPropCreator creator) {
  API_BEGIN();
  PyObject *cap = PyCapsule_New(reinterpret_cast<void *>(creator),
                                "mxtpu_custom_creator", nullptr);
  CHECK_PY(cap);
  PyObject *args = Py_BuildValue(
      "(sNNNN)", op_type, PyCFunction_New(&g_custom_create_def, nullptr),
      PyCFunction_New(&g_custom_prop_def, nullptr),
      PyCFunction_New(&g_custom_op_def, nullptr), cap);
  PyObject *r = CallShim("custom_op_register_native", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

/* ----------------------------------------------------------------- KVStore */
/* Role predicates (parity: c_api.h:1288-1304).  There are no separate
 * server/scheduler processes: every process is a worker unless the launch
 * contract says otherwise. */
static int RoleIs(const char *want) {
  const char *role = std::getenv("MXTPU_ROLE");
  if (role == nullptr) role = std::getenv("DMLC_ROLE");
  if (role == nullptr) role = "worker";
  return std::strcmp(role, want) == 0 ? 1 : 0;
}

int MXKVStoreIsWorkerNode(int *ret) {
  *ret = RoleIs("worker");
  return 0;
}

int MXKVStoreIsServerNode(int *ret) {
  *ret = RoleIs("server");
  return 0;
}

int MXKVStoreIsSchedulerNode(int *ret) {
  *ret = RoleIs("scheduler");
  return 0;
}

int MXKVStoreCreate(const char *type, KVStoreHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(s)", type);
  PyObject *r = CallShim("kvstore_create", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXKVStoreFree(KVStoreHandle handle) {
  API_BEGIN();
  Py_XDECREF(reinterpret_cast<PyObject *>(handle));
  API_END();
}

static PyObject *KVKeyList(mx_uint num, const int *keys) {
  PyObject *l = PyList_New(num);
  for (mx_uint i = 0; i < num; ++i) {
    PyList_SET_ITEM(l, i, PyLong_FromLong(keys[i]));
  }
  return l;
}

int MXKVStoreInit(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(ONN)", reinterpret_cast<PyObject *>(handle),
                                 KVKeyList(num, keys), NDList(num, vals));
  PyObject *r = CallShim("kvstore_init", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXKVStorePush(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals, int priority) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(ONNi)",
                                 reinterpret_cast<PyObject *>(handle),
                                 KVKeyList(num, keys), NDList(num, vals),
                                 priority);
  PyObject *r = CallShim("kvstore_push", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXKVStorePull(KVStoreHandle handle, mx_uint num, const int *keys,
                  NDArrayHandle *vals, int priority) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(ONNi)",
                                 reinterpret_cast<PyObject *>(handle),
                                 KVKeyList(num, keys), NDList(num, vals),
                                 priority);
  PyObject *r = CallShim("kvstore_pull", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXKVStoreSetUpdater(KVStoreHandle handle, MXKVStoreUpdater updater,
                        void *updater_handle) {
  API_BEGIN();
  auto *closure = new UpdaterClosure{updater, updater_handle};
  PyObject *cap = PyCapsule_New(closure, "mxtpu_updater", FreeUpdaterClosure);
  if (cap == nullptr) {
    delete closure;
    last_error = FetchPyError();
    return -1;
  }
  PyObject *fn = PyCFunction_New(&g_updater_def, nullptr);
  PyObject *args = Py_BuildValue("(ONN)",
                                 reinterpret_cast<PyObject *>(handle), fn,
                                 cap);
  PyObject *r = CallShim("kvstore_set_updater", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXKVStoreGetType(KVStoreHandle handle, const char **type) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("kvstore_get_type", args);
  Py_DECREF(args);
  CHECK_PY(r);
  int rc = StrOut(r, &scratch.json);
  Py_DECREF(r);
  if (rc != 0) return -1;
  *type = scratch.json.c_str();
  API_END();
}

int MXKVStoreGetRank(KVStoreHandle handle, int *rank) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("kvstore_get_rank", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *rank = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  API_END();
}

int MXKVStoreGetGroupSize(KVStoreHandle handle, int *size) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("kvstore_get_group_size", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *size = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  API_END();
}

int MXKVStoreBarrier(KVStoreHandle handle) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("kvstore_barrier", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXKVStoreSetBarrierBeforeExit(KVStoreHandle handle,
                                  int barrier_before_exit) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Oi)", reinterpret_cast<PyObject *>(handle),
                                 barrier_before_exit);
  PyObject *r = CallShim("kvstore_set_barrier_before_exit", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXKVStoreGetNumDeadNode(KVStoreHandle handle, int node_id, int *number,
                            int timeout_sec) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Oii)", reinterpret_cast<PyObject *>(handle),
                                 node_id, timeout_sec);
  PyObject *r = CallShim("kvstore_get_num_dead_node", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *number = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  API_END();
}

int MXKVStoreSendCommmandToServers(KVStoreHandle handle, int head,
                                   const char *body) {
  API_BEGIN();
  PyObject *payload = PyBytes_FromString(body != nullptr ? body : "");
  PyObject *args = Py_BuildValue("(OiN)",
                                 reinterpret_cast<PyObject *>(handle), head,
                                 payload);
  PyObject *r = CallShim("kvstore_send_command_to_servers", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXKVStoreRunServer(KVStoreHandle handle) {
  (void)handle;  // SPMD allreduce kvstore: no server processes to run
  return 0;
}

int MXInitPSEnv(mx_uint num_vars, const char **keys, const char **vals) {
  API_BEGIN();
  for (mx_uint i = 0; i < num_vars; ++i) {
    setenv(keys[i], vals[i], 1);
  }
  API_END();
}

/* ---------------------------------------------------------------- DataIter */
int MXListDataIters(mx_uint *out_size, DataIterCreator **out) {
  API_BEGIN();
  static std::vector<PyObject *> iters;  // stable creator handles
  if (iters.empty()) {
    PyObject *r = CallShim("list_data_iters", nullptr);
    CHECK_PY(r);
    Py_ssize_t n = PyList_Size(r);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject *s = PyList_GetItem(r, i);
      Py_INCREF(s);
      iters.push_back(s);
    }
    Py_DECREF(r);
  }
  *out_size = static_cast<mx_uint>(iters.size());
  *out = reinterpret_cast<DataIterCreator *>(iters.data());
  API_END();
}

int MXDataIterGetIterInfo(DataIterCreator creator, const char **name,
                          const char **description) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(creator));
  PyObject *r = CallShim("data_iter_info", args);
  Py_DECREF(args);
  CHECK_PY(r);
  static thread_local std::string nm, doc;
  if (StrOut(PyTuple_GetItem(r, 0), &nm) != 0 ||
      StrOut(PyTuple_GetItem(r, 1), &doc) != 0) {
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  *name = nm.c_str();
  *description = doc.c_str();
  API_END();
}

int MXDataIterCreateIter(DataIterCreator creator, mx_uint num_param,
                         const char **keys, const char **vals,
                         DataIterHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(ONN)",
                                 reinterpret_cast<PyObject *>(creator),
                                 StrList(num_param, keys),
                                 StrList(num_param, vals));
  PyObject *r = CallShim("data_iter_create", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXDataIterFree(DataIterHandle handle) {
  API_BEGIN();
  Py_XDECREF(reinterpret_cast<PyObject *>(handle));
  API_END();
}

int MXDataIterNext(DataIterHandle handle, int *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("data_iter_next", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  API_END();
}

int MXDataIterBeforeFirst(DataIterHandle handle) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("data_iter_before_first", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXDataIterGetData(DataIterHandle handle, NDArrayHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("data_iter_get_data", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("data_iter_get_label", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXDataIterGetPadNum(DataIterHandle handle, int *pad) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("data_iter_get_pad_num", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *pad = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  API_END();
}

int MXDataIterGetIndex(DataIterHandle handle, uint64_t **out_index,
                       uint64_t *out_size) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("data_iter_get_index", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_ssize_t n = PyList_Size(r);
  scratch.index.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    scratch.index.push_back(PyLong_AsUnsignedLongLong(PyList_GetItem(r, i)));
  }
  Py_DECREF(r);
  *out_size = static_cast<uint64_t>(n);
  *out_index = scratch.index.data();
  API_END();
}

/* ---------------------------------------------------------------- Profiler */
int MXSetProfilerConfig(int mode, const char *filename) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(is)", mode, filename);
  PyObject *r = CallShim("profiler_set_config", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXSetProfilerState(int state) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(i)", state);
  PyObject *r = CallShim("profiler_set_state", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXDumpProfile() {
  API_BEGIN();
  PyObject *r = CallShim("profiler_dump", nullptr);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

/* ---------------------------------------------------------------- RecordIO */
static int RecordIOCreate(const char *fn, const char *uri,
                          RecordIOHandle *out) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(s)", uri);
  PyObject *r = CallShim(fn, args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

static int RecordIOFree(RecordIOHandle handle) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("recordio_close", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  Py_XDECREF(reinterpret_cast<PyObject *>(handle));
  API_END();
}

int MXRecordIOWriterCreate(const char *uri, RecordIOHandle *out) {
  return RecordIOCreate("recordio_writer_create", uri, out);
}

int MXRecordIOWriterFree(RecordIOHandle handle) {
  return RecordIOFree(handle);
}

int MXRecordIOWriterWriteRecord(RecordIOHandle handle, const char *buf,
                                size_t size) {
  API_BEGIN();
  if (size == 0) {
    // the read contract uses *size == 0 as end-of-stream, so a zero-length
    // record would truncate every record after it on read
    last_error = "MXRecordIOWriterWriteRecord: zero-length records are not "
                 "representable through the C API";
    return -1;
  }
  PyObject *bytes = PyBytes_FromStringAndSize(buf, size);
  PyObject *args = Py_BuildValue("(ON)",
                                 reinterpret_cast<PyObject *>(handle), bytes);
  PyObject *r = CallShim("recordio_writer_write", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXRecordIOWriterTell(RecordIOHandle handle, size_t *pos) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("recordio_tell", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *pos = static_cast<size_t>(PyLong_AsSize_t(r));
  Py_DECREF(r);
  API_END();
}

int MXRecordIOReaderCreate(const char *uri, RecordIOHandle *out) {
  return RecordIOCreate("recordio_reader_create", uri, out);
}

int MXRecordIOReaderFree(RecordIOHandle handle) {
  return RecordIOFree(handle);
}

int MXRecordIOReaderReadRecord(RecordIOHandle handle, const char **buf,
                               size_t *size) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("recordio_reader_read", args);
  Py_DECREF(args);
  CHECK_PY(r);
  char *b = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &b, &len) != 0) {
    Py_DECREF(r);
    last_error = FetchPyError();
    return -1;
  }
  scratch.json.assign(b, static_cast<size_t>(len));
  Py_DECREF(r);
  *buf = scratch.json.data();
  *size = scratch.json.size();
  API_END();
}

int MXRecordIOReaderSeek(RecordIOHandle handle, size_t pos) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(On)",
                                 reinterpret_cast<PyObject *>(handle),
                                 static_cast<Py_ssize_t>(pos));
  PyObject *r = CallShim("recordio_reader_seek", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

/* --------------------------------------------------------------- Predictor */
int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                 int param_size, int dev_type, int dev_id,
                 mx_uint num_input_nodes, const char **input_keys,
                 const mx_uint *input_shape_indptr,
                 const mx_uint *input_shape_data, PredictorHandle *out) {
  API_BEGIN();
  PyObject *names = PyTuple_New(num_input_nodes);
  PyObject *shapes = PyTuple_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyTuple_SET_ITEM(names, i, PyUnicode_FromString(input_keys[i]));
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyTuple_SET_ITEM(shapes, i, ShapeTuple(input_shape_data + lo, hi - lo));
  }
  PyObject *blob = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(param_bytes), param_size);
  PyObject *args = Py_BuildValue("(sNiiNN)", symbol_json_str, blob, dev_type,
                                 dev_id, names, shapes);
  PyObject *r = CallShim("pred_create", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXPredCreatePartialOut(const char *symbol_json_str,
                           const void *param_bytes, int param_size,
                           int dev_type, int dev_id,
                           mx_uint num_input_nodes, const char **input_keys,
                           const mx_uint *input_shape_indptr,
                           const mx_uint *input_shape_data,
                           mx_uint num_output_nodes,
                           const char **output_keys, PredictorHandle *out) {
  API_BEGIN();
  PyObject *names = PyTuple_New(num_input_nodes);
  PyObject *shapes = PyTuple_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyTuple_SET_ITEM(names, i, PyUnicode_FromString(input_keys[i]));
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyTuple_SET_ITEM(shapes, i, ShapeTuple(input_shape_data + lo, hi - lo));
  }
  PyObject *blob = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(param_bytes), param_size);
  PyObject *args = Py_BuildValue("(sNiiNNN)", symbol_json_str, blob,
                                 dev_type, dev_id, names, shapes,
                                 StrList(num_output_nodes, output_keys));
  PyObject *r = CallShim("pred_create_partial", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *out = r;
  API_END();
}

int MXPredPartialForward(PredictorHandle handle, int step, int *step_left) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(Oi)",
                                 reinterpret_cast<PyObject *>(handle), step);
  PyObject *r = CallShim("pred_partial_forward", args);
  Py_DECREF(args);
  CHECK_PY(r);
  *step_left = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  API_END();
}

int MXNDListCreate(const char *nd_file_bytes, int nd_file_size,
                   NDListHandle *out, mx_uint *out_length) {
  API_BEGIN();
  PyObject *blob = PyBytes_FromStringAndSize(nd_file_bytes, nd_file_size);
  PyObject *args = Py_BuildValue("(N)", blob);
  PyObject *r = CallShim("ndlist_create", args);
  Py_DECREF(args);
  CHECK_PY(r);
  PyObject *lst = PyTuple_GetItem(r, 0);
  *out_length = static_cast<mx_uint>(
      PyLong_AsUnsignedLong(PyTuple_GetItem(r, 1)));
  Py_INCREF(lst);
  Py_DECREF(r);
  *out = lst;
  API_END();
}

int MXNDListGet(NDListHandle handle, mx_uint index, const char **out_key,
                const mx_float **out_data, const mx_uint **out_shape,
                mx_uint *out_ndim) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(OI)",
                                 reinterpret_cast<PyObject *>(handle), index);
  PyObject *r = CallShim("ndlist_get", args);
  Py_DECREF(args);
  CHECK_PY(r);
  /* every returned pointer aliases an object OWNED BY THE LIST HANDLE
   * (key str, data bytes, packed-u32 shape bytes), so all entries stay
   * valid simultaneously until MXNDListFree — the reference's contract.
   * PyUnicode_AsUTF8's buffer is cached inside the str object. */
  const char *key = PyUnicode_AsUTF8(PyTuple_GetItem(r, 0));
  char *buf = nullptr, *shp = nullptr;
  Py_ssize_t blen = 0, slen = 0;
  if (key == nullptr ||
      PyBytes_AsStringAndSize(PyTuple_GetItem(r, 1), &buf, &blen) != 0 ||
      PyBytes_AsStringAndSize(PyTuple_GetItem(r, 2), &shp, &slen) != 0) {
    Py_DECREF(r);
    last_error = FetchPyError();
    return -1;
  }
  *out_ndim = static_cast<mx_uint>(
      PyLong_AsUnsignedLong(PyTuple_GetItem(r, 3)));
  *out_key = key;
  *out_data = reinterpret_cast<const mx_float *>(buf);
  *out_shape = reinterpret_cast<const mx_uint *>(shp);
  Py_DECREF(r);
  API_END();
}

int MXNDListFree(NDListHandle handle) {
  API_BEGIN();
  Py_XDECREF(reinterpret_cast<PyObject *>(handle));
  API_END();
}

int MXPredSetInput(PredictorHandle handle, const char *key,
                   const mx_float *data, mx_uint size) {
  API_BEGIN();
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data), size * sizeof(mx_float));
  PyObject *args = Py_BuildValue("(OsN)",
                                 reinterpret_cast<PyObject *>(handle), key,
                                 bytes);
  PyObject *r = CallShim("pred_set_input", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXPredForward(PredictorHandle handle) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle));
  PyObject *r = CallShim("pred_forward", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_DECREF(r);
  API_END();
}

int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint **shape_data, mx_uint *shape_ndim) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(OI)",
                                 reinterpret_cast<PyObject *>(handle), index);
  PyObject *r = CallShim("pred_get_output_shape", args);
  Py_DECREF(args);
  CHECK_PY(r);
  Py_ssize_t n = PyTuple_Size(r);
  scratch.shape.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    scratch.shape.push_back(static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(r, i))));
  }
  Py_DECREF(r);
  *shape_ndim = static_cast<mx_uint>(n);
  *shape_data = scratch.shape.data();
  API_END();
}

int MXPredGetOutput(PredictorHandle handle, mx_uint index, mx_float *data,
                    mx_uint size) {
  API_BEGIN();
  PyObject *args = Py_BuildValue("(OI)",
                                 reinterpret_cast<PyObject *>(handle), index);
  PyObject *r = CallShim("pred_get_output", args);
  Py_DECREF(args);
  CHECK_PY(r);
  char *buf = nullptr;
  Py_ssize_t len = 0;
  PyBytes_AsStringAndSize(r, &buf, &len);
  size_t want = size * sizeof(mx_float);
  if (static_cast<size_t>(len) != want) {
    Py_DECREF(r);
    last_error = "MXPredGetOutput: size mismatch (output has " +
                 std::to_string(len / sizeof(mx_float)) +
                 " elements, caller passed " + std::to_string(size) + ")";
    return -1;
  }
  std::memcpy(data, buf, want);
  Py_DECREF(r);
  API_END();
}

int MXPredFree(PredictorHandle handle) {
  API_BEGIN();
  Py_XDECREF(reinterpret_cast<PyObject *>(handle));
  API_END();
}

}  // extern "C"
