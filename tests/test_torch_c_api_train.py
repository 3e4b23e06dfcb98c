"""Training through the port's C API only, on the CPU (dev_type 1): symbol
composition, bind, forward, backward, kvstore push and pull with a C
updater, a converged MLP, without the Python frontend.  Numpy only makes
the data and checks the results; every framework call goes through the
library ``ops.kernel_build.HostLibrary`` builds from ``csrc/c_api.cc``.

Twins of tests/python/unittest/test_c_api_train.py, and beside them: MLP
training steps through the C API held to the same steps through the JAX
package's executor (every parameter within FLOOR_X times the JAX
package's own float32 floor: its distance to the same steps from
parameters nudged by NUDGE), raw bytes byte for byte against the JAX
package's, float64 in the typed save/load (the JAX package runs without
x64), and the ``dist*`` stores at rank 0 of 1.
"""
import ctypes

import numpy as np

from test_torch_c_api import _check, host, libmx, mx  # noqa: F401
from test_torch_threads import torch_threads_per_worker  # noqa: F401

FLOOR_X = 4.0
FLOOR_MIN = 1e-6
NUDGE = 2.0 ** -20
c_uint_p = ctypes.POINTER(ctypes.c_uint)
c_int_p = ctypes.POINTER(ctypes.c_int)
Handle = ctypes.c_void_p


def _strs(*vals):
    arr = (ctypes.c_char_p * len(vals))()
    arr[:] = [v.encode() for v in vals]
    return arr


def _nd_create(lib, shape):
    h = Handle()
    cshape = (ctypes.c_uint * len(shape))(*shape)
    _check(lib, lib.MXNDArrayCreate(cshape, len(shape), 1, 0, 0,
                                    ctypes.byref(h)))
    return h


def _nd_set(lib, h, arr):
    arr = np.ascontiguousarray(arr, dtype="<f4")
    _check(lib, lib.MXNDArraySyncCopyFromCPU(
        h, arr.ctypes.data_as(ctypes.c_void_p), arr.size))


def _nd_get(lib, h):
    ndim = ctypes.c_uint()
    pdata = c_uint_p()
    _check(lib, lib.MXNDArrayGetShape(h, ctypes.byref(ndim),
                                      ctypes.byref(pdata)))
    shape = tuple(pdata[i] for i in range(ndim.value))
    out = np.empty(shape, dtype="<f4")
    n = int(np.prod(shape)) if shape else 1
    _check(lib, lib.MXNDArraySyncCopyToCPU(
        h, out.ctypes.data_as(ctypes.c_void_p), n))
    return out


def _atomic(lib, op, keys=(), vals=()):
    """CreateAtomicSymbol via a creator handle found by name."""
    n = ctypes.c_uint()
    creators = ctypes.POINTER(Handle)()
    _check(lib, lib.MXSymbolListAtomicSymbolCreators(ctypes.byref(n),
                                                     ctypes.byref(creators)))
    name = ctypes.c_char_p()
    creator = None
    for i in range(n.value):
        c = Handle(creators[i])
        _check(lib, lib.MXSymbolGetAtomicSymbolName(c, ctypes.byref(name)))
        if name.value.decode() == op:
            creator = c
            break
    assert creator is not None, "op %s not found" % op
    out = Handle()
    _check(lib, lib.MXSymbolCreateAtomicSymbol(
        creator, len(keys), _strs(*keys), _strs(*vals), ctypes.byref(out)))
    return out


def _compose(lib, sym, name, **inputs):
    keys = _strs(*inputs.keys())
    args = (Handle * len(inputs))(*[v for v in inputs.values()])
    _check(lib, lib.MXSymbolCompose(sym, name.encode(), len(inputs), keys,
                                    args))
    return sym


def _variable(lib, name):
    out = Handle()
    _check(lib, lib.MXSymbolCreateVariable(name.encode(), ctypes.byref(out)))
    return out


def test_reflection(libmx):
    lib = libmx
    n = ctypes.c_uint()
    creators = ctypes.POINTER(Handle)()
    _check(lib, lib.MXSymbolListAtomicSymbolCreators(ctypes.byref(n),
                                                     ctypes.byref(creators)))
    assert n.value > 200  # the full operator registry is visible
    # reflect FullyConnected (the cpp-package autogen path)
    fc = None
    name = ctypes.c_char_p()
    for i in range(n.value):
        _check(lib, lib.MXSymbolGetAtomicSymbolName(Handle(creators[i]),
                                                    ctypes.byref(name)))
        if name.value == b"FullyConnected":
            fc = Handle(creators[i])
    desc = ctypes.c_char_p()
    num_args = ctypes.c_uint()
    names = ctypes.POINTER(ctypes.c_char_p)()
    types = ctypes.POINTER(ctypes.c_char_p)()
    descs = ctypes.POINTER(ctypes.c_char_p)()
    kv = ctypes.c_char_p()
    _check(lib, lib.MXSymbolGetAtomicSymbolInfo(
        fc, ctypes.byref(name), ctypes.byref(desc), ctypes.byref(num_args),
        ctypes.byref(names), ctypes.byref(types), ctypes.byref(descs),
        ctypes.byref(kv)))
    got = [names[i].decode() for i in range(num_args.value)]
    assert "data" in got and "weight" in got and "num_hidden" in got


def test_imperative_invoke(libmx):
    lib = libmx
    a = _nd_create(lib, (2, 3))
    b = _nd_create(lib, (2, 3))
    _nd_set(lib, a, np.arange(6).reshape(2, 3))
    _nd_set(lib, b, np.ones((2, 3)))
    n = ctypes.c_uint()
    creators = ctypes.POINTER(Handle)()
    _check(lib, lib.MXSymbolListAtomicSymbolCreators(ctypes.byref(n),
                                                     ctypes.byref(creators)))
    name = ctypes.c_char_p()
    plus = None
    for i in range(n.value):
        _check(lib, lib.MXSymbolGetAtomicSymbolName(Handle(creators[i]),
                                                    ctypes.byref(name)))
        if name.value == b"elemwise_add":
            plus = Handle(creators[i])
    inputs = (Handle * 2)(a, b)
    num_out = ctypes.c_int(0)
    outputs = ctypes.POINTER(Handle)()
    _check(lib, lib.MXImperativeInvoke(
        plus, 2, inputs, ctypes.byref(num_out), ctypes.byref(outputs),
        0, None, None))
    assert num_out.value == 1
    out = _nd_get(lib, Handle(outputs[0]))
    np.testing.assert_allclose(out, np.arange(6).reshape(2, 3) + 1)
    for h in (a, b, Handle(outputs[0])):
        _check(lib, lib.MXNDArrayFree(h))


def _mlp_data():
    rng = np.random.RandomState(0)
    n, nin = 200, 10
    labels = rng.randint(0, 2, n).astype(np.float32)
    data = (rng.randn(n, nin) * 0.5 + labels[:, None] * 2.0) \
        .astype(np.float32)
    return rng, data, labels


def _c_mlp(lib, ncls=2):
    """data -> FC(32) -> relu -> FC(ncls) -> SoftmaxOutput, composed
    through the C API."""
    x = _variable(lib, "data")
    fc1 = _compose(lib, _atomic(lib, "FullyConnected",
                                ("num_hidden",), ("32",)), "fc1", data=x)
    act = _compose(lib, _atomic(lib, "Activation",
                                ("act_type",), ("relu",)), "relu1", data=fc1)
    fc2 = _compose(lib, _atomic(lib, "FullyConnected",
                                ("num_hidden",), (str(ncls),)), "fc2",
                   data=act)
    lab = _variable(lib, "softmax_label")
    return _compose(lib, _atomic(lib, "SoftmaxOutput"), "softmax",
                    data=fc2, label=lab)


def test_train_mlp_via_c_api(libmx):
    """bind -> forward -> backward -> kvstore push/pull (C updater) -> learn."""
    lib = libmx
    rng, data, labels = _mlp_data()
    n, nin = data.shape
    loss = _c_mlp(lib)

    # ---- arg introspection + shape inference
    nargs = ctypes.c_uint()
    argnames_c = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXSymbolListArguments(loss, ctypes.byref(nargs),
                                          ctypes.byref(argnames_c)))
    arg_names = [argnames_c[i].decode() for i in range(nargs.value)]
    assert arg_names[0] == "data" and arg_names[-1] == "softmax_label"

    batch = 20
    ind_ptr = (ctypes.c_uint * 3)(0, 2, 3)
    shape_data = (ctypes.c_uint * 3)(batch, nin, batch)
    in_size = ctypes.c_uint()
    in_ndim = c_uint_p()
    in_data = ctypes.POINTER(c_uint_p)()
    out_size = ctypes.c_uint()
    out_ndim = c_uint_p()
    out_data = ctypes.POINTER(c_uint_p)()
    aux_size = ctypes.c_uint()
    aux_ndim = c_uint_p()
    aux_data = ctypes.POINTER(c_uint_p)()
    complete = ctypes.c_int()
    _check(lib, lib.MXSymbolInferShape(
        loss, 2, _strs("data", "softmax_label"), ind_ptr, shape_data,
        ctypes.byref(in_size), ctypes.byref(in_ndim), ctypes.byref(in_data),
        ctypes.byref(out_size), ctypes.byref(out_ndim),
        ctypes.byref(out_data),
        ctypes.byref(aux_size), ctypes.byref(aux_ndim),
        ctypes.byref(aux_data), ctypes.byref(complete)))
    assert complete.value == 1
    arg_shapes = [tuple(in_data[i][j] for j in range(in_ndim[i]))
                  for i in range(in_size.value)]

    # ---- allocate args + grads; Xavier-ish init in numpy through the C API
    args_h, grads_h, reqs = [], [], []
    params = {}
    for name, shape in zip(arg_names, arg_shapes):
        h = _nd_create(lib, shape)
        args_h.append(h)
        if name in ("data", "softmax_label"):
            grads_h.append(None)
            reqs.append(0)          # null
        else:
            g = _nd_create(lib, shape)
            _nd_set(lib, g, np.zeros(shape))
            grads_h.append(g)
            reqs.append(1)          # write
            w = rng.uniform(-0.2, 0.2, shape).astype(np.float32) \
                if len(shape) > 1 else np.zeros(shape, np.float32)
            params[name] = h
            _nd_set(lib, h, w)

    ex = Handle()
    args_arr = (Handle * len(args_h))(*args_h)
    grads_arr = (Handle * len(args_h))(
        *[g if g is not None else None for g in grads_h])
    reqs_arr = (ctypes.c_uint * len(reqs))(*reqs)
    _check(lib, lib.MXExecutorBind(loss, 1, 0, len(args_h), args_arr,
                                   grads_arr, reqs_arr, 0, None,
                                   ctypes.byref(ex)))

    # ---- kvstore local with an SGD updater written against the C API
    kv = Handle()
    _check(lib, lib.MXKVStoreCreate(b"local", ctypes.byref(kv)))
    param_names = [nm for nm in arg_names if nm in params]
    keys = (ctypes.c_int * len(param_names))(*range(len(param_names)))
    vals = (Handle * len(param_names))(*[params[nm] for nm in param_names])
    _check(lib, lib.MXKVStoreInit(kv, len(param_names), keys, vals))

    UPDATER = ctypes.CFUNCTYPE(None, ctypes.c_int, Handle, Handle,
                               ctypes.c_void_p)

    lr = 0.05
    update_count = [0]

    def sgd_update(key, recv, local, _):
        recv, local = Handle(recv), Handle(local)  # callback args arrive as ints
        g = _nd_get(lib, recv)
        w = _nd_get(lib, local)
        _nd_set(lib, local, w - lr * g)
        update_count[0] += 1

    cb = UPDATER(sgd_update)
    _check(lib, lib.MXKVStoreSetUpdater(kv, cb, None))

    # ---- training loop: forward/backward + push/pull per batch
    grads_per_key = [grads_h[arg_names.index(nm)] for nm in param_names]
    data_h = args_h[arg_names.index("data")]
    label_h = args_h[arg_names.index("softmax_label")]
    outs_size = ctypes.c_uint()
    outs_p = ctypes.POINTER(Handle)()
    for epoch in range(30):
        for s in range(0, n, batch):
            _nd_set(lib, data_h, data[s:s + batch])
            _nd_set(lib, label_h, labels[s:s + batch])
            _check(lib, lib.MXExecutorForward(ex, 1))
            _check(lib, lib.MXExecutorBackward(ex, 0, None))
            gvals = (Handle * len(param_names))(*grads_per_key)
            _check(lib, lib.MXKVStorePush(kv, len(param_names), keys, gvals,
                                          0))
            wvals = (Handle * len(param_names))(
                *[params[nm] for nm in param_names])
            _check(lib, lib.MXKVStorePull(kv, len(param_names), keys, wvals,
                                          0))
    assert update_count[0] == 30 * (n // batch) * len(param_names)

    # ---- evaluate through the executor
    correct = 0
    for s in range(0, n, batch):
        _nd_set(lib, data_h, data[s:s + batch])
        _nd_set(lib, label_h, labels[s:s + batch])
        _check(lib, lib.MXExecutorForward(ex, 0))
        _check(lib, lib.MXExecutorOutputs(ex, ctypes.byref(outs_size),
                                          ctypes.byref(outs_p)))
        probs = _nd_get(lib, Handle(outs_p[0]))
        correct += int((probs.argmax(1) == labels[s:s + batch]).sum())
        for i in range(outs_size.value):
            _check(lib, lib.MXNDArrayFree(Handle(outs_p[i])))
    acc = correct / float(n)
    assert acc > 0.95, "C-API-trained MLP accuracy %.3f" % acc

    _check(lib, lib.MXKVStoreFree(kv))
    _check(lib, lib.MXExecutorFree(ex))


def test_data_iter_via_c_api(libmx, tmp_path):
    """MXListDataIters + CSVIter drive (reference c_api.h:1079 family)."""
    lib = libmx
    csv = tmp_path / "data.csv"
    arr = np.arange(20, dtype=np.float32).reshape(5, 4)
    np.savetxt(csv, arr, delimiter=",", fmt="%g")
    n = ctypes.c_uint()
    creators = ctypes.POINTER(Handle)()
    _check(lib, lib.MXListDataIters(ctypes.byref(n), ctypes.byref(creators)))
    assert n.value >= 3
    name = ctypes.c_char_p()
    desc = ctypes.c_char_p()
    csv_creator = None
    for i in range(n.value):
        _check(lib, lib.MXDataIterGetIterInfo(Handle(creators[i]), ctypes.byref(name),
                                              ctypes.byref(desc)))
        if name.value == b"CSVIter":
            csv_creator = Handle(creators[i])
    assert csv_creator is not None
    it = Handle()
    _check(lib, lib.MXDataIterCreateIter(
        csv_creator, 3,
        _strs("data_csv", "data_shape", "batch_size"),
        _strs(str(csv), "(4,)", "5"), ctypes.byref(it)))
    has = ctypes.c_int()
    _check(lib, lib.MXDataIterNext(it, ctypes.byref(has)))
    assert has.value == 1
    d = Handle()
    _check(lib, lib.MXDataIterGetData(it, ctypes.byref(d)))
    got = _nd_get(lib, d)
    np.testing.assert_allclose(got, arr)
    _check(lib, lib.MXNDArrayFree(d))
    _check(lib, lib.MXDataIterBeforeFirst(it))
    _check(lib, lib.MXDataIterNext(it, ctypes.byref(has)))
    assert has.value == 1
    _check(lib, lib.MXDataIterFree(it))


def test_executor_and_symbol_extras(libmx):
    lib = libmx
    x = _variable(lib, "data")
    fc = _compose(lib, _atomic(lib, "FullyConnected",
                               ("num_hidden",), ("4",)), "fc", data=x)
    # attr get/set
    _check(lib, lib.MXSymbolSetAttr(fc, b"color", b"red"))
    out = ctypes.c_char_p()
    ok = ctypes.c_int()
    _check(lib, lib.MXSymbolGetAttr(fc, b"color", ctypes.byref(out),
                                    ctypes.byref(ok)))
    assert ok.value == 1 and out.value == b"red"
    # copy + print + internals + output
    cp = Handle()
    _check(lib, lib.MXSymbolCopy(fc, ctypes.byref(cp)))
    s = ctypes.c_char_p()
    _check(lib, lib.MXSymbolPrint(cp, ctypes.byref(s)))
    assert b"fc" in s.value
    internals = Handle()
    _check(lib, lib.MXSymbolGetInternals(fc, ctypes.byref(internals)))
    nout = ctypes.c_uint()
    outs = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXSymbolListOutputs(internals, ctypes.byref(nout),
                                        ctypes.byref(outs)))
    assert nout.value >= 3
    one = Handle()
    _check(lib, lib.MXSymbolGetOutput(internals, 0, ctypes.byref(one)))
    for h in (cp, internals, one, fc, x):
        _check(lib, lib.MXSymbolFree(h))


def test_kvstore_type_rank(libmx):
    lib = libmx
    kv = Handle()
    _check(lib, lib.MXKVStoreCreate(b"local", ctypes.byref(kv)))
    t = ctypes.c_char_p()
    _check(lib, lib.MXKVStoreGetType(kv, ctypes.byref(t)))
    assert t.value == b"local"
    r = ctypes.c_int()
    _check(lib, lib.MXKVStoreGetRank(kv, ctypes.byref(r)))
    assert r.value == 0
    sz = ctypes.c_int()
    _check(lib, lib.MXKVStoreGetGroupSize(kv, ctypes.byref(sz)))
    assert sz.value == 1
    _check(lib, lib.MXKVStoreBarrier(kv))
    assert lib.MXKVStoreRunServer(kv) == 0
    _check(lib, lib.MXKVStoreFree(kv))
    # the dist types: rank 0 of a world of 1 without the MXTPU_* contract
    for kv_type in (b"dist_sync", b"dist_async", b"dist_tpu"):
        _check(lib, lib.MXKVStoreCreate(kv_type, ctypes.byref(kv)))
        _check(lib, lib.MXKVStoreGetType(kv, ctypes.byref(t)))
        assert t.value == kv_type
        _check(lib, lib.MXKVStoreGetRank(kv, ctypes.byref(r)))
        _check(lib, lib.MXKVStoreGetGroupSize(kv, ctypes.byref(sz)))
        assert (r.value, sz.value) == (0, 1)
        _check(lib, lib.MXKVStoreBarrier(kv))
        _check(lib, lib.MXKVStoreFree(kv))


# ---------------------------------------------------------------- error paths
def test_error_paths_set_last_error(libmx):
    """Every failure mode must return -1 and leave a message in
    MXGetLastError (reference c_api_error.cc contract; VERDICT r2 weak #6)."""
    lib = libmx
    h = Handle()
    # invalid JSON
    assert lib.MXSymbolCreateFromJSON(b"{not json", ctypes.byref(h)) == -1
    assert len(lib.MXGetLastError()) > 0
    # missing file
    sz = ctypes.c_uint(); arr = ctypes.POINTER(Handle)()
    nn = ctypes.c_uint(); names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXNDArrayLoad(b"/nonexistent/x.params", ctypes.byref(sz),
                             ctypes.byref(arr), ctypes.byref(nn),
                             ctypes.byref(names)) == -1
    assert b"/nonexistent" in lib.MXGetLastError()
    # size-mismatched copy
    a = _nd_create(lib, (2, 2))
    buf = np.zeros(3, "<f4")
    assert lib.MXNDArraySyncCopyToCPU(
        a, buf.ctypes.data_as(ctypes.c_void_p), 3) == -1
    assert b"mismatch" in lib.MXGetLastError()
    # invalid data-iter params (valid creator, missing required args —
    # NULL handles are UB here exactly as in the reference's blind casts)
    n2 = ctypes.c_uint()
    iters = ctypes.POINTER(Handle)()
    _check(lib, lib.MXListDataIters(ctypes.byref(n2), ctypes.byref(iters)))
    it = Handle()
    assert lib.MXDataIterCreateIter(
        Handle(iters[0]), 1, _strs("path_imgrec"), _strs("/missing.rec"),
        ctypes.byref(it)) == -1
    assert len(lib.MXGetLastError()) > 0
    # bad executor bind (wrong arg count)
    x = _variable(lib, "data")
    fc = _compose(lib, _atomic(lib, "FullyConnected",
                               ("num_hidden",), ("4",)), "efc", data=x)
    ex = Handle()
    reqs = (ctypes.c_uint * 1)(1)
    args = (Handle * 1)(a)
    assert lib.MXExecutorBind(fc, 1, 0, 1, args, args, reqs, 0, None,
                              ctypes.byref(ex)) == -1
    assert len(lib.MXGetLastError()) > 0
    # after an error, the API keeps working (TLS error does not poison state)
    b = _nd_create(lib, (2, 2))
    _nd_set(lib, b, np.ones((2, 2)))
    np.testing.assert_allclose(_nd_get(lib, b), np.ones((2, 2)))
    _check(lib, lib.MXNDArrayFree(a))
    _check(lib, lib.MXNDArrayFree(b))


def test_ndarray_save_load_mixed_dtypes(libmx, tmp_path):
    """MXNDArraySave/Load round-trip with f32 + i32 + f16 + f64 arrays
    (reference NDArray::Save binary format keeps per-array dtype)."""
    lib = libmx
    fname = str(tmp_path / "mixed.params").encode()
    arrays = {}
    handles = []
    keys = []
    for name, dt_code, dt in (("a", 0, "<f4"), ("b", 4, "<i4"),
                              ("c", 2, "<f2"), ("d", 1, "<f8")):
        h = Handle()
        sh = (ctypes.c_uint * 2)(2, 3)
        _check(lib, lib.MXNDArrayCreateEx(sh, 2, 1, 0, 0, dt_code,
                                          ctypes.byref(h)))
        data = (np.arange(6).reshape(2, 3) * (ord(name))).astype(dt)
        _check(lib, lib.MXNDArraySyncCopyFromCPUEx(
            h, data.ctypes.data_as(ctypes.c_void_p), data.nbytes))
        arrays[name] = data
        handles.append(h)
        keys.append(name.encode())
    harr = (Handle * 4)(*handles)
    karr = (ctypes.c_char_p * 4)(*keys)
    _check(lib, lib.MXNDArraySave(fname, 4, harr, karr))
    out_sz = ctypes.c_uint()
    out_arr = ctypes.POINTER(Handle)()
    out_nn = ctypes.c_uint()
    out_names = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXNDArrayLoad(fname, ctypes.byref(out_sz),
                                  ctypes.byref(out_arr),
                                  ctypes.byref(out_nn),
                                  ctypes.byref(out_names)))
    assert out_sz.value == 4 and out_nn.value == 4
    for i in range(4):
        name = out_names[i].decode()
        h = Handle(out_arr[i])
        dt = ctypes.c_int()
        _check(lib, lib.MXNDArrayGetDType(h, ctypes.byref(dt)))
        assert dt.value == {"a": 0, "b": 4, "c": 2, "d": 1}[name]
        want = arrays[name]
        got = np.empty(want.shape, want.dtype)
        _check(lib, lib.MXNDArraySyncCopyToCPUEx(
            h, got.ctypes.data_as(ctypes.c_void_p), got.nbytes))
        np.testing.assert_array_equal(got, want)
        _check(lib, lib.MXNDArrayFree(h))
    for h in handles:
        _check(lib, lib.MXNDArrayFree(h))


def test_multithreaded_imperative_invoke(libmx):
    """Concurrent imperative invokes from several host threads: the embedded
    runtime's GIL discipline must serialise safely (reference engine is
    thread-safe by design; our C boundary must be too)."""
    import threading
    lib = libmx
    n = ctypes.c_uint()
    creators = ctypes.POINTER(Handle)()
    _check(lib, lib.MXSymbolListAtomicSymbolCreators(ctypes.byref(n),
                                                     ctypes.byref(creators)))
    name = ctypes.c_char_p()
    mul = None
    for i in range(n.value):
        _check(lib, lib.MXSymbolGetAtomicSymbolName(Handle(creators[i]),
                                                    ctypes.byref(name)))
        if name.value == b"elemwise_mul":
            mul = Handle(creators[i])
    assert mul is not None
    errors = []

    def worker(seed):
        try:
            a = _nd_create(lib, (4, 4))
            _nd_set(lib, a, np.full((4, 4), float(seed)))
            for _ in range(20):
                ins = (Handle * 2)(a, a)
                num_out = ctypes.c_int(0)
                outs = ctypes.POINTER(Handle)()
                rc = lib.MXImperativeInvoke(mul, 2, ins,
                                            ctypes.byref(num_out),
                                            ctypes.byref(outs), 0, None,
                                            None)
                assert rc == 0, lib.MXGetLastError().decode()
                got = _nd_get(lib, Handle(outs[0]))
                assert got[0, 0] == float(seed) ** 2
                lib.MXNDArrayFree(Handle(outs[0]))
            lib.MXNDArrayFree(a)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,))
               for s in (2, 3, 4, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_bind_variants_and_infer_partial(libmx):
    """MXExecutorBindX/BindEX name parity + MXSymbolInferShapePartial
    (underspecified graphs return 0-dim entries with complete=0 semantics
    preserved via empty shapes)."""
    lib = libmx
    x = _variable(lib, "data")
    fc = _compose(lib, _atomic(lib, "FullyConnected",
                               ("num_hidden",), ("4",)), "pfc", data=x)
    # partial inference with NO known shapes: weight/bias unknown -> ()
    in_size = ctypes.c_uint(); in_ndim = c_uint_p()
    in_data = ctypes.POINTER(c_uint_p)()
    out_size = ctypes.c_uint(); out_ndim = c_uint_p()
    out_data = ctypes.POINTER(c_uint_p)()
    aux_size = ctypes.c_uint(); aux_ndim = c_uint_p()
    aux_data = ctypes.POINTER(c_uint_p)()
    complete = ctypes.c_int()
    ind_ptr = (ctypes.c_uint * 1)(0)
    _check(lib, lib.MXSymbolInferShapePartial(
        fc, 0, None, ind_ptr, None,
        ctypes.byref(in_size), ctypes.byref(in_ndim), ctypes.byref(in_data),
        ctypes.byref(out_size), ctypes.byref(out_ndim),
        ctypes.byref(out_data), ctypes.byref(aux_size),
        ctypes.byref(aux_ndim), ctypes.byref(aux_data),
        ctypes.byref(complete)))
    assert in_size.value == 3            # data, weight, bias
    assert in_ndim[0] == 0               # unknown -> 0-dim
    assert complete.value == 0           # underspecified graph

    # BindX with empty maps == Bind; with maps -> clean error
    batch = 2
    shapes = [(batch, 6), (4, 6), (4,)]
    args = [_nd_create(lib, s) for s in shapes]
    for h, s in zip(args, shapes):
        _nd_set(lib, h, np.zeros(s))
    arg_arr = (Handle * 3)(*args)
    grads = (Handle * 3)(None, None, None)
    reqs = (ctypes.c_uint * 3)(0, 0, 0)
    ex = Handle()
    _check(lib, lib.MXExecutorBindX(fc, 1, 0, 0, None, None, None,
                                    3, arg_arr, grads, reqs, 0, None,
                                    ctypes.byref(ex)))
    _check(lib, lib.MXExecutorForward(ex, 0))
    n_out = ctypes.c_uint(); outs = ctypes.POINTER(Handle)()
    _check(lib, lib.MXExecutorOutputs(ex, ctypes.byref(n_out),
                                      ctypes.byref(outs)))
    assert n_out.value == 1
    _check(lib, lib.MXNDArrayFree(Handle(outs[0])))
    _check(lib, lib.MXExecutorFree(ex))
    keys = _strs("group1")
    dts = (ctypes.c_int * 1)(1)
    ids = (ctypes.c_int * 1)(0)
    assert lib.MXExecutorBindX(fc, 1, 0, 1, keys, dts, ids, 3, arg_arr,
                               grads, reqs, 0, None, ctypes.byref(ex)) == -1
    assert b"group2ctx" in lib.MXGetLastError()
    # BindEX rejects shared_exec
    assert lib.MXExecutorBindEX(fc, 1, 0, 0, None, None, None, 3, arg_arr,
                                grads, reqs, 0, None, Handle(1234),
                                ctypes.byref(ex)) == -1
    # MXSymbolGrad: deprecated, parity with symbol.grad
    g = Handle()
    assert lib.MXSymbolGrad(fc, 1, _strs("data"), ctypes.byref(g)) == -1
    assert b"deprecated" in lib.MXGetLastError()
    for h in args:
        _check(lib, lib.MXNDArrayFree(h))


# --------------------------------------- round-4 C API surface (VERDICT #2)
def test_ndarray_wait_rawbytes_getdata(libmx, mx):
    lib = libmx
    h = _nd_create(lib, (3, 4))
    val = np.arange(12, dtype=np.float32).reshape(3, 4)
    _nd_set(lib, h, val)
    _check(lib, lib.MXNDArrayWaitToRead(h))
    _check(lib, lib.MXNDArrayWaitToWrite(h))
    # raw-bytes round trip (the kvstore state-transfer primitive)
    size = ctypes.c_size_t()
    buf = ctypes.c_char_p()
    _check(lib, lib.MXNDArraySaveRawBytes(h, ctypes.byref(size),
                                          ctypes.byref(buf)))
    raw = ctypes.string_at(buf, size.value)
    assert raw == mx.nd.save_raw_bytes(mx.nd.array(val))
    h2 = Handle()
    _check(lib, lib.MXNDArrayLoadFromRawBytes(raw, len(raw),
                                              ctypes.byref(h2)))
    np.testing.assert_array_equal(_nd_get(lib, h2), val)
    # GetData: host f32 view
    pdata = ctypes.POINTER(ctypes.c_float)()
    _check(lib, lib.MXNDArrayGetData(h, ctypes.byref(pdata)))
    got = np.ctypeslib.as_array(pdata, shape=(12,)).reshape(3, 4)
    np.testing.assert_array_equal(got, val)
    # polled again unchanged: the same buffer; after a write: a new copy,
    # the old pointer still readable
    again = ctypes.POINTER(ctypes.c_float)()
    _check(lib, lib.MXNDArrayGetData(h, ctypes.byref(again)))
    assert ctypes.addressof(again.contents) == ctypes.addressof(
        pdata.contents)
    _nd_set(lib, h, val + 1)
    _check(lib, lib.MXNDArrayGetData(h, ctypes.byref(again)))
    np.testing.assert_array_equal(
        np.ctypeslib.as_array(again, shape=(12,)).reshape(3, 4), val + 1)
    np.testing.assert_array_equal(got, val)
    for hh in (h, h2):
        _check(lib, lib.MXNDArrayFree(hh))


def test_symbol_name_children_file_shallow(libmx, tmp_path):
    lib = libmx
    x = _variable(lib, "data")
    fc = _compose(lib, _atomic(lib, "FullyConnected",
                               ("num_hidden",), ("4",)), "fc", data=x)
    nm = ctypes.c_char_p()
    ok = ctypes.c_int()
    _check(lib, lib.MXSymbolGetName(fc, ctypes.byref(nm), ctypes.byref(ok)))
    assert ok.value == 1 and nm.value == b"fc"
    # children: the fc node's direct inputs (data + implicit weight/bias)
    kids = Handle()
    _check(lib, lib.MXSymbolGetChildren(fc, ctypes.byref(kids)))
    nout = ctypes.c_uint()
    outs = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXSymbolListOutputs(kids, ctypes.byref(nout),
                                        ctypes.byref(outs)))
    names = {outs[i] for i in range(nout.value)}
    assert b"data" in names and any(b"weight" in s for s in names)
    # save to file == save to JSON
    fname = str(tmp_path / "sym.json").encode()
    _check(lib, lib.MXSymbolSaveToFile(fc, fname))
    js = ctypes.c_char_p()
    _check(lib, lib.MXSymbolSaveToJSON(fc, ctypes.byref(js)))
    assert open(fname.decode()).read() == js.value.decode()
    # shallow attrs: only the out node's own attrs, plain keys
    _check(lib, lib.MXSymbolSetAttr(fc, b"lr_mult", b"2"))
    nattr = ctypes.c_uint()
    pairs = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXSymbolListAttrShallow(fc, ctypes.byref(nattr),
                                            ctypes.byref(pairs)))
    d = {pairs[2 * i]: pairs[2 * i + 1] for i in range(nattr.value)}
    assert d.get(b"lr_mult") == b"2" and d.get(b"num_hidden") == b"4"
    for h in (kids, fc, x):
        _check(lib, lib.MXSymbolFree(h))


def test_kvstore_role_predicates(libmx):
    lib = libmx
    r = ctypes.c_int()
    _check(lib, lib.MXKVStoreIsWorkerNode(ctypes.byref(r)))
    assert r.value == 1
    _check(lib, lib.MXKVStoreIsServerNode(ctypes.byref(r)))
    assert r.value == 0
    _check(lib, lib.MXKVStoreIsSchedulerNode(ctypes.byref(r)))
    assert r.value == 0


def test_executor_monitor_callback(libmx):
    lib = libmx
    x = _variable(lib, "data")
    fc = _compose(lib, _atomic(lib, "FullyConnected",
                               ("num_hidden",), ("3",)), "fcm", data=x)
    act = _compose(lib, _atomic(lib, "Activation",
                                ("act_type",), ("relu",)), "relum", data=fc)
    args_h = [_nd_create(lib, s) for s in ((2, 5), (3, 5), (3,))]
    for h, s in zip(args_h, ((2, 5), (3, 5), (3,))):
        _nd_set(lib, h, np.ones(s, np.float32))
    ex = Handle()
    args_arr = (Handle * 3)(*args_h)
    grads_arr = (Handle * 3)(None, None, None)
    reqs_arr = (ctypes.c_uint * 3)(0, 0, 0)
    _check(lib, lib.MXExecutorBind(act, 1, 0, 3, args_arr, grads_arr,
                                   reqs_arr, 0, None, ctypes.byref(ex)))

    MONITOR = ctypes.CFUNCTYPE(None, ctypes.c_char_p, Handle,
                               ctypes.c_void_p)
    seen = {}

    def monitor(name, arr, _):
        arr = Handle(arr)
        seen[name.decode()] = _nd_get(lib, arr).copy()
        _check(lib, lib.MXNDArrayFree(arr))

    cb = MONITOR(monitor)
    _check(lib, lib.MXExecutorSetMonitorCallback(ex, cb, None))
    _check(lib, lib.MXExecutorForward(ex, 1))
    assert any("fcm" in k for k in seen), sorted(seen)
    fck = [k for k in seen if "fcm" in k][0]
    # data ones(2,5) @ weight ones(3,5)^T + bias ones = 6
    np.testing.assert_allclose(seen[fck], np.full((2, 3), 6.0), rtol=1e-5)
    _check(lib, lib.MXExecutorFree(ex))
    for h in (act, fc, x):
        _check(lib, lib.MXSymbolFree(h))


class _CCustomOpInfo(ctypes.Structure):
    _FWD = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int), ctypes.c_bool,
                            ctypes.c_void_p)
    _DEL = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_void_p)
    _fields_ = [("forward", _FWD), ("backward", _FWD), ("del_", _DEL),
                ("p_forward", ctypes.c_void_p),
                ("p_backward", ctypes.c_void_p),
                ("p_del", ctypes.c_void_p)]


class _CCustomOpPropInfo(ctypes.Structure):
    _LIST = ctypes.CFUNCTYPE(ctypes.c_bool,
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),
                             ctypes.c_void_p)
    _INFER = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.POINTER(ctypes.c_uint)),
                              ctypes.c_void_p)
    _DEPS = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
                             ctypes.c_void_p)
    _CREATE = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_char_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.POINTER(ctypes.c_uint)),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(_CCustomOpInfo),
                               ctypes.c_void_p)
    _DEL = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_void_p)
    _fields_ = [("list_arguments", _LIST), ("list_outputs", _LIST),
                ("infer_shape", _INFER),
                ("declare_backward_dependency", _DEPS),
                ("create_operator", _CREATE),
                ("list_auxiliary_states", _LIST), ("del_", _DEL),
                ("p_list_arguments", ctypes.c_void_p),
                ("p_list_outputs", ctypes.c_void_p),
                ("p_infer_shape", ctypes.c_void_p),
                ("p_declare_backward_dependency", ctypes.c_void_p),
                ("p_create_operator", ctypes.c_void_p),
                ("p_list_auxiliary_states", ctypes.c_void_p),
                ("p_del", ctypes.c_void_p)]


_CB_KEEPALIVE = []  # ctypes callbacks + string arenas must outlive the op


def test_custom_op_register_via_c(libmx):
    """A C-implemented custom op (out = 2*in) registered through
    MXCustomOpRegister, then composed, bound, forward+backward through the
    C API — the reference's CustomOpInfo callback-table contract end to
    end (reference c_api.h:103-140, custom-inl.h)."""
    lib = libmx

    args_arena = (ctypes.c_char_p * 3)(b"data", None, None)
    outs_arena = (ctypes.c_char_p * 2)(b"output", None)
    aux_arena = (ctypes.c_char_p * 1)(None)

    def list_args(out, _):
        out[0] = args_arena
        return True

    def list_outs(out, _):
        out[0] = outs_arena
        return True

    def list_aux(out, _):
        out[0] = aux_arena
        return True

    def infer_shape(num_in, ndims, shapes, _):
        # 1 input, 1 output: same shape (pointer reuse is copied out)
        ndims[1] = ndims[0]
        shapes[1] = shapes[0]
        return True

    def deps(out_grad, in_data, out_data, num_deps, rdeps, _):
        arena = (ctypes.c_int * 1)(out_grad[0])
        _CB_KEEPALIVE.append(arena)
        num_deps[0] = 1
        rdeps[0] = arena
        return True

    def forward(size, ptrs, tags, reqs, is_train, _):
        tens = {0: [], 1: [], 4: []}
        for i in range(size):
            tens.setdefault(tags[i], []).append(Handle(ptrs[i]))
        val = _nd_get(lib, tens[0][0])
        _nd_set(lib, tens[1][0], 2.0 * val)
        return True

    def backward(size, ptrs, tags, reqs, is_train, _):
        tens = {}
        for i in range(size):
            tens.setdefault(tags[i], []).append(Handle(ptrs[i]))
        og = _nd_get(lib, tens[3][0])
        _nd_set(lib, tens[2][0], 2.0 * og)   # in_grad = 2 * out_grad
        return True

    def create_op(ctx, num_in, shapes, ndims, dtypes, ret, _):
        ret[0].forward = _CCustomOpInfo._FWD(forward)
        ret[0].backward = _CCustomOpInfo._FWD(backward)
        ret[0].del_ = _CCustomOpInfo._DEL(lambda s: True)
        _CB_KEEPALIVE.extend([ret[0].forward, ret[0].backward, ret[0].del_])
        return True

    CREATOR = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_char_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_char_p),
                               ctypes.POINTER(ctypes.c_char_p),
                               ctypes.POINTER(_CCustomOpPropInfo))

    def creator(op_type, num_kwargs, keys, vals, ret):
        info = ret[0]
        info.list_arguments = _CCustomOpPropInfo._LIST(list_args)
        info.list_outputs = _CCustomOpPropInfo._LIST(list_outs)
        info.list_auxiliary_states = _CCustomOpPropInfo._LIST(list_aux)
        info.infer_shape = _CCustomOpPropInfo._INFER(infer_shape)
        info.declare_backward_dependency = _CCustomOpPropInfo._DEPS(deps)
        info.create_operator = _CCustomOpPropInfo._CREATE(create_op)
        info.del_ = _CCustomOpPropInfo._DEL(lambda s: True)
        _CB_KEEPALIVE.extend([info.list_arguments, info.list_outputs,
                              info.list_auxiliary_states, info.infer_shape,
                              info.declare_backward_dependency,
                              info.create_operator, info.del_])
        return True

    creator_cb = CREATOR(creator)
    _CB_KEEPALIVE.append(creator_cb)
    _check(lib, lib.MXCustomOpRegister(b"cdouble", creator_cb))

    # compose Custom(op_type=cdouble) and run fwd+bwd through the C API
    x = _variable(lib, "data")
    cust = _compose(lib, _atomic(lib, "Custom", ("op_type",), ("cdouble",)),
                    "cd", data=x)
    data_h = _nd_create(lib, (2, 3))
    val = np.arange(6, dtype=np.float32).reshape(2, 3)
    _nd_set(lib, data_h, val)
    grad_h = _nd_create(lib, (2, 3))
    _nd_set(lib, grad_h, np.zeros((2, 3), np.float32))
    ex = Handle()
    args_arr = (Handle * 1)(data_h)
    grads_arr = (Handle * 1)(grad_h)
    reqs_arr = (ctypes.c_uint * 1)(1)
    _check(lib, lib.MXExecutorBind(cust, 1, 0, 1, args_arr, grads_arr,
                                   reqs_arr, 0, None, ctypes.byref(ex)))
    _check(lib, lib.MXExecutorForward(ex, 1))
    outs_size = ctypes.c_uint()
    outs_p = ctypes.POINTER(Handle)()
    _check(lib, lib.MXExecutorOutputs(ex, ctypes.byref(outs_size),
                                      ctypes.byref(outs_p)))
    out = _nd_get(lib, Handle(outs_p[0]))
    np.testing.assert_allclose(out, 2.0 * val, rtol=1e-6)
    for i in range(outs_size.value):
        _check(lib, lib.MXNDArrayFree(Handle(outs_p[i])))
    # backward with explicit head grad: in_grad must be 2 * head
    head = _nd_create(lib, (2, 3))
    _nd_set(lib, head, np.ones((2, 3), np.float32))
    heads = (Handle * 1)(head)
    _check(lib, lib.MXExecutorBackward(ex, 1, heads))
    np.testing.assert_allclose(_nd_get(lib, grad_h),
                               np.full((2, 3), 2.0), rtol=1e-6)
    _check(lib, lib.MXExecutorFree(ex))
    for h in (cust, x):
        _check(lib, lib.MXSymbolFree(h))


def _jax_mlp(mx):
    S = mx.sym
    fc1 = S.FullyConnected(S.Variable("data"), num_hidden=32, name="fc1")
    act = S.Activation(fc1, act_type="relu", name="relu1")
    fc2 = S.FullyConnected(act, num_hidden=2, name="fc2")
    return S.SoftmaxOutput(fc2, S.Variable("softmax_label"), name="softmax")


MLP_SHAPES = {"fc1_weight": (32, 10), "fc1_bias": (32,),
              "fc2_weight": (2, 32), "fc2_bias": (2,)}
MLP_LR = np.float32(0.05)
MLP_STEPS = 10
MLP_BATCH = 20


def _mlp_init(nudge=0.0):
    rs = np.random.RandomState(1)
    out = {}
    for k, s in MLP_SHAPES.items():
        v = rs.uniform(-0.2, 0.2, s)
        out[k] = (v * (1 + nudge * rs.uniform(-1, 1, s))).astype(np.float32)
    return out


def _jax_steps(mx, init, data, labels):
    """MLP_STEPS SGD steps w - lr * g through the JAX package's executor."""
    net = _jax_mlp(mx)
    args = {k: mx.nd.array(v) for k, v in init.items()}
    args["data"] = mx.nd.zeros((MLP_BATCH, 10))
    args["softmax_label"] = mx.nd.zeros((MLP_BATCH,))
    grads = {k: mx.nd.zeros(s) for k, s in MLP_SHAPES.items()}
    ex = net.bind(mx.cpu(), args, args_grad=grads,
                  grad_req={k: ("write" if k in MLP_SHAPES else "null")
                            for k in args})
    for i in range(MLP_STEPS):
        s = (i * MLP_BATCH) % len(data)
        ex.arg_dict["data"][:] = data[s:s + MLP_BATCH]
        ex.arg_dict["softmax_label"][:] = labels[s:s + MLP_BATCH]
        ex.forward(is_train=True)
        ex.backward()
        for k in MLP_SHAPES:
            w = ex.arg_dict[k].asnumpy()
            ex.arg_dict[k][:] = w - MLP_LR * ex.grad_dict[k].asnumpy()
    return {k: ex.arg_dict[k].asnumpy() for k in MLP_SHAPES}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_mlp_steps_match_mxnet_tpu(libmx, mx):
    """MLP_STEPS SGD steps composed, bound and run through the C API, each
    update w - lr * g read and written through it, against the same steps
    through the JAX package's executor from the same parameters: every
    parameter within FLOOR_X times the JAX package's float32 floor."""
    lib = libmx
    _, data, labels = _mlp_data()
    loss = _c_mlp(lib)
    nargs = ctypes.c_uint()
    names_c = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXSymbolListArguments(loss, ctypes.byref(nargs),
                                          ctypes.byref(names_c)))
    arg_names = [names_c[i].decode() for i in range(nargs.value)]
    assert sorted(arg_names) == sorted(list(MLP_SHAPES)
                                       + ["data", "softmax_label"])
    init = _mlp_init()
    shapes = dict(MLP_SHAPES, data=(MLP_BATCH, 10),
                  softmax_label=(MLP_BATCH,))
    args = {k: _nd_create(lib, shapes[k]) for k in arg_names}
    grads = {k: _nd_create(lib, MLP_SHAPES[k]) for k in MLP_SHAPES}
    for k, v in init.items():
        _nd_set(lib, args[k], v)
    ex = Handle()
    _check(lib, lib.MXExecutorBind(
        loss, 1, 0, len(arg_names),
        (Handle * len(arg_names))(*[args[k] for k in arg_names]),
        (Handle * len(arg_names))(*[grads.get(k) for k in arg_names]),
        (ctypes.c_uint * len(arg_names))(*[1 if k in grads else 0
                                           for k in arg_names]),
        0, None, ctypes.byref(ex)))
    for i in range(MLP_STEPS):
        s = (i * MLP_BATCH) % len(data)
        _nd_set(lib, args["data"], data[s:s + MLP_BATCH])
        _nd_set(lib, args["softmax_label"], labels[s:s + MLP_BATCH])
        _check(lib, lib.MXExecutorForward(ex, 1))
        _check(lib, lib.MXExecutorBackward(ex, 0, None))
        for k in MLP_SHAPES:
            _nd_set(lib, args[k], _nd_get(lib, args[k])
                    - MLP_LR * _nd_get(lib, grads[k]))
    got = {k: _nd_get(lib, args[k]) for k in MLP_SHAPES}
    _check(lib, lib.MXExecutorFree(ex))
    want = _jax_steps(mx, init, data, labels)
    nudged = _jax_steps(mx, _mlp_init(NUDGE), data, labels)
    for k in MLP_SHAPES:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, \
            (k, _rel(got[k], want[k]), floor)
        assert _rel(got[k], init[k]) > 1e-3     # the steps moved it


def test_kvstore_send_command_sets_optimizer(libmx):
    """MXKVStoreSendCommmandToServers(head 0, a pickled optimizer) installs
    it on the store (the process is the server): a push then runs SGD."""
    import pickle
    import mxnet_tpu_torch as mt
    lib = libmx
    kv = Handle()
    _check(lib, lib.MXKVStoreCreate(b"local", ctypes.byref(kv)))
    w = _nd_create(lib, (4,))
    _nd_set(lib, w, np.ones(4))
    g = _nd_create(lib, (4,))
    _nd_set(lib, g, np.full(4, 2.0))
    key = (ctypes.c_int * 1)(0)
    _check(lib, lib.MXKVStoreInit(kv, 1, key, (Handle * 1)(w)))
    body = pickle.dumps(mt.optimizer.SGD(learning_rate=0.5), protocol=0)
    _check(lib, lib.MXKVStoreSendCommmandToServers(kv, 0, body))
    _check(lib, lib.MXKVStorePush(kv, 1, key, (Handle * 1)(g), 0))
    _check(lib, lib.MXKVStorePull(kv, 1, key, (Handle * 1)(w), 0))
    np.testing.assert_allclose(_nd_get(lib, w), np.zeros(4), atol=1e-7)
    dead = ctypes.c_int(-1)
    _check(lib, lib.MXKVStoreGetNumDeadNode(kv, 0, ctypes.byref(dead), 1))
    assert dead.value == 0
    _check(lib, lib.MXKVStoreSetBarrierBeforeExit(kv, 1))
    for h in (w, g):
        _check(lib, lib.MXNDArrayFree(h))
    _check(lib, lib.MXKVStoreFree(kv))
