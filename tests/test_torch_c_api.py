"""The port's native C API (``csrc/c_api.cc`` over ``mxnet_tpu_torch.capi``)
driven through ctypes on the CPU (dev_type 1), and the cpp-package built
against it.

Twins of tests/python/unittest/test_c_api.py, on the library that
``ops.kernel_build.HostLibrary`` builds with g++ (the JAX package's tests
build theirs with cmake).  The C predict API is held to the port's
``Predictor`` and to the JAX package's ``mxnet_tpu.Predictor`` on the same
checkpoint and inputs (float32, rtol 1e-5); raw bytes from
``MXNDArraySaveRawBytes`` to the JAX package's ``nd.save_raw_bytes`` byte
for byte; the generated ``op.h`` to the operators, inputs and attributes
that the JAX package's reflection calls give.  Device type codes other than
1, 2 and 3 fail with a named error, and so do 2 and 3 without a card.
The cpp-package's training examples that take longer (lenet, resnet,
charrnn) are in test_torch_cpp_package.py.
"""
import ctypes
import os
import re
import subprocess

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.kernel_build import HostLibrary
from test_torch_threads import child_env
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
BATCH, DIM, HIDDEN, CLASSES = 3, 32, 128, 4


@pytest.fixture(scope="module")
def host():
    return HostLibrary()


@pytest.fixture(scope="module")
def libmx(host):
    return host.get()


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.predictor  # noqa: F401
    return mx


def _check(lib, rc):
    assert rc == 0, lib.MXGetLastError().decode()


def _mlp_checkpoint(prefix, epoch=4):
    """``prefix``-symbol.json and ``prefix``-%04d.params of the MLP
    (fc1 128, fc2 64, fc3 4) with seed-2 weights (whose argmax differs
    between mlp_predict's rows, so that its check tells rows apart);
    returns (json, bytes)."""
    net = mt.models.get_mlp(num_classes=CLASSES)
    arg_shapes, _, _ = net.infer_shape(data=(BATCH, DIM))
    rs = RS(2)
    params = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        fan_in = shape[1] if len(shape) > 1 else 1
        params["arg:" + name] = (rs.uniform(-1, 1, shape)
                                 * np.sqrt(3.0 / fan_in)).astype(np.float32)
    with open(prefix + "-symbol.json", "w") as f:
        f.write(net.tojson())
    mt.nd.save("%s-%04d.params" % (prefix, epoch), params)
    with open(prefix + "-symbol.json", "rb") as f:
        sym_json = f.read()
    with open("%s-%04d.params" % (prefix, epoch), "rb") as f:
        blob = f.read()
    return sym_json, blob


def _pred_create(lib, sym_json, params, dev_type=1, outputs=None):
    keys = (ctypes.c_char_p * 1)(b"data")
    indptr = (ctypes.c_uint * 2)(0, 2)
    shapes = (ctypes.c_uint * 2)(BATCH, DIM)
    pred = ctypes.c_void_p()
    if outputs is None:
        rc = lib.MXPredCreate(sym_json, params, len(params), dev_type, 0, 1,
                              keys, indptr, shapes, ctypes.byref(pred))
    else:
        outs = (ctypes.c_char_p * len(outputs))(*outputs)
        rc = lib.MXPredCreatePartialOut(
            sym_json, params, len(params), dev_type, 0, 1, keys, indptr,
            shapes, len(outputs), outs, ctypes.byref(pred))
    return rc, pred


def _pred_output(lib, pred, index=0):
    sd = ctypes.POINTER(ctypes.c_uint)()
    nd_ = ctypes.c_uint()
    _check(lib, lib.MXPredGetOutputShape(pred, index, ctypes.byref(sd),
                                         ctypes.byref(nd_)))
    shape = tuple(sd[i] for i in range(nd_.value))
    out = np.zeros(int(np.prod(shape)), np.float32)
    _check(lib, lib.MXPredGetOutput(
        pred, index, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint(out.size)))
    return out.reshape(shape)


def _set_input(lib, pred, x):
    _check(lib, lib.MXPredSetInput(
        pred, b"data", x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint(x.size)))


def test_ndarray_roundtrip(libmx):
    shape = (ctypes.c_uint * 2)(3, 4)
    handle = ctypes.c_void_p()
    _check(libmx, libmx.MXNDArrayCreate(shape, 2, 1, 0, 0,
                                        ctypes.byref(handle)))
    data = np.arange(12, dtype=np.float32)
    _check(libmx, libmx.MXNDArraySyncCopyFromCPU(
        handle, data.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(12)))
    out = np.zeros(12, dtype=np.float32)
    _check(libmx, libmx.MXNDArraySyncCopyToCPU(
        handle, out.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(12)))
    np.testing.assert_array_equal(out, data)
    ndim = ctypes.c_uint()
    pdata = ctypes.POINTER(ctypes.c_uint)()
    _check(libmx, libmx.MXNDArrayGetShape(handle, ctypes.byref(ndim),
                                          ctypes.byref(pdata)))
    assert ndim.value == 2 and pdata[0] == 3 and pdata[1] == 4
    dev_type, dev_id = ctypes.c_int(), ctypes.c_int()
    _check(libmx, libmx.MXNDArrayGetContext(handle, ctypes.byref(dev_type),
                                            ctypes.byref(dev_id)))
    assert (dev_type.value, dev_id.value) == (1, 0)
    _check(libmx, libmx.MXNDArrayFree(handle))


def test_ndarray_create_none_kvstore_pull(libmx):
    """MXNDArrayCreateNone: ndim 0 until a kvstore pull fills it."""
    none_h = ctypes.c_void_p()
    _check(libmx, libmx.MXNDArrayCreateNone(ctypes.byref(none_h)))
    ndim = ctypes.c_uint(7)
    pdata = ctypes.POINTER(ctypes.c_uint)()
    _check(libmx, libmx.MXNDArrayGetShape(none_h, ctypes.byref(ndim),
                                          ctypes.byref(pdata)))
    assert ndim.value == 0
    kv = ctypes.c_void_p()
    _check(libmx, libmx.MXKVStoreCreate(b"local", ctypes.byref(kv)))
    shape = (ctypes.c_uint * 1)(4)
    src = ctypes.c_void_p()
    _check(libmx, libmx.MXNDArrayCreate(shape, 1, 1, 0, 0,
                                        ctypes.byref(src)))
    data = np.arange(4, dtype=np.float32)
    _check(libmx, libmx.MXNDArraySyncCopyFromCPU(
        src, data.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(4)))
    key = (ctypes.c_int * 1)(3)
    _check(libmx, libmx.MXKVStoreInit(kv, 1, key,
                                      (ctypes.c_void_p * 1)(src)))
    _check(libmx, libmx.MXKVStorePull(kv, 1, key,
                                      (ctypes.c_void_p * 1)(none_h), 0))
    _check(libmx, libmx.MXNDArrayGetShape(none_h, ctypes.byref(ndim),
                                          ctypes.byref(pdata)))
    assert ndim.value == 1 and pdata[0] == 4
    out = np.zeros(4, dtype=np.float32)
    _check(libmx, libmx.MXNDArraySyncCopyToCPU(
        none_h, out.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(4)))
    np.testing.assert_array_equal(out, data)
    for h in (none_h, src):
        _check(libmx, libmx.MXNDArrayFree(h))
    _check(libmx, libmx.MXKVStoreFree(kv))


def test_ndarray_save_load(libmx, mx, tmp_path):
    """MXNDArraySave writes the ``.params`` format: the JAX package loads
    the file, and the library loads it back."""
    fname = str(tmp_path / "arrs.params").encode()
    shape = (ctypes.c_uint * 1)(5)
    h = ctypes.c_void_p()
    _check(libmx, libmx.MXNDArrayCreate(shape, 1, 1, 0, 0, ctypes.byref(h)))
    vals = np.array([1, 2, 3, 4, 5], np.float32)
    _check(libmx, libmx.MXNDArraySyncCopyFromCPU(
        h, vals.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(5)))
    _check(libmx, libmx.MXNDArraySave(fname, 1, (ctypes.c_void_p * 1)(h),
                                      (ctypes.c_char_p * 1)(b"w")))
    np.testing.assert_array_equal(mx.nd.load(fname.decode())["w"].asnumpy(),
                                  vals)
    out_size = ctypes.c_uint()
    out_arr = ctypes.POINTER(ctypes.c_void_p)()
    name_size = ctypes.c_uint()
    names = ctypes.POINTER(ctypes.c_char_p)()
    _check(libmx, libmx.MXNDArrayLoad(fname, ctypes.byref(out_size),
                                      ctypes.byref(out_arr),
                                      ctypes.byref(name_size),
                                      ctypes.byref(names)))
    assert out_size.value == 1 and name_size.value == 1
    assert names[0] == b"w"
    got = np.zeros(5, np.float32)
    _check(libmx, libmx.MXNDArraySyncCopyToCPU(
        ctypes.c_void_p(out_arr[0]), got.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(5)))
    np.testing.assert_array_equal(got, vals)


def test_list_ops_and_symbol_json(libmx, mx):
    n = ctypes.c_uint()
    arr = ctypes.POINTER(ctypes.c_char_p)()
    _check(libmx, libmx.MXListAllOpNames(ctypes.byref(n), ctypes.byref(arr)))
    ops = [arr[i].decode() for i in range(n.value)]
    import mxnet_tpu.capi as jcapi
    assert ops == jcapi.list_all_op_names()
    assert {"FullyConnected", "Convolution",
            "dot_product_attention"} <= set(ops)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                                name="fc")
    h = ctypes.c_void_p()
    _check(libmx, libmx.MXSymbolCreateFromJSON(net.tojson().encode(),
                                               ctypes.byref(h)))
    ns = ctypes.c_uint()
    sarr = ctypes.POINTER(ctypes.c_char_p)()
    _check(libmx, libmx.MXSymbolListArguments(h, ctypes.byref(ns),
                                              ctypes.byref(sarr)))
    assert [sarr[i].decode() for i in range(ns.value)] == \
        ["data", "fc_weight", "fc_bias"]
    out_json = ctypes.c_char_p()
    _check(libmx, libmx.MXSymbolSaveToJSON(h, ctypes.byref(out_json)))
    assert b"fc_weight" in out_json.value
    _check(libmx, libmx.MXSymbolFree(h))


def test_error_reporting(libmx):
    h = ctypes.c_void_p()
    assert libmx.MXSymbolCreateFromJSON(b"{not json", ctypes.byref(h)) == -1
    assert len(libmx.MXGetLastError()) > 0


@pytest.mark.parametrize("dev_type", [4, 7, 0])
def test_unknown_device_type_fails(libmx, tmp_path, dev_type):
    """Codes other than 1, 2 and 3 fail with a named error (the JAX
    package's library maps them to the CPU; the port does not)."""
    h = ctypes.c_void_p()
    shape = (ctypes.c_uint * 1)(2)
    assert libmx.MXNDArrayCreate(shape, 1, dev_type, 0, 0,
                                 ctypes.byref(h)) == -1
    msg = libmx.MXGetLastError().decode()
    assert "device type code %d" % dev_type in msg, msg
    sym_json, params = _mlp_checkpoint(str(tmp_path / "mlp"))
    rc, _ = _pred_create(libmx, sym_json, params, dev_type=dev_type)
    assert rc == -1
    assert "device type code %d" % dev_type in \
        libmx.MXGetLastError().decode()


@pytest.mark.parametrize("dev_type", [2, 3])
def test_card_device_types_fail_without_card(libmx, dev_type):
    """gpu (2) and cpu_pinned (3) need a card: without one the call fails
    with the context's error, and nothing falls back to the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    h = ctypes.c_void_p()
    shape = (ctypes.c_uint * 1)(2)
    assert libmx.MXNDArrayCreate(shape, 1, dev_type, 0, 0,
                                 ctypes.byref(h)) == -1
    assert "needs a CUDA device" in libmx.MXGetLastError().decode()


def test_c_predict_api(libmx, mx, tmp_path):
    """MXPredCreate/SetInput/Forward/GetOutput against the port's and the
    JAX package's Predictor on the same checkpoint and input."""
    prefix = str(tmp_path / "mlp")
    sym_json, params = _mlp_checkpoint(prefix)
    rc, pred = _pred_create(libmx, sym_json, params)
    _check(libmx, rc)
    x = np.linspace(-1, 1, BATCH * DIM).astype(np.float32)
    _set_input(libmx, pred, x)
    _check(libmx, libmx.MXPredForward(pred))
    out = _pred_output(libmx, pred)
    assert out.shape == (BATCH, CLASSES)
    _check(libmx, libmx.MXPredFree(pred))
    port = mt.Predictor.from_checkpoint(prefix, 4, {"data": (BATCH, DIM)},
                                        dev_type="cpu")
    port.forward(data=x.reshape(BATCH, DIM))
    np.testing.assert_array_equal(out, port.get_output(0))
    jax_pred = mx.predictor.Predictor.from_checkpoint(
        prefix, 4, {"data": (BATCH, DIM)})
    jax_pred.set_input("data", x.reshape(BATCH, DIM))
    jax_pred.forward()
    np.testing.assert_allclose(out, jax_pred.get_output(0), rtol=1e-5,
                               atol=1e-7)


def _mlp_predict_reference(prefix, mx):
    """The deterministic batch of cpp-package/example/mlp_predict.cpp and
    the argmax rows both packages' Predictors give for it."""
    data = (np.arange(BATCH * DIM) % 7 * 0.25 - 0.75).astype(np.float32)
    data = data.reshape(BATCH, DIM)
    port = mt.Predictor.from_checkpoint(prefix, 4, {"data": (BATCH, DIM)},
                                        dev_type="cpu")
    port.forward(data=data)
    jax_pred = mx.predictor.Predictor.from_checkpoint(
        prefix, 4, {"data": (BATCH, DIM)})
    jax_pred.set_input("data", data)
    jax_pred.forward()
    return port.get_output(0).argmax(1), jax_pred.get_output(0).argmax(1)


def test_cpp_example_binary(host, mx, tmp_path):
    """cpp-package/example/mlp_predict.cpp, built against the port's
    library, runs standalone (its own embedded interpreter): the argmax of
    each row is the port's and the JAX package's Predictor's, and the
    partial-out feature path gives (3, 128)."""
    prefix = str(tmp_path / "mlp")
    _mlp_checkpoint(prefix)
    res = subprocess.run([host.example("mlp_predict"), prefix, "4",
                          str(BATCH), str(DIM)], capture_output=True,
                         text=True, env=host.run_env(child_env()),
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "output shape: (3, 4)" in res.stdout
    rows = [int(m) for m in re.findall(r"row \d+ argmax (\d+)", res.stdout)]
    want_port, want_jax = _mlp_predict_reference(prefix, mx)
    assert rows == list(want_port) == list(want_jax)
    assert len(set(rows)) > 1
    assert "FEATURES OK" in res.stdout
    assert "feature shape: (3, 128)" in res.stdout


def test_cpp_train_binary(host):
    """cpp-package/example/mlp_train.cpp: op.h symbol composition, the
    Executor, SGDOptimizer and the KVStore updater through the port's
    library, converging."""
    res = subprocess.run([host.example("mlp_train")], capture_output=True,
                         text=True, env=host.run_env(child_env()),
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PASS" in res.stdout


def _op_h_entries(text):
    """{op: (inputs, attrs)} of a generated op.h: the attrs from each
    op's comment line, the inputs from its first constructor."""
    out = {}
    for m in re.finditer(r"/\* (\w+) \(attrs([^)]*)\) \*/\ninline Symbol "
                         r"(\w+)\(const std::string &name((?:,\n    "
                         r"Symbol \w+)*|,\n    const std::vector<Symbol>)",
                         text):
        name, attrs, name2, ins = m.groups()
        assert name == name2
        out[name] = (tuple(re.findall(r"Symbol (\w+)", ins)),
                     tuple(attrs.split()))
    return out


def test_op_h_generator(host, mx):
    """op.h generated through the port's library names the same
    operators, with the same inputs and attributes, as the JAX package's
    reflection calls (what its own op.h is generated from)."""
    with open(os.path.join(host.op_h(), "mxnet-cpp", "op.h")) as f:
        got = _op_h_entries(f.read())
    import mxnet_tpu.capi as jcapi
    want = {}
    for op in jcapi.list_all_op_names():
        if op.startswith("_") or not re.match(r"^[A-Za-z]\w*$", op):
            continue
        _, _, names, types, _, kv = jcapi.atomic_symbol_info(op)
        ins = tuple(n for n, t in zip(names, types)
                    if t == "NDArray-or-Symbol")
        attrs = tuple(n for n, t in zip(names, types)
                      if t != "NDArray-or-Symbol")
        want[op] = (() if kv else ins, attrs)
    assert sorted(got) == sorted(want)
    assert got == want
    for op in ("FullyConnected", "Convolution", "BatchNorm", "Pooling",
               "SoftmaxOutput", "Concat", "Activation", "Dropout",
               "Embedding", "RNN"):
        assert op in got


def test_recordio_c_api(libmx, tmp_path):
    """MXRecordIO* round trip; the file reads back through the port's
    MXRecordIO too."""
    uri = str(tmp_path / "data.rec").encode()
    w = ctypes.c_void_p()
    _check(libmx, libmx.MXRecordIOWriterCreate(uri, ctypes.byref(w)))
    payloads = [b"alpha", b"bravo" * 100, b"charlie"]
    for p in payloads:
        _check(libmx, libmx.MXRecordIOWriterWriteRecord(
            w, p, ctypes.c_size_t(len(p))))
    pos = ctypes.c_size_t()
    _check(libmx, libmx.MXRecordIOWriterTell(w, ctypes.byref(pos)))
    assert pos.value > 0
    _check(libmx, libmx.MXRecordIOWriterFree(w))
    r = ctypes.c_void_p()
    _check(libmx, libmx.MXRecordIOReaderCreate(uri, ctypes.byref(r)))
    got = []
    while True:
        buf = ctypes.c_char_p()
        size = ctypes.c_size_t()
        _check(libmx, libmx.MXRecordIOReaderReadRecord(
            r, ctypes.byref(buf), ctypes.byref(size)))
        if size.value == 0:
            break
        got.append(ctypes.string_at(buf, size.value))
    assert got == payloads
    _check(libmx, libmx.MXRecordIOReaderFree(r))
    rec = mt.recordio.MXRecordIO(uri.decode(), "r")
    assert [rec.read() for _ in payloads] == payloads
    rec.close()


def test_c_predict_partial_out_and_ndlist(libmx, mx, tmp_path):
    """MXPredCreatePartialOut up to fc1; the MXPredPartialForward loop
    counts down the JAX package's steps; the features equal the port's
    and the JAX package's ``Predictor(output_names=...)``; MXNDList reads
    the params blob."""
    prefix = str(tmp_path / "mlp")
    sym_json, params = _mlp_checkpoint(prefix)
    rc, pred = _pred_create(libmx, sym_json, params, outputs=[b"fc1"])
    _check(libmx, rc)
    x = np.linspace(-1, 1, BATCH * DIM).astype(np.float32)
    _set_input(libmx, pred, x)
    step, left = 0, ctypes.c_int(1)
    while left.value > 0:
        step += 1
        _check(libmx, libmx.MXPredPartialForward(pred, step,
                                                 ctypes.byref(left)))
    feat = _pred_output(libmx, pred)
    assert feat.shape == (BATCH, HIDDEN)
    _check(libmx, libmx.MXPredFree(pred))
    jax_pred = mx.predictor.Predictor(sym_json.decode(), params,
                                      {"data": (BATCH, DIM)},
                                      output_names=["fc1"])
    jax_pred.set_input("data", x.reshape(BATCH, DIM))
    jax_steps = 0
    while jax_pred.partial_forward(jax_steps + 1) > 0:
        jax_steps += 1
    assert step == jax_steps + 1 > 1
    np.testing.assert_allclose(feat, jax_pred.get_output(0), rtol=1e-5,
                               atol=1e-6)
    port = mt.Predictor(sym_json.decode(), params, {"data": (BATCH, DIM)},
                        dev_type="cpu", output_names=["fc1"])
    port.forward(data=x.reshape(BATCH, DIM))
    np.testing.assert_array_equal(feat, port.get_output(0))

    lst = ctypes.c_void_p()
    length = ctypes.c_uint()
    _check(libmx, libmx.MXNDListCreate(params, len(params),
                                       ctypes.byref(lst),
                                       ctypes.byref(length)))
    assert length.value == 6   # fc1-3 weight and bias
    key = ctypes.c_char_p()
    data_p = ctypes.POINTER(ctypes.c_float)()
    shape_p = ctypes.POINTER(ctypes.c_uint)()
    ndim = ctypes.c_uint()
    found = {}
    for i in range(length.value):
        _check(libmx, libmx.MXNDListGet(lst, i, ctypes.byref(key),
                                        ctypes.byref(data_p),
                                        ctypes.byref(shape_p),
                                        ctypes.byref(ndim)))
        shp = tuple(shape_p[j] for j in range(ndim.value))
        found[key.value.decode()] = np.ctypeslib.as_array(
            data_p, shape=(int(np.prod(shp)),)).reshape(shp).copy()
    want = mx.nd.load(prefix + "-0004.params")
    assert sorted(found) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(found[k], v.asnumpy())
    _check(libmx, libmx.MXNDListFree(lst))


def test_failed_build_raises_with_compiler_output(tmp_path):
    """A source the compiler refuses raises MXNetError carrying g++'s
    message, and a missing compiler raises too: nothing falls back to
    another library (such as the JAX package's build/libmxnet_tpu.so)."""
    broken = tmp_path / "c_api.cc"
    broken.write_text(open(HostLibrary().source).read()
                      + "\nint broken_here( {\n")
    host = HostLibrary()
    host.source = str(broken)
    with pytest.raises(mt.MXNetError) as e:
        host.get()
    assert "c_api.cc" in str(e.value) and "error" in str(e.value)
    assert not os.path.exists(host.so_path())
    assert host.lib is None
    missing = HostLibrary(cxx=str(tmp_path / "no-such-g++"))
    with pytest.raises(mt.MXNetError, match="cannot run"):
        missing.build()
