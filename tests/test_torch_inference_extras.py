"""The inference extras of the port on the CPU, against mxnet_tpu:

- ``nd.save_raw_bytes`` / ``load_from_raw_bytes``: the bytes equal the JAX
  package's for every dtype code (float64 and int64 with JAX's x64 on), and
  each package loads the other's;
- ``Predictor.partial_forward``: the JAX package's step protocol, the same
  ``step_left`` at every step, with and without ``output_names``, and the
  outputs the forward gives;
- ``cpu_pinned``: a context (id 3) that raises ``MXNetError`` when it is
  resolved without a card, and on the card (``cuda`` marker) page-locked
  host arrays that copy to and from ``gpu(0)``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
DTYPES = ("float32", "float16", "uint8", "int32", "int8", "bfloat16")
X64_DTYPES = ("float64", "int64")


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.predictor  # noqa: F401
    return mx


def _values(dtype, shape=(3, 4, 5)):
    v = RS(0).uniform(-100, 100, shape)
    if dtype == "uint8":
        v = np.abs(v)
    return v


def _raw_pair(mx, dtype, shape=(3, 4, 5)):
    v = _values(dtype, shape)
    port = mt.nd.array(v, ctx=mt.cpu(), dtype=dtype)
    jax_arr = mx.nd.array(v, dtype=dtype)
    assert str(port.dtype) == str(jax_arr.dtype) or dtype == "bfloat16"
    return port, jax_arr


def _check_raw(mx, dtype, shape=(3, 4, 5)):
    port, jax_arr = _raw_pair(mx, dtype, shape)
    raw = mt.nd.save_raw_bytes(port)
    assert raw == mx.nd.save_raw_bytes(jax_arr)
    back = mx.nd.load_from_raw_bytes(raw)
    np.testing.assert_array_equal(
        np.asarray(back.asnumpy(), np.float64),
        np.asarray(port.asnumpy(), np.float64))
    mine = mt.nd.load_from_raw_bytes(mx.nd.save_raw_bytes(jax_arr),
                                     ctx=mt.cpu())
    assert mine.value.dtype == port.value.dtype
    assert torch.equal(mine.value, port.value)


@pytest.mark.parametrize("dtype", DTYPES)
def test_raw_bytes_match_mxnet_tpu(mx, dtype):
    _check_raw(mx, dtype)


@pytest.mark.parametrize("dtype", X64_DTYPES)
def test_raw_bytes_match_mxnet_tpu_x64(mx, dtype):
    import jax
    with jax.enable_x64(True):
        _check_raw(mx, dtype)


def test_raw_bytes_shapes_and_faults(mx):
    for shape in ((1,), (7,), (2, 0, 3)):
        _check_raw(mx, "float32", shape)
    # a 0-d array (the JAX package's nd.array makes (1,) of a scalar)
    s = mt.nd.array(np.float32(2.5), ctx=mt.cpu())
    assert s.shape == ()
    raw = mt.nd.save_raw_bytes(s)
    assert len(raw) == 16 + 4
    assert mt.nd.load_from_raw_bytes(raw, ctx=mt.cpu()).asnumpy() == 2.5
    raw = mt.nd.save_raw_bytes(mt.nd.ones((2, 3), ctx=mt.cpu()))
    with pytest.raises(mt.MXNetError, match="truncated"):
        mt.nd.load_from_raw_bytes(raw[:-1], ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="invalid"):
        mt.nd.load_from_raw_bytes(b"\0" * len(raw), ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="invalid"):
        mt.nd.load_from_raw_bytes(raw[:8], ctx=mt.cpu())


def _nets():
    """(name, port symbol, JAX symbol factory, input shape, outputs)."""
    return [
        ("mlp", mt.models.get_mlp(num_classes=4), "get_mlp", (2, 20),
         None),
        ("mlp_fc1", mt.models.get_mlp(num_classes=4), "get_mlp", (2, 20),
         ["fc1"]),
        ("mlp_two", mt.models.get_mlp(num_classes=4), "get_mlp", (2, 20),
         ["fc1", "fc2_output"]),
        ("lenet_pool", mt.models.get_lenet(num_classes=4), "get_lenet",
         (2, 1, 28, 28), ["pool2"]),
        ("lenet", mt.models.get_lenet(num_classes=4), "get_lenet",
         (2, 1, 28, 28), None),
    ]


@pytest.mark.parametrize("case", range(5))
def test_partial_forward_matches_mxnet_tpu(mx, case):
    name, net, factory, shape, outputs = _nets()[case]
    import mxnet_tpu.models  # noqa: F401
    jnet = getattr(mx.models, factory)(num_classes=4)
    arg_shapes, _, _ = net.infer_shape(data=shape)
    rs = RS(1)
    params = {"arg:" + n: (rs.randn(*s) * 0.1).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    blob = mt.nd.serialize_arrays(params)
    x = RS(2).randn(*shape).astype(np.float32)
    port = mt.Predictor(net.tojson(), blob, {"data": shape}, dev_type="cpu",
                        output_names=outputs)
    jax_pred = mx.predictor.Predictor(jnet.tojson(), blob, {"data": shape},
                                      output_names=outputs)
    port.set_input("data", x)
    jax_pred.set_input("data", x)
    got, want = [], []
    step = 0
    while True:
        step += 1
        got.append(port.partial_forward(step))
        want.append(jax_pred.partial_forward(step))
        if want[-1] == 0:
            break
    assert got == want, name
    assert len(want) > 1
    assert port.num_outputs == jax_pred.num_outputs == \
        (len(outputs) if outputs else 1)
    for i in range(port.num_outputs):
        # float32 through each package's own convolutions and products
        np.testing.assert_allclose(port.get_output(i),
                                   jax_pred.get_output(i), rtol=1e-5,
                                   atol=1e-5)
    # a further call leaves the outputs and reports 0 steps left
    before = port.get_output(0)
    assert port.partial_forward(step + 5) == 0
    np.testing.assert_array_equal(port.get_output(0), before)


def test_cpu_pinned_needs_a_card():
    """cpu_pinned is a context, id 3; without a card resolving it raises,
    as gpu does, and nothing lands in pageable memory instead."""
    ctx = mt.cpu_pinned()
    assert ctx.device_typeid == 3 and str(ctx) == "cpu_pinned(0)"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (lambda: ctx.torch_device(),
               lambda: mt.nd.zeros((2,), ctx=ctx),
               lambda: mt.nd.array(np.ones(2), ctx=ctx),
               lambda: mt.nd.ones((2,), ctx=mt.cpu()).copyto(ctx),
               lambda: mt.nd.load_from_raw_bytes(
                   mt.nd.save_raw_bytes(mt.nd.ones((2,), ctx=mt.cpu())),
                   ctx=ctx)):
        with pytest.raises(mt.MXNetError, match="needs a CUDA device"):
            fn()
    with pytest.raises(mt.MXNetError, match="unknown device type tpu"):
        mt.Context("tpu", 0)


@pytest.mark.cuda
def test_cpu_pinned_on_card():
    """On the card: arrays on cpu_pinned() are page-locked, whether made
    there, copied there, loaded there or computed there; copies to and
    from gpu(0) keep the values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx = mt.cpu_pinned()
    v = RS(0).randn(64, 33).astype(np.float32)
    a = mt.nd.array(v, ctx=ctx)
    assert a.value.is_pinned() and a.context == ctx
    z = mt.nd.zeros((5, 5), ctx=ctx)
    assert z.value.is_pinned()
    g = a.copyto(mt.gpu(0))
    assert g.value.is_cuda
    back = g.copyto(ctx)
    assert back.value.is_pinned()
    np.testing.assert_array_equal(back.asnumpy(), v)
    np.testing.assert_array_equal(back.asnumpy(),
                                  g.copyto(mt.cpu()).asnumpy())
    s = a + a
    assert s.value.is_pinned()
    np.testing.assert_array_equal(s.asnumpy(), v + v)
    r = mt.nd.load_from_raw_bytes(mt.nd.save_raw_bytes(g), ctx=ctx)
    assert r.value.is_pinned()
    np.testing.assert_array_equal(r.asnumpy(), v)
    # copyto into an existing pinned array keeps its storage
    ptr = back.value.data_ptr()
    (g * 2).copyto(back)
    assert back.value.data_ptr() == ptr and back.value.is_pinned()
    np.testing.assert_array_equal(back.asnumpy(), 2 * v)
