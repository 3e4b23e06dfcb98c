"""Matrix products of mixed float dtypes in mxnet_tpu_torch, against
mxnet_tpu's, on the CPU.

The JAX package's ``FullyConnected``, ``dot`` and ``batch_dot`` promote
their operands as ``jnp.dot`` does: float32 data with bfloat16 weights
gives float32.  The port promotes with ``torch.promote_types`` before the
product (``ops/elemwise.promoted``), in those ops and in the ``RNN`` op's
steps and cuDNN route.  So a JAX-saved LSTM LM's symbol JSON, whose begin
states are ``_state_init(dtype="float32")``, trains under a bfloat16 policy
in the port as in the JAX package, with its recurrence in float32; the
port's own cell graphs write the same float32 states.

- ``mt.nd.FullyConnected``, ``dot`` and ``batch_dot`` of float32 x
  bfloat16 (either side) against ``mxnet_tpu.nd``: the result dtype and
  values (PROD_TOL: the products of the same bfloat16-exact operands in
  float32, summed in another order).
- The LSTM LM (unrolled ``LSTMCell`` stack, and ``FusedRNNCell``) built and
  saved by the JAX package, loaded from its JSON: one CPU step of the
  port's ``TrainStep(policy="bfloat16")``, and ``EvalStep`` of both
  packages under the policy from the same parameters: float32 outputs
  within BF16_TOL of each other (bfloat16 rounds at other places in the
  two frameworks).
"""
import json

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

PROD_TOL = 1e-5
BF16_TOL = 2e-2
V, E, H, T, N = 30, 8, 8, 5, 4


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.rnn  # noqa: F401
    import mxnet_tpu.train  # noqa: F401
    return mx


def _arrays(pkg, *pairs):
    """NDArrays of (numpy float32 array, dtype name) pairs."""
    out = []
    for a, dt in pairs:
        kw = {"ctx": mt.cpu()} if pkg is mt else {}
        out.append(pkg.nd.array(a, dtype=dt, **kw))
    return out


def _check(got, want):
    assert str(got.dtype) == str(want.dtype) == "float32", \
        (got.dtype, want.dtype)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=PROD_TOL,
                               atol=PROD_TOL)


@pytest.mark.parametrize("bf16_side", ["weight", "data"])
def test_fully_connected_promotes(mx, bf16_side):
    rs = np.random.RandomState(0)
    x, w, b = rs.randn(3, 2, 4), rs.randn(5, 8), rs.randn(5)
    dts = ("float32", "bfloat16", "bfloat16") if bf16_side == "weight" \
        else ("bfloat16", "float32", "float32")
    res = [pkg.nd.FullyConnected(*_arrays(pkg, *zip((x, w, b), dts)),
                                 num_hidden=5) for pkg in (mt, mx)]
    _check(*res)


@pytest.mark.parametrize("op,shapes", [
    ("dot", ((3, 4), (4, 5))),
    ("dot", ((2, 3, 4), (4, 5))),
    ("batch_dot", ((2, 3, 4), (2, 4, 5)))])
@pytest.mark.parametrize("bf16_side", ["lhs", "rhs"])
def test_dot_and_batch_dot_promote(mx, op, shapes, bf16_side):
    rs = np.random.RandomState(1)
    a, b = (rs.randn(*s) for s in shapes)
    dts = ("float32", "bfloat16") if bf16_side == "rhs" \
        else ("bfloat16", "float32")
    res = [getattr(pkg.nd, op)(*_arrays(pkg, (a, dts[0]), (b, dts[1])))
           for pkg in (mt, mx)]
    _check(*res)


def _lm(mx, fused):
    """The LSTM LM built by the JAX package (2 layers, bucket T)."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data=data, input_dim=V, output_dim=E,
                             name="embed")
    if fused:
        cell = mx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                   prefix="lstm_")
    else:
        cell = mx.rnn.SequentialRNNCell()
        for i in range(2):
            cell.add(mx.rnn.LSTMCell(num_hidden=H, prefix="lstm_l%d_" % i))
    out, _ = cell.unroll(T, inputs=embed, merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, H)),
                                 num_hidden=V, name="pred")
    return mx.sym.SoftmaxOutput(pred, mx.sym.Reshape(label, shape=(-1,)),
                                name="softmax")


def _state_dtypes(js):
    return {(n.get("attrs") or n.get("param") or {}).get("dtype")
            for n in json.loads(js)["nodes"] if n["op"] == "_state_init"}


@pytest.mark.parametrize("fused", [False, True], ids=["stack", "fused"])
def test_jax_saved_lstm_lm_trains_under_bf16_policy(mx, fused):
    import jax.numpy as jnp
    js = _lm(mx, fused).tojson()
    assert _state_dtypes(js) == {"float32"}
    net = mt.sym.load_json(js)
    # the port's own graph writes the same begin-state dtype
    assert _state_dtypes(_lm(mt, fused).tojson()) == {"float32"}
    ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=0.1),
                      policy="bfloat16", ctx=mt.cpu())
    p, s, a = ts.init({"data": (N, T)}, {"softmax_label": (N, T)})
    rs = np.random.RandomState(0)
    batch = {"data": rs.randint(0, V, (N, T)).astype(np.float32),
             "softmax_label": rs.randint(0, V, (N, T)).astype(np.float32)}
    before = {k: v.clone() for k, v in p.items()}
    p, s, a, outs = ts(p, s, a, batch)
    assert outs[0].dtype == mt.base.torch_dtype("float32")
    assert np.isfinite(outs[0].numpy()).all()
    assert all(np.isfinite(v.numpy()).all() for v in p.values())
    assert any((p[k] != before[k]).any() for k in p)
    # EvalStep under the policy: float32 probabilities from both packages
    got = mt.EvalStep(net, policy="bfloat16")(p, a, batch)[0]
    want = mx.train.EvalStep(mx.sym.load_json(js), policy="bfloat16")(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, {}, batch)[0]
    assert str(got.dtype) == "torch.float32" and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_TOL)


def test_port_cells_write_float32_states():
    """The port's own cells keep the reference's float32 begin states, and
    a float64 graph from them runs (the products promote)."""
    cell = mt.rnn.LSTMCell(num_hidden=H, prefix="l0_")
    data = mt.sym.Variable("data")
    out, _ = cell.unroll(T, inputs=data)
    assert _state_dtypes(mt.sym.Group(out).tojson()) == {"float32"}
    fused = mt.rnn.FusedRNNCell(H, num_layers=1, mode="lstm", prefix="f_")
    fo, _ = fused.unroll(T, inputs=data, merge_outputs=True)
    ex = fo.simple_bind(mt.cpu(), type_dict={
        n: np.float64 for n in fo.list_arguments()}, data=(N, T, E))
    for v in ex.arg_dict.values():
        v[:] = np.random.RandomState(2).randn(*v.shape) * 0.1
    res = ex.forward()[0]
    assert res.dtype == np.float64 and np.isfinite(res.asnumpy()).all()
