"""The sequence ops of mxnet_tpu_torch (ops/sequence.py) against
mxnet_tpu's, on the CPU in float64: SequenceLast, SequenceMask and
SequenceReverse, with and without ``sequence_length``, forward through
``mx.nd`` and forward plus gradients through a bound graph."""
import numpy as np
import pytest

import mxnet_tpu_torch as mt

TOL = 1e-12
OPS = ["SequenceLast", "SequenceMask", "SequenceReverse"]


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    jax.config.update("jax_enable_x64", True)
    yield mx
    jax.config.update("jax_enable_x64", False)


def _inputs(shape):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape)
    lens = rs.randint(1, shape[0] + 1, shape[1]).astype(np.float64)
    lens[0] = shape[0]            # one full-length sequence
    return x, lens


def _attrs(op, use_len):
    attrs = {"use_sequence_length": use_len}
    if op == "SequenceMask":
        attrs["value"] = -2.5
    return attrs


@pytest.mark.parametrize("shape", [(5, 3), (5, 3, 4), (4, 2, 3, 2)])
@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_nd_matches_mxnet_tpu(op, use_len, shape, jx):
    x, lens = _inputs(shape)
    outs = []
    for pkg in (mt, jx):
        ins = [pkg.nd.array(x, ctx=pkg.cpu(), dtype=np.float64)]
        if use_len:
            ins.append(pkg.nd.array(lens, ctx=pkg.cpu(), dtype=np.float64))
        outs.append(getattr(pkg.nd, op)(*ins, **_attrs(op, use_len))
                    .asnumpy())
    assert outs[0].shape == outs[1].shape
    np.testing.assert_allclose(outs[0], outs[1], rtol=TOL, atol=TOL)


def _graph(pkg, op, use_len, x, lens, head):
    ctx = pkg.cpu()
    ins = [pkg.sym.Variable("data")]
    args = {"data": pkg.nd.array(x, ctx=ctx, dtype=np.float64)}
    if use_len:
        ins.append(pkg.sym.Variable("sequence_length"))
        args["sequence_length"] = pkg.nd.array(lens, ctx=ctx,
                                               dtype=np.float64)
    net = getattr(pkg.sym, op)(*ins, **_attrs(op, use_len))
    grads = {"data": pkg.nd.zeros(x.shape, ctx=ctx, dtype=np.float64)}
    ex = net.bind(ctx, args, args_grad=grads,
                  grad_req={"data": "write", "sequence_length": "null"})
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([pkg.nd.array(head, ctx=ctx, dtype=np.float64)])
    return out, grads["data"].asnumpy()


@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_graph_gradients_match_mxnet_tpu(op, use_len, jx):
    x, lens = _inputs((6, 4, 3))
    out_shape = x.shape[1:] if op == "SequenceLast" else x.shape
    head = np.random.RandomState(1).randn(*out_shape)
    got = _graph(mt, op, use_len, x, lens, head)
    want = _graph(jx, op, use_len, x, lens, head)
    for g, w, what in zip(got, want, ("output", "d data")):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=what)
