"""mxnet_tpu_torch's Executor walk against mxnet_tpu's on four paths:
sampling ops inside a graph (drawn from the bound device's generator;
compared by statistics, since torch's Philox and JAX's threefry give other
streams), ops with no input (built on the bound device), the max-pool
equality-mask backward of ``MXNET_POOL_MASK_BWD`` (every tied maximum takes
the window's gradient), and a keyword NDArray of another shape, which
rebinds the input as the reference does.  The ``cuda`` test binds to
``gpu(0)`` and skips without a card.

JAX is imported by the tests that compare with it, not by the module, so
that the ``cuda`` test also runs where only the port is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_executor_faults.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import _Lowered
from test_torch_threads import torch_threads_per_worker  # noqa: F401

PKGS = ["jax", "torch"]


def _pkg(name):
    return mt if name == "torch" else pytest.importorskip("mxnet_tpu")


def _bind(pkg, net, args, ctx=None, **kw):
    ctx = ctx or pkg.cpu()
    return net.bind(ctx, {n: pkg.nd.array(v, ctx=ctx) for n, v in
                          args.items()}, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_uniform_sampler_in_a_graph(pkg):
    pkg = _pkg(pkg)
    net = pkg.sym.uniform(shape=(2, 3), low=2.0, high=3.0) \
        + pkg.sym.Variable("x")
    x = np.arange(6, dtype=np.float32).reshape(2, 3) * 10
    out = _bind(pkg, net, {"x": x}).forward()[0].asnumpy()
    assert out.shape == (2, 3)
    u = out - x
    assert ((u >= 2.0) & (u < 3.0)).all()


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("op", ["_random_normal", "normal"])
def test_normal_sampler_statistics(pkg, op):
    """20000 draws of N(1.5, 2) through one graph node: the sample mean
    within 5 standard errors of loc, the sample std within 3%."""
    pkg = _pkg(pkg)
    n = 20000
    net = getattr(pkg.sym, op)(shape=(n,), loc=1.5, scale=2.0) \
        + pkg.sym.Variable("x")
    out = _bind(pkg, net, {"x": np.zeros(n, np.float32)}).forward()[0]
    s = out.asnumpy().astype(np.float64)
    assert abs(s.mean() - 1.5) < 5 * 2.0 / np.sqrt(n)
    assert abs(s.std() - 2.0) < 0.06


def test_sampler_draws_from_the_bound_generator():
    """Two forwards after one seed give the draws of one generator in
    order; reseeding repeats them."""
    net = mt.sym.uniform(shape=(4,)) + mt.sym.Variable("x")
    ex = _bind(mt, net, {"x": np.zeros(4, np.float32)})
    mt.random.seed(7)
    a, b = (ex.forward()[0].asnumpy().copy() for _ in range(2))
    mt.random.seed(7)
    assert np.array_equal(ex.forward()[0].asnumpy(), a)
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("pkg", PKGS)
def test_no_input_op_in_a_graph(pkg):
    pkg = _pkg(pkg)
    net = pkg.sym._ones(shape=(2, 3)) + pkg.sym.Variable("x")
    x = np.full((2, 3), 0.5, np.float32)
    out = _bind(pkg, net, {"x": x}).forward()[0].asnumpy()
    np.testing.assert_array_equal(out, np.full((2, 3), 1.5, np.float32))


def test_walk_hands_the_bound_device_to_no_input_ops():
    """An op with no input runs under the device the walk is given (here
    ``meta``, which no default reaches), and by default under the device
    of the bound values."""
    low = _Lowered(mt.sym._ones(shape=(2, 3)) + mt.sym.Variable("x"))
    x = torch.empty(2, 3, device="meta")
    for kw in ({"device": torch.device("meta")}, {}):
        (out,), _ = low.run({"x": x}, {}, **kw)
        assert out.device.type == "meta" and tuple(out.shape) == (2, 3)
    (out,), _ = _Lowered(mt.sym._ones(shape=(3,))).run(
        {}, {}, device=torch.device("meta"))
    assert out.device.type == "meta"


@pytest.mark.cuda
def test_no_input_op_bound_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gpu = mt.gpu(0)
    net = mt.sym._ones(shape=(2, 3)) + mt.sym.Variable("data")
    ex = net.bind(gpu, {"data": mt.nd.array(np.full((2, 3), 2, np.float32),
                                            ctx=gpu)})
    out = ex.forward()[0]
    assert out.value.is_cuda
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 3), 3.0))
    net = mt.sym.normal(shape=(1000,)) + mt.sym.Variable("data")
    ex = net.bind(gpu, {"data": mt.nd.zeros((1000,), ctx=gpu)})
    assert ex.forward()[0].value.is_cuda


POOLS = [((2, 2), (2, 2), (0, 0)), ((3, 3), (1, 1), (1, 1)),
         ((3, 3), (2, 2), (1, 1))]


def _pool_grads(pkg, x, dy, kernel, stride, pad):
    net = pkg.sym.Pooling(pkg.sym.Variable("data"), kernel=kernel,
                          stride=stride, pad=pad, pool_type="max")
    ctx = pkg.cpu()
    ex = net.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                  args_grad={"data": pkg.nd.zeros(x.shape, ctx=ctx)},
                  grad_req="write")
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([pkg.nd.array(dy, ctx=ctx)])
    return out, ex.grad_dict["data"].asnumpy()


@pytest.mark.parametrize("mask", ["1", "0"])
@pytest.mark.parametrize("geom", POOLS, ids=["2x2s2", "3x3s1p1", "3x3s2p1"])
def test_max_pool_mask_backward_parity(geom, mask, monkeypatch):
    """Inputs drawn from {0, 1, 2} tie inside most windows: with the
    variable at 1 every tied maximum takes the gradient in both packages;
    at 0 both route it to one of them."""
    monkeypatch.setenv("MXNET_POOL_MASK_BWD", mask)
    mx = _pkg("jax")
    rng = np.random.RandomState(11)
    x = rng.randint(0, 3, (2, 3, 7, 8)).astype(np.float32)
    kernel, stride, pad = geom
    out_shape = mx.sym.Pooling(mx.sym.Variable("data"), kernel=kernel,
                               stride=stride, pad=pad).infer_shape(
        data=x.shape)[1][0]
    dy = rng.randn(*out_shape).astype(np.float32)
    jo, jg = _pool_grads(mx, x, dy, kernel, stride, pad)
    po, pg = _pool_grads(mt, x, dy, kernel, stride, pad)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=1e-6)
    ties = np.abs(pg).sum() > np.abs(dy).sum() + 1e-3
    assert ties == (mask == "1")


@pytest.mark.parametrize("pkg", PKGS)
def test_forward_rebinds_an_ndarray_of_another_shape(pkg):
    """A (4, 5)-bound FullyConnected fed a (2, 5) NDArray gives (2, 3); a
    numpy input of the bound shape is still copied in place."""
    pkg = _pkg(pkg)
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                 name="fc")
    rng = np.random.RandomState(5)
    w, b = rng.randn(3, 5).astype(np.float32), np.zeros(3, np.float32)
    ex = _bind(pkg, net, {"data": np.zeros((4, 5), np.float32),
                          "fc_weight": w, "fc_bias": b})
    x = rng.randn(2, 5).astype(np.float32)
    ctx = pkg.cpu()
    out = ex.forward(data=pkg.nd.array(x, ctx=ctx))[0].asnumpy()
    assert out.shape == (2, 3)
    np.testing.assert_allclose(out, x @ w.T, rtol=1e-5, atol=1e-6)
    assert ex.arg_dict["data"].shape == (2, 5)
    x2 = rng.randn(2, 5).astype(np.float32)
    out = ex.forward(data=x2)[0].asnumpy()
    np.testing.assert_allclose(out, x2 @ w.T, rtol=1e-5, atol=1e-6)
