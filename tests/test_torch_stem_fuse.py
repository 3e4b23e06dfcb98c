"""mxnet_tpu_torch's fused input BatchNorm + stem convolution (the executor's
stem peephole and ``ops.nn.input_bn_conv``), the twin of
tests/python/unittest/test_stem_fuse.py, on the CPU in float64:

- d(beta) by per-tap rectangle sums and dW by the weight gradient, against
  autograd of the unfused composition and against the JAX package's
  ``input_bn_conv``, over its stem geometries, space-to-depth on and off;
- one ResNet-50 ``TrainStep`` step with MXNET_STEM_FUSE on (space-to-depth
  off and on) and off, against each other and against the JAX package's
  step, at 3x64x64, whose 7x7/s2/p3 stem space-to-depth takes;
- the gating: no fuse when the input needs a gradient, none where NormConv
  takes the BatchNorm.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import nn as pnn
from test_torch_resnet_train import _resnet, _state
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-9
GEOMS = [
    # H, K, S, P, Cin, Cout (test_stem_fuse.GEOMS: the 7x7/s2/p3 stem, and
    # a stride-2 geometry space-to-depth cannot take, k - 2p = 3)
    (16, 7, 2, 3, 3, 8),
    (16, 3, 1, 1, 3, 8),
    (15, 5, 2, 2, 4, 8),
    (8, 1, 1, 0, 3, 8),
    (9, 3, 2, 1, 2, 6),
    (16, 3, 2, 0, 3, 8),
]
EPS = 2e-5
SGD = dict(learning_rate=0.1, momentum=0.9)


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


class _X64(object):
    """JAX's 64-bit mode for the body of a ``with``."""

    def __init__(self, jax):
        self.jax = jax

    def __enter__(self):
        self.jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        self.jax.config.update("jax_enable_x64", False)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _count_stem(monkeypatch):
    """Count the executor's calls of the fused stem."""
    from mxnet_tpu_torch import executor as pexec
    calls = []
    real = pexec.input_bn_conv

    def counted(*a, **k):
        calls.append(k.get("s2d"))
        return real(*a, **k)
    monkeypatch.setattr(pexec, "input_bn_conv", counted)
    return calls


# --------------------------------------------------------------- the op
def _unfused(x, b, w, k, s, p):
    mean = x.mean(dim=(0, 1, 2))
    var = ((x * x).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
    y = (x - mean) * torch.rsqrt(var + EPS) + b
    return F.conv2d(y.permute(0, 3, 1, 2), w, stride=s,
                    padding=p).permute(0, 2, 3, 1)


@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("geom", GEOMS)
def test_dbeta_rectangle_sums_vs_autograd(geom, s2d, jax):
    """The fused op's output, d(beta) and dW equal autograd of the unfused
    composition and ``jax.value_and_grad`` of the JAX package's
    ``input_bn_conv`` within 1e-9, through a head gradient that is not
    constant (sum of out * cos(out))."""
    from mxnet_tpu.ops.nn import input_bn_conv as jibc
    jnp = jax.numpy
    h, k, s, p, cin, cout = geom
    rng = np.random.RandomState(0)
    x = rng.randn(3, h, h, cin)
    w = rng.randn(cout, cin, k, k) * 0.1
    b = rng.randn(cin)
    tb, tw = (torch.from_numpy(v).requires_grad_(True) for v in (b, w))
    out, _, _ = pnn.input_bn_conv(torch.from_numpy(x), tb, tw, EPS, (k, k),
                                  (s, s), (p, p), s2d=s2d)
    loss = (out * torch.cos(out)).sum()
    db, dw = torch.autograd.grad(loss, [tb, tw])
    ub, uw = (torch.from_numpy(v).requires_grad_(True) for v in (b, w))
    ref = _unfused(torch.from_numpy(x), ub, uw, k, s, p)
    rdb, rdw = torch.autograd.grad((ref * torch.cos(ref)).sum(), [ub, uw])
    _close(out.detach(), ref.detach(), "out vs unfused")
    _close(db, rdb, "dbeta vs unfused")
    _close(dw, rdw, "dw vs unfused")

    def jloss(b_, w_):
        o, _, _ = jibc(jnp.asarray(x), b_, w_, EPS, (k, k), (s, s), (p, p),
                       s2d=s2d)
        return jnp.sum(o * jnp.cos(o))
    with _X64(jax):
        v, (jdb, jdw) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(b),
                                                          jnp.asarray(w))
        v, jdb, jdw = float(v), np.asarray(jdb), np.asarray(jdw)
    np.testing.assert_allclose(loss.item(), v, rtol=1e-12)
    _close(db, jdb, "dbeta vs mxnet_tpu")
    _close(dw, jdw, "dw vs mxnet_tpu")


def test_s2d_packing_round_trip():
    """Space-to-depth packs the 7x7/s2/p3 stem into a 4x4 stride-1 conv on
    (H/2, W/2, 4C) with padding (2, 1) on each axis; the weights' gradient
    unpacks by the transpose of the packing's scatter."""
    geom = ((7, 7), (2, 2), (3, 3))
    assert pnn._s2d_eligible((2, 16, 16, 3), geom)
    assert not pnn._s2d_eligible((2, 15, 16, 3), geom)
    assert not pnn._s2d_eligible((2, 16, 16, 3), ((3, 3), (2, 2), (0, 0)))
    w = torch.randn(8, 3, 7, 7, dtype=torch.float64)
    wp, pads = pnn._s2d_pack_weights(w, geom)
    assert wp.shape == (8, 12, 4, 4) and pads == ((2, 1), (2, 1))
    # 49 of the 4 x 4 x 4 packed taps hold a weight, the others are zero
    assert int((wp.abs().sum(dim=(0,)) != 0).reshape(4, 3, 16).any(1)
               .sum()) == 49
    assert torch.equal(pnn._s2d_unpack_weight_grad(wp, geom), w)


# -------------------------------------------------------------- the graph
@pytest.fixture(scope="module")
def jax_step(jax):
    """The JAX package's float64 ResNet-50 step (3x64x64, 10 classes, batch
    2) with its default MXNET_STEM_FUSE=1, once for the module: (its JSON,
    the state, (params, aux) as numpy)."""
    mx = pytest.importorskip("mxnet_tpu")
    from mxnet_tpu.train import TrainStep as JTrainStep
    jsym = _resnet("jax", 10, 50, 64)
    state = _state(_resnet("torch", 10, 50, 64), 2, 64, 10)
    params, opt_state, aux, batch = state
    mp = pytest.MonkeyPatch()
    for k in ("MXNET_STEM_FUSE", "MXNET_STEM_S2D", "MXNET_NORM_CONV"):
        mp.delenv(k, raising=False)
    try:
        with _X64(jax):
            jts = JTrainStep(jsym, mx.optimizer.SGD(**SGD))
            asj = jax.numpy.asarray
            jp, _, ja, _ = jts({n: asj(v) for n, v in params.items()},
                               {n: tuple(asj(x) for x in st)
                                for n, st in opt_state.items()},
                               {n: asj(v) for n, v in aux.items()},
                               jts.shard_batch(batch))
            got = ({n: np.asarray(v) for n, v in jp.items()},
                   {n: np.asarray(v) for n, v in ja.items()})
    finally:
        mp.undo()
    return jsym.tojson(), state, got


def _port_step(sym_json, state, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    params, opt_state, aux, batch = state
    ts = mt.TrainStep(mt.sym.load_json(sym_json), mt.optimizer.SGD(**SGD),
                      ctx=mt.cpu())
    pp, ps, pa = mt.convert.train_state_from_numpy(params, opt_state, aux,
                                                   ctx=mt.cpu())
    pp, _, pa, _ = ts(pp, ps, pa, ts.shard_batch(batch))
    return pp, pa


@pytest.mark.parametrize("s2d", ["0", "1"])
def test_graph_parity_f64_resnet50(s2d, jax_step, monkeypatch):
    """One ResNet-50 step (3x64x64, batch 2) with MXNET_STEM_FUSE=1
    (MXNET_STEM_S2D as given) equals the step with it off and the JAX
    package's fused step within 1e-9: every parameter and moving
    statistic.  The fused run calls the stem once, the unfused never."""
    sym_json, state, (jp, ja) = jax_step
    calls = _count_stem(monkeypatch)
    p1, a1 = _port_step(sym_json, state, {"MXNET_STEM_FUSE": "1",
                                          "MXNET_STEM_S2D": s2d},
                        monkeypatch)
    assert calls == [s2d == "1"]
    p0, a0 = _port_step(sym_json, state, {"MXNET_STEM_FUSE": "0"},
                        monkeypatch)
    assert len(calls) == 1
    assert sorted(p1) == sorted(p0) == sorted(jp)
    for n in p0:
        _close(p1[n], p0[n], n + " vs unfused")
        _close(p1[n], jp[n], n + " vs mxnet_tpu")
    for n in a0:
        _close(a1[n], a0[n], n + " vs unfused")
        _close(a1[n], ja[n], n + " vs mxnet_tpu")
    assert not np.array_equal(a1["bn_data_moving_mean"].numpy(),
                              state[2]["bn_data_moving_mean"])


def _stem_net(pkg):
    return pkg.sym.SoftmaxOutput(
        pkg.sym.Flatten(pkg.sym.Convolution(
            pkg.sym.BatchNorm(pkg.sym.Variable("data"), fix_gamma=True,
                              eps=2e-5, name="bn_data"),
            num_filter=4, kernel=(3, 3), pad=(1, 1), no_bias=True,
            name="conv0")), name="softmax")


@pytest.mark.parametrize("data_grad", ["write", "null"])
def test_no_fuse_when_input_needs_grad(data_grad, monkeypatch):
    """Executor path: with a gradient requested for the input, the stem
    does not fuse and d(data) is real, equal to the JAX package's (which
    does not fuse there either); with none, it fuses and the parameters'
    gradients are the JAX package's."""
    mx = pytest.importorskip("mxnet_tpu")
    calls = _count_stem(monkeypatch)
    rs = np.random.RandomState(1)
    w = rs.randn(4, 3, 3, 3).astype(np.float32) * 0.1
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    y = np.array([1.0, 0.0], np.float32)
    grads = []
    for pkg in (mx, mt):
        net = _stem_net(pkg)
        req = {"data": data_grad, "softmax_label": "null",
               "bn_data_gamma": "write", "bn_data_beta": "write",
               "conv0_weight": "write"}
        ex = net.simple_bind(pkg.cpu(), data=(2, 3, 8, 8),
                             softmax_label=(2,), grad_req=req)
        ex.arg_dict["bn_data_gamma"][:] = np.ones(3, np.float32)
        ex.arg_dict["conv0_weight"][:] = w
        ex.forward(is_train=True, data=pkg.nd.array(x, ctx=pkg.cpu()),
                   softmax_label=pkg.nd.array(y, ctx=pkg.cpu()))
        ex.backward()
        grads.append({n: g.asnumpy() for n, g in ex.grad_dict.items()})
    assert len(calls) == (0 if data_grad == "write" else 1)
    if data_grad == "write":
        assert np.abs(grads[1]["data"]).sum() > 0
    assert sorted(grads[0]) == sorted(grads[1])
    for n, g in grads[0].items():
        np.testing.assert_allclose(grads[1][n], g, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_norm_conv_takes_the_stem_first(monkeypatch):
    """With MXNET_NORM_CONV=1 the 32x32 ResNet's bn_data -> conv0 (3x3) is
    NormConv's, so the stem peephole stands aside; at 64x64 the 7x7 conv0
    is not NormConv's and the stem fuses."""
    calls = _count_stem(monkeypatch)
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    for image, fused in ((32, 0), (64, 1)):
        sym = _resnet("torch", 10, 50, image)
        params, opt_state, aux, batch = _state(sym, 2, image, 10)
        del calls[:]
        ts = mt.TrainStep(sym, mt.optimizer.SGD(**SGD), ctx=mt.cpu())
        pp, ps, pa = mt.convert.train_state_from_numpy(
            params, opt_state, aux, ctx=mt.cpu())
        ts(pp, ps, pa, ts.shard_batch(batch))
        assert len(calls) == fused, image
