"""The imperative optimizer half of mxnet_tpu_torch against mxnet_tpu's: three
``Updater`` steps of every optimizer on four parameters (with rescale_grad,
clip_gradient, wd and an lr schedule) held to the JAX ``Updater`` in
float64 at 1e-9; the port's ``Updater`` against its own fused rule
(``train._FunctionalOptimizer``) for the seven rules they share; SGLD by
the statistics of its noise; and the ``get_states``/``set_states``
round trip."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.train import _FunctionalOptimizer
from test_torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-9
SHAPES = {"fc1_weight": (4, 3), "fc1_bias": (3,), "bn_gamma": (3,),
          "fc2_weight": (2, 5)}
NAMES = sorted(SHAPES)
IDX2NAME = dict(enumerate(NAMES))
STEPS = 3

CASES = {
    "sgd": ("SGD", {}),
    "sgd_momentum": ("SGD", {"momentum": 0.9}),
    "ccsgd": ("ccSGD", {"momentum": 0.8}),
    "nag": ("NAG", {}),
    "nag_momentum": ("NAG", {"momentum": 0.9}),
    "adam": ("Adam", {"learning_rate": 0.01, "beta1": 0.8, "beta2": 0.95}),
    "adagrad": ("AdaGrad", {"eps": 1e-6}),
    "rmsprop": ("RMSProp", {"learning_rate": 0.01, "gamma1": 0.8}),
    "rmsprop_centered": ("RMSProp", {"learning_rate": 0.01, "gamma1": 0.8,
                                     "gamma2": 0.7, "centered": True,
                                     "clip_weights": 2.0}),
    "adadelta": ("AdaDelta", {"rho": 0.8, "epsilon": 1e-4}),
    "dcasgd": ("DCASGD", {"lamda": 0.1}),
    "dcasgd_momentum": ("DCASGD", {"momentum": 0.9, "lamda": 0.1}),
    "test": ("Test", {}),
}
# the rules TrainStep's fused path shares with the Updater
SHARED = ("sgd", "sgd_momentum", "ccsgd", "nag", "nag_momentum", "adam",
          "adagrad", "rmsprop", "rmsprop_centered", "adadelta")


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _data(seed):
    rs = np.random.RandomState(seed)
    weights = {n: rs.randn(*s) for n, s in SHAPES.items()}
    grads = [{n: rs.randn(*s) * 3 for n, s in SHAPES.items()}
             for _ in range(STEPS)]
    return weights, grads


def _make(pkg, case, schedule=True):
    klass, kw = CASES[case]
    kw = dict(kw)
    kw.setdefault("learning_rate", 0.1)
    if schedule:
        kw["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(step=2,
                                                              factor=0.5)
    return getattr(pkg.optimizer, klass)(
        rescale_grad=0.5, clip_gradient=1.0, wd=0.05,
        param_idx2name=dict(IDX2NAME), **kw)


def _run(pkg, case, weights, grads, arr):
    upd = pkg.optimizer.get_updater(_make(pkg, case))
    ws = [arr(weights[n]) for n in NAMES]
    for step in grads:
        for i, n in enumerate(NAMES):
            upd(i, arr(step[n]), ws[i])
    return upd, ws


def _flat_states(st):
    if st is None:
        return []
    if isinstance(st, tuple):
        return [s for s in st if s is not None]
    return [st]


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= rel * scale, \
        "%s: max |d| %.3g > %g x %.3g" % (what, err, rel, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_updater_matches_jax(f64, case):
    weights, grads = _data(0)
    jupd, jw = _run(mx, case, weights, grads,
                    lambda a: mx.nd.array(a, dtype=np.float64))
    pupd, pw = _run(mt, case, weights, grads,
                    lambda a: mt.nd.array(a, ctx=mt.cpu(), dtype=np.float64))
    for n, a, b in zip(NAMES, pw, jw):
        assert a.dtype == b.dtype
        _close(a.asnumpy(), b.asnumpy(), "%s %s" % (case, n))
    for i in range(len(NAMES)):
        js, ps = _flat_states(jupd.states[i]), _flat_states(pupd.states[i])
        assert len(js) == len(ps)
        for k, (a, b) in enumerate(zip(ps, js)):
            assert a.dtype == b.dtype, (case, i, k, a.dtype, b.dtype)
            _close(a.asnumpy(), b.asnumpy(), "%s state %d.%d" % (case, i, k))
    assert pupd.optimizer.num_update == jupd.optimizer.num_update


@pytest.mark.parametrize("case", SHARED)
def test_updater_matches_fused_rule(case):
    """The same tensors through the Updater and through TrainStep's fused
    rule, float64 at 1e-7 of the largest |w|: the fused rule rounds its
    step scalars (lr, Adam's bias correction) to float32 as the JAX
    package's TrainStep does, the Updater keeps them in float64 as its
    Updater does (a relative 6e-8 of each step)."""
    weights, grads = _data(1)
    upd = mt.optimizer.get_updater(_make(mt, case, schedule=False))
    ws = [mt.nd.array(weights[n], ctx=mt.cpu(), dtype=np.float64)
          for n in NAMES]
    fopt = _FunctionalOptimizer(_make(mt, case, schedule=False), NAMES)
    fw = {n: torch.from_numpy(weights[n].copy()) for n in NAMES}
    state = fopt.init_state(fw)
    for t, step in enumerate(grads, 1):
        hyper = fopt.hyper(t - 1)
        for i, n in enumerate(NAMES):
            g = torch.from_numpy(step[n])
            upd(i, mt.nd.array(g, ctx=mt.cpu()), ws[i])
            nw, ns = fopt.update(n, fw[n], g, state[n], hyper, t)
            fw[n].copy_(nw)
            for s, v in zip(state[n], ns):
                s.copy_(v)
    for i, n in enumerate(NAMES):
        _close(ws[i].asnumpy(), fw[n].numpy(), "%s %s" % (case, n), 1e-7)
        ps = _flat_states(upd.states[i])
        assert len(ps) == len(state[n])
        for a, b in zip(ps, state[n]):
            _close(a.asnumpy(), b.numpy(), "%s state of %s" % (case, n), 1e-7)


def test_sgld_noise_statistics():
    """One SGLD step over 10^6 weights: (w1 - w0 + lr/2 (g + wd w0)) /
    sqrt(lr) is the drawn noise, N(0, 1)."""
    n, lr, wd = 10 ** 6, 0.01, 0.1
    rs = np.random.RandomState(2)
    w0, g = rs.randn(n), rs.randn(n)
    opt = mt.optimizer.SGLD(learning_rate=lr, wd=wd,
                            param_idx2name={0: "w_weight"})
    w = mt.nd.array(w0, ctx=mt.cpu(), dtype=np.float64)
    mt.random.seed(5)
    mt.optimizer.get_updater(opt)(0, mt.nd.array(g, ctx=mt.cpu(),
                                                 dtype=np.float64), w)
    z = (w.asnumpy() - w0 + lr / 2 * (g + wd * w0)) / np.sqrt(lr)
    assert abs(z.mean()) < 0.005 and abs(z.std() - 1) < 0.005, \
        (z.mean(), z.std())


def test_sgld_updates_views_in_place():
    """A view taken before the update sees it (the update is in place)."""
    w = mt.nd.array(np.ones((4, 3)), ctx=mt.cpu(), dtype=np.float64)
    row = w[1]
    mt.optimizer.get_updater(mt.optimizer.SGLD(learning_rate=0.01))(
        0, mt.nd.array(np.ones((4, 3)), ctx=mt.cpu(), dtype=np.float64), w)
    np.testing.assert_array_equal(row.asnumpy(), w.asnumpy()[1])
    assert not np.array_equal(row.asnumpy(), np.ones(3))


@pytest.mark.parametrize("case", ["adam", "dcasgd_momentum", "sgd"])
def test_get_set_states_round_trip(case):
    weights, grads = _data(3)
    upd, ws = _run(mt, case, weights, grads[:2],
                   lambda a: mt.nd.array(a, ctx=mt.cpu(), dtype=np.float64))
    blob = upd.get_states()
    other = mt.optimizer.get_updater(_make(mt, case))
    other.set_states(blob)
    assert sorted(other.states) == sorted(upd.states)
    for i in upd.states:
        a, b = _flat_states(upd.states[i]), _flat_states(other.states[i])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x is not y and y.context == mt.cpu() and \
                y.dtype == x.dtype
            np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
    # the restored states carry on as the originals do
    other.optimizer._index_update_count = dict(
        upd.optimizer._index_update_count)
    other.optimizer.num_update = upd.optimizer.num_update
    ws2 = [mt.nd.array(w.asnumpy(), ctx=mt.cpu(), dtype=np.float64)
           for w in ws]
    for i, n in enumerate(NAMES):
        g = grads[2][n]
        upd(i, mt.nd.array(g, ctx=mt.cpu(), dtype=np.float64), ws[i])
        other(i, mt.nd.array(g, ctx=mt.cpu(), dtype=np.float64), ws2[i])
    for a, b in zip(ws, ws2):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_create_and_refusals():
    opt = mt.optimizer.create("sgld", learning_rate=0.5)
    assert isinstance(opt, mt.optimizer.SGLD) and opt.lr == 0.5
    for name in ("dcasgd", "test", "adam", "nag"):
        assert type(mt.optimizer.create(name)).__name__.lower() == name
    with pytest.raises(mt.MXNetError):
        mt.optimizer.create("nope")
    with pytest.raises(NotImplementedError):
        mt.optimizer.Optimizer().update(0, None, None, None)
    assert mt.optimizer.Optimizer().create_state(0, None) is None
    nag = mt.optimizer.NAG(momentum=0.9)
    w = mt.nd.array(np.ones(3), ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="state"):
        nag.update(0, w, w, None)
    assert isinstance(mt.optimizer.Optimizer.loads(opt.dumps()),
                      mt.optimizer.SGLD)
