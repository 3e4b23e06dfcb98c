"""Module.fit's fused path in mxnet_tpu_torch (``module._FusedFit``), on the
CPU: twins of tests/python/unittest/test_fused_fit.py and of the AMP fit
tests of tests/python/unittest/test_amp.py, with the port's own checks.

- The fused path gives the general path's parameters (the reference's
  rtol=5e-3, atol=1e-5), engages and converges, exports its optimizer
  state to the ``Updater``, stays off under each gate and the off switch,
  and installs copies, never aliases, when it syncs back: TrainStep updates
  its tensors in place, so an alias would change arrays a caller holds.
- ``rescale_grad``: ``init_optimizer``'s 1 / batch_size reaches the fused
  step and the ``Updater`` through one optimizer object.
- The cache key: MXNET_AMP unset or "0" trains bitwise the same and reuses
  the cached TrainStep; MXNET_AMP=1 builds a bfloat16 one; MXNET_NORM_CONV
  needs no key (the executor reads it at every run): toggled between two
  fits of one module, the second fit runs the NormConv Function with the
  same TrainStep.
- AMP: a bfloat16 fused fit converges with float32 masters; an explicit
  ``Policy("float32", loss_scale=8)`` is bitwise the plain float32 fit, the
  documented contract of a power-of-two scale.  The JAX package's own twin
  (test_amp.py::test_explicit_fit_policy_kwarg) fails in every run of its
  suite; the port is held to the contract, and test_torch_module.py holds
  its parameters to the JAX package's plain float32 fit, not to the failing
  reference.
- The device prefetch: on and off train bitwise the same, the producer
  engages, and an exception mid-epoch drains it.
"""
import logging
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor as pexec
from mxnet_tpu_torch import random as prandom
from mxnet_tpu_torch.amp import Policy
from test_torch_threads import torch_threads_per_worker  # noqa: F401


def _env(env):
    """Set ``env`` ({name: value or None}); returns the old values."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def _data(n=120, classes=4, separable=False, seed=0, image=12):
    np.random.seed(seed)
    if separable:
        y = np.random.randint(0, classes, n).astype(np.float32)
        x = (np.random.randn(n, 1, image, image) * 0.4
             + y[:, None, None, None]).astype(np.float32)
    else:
        x = np.random.randn(n, 1, image, image).astype(np.float32)
        y = np.random.randint(0, classes, n).astype(np.float32)
    return x, y


def _fit(env=None, optimizer="sgd", opt_params=None, epochs=3, n=120,
         classes=4, separable=False, batch=30, fixed=None, net=None,
         **fit_kw):
    """(Module, {name: numpy parameter}, (x, y)) of an MLP fit on the CPU
    (parity: the reference tests' ``_fit``)."""
    old = _env(env or {})
    try:
        x, y = _data(n, classes, separable)
        it = mt.io.NDArrayIter(x, y, batch_size=batch)
        mod = mt.Module(net or mt.models.get_mlp(num_classes=classes),
                        context=mt.cpu(), fixed_param_names=fixed)
        prandom.seed(7)
        mod.fit(it, num_epoch=epochs, optimizer=optimizer,
                optimizer_params=opt_params or {"learning_rate": 0.01,
                                                "momentum": 0.9},
                initializer=mt.initializer.Xavier(magnitude=2.0), **fit_kw)
        arg, _ = mod.get_params()
        return mod, {k: v.asnumpy() for k, v in arg.items()}, (x, y)
    finally:
        _env(old)


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.01, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_fused_fit_matches_general_path(optimizer, opt_params):
    m1, p1, _ = _fit({"MXNET_FUSED_FIT": "1"}, optimizer, opt_params)
    m0, p0, _ = _fit({"MXNET_FUSED_FIT": "0"}, optimizer, opt_params)
    assert m1._fused_ts_cache is not None and m0._fused_ts_cache is None
    for k in p1:
        np.testing.assert_allclose(p1[k], p0[k], rtol=5e-3, atol=1e-5,
                                   err_msg=k)


def test_fused_fit_engages_and_converges():
    x, y = _data(200, 2, separable=True, image=28)
    mod = mt.Module(mt.models.get_lenet(num_classes=2), context=mt.cpu())
    prandom.seed(7)
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=40, shuffle=True),
            num_epoch=8, optimizer_params={"learning_rate": 0.05},
            initializer=mt.initializer.Xavier(magnitude=2.0))
    assert mod._fused_ts_cache is not None
    score = mod.score(mt.io.NDArrayIter(x, y, batch_size=40),
                      mt.metric.Accuracy())
    assert score[0][1] > 0.9


def test_fused_fit_exports_optimizer_state(tmp_path):
    m, _, _ = _fit()
    states = {k: v for k, v in m._updater.states.items() if v is not None}
    assert len(states) == len(m._param_names)
    assert all(float(np.abs(v.asnumpy()).max()) > 0 for v in states.values())
    # the update count continues in the optimizer: 3 epochs of 4 batches
    assert set(m._optimizer._index_update_count.values()) == {12}
    path = str(tmp_path / "opt.states")
    m.save_optimizer_states(path)
    m.load_optimizer_states(path)
    for idx, v in states.items():
        np.testing.assert_array_equal(m._updater.states[idx].asnumpy(),
                                      v.asnumpy())


def test_rescale_grad_reaches_both_paths():
    """init_optimizer's rescale_grad (1 / batch_size) is the one optimizer
    object's, which the fused step and the Updater both read; an Optimizer
    passed in keeps its own, on both paths alike."""
    m, _, _ = _fit(epochs=1)
    assert m._optimizer.rescale_grad == 1.0 / 30
    assert m._fused_ts_cache[1].fopt.opt is m._optimizer
    assert m._updater.optimizer is m._optimizer
    got = []
    for fused in ("1", "0"):
        opt_ = mt.optimizer.SGD(learning_rate=0.01, momentum=0.9,
                                rescale_grad=0.5)
        _, p, _ = _fit({"MXNET_FUSED_FIT": fused}, optimizer=opt_, epochs=1)
        assert opt_.rescale_grad == 0.5
        got.append(p)
    for k in got[0]:
        np.testing.assert_allclose(got[0][k], got[1][k], rtol=5e-3,
                                   atol=1e-5, err_msg=k)


def test_fused_fit_gates(tmp_path, caplog):
    """Each gate sends fit to the general path and logs why."""
    m, _, _ = _fit(fixed=["fc1_weight"], epochs=1)
    assert m._fused_ts_cache is None

    class Quirky(mt.optimizer.SGD):
        def update(self, index, weight, grad, state):
            weight -= 0.01 * grad

    caplog.set_level(logging.INFO)
    m2, _, _ = _fit(optimizer=Quirky(), epochs=1)
    assert m2._fused_ts_cache is None
    assert "general (executor) path" in caplog.text

    x, y = _data()
    it = mt.io.NDArrayIter(x, y, batch_size=30)

    def bound(**kw):
        mod = mt.Module(mt.models.get_mlp(num_classes=4), context=mt.cpu())
        mod.bind(it.provide_data, it.provide_label, **kw)
        mod.init_params()
        mod.init_optimizer()
        return mod
    assert bound(grad_req="add")._start_fused_fit() is None
    assert bound(inputs_need_grad=True)._start_fused_fit() is None
    mod = bound()
    assert mod._start_fused_fit() is not None
    path = str(tmp_path / "s")
    mod.save_optimizer_states(path)
    mod.load_optimizer_states(path)
    assert mod._start_fused_fit() is None
    assert "explicitly loaded optimizer states" in caplog.text


def test_fused_fit_off_switch():
    m, _, _ = _fit({"MXNET_FUSED_FIT": "0"}, epochs=1)
    assert m._fused_ts_cache is None


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def test_fused_fit_no_aliases():
    """(twin: test_fused_fit_no_donated_aliases, and the port's own check)
    After sync_back no module array shares storage with the step's
    tensors; steps of a later fused run leave the arrays a caller took from
    get_params(), the executor's and the Updater's unchanged until their
    own sync_back; a second fit and a score run after it."""
    x, y = _data(90, 3)
    it = mt.io.NDArrayIter(x, y, batch_size=30)
    mod = mt.Module(mt.models.get_mlp(num_classes=3), context=mt.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
    held = dict(mod.get_params()[0])
    before = {k: v.asnumpy() for k, v in held.items()}
    ex = mod._exec_group.execs[0]
    ex_before = {k: ex.arg_dict[k].asnumpy() for k in held}
    st_before = {i: s.asnumpy() for i, s in mod._updater.states.items()}

    ff = mod._start_fused_fit()
    it.reset()
    for b in it:
        ff.step(b)
    step_tensors = list(ff._params.values()) + list(ff._aux.values()) + \
        [s for st in ff._state.values() for s in st]
    module_tensors = [v.value for v in held.values()] + \
        [ex.arg_dict[k].value for k in held] + \
        [s.value for s in mod._updater.states.values()]
    assert not _storages(step_tensors) & _storages(module_tensors)
    for k in held:
        np.testing.assert_array_equal(held[k].asnumpy(), before[k])
        np.testing.assert_array_equal(ex.arg_dict[k].asnumpy(), ex_before[k])
    for i, s in mod._updater.states.items():
        np.testing.assert_array_equal(s.asnumpy(), st_before[i])
    ff.sync_back()
    module_tensors = [v.value for v in mod.get_params()[0].values()] + \
        [ex.arg_dict[k].value for k in held] + \
        [s.value for s in mod._updater.states.values()]
    assert not _storages(step_tensors) & _storages(module_tensors)
    for k in held:
        np.testing.assert_array_equal(ex.arg_dict[k].asnumpy(),
                                      ff._params[k].numpy())

    it.reset()
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
    score = mod.score(mt.io.NDArrayIter(x, y, batch_size=30),
                      mt.metric.Accuracy())
    assert np.isfinite(score[0][1])
    for v in mod._updater.states.values():
        assert np.isfinite(v.asnumpy()).all()
    # 2 + 1 (the steps above) + 2 epochs of 3 batches
    assert max(mod._optimizer._index_update_count.values()) == 15


# ----------------------------------------------------------------- AMP
def test_policy_off_guard_bitwise_and_cached():
    """(twin) MXNET_AMP unset and "0" train bitwise the same with no
    policy, and a second identical fit reuses the cached TrainStep."""
    m1, p1, (x, y) = _fit()
    _, p2, _ = _fit({"MXNET_AMP": "0"})
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)
    assert m1._fused_ts_cache[1].policy is None
    ts_before = m1._fused_ts_cache[1]
    m1.fit(mt.io.NDArrayIter(x[:60], y[:60], batch_size=30), num_epoch=1,
           optimizer="sgd",
           optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
    assert m1._fused_ts_cache[1] is ts_before


def test_policy_toggle_takes_effect_after_prior_compile():
    """(twin) MXNET_AMP=1 between two fits builds a new bfloat16 step."""
    m, _, (x, y) = _fit()
    ts_f32, key_f32 = m._fused_ts_cache[1], m._fused_ts_cache[0]
    old = _env({"MXNET_AMP": "1"})
    try:
        m.fit(mt.io.NDArrayIter(x, y, batch_size=30), num_epoch=1,
              optimizer="sgd",
              optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
    finally:
        _env(old)
    assert m._fused_ts_cache[1] is not ts_f32
    assert m._fused_ts_cache[0] != key_f32
    assert m._fused_ts_cache[1].policy.compute_dtype == "bfloat16"


def test_amp_fused_fit_converges():
    """(twin) MXNET_AMP=1: bfloat16 compute, float32 masters, converges."""
    m, params, (x, y) = _fit({"MXNET_AMP": "1"}, epochs=8, n=200,
                             classes=2, opt_params={"learning_rate": 0.05,
                                                    "momentum": 0.9},
                             separable=True, batch=40)
    ts = m._fused_ts_cache[1]
    assert ts.policy is not None and ts.policy.compute_dtype == "bfloat16"
    for k, v in params.items():
        assert v.dtype == np.float32, k
    scale, _ = ts.amp_stats()
    assert scale > 0
    score = m.score(mt.io.NDArrayIter(x, y, batch_size=40),
                    mt.metric.Accuracy())
    assert score[0][1] > 0.9, score


def test_explicit_fit_policy_kwarg():
    """(twin) ``fit(policy=Policy("float32", loss_scale=8))`` uses that
    policy and trains bitwise as the plain float32 fit (scaling by a power
    of two is exact).  The JAX package's twin fails in every run of its
    own suite: the port is held to the documented contract, not to the
    failing reference."""
    pol = Policy("float32", loss_scale=8.0)
    m, p1, _ = _fit(policy=pol)
    assert m._fused_ts_cache[1].policy is pol
    _, p0, _ = _fit()
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


# ------------------------------------------------------ per-run levers
def test_norm_conv_toggle_between_fits_needs_no_new_step(monkeypatch):
    """MXNET_NORM_CONV is read by the executor at every run: toggled
    between two fits of one module (a ResNet-8), the first runs no NormConv
    Function, the second runs it, both on the same cached TrainStep."""
    calls = []
    real = pexec.NormConv

    class Counting(object):
        @staticmethod
        def apply(*args):
            calls.append(1)
            return real.apply(*args)
    monkeypatch.setattr(pexec, "NormConv", Counting)
    net = mt.models.resnet.get_symbol(4, 8, "3,16,16")
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (8, 3, 16, 16)).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    mod = mt.Module(net, context=mt.cpu())
    counts, steps = [], []
    for lever in ("0", "1"):
        monkeypatch.setenv("MXNET_NORM_CONV", lever)
        del calls[:]
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
                initializer=mt.initializer.Xavier(magnitude=2.0))
        counts.append(len(calls))
        steps.append(mod._fused_ts_cache[1])
    assert counts[0] == 0 and counts[1] > 0 and counts[1] % 2 == 0
    assert steps[0] is steps[1]


# ------------------------------------------------------------ prefetch
def test_prefetch_fit_bitwise_and_engaged(monkeypatch):
    """(twin: test_prefetch_fit_byte_identical_and_counted) prefetch on
    and off train bitwise the same; with it on every batch went through
    the producer's staging."""
    from mxnet_tpu_torch.module import module as pmod
    staged = []
    real = pmod._FusedFit._stage

    def spy(self, b):
        staged.append(1)
        return real(self, b)
    monkeypatch.setattr(pmod._FusedFit, "_stage", spy)
    _, p_on, _ = _fit(epochs=2)
    assert len(staged) == 8
    _, p_off, _ = _fit({"MXNET_DEVICE_PREFETCH": "0"}, epochs=2)
    assert len(staged) == 8
    for k in p_on:
        np.testing.assert_array_equal(p_on[k], p_off[k], err_msg=k)


def test_prefetch_drained_on_mid_epoch_exception(monkeypatch):
    """(twin) a callback's exception mid-epoch leaves no producer alive."""
    from mxnet_tpu_torch import io as pio
    created = []
    orig = pio.DevicePrefetchIter

    class Spy(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)
    monkeypatch.setattr(pio, "DevicePrefetchIter", Spy)

    def boom(param):
        raise RuntimeError("callback boom")

    with pytest.raises(RuntimeError, match="callback boom"):
        _fit(batch_end_callback=boom)
    assert created
    for c in created:
        assert not c._thread.is_alive()
        assert c._exhausted
