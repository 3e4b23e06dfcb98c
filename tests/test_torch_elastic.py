"""Elastic resume of mxnet_tpu_torch (``parallel.elastic``, the fused fit's
checkpoint hooks, ``callback.do_step_checkpoint``) against mxnet_tpu, on
the CPU: an FC-BatchNorm-FC net, 4 batches of 8 an epoch, 2 epochs of
SGD with momentum through ``fit_elastic`` with
``MXNET_CKPT_EVERY_N_STEPS=2``.

- Uninterrupted: the epoch checkpoints (``.params`` and ``.states``) and
  the step checkpoints of steps 2, 4, 6 and 8, each at its data position.
- Stopped after step 3 (a batch callback raises) and resumed by a fresh
  ``Module`` from the step-2 checkpoint: the fused state restored (the
  update count, the momenta, the moving statistics), batch 2 of epoch 0
  next, and the final parameters and aux states bitwise equal to the
  uninterrupted run's; both within 1e-5 of their largest entry of the
  JAX package's ``fit_elastic`` over the same scenario.  The same under a
  bfloat16 ``Policy``: the loss-scale state restored.
- A resume from a per-epoch ``.params`` (with its ``.states``: the
  general path, as in the JAX package) within 1e-5 of the uninterrupted
  run.
- ``_ckpt_resume`` as a path; ``is_recovery`` under
  ``MXTPU_RESTART_COUNT``; ``latest_checkpoint`` skipping a truncated
  file; ``resume_or_start``; ``MXNET_ELASTIC_PLAN`` refused, naming the
  live-resize part; the live-resize hooks refused.
"""
import glob
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import checkpoint as pck
from mxnet_tpu_torch.parallel import elastic
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
SCALE_MIN = 1e-4
BATCH, BATCHES, EPOCHS = 8, 4, 2
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


@pytest.fixture(autouse=True)
def _every_2(monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_EVERY_N_STEPS", "2")
    for k in ("MXNET_ELASTIC_PLAN", "MXTPU_RESTART_COUNT", "MXNET_AMP",
              "MXNET_FUSED_FIT", "MXTPU_NUM_PROCESSES", "MXTPU_PROCESS_ID",
              "MXTPU_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)


def _net(S):
    h = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=16)
    h = S.BatchNorm(h, name="bn1", fix_gamma=False)
    h = S.Activation(h, act_type="relu")
    h = S.FullyConnected(h, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(h, name="softmax")


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(BATCH * BATCHES, 10).astype(np.float32),
            rs.randint(0, 4, BATCH * BATCHES).astype(np.float32))


def _init():
    net = _net(mt.sym)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(BATCH, 10), softmax_label=(BATCH,))[0]))
    rs = np.random.RandomState(1)
    args = {n: rs.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}
    aux = {"bn1_moving_mean": np.zeros(16, np.float32),
           "bn1_moving_var": np.ones(16, np.float32)}
    return args, aux


class Crash(RuntimeError):
    pass


def _fit(pkg, prefix, crash_after=None, policy=None, epochs=EPOCHS,
         module=None):
    """fit_elastic of a fresh module (or ``module``) from the fixed initial
    state; a batch callback raises after global step ``crash_after``.
    Returns (module, {name: numpy} of parameters and aux states)."""
    x, y = _data()
    args, aux = _init()
    if pkg is mt:
        el = elastic
    else:
        from mxnet_tpu.parallel import elastic as el
    mod = module or pkg.Module(_net(pkg.sym), context=pkg.cpu())
    seen = []

    def crash(param):
        seen.append((param.epoch, param.nbatch))
        if crash_after is not None and len(seen) == crash_after:
            raise Crash("stop after step %d" % crash_after)
    kw = {} if policy is None else {"policy": policy}
    try:
        el.fit_elastic(mod, pkg.io.NDArrayIter(x, y, batch_size=BATCH),
                       prefix, num_epoch=epochs, optimizer="sgd",
                       optimizer_params=OPT,
                       arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                   for k, v in args.items()},
                       aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                   for k, v in aux.items()},
                       batch_end_callback=crash, **kw)
    except Crash:
        return mod, None, seen
    a, x_ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in list(a.items())
                 + list(x_.items())}, seen


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), SCALE_MIN)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted port run (the reference of the resume tests)."""
    d = tmp_path_factory.mktemp("straight")
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_CKPT_EVERY_N_STEPS", "2")
    try:
        mod, final, seen = _fit(mt, str(d / "m"))
    finally:
        mp.undo()
    return str(d / "m"), final, seen, mod


def test_uninterrupted_writes_both_cadences(straight):
    prefix, final, seen, mod = straight
    assert len(seen) == EPOCHS * BATCHES
    assert mod._fused_ts_cache is not None
    for e in (1, 2):
        assert os.path.exists("%s-%04d.params" % (prefix, e))
        assert os.path.exists("%s-%04d.states" % (prefix, e))
    dirs = sorted(glob.glob(prefix + "-step*.ckpt"))
    assert [os.path.basename(d) for d in dirs] == \
        ["m-step%08d.ckpt" % s for s in (2, 4, 6, 8)]
    mans = [pck.verify_checkpoint(d) for d in dirs]
    assert [(m["epoch"], m["nbatch"]) for m in mans] == \
        [(0, 1), (0, 3), (1, 1), (1, 3)]
    assert pck.latest_sharded(prefix) == dirs[-1]
    assert elastic.latest_checkpoint(prefix) == 2


def test_stop_and_resume_bitwise(straight, tmp_path, monkeypatch):
    _, want, _, _ = straight
    prefix = str(tmp_path / "m")
    _, none, seen = _fit(mt, prefix, crash_after=3)
    assert none is None and seen == [(0, 0), (0, 1), (0, 2)]
    assert pck.latest_sharded(prefix).endswith("-step00000002.ckpt")
    saved = pck.load_sharded(pck.latest_sharded(prefix))
    restored = {}
    real = mt.module.module._FusedFit._resume

    def spy(self, resume):
        real(self, resume)
        restored.update(step=self._ts.num_update,
                        params={n: v.clone() for n, v in
                                self._params.items()},
                        state={n: tuple(s.clone() for s in st)
                               for n, st in self._state.items()},
                        aux={n: v.clone() for n, v in self._aux.items()})
    monkeypatch.setattr(mt.module.module._FusedFit, "_resume", spy)
    mod, got, seen = _fit(mt, prefix)
    # the restored state is the saved one, bitwise
    man, sp, ss, sa = saved
    assert restored["step"] == man["step"] == 2
    for n in sp:
        assert torch.equal(restored["params"][n], sp[n])
        assert all(torch.equal(x, y) for x, y in
                   zip(restored["state"][n], ss[n]))
    for n in sa:
        assert torch.equal(restored["aux"][n], sa[n])
    # batches 2 and 3 of epoch 0 (the loop's index restarts at 0), then
    # epoch 1
    assert seen == [(0, 0), (0, 1)] + [(1, i) for i in range(BATCHES)]
    assert mod._optimizer.num_update == EPOCHS * BATCHES
    assert getattr(mod, "_ckpt_resume", None) is None
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # the resumed run's step checkpoints carry the true positions
    man = pck.load_manifest(pck.latest_sharded(prefix))
    assert (man["epoch"], man["nbatch"], man["step"]) == (1, 3, 8)


def test_resume_matches_jax_fit_elastic(straight, mx, tmp_path):
    _, want, _, _ = straight
    prefix = str(tmp_path / "j")
    _fit(mx, prefix, crash_after=3)
    _, jgot, _ = _fit(mx, prefix)
    assert sorted(jgot) == sorted(want)
    for k in jgot:
        _close(want[k], jgot[k], k)


def test_resume_restores_the_loss_scale(tmp_path, monkeypatch):
    """Under a bfloat16 policy: the scale state saved at step 2 is the
    restored step's, and the resumed fit ends bitwise as the
    uninterrupted one."""
    pol = mt.amp.Policy("bfloat16", loss_scale=2.0 ** 10)
    _, want, _ = _fit(mt, str(tmp_path / "a"), policy=pol)
    prefix = str(tmp_path / "b")
    _fit(mt, prefix, crash_after=3, policy=pol)
    man = pck.load_manifest(pck.latest_sharded(prefix))
    assert man["extra"]["loss_scale"]["scale"] == 2.0 ** 10
    assert man["extra"]["loss_scale"]["good"] == 2
    scales = []
    real = mt.module.module._FusedFit._resume

    def spy(self, resume):
        real(self, resume)
        scales.append(self._ts.scale_state_host())
    monkeypatch.setattr(mt.module.module._FusedFit, "_resume", spy)
    _, got, _ = _fit(mt, prefix, policy=pol)
    assert scales == [man["extra"]["loss_scale"]]
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_resume_from_epoch_params(straight, tmp_path, caplog):
    """One epoch, then a rerun to two: it resumes at epoch 1 from
    ``m-0001.params`` and ``.states`` (loaded optimizer states: the
    general path), within 1e-5 of the uninterrupted run."""
    import logging
    _, want, _, _ = straight
    prefix = str(tmp_path / "m")
    os.environ.pop("MXNET_CKPT_EVERY_N_STEPS")
    _fit(mt, prefix, epochs=1)
    assert elastic.latest_checkpoint(prefix) == 1
    with caplog.at_level(logging.INFO):
        mod, got, seen = _fit(mt, prefix)
    assert seen == [(1, i) for i in range(BATCHES)]
    assert "explicitly loaded optimizer states" in caplog.text
    for k in want:
        _close(got[k], want[k], k)


def test_resume_hook_path_form(straight, tmp_path):
    """``module._ckpt_resume`` set to a checkpoint directory: the fused
    fit restores it (update count, state) before its first step."""
    prefix, _, _, _ = straight
    path = sorted(glob.glob(prefix + "-step*.ckpt"))[0]
    mod = mt.Module(_net(mt.sym), context=mt.cpu())
    x, y = _data()
    it = mt.io.NDArrayIter(x, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    args, aux = _init()
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in args.items()},
                    aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer_params=OPT)
    mod._ckpt_resume = path
    ff = mod._start_fused_fit()
    assert ff.num_update() == 2 and mod._ckpt_resume is None
    man, p, s, a = pck.load_sharded(path)
    for n in p:
        assert torch.equal(ff._params[n], p[n])
    assert mod._optimizer._index_update_count[0] == 2
    ck = pck.Checkpointer(str(tmp_path / "c"), async_=False)
    saved = ff.save_checkpoint(ck, epoch=3, nbatch=1)
    assert saved.endswith("-step00000002.ckpt")
    assert pck.load_manifest(saved)["epoch"] == 3
    for hook, args in (("export_state", ()),
                       ("apply_resize", (None, None, None, None))):
        with pytest.raises(mt.MXNetError, match="live-resize part"):
            getattr(ff, hook)(*args)


def test_step_checkpoint_needs_the_fused_fit(tmp_path, caplog):
    """On the general path the callback warns once and saves nothing."""
    import logging
    mod = mt.Module(_net(mt.sym), context=mt.cpu())
    ck = pck.Checkpointer(str(tmp_path / "c"), async_=False)
    cb = mt.callback.do_step_checkpoint(mod, ck, 1)
    with caplog.at_level(logging.WARNING):
        cb(mt.model.BatchEndParam(0, 0, None, {}))
        cb(mt.model.BatchEndParam(0, 1, None, {}))
    assert caplog.text.count("fused fit path is not active") == 1
    assert not os.path.exists(str(tmp_path / "c-step00000000.ckpt"))


def test_recovery_and_listing(tmp_path, monkeypatch):
    assert not elastic.is_recovery()
    monkeypatch.setenv("MXTPU_RESTART_COUNT", "2")
    assert elastic.is_recovery()
    prefix = str(tmp_path / "m")
    assert elastic.latest_checkpoint(prefix) is None
    net = _net(mt.sym)
    args, aux = _init()
    mt.model.save_checkpoint(prefix, 3, net,
                             {k: mt.nd.array(v, ctx=mt.cpu())
                              for k, v in args.items()},
                             {k: mt.nd.array(v, ctx=mt.cpu())
                              for k, v in aux.items()})
    blob = open("%s-0003.params" % prefix, "rb").read()
    open("%s-0004.params" % prefix, "wb").write(blob[:-5])
    assert elastic.latest_checkpoint(prefix) == 3
    mod = mt.Module(net, context=mt.cpu())
    mod.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
    mod.init_params()
    assert elastic.resume_or_start(mod, prefix) == 3
    got = mod.get_params()[0]
    for k, v in args.items():
        assert np.array_equal(got[k].asnumpy(), v)
    assert elastic.num_dead_node() == 0 and elastic.health_check(1.0)


def test_live_resize_plan_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_ELASTIC_PLAN", str(tmp_path / "plan.json"))
    mod = mt.Module(_net(mt.sym), context=mt.cpu())
    x, y = _data()
    with pytest.raises(mt.MXNetError, match="live-resize part"):
        elastic.fit_elastic(mod, mt.io.NDArrayIter(x, y, batch_size=BATCH),
                            str(tmp_path / "m"), num_epoch=1)
