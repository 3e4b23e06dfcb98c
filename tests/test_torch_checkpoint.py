"""Sharded checkpoints of mxnet_tpu_torch against mxnet_tpu, on the CPU
(the port's ``checkpoint.py``, ``TrainStep``'s checkpoint hooks,
``ndarray.load_arrays`` / ``validate_file``).

- Byte compatibility: the same host state (an FC-BatchNorm-FC net, SGD
  with momentum, random values) saved by both packages gives byte-equal
  shard files and an equal ``manifest.json`` (the port synchronous and
  asynchronous); under a bfloat16 ``Policy`` the loss-scale state rides
  ``extra`` alike.
- Cross restores, float64 (the JAX package in x64 mode): a JAX
  ``TrainStep`` checkpoint restored by the port and run 2 more steps
  agrees with the JAX package's own 2 steps within 1e-9 of each tensor's
  largest entry, and the other way round.  Under the bfloat16 policy, from
  a state with an overflow and a good step behind it: the scale state is
  restored exactly and moves alike over 2 steps, and each parameter is
  within BF16_X times the distance between the JAX package's bfloat16 and
  float32 steps from the restored state.
- Any topology: checkpoints the JAX package writes on its virtual mesh
  (pp 2; ZeRO-2 and ZeRO-3 over dp 2) load in the port to the JAX
  package's ``load_sharded`` logical tensors, and restore into the port's
  single-device step.
- Crash consistency, as tests/python/unittest/test_checkpoint.py checks
  it: the manifest is written last; ``latest_sharded`` skips a directory
  without a manifest or with a short shard and orders by position; a
  corrupt or missing shard is named; a version mismatch names both; a
  writer failure is raised at the next save and leaves the previous
  checkpoint intact; no thread before the first asynchronous save.
- ``export_monolithic`` loads in both packages; ``load_arrays`` and
  ``validate_file`` agree with the JAX package's on whole, truncated and
  foreign files; ``export_host`` equals a save and load.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import checkpoint as pck
from test_torch_threads import torch_threads_per_worker  # noqa: F401

BATCH = 8
F64_TOL = 1e-9
# a bfloat16 step of the port against the JAX package's, per parameter,
# within this factor of the JAX package's bfloat16-to-float32 distance
# (tests/test_torch_amp.py's rule)
BF16_X = 4.0
BF16_MIN = 1e-3


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


@pytest.fixture
def jx64(mx):
    import jax
    jax.config.update("jax_enable_x64", True)
    yield mx
    jax.config.update("jax_enable_x64", False)


def _net(S, classes=8):
    h = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=16)
    h = S.BatchNorm(h, name="bn1", fix_gamma=False)
    h = S.Activation(h, act_type="relu")
    h = S.FullyConnected(h, name="fc2", num_hidden=16)
    h = S.Activation(h, act_type="tanh")
    h = S.FullyConnected(h, name="fc3", num_hidden=classes)
    return S.SoftmaxOutput(h, name="softmax")


def _mlp(S, classes=8):
    """The net of the JAX package's checkpoint tests (no aux state)."""
    h = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=16)
    h = S.Activation(h, act_type="relu")
    h = S.FullyConnected(h, name="fc2", num_hidden=16)
    h = S.Activation(h, act_type="tanh")
    h = S.FullyConnected(h, name="fc3", num_hidden=classes)
    return S.SoftmaxOutput(h, name="softmax")


def _batch(seed=0, dtype=np.float32, inf=False):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (BATCH, 32)).astype(dtype)
    if inf:
        x[0, 0] = np.inf
    return {"data": x,
            "softmax_label": rs.randint(0, 8, (BATCH,)).astype(dtype)}


def _opt(pkg):
    return pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                             rescale_grad=1.0 / BATCH)


def _state(seed=0, dtype=np.float32):
    """Random parameters, momenta and aux states of ``_net``."""
    net = _net(mt.sym)
    args, _, auxs = net.infer_shape(data=(BATCH, 32),
                                    softmax_label=(BATCH,))
    rs = np.random.RandomState(seed)
    names = [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")]
    shapes = dict(zip(net.list_arguments(), args))
    p = {n: rs.uniform(-0.5, 0.5, shapes[n]).astype(dtype) for n in names}
    s = {n: (rs.uniform(-0.01, 0.01, shapes[n]).astype(dtype),)
         for n in names}
    a = {n: rs.uniform(0.5, 1.5, sh).astype(dtype)
         for n, sh in zip(net.list_auxiliary_states(), auxs)}
    return p, s, a


def _jax_trees(p, s, a):
    import jax.numpy as jnp
    return ({n: jnp.asarray(v) for n, v in p.items()},
            {n: tuple(jnp.asarray(x) for x in st) for n, st in s.items()},
            {n: jnp.asarray(v) for n, v in a.items()})


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def _rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol * scale, \
        (what, err, scale)


# ------------------------------------------------------- byte compatibility
@pytest.mark.parametrize("async_", [False, True])
def test_same_state_same_bytes(mx, tmp_path, async_):
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.train import TrainStep as JTrainStep
    p, s, a = _state()
    jts = JTrainStep(_net(mx.sym), _opt(mx))
    jts.num_update = 5
    jdir = jck.Checkpointer(str(tmp_path / "j" / "m"), async_=False).save(
        jts, *_jax_trees(p, s, a), epoch=1, nbatch=3, extra={"note": "x"})
    pts = mt.TrainStep(_net(mt.sym), _opt(mt), ctx=mt.cpu())
    pts.num_update = 5
    pp, ps, pa = mt.convert.train_state_from_numpy(p, s, a, ctx=mt.cpu())
    ck = pck.Checkpointer(str(tmp_path / "p" / "m"), async_=async_)
    pdir = ck.save(pts, pp, ps, pa, epoch=1, nbatch=3, extra={"note": "x"})
    ck.close()
    assert os.path.basename(pdir) == os.path.basename(jdir) \
        == "m-step00000005.ckpt"
    jf, pf = _files(jdir), _files(pdir)
    assert sorted(pf) == ["manifest.json", "stage0-opt.params",
                          "stage0.params"]
    assert pf == jf


def test_same_state_same_bytes_amp(mx, tmp_path):
    """Under a bfloat16 policy the float32 masters and the scale state
    (after an overflow and a good step) save alike."""
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.train import TrainStep as JTrainStep
    p, s, a = _state(1)
    jts = JTrainStep(_net(mx.sym), _opt(mx),
                     policy=mx.amp.Policy("bfloat16"))
    jp, js, ja = _jax_trees(p, s, a)
    for inf in (True, False):
        jp, js, ja, _ = jts(jp, js, ja, jts.shard_batch(_batch(2, inf=inf)))
    host = {k: np.asarray(v) for k, v in jp.items()}, \
        {k: tuple(np.asarray(x) for x in v) for k, v in js.items()}, \
        {k: np.asarray(v) for k, v in ja.items()}
    jdir = jck.Checkpointer(str(tmp_path / "j" / "m"), async_=False).save(
        jts, jp, js, ja)
    pts = mt.TrainStep(_net(mt.sym), _opt(mt),
                       policy=mt.amp.Policy("bfloat16"), ctx=mt.cpu())
    pts.num_update = jts.num_update
    pts.load_scale_state(jts.scale_state_host())
    pdir = pck.Checkpointer(str(tmp_path / "p" / "m"), async_=False).save(
        pts, *mt.convert.train_state_from_numpy(*host, ctx=mt.cpu()))
    man = json.loads(_files(pdir)["manifest.json"])
    assert man["extra"]["loss_scale"] == {"scale": 2.0 ** 14, "good": 1,
                                          "overflow": 1}
    assert _files(pdir) == _files(jdir)


# ------------------------------------------------------------ cross restore
def _port_steps(pts, p, s, a, n, seed=4, dtype=np.float64):
    b = pts.shard_batch(_batch(seed, dtype))
    for _ in range(n):
        p, s, a, _ = pts(p, s, a, b)
    return p, s, a


def _jax_steps(jts, p, s, a, n, seed=4, dtype=np.float64):
    b = jts.shard_batch(_batch(seed, dtype))
    for _ in range(n):
        p, s, a, _ = jts(p, s, a, b)
    return p, s, a


def test_jax_checkpoint_restores_in_port(jx64, tmp_path):
    mx = jx64
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.train import TrainStep as JTrainStep
    p, s, a = _state(2, np.float64)
    jts = JTrainStep(_net(mx.sym), _opt(mx))
    jp, js, ja = _jax_steps(jts, *_jax_trees(p, s, a), 2, seed=3)
    path = jck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        jts, jp, js, ja)
    jp, js, ja = _jax_steps(jts, jp, js, ja, 2)
    pts = mt.TrainStep(_net(mt.sym), _opt(mt), ctx=mt.cpu())
    pp, ps, pa, man = pck.restore_into(pts, path)
    assert pts.num_update == man["step"] == 2
    assert pp["fc1_weight"].dtype == torch.float64
    pp, ps, pa = _port_steps(pts, pp, ps, pa, 2)
    assert pts.num_update == jts.num_update == 4
    for n in jp:
        _rel(pp[n], jp[n], F64_TOL, n)
        _rel(ps[n][0], js[n][0], F64_TOL, "mom " + n)
    for n in ja:
        _rel(pa[n], ja[n], F64_TOL, n)


def test_port_checkpoint_restores_in_jax(jx64, tmp_path):
    mx = jx64
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.train import TrainStep as JTrainStep
    p, s, a = _state(3, np.float64)
    pts = mt.TrainStep(_net(mt.sym), _opt(mt), ctx=mt.cpu())
    pp, ps, pa = _port_steps(pts, *mt.convert.train_state_from_numpy(
        p, s, a, ctx=mt.cpu()), 2, seed=3)
    path = pck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        pts, pp, ps, pa)
    pp, ps, pa = _port_steps(pts, pp, ps, pa, 2)
    jts = JTrainStep(_net(mx.sym), _opt(mx))
    jp, js, ja, man = jck.restore_into(jts, path)
    assert jts.num_update == 2
    jp, js, ja = _jax_steps(jts, jp, js, ja, 2)
    for n in jp:
        _rel(pp[n], jp[n], F64_TOL, n)
        _rel(ps[n][0], js[n][0], F64_TOL, "mom " + n)
    for n in ja:
        _rel(pa[n], ja[n], F64_TOL, n)


def _dist(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_amp_cross_restore(mx, tmp_path, direction):
    """bfloat16 policy: the scale state restored exactly and moving alike;
    each parameter after 2 steps within BF16_X times the JAX package's
    bfloat16-to-float32 distance (or BF16_MIN x max |w|)."""
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.train import TrainStep as JTrainStep
    p, s, a = _state(4)
    policy = lambda pkg: pkg.amp.Policy("bfloat16")  # noqa: E731
    jts = JTrainStep(_net(mx.sym), _opt(mx), policy=policy(mx))
    pts = mt.TrainStep(_net(mt.sym), _opt(mt), policy=policy(mt),
                       ctx=mt.cpu())
    if direction == "jax_to_port":
        jp, js, ja = _jax_trees(p, s, a)
        for inf in (True, False):
            jp, js, ja, _ = jts(jp, js, ja,
                                jts.shard_batch(_batch(5, inf=inf)))
        path = jck.Checkpointer(str(tmp_path / "m"), async_=False).save(
            jts, jp, js, ja)
    else:
        pp, ps, pa = mt.convert.train_state_from_numpy(p, s, a,
                                                       ctx=mt.cpu())
        for inf in (True, False):
            pp, ps, pa, _ = pts(pp, ps, pa, _batch(5, inf=inf))
        path = pck.Checkpointer(str(tmp_path / "m"), async_=False).save(
            pts, pp, ps, pa)
    jts = JTrainStep(_net(mx.sym), _opt(mx), policy=policy(mx))
    pts = mt.TrainStep(_net(mt.sym), _opt(mt), policy=policy(mt),
                       ctx=mt.cpu())
    jp, js, ja, man = jck.restore_into(jts, path)
    pp, ps, pa, _ = pck.restore_into(pts, path)
    want_scale = {"scale": 2.0 ** 14, "good": 1, "overflow": 1}
    assert man["extra"]["loss_scale"] == want_scale
    assert jts.scale_state_host() == pts.scale_state_host() == want_scale
    jf = JTrainStep(_net(mx.sym), _opt(mx))
    fp, fs, fa, _ = jck.restore_into(jf, path)
    jp, js, ja = _jax_steps(jts, jp, js, ja, 2, dtype=np.float32)
    pp, ps, pa = _port_steps(pts, pp, ps, pa, 2, dtype=np.float32)
    fp, fs, fa = _jax_steps(jf, fp, fs, fa, 2, dtype=np.float32)
    assert jts.scale_state_host() == pts.scale_state_host() == \
        {"scale": 2.0 ** 14, "good": 3, "overflow": 1}
    for n in jp:
        w = np.asarray(jp[n])
        floor = max(_dist(jp[n], fp[n]),
                    BF16_MIN * float(np.abs(w).max()))
        assert _dist(pp[n].numpy(), w) <= BF16_X * floor, n


# ------------------------------------------------------------- any topology
def _jax_mesh_ts(mx, kind):
    import jax
    from mxnet_tpu.parallel.mesh import make_mesh, make_pp_mesh
    from mxnet_tpu.train import PipelineTrainStep, TrainStep as JTrainStep
    if kind == "pp2":
        mesh = make_pp_mesh(2, dp=1, devices=jax.devices()[:2])
        return PipelineTrainStep(_mlp(mx.sym), _opt(mx), mesh=mesh,
                                 num_microbatches=2)
    level = int(kind[-1])
    mesh = make_mesh({"dp": 2}, devices=jax.devices()[:2])
    return JTrainStep(_mlp(mx.sym), _opt(mx), mesh=mesh, zero=level)


@pytest.mark.parametrize("kind", ["pp2", "zero2", "zero3"])
def test_jax_mesh_checkpoints_load_in_port(mx, tmp_path, kind):
    from mxnet_tpu import checkpoint as jck
    jts = _jax_mesh_ts(mx, kind)
    p, s, a = jts.init({"data": (BATCH, 32)}, {"softmax_label": (BATCH,)},
                       seed=3)
    p, s, a = _jax_steps(jts, p, s, a, 2, dtype=np.float32)
    path = jck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        jts, p, s, a)
    jman, jp, js, ja = jck.load_sharded(path)
    man, pp, ps, pa = pck.load_sharded(path)
    assert man == jman
    if kind == "pp2":
        assert man["topology"]["pp"] == 2
        assert {"stage0.params", "stage1.params"} <= set(man["shards"])
    else:
        assert man["topology"]["zero"] == int(kind[-1])
        assert {"stage0-zero0.params", "stage0-zero1.params"} <= \
            set(man["shards"])
    assert sorted(pp) == sorted(jp) and sorted(ps) == sorted(js)
    for n in jp:
        np.testing.assert_array_equal(pp[n].numpy(), np.asarray(jp[n]))
        assert len(ps[n]) == len(js[n])
        for x, y in zip(ps[n], js[n]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    pts = mt.TrainStep(_mlp(mt.sym), _opt(mt), ctx=mt.cpu())
    rp, rs_, _, _ = pck.restore_into(pts, path)
    assert pts.num_update == 2 and list(rp) == pts.param_names
    for n in jp:
        np.testing.assert_array_equal(rp[n].numpy(), np.asarray(jp[n]))


# ------------------------------------------------------- crash consistency
def _plain(seed=3):
    ts = mt.TrainStep(_mlp(mt.sym), _opt(mt), ctx=mt.cpu())
    p, s, a = ts.init({"data": (BATCH, 32)}, {"softmax_label": (BATCH,)},
                      seed=seed)
    return ts, p, s, a


def test_manifest_written_last(tmp_path, monkeypatch):
    ts, p, s, a = _plain()
    order = []
    real = pck.atomic_write

    def spy(path, *args, **kw):
        order.append(os.path.basename(path))
        return real(path, *args, **kw)
    monkeypatch.setattr(pck, "atomic_write", spy)
    pck.Checkpointer(str(tmp_path / "m"), async_=False).save(ts, p, s, a)
    # the groups in sorted order, then the manifest
    assert order == ["stage0.params", "stage0-opt.params", "manifest.json"]


def test_latest_sharded_skips_incomplete(tmp_path):
    ts, p, s, a = _plain()
    prefix = str(tmp_path / "m")
    cp = pck.Checkpointer(prefix, async_=False)
    good = cp.save(ts, p, s, a, step=1)
    no_man = cp.save(ts, p, s, a, step=2, nbatch=1)
    os.remove(os.path.join(no_man, "manifest.json"))
    short = cp.save(ts, p, s, a, step=3, nbatch=2)
    with open(os.path.join(short, "stage0.params"), "r+b") as f:
        f.truncate(10)
    assert pck.latest_sharded(prefix) == good
    # newest by position (epoch, nbatch, step), not by the name's step
    later = cp.save(ts, p, s, a, step=0, epoch=1)
    assert pck.latest_sharded(prefix) == later


def test_corrupt_and_missing_shards_named(tmp_path):
    ts, p, s, a = _plain()
    path = pck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        ts, p, s, a)
    shard = os.path.join(path, "stage0.params")
    blob = bytearray(open(shard, "rb").read())
    blob[-1] ^= 0xFF
    open(shard, "wb").write(bytes(blob))
    with pytest.raises(mt.MXNetError, match="stage0.params.*corrupt"):
        pck.load_sharded(path)
    with pytest.raises(mt.MXNetError, match="corrupt"):
        pck.verify_checkpoint(path)
    os.remove(shard)
    with pytest.raises(mt.MXNetError, match="missing shard stage0.params"):
        pck.load_sharded(path)


def test_version_mismatch_names_both(tmp_path):
    ts, p, s, a = _plain()
    path = pck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        ts, p, s, a)
    mpath = os.path.join(path, "manifest.json")
    man = json.load(open(mpath))
    man["version"] = 7
    open(mpath, "w").write(json.dumps(man))
    with pytest.raises(mt.MXNetError, match="version 7.*version 1"):
        pck.load_manifest(path)


def test_writer_failure_raised_at_next_save(tmp_path, monkeypatch):
    ts, p, s, a = _plain()
    prefix = str(tmp_path / "m")
    before = threading.active_count()
    cp = pck.Checkpointer(prefix, async_=True)
    assert threading.active_count() == before and cp._thread is None
    good = cp.save(ts, p, s, a, step=1)
    cp.wait()
    assert cp.last_write_seconds is not None

    def full_disk(dirname, job):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(pck, "write_snapshot", full_disk)
    cp.save(ts, p, s, a, step=2)
    cp._queue.join()
    with pytest.raises(mt.MXNetError, match="No space left"):
        cp.save(ts, p, s, a, step=3)
    monkeypatch.undo()
    assert pck.latest_sharded(prefix) == good
    assert pck.verify_checkpoint(good)["step"] == 1
    cp.close()


def test_snapshot_is_a_copy(tmp_path):
    """The step updates its tensors in place after the save: the queued
    snapshot keeps the saved values."""
    ts, p, s, a = _plain()
    want = {n: v.clone() for n, v in p.items()}
    job = pck.snapshot(ts, p, s, a)
    for v in p.values():
        v.add_(1.0)
    man, got, _, _ = pck.reassemble(job)
    for n in want:
        assert torch.equal(got[n], want[n])


def test_export_host_equals_save_and_load(tmp_path):
    ts, p, s, a = _plain()
    ts(p, s, a, _batch(1))
    man, hp, hs, ha = ts.export_host(p, s, a)
    path = pck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        ts, p, s, a)
    man2, lp, ls, la = pck.load_sharded(path)
    assert man["step"] == man2["step"] == 1
    for n in p:
        assert torch.equal(hp[n], lp[n]) and torch.equal(hp[n], p[n])
        assert all(torch.equal(x, y) for x, y in zip(hs[n], ls[n]))


def test_restore_missing_param_named(tmp_path):
    ts, p, s, a = _plain()
    path = pck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        ts, p, s, a)
    other = mt.TrainStep(_net(mt.sym), _opt(mt), ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="bn1_beta"):
        pck.restore_into(other, path)


def test_export_monolithic_loads_in_both(mx, tmp_path):
    ts, p, s, a = _plain()
    path = pck.Checkpointer(str(tmp_path / "m"), async_=False).save(
        ts, p, s, a)
    # the symbol file beside it, then the exported parameters over the
    # empty ones
    mt.model.save_checkpoint(str(tmp_path / "mono"), 1, _mlp(mt.sym), {},
                             {})
    pck.export_monolithic(path, str(tmp_path / "mono-0001.params"))
    _, parg, _ = mt.model.load_checkpoint(str(tmp_path / "mono"), 1)
    _, jarg, _ = mx.model.load_checkpoint(str(tmp_path / "mono"), 1)
    for n, v in p.items():
        assert np.array_equal(parg[n].asnumpy(), v.numpy())
        assert np.array_equal(jarg[n].asnumpy(), v.numpy())


def test_load_arrays_and_validate_file(mx, tmp_path):
    f = str(tmp_path / "x.params")
    mt.nd.save(f, {"a": mt.nd.array(np.arange(6.0).reshape(2, 3),
                                    ctx=mt.cpu()),
                   "b": mt.nd.array(np.ones(4, np.int32), ctx=mt.cpu(),
                                    dtype="int32")})
    got, want = mt.nd.load_arrays(f), mx.nd.load_arrays(f)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got[k].device.type == "cpu"
    blob = open(f, "rb").read()
    cases = {"whole": blob, "truncated": blob[:-3], "head": blob[:20],
             "foreign": b"not a params file at all, just text"}
    for name, data in cases.items():
        path = str(tmp_path / (name + ".params"))
        open(path, "wb").write(data)
        assert mt.nd.validate_file(path) == mx.nd.validate_file(path) \
            == (name == "whole"), name
    assert mt.nd.validate_file(str(tmp_path / "none.params")) is False
