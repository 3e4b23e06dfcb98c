"""ZeRO under AMP, in ``Module.fit`` and in the sharded checkpoint, in
mxnet_tpu_torch against mxnet_tpu on the CPU: one world of two gloo ranks
(``bench/zero_ladder.py --network mlp``, one launch) beside the JAX
package's runs of the same state.

- AMP at level 3: a batch with an inf in rank 0's rows is skipped by both
  ranks (masters, optimizer rows and moving statistics bitwise unchanged),
  the scale halves and one overflow counts, as in the JAX package; the
  clean step after it lands within 1e-5 of the JAX package's.
- ``Module.fit`` under ``MXNET_ZERO=2`` from the same ``.params``: within
  1e-5 of the JAX package's ZeRO-2 fit over its virtual devices.
- The checkpoint of a level-2 step: each rank writes its row; the JAX
  package reads it, places it on its own dp=2 ZeRO-2 step and saves it
  again, and every shard file, ``stage0-zero<j>.params`` included, is
  byte-equal.  It restores both ways (the JAX package's rows equal the
  port's, the port's restore of a JAX checkpoint equals its rows) and onto
  dp=1 (no mesh, and a one-rank mesh at level 2).
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import checkpoint as pck
from mxnet_tpu_torch.bench import zero_ladder
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh
from mxnet_tpu_torch.parallel import placement as pplace

from test_torch_zero import finish, ladder_args, start
from test_torch_threads import torch_threads_per_worker  # noqa: F401

BATCH, STEPS, CLASSES = 8, 2, 7
TOL = 1e-5


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _jax_mesh_ts(mx, level, policy=None):
    import jax
    from mxnet_tpu.parallel.mesh import make_mesh
    from mxnet_tpu.train import TrainStep as JTrainStep
    mesh = make_mesh({"dp": 2}, devices=jax.devices()[:2])
    return JTrainStep(zero_ladder.mlp_net(mx, CLASSES),
                      mx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                       wd=1e-4, rescale_grad=1.0 / BATCH),
                      mesh=mesh, zero=level, policy=policy)


def _save_params(path, arg, aux=None):
    mt.nd.save(path, dict(
        [("arg:" + k, mt.nd.array(v, ctx=mt.cpu())) for k, v in arg.items()]
        + [("aux:" + k, mt.nd.array(v, ctx=mt.cpu()))
           for k, v in (aux or {}).items()]))


def _jax_amp(mx, params, data, label):
    """The JAX package's level-3 overflow skip and clean step (its test's
    policy): (skipped, scale state, logical params after the clean
    step)."""
    import jax
    pol = mx.amp.Policy("float32", loss_scale=16.0, growth_interval=50)
    ts = _jax_mesh_ts(mx, 3, policy=pol)
    p, s, a = ts.place_checkpoint(params, ts.fopt.init_state(params), {})
    bad = {"data": data[0].copy(), "softmax_label": label[0]}
    bad["data"].reshape(-1)[0] = np.inf
    before = {k: np.asarray(v).copy() for k, v in p.items()}
    p, s, a, _ = ts(p, s, a, ts.shard_batch(bad))
    skipped = all(np.array_equal(before[k], np.asarray(p[k]))
                  for k in before)
    scale = {k: float(v) for k, v in jax.device_get(
        ts._scale_state).items()}
    p, s, a, _ = ts(p, s, a, ts.shard_batch(
        {"data": data[0], "softmax_label": label[0]}))
    return skipped, scale, {n: ts.unflatten_host(n, np.asarray(v))
                            for n, v in p.items()}


def _jax_fit(mx, fparams, monkeypatch):
    """The JAX package's MXNET_ZERO=2 fit of the same network, data and
    initial parameters over its virtual devices."""
    x, y = zero_ladder.fit_data()
    it = mx.io.NDArrayIter(x, y, batch_size=zero_ladder.FIT_BATCH,
                           shuffle=False, label_name="softmax_label")
    mod = mx.Module(zero_ladder.fit_net(mx), context=mx.cpu())
    monkeypatch.setenv("MXNET_ZERO", "2")
    mod.fit(it, num_epoch=zero_ladder.FIT_EPOCHS, optimizer="sgd",
            optimizer_params={"learning_rate": zero_ladder.FIT_LR},
            arg_params={k: mx.nd.array(v) for k, v in fparams.items()},
            aux_params={}, eval_metric="acc")
    monkeypatch.delenv("MXNET_ZERO")
    assert mod._fused_ts_cache[1].zero == 2
    it.reset()
    acc = dict(mod.score(it, mx.metric.Accuracy()))["accuracy"]
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, acc


@pytest.fixture(scope="module")
def world(mx, tmp_path_factory):
    import jax
    from mxnet_tpu import checkpoint as jck
    mp = pytest.MonkeyPatch()
    out = tmp_path_factory.mktemp("zero_fit")
    net = zero_ladder.mlp_net(mx, CLASSES)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(BATCH, 10), softmax_label=(BATCH,))[0]))
    rs = np.random.RandomState(9)
    params = {n: rs.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in shapes.items() if n not in ("data",
                                                      "softmax_label")}
    data = rs.uniform(-1, 1, (STEPS, BATCH, 10)).astype(np.float32)
    label = rs.randint(0, CLASSES, (STEPS, BATCH)).astype(np.float32)
    fshapes = dict(zip(zero_ladder.fit_net(mt).list_arguments(),
                       zero_ladder.fit_net(mt).infer_shape(
                           data=(16, 16), softmax_label=(16,))[0]))
    fparams = {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
               for n, s in fshapes.items() if n not in ("data",
                                                        "softmax_label")}
    pfile, dfile, ffile = (str(out / n) for n in ("init.params",
                                                  "data.params",
                                                  "fit.params"))
    _save_params(pfile, params)
    _save_params(ffile, fparams)
    mt.nd.save(dfile, {"data": mt.nd.array(data, ctx=mt.cpu()),
                       "softmax_label": mt.nd.array(label, ctx=mt.cpu())})
    # a JAX level-2 checkpoint of a state with seeded momenta, for the port
    # to restore (placement only: no step is compiled)
    jts = _jax_mesh_ts(mx, 2)
    jstate = {n: (rs.uniform(-1, 1, v.shape).astype(np.float32),)
              for n, v in params.items()}
    jp, js, ja = jts.place_checkpoint(params, jstate, {})
    jpath = jck.Checkpointer(str(out / "jax" / "m"), async_=False).save(
        jts, jp, js, ja)
    proc = start(ladder_args(
        "--network", "mlp", "--classes", str(CLASSES), "--batch",
        str(BATCH), "--dtype", "float32", "--levels", "2", "--optimizers",
        "sgd", "--steps", str(STEPS), "--params", pfile, "--data", dfile,
        "--ckpt", "--amp", "float32", "--fit", "--fit-params", ffile,
        "--restore", jpath, "--save-arrays", "--out", str(out)))
    try:
        want = {"amp": _jax_amp(mx, params, data, label),
                "fit": _jax_fit(mx, fparams, mp),
                "jstate": jstate, "jpath": jpath}
    finally:
        mp.undo()
    rc, log = finish(proc)
    rows, arrays = [], []
    for r in range(2):
        path = os.path.join(str(out), "rank%d.json" % r)
        if os.path.exists(path):
            with open(path) as f:
                rows.append(json.load(f))
            raw = mt.nd.load(os.path.join(str(out), "rank%d.params" % r),
                             ctx=mt.cpu())
            arrays.append({k: v.asnumpy() for k, v in raw.items()})
    assert jax.devices()
    return rc, log, rows, arrays, want, out


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-4)
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def test_amp_overflow_skip_at_level3_matches_jax(world):
    rc, log, rows, arrays, want, _ = world
    assert rc == 0 and len(rows) == 2, log[-4000:]
    skipped, scale, after = want["amp"]
    assert skipped and scale["scale"] == 8.0 and scale["overflow"] == 1
    for r, arr in zip(rows, arrays):
        amp = r["amp"]
        assert amp["skipped"] and amp["every_rank_skipped"], amp
        assert (amp["scale"], amp["overflow"]) == (8.0, 1), amp
        assert amp["clean_step_moved"]
        for n, w in after.items():
            _close(arr["amp/arg:" + n], w, n)


def test_zero2_fit_matches_jax(world):
    rc, log, rows, arrays, want, _ = world
    assert rc == 0, log[-4000:]
    fparams, acc = want["fit"]
    for r, arr in zip(rows, arrays):
        assert r["fit"]["zero"] == 2 and r["fit"]["dp"] == 2
        assert r["fit"]["fc1_weight_shape"] == [32, 16]
        assert r["fit"]["accuracy"] == acc
        for n, w in fparams.items():
            _close(arr["fit/arg:" + n], w, n)


def _shards(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".params")}


def test_zero2_checkpoint_bytes_equal_jax_save(world, mx):
    """The port's two-rank save, read, placed and saved again by the JAX
    package at the same topology: every shard file byte-equal."""
    from mxnet_tpu import checkpoint as jck
    rc, log, rows, _, _, out = world
    assert rc == 0, log[-4000:]
    path = rows[0]["ckpt"]
    man = pck.verify_checkpoint(path)
    assert man["topology"]["zero"] == 2 and man["topology"]["dp"] == 2
    assert {f: m["rank"] for f, m in man["shards"].items()} == {
        "stage0.params": 0, "stage0-zero0.params": 0,
        "stage0-zero1.params": 1}
    jman, jp, js, ja = jck.load_sharded(path)
    jts = _jax_mesh_ts(mx, 2)
    p, s, a = jts.place_checkpoint(jp, js, ja)
    again = jck.Checkpointer(str(out / "again" / "m"), async_=False).save(
        jts, p, s, a, step=jman["step"])
    assert _shards(again) == _shards(path)


def test_zero2_checkpoint_restores_both_ways(world, mx):
    """The JAX package's restore of the port's checkpoint holds the port's
    rows; the port's restore of a JAX checkpoint holds the JAX rows."""
    import jax
    from mxnet_tpu import checkpoint as jck
    rc, log, rows, arrays, want, _ = world
    assert rc == 0, log[-4000:]
    jts = _jax_mesh_ts(mx, 2)
    _, js, _, man = jck.restore_into(jts, rows[0]["ckpt"])
    assert jts.num_update == STEPS == man["step"]
    for j, arr in enumerate(arrays):
        for n, st in js.items():
            np.testing.assert_array_equal(
                arr["L2-sgd/row:%s:0" % n],
                np.asarray(jax.device_get(st[0]))[j])
    for j, (r, arr) in enumerate(zip(rows, arrays)):
        assert r["restore"] == {"step": 0, "zero": 2}
        for n, st in want["jstate"].items():
            np.testing.assert_array_equal(arr["restore/row:%s:0" % n],
                                          pplace.flat_np(st[0], 2)[j])


def test_zero2_checkpoint_restores_onto_dp1(world):
    """The dp=2 checkpoint onto one process: no mesh (logical state), and a
    one-rank mesh at level 2 (its row is the whole flat view)."""
    rc, log, rows, arrays, _, _ = world
    assert rc == 0, log[-4000:]
    path = rows[0]["ckpt"]
    _, lp, ls, _ = pck.load_sharded(path)
    net = zero_ladder.mlp_net(mt, CLASSES)
    ts = mt.TrainStep(net, zero_ladder.make_opt("sgd", BATCH), ctx=mt.cpu())
    p, s, _, _ = pck.restore_into(ts, path)
    for n in lp:
        np.testing.assert_array_equal(p[n].numpy(), lp[n].numpy())
        np.testing.assert_array_equal(s[n][0].numpy(), ls[n][0].numpy())
        np.testing.assert_array_equal(arrays[0]["L2-sgd/opt:%s:0" % n],
                                      ls[n][0].numpy())
    dist.ensure_group()
    try:
        ts1 = mt.TrainStep(net, zero_ladder.make_opt("sgd", BATCH),
                           mesh=pmesh.make_mesh({"dp": -1}), zero=2,
                           ctx=mt.cpu())
        _, s1, _, _ = pck.restore_into(ts1, path)
        for n in lp:
            np.testing.assert_array_equal(
                s1[n][0].numpy(), ls[n][0].numpy().reshape(-1))
    finally:
        dist.shutdown_process_group()
