"""The mesh and ZeRO part of the distributed slice in mxnet_tpu_torch against
mxnet_tpu, on the CPU.

- In process: the flat (dp, chunk) layout (``chunk_rows``, ``flat_shards``,
  ``from_flat``, ``flat_np``) equal to the JAX package's on odd and even
  sizes; ``PlacementPlan.per_device_bytes`` at levels 0-3 and dp 1/2/4 for
  the ResNet-50 of ``MULTICHIP_ZERO_r01.json`` equal to the JAX package's
  and to the record's ladder; ``normalize_zero``; the refusals that need no
  world (a ZeRO level without a mesh, the pipeline meshes, a sequence mesh
  that is none, ``MXNET_PP``), a ``tp`` spec without a mesh (not read) and
  the sequence mesh set and cleared; a mesh over a world of one.
- One world of two gloo ranks on the CPU (``bench/zero_ladder.py``, one
  launch): a 20-layer ResNet at 3x16x16 with 7 classes (an odd classifier,
  so the rows are padded) in float64, levels 0-3 with SGD-momentum and
  with Adam for 2 steps from the JAX package's initial state.  Every
  level's logical parameters and moving statistics are within 1e-9 of the
  JAX package's level 0 (SGD) and level 2 (Adam) on a dp=2 mesh of its
  virtual CPU devices (its BatchNorm statistics are the global batch's,
  and so are the port's), and so are the SGD levels under the NormConv
  peephole (``MXNET_NORM_CONV=1``), under ``remat`` and one process's step
  over the whole global batch, every backward driven from a thread of its
  own (as on the card); the optimizer rows equal the JAX rows j, the
  collectives are those of each level, the plan's bytes are the JAX step's,
  and the refusals that need two ranks raise (a batch that does not
  divide, ``MXNET_ZERO`` with such a batch), while a ``tp`` axis of size 2
  (replicated, and with a row-parallel ``fc1_weight``) steps as one process
  does and ``MXNET_ZERO`` with ``MXNET_PP`` trains through
  ``PipelineTrainStep``.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh
from mxnet_tpu_torch.parallel import placement as pplace
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
BATCH, STEPS, CLASSES, IMAGE, LAYERS = 8, 2, 7, 16, 20


def start(args):
    """Start a command in a session of its own with the repo importable, no
    MXTPU_* variables of ours and one thread a rank."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXTPU_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def finish(p, timeout=240):
    """Wait for a started command; on timeout kill its process group.
    Returns (rc, stdout + stderr)."""
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail("timed out after %d s: %s" % (timeout, out[-4000:]))
    return p.returncode, out


def ladder_args(*extra):
    return [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
            sys.executable, "-m", "mxnet_tpu_torch.bench.zero_ladder",
            "--ctx", "cpu"] + list(extra)


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


@pytest.fixture
def world1():
    """A one-rank process group in this process, torn down after."""
    dist.ensure_group()
    yield
    dist.shutdown_process_group()


# ----------------------------------------------------------- in process
@pytest.mark.parametrize("size,dp", [(7, 2), (8, 2), (1, 4), (13, 4),
                                     (12, 1), (5, 8)])
def test_flat_layout_matches_jax(mx, size, dp):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import placement as jplace
    x = np.arange(1, size + 1, dtype=np.float32).reshape(-1, 1)
    assert pplace.chunk_rows(size, dp) == jplace.chunk_rows(size, dp)
    want = np.asarray(jplace.flat_shards(jnp.asarray(x), dp))
    got = pplace.flat_shards(mt.nd.array(x, ctx=mt.cpu()).value, dp)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pplace.flat_np(x, dp),
                                  jplace.flat_np(x, dp))
    np.testing.assert_array_equal(
        pplace.from_flat(got, x.shape).numpy(),
        np.asarray(jplace.from_flat(jnp.asarray(want), x.shape)))
    # an already flat view round-trips unchanged
    assert pplace.flat_shards(got, dp).shape == got.shape


def _record_shapes():
    """The logical parameter shapes of the record's ResNet-50 (128
    classes, 3x64x64: __graft_entry__.py's dryrun) and its SGD-momentum
    state, as zero-stride float32 arrays (shape metadata only)."""
    net = mt.models.resnet.get_symbol(128, 50, "3,64,64")
    args, _, _ = net.infer_shape(data=(8, 3, 64, 64), softmax_label=(8,))
    return {n: tuple(s) for n, s in zip(net.list_arguments(), args)
            if n not in ("data", "softmax_label")}


def _meta(shape):
    return np.broadcast_to(np.zeros((), np.float32), shape)


def _ladder_inputs(shapes, level, dp):
    """(params, opt_state) in the JAX package's global layout: flat (dp,
    chunk) arrays where the level shards them."""
    def flat(s):
        return (dp, pplace.chunk_rows(int(np.prod(s)), dp))
    params = {n: _meta(flat(s) if level >= 3 else s)
              for n, s in shapes.items()}
    state = {n: (_meta(flat(s) if level >= 1 else s),)
             for n, s in shapes.items()}
    return params, state


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_per_device_bytes_match_jax_and_record(mx, level, dp):
    from mxnet_tpu.parallel import placement as jplace
    shapes = _record_shapes()
    params, state = _ladder_inputs(shapes, level, dp)
    plans = []
    for mod in (pplace, jplace):
        plan = mod.PlacementPlan(zero=level, dp=dp)
        plan.note_host({n: _meta(s) for n, s in shapes.items()})
        plans.append(plan.per_device_bytes(params, state))
    assert plans[0] == plans[1]
    with open(os.path.join(ROOT, "MULTICHIP_ZERO_r01.json")) as f:
        ladder = json.load(f)["ladder"]
    row = ladder[level]
    if row["dp"] == dp or level == 0:
        assert [round(plans[0][k] / 1e6, 3) for k in ("param", "grad",
                                                       "opt")] == \
            [row["zero_%s_bytes_mb" % k] for k in ("param", "grad", "opt")]


def test_normalize_zero_matches_jax(mx):
    from mxnet_tpu.parallel import placement as jplace
    for v in (False, True, 0, 1, 2, 3):
        assert pplace.normalize_zero(v) == jplace.normalize_zero(v)
    for bad in (4, -1, 7):
        for mod in (pplace, jplace):
            with pytest.raises((mt.MXNetError, mx.base.MXNetError)):
                mod.normalize_zero(bad)


def _mlp():
    return mt.models.get_mlp(num_classes=4)


def test_refusals_without_a_world():
    with pytest.raises(mt.MXNetError, match="needs a mesh with a 'dp'"):
        mt.TrainStep(_mlp(), mt.optimizer.SGD(), zero=2, ctx=mt.cpu())
    # a tp spec without a mesh is not read (the JAX package's rule): the
    # step is built with every parameter whole
    ts = mt.TrainStep(_mlp(), mt.optimizer.SGD(), ctx=mt.cpu(),
                      param_shardings={"fc1_weight": ("tp", None)})
    p, _, _ = ts.init({"data": (4, 32)}, {"softmax_label": (4,)})
    assert ts._tp is None and p["fc1_weight"].shape == (128, 32)
    with pytest.raises(mt.MXNetError, match="takes a parallel.mesh"):
        mt.EvalStep(_mlp(), mesh=object())
    # the pipeline meshes train (tests/test_torch_pipeline.py); what still
    # refuses: two stages over a world of one, and a mesh that is none
    try:
        with pytest.raises(mt.MXNetError, match="cannot infer mesh axis"):
            pmesh.make_pp_mesh(2)
    finally:
        dist.shutdown_process_group()
    with pytest.raises(mt.MXNetError, match="takes a parallel.mesh mesh"):
        pmesh.pp_submeshes(None)
    # the sequence mesh is set and cleared (ring attention:
    # tests/test_torch_ring_attention.py); a mesh that is none refuses
    with pytest.raises(mt.MXNetError, match="takes a parallel.mesh mesh"):
        pmesh.set_sequence_mesh(object())
    try:
        mesh = pmesh.make_mesh({"sp": -1})
        with pytest.raises(mt.MXNetError, match="has no 'tp' axis"):
            pmesh.set_sequence_mesh(mesh, axis="tp")
        pmesh.set_sequence_mesh(mesh)
        assert pmesh.sequence_mesh() == (mesh, "sp")
    finally:
        pmesh.set_sequence_mesh(None)
        dist.shutdown_process_group()
    assert pmesh.sequence_mesh() == (None, "sp")


def test_mesh_over_a_world_of_one(world1):
    """make_mesh at world 1: a one-rank dp mesh; a ZeRO-2 step over it is
    the plain step, bit for bit, with its rows the whole flat view."""
    mesh = pmesh.make_mesh({"dp": -1})
    assert pmesh.axis_names(mesh) == ("dp",)
    assert pmesh.axis_size(mesh, "dp") == 1
    assert pmesh.axis_size(mesh, "tp") == 1
    assert pmesh.mesh_cache_key(mesh) == (("dp",), (1,), (0,))
    assert pmesh.mesh_cache_key(pmesh.data_parallel_mesh()) == \
        pmesh.mesh_cache_key(mesh)
    assert pmesh.local_devices_for() == [torch.device("cpu")]
    assert pmesh.local_devices_for([mt.cpu()]) == [torch.device("cpu")]
    with pytest.raises(mt.MXNetError, match="one device a rank"):
        pmesh.data_parallel_mesh([mt.cpu(), mt.cpu()])
    with pytest.raises(mt.MXNetError, match="does not cover"):
        pmesh.make_mesh({"dp": 2})
    rs = np.random.RandomState(0)
    batch = {"data": rs.randn(6, 32), "softmax_label":
             rs.randint(0, 4, 6).astype(np.float64)}
    out = []
    for kw in ({}, {"mesh": mesh, "zero": 2}, {"mesh": mesh, "zero": 3}):
        ts = mt.TrainStep(_mlp(), mt.optimizer.SGD(
            learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 6),
            ctx=mt.cpu(), **kw)
        p, s, a = ts.init({"data": (6, 32)}, {"softmax_label": (6,)})
        p = {k: v.double() for k, v in p.items()}
        s = {k: tuple(x.double() for x in st) for k, st in s.items()}
        for _ in range(2):
            p, s, a, _ = ts(p, s, a, batch)
        out.append({k: v.numpy() for k, v in ts.gather_params(p).items()})
        if kw:
            assert ts.zero_bytes(p, s)["grad"] == sum(
                v.nbytes for v in out[0].values())
    for got in out[1:]:
        for k in out[0]:
            np.testing.assert_array_equal(got[k], out[0][k])


def test_zero_gauges_and_gather_span(world1, tmp_path):
    """While telemetry records, a ZeRO step sets the zero_param_bytes and
    zero_grad_bytes gauges to its plan's bytes, and gather_params is the
    zero.gather span; with telemetry off a step sets neither."""
    from mxnet_tpu_torch import telemetry as tel
    mesh = pmesh.make_mesh({"dp": -1})
    rs = np.random.RandomState(1)
    batch = {"data": rs.randn(4, 32).astype(np.float32),
             "softmax_label": rs.randint(0, 4, 4).astype(np.float32)}

    def step(level, classes=4):
        ts = mt.TrainStep(mt.models.get_mlp(num_classes=classes),
                          mt.optimizer.SGD(momentum=0.9), mesh=mesh,
                          zero=level, ctx=mt.cpu())
        p, s, a = ts.init({"data": (4, 32)}, {"softmax_label": (4,)})
        p, s, a, _ = ts(p, s, a, batch)
        return ts, p, s
    tel.start(str(tmp_path / "t.jsonl"))
    try:
        ts, p, s = step(3)
        zb = ts.zero_bytes(p, s)
        assert tel.gauges()["zero_param_bytes"] == zb["param"]
        assert tel.gauges()["zero_grad_bytes"] == zb["grad"]
        full = ts.gather_params(p)
        assert [full[n].shape for n in ts.param_names] == [
            tuple(ts.plan.shape_of(n)) for n in ts.param_names]
        assert any(e.get("name") == "zero.gather" for e in tel.events())
    finally:
        tel.stop()
    # another network: other bytes, which a telemetry-off step must not set
    before = dict(tel.gauges())
    ts, p, s = step(2, classes=7)
    assert ts.zero_bytes(p, s)["grad"] != before["zero_grad_bytes"]
    assert tel.gauges().get("zero_grad_bytes") == \
        before["zero_grad_bytes"]


# ------------------------------------------------- one world of two ranks
def _jax_state(mx):
    """The JAX package's initial state of the ResNet (float32 from its
    initializer) and two seeded float64 batches of 8."""
    import jax
    from mxnet_tpu.train import TrainStep as JTrainStep
    from mxnet_tpu.models import resnet as jresnet
    net = jresnet.get_symbol(CLASSES, LAYERS, "3,%d,%d" % (IMAGE, IMAGE))
    ts = JTrainStep(net, mx.optimizer.SGD())
    p, _, a = ts.init({"data": (BATCH, 3, IMAGE, IMAGE)},
                      {"softmax_label": (BATCH,)}, seed=3)
    params = {k: np.asarray(jax.device_get(v)) for k, v in p.items()}
    aux = {k: np.asarray(jax.device_get(v)) for k, v in a.items()}
    rs = np.random.RandomState(5)
    data = rs.uniform(-1, 1, (STEPS, BATCH, 3, IMAGE, IMAGE))
    label = rs.randint(0, CLASSES, (STEPS, BATCH)).astype(np.float64)
    return net, params, aux, data, label


def _jax_opt(mx, name):
    if name == "sgd":
        return mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                                rescale_grad=1.0 / BATCH)
    return mx.optimizer.Adam(learning_rate=1e-3, rescale_grad=1.0 / BATCH)


def _jax_run(mx, net, params, aux, data, label, level, opt_name):
    """JAX ``TrainStep`` over a dp=2 mesh of its virtual CPU devices,
    float64, 2 steps: logical params, aux and optimizer state (global
    arrays), and its zero_bytes."""
    import jax
    from mxnet_tpu.parallel.mesh import make_mesh
    from mxnet_tpu.train import TrainStep as JTrainStep
    mesh = make_mesh({"dp": 2}, devices=jax.devices()[:2])
    ts = JTrainStep(net, _jax_opt(mx, opt_name), mesh=mesh, zero=level)
    host = {n: v.astype(np.float64) for n, v in params.items()}
    state = ts.fopt.init_state(host)
    p, s, a = ts.place_checkpoint(host, state, {n: v.astype(np.float64)
                                                for n, v in aux.items()})
    for i in range(STEPS):
        b = ts.shard_batch({"data": data[i], "softmax_label": label[i]})
        p, s, a, _ = ts(p, s, a, b, rng=jax.random.PRNGKey(7))
    zb = ts.zero_bytes(p, s) if level else None
    get = jax.device_get
    lp = {n: (ts.unflatten_host(n, np.asarray(get(v))) if level >= 3
              else np.asarray(get(v))) for n, v in p.items()}
    return (lp, {n: np.asarray(get(v)) for n, v in a.items()},
            {n: tuple(np.asarray(get(x)) for x in st)
             for n, st in s.items()}, zb)


@pytest.fixture(scope="module")
def ladder(mx, tmp_path_factory):
    import jax
    out = tmp_path_factory.mktemp("zero_ladder")
    net, params, aux, data, label = _jax_state(mx)
    pfile, dfile = str(out / "init.params"), str(out / "data.params")
    mt.nd.save(pfile, dict(
        [("arg:" + k, mt.nd.array(v, ctx=mt.cpu())) for k, v in
         params.items()] + [("aux:" + k, mt.nd.array(v, ctx=mt.cpu()))
                            for k, v in aux.items()]))
    mt.nd.save(dfile, {"data": mt.nd.array(data, ctx=mt.cpu(),
                                           dtype="float64"),
                       "softmax_label": mt.nd.array(label, ctx=mt.cpu(),
                                                    dtype="float64")})
    # the two packages run at once: the world in the background
    proc = start(ladder_args("--params", pfile, "--data", dfile, "--dtype",
                            "float64", "--steps", str(STEPS), "--batch",
                            str(BATCH), "--classes", str(CLASSES), "--image",
                            str(IMAGE), "--num-layers", str(LAYERS),
                            "--save-arrays", "--refusals", "--eval",
                            "--norm-conv-levels", "0,1,2,3",
                            "--remat-levels", "0,3", "--single",
                            "--backward-thread", "--out", str(out)))
    jax.config.update("jax_enable_x64", True)
    try:
        want = {"sgd": _jax_run(mx, net, params, aux, data, label, 0,
                                "sgd"),
                "adam": _jax_run(mx, net, params, aux, data, label, 2,
                                 "adam")}
    finally:
        jax.config.update("jax_enable_x64", False)
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
    return rc, log, rows, arrays, want


def _level(row, level, opt):
    return [r for r in row["levels"]
            if r["level"] == level and r["optimizer"] == opt][0]


def test_ladder_world_runs(ladder):
    rc, log, rows, _, _ = ladder
    assert rc == 0 and len(rows) == 2, log[-4000:]
    for r in rows:
        assert r["ok"] and r["world"] == 2 and r["route"] == "gloo"
        assert len(r["levels"]) == 8
        assert all(lv["replicated_bitwise_equal"] for lv in r["levels"])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_levels_match_jax_mesh(ladder, opt, level):
    """Each level's logical parameters and moving statistics on each rank
    against the JAX package's level 0 (SGD) or level 2 (Adam) over its dp=2
    mesh, 1e-9 of the largest entry."""
    rc, log, _, arrays, want = ladder
    assert rc == 0, log[-4000:]
    for arr in arrays:
        _assert_matches(arr, "L%d-%s/" % (level, opt), want[opt])


def _assert_matches(arr, tag, want):
    """A run's logical parameters and moving statistics within 1e-9 of the
    largest entry of the JAX package's."""
    wp, wa, _, _ = want
    for kind, ref in (("arg:", wp), ("aux:", wa)):
        for n, w in ref.items():
            got = arr[tag + kind + n]
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(got - w).max()) <= TOL * scale, \
                (tag + kind + n)


@pytest.mark.parametrize("variant,level", [
    ("nc", 0), ("nc", 1), ("nc", 2), ("nc", 3), ("remat", 0),
    ("remat", 3), ("single", 0)])
def test_variants_match_jax_mesh(ladder, variant, level):
    """SGD levels through the NormConv peephole (its statistics epilogue's
    sums taken across the ranks, their cotangents summed back), under
    ``remat`` with the backward, and so the recompute, on a thread other
    than the step's, and one process's step over the whole global batch:
    each rank's logical parameters and moving statistics against the JAX
    package's level 0 on its dp=2 mesh, 1e-9 of the largest entry."""
    rc, log, rows, arrays, want = ladder
    assert rc == 0, log[-4000:]
    for r, arr in zip(rows, arrays):
        rep = [v for v in r["variants"]
               if v["variant"] == variant and v["level"] == level][0]
        plain = _level(r, level, "sgd")
        # the peephole ran (NormConv's plain version on the CPU), and only
        # where it was asked for
        assert (rep["norm_conv_calls_per_step"] > 0) == (variant == "nc")
        if variant == "remat":
            # the recompute takes the global batch's statistics again
            assert rep["collectives_per_step"]["stats"] > \
                plain["collectives_per_step"]["stats"], rep
        elif variant == "nc":
            assert rep["collectives_per_step"] == \
                plain["collectives_per_step"], rep
        else:
            assert rep["collectives_per_step"] == {}, rep
        _assert_matches(arr, "%s-L%d-sgd/" % (variant, level), want["sgd"])


@pytest.mark.parametrize("level", [1, 2, 3])
def test_optimizer_rows_match_jax_rows(ladder, level):
    """Rank j's Adam rows (both moments) are row j of the JAX package's
    flat (dp, chunk) state at level 2."""
    rc, log, _, arrays, want = ladder
    assert rc == 0, log[-4000:]
    jstate = want["adam"][2]
    tag = "L%d-adam/row:" % level
    for j, arr in enumerate(arrays):
        for n, st in jstate.items():
            assert len(st) == 2
            for i, leaf in enumerate(st):
                assert leaf.shape[0] == 2
                got = arr[tag + "%s:%d" % (n, i)]
                assert got.shape == leaf[j].shape, n
                scale = max(float(np.abs(leaf).max()), 1e-3)
                assert float(np.abs(got - leaf[j]).max()) <= TOL * scale, n


def test_collectives_and_bytes_by_level(ladder):
    """A step's collectives: levels 0-1 all-reduce the gradients (one
    bucket), levels 2-3 reduce-scatter one (dp, chunk) bucket, levels 1-3
    all-gather once; BatchNorm sums twice a layer (forward and backward),
    but for the input BatchNorm, whose input takes no gradient.
    The plan's bytes are the JAX step's."""
    rc, log, rows, _, want = ladder
    assert rc == 0, log[-4000:]
    kinds = {0: {"all_reduce"}, 1: {"all_reduce", "all_gather"},
             2: {"reduce_scatter", "all_gather"},
             3: {"reduce_scatter", "all_gather"}}
    nbn = sum(1 for n in want["sgd"][1] if n.endswith("moving_mean"))
    for r in rows:
        for lv in r["levels"]:
            calls = dict(lv["collectives_per_step"])
            assert calls.pop("stats") == 2 * nbn - 1
            assert set(calls) == kinds[lv["level"]], lv
            assert all(v == 1 for v in calls.values()), lv
        assert _level(r, 2, "adam")["plan_bytes"] == want["adam"][3]
        zb = [_level(r, lv, "sgd")["plan_bytes"] for lv in range(4)]
        assert zb[1]["opt"] < zb[0]["opt"] and zb[2]["grad"] < zb[1]["grad"]
        assert zb[3]["param"] < zb[2]["param"]


def test_eval_step_over_the_mesh(ladder):
    """EvalStep(mesh=): each rank's rows forward, the outputs gathered on
    every rank, equal to the whole batch's forward without a mesh; and the
    loss heads' global normalizations."""
    rc, log, rows, _, _ = ladder
    assert rc == 0, log[-4000:]
    for r in rows:
        ev = r["eval"]
        assert ev["shapes"] == [[BATCH, CLASSES]]
        assert ev["equal_across_ranks"] and ev["max_abs"] <= TOL, ev
        # SoftmaxOutput's "batch" and "valid" normalizations count the
        # global batch on the mesh, as the step without one does
        assert set(ev["loss_norm_max_abs"]) == {"batch", "valid"}
        assert max(ev["loss_norm_max_abs"].values()) <= TOL, ev


def test_refusals_in_a_world(ladder):
    rc, log, rows, _, _ = ladder
    assert rc == 0, log[-4000:]
    for r in rows:
        assert r["refusals"] == {
            "tp_axis": "stepped", "tp_spec": "stepped",
            "dp_spec_accepted": True,
            "batch_not_divisible": True, "fit_MXNET_ZERO": True,
            "fit_MXNET_PP": "stepped"}
