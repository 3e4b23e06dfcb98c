"""The pipeline part of the distributed slice in mxnet_tpu_torch against
mxnet_tpu, on the CPU.

- In process: ``parallel.schedule`` (``stage_orders``, ``dispatch_order``,
  ``simulate``, ``validate_schedule``) equal to the JAX package's over a
  grid of (schedule, pp, M, v), errors included;
  ``pipeline_bubble_fraction`` against every ``pp_bubble_fraction`` row of
  ``MULTICHIP_PP_r01.json`` and ``MULTICHIP_PP_r02.json``;
  ``stage_partition`` on the dryrun's ResNet-50 (128 classes, 64x64) at 2,
  4 and 8 stages equal to the JAX package's cut, its per-slice MB equal to
  the records' ``stage_param_mb`` rows; the cuts that refuse; the pipeline
  meshes over a world of one; a pp=1 step's telemetry (the ``pp.*`` spans
  and gauges).
- One world of two gloo ranks and one of four (``bench/pp_ladder.py``, one
  launch each), float64, a small BatchNorm conv net that the NormConv
  peephole fuses, 2 steps from the JAX package's initial state: every case
  (pp=2 M=1; pp=2 M=4 under gpipe, 1f1b and interleaved v=2; dp2 x pp2
  M=2 under gpipe and 1f1b; pp=4 M=4 under 1f1b), unfused and under
  ``MXNET_NORM_CONV=1``, within 1e-9 of the JAX package's gpipe
  ``PipelineTrainStep`` on its virtual CPU devices (pp=2 M=1 also of its
  one-program ``TrainStep``); ``last_live_bytes`` of the gpipe cases equal
  to the JAX step's, 1f1b's flat over M=2..8 while gpipe's grows; the
  pp=2 and dp2 x pp2 saves of the initial state byte-equal to the JAX
  package's; restores pp 2 -> 1 and 1 -> 2; ``Module.fit`` under
  ``MXNET_PP=2``; the 'batch' head fold and the 'valid' refusal; the
  refusals that stay (``tp``, no ``pp`` axis, ``TrainStep`` on a ``pp``
  mesh, ``dtype=`` with ``policy=``, ZeRO without a ``dp`` axis) and the
  lifted ones built and stepped (ZeRO, AMP, the bfloat16 cast, ``MXNET_PP``
  with ``MXNET_ZERO`` / ``MXNET_AMP``; their parity is
  ``test_torch_pipeline_zero_amp.py``'s).

The JAX package's interleaved dp=2 cases and its 1f1b pp=4 dp=2 case fail
in the repo's tier-1 runs (ROADMAP "Reference caveats"), so the port's 1f1b
and interleaved schedules are held to its gpipe schedule, which computes
the same math.
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
from mxnet_tpu_torch.bench.pp_ladder import convnet
from mxnet_tpu_torch.executor import _Lowered
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh
from mxnet_tpu_torch.parallel import schedule as psched
from mxnet_tpu_torch.train import PipelineTrainStep, pipeline_bubble_fraction
from test_torch_threads import child_env, torch_threads_per_worker  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
BATCH, STEPS, CLASSES, IMAGE = 8, 2, 4, 8
W2_CASES = "gpipe:2:1:1,gpipe:2:1:4,1f1b:2:1:4,interleaved:2:1:4:2"
W4_CASES = "gpipe:2:2:2,1f1b:2:2:2,1f1b:4:1:4"
# each port case -> the JAX package's gpipe run it is held to
JAX_OF = {"pp2-dp1-m1": (2, 1, 1), "pp2-dp1-m4": (2, 1, 4),
          "pp2-dp2-m2": (2, 2, 2), "pp4-dp1-m4": (4, 1, 4)}


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


# ------------------------------------------------------------- schedules
GRID = [(s, pp, m, v) for s in ("gpipe", "1f1b", "interleaved", "zigzag")
        for pp in (1, 2, 3, 4) for m in (1, 2, 4, 6, 8) for v in (1, 2, 3)]


def _outcome(mod, fn):
    try:
        return ("ok", fn(mod))
    except Exception as exc:   # both packages' MXNetError
        return ("error", str(exc))


@pytest.mark.parametrize("part", ["orders", "dispatch"])
def test_schedules_match_jax(mx, part):
    """Every (schedule, pp, M, v) of the grid gives the JAX package's
    orders, simulation, dispatch order and bubble, or its error."""
    from mxnet_tpu.parallel import schedule as jsched
    for sched, pp, m, v in GRID:
        def run(mod):
            name, iv = mod.validate_schedule(sched, pp, m, v)
            orders = mod.stage_orders(pp, m, name, iv)
            if part == "orders":
                sim = mod.simulate(orders, pp, iv)
                return orders, sim["span"], sim["bubble"], sorted(
                    sim["start"].items())
            return mod.dispatch_order(orders, pp, iv)[0]
        got, want = _outcome(psched, run), _outcome(jsched, run)
        assert got == want, (sched, pp, m, v)
        if got[0] == "ok" and part == "orders":
            assert abs(got[1][2] - pipeline_bubble_fraction(
                pp, m, v if sched == "interleaved" else 1)) < 1e-9


def test_bubble_fraction_matches_the_records(mx):
    from mxnet_tpu.train import pipeline_bubble_fraction as jbubble
    rows = 0
    for rec in ("MULTICHIP_PP_r01.json", "MULTICHIP_PP_r02.json"):
        with open(os.path.join(ROOT, rec)) as f:
            data = json.load(f)
        for r in data["ladder"]:
            v = r.get("interleave", 1)
            got = pipeline_bubble_fraction(r["pp"], r["microbatches"], v)
            assert got == jbubble(r["pp"], r["microbatches"], v)
            assert round(got, 4) == r["pp_bubble_fraction"]
            rows += 1
        cfg = data["pipeline"]["config"]
        assert round(pipeline_bubble_fraction(
            cfg["pp"], cfg["microbatches"], cfg.get("interleave", 1)),
            4) == data["pipeline"]["pp_bubble_fraction"]
    assert rows == 13


# ---------------------------------------------------------------- the cut
def _record_net(pkg):
    if pkg == "port":
        return mt.models.resnet.get_symbol(128, 50, "3,64,64")
    from mxnet_tpu.models import resnet
    return resnet.get_symbol(num_classes=128, num_layers=50,
                             image_shape="3,64,64")


@pytest.fixture(scope="module")
def record_cut(mx):
    from mxnet_tpu.executor import _Lowered as JLowered
    net = _record_net("port")
    args, _, _ = net.infer_shape(data=(8, 3, 64, 64), softmax_label=(8,))
    sizes = {n: int(np.prod(s)) for n, s in zip(net.list_arguments(), args)
             if n not in ("data", "softmax_label")}
    return _Lowered(net), JLowered(_record_net("jax")), sizes


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_stage_partition_matches_jax(record_cut, stages):
    low, jlow, sizes = record_cut
    inputs = {"data", "softmax_label"}
    got = low.stage_partition(stages, inputs, sizes)
    want = jlow.stage_partition(stages, inputs, sizes)
    assert [s.describe() for s in got] == [s.describe() for s in want]
    assert [len(s.nodes) for s in got] == [len(s.nodes) for s in want]


def _slice_mb(stages, sizes, pp):
    mb = [0.0] * pp
    for st in stages:
        mb[st.index % pp] += sum(4 * sizes[n] for n in st.params) / 1e6
    return [round(x, 3) for x in mb]


def test_stage_param_mb_matches_the_records(record_cut):
    low, _, sizes = record_cut
    inputs = {"data", "softmax_label"}
    seen = set()
    for rec in ("MULTICHIP_PP_r01.json", "MULTICHIP_PP_r02.json"):
        with open(os.path.join(ROOT, rec)) as f:
            ladder = json.load(f)["ladder"]
        for r in ladder:
            v = r.get("interleave", 1)
            got = _slice_mb(low.stage_partition(r["pp"] * v, inputs, sizes),
                            sizes, r["pp"])
            assert np.allclose(got, r["stage_param_mb"], atol=1e-3), r
            assert abs(sum(got) - r["replicated_param_mb"]) <= 2e-3
            seen.add((r["pp"], v))
    assert seen == {(2, 1), (4, 1), (4, 2)}
    assert _slice_mb(low.stage_partition(2, inputs, sizes), sizes, 2) == \
        [58.285, 36.766]


def test_cuts_that_refuse():
    S = mt.sym
    inputs = {"data", "softmax_label"}
    # the peepholes glue every op of this graph: no legal cut
    bn = S.BatchNorm(S.Variable("data"), name="bn", fix_gamma=False)
    glued = S.Activation(bn, act_type="relu")
    with pytest.raises(mt.MXNetError, match="no legal cut"):
        _Lowered(glued).stage_partition(2, inputs)
    # a weight consumed on both sides of the cut
    w = S.Variable("shared_weight")
    h = S.FullyConnected(S.Variable("data"), w, num_hidden=4, no_bias=True,
                         name="fa")
    h = S.Activation(h, act_type="tanh")
    h = S.FullyConnected(h, w, num_hidden=4, no_bias=True, name="fb")
    shared = S.SoftmaxOutput(h, name="softmax")
    with pytest.raises(mt.MXNetError, match="cross-stage weight sharing"):
        _Lowered(shared).stage_partition(3, inputs)
    low = _Lowered(convnet(mt, CLASSES))
    ops = sum(1 for n in low.order if not n.is_var)
    with pytest.raises(mt.MXNetError, match="stages >"):
        low.stage_partition(ops + 1, inputs)
    with pytest.raises(mt.MXNetError, match=">= 1"):
        low.stage_partition(0, inputs)


def test_pipeline_meshes_over_a_world_of_one():
    dist.ensure_group()
    try:
        mesh = pmesh.make_pp_mesh(1)
        assert pmesh.axis_names(mesh) == ("dp", "pp")
        subs = pmesh.pp_submeshes(mesh)
        assert [s.ranks for s in subs] == [[0]]
        assert subs[0].shape == {"dp": 1}
        with pytest.raises(mt.MXNetError, match="has no 'pp' axis"):
            pmesh.pp_submeshes(pmesh.make_mesh({"dp": -1}))
        with pytest.raises(mt.MXNetError, match="needs a mesh with a 'pp'"):
            PipelineTrainStep(convnet(mt, CLASSES), mt.optimizer.SGD(),
                              mesh=pmesh.make_mesh({"dp": -1}),
                              ctx=mt.cpu())
        ts = PipelineTrainStep(convnet(mt, CLASSES), mt.optimizer.SGD(),
                               mesh=mesh, num_microbatches=2, ctx=mt.cpu())
        assert ts.schedule() == ("gpipe", 1) and ts.stages() is None
        with pytest.raises(mt.MXNetError, match="call init"):
            ts.checkpoint_topology()
    finally:
        dist.shutdown_process_group()


# ------------------------------------------------------- launched worlds
def _launch(n, out, *extra):
    env = {k: v for k, v in child_env().items()
           if not k.startswith("MXTPU_")}
    env.update(PYTHONPATH=ROOT)
    env.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
         sys.executable, "-m", "mxnet_tpu_torch.bench.pp_ladder", "--ctx",
         "cpu", "--out", out] + list(extra), cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _finish(p, timeout=300):
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail("timed out after %d s: %s" % (timeout, out[-4000:]))
    return p.returncode, out


def _jax_state(mx):
    """The JAX package's initial state of the conv net (float32 from its
    initializer) and two seeded float64 batches of 8."""
    import jax
    from mxnet_tpu.train import TrainStep as JTrainStep
    ts = JTrainStep(convnet(mx, CLASSES), mx.optimizer.SGD())
    p, _, a = ts.init({"data": (BATCH, 3, IMAGE, IMAGE)},
                      {"softmax_label": (BATCH,)}, seed=3)
    params = {k: np.asarray(jax.device_get(v)) for k, v in p.items()}
    aux = {k: np.asarray(jax.device_get(v)) for k, v in a.items()}
    rs = np.random.RandomState(5)
    data = rs.uniform(-1, 1, (STEPS, BATCH, 3, IMAGE, IMAGE))
    label = rs.randint(0, CLASSES, (STEPS, BATCH)).astype(np.float64)
    return params, aux, data, label


def _jax_opt(mx):
    return mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                            rescale_grad=1.0 / BATCH)


def _jax_runs(mx, params, aux, data, label, ckdir):
    """The JAX package's float64 references: its one-program TrainStep
    and its gpipe PipelineTrainStep at each (pp, dp, M) of JAX_OF, 2
    steps each: {key: (logical params, aux, last_live_bytes)}; the pp=2
    and dp2 x pp2 steps also save their initial state under ``ckdir``."""
    import jax
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.parallel.mesh import make_pp_mesh
    from mxnet_tpu.train import PipelineTrainStep as JPipe
    from mxnet_tpu.train import TrainStep as JTrainStep
    host = {n: v.astype(np.float64) for n, v in params.items()}
    haux = {n: v.astype(np.float64) for n, v in aux.items()}
    key = jax.random.PRNGKey(7)
    get = jax.device_get
    out = {}
    ts = JTrainStep(convnet(mx, CLASSES), _jax_opt(mx))
    p, s, a = ts.place_checkpoint(host, ts.fopt.init_state(host), haux)
    for i in range(STEPS):
        b = ts.shard_batch({"data": data[i], "softmax_label": label[i]})
        p, s, a, _ = ts(p, s, a, b, rng=key)
    out["single"] = ({n: np.asarray(get(v)) for n, v in p.items()},
                     {n: np.asarray(get(v)) for n, v in a.items()}, None)
    for tag, (pp, dp, m) in JAX_OF.items():
        mesh = make_pp_mesh(pp, dp=dp, devices=jax.devices()[:pp * dp])
        ts = JPipe(convnet(mx, CLASSES), _jax_opt(mx), mesh=mesh,
                   num_microbatches=m, schedule="gpipe")
        p = ts.place_params(host)
        s = ts.place_state(ts.fopt.init_state(host))
        a = ts.place_aux(haux)
        if m in (1, 2) and pp == 2:
            jck.Checkpointer(os.path.join(ckdir, tag, "m"),
                             async_=False).save(ts, p, s, a)
        for i in range(STEPS):
            p, s, a, _ = ts(p, s, a, {"data": data[i],
                                      "softmax_label": label[i]}, rng=key)
        out[tag] = ({n: np.asarray(get(v)) for n, v in p.items()},
                    {n: np.asarray(get(v)) for n, v in a.items()},
                    list(ts.last_live_bytes))
    return out


@pytest.fixture(scope="module")
def worlds(mx, tmp_path_factory):
    """Both launched worlds, run while the JAX package's references run in
    this process: (rc/log/rank reports/rank-0 arrays of each world, the
    JAX references, the JAX checkpoint directory)."""
    import jax
    tmp = tmp_path_factory.mktemp("pp_ladder")
    params, aux, data, label = _jax_state(mx)
    pfile, dfile = str(tmp / "init.params"), str(tmp / "data.params")
    mt.nd.save(pfile, dict(
        [("arg:" + k, mt.nd.array(v, ctx=mt.cpu())) for k, v in
         params.items()] + [("aux:" + k, mt.nd.array(v, ctx=mt.cpu()))
                            for k, v in aux.items()]))
    mt.nd.save(dfile, {"data": mt.nd.array(data, ctx=mt.cpu(),
                                           dtype="float64"),
                       "softmax_label": mt.nd.array(label, ctx=mt.cpu(),
                                                    dtype="float64")})
    common = ["--params", pfile, "--data", dfile, "--dtype", "float64",
              "--steps", str(STEPS), "--batch", str(BATCH), "--classes",
              str(CLASSES), "--image", str(IMAGE), "--norm-conv", "--ckpt",
              "--save-arrays"]
    outs = {2: str(tmp / "w2"), 4: str(tmp / "w4")}
    procs = {2: _launch(2, outs[2], "--cases", W2_CASES, "--single",
                        "--micro-ref", "4", "--live", "2,8", "--fit", "2",
                        "--semantics", "--refusals", *common),
             4: _launch(4, outs[4], "--cases", W4_CASES, *common)}
    ckdir = str(tmp / "jax_ck")
    jax.config.update("jax_enable_x64", True)
    try:
        want = _jax_runs(mx, params, aux, data, label, ckdir)
    finally:
        jax.config.update("jax_enable_x64", False)
    res = {}
    for n, proc in procs.items():
        rc, log = _finish(proc)
        rows = []
        for r in range(n):
            path = os.path.join(outs[n], "rank%d.json" % r)
            if os.path.exists(path):
                with open(path) as f:
                    rows.append(json.load(f))
        arrays = {}
        path = os.path.join(outs[n], "rank0.params")
        if os.path.exists(path):
            arrays = {k: v.asnumpy() for k, v in
                      mt.nd.load(path, ctx=mt.cpu()).items()}
        res[n] = (rc, log, rows, arrays, outs[n])
    return res, want, ckdir


def _world(worlds, n):
    res, want, ckdir = worlds
    rc, log, rows, arrays, out = res[n]
    assert rc == 0 and len(rows) == n, log[-4000:]
    return rows, arrays, out, want, ckdir


def _close(arrays, tag, want_p, want_a):
    """The case's logical parameters and moving statistics within 1e-9 of
    the largest entry of the JAX package's."""
    for kind, ref in (("arg:", want_p), ("aux:", want_a)):
        for n, w in ref.items():
            got = arrays[tag + "/" + kind + n]
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(got - w).max()) <= TOL * scale, \
                (tag, kind + n)


def _cases(world):
    return [c for c in (W2_CASES if world == 2 else W4_CASES).split(",")]


@pytest.mark.parametrize("nc_on", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_cases_match_jax_gpipe(worlds, world, nc_on):
    """Every case (unfused and under MXNET_NORM_CONV=1) against the JAX
    package's gpipe step of the same pp, dp and M."""
    rows, arrays, _, want, _ = _world(worlds, world)
    for spec in _cases(world):
        sched, pp, dp, m = spec.split(":")[:4]
        v = 2 if sched == "interleaved" else 1
        tag = "%s%s-pp%s-dp%s-m%s-v%d" % ("nc-" if nc_on else "", sched, pp,
                                          dp, m, v)
        jp, ja, _ = want["pp%s-dp%s-m%s" % (pp, dp, m)]
        _close(arrays, tag, jp, ja)
        row = [r for r in rows[0]["cases"] if r["tag"] == tag][0]
        # the peephole ran (its plain version on the CPU), only when asked
        assert (sum(r["norm_conv_calls_per_step"] for rr in rows
                    for r in rr["cases"] if r["tag"] == tag) > 0) == nc_on
        assert row["outputs_finite"]
        assert row["output_shapes"] == [[BATCH, CLASSES]]


def test_pp2_m1_matches_the_one_program_step(worlds):
    rows, arrays, _, want, _ = _world(worlds, 2)
    jp, ja, _ = want["single"]
    for tag in ("gpipe-pp2-dp1-m1-v1", "nc-gpipe-pp2-dp1-m1-v1", "single"):
        _close(arrays, tag, jp, ja)


def test_bn_microbatches_equal_pp1_with_the_same_m(worlds):
    """At M > 1 the stages' BatchNorm statistics are each microbatch's:
    every pp=2 M=4 schedule equals one process's pp=1 M=4 step."""
    rows, arrays, _, _, _ = _world(worlds, 2)
    ref = {k[len("micro4/"):]: v for k, v in arrays.items()
           if k.startswith("micro4/")}
    for sched in ("gpipe", "1f1b", "interleaved"):
        v = 2 if sched == "interleaved" else 1
        tag = "%s-pp2-dp1-m4-v%d/" % (sched, v)
        for k, w in ref.items():
            assert float(np.abs(arrays[tag + k] - w).max()) <= TOL, k
        row = [r for r in rows[0]["cases"] if r["tag"] == tag[:-1]][0]
        assert row["reference"] == "micro4"
        assert row["worst_over_floor"][0] < 1e-3


def test_schedules_and_p2p_counts(worlds):
    """Each rank runs its slice's stages; a step's P2P transfers are one a
    carry tensor and microbatch at each cut, each way; the final stage
    hands the outputs to the other slices."""
    for world in (2, 4):
        rows, _, _, _, _ = _world(worlds, world)
        for r in rows:
            for row in r["cases"]:
                pp, dp, m, v = (row["pp"], row["dp"], row["microbatches"],
                                row["interleave"])
                s = r["rank"] % pp
                assert row["my_stages"] == list(range(s, pp * v, pp))
                calls = row["collectives_per_step"]
                cuts = sum(1 for k in range(pp * v - 1)
                           if k % pp == s or (k + 1) % pp == s)
                assert calls["send"]["calls"] + calls["recv"]["calls"] == \
                    2 * m * cuts, row["tag"]
                if s == pp - 1:
                    assert calls["send_outputs"]["calls"] == pp - 1
                else:
                    assert calls["recv_outputs"]["calls"] == 1
                assert row["pp_bubble_fraction"] == round(
                    pipeline_bubble_fraction(pp, m, v), 4)
                assert ("stats" in calls) == (dp > 1)


def test_live_bytes_match_jax_and_1f1b_stays_flat(worlds):
    rows, _, _, want, _ = _world(worlds, 2)
    for world, tag, key in ((2, "gpipe-pp2-dp1-m1-v1", "pp2-dp1-m1"),
                            (2, "gpipe-pp2-dp1-m4-v1", "pp2-dp1-m4"),
                            (4, "gpipe-pp2-dp2-m2-v1", "pp2-dp2-m2")):
        wr = _world(worlds, world)[0]
        for r in wr:
            row = [c for c in r["cases"] if c["tag"] == tag][0]
            assert row["last_live_bytes"] == want[key][2], tag
    lad = {(r["schedule"], r["microbatches"]): r["pp_live_bytes_max_mb"]
           for r in rows[0]["live_bytes_ladder"]}
    assert lad[("1f1b", 8)] <= lad[("1f1b", 2)]
    assert lad[("gpipe", 8)] > lad[("gpipe", 2)]
    assert lad[("1f1b", 8)] < lad[("gpipe", 8)]


@pytest.mark.parametrize("world,tag,key", [
    (2, "gpipe-pp2-dp1-m1-v1", "pp2-dp1-m1"),
    (4, "gpipe-pp2-dp2-m2-v1", "pp2-dp2-m2")])
def test_checkpoints_byte_equal_to_jax(worlds, world, tag, key):
    """The initial state saved under pp=2 (and dp2 x pp2): every shard
    byte-equal to the JAX package's save of the same state, and the
    manifests equal but for the world and the writing ranks."""
    _, _, out, _, ckdir = _world(worlds, world)
    got = os.path.join(out, "ck0-" + tag, "m-step00000000.ckpt")
    wanted = os.path.join(ckdir, key, "m-step00000000.ckpt")
    names = sorted(os.listdir(wanted))
    assert names == sorted(os.listdir(got))
    assert {"stage0.params", "stage1.params", "stage0-opt.params",
            "stage1-opt.params", "manifest.json"} <= set(names)
    for name in names:
        a = open(os.path.join(got, name), "rb").read()
        b = open(os.path.join(wanted, name), "rb").read()
        if name != "manifest.json":
            assert a == b, name
            continue
        ma, mb = json.loads(a), json.loads(b)
        assert ma["topology"].pop("world") == world
        mb["topology"].pop("world")
        for m_ in (ma, mb):
            for meta in m_["shards"].values():
                meta.pop("rank")
        assert ma == mb


def test_restores_and_the_fit(worlds):
    rows, arrays, _, _, _ = _world(worlds, 2)
    for r in rows:
        ck = r["ckpt"]
        assert ck["pp_bitwise"] and ck["one_process_bitwise"] \
            and ck["one_to_pp_bitwise"], ck
        assert ck["topology"]["pp"] == 2 and ck["step"] == STEPS
        fit = r["fit"]
        assert fit["pipeline"] == "PipelineTrainStep" and fit["pp"] == 2
        assert fit["host_backed"] and fit["batches"] == STEPS
        assert fit["max_abs"] == 0.0 and fit["aux_max_abs"] == 0.0, fit
    for k, v in arrays.items():
        if k.startswith("fit/"):
            np.testing.assert_array_equal(v, arrays["fitref/" + k[4:]])


def test_semantics_and_refusals(worlds):
    rows, _, _, _, _ = _world(worlds, 2)
    for r in rows:
        assert r["semantics"]["valid_refused"]
        assert r["semantics"]["batch_head_max_abs"] <= TOL
        assert r["refusals"] == {
            "tp_axis": True, "no_pp_axis": True, "trainstep_pp_axis": True,
            "dtype_with_policy": True, "zero_without_dp_axis": True,
            "zero": "stepped", "policy": "stepped", "dtype": "stepped",
            "fit_MXNET_PP+MXNET_ZERO": "stepped",
            "fit_MXNET_PP+MXNET_AMP": "stepped"}


def test_telemetry_spans_and_gauges(tmp_path):
    """While telemetry records, a step emits the slice's ``pp.stage`` span,
    ``pp.bubble`` and the ``pp_bubble_fraction`` /
    ``pp_stage<N>_live_bytes`` gauges (the JAX package's names); a pp=1
    step over a world of one, M=2."""
    from mxnet_tpu_torch import telemetry as tel
    dist.ensure_group()
    try:
        ts = PipelineTrainStep(convnet(mt, CLASSES), mt.optimizer.SGD(
            learning_rate=0.1, momentum=0.9), mesh=pmesh.make_pp_mesh(1),
            num_microbatches=2, ctx=mt.cpu())
        p, s, a = ts.init({"data": (BATCH, 3, IMAGE, IMAGE)},
                          {"softmax_label": (BATCH,)})
        rs = np.random.RandomState(0)
        batch = {"data": rs.uniform(-1, 1, (BATCH, 3, IMAGE, IMAGE))
                 .astype(np.float32),
                 "softmax_label": rs.randint(0, CLASSES, BATCH)
                 .astype(np.float32)}
        tel.start(str(tmp_path / "t.jsonl"))
        try:
            _, _, _, outs = ts(p, s, a, batch)
            names = {e.get("name") for e in tel.events()}
            assert {"pp.stage", "pp.bubble"} <= names
            gauges = tel.gauges()
            assert gauges["pp_bubble_fraction"] == \
                pipeline_bubble_fraction(1, 2) == 0.0
            assert gauges["pp_stage0_live_bytes"] == ts.last_live_bytes[0]
        finally:
            tel.stop()
        assert outs[0].shape == (BATCH, CLASSES)
        assert ts.stages()[0].final and ts.my_stages() == [0]
    finally:
        dist.shutdown_process_group()
