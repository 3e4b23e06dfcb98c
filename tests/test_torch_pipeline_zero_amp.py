"""The ZeRO and AMP part of the pipeline in mxnet_tpu_torch against
mxnet_tpu, on the CPU: ``PipelineTrainStep(zero=1..3, policy=, dtype=)``,
the overlapped bucketed dp gradients, and ``MXNET_PP`` with ``MXNET_ZERO`` /
``MXNET_AMP`` in ``Module.fit``.

Two launched worlds of gloo ranks (``bench/pp_ladder.py``, one launch
each, the NormConv peephole on) run while the JAX package's references
run in this process on its virtual CPU devices:

- four ranks, the BatchNorm conv net in float64 (x64 on the JAX side):
  (a) dp2 x pp2 at ZeRO levels 0-3 under gpipe (M=2) and levels 0 and 2
  under 1f1b (M=4), each within 1e-9 of the JAX package's
  ``PipelineTrainStep(zero=level)`` of the same schedule and M after two
  steps, the interleaved schedule at level 2 (M=4, v=2) within 1e-9 of its
  gpipe step at M=4 (its own interleaved dp=2 cases fail in every run,
  ROADMAP "Reference caveats"); the rows hold 1/dp of a stage; the plan's
  bytes and ``last_live_bytes`` equal the JAX package's slice by slice;
  the collectives a step by kind equal their prediction; under a float32
  policy, rank 0 alone finding an inf in its bucket row (level 2, and
  level 0 under the overlap) makes every rank skip on the world's
  verdict, and a policy on a mesh of part of the world refuses.  (e) The
  level-2 and level-3 saves byte-equal to the JAX package's; a level-2
  checkpoint (float32 policy) restored into a level-0 step and into one
  process's ``TrainStep``, two more steps within 1e-9, the loss-scale
  state carried.  (b), (c) in float32 on the JAX tests' MLP: pp=4 with the
  bare loss head as its own stage, and AMP x ZeRO-1 x 1f1b at dp2 x pp2,
  each under a float32 policy at a loss scale of 1024, within the JAX
  package's float32 tolerance.  (f) ``Module.fit`` under ``MXNET_PP=2``
  with ``MXNET_ZERO=3`` and with ``MXNET_AMP=1``: each equal to
  ``PipelineTrainStep`` over the same batches, above the JAX test's
  accuracy of 0.8.
- two ranks, the conv net in float32: (c) pp=2 under the float32 policy,
  gpipe at M=2 and 1f1b at M=4 against the JAX package's policy steps, and
  the overflow step (an inf in the first microbatch): parameters,
  optimizer state and moving statistics bitwise unchanged, the scale
  halved and one overflow on every rank and in the JAX package.  (d) The
  pure bfloat16 cast and the bfloat16 policy at gpipe M=2, float32
  masters, within 4x the JAX package's own bfloat16 floor (its distance to
  runs from parameters nudged by 2^-9).
"""
import functools
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench.pp_ladder import (convnet, mlp, parse_case,
                                             predicted_collectives)
from mxnet_tpu_torch.executor import _Lowered
from mxnet_tpu_torch.parallel.placement import chunk_rows
from test_torch_threads import child_env, torch_threads_per_worker  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
# the JAX package's float32 pipeline tolerance (test_pipeline.py)
RTOL32, ATOL32 = 2e-5, 1e-6
BF16_NUDGE, BF16_X, BF16_SAMPLES = 2.0 ** -9, 4.0, 2
BATCH, STEPS, CLASSES, IMAGE = 8, 2, 4, 8
MLP_IN, MLP_CLASSES = 32, 8
# the float32 policy's loss scale (the ladder's amp32 cases)
SCALE = 1024.0
# case -> the JAX step it is held to: (pp, dp, M, schedule, zero)
W4_CASES = {
    "gpipe:2:2:2": (2, 2, 2, "gpipe", 0),
    "gpipe:2:2:2:z1": (2, 2, 2, "gpipe", 1),
    "gpipe:2:2:2:z2": (2, 2, 2, "gpipe", 2),
    "gpipe:2:2:2:z3": (2, 2, 2, "gpipe", 3),
    "1f1b:2:2:4": (2, 2, 4, "1f1b", 0),
    "1f1b:2:2:4:z2": (2, 2, 4, "1f1b", 2),
    "interleaved:2:2:4:2:z2": (2, 2, 4, "gpipe", 2)}
MLP_CASES = {"gpipe:4:1:2:1:amp32": (4, 1, 2, "gpipe", 0),
             "1f1b:2:2:4:1:z1:amp32": (2, 2, 4, "1f1b", 1)}
W2_CASES = {"gpipe:2:1:2:1:amp32": (2, 1, 2, "gpipe", 0),
            "1f1b:2:1:4:1:amp32": (2, 1, 4, "1f1b", 0),
            "gpipe:2:1:2:1:cast": (2, 1, 2, "gpipe", 0),
            "gpipe:2:1:2:1:bf16": (2, 1, 2, "gpipe", 0)}
OVERFLOW = "gpipe:2:1:2:1:amp32"
# rank 0 alone finds an inf in its bucket row: level 2, and level 0 under
# the overlap (float32 policy)
ROW_OVERFLOW = ("gpipe:2:2:2:1:z2:amp32", "1f1b:2:2:4:1:z0:amp32")
RESTORE = "gpipe:2:2:1:1:z2:amp32"


def _tag(spec, prefix=""):
    from mxnet_tpu_torch.bench.pp_ladder import case_tag
    return prefix + case_tag(parse_case(spec))


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


# ------------------------------------------------------------ the worlds
def _launch(n, out, *extra):
    env = {k: v for k, v in child_env().items()
           if not k.startswith("MXTPU_")}
    env.update(PYTHONPATH=ROOT, MXNET_NORM_CONV="1")
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


def _save(path, arrays):
    mt.nd.save(path, {k: mt.nd.array(v, ctx=mt.cpu(), dtype=v.dtype)
                      for k, v in arrays.items()})


def _jax_init(mx, net, data_shape, seed):
    """The JAX package's initial state of ``net`` (float32)."""
    import jax
    from mxnet_tpu.train import TrainStep as JTrainStep
    ts = JTrainStep(net, mx.optimizer.SGD())
    p, _, a = ts.init({"data": data_shape},
                      {"softmax_label": (data_shape[0],)}, seed=seed)
    return ({k: np.asarray(jax.device_get(v)) for k, v in p.items()},
            {k: np.asarray(jax.device_get(v)) for k, v in a.items()})


def _inputs(mx):
    """The conv net's state and two float64 batches; the MLP's state and
    its batch (float32, the same batch both steps, as the JAX tests)."""
    params, aux = _jax_init(mx, convnet(mx, CLASSES),
                            (BATCH, 3, IMAGE, IMAGE), 3)
    rs = np.random.RandomState(5)
    data = rs.uniform(-1, 1, (STEPS, BATCH, 3, IMAGE, IMAGE))
    label = rs.randint(0, CLASSES, (STEPS, BATCH)).astype(np.float64)
    mparams, _ = _jax_init(mx, mlp(mx, MLP_CLASSES), (BATCH, MLP_IN), 0)
    rs = np.random.RandomState(0)
    mdata = rs.uniform(-1, 1, (BATCH, MLP_IN)).astype(np.float32)
    mlabel = rs.randint(0, MLP_CLASSES, (BATCH,)).astype(np.float32)
    return (params, aux, data, label, mparams,
            np.stack([mdata] * STEPS), np.stack([mlabel] * STEPS))


def _opt(mx):
    return mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                            rescale_grad=1.0 / BATCH)


def _jax_pipe(mx, net, host, haux, key, data, label, steps=STEPS,
              policy=None, dtype=None, ckdir=None):
    """The JAX package's PipelineTrainStep of ``key`` = (pp, dp, M,
    schedule, zero) over ``steps`` steps: (step, logical params, aux,
    state)."""
    import jax
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.parallel.mesh import make_pp_mesh
    from mxnet_tpu.train import PipelineTrainStep as JPipe
    pp, dp, m, sched, zero = key
    ts = JPipe(net, _opt(mx), mesh=make_pp_mesh(
        pp, dp=dp, devices=jax.devices()[:pp * dp]), num_microbatches=m,
        schedule=sched, zero=zero, policy=policy, dtype=dtype)
    p, s, a = ts.place_checkpoint(host, ts.fopt.init_state(host), haux)
    if ckdir is not None:
        jck.Checkpointer(os.path.join(ckdir, "m"), async_=False).save(
            ts, p, s, a)
    rng = jax.random.PRNGKey(7)
    for i in range(steps):
        p, s, a, _ = ts(p, s, a, {"data": data[i],
                                  "softmax_label": label[i]}, rng=rng)
    lp = {n: np.asarray(jax.device_get(v)) for n, v in p.items()}
    if zero >= 3:
        lp = {n: ts.unflatten_host(n, v) for n, v in lp.items()}
    return (ts, lp, {n: np.asarray(jax.device_get(v)) for n, v in a.items()},
            (p, s))


def _jax_slice_bytes(ts, p, s):
    """The JAX plan's per-device bytes of each slice (its zero_bytes before
    the worst-slice max)."""
    per = []
    for d in range(ts._pp):
        acc = {"param": 0, "grad": 0, "opt": 0}
        for st in ts.stages():
            if st.index % ts._pp != d:
                continue
            zb = ts.plan.per_device_bytes({n: p[n] for n in st.params},
                                          {n: s[n] for n in st.params})
            for k in acc:
                acc[k] += zb[k]
        per.append(acc)
    return per


def _jax_refs(mx, inp, tmp):
    """Every JAX reference of the file: {name: ...}."""
    import jax
    from mxnet_tpu import amp as jamp
    params, aux, data, label, mparams, mdata, mlabel = inp
    out = {}
    conv, net_mlp = convnet(mx, CLASSES), mlp(mx, MLP_CLASSES)

    def pol():
        return jamp.Policy(compute_dtype="float32", loss_scale=SCALE)
    # float32: the policy cases, the overflow, bfloat16 and its floor
    p32 = {n: v.astype(np.float32) for n, v in params.items()}
    a32 = {n: v.astype(np.float32) for n, v in aux.items()}
    d32, l32 = data.astype(np.float32), label.astype(np.float32)
    for spec, key in MLP_CASES.items():
        ts, lp, _, _ = _jax_pipe(mx, net_mlp, mparams, {}, key, mdata,
                                 mlabel, policy=pol())
        out["mlp/" + spec] = (lp, ts.amp_stats())
    for spec in ("gpipe:2:1:2:1:amp32", "1f1b:2:1:4:1:amp32"):
        ts, lp, la, _ = _jax_pipe(mx, conv, p32, a32, W2_CASES[spec], d32,
                                  l32, policy=pol())
        out["w2/" + spec] = (lp, la, ts.amp_stats())
    bad = d32.copy()
    bad[0, 0, 0, 0, 0] = np.inf
    ts, lp, la, _ = _jax_pipe(mx, conv, p32, a32, W2_CASES[OVERFLOW], bad,
                              l32, steps=1, policy=pol())
    out["overflow"] = (lp, la, ts.amp_stats())
    gen = np.random.RandomState(9)
    nudged = [{n: (v * (1 + BF16_NUDGE * gen.uniform(-1, 1, v.shape)))
               .astype(np.float32) for n, v in p32.items()}
              for _ in range(BF16_SAMPLES)]
    for spec, kw in (("gpipe:2:1:2:1:cast", {"dtype": "bfloat16"}),
                     ("gpipe:2:1:2:1:bf16",
                      {"policy": jamp.Policy("bfloat16")})):
        runs = [_jax_pipe(mx, conv, src, a32, W2_CASES[spec], d32, l32,
                          **kw)[1:3] for src in [p32] + nudged]
        base = dict(runs[0][0], **runs[0][1])
        floor = {n: max(float(np.abs(dict(r[0], **r[1])[n].astype(
            np.float64) - base[n]).max()) for r in runs[1:]) for n in base}
        out["w2/" + spec] = (base, floor)
    # float64: the ZeRO levels, their bytes and the saves
    p64 = {n: v.astype(np.float64) for n, v in params.items()}
    a64 = {n: v.astype(np.float64) for n, v in aux.items()}
    jax.config.update("jax_enable_x64", True)
    try:
        for spec, key in W4_CASES.items():
            save = os.path.join(tmp, "jax_z%d" % key[4]) \
                if key[4] >= 2 and key[3] == "gpipe" and key[2] == 2 \
                else None
            ts, lp, la, (p, s) = _jax_pipe(mx, conv, p64, a64, key, data,
                                           label, ckdir=save)
            out["w4/" + spec] = (lp, la, list(ts.last_live_bytes),
                                 _jax_slice_bytes(ts, p, s),
                                 ts.zero_bytes(p, s))
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


@pytest.fixture(scope="module")
def worlds(mx, tmp_path_factory):
    """Both launched worlds, run while the JAX references run here: ({world:
    (rc, log, rank reports, rank-0 arrays, out dir)}, JAX refs, tmp)."""
    tmp = tmp_path_factory.mktemp("pp_zero_amp")
    inp = _inputs(mx)
    params, aux, data, label, mparams, mdata, mlabel = inp
    files = {"p": str(tmp / "init.params"), "d": str(tmp / "data.params"),
             "mp": str(tmp / "mlp.params"), "md": str(tmp / "mlpdata.params")}
    _save(files["p"], dict([("arg:" + k, v) for k, v in params.items()]
                           + [("aux:" + k, v) for k, v in aux.items()]))
    _save(files["d"], {"data": data, "softmax_label": label})
    _save(files["mp"], {"arg:" + k: v for k, v in mparams.items()})
    _save(files["md"], {"data": mdata, "softmax_label": mlabel})
    common = ["--params", files["p"], "--data", files["d"], "--steps",
              str(STEPS), "--batch", str(BATCH), "--classes", str(CLASSES),
              "--image", str(IMAGE), "--save-arrays"]
    outs = {2: str(tmp / "w2"), 4: str(tmp / "w4")}
    procs = {
        4: _launch(4, outs[4], "--dtype", "float64", "--cases",
                   ",".join(W4_CASES), "--ckpt", "--restore-check", RESTORE,
                   "--row-overflow", ",".join(ROW_OVERFLOW),
                   "--mlp-cases", ",".join(MLP_CASES), "--mlp-params",
                   files["mp"], "--mlp-data", files["md"], "--toy-fit",
                   *common),
        2: _launch(2, outs[2], "--dtype", "float32", "--cases",
                   ",".join(W2_CASES), "--overflow", OVERFLOW, *common)}
    want = _jax_refs(mx, inp, str(tmp))
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
    return res, want, str(tmp)


def _world(worlds, n):
    res, want, tmp = worlds
    rc, log, rows, arrays, out = res[n]
    assert rc == 0 and len(rows) == n, log[-4000:]
    return rows, arrays, out, want, tmp


def _row(rows, rank, tag):
    return [c for c in rows[rank]["cases"] if c["tag"] == tag][0]


def _leaves(arrays, tag):
    p = {k[len(tag) + 5:]: v for k, v in arrays.items()
         if k.startswith(tag + "/arg:")}
    a = {k[len(tag) + 5:]: v for k, v in arrays.items()
         if k.startswith(tag + "/aux:")}
    return p, a


# ------------------------------------------------------ (a) the levels
@functools.lru_cache(maxsize=None)
def _stage_params(V):
    low = _Lowered(convnet(mt, CLASSES))
    args, _, _ = convnet(mt, CLASSES).infer_shape(
        data=(BATCH, 3, IMAGE, IMAGE), softmax_label=(BATCH,))
    names = convnet(mt, CLASSES).list_arguments()
    sizes = {n: int(np.prod(s)) for n, s in zip(names, args)
             if n not in ("data", "softmax_label")}
    return [(st.params, sizes) for st in low.stage_partition(
        V, {"data", "softmax_label"}, sizes)]


@pytest.mark.parametrize("spec", sorted(W4_CASES))
def test_levels_match_jax(worlds, spec):
    """Each level and schedule within 1e-9 of the JAX package's step."""
    rows, arrays, _, want, _ = _world(worlds, 4)
    jp, ja = want["w4/" + spec][:2]
    gp, ga = _leaves(arrays, _tag(spec))
    for kind, ref, got in (("arg", jp, gp), ("aux", ja, ga)):
        assert sorted(got) == sorted(ref)
        for n, w in ref.items():
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(got[n] - w).max()) <= TOL * scale, \
                (spec, kind, n)
    assert all(_row(rows, r["rank"], _tag(spec))["outputs_finite"]
               for r in rows)
    # the peephole ran (its plain version on the CPU)
    assert sum(_row(rows, r["rank"], _tag(spec))["norm_conv_calls_per_step"]
               for r in rows) > 0


@pytest.mark.parametrize("spec", sorted(W4_CASES))
def test_rows_bytes_and_collectives(worlds, spec):
    """The rows hold 1/dp of a stage (state at level >= 1, parameters too
    at 3); the plan's bytes and ``last_live_bytes`` equal the JAX
    package's slice by slice; the collectives equal their prediction."""
    rows, _, _, want, _ = _world(worlds, 4)
    case = parse_case(spec)
    level, dp = case[5], case[2]
    jp, _, live, by_slice, worst = want["w4/" + spec]
    for r in rows:
        row = _row(rows, r["rank"], _tag(spec))
        for n, shapes in row["row_shapes"].items():
            size = int(np.prod(jp[n].shape))
            rowshape = [chunk_rows(size, dp)]
            assert shapes[0] == (rowshape if level >= 3
                                 else list(jp[n].shape)), n
            assert all(s == (rowshape if level else list(jp[n].shape))
                       for s in shapes[1:]), n
        if case[0] == W4_CASES[spec][3]:
            # the same schedule and cut as the JAX step's
            assert row["last_live_bytes"] == live, spec
            assert row["zero_bytes_by_slice"] == by_slice, spec
            assert row["zero_bytes"] == worst
        calls = {k: v["calls"] for k, v in row["collectives_per_step"]
                 .items() if k not in ("send", "recv", "send_outputs",
                                       "recv_outputs", "stats")}
        stages = [bool(names) for names, _ in _stage_params(
            case[1] * case[4])]
        assert calls == predicted_collectives(case, r["rank"], stages), \
            (spec, r["rank"])


# ------------------------------------------------------ (b), (c) AMP
def _close32(got, want, what):
    for n in sorted(want):
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL32,
                                   atol=ATOL32, err_msg="%s %s" % (what, n))


@pytest.mark.parametrize("spec", sorted(MLP_CASES))
def test_mlp_policy_cases_match_jax(worlds, spec):
    """pp=4 with a stage of the bare loss head, and AMP x ZeRO-1 x 1f1b at
    dp2 x pp2, under a float32 policy at a loss scale of 1024."""
    rows, arrays, _, want, _ = _world(worlds, 4)
    jp, jstats = want["mlp/" + spec]
    tag = _tag(spec, "mlp-")
    _close32(_leaves(arrays, tag)[0], jp, spec)
    assert tuple(jstats) == (SCALE, 0)
    for r in rows:
        assert tuple(_row(rows, r["rank"], tag)["amp_stats"]) == (SCALE, 0)
    if parse_case(spec)[1] == 4:
        # the last stage is the bare loss head: no parameters
        assert not _Lowered(mlp(mt, MLP_CLASSES)).stage_partition(
            4, {"data", "softmax_label"})[3].params


@pytest.mark.parametrize("spec", ["1f1b:2:1:4:1:amp32",
                                  "gpipe:2:1:2:1:amp32"])
def test_conv_policy_cases_match_jax(worlds, spec):
    rows, arrays, _, want, _ = _world(worlds, 2)
    jp, ja, jstats = want["w2/" + spec]
    gp, ga = _leaves(arrays, _tag(spec))
    _close32(gp, jp, spec)
    _close32(ga, ja, spec)
    assert tuple(jstats) == (SCALE, 0)
    for r in rows:
        row = _row(rows, r["rank"], _tag(spec))
        assert tuple(row["amp_stats"]) == (SCALE, 0)
        assert row["output_dtypes"] == ["float32"]


def test_overflow_skips_every_stage(worlds):
    rows, _, _, want, _ = _world(worlds, 2)
    _, _, jstats = want["overflow"]
    assert tuple(jstats) == (SCALE / 2, 1)
    for r in rows:
        ov = r["overflow"]
        assert ov["params_bitwise"] and ov["state_bitwise"] \
            and ov["aux_bitwise"], ov
        assert tuple(ov["amp_stats"]) == (SCALE / 2, 1), ov
        assert ov["scale_state"] == {"scale": SCALE / 2, "good": 0,
                                     "overflow": 1}


@pytest.mark.parametrize("spec", ROW_OVERFLOW)
def test_one_rows_overflow_skips_every_rank(worlds, spec):
    """Rank 0 alone judges its gradients non-finite (an inf in its bucket
    row, the batch clean); the world's verdict makes every rank skip:
    nothing moves anywhere, the scale halves on every rank."""
    rows, _, _, _, _ = _world(worlds, 4)
    for r in rows:
        ov = [x for x in r["row_overflow"] if x["tag"] == _tag(spec)][0]
        assert ov["own_verdict"] == [r["rank"] != 0], (spec, r["rank"])
        assert ov["params_bitwise"] and ov["state_bitwise"] \
            and ov["aux_bitwise"], (spec, r["rank"], ov)
        assert tuple(ov["amp_stats"]) == (SCALE / 2, 1), (spec, ov)
        assert r["part_mesh_policy_refused"] is True


# ------------------------------------------------------------ (d) bf16
@pytest.mark.parametrize("spec", ["gpipe:2:1:2:1:cast",
                                  "gpipe:2:1:2:1:bf16"])
def test_bf16_within_the_jax_floor(worlds, spec):
    """Each leaf within 4x the JAX package's own bfloat16 floor: the
    largest distance of its runs from parameters nudged by 2^-9."""
    rows, arrays, _, want, _ = _world(worlds, 2)
    base, floor = want["w2/" + spec]
    gp, ga = _leaves(arrays, _tag(spec))
    got = dict(gp, **ga)
    assert sorted(got) == sorted(base)
    for n, w in base.items():
        d = float(np.abs(got[n].astype(np.float64) - w).max())
        assert d <= BF16_X * floor[n], (spec, n, d, floor[n])
    for r in rows:
        row = _row(rows, r["rank"], _tag(spec))
        assert row["output_dtypes"] == (
            ["float32"] if spec.endswith("bf16") else ["bfloat16"])
        assert row["outputs_finite"]


# ------------------------------------------------------- (e) checkpoints
@pytest.mark.parametrize("level", [2, 3])
def test_zero_saves_byte_equal_to_jax(worlds, level):
    """The initial state saved at dp2 x pp2: every shard, the
    ``stage<k>-zero<j>`` rows included, byte-equal to the JAX package's
    save, and the manifests equal but for the world and the writers."""
    _, _, out, _, tmp = _world(worlds, 4)
    got = os.path.join(out, "ck0-" + _tag("gpipe:2:2:2:z%d" % level, ""),
                       "m-step00000000.ckpt")
    wanted = os.path.join(tmp, "jax_z%d" % level, "m-step00000000.ckpt")
    names = sorted(os.listdir(wanted))
    assert names == sorted(os.listdir(got))
    assert {"stage0-zero0.params", "stage0-zero1.params",
            "stage1-zero0.params", "stage1-zero1.params"} <= set(names)
    for name in names:
        a = open(os.path.join(got, name), "rb").read()
        b = open(os.path.join(wanted, name), "rb").read()
        if name != "manifest.json":
            assert a == b, name
            continue
        ma, mb = json.loads(a), json.loads(b)
        assert ma["topology"].pop("world") == 4
        mb["topology"].pop("world")
        for m_ in (ma, mb):
            for meta in m_["shards"].values():
                meta.pop("rank")
        assert ma == mb


def test_restore_across_levels_and_topologies(worlds):
    rows, _, _, _, _ = _world(worlds, 4)
    for r in rows:
        rc = r["restore_check"]
        assert rc["topology"]["zero"] == 2 and rc["topology"]["dp"] == 2
        assert rc["restored_bitwise"] and rc["one_process_restored_bitwise"]
        assert rc["zero0_max_abs"] <= TOL and \
            rc["one_process_max_abs"] <= TOL, rc
        # the loss-scale state round-trips
        assert rc["scale_saved"] == {"scale": SCALE, "good": STEPS,
                                     "overflow": 0}
        assert rc["scale_restored"] == [rc["scale_saved"]] * 2


# ------------------------------------------------------- (f) the fit
@pytest.mark.parametrize("label", ["zero3", "amp"])
def test_fused_fit_knobs(worlds, label):
    rows, _, _, _, _ = _world(worlds, 4)
    for r in rows:
        fit = r["toy_fit"][label]
        assert fit["pipeline"] == "PipelineTrainStep" and fit["pp"] == 2 \
            and fit["dp"] == 2, fit
        assert fit["zero"] == (3 if label == "zero3" else 0)
        assert (fit["policy"] is not None) == (label == "amp")
        assert fit["max_abs"] == 0.0, fit
        assert fit["accuracy"] > 0.8, fit
