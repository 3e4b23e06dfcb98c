"""The tensor-parallel part of the distributed slice in mxnet_tpu_torch
against mxnet_tpu, on the CPU.

Two gloo worlds run ``bench/tp_sp_ladder.py`` (one launch each, beside the
JAX package's runs): four ranks on a ``dp2 x tp2`` mesh and two on ``tp2``.
Each trains the zero tests' 20-layer ResNet at 3x16x16 with 8 classes (so
the classifier splits over ``tp``) in float64 for 2 steps from the JAX
package's initial state, with SGD-momentum and with Adam, through the three
routes: ``col`` (the dryrun's ``fc1_weight`` ``("tp", None)`` and
``fc1_bias`` ``("tp",)``: column-parallel), ``row`` (``fc1_weight``
``(None, "tp")``: row-parallel) and ``gather`` (``conv0_weight`` split on
its output channels, all-gathered where it is read).  Every case's whole
parameters and moving statistics are within rtol 1e-9 / atol 1e-10 (the
dryrun's tolerance) of the JAX package's single-device step, and of its
``dp2 x tp2`` step of the same route where it ran; the collectives a step
are ``predicted_collectives``' calls and bytes; the replicated parameters
and moving statistics are bitwise equal across the ``tp`` ranks; a planted
fault (BatchNorm's sums over the world with the dp count) is seen by the
same comparison; the NormConv peephole's case matches too.  A checkpoint
of the JAX package's state saved by the four ranks is byte-equal to the
JAX package's save of it on its ``dp2 x tp2`` mesh, restores into that mesh
bitwise and into one process whole; ``EvalStep`` over the mesh equals one
process's forward; ZeRO with a ``tp`` spec, ``PipelineTrainStep`` on a
``tp`` axis and a split that does not divide refuse, the last in the JAX
package's words.
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
from mxnet_tpu_torch.bench import tp_sp_ladder as ladder
from test_torch_threads import child_env
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-10
BATCH, CLASSES, IMAGE, LAYERS = 8, 8, 16, 20
STEPS = ladder.STEPS
# the worlds: ranks, mesh, cases
WORLDS = {"dp2xtp2": (4, "col:sgd,col:adam,row:sgd,row:adam,gather:sgd"),
          "tp2": (2, "col:sgd,row:sgd,row:adam,gather:adam")}
# the JAX package's dp2 x tp2 steps the cases are also held to
JAX_MESH = ("col:sgd", "row:adam", "gather:sgd")
CASES = [(w, c) for w, (_, cases) in WORLDS.items()
         for c in cases.split(",")]


def start(args):
    env = {k: v for k, v in child_env().items()
           if not k.startswith("MXTPU_")}
    env.update(PYTHONPATH=ROOT)
    return subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def finish(p, timeout=300):
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail("timed out after %d s: %s" % (timeout, out[-4000:]))
    return p.returncode, out


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _pspec(spec):
    from jax.sharding import PartitionSpec
    return {n: PartitionSpec(*s) for n, s in spec.items()}


def _jax_opt(mx, name):
    if name == "sgd":
        return mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                                rescale_grad=1.0 / BATCH)
    return mx.optimizer.Adam(learning_rate=1e-3, rescale_grad=1.0 / BATCH)


def _jax_mesh():
    import jax
    from mxnet_tpu.parallel.mesh import make_mesh
    return make_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])


def _jax_run(mx, net, params, aux, data, label, case):
    """The JAX package's step (``case`` a bare optimizer name: one device;
    ``route:optimizer``: the route on its dp2 x tp2 mesh), float64, 2
    steps: whole params and aux."""
    import jax
    from mxnet_tpu.train import TrainStep as JTrainStep
    opt = case.split(":")[-1]
    if ":" not in case:
        ts = JTrainStep(net, _jax_opt(mx, opt))
    else:
        ts = JTrainStep(net, _jax_opt(mx, opt), mesh=_jax_mesh(),
                        param_shardings=_pspec(
                            ladder.SPECS[case.split(":")[0]]))
    host = {n: v.astype(np.float64) for n, v in params.items()}
    p, s, a = ts.place_checkpoint(host, ts.fopt.init_state(host),
                                  {n: v.astype(np.float64)
                                   for n, v in aux.items()})
    get = jax.device_get
    for i in range(STEPS):
        if i and ":" in case:
            # the JAX step's outputs come back with the split propagated to
            # replicated parameters (row and gather), which its next call's
            # in_shardings refuse: place its state again between steps
            p, s, a = ts.place_checkpoint(get(p), get(s), get(a))
        b = ts.shard_batch({"data": data[i], "softmax_label": label[i]})
        p, s, a, _ = ts(p, s, a, b, rng=jax.random.PRNGKey(7))
    return ({n: np.asarray(get(v)) for n, v in p.items()},
            {n: np.asarray(get(v)) for n, v in a.items()})


def _ckpt_state(params, aux):
    """A float64 state (parameters, momenta, moving statistics) of random
    values, saved by both packages."""
    rs = np.random.RandomState(17)
    p = {n: rs.randn(*v.shape) * 0.1 for n, v in params.items()}
    s = {n: (rs.randn(*v.shape) * 0.01,) for n, v in params.items()}
    a = {n: (rs.rand(*v.shape) + 0.5) if "var" in n else rs.randn(*v.shape)
         for n, v in aux.items()}
    return p, s, a


def _save(path, entries):
    mt.nd.save(path, {k: mt.nd.array(v, ctx=mt.cpu(), dtype=v.dtype)
                      for k, v in entries.items()})


def _jax_save(mx, net, state, out):
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu.train import TrainStep as JTrainStep
    p, s, a = state
    ts = JTrainStep(net, _jax_opt(mx, "sgd"), mesh=_jax_mesh(),
                    param_shardings=_pspec(ladder.SPECS["col"]))
    jp, js, ja = ts.place_checkpoint(p, s, a)
    ts.num_update = STEPS
    return jck.Checkpointer(os.path.join(out, "m"), async_=False).save(
        ts, jp, js, ja)


@pytest.fixture(scope="module")
def worlds(mx, tmp_path_factory):
    import jax
    from mxnet_tpu.models import resnet as jresnet
    from mxnet_tpu.train import TrainStep as JTrainStep
    out = tmp_path_factory.mktemp("tp_ladder")
    net = jresnet.get_symbol(CLASSES, LAYERS, "3,%d,%d" % (IMAGE, IMAGE))
    p, _, a = JTrainStep(net, mx.optimizer.SGD()).init(
        {"data": (BATCH, 3, IMAGE, IMAGE)}, {"softmax_label": (BATCH,)},
        seed=3)
    params = {k: np.asarray(jax.device_get(v)) for k, v in p.items()}
    aux = {k: np.asarray(jax.device_get(v)) for k, v in a.items()}
    rs = np.random.RandomState(5)
    data = rs.uniform(-1, 1, (STEPS, BATCH, 3, IMAGE, IMAGE))
    label = rs.randint(0, CLASSES, (STEPS, BATCH)).astype(np.float64)
    files = {k: str(out / ("%s.params" % k)) for k in ("init", "data",
                                                        "ckpt")}
    _save(files["init"], dict([("arg:" + k, v) for k, v in params.items()]
                              + [("aux:" + k, v) for k, v in aux.items()]))
    _save(files["data"], {"data": data, "softmax_label": label})
    cstate = _ckpt_state(params, aux)
    _save(files["ckpt"], dict(
        [("arg:" + k, v) for k, v in cstate[0].items()]
        + [("aux:" + k, v) for k, v in cstate[2].items()]
        + [("opt:%s:0" % k, v[0]) for k, v in cstate[1].items()]))
    common = ["--ctx", "cpu", "--params", files["init"], "--data",
              files["data"], "--dtype", "float64", "--batch", str(BATCH),
              "--classes", str(CLASSES), "--image", str(IMAGE),
              "--num-layers", str(LAYERS), "--save-arrays"]
    procs = {}
    for name, (n, cases) in WORLDS.items():
        # the first case (col:sgd) again under the knob, with the planted
        # fault, and its checkpoint
        extra = ["--eval", "--refusals", "--bn-world", "--norm-conv",
                 "--ckpt", "--ckpt-state", files["ckpt"]] if n == 4 else []
        procs[name] = start(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
             sys.executable, "-m", "mxnet_tpu_torch.bench.tp_sp_ladder",
             "--out", str(out / name), "--mesh", name, "--cases", cases]
            + common + extra)
    jax.config.update("jax_enable_x64", True)
    try:
        want = {opt: _jax_run(mx, net, params, aux, data, label, opt)
                for opt in ("sgd", "adam")}
        mesh = {c: _jax_run(mx, net, params, aux, data, label, c)
                for c in JAX_MESH}
        jdir = _jax_save(mx, net, cstate, str(out / "jck"))
    finally:
        jax.config.update("jax_enable_x64", False)
    res = {}
    for name, (n, _) in WORLDS.items():
        rc, log = finish(procs[name])
        rows, arrays = [], []
        for r in range(n):
            path = os.path.join(str(out / name), "rank%d.json" % r)
            if os.path.exists(path):
                with open(path) as f:
                    rows.append(json.load(f))
                raw = mt.nd.load(os.path.join(str(out / name),
                                              "rank%d.params" % r),
                                 ctx=mt.cpu())
                arrays.append({k: v.asnumpy() for k, v in raw.items()})
        res[name] = (rc, log, rows, arrays)
    return {"worlds": res, "single": want, "mesh": mesh, "jdir": jdir,
            "out": str(out), "cstate": cstate, "params": params}


def _world(worlds, name):
    rc, log, rows, arrays = worlds["worlds"][name]
    assert rc == 0 and len(rows) == WORLDS[name][0], log[-4000:]
    return rows, arrays


def _case(row, tag):
    return [c for c in row["cases"] if c["case"] == tag][0]


def _close(arr, tag, want):
    wp, wa = want
    for kind, ref in (("arg:", wp), ("aux:", wa)):
        for n, w in ref.items():
            np.testing.assert_allclose(arr["%s/%s%s" % (tag, kind, n)], w,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=tag + kind + n)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_worlds_run(worlds, name):
    rows, _ = _world(worlds, name)
    for r in rows:
        assert r["ok"] and r["route"] == "gloo"
        assert r["world"] == WORLDS[name][0]
        assert r["mesh"] == {"dp": ladder.parse_mesh(name).get("dp", 1),
                             "tp": 2}


@pytest.mark.parametrize("name,case", CASES)
def test_cases_match_jax(worlds, name, case):
    """Each rank's whole parameters and moving statistics against the JAX
    package's single-device step of the optimizer, and its dp2 x tp2 step
    of the route where it ran (rtol 1e-9, atol 1e-10)."""
    _, arrays = _world(worlds, name)
    for arr in arrays:
        _close(arr, case, worlds["single"][case.split(":")[1]])
        if case in worlds["mesh"]:
            _close(arr, case, worlds["mesh"][case])


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_routes_collectives_and_replicas(worlds, name):
    """The routes the plan chose; the collectives a step, calls and bytes,
    equal to ``predicted_collectives``; the replicated parameters and
    moving statistics bitwise equal across the tp ranks; the outputs the
    dp slice's rows at full width; the split parameters' bytes."""
    rows, _ = _world(worlds, name)
    routes = {"col": ({"fc1": "column"}, []), "row": ({"fc1": "row"}, []),
              "gather": ({}, ["conv0_weight"])}
    dp = ladder.parse_mesh(name).get("dp", 1)
    for r in rows:
        for c in r["cases"]:
            if c["case"].startswith(("nc-", "bnworld-")):
                continue
            assert (c["routes"], c["gathered"]) == routes[c["route"]], c
            calls = {k: v[0] for k, v in c["predicted"].items()}
            assert c["collectives_per_step"] == calls, c
            for k, (_, nbytes) in c["predicted"].items():
                if nbytes is not None:
                    assert c["collective_bytes_per_step"][k] == nbytes, (k, c)
            assert c["tp_bitwise_equal"] and \
                c["whole_equal_across_world"], c
            assert c["outputs"] == [[BATCH // dp, CLASSES]]
        col = _case(r, "col:sgd")
        assert col["split_bytes"] == (CLASSES * 64 + CLASSES) // 2 * 8


def test_batchnorm_sums_over_the_dp_group(worlds):
    """BatchNorm's sums go over the dp group: the same step with them over
    the world (the tp ranks' duplicate rows counted twice) is far from the
    JAX package's, which the parity check sees."""
    rows, arrays = _world(worlds, "dp2xtp2")
    want = worlds["single"]["sgd"]
    for r, arr in zip(rows, arrays):
        planted = _case(r, "bnworld-col:sgd")
        assert planted["collectives_per_step"]["stats"] == \
            _case(r, "col:sgd")["collectives_per_step"]["stats"]
        with pytest.raises(AssertionError):
            _close(arr, "bnworld-col:sgd", want)
        _close(arr, "col:sgd", want)


def test_norm_conv_peephole_on_the_mesh(worlds):
    """The column-parallel case through the NormConv peephole (its plain
    version on the CPU; its statistics' sums over the dp group) matches the
    JAX package's dp2 x tp2 step."""
    rows, arrays = _world(worlds, "dp2xtp2")
    for r, arr in zip(rows, arrays):
        assert _case(r, "nc-col:sgd")["norm_conv_calls_per_step"] > 0
        assert _case(r, "col:sgd")["norm_conv_calls_per_step"] == 0
        _close(arr, "nc-col:sgd", worlds["mesh"]["col:sgd"])


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_checkpoint_bytes_match_jax_and_restore(worlds):
    """The four ranks' save of the JAX package's state is the JAX
    package's save of it on its dp2 x tp2 mesh, shard for shard byte for
    byte (the split parameters and their momenta whole); it restores
    bitwise into the mesh and, in one process, whole."""
    from mxnet_tpu_torch import checkpoint as pck
    rows, _ = _world(worlds, "dp2xtp2")
    rep = rows[0]["ckpt"]
    assert all(r["ckpt"]["restored_bitwise"] for r in rows)
    assert rep["one_process_bitwise"] and rep["one_process_shapes"] == {
        "fc1_weight": [CLASSES, 64], "fc1_bias": [CLASSES]}
    pdir = os.path.join(worlds["out"], "dp2xtp2", rep["path"])
    jf, pf = _files(worlds["jdir"]), _files(pdir)
    assert sorted(pf) == sorted(jf) == ["manifest.json", "stage0-opt.params",
                                        "stage0.params"]
    for f in ("stage0-opt.params", "stage0.params"):
        assert pf[f] == jf[f], f
    jm, pm = (json.loads(x["manifest.json"]) for x in (jf, pf))
    for k in ("params", "aux", "opt_state", "step", "stage_of"):
        assert pm[k] == jm[k], k
    p, s, a = worlds["cstate"]
    ts = mt.TrainStep(mt.models.resnet.get_symbol(
        CLASSES, LAYERS, "3,%d,%d" % (IMAGE, IMAGE)),
        mt.optimizer.SGD(momentum=0.9), ctx=mt.cpu())
    rp, rs, ra, _ = pck.restore_into(ts, pdir)
    assert ts.num_update == STEPS
    for n in p:
        np.testing.assert_array_equal(rp[n].numpy(), p[n])
        np.testing.assert_array_equal(rs[n][0].numpy(), s[n][0])
    for n in a:
        np.testing.assert_array_equal(ra[n].numpy(), a[n])


def test_eval_step_over_the_mesh(worlds):
    rows, _ = _world(worlds, "dp2xtp2")
    for r in rows:
        ev = r["eval"]
        assert ev["shapes"] == [[BATCH, CLASSES]]
        assert ev["equal_across_ranks"] and ev["max_abs"] <= ATOL, ev


def test_refusals_that_stay(worlds, mx):
    """ZeRO with a tp spec and PipelineTrainStep on a tp axis refuse in the
    JAX package's words, and a split that does not divide in the words of
    the JAX package's own refusal of it."""
    from mxnet_tpu.train import TrainStep as JTrainStep
    rows, _ = _world(worlds, "dp2xtp2")
    for r in rows:
        assert r["refusals"] == {"zero_with_tp_spec": True,
                                 "pipeline_tp_axis": True,
                                 "uneven_split": True,
                                 "sp_axis_on_a_step": True}
    net = mx.models.resnet.get_symbol(CLASSES, LAYERS,
                                      "3,%d,%d" % (IMAGE, IMAGE))
    ts = JTrainStep(net, _jax_opt(mx, "sgd"), mesh=_jax_mesh(),
                    param_shardings=_pspec(
                        {"conv0_weight": (None, "tp", None, None)}))
    with pytest.raises(ValueError, match="should be divisible by 2, but it "
                       "is equal to 3"):
        ts.init({"data": (BATCH, 3, IMAGE, IMAGE)},
                {"softmax_label": (BATCH,)})


@pytest.mark.cuda
def test_dp_tp_world_on_the_card(tmp_path):
    """Two ranks sharing the card over gloo: the column- and row-parallel
    cases at toy size in float32, each held to one process's step on the
    card, the replicated leaves bitwise equal across the tp ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = start([sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
               sys.executable, "-m", "mxnet_tpu_torch.bench.tp_sp_ladder",
               "--ctx", "gpu", "--out", str(tmp_path), "--mesh", "tp2",
               "--cases", "col:sgd,row:sgd", "--dtype", "float32",
               "--single"])
    rc, log = finish(p)
    assert rc == 0, log[-4000:]
    for r in range(2):
        with open(os.path.join(str(tmp_path), "rank%d.json" % r)) as f:
            rep = json.load(f)
        assert rep["route"] == "gloo-cuda"
        for c in rep["cases"]:
            assert c["tp_bitwise_equal"] and c["max_abs_vs_single"] < 1e-4
