"""The port's telemetry (mxnet_tpu_torch/telemetry.py and its call sites)
against mxnet_tpu's, on the CPU.

- Twins of tests/python/unittest/test_telemetry.py: the registry's JSON-lines
  round trip, cancel, the profiler mirror, env autostart and its failures,
  the fit loop's step breakdown, the kvstore counters, the Speedometer,
  tools/telemetry_report.py (unedited) on the port's file, the
  zero-overhead default and the fused path kept while telemetry is off.
- Parity: the same numpy inputs and parameters through an MLP fit of 3
  batches in each package, on the general path and on the fused path
  (``MXNET_TELEMETRY_FUSED=1``): the multiset of (kind, name, cat, tag
  keys) of the events, the counters, and the ``train_*`` scalars within
  1e-6.  The JAX package's events of its jit caches, compiles and device
  memory samples (``jit_cache_*``, ``xla_compile``, ``compile_*``,
  ``device_live_*``, the ``jit`` tag of ``executor.forward``) belong to
  its sanitizer and diagnostics, which the port has not (no jit, no
  compile; the diagnostics arrive with the numerics slice), and are set
  aside before the comparison.  The kvstore counters over [cpu(0),
  cpu(1)] with "local", equal in both.
- The flight recorder, histograms and quantiles, ``MXNET_OPT_STATS``, the
  io, serving and lr-schedule sites.
- Off means off: with every knob unset a fit emits nothing, starts no
  thread of the registry's, and waits for no device
  (``engine._wait`` and ``torch.cuda.synchronize`` counted through a
  monkeypatch).
"""
import importlib.util
import json
import os
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tel
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RS = np.random.RandomState
# the JAX package's events of its jit caches, compiles and device-memory
# samples: the sanitizer and diagnostics, not ported
JAX_ONLY = ("jit_cache_hit", "jit_cache_miss", "jit_cache_size",
            "xla_compile", "compile_ms", "compile_seconds")
JAX_ONLY_PREFIX = ("device_live_",)


@pytest.fixture(autouse=True)
def _clean_registry():
    """Telemetry is process-global: every test starts and ends disabled."""
    tel.stop()
    tel.reset()
    yield
    tel.stop()
    tel.reset()


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.models  # noqa: F401
    mx.telemetry.stop()
    mx.telemetry.reset()
    yield mx
    mx.telemetry.stop()
    mx.telemetry.reset()


def _small_net(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _load_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _fit_smoke(tmp_path, kvstore="local"):
    """2-epoch synthetic Module.fit with a JSON-lines sink; returns events."""
    fname = str(tmp_path / "telemetry.jsonl")
    x = RS(0).rand(20, 6).astype(np.float32)
    y = RS(1).randint(0, 4, 20).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=10)
    mod = mt.Module(_small_net(mt), context=mt.cpu(),
                    data_names=("data",), label_names=("softmax_label",))
    tel.start(fname)
    try:
        mod.fit(it, num_epoch=2, kvstore=kvstore,
                optimizer_params={"learning_rate": 0.1})
    finally:
        tel.stop()
    return fname, _load_jsonl(fname)


# ----------------------------------------------------------------- registry
def test_counter_span_gauge_roundtrip_jsonl(tmp_path):
    fname = str(tmp_path / "t.jsonl")
    tel.start(fname)
    tel.counter("apples", 2, basket="a")
    tel.counter("apples", 3)
    tel.gauge("temp", 21.5)
    with tel.span("work", cat="unit", nbatch=7):
        pass
    assert tel.value("apples") == 5
    assert tel.value("temp") == 21.5
    tel.stop()
    events = _load_jsonl(fname)
    kinds = {}
    for ev in events:
        kinds.setdefault(ev["type"], []).append(ev)
    assert [e["total"] for e in kinds["counter"]
            if e["name"] == "apples"] == [2, 5]
    assert kinds["counter"][0]["tags"] == {"basket": "a"}
    (sp,) = kinds["span"]
    assert sp["name"] == "work" and sp["cat"] == "unit"
    assert sp["dur"] >= 0 and sp["tags"] == {"nbatch": 7}
    (summary,) = kinds["summary"]
    assert summary["counters"]["apples"] == 5
    assert summary["gauges"]["temp"] == 21.5
    assert summary["histograms"]["work"]["count"] == 1
    # stop() disables: later traffic is dropped
    tel.counter("apples", 100)
    assert tel.value("apples") == 5


def test_span_cancel_suppresses_emission():
    tel.start()
    with tel.span("kept"):
        pass
    with tel.span("dropped") as sp:
        sp.cancel()
    names = [e["name"] for e in tel.events() if e["type"] == "span"]
    assert names == ["kept"]


def test_histograms_and_scalars_match_jax(mx):
    """The same observations give the same histogram export, quantiles,
    series keys and scalar registry in both packages."""
    jt = mx.telemetry
    vals = list(RS(0).lognormal(3.0, 2.0, 200)) + [0.01, 1e11, float("nan")]
    out = []
    for t in (tel, jt):
        t.start()
        for i, v in enumerate(vals):
            t.histogram("lat", v)
            t.scalar("loss", i, v, head="a")
        snap = t.registry_snapshot()
        out.append((snap["histograms"], snap["scalars"],
                    [t.quantile("lat", q) for q in (0.0, 0.5, 0.9, 0.99, 1)],
                    t.series_key("grad_norm", {"param": "w", "a": 1})))
        t.stop()
    assert out[0][0] == out[1][0]
    assert out[0][2] == out[1][2]
    assert out[0][3] == out[1][3] == "grad_norm[a=1,param=w]"
    (k0, s0), = out[0][1].items()
    (k1, s1), = out[1][1].items()
    assert k0 == k1 and s0["n"] == s1["n"] and s0["step"] == s1["step"]


def test_flight_recorder_ring(monkeypatch):
    """MXNET_FLIGHT_RECORDER arms the ring without a full session:
    ``enabled()`` stays False (no fused-path downgrade, no scalar_due
    reads), the hot call sites feed the ring, and disarming restores the
    off state."""
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER", "4")
    assert tel._fr_autostart() is True
    try:
        assert tel._enabled and not tel.enabled()
        assert tel.flight_recorder_armed()
        assert not tel.scalar_due(0)
        for i in range(6):
            tel.record_span("step", 0.0, 0.001, cat="step", nbatch=i)
        tel.scalar("train_accuracy", 7, 0.5)
        fr = tel.flight_recorder()
        assert fr["capacity"] == 4 and fr["recorded"] == 4
        assert fr["last_step"] == {"nbatch": 5}
        assert fr["last_scalar_step"] == 7
        assert tel.events() == []     # fr-only: the ring is the only sink
    finally:
        tel._fr_disarm()
    assert not tel._enabled and tel.flight_recorder() is None
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER", "-2")
    with pytest.warns(UserWarning, match="positive integer"):
        assert tel._fr_autostart() is False


def test_spans_mirror_into_profiler(tmp_path):
    """One span stream, two sinks: chrome-trace sees telemetry spans."""
    fname = str(tmp_path / "prof.json")
    mt.profiler.set_config(mode="symbolic", filename=fname)
    mt.profiler.set_state("run")
    tel.start()
    try:
        with tel.span("shared_timeline", cat="unit"):
            pass
    finally:
        tel.stop()
        mt.profiler.set_state("stop")
    mt.profiler.dump_profile()
    with open(fname) as f:
        trace = json.load(f)
    assert any(e["name"] == "shared_timeline"
               for e in trace["traceEvents"] if e.get("ph") != "M")


def test_profiler_plus_telemetry_no_double_count(tmp_path):
    """With both sinks live, a profiler-Scoped executor region lands in the
    chrome trace once (telemetry's copy is not mirrored back)."""
    fname = str(tmp_path / "both.json")
    mt.profiler.set_config(mode="symbolic", filename=fname)
    mt.profiler.set_state("run")
    tel.start()
    try:
        ex = _small_net(mt).simple_bind(mt.cpu(), data=(2, 6),
                                        softmax_label=(2,))
        ex.forward(is_train=False,
                   data=mt.nd.array(RS(0).rand(2, 6), ctx=mt.cpu()))
    finally:
        tel.stop()
        mt.profiler.set_state("stop")
    mt.profiler.dump_profile()
    with open(fname) as f:
        trace = json.load(f)
    fwd = [e["name"] for e in trace["traceEvents"]
           if e.get("ph") != "M" and "executor.forward" in e["name"]]
    assert len(fwd) == 1, fwd
    assert any(e["type"] == "span" and e["name"] == "executor.forward"
               for e in tel.events())


def test_autostart_env(monkeypatch, tmp_path):
    fname = str(tmp_path / "auto.jsonl")
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    monkeypatch.delenv("MXTPU_PROCESS_ID", raising=False)
    assert tel._autostart() is False
    assert not tel.enabled()
    monkeypatch.setenv("MXNET_TELEMETRY", fname)
    assert tel._autostart() is True
    assert tel.enabled() and tel.sink_path() == fname
    tel.counter("autostarted")
    tel.stop()
    events = _load_jsonl(fname)
    assert any(e["type"] == "counter" and e["name"] == "autostarted"
               for e in events)
    # multi-process launch contract: each worker gets its own file
    monkeypatch.setenv("MXTPU_PROCESS_ID", "3")
    assert tel._autostart() is True
    tel.stop()
    assert os.path.exists(fname + ".rank3")


def test_autostart_in_a_fresh_process_flushes_at_exit(tmp_path):
    """MXNET_TELEMETRY set before the import records a whole process and
    writes the summary at exit."""
    fname = str(tmp_path / "proc.jsonl")
    code = ("import mxnet_tpu_torch as mt\n"
            "mt.telemetry.counter('from_child', 2)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), MXNET_TELEMETRY=fname)
    env.pop("MXTPU_PROCESS_ID", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    events = _load_jsonl(fname)
    (summary,) = [e for e in events if e["type"] == "summary"]
    assert summary["counters"] == {"from_child": 2}


def test_flush_failure_degrades_to_memory(tmp_path):
    """A sink that turns unwritable mid-run must not crash the training
    loop: file export stops with a warning, recording goes on in
    memory."""
    d = tmp_path / "sink"
    d.mkdir()
    fname = str(d / "t.jsonl")
    tel.start(fname)
    tel.counter("before")
    tel.flush()
    os.remove(fname)
    d.rmdir()
    tel.counter("after")
    with pytest.warns(UserWarning, match="unwritable"):
        tel.flush()
    assert tel.enabled()
    assert tel.value("after") == 1
    tel.stop()


def test_autostart_unwritable_path_degrades(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TELEMETRY",
                       str(tmp_path / "no-such-dir" / "t.jsonl"))
    monkeypatch.delenv("MXTPU_PROCESS_ID", raising=False)
    with pytest.warns(UserWarning, match="unwritable"):
        assert tel._autostart() is False
    assert not tel.enabled()


def test_nbytes_of():
    t = torch.zeros(3, 5, dtype=torch.float64)
    assert tel.nbytes_of(t) == 120
    assert tel.nbytes_of(mt.nd.array(np.zeros((2, 2), np.float32),
                                     ctx=mt.cpu())) == 16
    assert tel.nbytes_of(np.zeros(7, np.int16)) == 14
    assert tel.nbytes_of(object()) == 0


# ------------------------------------------------------------------ fit loop
def test_fit_smoke_step_breakdown(tmp_path):
    fname, events = _fit_smoke(tmp_path)
    spans = [e for e in events if e["type"] == "span"]
    names = {s["name"] for s in spans}
    for required in ("data_wait", "forward", "backward", "update", "metric",
                     "step", "epoch", "executor.forward",
                     "executor.backward", "exec_group.load_data"):
        assert required in names, (required, sorted(names))
    (summary,) = [e for e in events if e["type"] == "summary"]
    c = summary["counters"]
    assert c["fit_epochs"] == 2
    assert c["fit_batches"] == 4 and c["fit_samples"] == 40
    assert c["io_batches"] == 4
    assert c["param_updates"] == 16
    # per-step component spans sum to within [0.8, 1.05] of the step
    steps = {}
    for s in spans:
        tags = s.get("tags") or {}
        if s["cat"] != "step" or "nbatch" not in tags:
            continue
        key = (tags["epoch"], tags["nbatch"])
        steps.setdefault(key, {})[s["name"]] = \
            steps.setdefault(key, {}).get(s["name"], 0) + s["dur"]
    assert len(steps) == 4
    for key, comp in steps.items():
        wall = comp.pop("step")
        assert sum(comp.values()) >= 0.8 * wall, (key, comp, wall)
        assert sum(comp.values()) <= 1.05 * wall, (key, comp, wall)


def test_fit_with_kvstore_counters(tmp_path):
    _, events = _fit_smoke(tmp_path, kvstore=mt.kvstore.create("local"))
    (summary,) = [e for e in events if e["type"] == "summary"]
    c = summary["counters"]
    assert c.get("kvstore_push", 0) >= 1
    assert c.get("kvstore_pull", 0) >= 1
    assert c.get("kvstore_push_bytes", 0) > 0
    assert c.get("param_updates", 0) >= 1


def _mlp_params(seed=1):
    net = mt.models.get_mlp(num_classes=4)
    shapes, _, _ = net.infer_shape(data=(20, 1, 12, 12),
                                   softmax_label=(20,))
    rs = RS(seed)
    return {n: (rs.uniform(-1, 1, s) * np.sqrt(3.0 / max(1, np.prod(s[1:]))))
            .astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _events_fit(pkg, fused, tmp_path, tag, kvstore="local", contexts=None):
    """An MLP fit of 3 batches of 20 from the same numpy inputs and
    parameters, recorded; returns the events."""
    fname = str(tmp_path / ("%s.jsonl" % tag))
    x = RS(0).randn(60, 1, 12, 12).astype(np.float32)
    y = RS(1).randint(0, 4, 60).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=20)
    ctx = contexts or pkg.cpu()
    mod = pkg.Module(pkg.models.get_mlp(num_classes=4), context=ctx)
    params = _mlp_params()
    if pkg is mt:
        args = {n: mt.nd.array(v, ctx=mt.cpu()) for n, v in params.items()}
    else:
        args = {n: pkg.nd.array(v) for n, v in params.items()}
    env = {"MXNET_FUSED_FIT": "1" if fused else "0",
           "MXNET_TELEMETRY_FUSED": "1" if fused else "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    pkg.telemetry.start(fname)
    try:
        mod.fit(it, num_epoch=1, kvstore=kvstore, arg_params=args,
                aux_params={}, optimizer_params={"learning_rate": 0.1,
                                                 "momentum": 0.9},
                batch_end_callback=pkg.callback.Speedometer(20, 1))
    finally:
        pkg.telemetry.stop()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return _load_jsonl(fname)


def _comparable(events):
    """Events without the JAX package's sanitizer/diagnostics entries and
    its ``jit`` tag."""
    out = []
    for e in events:
        name = e.get("name")
        if name in JAX_ONLY or (name or "").startswith(JAX_ONLY_PREFIX):
            continue
        out.append(e)
    return out


def _shape_key(e):
    tags = dict(e.get("tags") or {})
    tags.pop("jit", None)
    return (e["type"], e.get("name"), e.get("cat"), tuple(sorted(tags)))


def _summary_counters(events):
    (s,) = [e for e in events if e["type"] == "summary"]
    return {k: v for k, v in s["counters"].items() if k not in JAX_ONLY}


@pytest.mark.parametrize("fused", [False, True], ids=["general", "fused"])
def test_fit_events_match_jax(mx, tmp_path, fused):
    got = _comparable(_events_fit(mt, fused, tmp_path, "port"))
    want = _comparable(_events_fit(mx, fused, tmp_path, "jax"))
    assert Counter(map(_shape_key, got)) == Counter(map(_shape_key, want))
    assert _summary_counters(got) == _summary_counters(want)
    names = {e["name"] for e in got if e["type"] == "span"}
    if fused:
        assert {"fused_step", "train_step", "metric", "step"} <= names
        assert "forward" not in names
    else:
        assert {"forward", "backward", "update", "executor.forward"} <= names
    for e in got:
        if e["type"] == "span":
            assert e["dur"] >= 0

    def series(evs):
        return [(e["name"], e["step"], e["value"]) for e in evs
                if e["type"] == "scalar"
                and e["name"].startswith(("train_", "lr"))]
    a, b = series(got), series(want)
    assert [x[:2] for x in a] == [x[:2] for x in b] and a
    for (_, _, va), (_, _, vb) in zip(a, b):
        assert abs(va - vb) <= 1e-6, (a, b)


def test_kvstore_counters_match_jax(mx, tmp_path):
    """Module over [cpu(0), cpu(1)] with a "local" store: the same
    kvstore_* and param_updates counts in both packages."""
    got = _events_fit(mt, False, tmp_path, "port", kvstore="local",
                      contexts=[mt.cpu(0), mt.cpu(1)])
    want = _events_fit(mx, False, tmp_path, "jax", kvstore="local",
                       contexts=[mx.cpu(0), mx.cpu(1)])
    cg, cw = _summary_counters(got), _summary_counters(want)
    for k in ("kvstore_push", "kvstore_push_bytes", "kvstore_pull",
              "kvstore_pull_bytes", "param_updates"):
        assert cg.get(k) == cw.get(k) and cg.get(k), (k, cg, cw)


def test_speedometer_reads_telemetry_counters(caplog):
    import logging
    from mxnet_tpu_torch.model import BatchEndParam
    tel.start()
    try:
        meter = mt.callback.Speedometer(batch_size=10, frequent=2)
        with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.callback"):
            for n in range(5):
                tel.counter("fit_samples", 10)
                tel.counter("fit_batches")
                meter(BatchEndParam(epoch=0, nbatch=n, eval_metric=None,
                                    locals={}))
    finally:
        tel.stop()
    shown = [r.getMessage() for r in caplog.records
             if "samples/s" in r.getMessage()]
    assert shown, "Speedometer never reported with telemetry active"
    steps = [e["step"] for e in tel.events()
             if e["type"] == "scalar" and e["name"] == "throughput"]
    assert steps == [2, 4], steps


def test_speedometer_stale_counter_falls_back(caplog):
    """A loop that never advances fit_samples (score()) reports the batch
    index's rate, not 0 samples/s."""
    import logging
    from mxnet_tpu_torch.model import BatchEndParam
    tel.start()
    try:
        meter = mt.callback.Speedometer(batch_size=10, frequent=2)
        with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.callback"):
            for n in range(5):
                meter(BatchEndParam(epoch=0, nbatch=n, eval_metric=None,
                                    locals={}))
    finally:
        tel.stop()
    rates = [float(r.getMessage().split()[2]) for r in caplog.records
             if "samples/s" in r.getMessage()]
    assert rates and all(r > 0 for r in rates), rates


# ----------------------------------------------------------- other sites
def test_opt_stats_against_numpy(monkeypatch):
    """grad/weight norms and the update-to-weight ratio match a numpy
    replication of the SGD step w1 = w0 - lr*rescale*g."""
    monkeypatch.setenv("MXNET_OPT_STATS", "1")
    w0 = RS(3).rand(5, 4).astype(np.float32)
    g = RS(4).rand(5, 4).astype(np.float32)
    lr, rescale = 0.25, 0.5
    opt = mt.optimizer.SGD(learning_rate=lr, rescale_grad=rescale, wd=0.0,
                           param_idx2name={0: "fc1_weight"})
    updater = mt.optimizer.get_updater(opt)
    tel.start()
    w = mt.nd.array(w0, ctx=mt.cpu())
    updater(0, mt.nd.array(g, ctx=mt.cpu()), w)
    sc = {e["name"]: e for e in tel.events() if e["type"] == "scalar"}
    w1 = w0 - lr * rescale * g
    assert sc["grad_norm"]["value"] == pytest.approx(np.linalg.norm(g),
                                                     rel=1e-5)
    assert sc["weight_norm"]["value"] == pytest.approx(np.linalg.norm(w0),
                                                       rel=1e-5)
    assert sc["update_ratio"]["value"] == pytest.approx(
        np.linalg.norm(w1 - w0) / np.linalg.norm(w0), rel=1e-4)
    assert sc["grad_norm"]["tags"] == {"param": "fc1_weight"}
    assert sc["grad_norm"]["step"] == 0
    np.testing.assert_allclose(w.asnumpy(), w1, rtol=1e-6)
    monkeypatch.setenv("MXNET_OPT_STATS", "0")
    assert not mt.optimizer.opt_stats_enabled()


def test_io_counters():
    x = RS(0).rand(40, 3).astype(np.float32)
    y = RS(1).rand(40).astype(np.float32)
    tel.start()
    it = mt.io.PrefetchingIter(mt.io.NDArrayIter(x, y, batch_size=10))
    assert len(list(it)) == 4
    dev = mt.io.DevicePrefetchIter(iter(mt.io.NDArrayIter(x, y,
                                                          batch_size=20)),
                                   stage=lambda b: b, depth=2)
    assert len(list(dev)) == 2
    c = tel.counters()
    assert c["io_prefetch_batches"] == 4
    assert c["io_device_prefetch_batches"] == 2
    assert c["io_batches"] == 6
    waits = [e for e in tel.events() if e.get("name") == "io.queue_wait"]
    assert len(waits) == 4 and all(e["cat"] == "io" for e in waits)


def test_lr_schedule_decay_scalar():
    sched = mt.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    sched.base_lr = 1.0
    tel.start()
    lrs = [sched(n) for n in range(1, 7)]
    assert lrs == [1.0, 1.0, 0.5, 0.5, 0.25, 0.25]
    pts = [(e["step"], e["value"]) for e in tel.events()
           if e["type"] == "scalar" and e["name"] == "lr"]
    assert pts == [(3, 0.5), (5, 0.25)]


def test_serving_telemetry():
    """A ServedModel tick records the JAX package's serving events."""
    net = _small_net(mt)
    shapes, _, _ = net.infer_shape(data=(1, 6), softmax_label=(1,))
    rs = RS(2)
    params = {n: rs.randn(*s).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    blob = mt.convert.params_from_numpy(params, {}, ctx=mt.cpu())
    sm = mt.serving.ServedModel(net, blob, {"data": (6,)}, name="mlp",
                                max_batch=4, dev_type="cpu")
    tel.start()
    try:
        futs = [sm.submit({"data": rs.rand(6).astype(np.float32)})
                for _ in range(3)]
        for f in futs:
            assert f.result(timeout=60)[0].shape == (4,)
    finally:
        sm.close()
        tel.stop()
    evs = tel.events()
    names = Counter(e.get("name") for e in evs)
    c = tel.counters()
    assert c["serve_requests"] == 3
    assert names["serve.queue_wait"] == 3 and names["serve.batch"] >= 1
    assert names["predict.forward"] == names["serve.batch"]
    assert all(e["tags"]["model"] == "mlp" for e in evs
               if e.get("name", "").startswith("serve"))
    assert {"serve_batch_size", "serve_queue_depth"} <= set(tel.gauges())


# -------------------------------------------------------------- report tool
def _report_mod():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", ROOT / "tools" / "telemetry_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_report_renders_breakdown(tmp_path, capsys):
    fname, _ = _fit_smoke(tmp_path)
    report = _report_mod()
    assert report.main([fname, "--steps"]) == 0
    out = capsys.readouterr().out
    assert "Step-time breakdown" in out
    assert "data_wait" in out and "forward" in out and "backward" in out
    assert "coverage" in out and "fit_samples" in out


def test_report_and_agg_run_as_scripts(tmp_path):
    """tools/telemetry_report.py and tools/telemetry_agg.py, unedited, as
    subprocesses on the port's file."""
    fname, _ = _fit_smoke(tmp_path)
    for tool, args in (("telemetry_report.py", [fname]),
                       ("telemetry_agg.py", [fname])):
        res = subprocess.run([sys.executable, str(ROOT / "tools" / tool)]
                             + args, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, (tool, res.stdout, res.stderr)
        assert "update" in res.stdout or "step" in res.stdout, res.stdout


def test_report_empty_file(tmp_path, capsys):
    fname = str(tmp_path / "empty.jsonl")
    open(fname, "w").close()
    report = _report_mod()
    assert report.main([fname]) == 0
    assert "no step spans" in capsys.readouterr().out


# ---------------------------------------------------- zero-overhead default
@pytest.mark.parametrize("fused", [False, True], ids=["general", "fused"])
def test_zero_overhead_when_disabled(tmp_path, monkeypatch, fused):
    """With every knob unset: the shared null span, no accumulation, no
    events, no new thread of the registry's, and a whole fit waits for no
    device — neither ``engine._wait`` nor ``torch.cuda.synchronize`` is
    called.  Telemetry on, the same fit waits at its spans."""
    for knob in ("MXNET_TELEMETRY", "MXNET_FLIGHT_RECORDER",
                 "MXNET_PROFILER_AUTOSTART", "MXNET_ENGINE_TYPE"):
        assert not os.environ.get(knob)
    assert not tel.enabled() and not tel._enabled
    sp = tel.span("anything", cat="x", k=1)
    assert sp is tel.span("other") is tel._NULL_SPAN
    with sp:
        sp.tags["ignored"] = True
    tel.counter("c", 5)
    tel.gauge("g", 1.0)
    tel.record_span("s", 0.0, 1.0)
    assert tel.counters() == {} and tel.gauges() == {} and tel.events() == []
    waits, syncs = [], []
    monkeypatch.setattr(mt.engine, "_wait",
                        lambda devs: waits.append(set(devs)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    monkeypatch.setenv("MXNET_FUSED_FIT", "1" if fused else "0")
    threads = {t.ident for t in threading.enumerate()}
    x = RS(0).rand(20, 6).astype(np.float32)
    y = RS(1).randint(0, 4, 20).astype(np.float32)
    mod = mt.Module(_small_net(mt), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=10), num_epoch=1,
            optimizer_params={"learning_rate": 0.1})
    assert waits == [] and syncs == []
    assert tel.counters() == {} and tel.events() == []
    # no thread outlives the fit (the fused path's device prefetcher is
    # drained at each epoch's end, with telemetry on and off alike)
    new = [t for t in threading.enumerate()
           if t.ident not in threads and t.is_alive()]
    assert new == [], new
    assert not (tmp_path / "telemetry.jsonl").exists()
    monkeypatch.setenv("MXNET_TELEMETRY_FUSED", "1")
    tel.start()
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=10), num_epoch=1,
            optimizer_params={"learning_rate": 0.1})
    tel.stop()
    assert waits and syncs == []   # host tensors: the wait needs no card


def test_fused_fit_kept_when_telemetry_off(caplog):
    """The fused path stays engaged by default (telemetry takes the
    general path only while recording, unless MXNET_TELEMETRY_FUSED=1)."""
    import logging
    x = RS(0).rand(20, 6).astype(np.float32)
    y = RS(1).randint(0, 4, 20).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=10)
    mod = mt.Module(_small_net(mt), context=mt.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1})
    assert not any("general (executor) path" in r.message
                   for r in caplog.records)
    assert mod._fused_ts_cache is not None
    tel.start()
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1})
    tel.stop()
    assert any("telemetry step breakdown" in r.message
               for r in caplog.records)
