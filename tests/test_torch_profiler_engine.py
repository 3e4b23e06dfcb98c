"""The port's profiler and engine (mxnet_tpu_torch/profiler.py,
engine.py) against mxnet_tpu's, on the CPU.

- Twins of tests/python/unittest/test_profiler_engine.py: executor events
  in the chrome trace, imperative mode, a profiled TrainStep, the
  metadata events and the drain, NaiveEngine, ``MXNET_ENGINE_TYPE``,
  ``waitall``.
- Parity: the same executor forward/backward, TrainStep step, Scope and
  imperative ops under the profiler in both packages give the same
  chrome-trace event names, categories and metadata events; an unknown
  profiler mode or state and an unknown engine type raise in both.
- The torch trace: ``set_state("stop")`` writes ``<filename>.torch.json``,
  where the ops of a step nest inside the ``train_step[n]`` and
  ``executor.forward[train]`` ranges (CPU ops here; the card's kernels on
  the H100, in chip_smoke.py's observability phase).  A second profiler
  session raises ``MXNetError``.
- NaiveEngine waits at every imperative op, forward and backward
  (``engine._wait`` counted); ``MXNET_ENGINE_NOJIT`` changes nothing.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


@pytest.fixture(autouse=True)
def _profiler_off():
    yield
    if mt.profiler.is_running():
        mt.profiler.set_state("stop")
    mt.profiler._state["events"] = []
    mt.profiler.set_config()


def _small_net(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _trace(fname):
    with open(fname) as f:
        return json.load(f)["traceEvents"]


def test_profiler_records_executor_events(tmp_path):
    fname = str(tmp_path / "profile.json")
    mt.profiler.set_config(mode="symbolic", filename=fname)
    mt.profiler.set_state("run")
    try:
        ex = _small_net(mt).simple_bind(mt.cpu(), data=(4, 10),
                                        softmax_label=(4,))
        ex.forward(is_train=True,
                   data=mt.nd.array(RS(0).rand(4, 10), ctx=mt.cpu()),
                   softmax_label=mt.nd.array([0, 1, 2, 3], ctx=mt.cpu()))
        ex.backward()
    finally:
        mt.profiler.set_state("stop")
    mt.profiler.dump_profile()
    timed = [e for e in _trace(fname) if e.get("ph") != "M"]
    names = [e["name"] for e in timed]
    assert "executor.forward[train]" in names, names
    assert "executor.backward" in names, names
    assert all(e["dur"] >= 0 for e in timed)


def test_profiler_imperative_mode(tmp_path):
    fname = str(tmp_path / "imp.json")
    mt.profiler.set_config(mode="imperative", filename=fname)
    mt.profiler.set_state("run")
    try:
        a = mt.nd.ones((8, 8), ctx=mt.cpu())
        b = (a * 2 + 1).asnumpy()
        assert (b == 3).all()
    finally:
        mt.profiler.set_state("stop")
    mt.profiler.dump_profile()
    cats = {e["cat"] for e in _trace(fname) if e.get("ph") != "M"}
    assert "imperative" in cats


def _train_step(pkg, ctx_kw):
    net = _small_net(pkg)
    train = importlib.import_module(pkg.__name__ + ".train")
    ts = train.TrainStep(net, pkg.optimizer.SGD(learning_rate=0.1),
                         **ctx_kw)
    params, state, aux = ts.init({"data": (4, 10)}, {"softmax_label": (4,)})
    batch = ts.shard_batch({"data": RS(0).rand(4, 10).astype(np.float32),
                            "softmax_label": np.array([0, 1, 2, 3],
                                                      np.float32)})
    return ts, params, state, aux, batch


def test_train_step_profiled_and_torch_trace(tmp_path):
    """The chrome trace holds ``train_step[1]``; the torch trace written at
    stop holds the step's ops inside the ``train_step[1]`` range."""
    fname = str(tmp_path / "ts.json")
    mt.profiler.set_config(mode="symbolic", filename=fname)
    ts, params, state, aux, batch = _train_step(mt, {"ctx": mt.cpu()})
    mt.profiler.set_state("run")
    try:
        ts(params, state, aux, batch)
    finally:
        mt.profiler.set_state("stop")
    mt.profiler.dump_profile()
    assert any(e["name"] == "train_step[1]" for e in _trace(fname))
    torch_trace = fname + ".torch.json"
    assert os.path.exists(torch_trace)
    evs = [e for e in _trace(torch_trace) if e.get("ph") == "X"]
    (rng,) = [e for e in evs if e["name"] == "train_step[1]"]
    inside = [e for e in evs if e["name"].startswith("aten::")
              and rng["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= rng["ts"] + rng["dur"]]
    assert any(e["name"] == "aten::addmm" for e in inside), \
        sorted({e["name"] for e in inside})


def test_dump_profile_metadata_and_drain(tmp_path):
    fname = str(tmp_path / "drain.json")
    mt.profiler.set_config(mode="symbolic", filename=fname)
    mt.profiler.set_state("run")
    try:
        with mt.profiler.Scope("drain_probe", "operator"):
            pass
    finally:
        mt.profiler.set_state("stop")
    mt.profiler.dump_profile()
    first = _trace(fname)
    meta_names = {e["name"] for e in first if e.get("ph") == "M"}
    assert "process_name" in meta_names and "thread_name" in meta_names
    assert sum(1 for e in first if e["name"] == "drain_probe") == 1
    mt.profiler.dump_profile()
    assert not any(e["name"] == "drain_probe" for e in _trace(fname))


def _profiled_run(pkg, fname, ctx_kw, nd_kw):
    """An executor round, a TrainStep step, a Scope and two imperative ops
    under the profiler in ``all`` mode; the chrome trace's events."""
    pkg.profiler.set_config(mode="all", filename=fname)
    ts, params, state, aux, batch = _train_step(pkg, ctx_kw)
    ex = _small_net(pkg).simple_bind(pkg.cpu(), data=(4, 10),
                                     softmax_label=(4,))
    pkg.profiler.set_state("run")
    try:
        ex.forward(is_train=True,
                   data=pkg.nd.array(RS(0).rand(4, 10), **nd_kw),
                   softmax_label=pkg.nd.array([0, 1, 2, 3], **nd_kw))
        ex.backward()
        ex.forward(is_train=False)
        ts(params, state, aux, batch)
        with pkg.profiler.Scope("user_region", "operator"):
            a = pkg.nd.ones((3, 3), **nd_kw)
            (a + a).asnumpy()
    finally:
        pkg.profiler.set_state("stop")
    pkg.profiler.dump_profile()
    return _trace(fname)


def test_chrome_trace_matches_jax(mx, tmp_path):
    got = _profiled_run(mt, str(tmp_path / "port.json"), {"ctx": mt.cpu()},
                        {"ctx": mt.cpu()})
    want = _profiled_run(mx, str(tmp_path / "jax.json"), {}, {})
    assert [e for e in got if e.get("ph") == "M"] == \
        [e for e in want if e.get("ph") == "M"]

    def timed(evs):
        return sorted((e["name"], e["cat"]) for e in evs
                      if e.get("ph") != "M" and e["cat"] != "imperative")

    def ops(evs):
        return {e["name"] for e in evs if e.get("cat") == "imperative"}
    assert timed(got) == timed(want)
    assert ops(got) == ops(want) and {"_ones", "_plus"} <= ops(got)


def test_refusals_match_jax(mx, tmp_path):
    """An unknown profiler mode or state and an unknown engine type raise
    the package's MXNetError in both."""
    for pkg in (mt, mx):
        with pytest.raises(pkg.base.MXNetError, match="invalid profiler"):
            pkg.profiler.set_config(mode="bogus")
        with pytest.raises(pkg.base.MXNetError, match="invalid profiler"):
            pkg.profiler.set_state("pause")
        with pytest.raises(pkg.base.MXNetError, match="unknown engine"):
            pkg.engine.set_engine_type("FastEngine")


def test_second_profiler_session_raises(tmp_path):
    """Kineto runs one session at a time: set_state("run") inside another
    torch.profiler session, or twice, raises MXNetError; the profiler
    stays off."""
    mt.profiler.set_config(filename=str(tmp_path / "p.json"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(mt.MXNetError, match="already open"):
            mt.profiler.set_state("run")
    assert not mt.profiler.is_running()
    assert mt.profiler._state["torch_prof"] is None
    mt.profiler.set_state("run")
    with pytest.raises(mt.MXNetError, match="already running"):
        mt.profiler.set_state("run")
    mt.profiler.set_state("stop")
    assert os.path.exists(str(tmp_path / "p.json.torch.json"))
    mt.profiler.set_state("stop")    # stopping twice is a no-op


def test_monitor_reports_armed_step():
    """Monitor rows carry the index of the batch that was armed."""
    mon = mt.monitor.Monitor(interval=2, stat_func=lambda a: 0.0)
    seen = []
    for _ in range(4):
        mon.tic()
        mon._observe("probe", mt.nd.ones((2,), ctx=mt.cpu()))
        seen.extend((row[0], row[1]) for row in mon.toc())
    assert [s for s, name in seen if name == "probe"] == [0, 2]


def test_naive_engine_sync(monkeypatch):
    """MXNET_ENGINE_TYPE=NaiveEngine waits at every imperative op, every
    forward and every backward (the waits counted); the threaded engine
    waits at none."""
    waits = []
    monkeypatch.setattr(mt.engine, "_wait",
                        lambda devs: waits.append(set(devs)))
    old = mt.engine.engine_type()
    try:
        net = _small_net(mt)
        ex = net.simple_bind(mt.cpu(), data=(2, 10), softmax_label=(2,))
        a = mt.nd.ones((4, 4), ctx=mt.cpu())
        ex.forward(is_train=True)
        ex.backward()
        b = a + 1
        assert waits == []
        mt.engine.set_engine_type("NaiveEngine")
        assert mt.engine.is_naive()
        b = a + 1
        n_op = len(waits)
        assert n_op >= 1 and waits[-1] == {torch.device("cpu")}
        assert (b.asnumpy() == 2).all()
        out = ex.forward(is_train=True)[0]
        ex.backward()
        assert len(waits) >= n_op + 2
        assert out.shape == (2, 4)
    finally:
        mt.engine.set_engine_type(old)


def test_engine_type_env(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    mt.engine._state["type"] = None
    assert mt.engine.engine_type() == "NaiveEngine"
    mt.engine._state["type"] = None
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "BogusEngine")
    with pytest.raises(mt.MXNetError):
        mt.engine.engine_type()
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    mt.engine._state["type"] = None
    assert mt.engine.engine_type() == "ThreadedEnginePerDevice"


def test_engine_nojit_changes_nothing(monkeypatch):
    """MXNET_ENGINE_NOJIT=1 (op-by-op dispatch in the JAX package) is what
    the port always does: the same results."""
    x = mt.nd.array(RS(0).rand(3, 4), ctx=mt.cpu())
    want = mt.nd.exp(x).asnumpy()
    monkeypatch.setenv("MXNET_ENGINE_NOJIT", "1")
    old = mt.engine.engine_type()
    try:
        mt.engine.set_engine_type("NaiveEngine")
        np.testing.assert_array_equal(mt.nd.exp(x).asnumpy(), want)
    finally:
        mt.engine.set_engine_type(old)


def test_waitall(monkeypatch):
    """waitall and engine.wait_all wait through the engine (no card here:
    nothing to wait for)."""
    waits = []
    monkeypatch.setattr(mt.engine, "_wait",
                        lambda devs: waits.append(list(devs)))
    a = mt.nd.ones((2, 2), ctx=mt.cpu())
    mt.nd.waitall()
    mt.engine.wait_all()
    assert (a.asnumpy() == 1).all()
    if not torch.cuda.is_available():
        assert waits == []
