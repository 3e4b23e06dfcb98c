"""The port's Monitor (mxnet_tpu_torch/monitor.py, ``Executor``'s monitor
callback, the fused fit's Monitor bridge) against mxnet_tpu's, on the CPU.

- Twins of the JAX package's Monitor tests (test_attr_viz.py's Module
  install, test_numerics.py's fused-path bridge and custom-stat fallback,
  test_run_compare.py's ``monitor`` scalars).
- Parity, the same numpy inputs and parameters in both packages:
  - an MLP fit of 3 batches on the general path (``MXNET_FUSED_FIT=0``)
    with ``Monitor(2)``: the rows' steps and names in the same order (every
    node output of the armed forward, then every argument), the values
    within the float32 fit's tolerance;
  - one executor forward of a small conv net in float64 (x64 on for JAX)
    with the default statistic: the same rows, each within 1e-9;
  - the fused path: parameter rows at the armed steps, each equal to the
    JAX package's within the float32 fit's tolerance, and the first
    armed step's rows equal to ‖w‖/√size of the initial parameters.
"""
import importlib
import logging
import math
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.monitor import Monitor
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
FIT_RTOL = 1e-4
FIT_ATOL = 1e-6


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.models  # noqa: F401
    return mx


@pytest.fixture
def f64(mx):
    import jax
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _capture(pkg, interval, **kw):
    rows = []

    class Capture(importlib.import_module(pkg.__name__ + ".monitor").Monitor):
        def toc_print(self):
            rows.extend(self.toc())
    return Capture(interval, **kw), rows


def _value(shown):
    return float(str(shown).strip("[] "))


def _mlp_params():
    net = mt.models.get_mlp(num_classes=4)
    shapes, _, _ = net.infer_shape(data=(20, 1, 12, 12),
                                   softmax_label=(20,))
    rs = RS(1)
    return {n: (rs.uniform(-1, 1, s) * np.sqrt(3.0 / max(1, np.prod(s[1:]))))
            .astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _fit(pkg, fused, monitor):
    x = RS(0).randn(60, 1, 12, 12).astype(np.float32)
    y = RS(1).randint(0, 4, 60).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=20)
    ctx = pkg.cpu()
    # a fresh name counter: both packages name the Flatten node alike
    with importlib.import_module(pkg.__name__ + ".name").NameManager():
        net = pkg.models.get_mlp(num_classes=4)
    mod = pkg.Module(net, context=ctx)
    kw = {"ctx": mt.cpu()} if pkg is mt else {}
    args = {n: pkg.nd.array(v, **kw) for n, v in _mlp_params().items()}
    old = os.environ.get("MXNET_FUSED_FIT")
    os.environ["MXNET_FUSED_FIT"] = "1" if fused else "0"
    try:
        mod.fit(it, num_epoch=1, arg_params=args, aux_params={},
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                monitor=monitor)
    finally:
        if old is None:
            os.environ.pop("MXNET_FUSED_FIT", None)
        else:
            os.environ["MXNET_FUSED_FIT"] = old
    return mod


def _same_rows(got, want, rtol, atol):
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    for (_, n, a), (_, _, b) in zip(got, want):
        va, vb = _value(a), _value(b)
        assert abs(va - vb) <= atol + rtol * abs(vb), (n, va, vb)


def test_monitor_module_install():
    """Monitor through Module.fit collects per-op stats from the one real
    forward; a Monitor installed on a bare executor sees the same nodes."""
    x = RS(0).rand(20, 6).astype(np.float32)
    y = RS(1).randint(0, 3, 20).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=10)
    net = mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                              name="fc"), name="softmax")
    mon = Monitor(1, stat_func=lambda d: mt.nd.norm(d), pattern=".*fc.*")
    mod = mt.Module(net, context=mt.cpu())
    mod.fit(it, num_epoch=1, monitor=mon,
            optimizer_params={"learning_rate": 0.1})
    assert mod._fused_ts_cache is None     # a custom stat: general path
    ex = net.simple_bind(mt.cpu(), data=(10, 6), softmax_label=(10,))
    mon2 = Monitor(1, stat_func=lambda d: mt.nd.norm(d), pattern=".*fc.*")
    mon2.install(ex)
    mon2.tic()
    ex.forward(is_train=True, data=mt.nd.array(x[:10], ctx=mt.cpu()),
               softmax_label=mt.nd.array(y[:10], ctx=mt.cpu()))
    names = [t[1] for t in mon2.toc()]
    assert names == ["fc_output", "fc_weight", "fc_bias"], names
    # removed: the next forward streams nothing
    ex.set_monitor_callback(None)
    mon2.tic()
    ex.forward(is_train=False)
    assert [t[1] for t in mon2.toc()] == ["fc_weight", "fc_bias"]


def test_general_path_rows_match_jax(mx):
    mon, got = _capture(mt, 2)
    jmon, want = _capture(mx, 2)
    mod = _fit(mt, False, mon)
    _fit(mx, False, jmon)
    assert mod._fused_ts_cache is None
    assert got and sorted({s for s, _, _ in got}) == [0, 2]
    names = [n for s, n, _ in got if s == 0]
    assert "fc1_output" in names and "softmax_output" in names \
        and "fc3_bias" in names and "data" in names
    _same_rows(got, want, FIT_RTOL, FIT_ATOL)


def test_monitor_stats_f64_match_jax(mx, f64):
    """One float64 forward of a conv net (Convolution, BatchNorm, ReLU,
    Pooling, FullyConnected: the layout pass and the fused BatchNorm+ReLU
    peephole in the unmonitored walk) with the default RMS statistic:
    every row within 1e-9 of the JAX package's."""
    rows = []
    for pkg in (mt, mx):
        v = pkg.sym.Variable
        net = pkg.sym.Convolution(v("data"), kernel=(3, 3), pad=(1, 1),
                                  num_filter=4, name="conv")
        net = pkg.sym.BatchNorm(net, fix_gamma=False, name="bn")
        net = pkg.sym.Activation(net, act_type="relu", name="relu")
        net = pkg.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                              pool_type="max", name="pool")
        net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc")
        net = pkg.sym.SoftmaxOutput(net, name="softmax")
        shapes = {"data": (2, 2, 6, 6), "softmax_label": (2,)}
        types = {n: np.float64 for n in net.list_arguments()}
        ex = net.simple_bind(pkg.cpu(), type_dict=types, **shapes)
        arg_shapes, _, _ = net.infer_shape(**shapes)
        rs = RS(4)
        for n, s in zip(net.list_arguments(), arg_shapes):
            ex.arg_dict[n][:] = rs.uniform(-1, 1, s) if n != "softmax_label" \
                else np.array([0.0, 2.0])
        mon = importlib.import_module(pkg.__name__ + ".monitor").Monitor(1)
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=True)
        rows.append(mon.toc())
    got, want = rows
    assert [n for _, n, _ in got][:6] == ["bn_output", "conv_output",
                                          "fc_output", "pool_output",
                                          "relu_output", "softmax_output"]
    _same_rows(got, want, 0.0, 1e-9)


def test_fused_path_rows_match_jax(mx, caplog):
    mon, got = _capture(mt, 2)
    jmon, want = _capture(mx, 2)
    with caplog.at_level(logging.INFO):
        mod = _fit(mt, True, mon)
    _fit(mx, True, jmon)
    assert mod._fused_ts_cache is not None
    assert any("Monitor served from the fused step" in r.getMessage()
               for r in caplog.records)
    params = _mlp_params()
    assert [(s, n) for s, n, _ in got] == \
        [(s, n) for s in (0, 2) for n in sorted(params)]
    for s, n, shown in got:
        assert math.isfinite(_value(shown))
        if s == 0:
            w = params[n].astype(np.float64)
            rms = np.sqrt((w * w).sum()) / math.sqrt(w.size)
            assert abs(_value(shown) - rms) <= 1e-6 * rms, (n, shown, rms)
    _same_rows(got, want, FIT_RTOL, FIT_ATOL)


def test_custom_stat_func_falls_back(caplog):
    with caplog.at_level(logging.INFO):
        mod = _fit(mt, True, Monitor(1, stat_func=lambda x: 0.0))
    assert mod._fused_ts_cache is None
    assert any("custom stat_func" in r.getMessage() for r in caplog.records)


def test_monitor_stats_flow_to_scalars():
    """Per-tensor Monitor stats become a plottable ``monitor`` series."""
    tel = mt.telemetry
    tel.start()
    try:
        _fit(mt, False, Monitor(interval=2, pattern=".*weight"))
    finally:
        tel.stop()
    sc = [e for e in tel.events() if e["type"] == "scalar"
          and e["name"] == "monitor"]
    tel.reset()
    keys = {e["tags"]["tensor"] for e in sc}
    assert {"fc1_weight", "fc2_weight", "fc3_weight"} <= keys, keys
    assert sorted({e["step"] for e in sc}) == [0, 2]


def test_sort_pattern_and_tic_interval():
    mon = Monitor(3, stat_func=lambda a: 1.0, pattern="^b", sort=True)
    seen = []
    for _ in range(7):
        mon.tic()
        for name in ("bz", "a", "ba"):
            mon._observe(name, mt.nd.ones((1,), ctx=mt.cpu()))
        seen.append(mon.toc())
    assert [[(s, n) for s, n, _ in rows] for rows in seen] == [
        [(0, "ba"), (0, "bz")], [], [], [(3, "ba"), (3, "bz")], [], [],
        [(6, "ba"), (6, "bz")]]
