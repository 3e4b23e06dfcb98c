"""The port's cost arithmetic and model-FLOP count (mxnet_tpu_torch/cost.py)
against mxnet_tpu's, on the CPU.

- Twins of the first three tests of tests/python/unittest/test_cost.py
  (the rate grammar, the env precedence, mfu / ridge / verdict) and of its
  two fused-fit MFU tests (the gauges with peaks set, none without).
- Parity: ``_parse_rate``, ``resolve_peaks``, ``mfu``, ``ridge`` and
  ``verdict`` over a grid of inputs give the JAX package's values; the
  device table has one row, the H100's (its name matched as
  ``torch.cuda.get_device_name`` gives it, monkeypatched here).
- ``graph_flops``: each counted op against its formula, and a small
  ResNet's ``step_flops`` the same with ``MXNET_NORM_CONV`` at 0 and at 1
  (NormConv's plain version runs on the CPU) and within 0.5-2.0 of the JAX
  package's ``step_flops()`` (XLA's cost analysis of the compiled step,
  cost attribution armed).
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import cost
from mxnet_tpu_torch import telemetry as tel
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
RATES = (None, "", "fast", "-3T", "0", "T", "275e12", "275T", "1228G",
         " 1.5p ", "819000M", "100M", "3k", "989T")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """The resolved peak pair is cached module-global; telemetry is
    process-global."""
    monkeypatch.delenv("MXNET_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MXNET_PEAK_BW", raising=False)
    cost._cache = None
    tel.stop()
    tel.reset()
    yield
    tel.stop()
    tel.reset()
    cost._cache = None


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    from mxnet_tpu import cost as jcost
    jcost._cache = None
    yield mx
    jcost._cache = None


# ------------------------------------------------------------- roofline peaks
def test_parse_rate_grammar():
    assert cost._parse_rate("275e12") == pytest.approx(275e12)
    assert cost._parse_rate("275T") == pytest.approx(275e12)
    assert cost._parse_rate("1228G") == pytest.approx(1228e9)
    assert cost._parse_rate(" 1.5p ") == pytest.approx(1.5e15)
    assert cost._parse_rate("819000M") == pytest.approx(819e9)
    for junk in (None, "", "fast", "-3T", "0", "T"):
        assert cost._parse_rate(junk) is None


def test_resolve_peaks_env_precedence(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the no-peak case needs a host without a card")
    assert cost.resolve_peaks(refresh=True) == (None, None)
    assert not cost.enabled()
    assert cost.mfu(1e9, 0.1) is None
    assert cost.ridge() is None
    assert cost.verdict(10.0) is None
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "100G")
    assert cost.resolve_peaks(refresh=True) == (pytest.approx(100e9), None)
    assert cost.enabled()
    assert cost.ridge() is None
    monkeypatch.setenv("MXNET_PEAK_BW", "10G")
    assert cost.resolve_peaks(refresh=True) == (
        pytest.approx(100e9), pytest.approx(10e9))
    # cached until refresh
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "200G")
    assert cost.resolve_peaks()[0] == pytest.approx(100e9)
    assert cost.resolve_peaks(refresh=True)[0] == pytest.approx(200e9)


def test_mfu_ridge_verdict(monkeypatch):
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "100G")
    monkeypatch.setenv("MXNET_PEAK_BW", "10G")
    cost.resolve_peaks(refresh=True)
    assert cost.mfu(50e9, 1.0) == pytest.approx(0.5)
    assert cost.mfu(0, 1.0) is None
    assert cost.mfu(50e9, 0.0) is None
    assert cost.ridge() == pytest.approx(10.0)
    assert cost.verdict(10.0) == "compute-bound"
    assert cost.verdict(9.99) == "memory-bound"
    assert cost.verdict(None) is None


def test_cost_matches_jax_on_a_grid(mx, monkeypatch):
    jcost = importlib.import_module("mxnet_tpu.cost")
    for raw in RATES:
        assert cost._parse_rate(raw) == jcost._parse_rate(raw), raw
    cases = [(f, b) for f in RATES[6:] for b in (None, "1228G", "3.35T")]
    for flops, bw in cases:
        for k, v in (("MXNET_PEAK_FLOPS", flops), ("MXNET_PEAK_BW", bw)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        got = cost.resolve_peaks(refresh=True)
        want = jcost.resolve_peaks(refresh=True)
        assert got == want, (flops, bw)
        for fl, sec in ((1e12, 0.5), (3.3e9, 1e-3), (0, 1.0), (1e9, 0)):
            assert cost.mfu(fl, sec) == jcost.mfu(fl, sec)
        assert cost.ridge() == jcost.ridge()
        for inten in (None, 0.5, 80.0, 400.0):
            assert cost.verdict(inten) == jcost.verdict(inten)


def test_device_table_has_the_h100_row(monkeypatch):
    """One row, the H100's data-sheet peaks (989 TFLOP/s dense bf16, 3.35
    TB/s), matched in the card's name; another card resolves nothing."""
    assert [r[0] for r in cost.DEVICE_PEAKS] == ["h100"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
                       ("NVIDIA A100-SXM4-80GB", (None, None))):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, n=name: n)
        assert cost.resolve_peaks(refresh=True) == want
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("MXNET_PEAK_BW", "1T")
    assert cost.resolve_peaks(refresh=True) == (989e12, 1e12)


# ----------------------------------------------------------- model FLOPs
def test_graph_flops_formulas():
    v = mt.sym.Variable
    # a 3x3 pad-1 conv on 5x5: per axis 13 of the 15 taps are in bounds
    conv = mt.sym.Convolution(v("data"), kernel=(3, 3), pad=(1, 1),
                              num_filter=4, no_bias=True, name="c")
    assert cost.graph_flops(conv, {"data": (2, 3, 5, 5)}, False) == \
        2 * 2 * 13 * 13 * 3 * 4
    assert cost.graph_flops(conv, {"data": (2, 3, 5, 5)}) == \
        3 * 2 * 2 * 13 * 13 * 3 * 4
    grouped = mt.sym.Convolution(v("data"), kernel=(1, 1), stride=(2, 2),
                                 num_filter=6, num_group=3, name="g")
    assert cost.graph_flops(grouped, {"data": (1, 6, 4, 4)}, False) == \
        2 * 1 * 2 * 2 * 2 * 6
    fc = mt.sym.FullyConnected(v("data"), num_hidden=7, name="fc")
    assert cost.graph_flops(fc, {"data": (3, 2, 5)}, False) == 2 * 3 * 10 * 7
    dot = mt.sym.dot(v("a"), v("b"), transpose_b=True)
    assert cost.graph_flops(dot, {"a": (4, 6), "b": (5, 6)}, False) == \
        2 * 4 * 6 * 5
    bdot = mt.sym.batch_dot(v("a"), v("b"))
    assert cost.graph_flops(bdot, {"a": (3, 4, 6), "b": (3, 6, 5)},
                            False) == 2 * 3 * 4 * 6 * 5
    att = mt.sym.dot_product_attention(v("q"), v("k"), v("v"), causal=True)
    shp = {"q": (2, 3, 8, 4), "k": (2, 3, 8, 4), "v": (2, 3, 8, 4)}
    assert cost.graph_flops(att, shp, False) == 2 * 2 * (2 * 3 * 4 * 36)
    rnn = mt.sym.RNN(v("data"), v("p"), v("s"), v("c"), state_size=5,
                     num_layers=2, mode="lstm", bidirectional=True)
    macs = 2 * 7 * 3 * 4 * 5 * (6 + 5) + 2 * 7 * 3 * 4 * 5 * (10 + 5)
    assert cost.graph_flops(rnn, {"data": (7, 3, 6)}, False) == 2 * macs
    act = mt.sym.Activation(v("data"), act_type="relu")
    assert cost.graph_flops(act, {"data": (2, 2)}) == 0
    assert cost.graph_flops(fc, {}) is None


def _small_resnet(pkg):
    models = importlib.import_module(pkg.__name__ + ".models.resnet")
    return models.get_symbol(10, 8, "3,16,16")


def test_step_flops_independent_of_norm_conv_and_near_jax(mx, monkeypatch):
    shapes = ({"data": (2, 3, 16, 16)}, {"softmax_label": (2,)})
    batch = {"data": RS(0).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32),
             "softmax_label": np.array([1.0, 7.0], np.float32)}
    nc = mt.ops.norm_conv
    ref = nc.norm_conv_ref
    plain = []
    monkeypatch.setattr(nc, "norm_conv_ref",
                        lambda *a, **k: plain.append(1) or ref(*a, **k))
    counts = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("MXNET_NORM_CONV", flag)
        del plain[:]
        ts = mt.TrainStep(_small_resnet(mt),
                          mt.optimizer.SGD(learning_rate=0.1), ctx=mt.cpu())
        assert ts.step_flops() is None
        p, s, a = ts.init(*shapes)
        ts(p, s, a, batch)
        counts[flag] = ts.step_flops()
        # NormConv's plain version ran only with the peephole on
        assert bool(plain) == (flag == "1")
    assert counts["0"] == counts["1"] > 0
    san = importlib.import_module("mxnet_tpu.sanitize")
    train = importlib.import_module("mxnet_tpu.train")
    monkeypatch.setenv("MXNET_NORM_CONV", "0")
    san.cost_arm()
    try:
        jts = train.TrainStep(_small_resnet(mx),
                              mx.optimizer.SGD(learning_rate=0.1))
        p, s, a = jts.init(*shapes)
        jts(p, s, a, jts.shard_batch(batch))
        want = jts.step_flops()
    finally:
        san.cost_disarm()
    assert want, "the JAX package's cost attribution captured nothing"
    print("step_flops port %d, JAX package (XLA cost analysis) %d"
          % (counts["0"], want))
    assert 0.5 <= counts["0"] / want <= 2.0, (counts["0"], want)


# --------------------------------------------------- fused fit: MFU end-to-end
def _fit(num_epoch=2, n=32):
    x = RS(0).rand(n, 6).astype(np.float32)
    y = RS(1).randint(0, 4, n).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=8)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=8, name="fc1"), name="softmax")
    mod = mt.Module(net, context=mt.cpu())
    mod.fit(it, num_epoch=num_epoch, optimizer_params={"learning_rate": 0.1})
    return mod, net


def test_fused_fit_mfu_gauges(monkeypatch):
    """With a peak set, the fused fit under telemetry emits model_flops
    (the graph's count), achieved_flops and mfu in (0, 1)."""
    monkeypatch.setenv("MXNET_TELEMETRY_FUSED", "1")
    # a peak scaled to the toy model so its MFU lands in (0, 1) at the
    # gauge's 4 decimals
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "100M")
    monkeypatch.setenv("MXNET_PEAK_BW", "100G")
    cost.resolve_peaks(refresh=True)
    tel.start()
    mod, net = _fit()
    tel.stop()
    assert mod._fused_ts_cache is not None
    g = tel.gauges()
    want = cost.graph_flops(net, {"data": (8, 6), "softmax_label": (8,)})
    assert want == 3 * 2 * 8 * 6 * 8
    assert g["model_flops"] == want
    assert 0 < g["mfu"] < 1 and g["achieved_flops"] > 0
    assert sum(1 for e in tel.events() if e.get("name") == "mfu") == 8
    assert sum(1 for e in tel.events() if e.get("name") == "fused_step") == 8


def test_fused_fit_without_peaks_stays_dark(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card resolves its row")
    monkeypatch.setenv("MXNET_TELEMETRY_FUSED", "1")
    cost.resolve_peaks(refresh=True)
    tel.start()
    _fit(num_epoch=1, n=16)
    tel.stop()
    assert "mfu" not in tel.gauges() and "model_flops" not in tel.gauges()
