"""The metrics of mxnet_tpu_torch (``metric``) against mxnet_tpu's, on the
same inputs: every case of tests/python/unittest/test_metric.py (each
metric's value checked against its formula there), here run through both
packages and required to give the same names and values (within 1e-6:
the host metrics compute in float64 numpy from the same float32 arrays,
``Accuracy`` counts integers).  ``Accuracy`` reduces on the device: its
sum stays a tensor until ``get()``."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
TOL = 1e-6


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _both(mx, make, labels, preds):
    """(port's get(), mxnet_tpu's get()) of one update with each
    package's arrays made from the same numpy inputs."""
    out = []
    for pkg, kw in ((mt, {"ctx": mt.cpu()}), (mx, {})):
        m = make(pkg)
        m.update([pkg.nd.array(np.asarray(x, np.float32), **kw)
                  for x in labels],
                 [pkg.nd.array(np.asarray(x, np.float32), **kw)
                  for x in preds])
        out.append(m.get())
    return out


def _check(got, want):
    gn, gv = got
    wn, wv = want
    assert gn == wn
    np.testing.assert_allclose(np.asarray(gv, np.float64),
                               np.asarray(wv, np.float64), rtol=TOL,
                               atol=TOL)


CASES = {
    # (twins of test_metric.py) name -> (make, labels, preds, formula)
    "accuracy": (lambda p: p.metric.Accuracy(), [[1, 0, 0]],
                 [[[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]]], 2.0 / 3),
    "top_k_accuracy": (lambda p: p.metric.TopKAccuracy(top_k=2), [[1, 2, 0]],
                       [[[0.1, 0.2, 0.7], [0.5, 0.4, 0.1],
                         [0.1, 0.6, 0.3]]], 1.0 / 3),
    "f1": (lambda p: p.metric.F1(), [[0, 1, 1, 1]],
           [[[0.7, 0.3], [0.2, 0.8], [0.6, 0.4], [0.1, 0.9]]], 0.8),
    "mae": (lambda p: p.metric.MAE(), [[[2.0], [2.0], [5.0]]],
            [[[1.0], [2.0], [3.0]]], 1.0),
    "mse": (lambda p: p.metric.MSE(), [[[2.0], [2.0], [5.0]]],
            [[[1.0], [2.0], [3.0]]], 5 / 3.0),
    "rmse": (lambda p: p.metric.RMSE(), [[[2.0], [2.0], [5.0]]],
             [[[1.0], [2.0], [3.0]]], np.sqrt(5 / 3.0)),
    "cross_entropy": (lambda p: p.metric.CrossEntropy(), [[1, 0]],
                      [[[0.2, 0.8], [0.9, 0.1]]],
                      -(np.log(0.8) + np.log(0.9)) / 2),
    "perplexity": (lambda p: p.metric.Perplexity(ignore_label=None), [[1, 0]],
                   [[[0.25, 0.75], [0.5, 0.5]]],
                   np.exp(-(np.log(0.75) + np.log(0.5)) / 2)),
    "perplexity_ignore": (lambda p: p.metric.Perplexity(ignore_label=0),
                          [[1, 0, 1]],
                          [[[0.25, 0.75], [0.5, 0.5], [0.4, 0.6]]],
                          np.exp(-(np.log(0.75) + np.log(0.6)) / 2)),
    "custom": (lambda p: p.metric.CustomMetric(
        lambda label, pred: float(np.abs(label - pred.argmax(axis=1))
                                  .mean()), name="mymetric"),
        [[0, 0]], [[[0.1, 0.9], [0.8, 0.2]]], 0.5),
    "np": (lambda p: p.metric.np(
        lambda label, pred: float((label == 0).mean())),
        [[0, 1]], [[[1.0], [1.0]]], 0.5),
    "loss": (lambda p: p.metric.Loss(), [[0, 0]], [[[1.5], [2.5]]], 2.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_mxnet_tpu(mx, name):
    make, labels, preds, formula = CASES[name]
    got, want = _both(mx, make, labels, preds)
    _check(got, want)
    assert abs(got[1] - formula) < 1e-5


def test_composite(mx):
    """(twin) two children fed by one update."""
    got, want = _both(
        mx, lambda p: p.metric.CompositeEvalMetric(
            metrics=[p.metric.Accuracy(), p.metric.MSE()]),
        [[1, 1]], [[[0.1, 0.9], [0.8, 0.2]]])
    _check(got, want)
    assert len(got[0]) == 2


def test_create_by_name(mx):
    """(twin) every name both packages register makes the same metric, a
    list a composite, a callable a CustomMetric; an unknown name raises."""
    for name in ["acc", "accuracy", "ce", "f1", "mae", "mse", "rmse",
                 "loss", "torch"]:
        got, want = mt.metric.create(name), mx.metric.create(name)
        assert type(got).__name__ == type(want).__name__, name
        assert got.name == want.name, name
    assert mt.metric.create("top_k_acc", top_k=3).name == \
        mx.metric.create("top_k_acc", top_k=3).name
    comp = mt.metric.create(["acc", "mse"])
    assert isinstance(comp, mt.metric.CompositeEvalMetric)
    assert isinstance(mt.metric.create(lambda label, pred: 0.0),
                      mt.metric.CustomMetric)
    with pytest.raises(mt.MXNetError):
        mt.metric.create("nope_metric")


def test_reset_and_running_average(mx):
    """(twin) the running average over two updates, then reset: NaN with
    no instances."""
    vals = []
    for pkg, kw in ((mt, {"ctx": mt.cpu()}), (mx, {})):
        m = pkg.metric.Accuracy()
        m.update([pkg.nd.array([1], **kw)], [pkg.nd.array([[0.0, 1.0]],
                                                          **kw)])
        first = m.get()[1]
        m.update([pkg.nd.array([0], **kw)], [pkg.nd.array([[0.0, 1.0]],
                                                          **kw)])
        second = m.get()[1]
        m.reset()
        vals.append((first, second, m.num_inst, np.isnan(m.get()[1])))
    assert vals[0] == vals[1] == (1.0, 0.5, 0, True)


def test_accuracy_stays_on_the_device(mx):
    """Accuracy over several batches on one device keeps its sum a tensor
    there (no host value in the batch loop: ``num_inst`` grows from
    shapes), and equals mxnet_tpu's over the same batches, also with
    predictions already reduced to class ids and labels as class ids in
    another dtype."""
    rng = RS(4)
    m = mt.metric.Accuracy()
    want = mx.metric.Accuracy()
    for _ in range(3):
        p = rng.rand(16, 5).astype(np.float32)
        y = rng.randint(0, 5, 16).astype(np.float32)
        m.update([mt.nd.array(y, ctx=mt.cpu())],
                 [mt.nd.array(p, ctx=mt.cpu())])
        want.update([mx.nd.array(y)], [mx.nd.array(p)])
        assert isinstance(m.sum_metric, torch.Tensor)
        assert m.sum_metric.dtype == torch.int64
    ids = rng.randint(0, 5, 16)
    m.update([mt.nd.array(ids.astype(np.int32), ctx=mt.cpu())],
             [mt.nd.array(ids.astype(np.float32), ctx=mt.cpu())])
    want.update([mx.nd.array(ids.astype(np.int32))],
                [mx.nd.array(ids.astype(np.float32))])
    assert m.num_inst == want.num_inst == 64
    assert m.get() == want.get()
    with pytest.raises(ValueError):
        m.update([mt.nd.array(np.zeros(3), ctx=mt.cpu())],
                 [mt.nd.array(np.zeros((4, 2)), ctx=mt.cpu())])
