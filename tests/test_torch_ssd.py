"""The SSD slice (models/ssd.py) of mxnet_tpu_torch against mxnet_tpu's, on
the CPU.

- The twin of tests/python/unittest/test_ssd.py: the training symbol binds
  through ``Module``, takes a forward, backward and update, and the
  detection symbol emits (1, 1344, 6).
- One executor step of ``get_symbol_train`` in float64 (``type_dict`` over
  every argument; the JAX package with x64 on) from the same ``.params``
  file in both packages: the three outputs, every gradient, and every
  parameter after one SGD-momentum ``Updater`` step, within STEP_TOL of the
  largest entry.  At batch 2, with three ground-truth boxes, the targets
  hold 25 positives, 75 mined negatives and 2,588 ignored anchors.
- ``Module.fit``, 2 epochs of 3 batches of 2, float32, SGD-momentum, from
  the same parameters: the first batch's targets equal, every parameter
  within FLOOR_X times its float32 floor (the JAX package's fit against
  its fit from parameters nudged by NUDGE), the rule of test_torch_module.py.
- The detection symbol from the same parameters in float64: kept ids equal
  and the rest within STEP_TOL.
- ``bench/ssd_train.py`` at toy size on the host.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench import ssd_train
from mxnet_tpu_torch.models import ssd as pssd
from test_torch_threads import torch_threads_per_worker  # noqa: F401

STEP_TOL = 1e-9
FLOOR_X = 4.0
FLOOR_MIN = 1e-6
NUDGE = 2.0 ** -20
CLASSES = 3
SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 5e-4}


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.models.ssd  # noqa: F401
    return mx


@pytest.fixture
def mx64(mx):
    """mxnet_tpu with 64-bit mode on for the test."""
    import jax
    jax.config.update("jax_enable_x64", True)
    yield mx
    jax.config.update("jax_enable_x64", False)


def _labels(b):
    label = np.full((b, 4, 5), -1.0, np.float32)
    label[0, 0] = [1, 0.2, 0.2, 0.6, 0.6]
    label[1, 0] = [0, 0.1, 0.3, 0.5, 0.8]
    label[1, 1] = [2, 0.5, 0.05, 0.95, 0.4]
    return label


def _params(net, seed=1, nudge=0.0, batch=2):
    """Numpy parameters: uniform in +-sqrt(3 / fan-in), biases 0.05 x
    uniform, each times 1 + u * ``nudge``."""
    shapes = {"data": (batch, 3, 64, 64), "label": (batch, 4, 5)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    out = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        scale = np.sqrt(3.0 / np.prod(s[1:])) if len(s) > 1 else 0.05
        v = rs.uniform(-1, 1, s) * scale
        out[n] = v * (1 + nudge * rs.uniform(-1, 1, s))
    return out


def test_ssd_train_step_and_detection():
    """Twin of test_ssd.py::test_ssd_train_step_and_detection."""
    net = pssd.get_symbol_train(num_classes=CLASSES)
    b = 2
    rs = np.random.RandomState(0)
    data = rs.rand(b, 3, 64, 64).astype(np.float32)
    label = np.full((b, 4, 5), -1.0, np.float32)
    label[0, 0] = [1, 0.2, 0.2, 0.6, 0.6]
    label[1, 0] = [0, 0.1, 0.3, 0.5, 0.8]
    mod = mt.Module(net, data_names=("data",), label_names=("label",),
                    context=mt.cpu())
    it = mt.io.NDArrayIter({"data": data}, {"label": label}, batch_size=b)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01})
    batch = next(iter(it))
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    outs = mod.get_outputs()
    assert outs[0].shape == (b, 4, 1344)      # cls_prob
    assert outs[1].shape == (b, 1344 * 4)     # loc loss
    assert np.isfinite(outs[1].asnumpy()).all()

    det = pssd.get_symbol(num_classes=CLASSES)
    ex = det.simple_bind(mt.cpu(), data=(1, 3, 64, 64))
    out = ex.forward(is_train=False)
    assert out[0].shape == (1, 1344, 6)


def _step(pkg, net, params_file, data, label, dtype):
    """(outputs, {name: gradient}, {name: parameter after one SGD-momentum
    Updater step}) of one executor step, every argument at ``dtype``."""
    b = data.shape[0]
    ex = net.simple_bind(pkg.cpu(), grad_req="write",
                         type_dict={n: dtype for n in net.list_arguments()},
                         data=data.shape, label=label.shape)
    loaded = pkg.nd.load(params_file, **({"ctx": mt.cpu()} if pkg is mt
                                         else {}))
    ex.copy_params_from({k[4:]: v for k, v in loaded.items()}, {})
    ex.arg_dict["data"][:] = data.astype(dtype)
    ex.arg_dict["label"][:] = label.astype(dtype)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward()
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
             if n not in ("data", "label")}
    upd = pkg.optimizer.get_updater(pkg.optimizer.SGD(
        rescale_grad=1.0 / b, **SGD))
    names = [n for n in net.list_arguments() if n not in ("data", "label")]
    for i, n in enumerate(names):
        upd(i, ex.grad_dict[n], ex.arg_dict[n])
    return outs, grads, {n: ex.arg_dict[n].asnumpy() for n in names}


def _close(got, want, what, tol=STEP_TOL):
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        (what, np.abs(got - want).max() / scale)


def test_train_step_matches_mxnet_tpu_float64(mx64, tmp_path):
    """One executor step of get_symbol_train in float64 from one .params
    file: outputs, gradients and updated parameters within STEP_TOL."""
    mx = mx64
    net_t = pssd.get_symbol_train(num_classes=CLASSES)
    net_j = mx.models.ssd.get_symbol_train(num_classes=CLASSES)
    params = _params(net_t)
    f = str(tmp_path / "ssd.params")
    mt.nd.save(f, {"arg:" + k: mt.nd.array(v, ctx=mt.cpu(),
                                            dtype=np.float64)
                   for k, v in params.items()})
    data = np.random.RandomState(0).rand(2, 3, 64, 64)
    label = _labels(2).astype(np.float64)
    got = _step(mt, net_t, f, data, label, np.float64)
    want = _step(mx, net_j, f, data, label, np.float64)
    cls_t = want[0][2]
    assert got[0][0].dtype == np.float64
    # three ground-truth boxes over two images: 25 positives, 3 x 25 mined
    # negatives, the rest ignored
    assert ((cls_t > 0).sum(), (cls_t == 0).sum(), (cls_t < 0).sum()) \
        == (25, 75, 2588)
    np.testing.assert_array_equal(got[0][2], cls_t)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, "output %d" % i)
    assert sorted(got[1]) == sorted(want[1])
    for n in want[1]:
        _close(got[1][n], want[1][n], "grad " + n)
        _close(got[2][n], want[2][n], "param " + n)


def _fit(pkg, params):
    """(Module, {name: parameter}, the first batch's cls_target) after
    2 epochs of 3 batches of 2 of the example's synthetic data."""
    it = _iter(pkg)
    net = (pssd if pkg is mt else pkg.models.ssd).get_symbol_train(
        num_classes=CLASSES)
    mod = pkg.Module(net, data_names=("data",), label_names=("label",),
                     context=pkg.cpu())
    first = []

    def keep_first(param):
        if not first:
            first.append(mod.get_outputs()[2].asnumpy())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params=dict(SGD),
            eval_metric=pkg.metric.Loss(),
            arg_params={k: pkg.nd.array(v.astype(np.float32),
                                        ctx=pkg.cpu())
                        for k, v in params.items()}, aux_params={},
            batch_end_callback=keep_first)
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}, first[0]


def _iter(pkg):
    """Three batches of 2 of the example's synthetic data, as NDArrayIter."""
    d, lab = ssd_train.synthetic_detection_batch(np.random.RandomState(0),
                                                 6, CLASSES)
    return pkg.io.NDArrayIter({"data": d}, {"label": lab}, batch_size=2)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_fit_matches_mxnet_tpu(mx):
    """Module.fit in float32 on the fused path: the first batch's targets
    equal, every parameter within FLOOR_X times its float32 floor."""
    net = pssd.get_symbol_train(num_classes=CLASSES)
    params = _params(net)
    mod, got, got_t = _fit(mt, params)
    assert mod._fused_ts_cache is not None
    _, want, want_t = _fit(mx, params)
    _, nudged, _ = _fit(mx, _params(net, nudge=NUDGE))
    np.testing.assert_array_equal(got_t, want_t)
    assert sorted(got) == sorted(want)
    for k in want:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, \
            (k, _rel(got[k], want[k]), floor)


def test_detection_matches_mxnet_tpu_float64(mx64):
    """get_symbol's detections from the same parameters in float64: the
    kept ids equal, scores and boxes within STEP_TOL."""
    mx = mx64
    net = pssd.get_symbol(num_classes=CLASSES)
    params = _params(pssd.get_symbol_train(num_classes=CLASSES))
    # a background bias below the classes' makes detections to keep
    for k in ("cls_pred_0_bias", "cls_pred_1_bias", "cls_pred_2_bias"):
        params[k] = params[k].reshape(-1, CLASSES + 1) \
            + np.array([-1.0, 0.0, 0.0, 0.0])
        params[k] = params[k].reshape(-1)
    data = np.random.RandomState(0).rand(2, 3, 64, 64)
    outs = []
    for pkg, sym in ((mt, net),
                     (mx, mx.models.ssd.get_symbol(num_classes=CLASSES))):
        ex = sym.simple_bind(pkg.cpu(), type_dict={
            n: np.float64 for n in sym.list_arguments()}, data=data.shape)
        ex.copy_params_from({k: pkg.nd.array(v, ctx=pkg.cpu(),
                                             dtype=np.float64)
                             for k, v in params.items()}, {})
        outs.append(ex.forward(data=pkg.nd.array(data, ctx=pkg.cpu(),
                                                 dtype=np.float64))[0]
                    .asnumpy())
    got, want = outs
    assert got.shape == (2, 1344, 6) and got.dtype == np.float64
    kept = (want[..., 0] >= 0).sum()
    assert 0 < kept < want[..., 0].size
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    _close(got, want, "detections")


def test_ssd_train_bench_on_the_host():
    """bench/ssd_train.py at toy size: the fused fit, LocL1 per epoch, the
    detection forward on the host (no NMS launch)."""
    rec, mod, out = ssd_train.run(num_classes=CLASSES, batch_size=2,
                                  num_epochs=2, num_batches=2, ctx=mt.cpu())
    assert rec["fused_path"] and len(rec["loc_l1"]) == 2
    assert out.shape == (2, 1344, 6) and rec["nms_launches"] == 0
    assert np.isfinite(rec["loc_l1"]).all() and rec["value"] > 0
