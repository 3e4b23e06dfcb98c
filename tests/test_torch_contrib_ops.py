"""The SSD slice's operators of mxnet_tpu_torch (ops/contrib.py: MultiBoxPrior,
MultiBoxTarget, MultiBoxDetection; ops/nn.py: SoftmaxActivation) against
mxnet_tpu's, on the CPU.

- Twins of the seven MultiBox cases of
  tests/python/unittest/test_contrib_ops.py (:8-102), through ``mt.nd``.
- Parity with the JAX package on seeded random inputs: a 4x6 map's priors
  (bit for bit: the port multiplies by the float32 reciprocal of the map
  size, as XLA compiles the JAX package's division); targets with label
  width 4 and padding rows, an image without ground truth, hard-negative
  mining on and off; detections with ``force_suppress`` on and off,
  ``clip`` off and a nonzero ``background_id``.  Targets and kept ids
  exact; boxes and offsets within F32_TOL of the largest entry in
  float32, and F64_TOL in float64 with the JAX package's x64 mode on.
- Tied scores: negatives mined among equal scores and detections of equal
  scores take the same rows as the JAX package's stable argsort.
- SoftmaxActivation in both modes, forward and gradient.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

F32_TOL = 1e-6
F64_TOL = 1e-12
CPU = mt.cpu()


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


@pytest.fixture
def mx64(mx):
    """mxnet_tpu with 64-bit mode on for the test."""
    import jax
    jax.config.update("jax_enable_x64", True)
    yield mx
    jax.config.update("jax_enable_x64", False)


def _nd(pkg, a, dtype=None):
    if pkg is mt:
        return mt.nd.array(a, ctx=CPU, dtype=dtype or a.dtype)
    return pkg.nd.array(a, dtype=dtype or a.dtype)


# ------------------------------------------------ twins of test_contrib_ops.py
def test_multibox_prior_counts_and_first_box():
    data = mt.nd.zeros((1, 3, 4, 6), ctx=CPU)
    out = mt.nd.MultiBoxPrior(data, sizes=(0.5, 0.25), ratios=(1, 2, 0.5))
    # per pixel: num_sizes + num_ratios - 1 = 4
    assert out.shape == (1, 4 * 6 * 4, 4)
    b = out.asnumpy()[0]
    # first pixel center is (0.5/6, 0.5/4); first box is size 0.5 ratio 1
    cx, cy = 0.5 / 6, 0.5 / 4
    np.testing.assert_allclose(b[0], [cx - 0.25, cy - 0.25,
                                      cx + 0.25, cy + 0.25], atol=1e-6)
    # ratio-2 box: half-w = s*sqrt(2)/2, half-h = s/sqrt(2)/2, s = sizes[0]
    hw = 0.5 * np.sqrt(2.0) / 2
    hh = 0.5 / np.sqrt(2.0) / 2
    np.testing.assert_allclose(b[2], [cx - hw, cy - hh, cx + hw, cy + hh],
                               atol=1e-6)


def test_multibox_prior_clip():
    data = mt.nd.zeros((1, 3, 2, 2), ctx=CPU)
    out = mt.nd.MultiBoxPrior(data, sizes=(1.5,), clip=True).asnumpy()
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_multibox_target_perfect_match():
    # one anchor exactly equals the one GT box -> positive with class 0+1
    anchors = mt.nd.array(np.array(
        [[[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]]], np.float32), ctx=CPU)
    labels = mt.nd.array(np.array(
        [[[0, 0.1, 0.1, 0.4, 0.4]]], np.float32), ctx=CPU)
    cls_preds = mt.nd.zeros((1, 3, 2), ctx=CPU)
    loc_t, loc_m, cls_t = mt.nd.MultiBoxTarget(anchors, labels, cls_preds)
    np.testing.assert_array_equal(cls_t.asnumpy(), [[1, 0]])
    np.testing.assert_array_equal(loc_m.asnumpy(),
                                  [[1, 1, 1, 1, 0, 0, 0, 0]])
    # exact match -> zero encoded offsets
    np.testing.assert_allclose(loc_t.asnumpy()[0, :4], np.zeros(4),
                               atol=1e-5)


def test_multibox_target_encoding_math():
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5]]], np.float32)
    labels = np.array([[[2, 0.1, 0.1, 0.6, 0.6]]], np.float32)
    loc_t, loc_m, cls_t = mt.nd.MultiBoxTarget(
        mt.nd.array(anchors, ctx=CPU), mt.nd.array(labels, ctx=CPU),
        mt.nd.zeros((1, 4, 1), ctx=CPU))
    np.testing.assert_array_equal(cls_t.asnumpy(), [[3]])  # class 2 + 1
    # encode: both centers (0.25,0.25) vs (0.35,0.35), aw=ah=0.5, gw=gh=0.5
    v = (0.1, 0.1, 0.2, 0.2)
    tx = (0.35 - 0.25) / 0.5 / v[0]
    np.testing.assert_allclose(loc_t.asnumpy()[0],
                               [tx, tx, 0.0, 0.0], atol=1e-4)


def test_multibox_target_no_gt():
    anchors = mt.nd.array(np.array([[[0.1, 0.1, 0.4, 0.4]]], np.float32),
                          ctx=CPU)
    labels = mt.nd.array(np.array([[[-1, 0, 0, 0, 0]]], np.float32), ctx=CPU)
    loc_t, loc_m, cls_t = mt.nd.MultiBoxTarget(anchors, labels,
                                               mt.nd.zeros((1, 2, 1),
                                                           ctx=CPU))
    assert cls_t.asnumpy().sum() == 0
    assert loc_m.asnumpy().sum() == 0


def test_multibox_detection_decode_and_nms():
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4],
                         [0.11, 0.11, 0.41, 0.41],
                         [0.6, 0.6, 0.9, 0.9]]], np.float32)
    # class probs (B, num_cls+1, A): anchor0/1 class1, anchor2 class2
    cls_prob = np.array([[[0.1, 0.2, 0.2],
                          [0.8, 0.7, 0.1],
                          [0.1, 0.1, 0.7]]], np.float32)
    loc_pred = np.zeros((1, 12), np.float32)
    out = mt.nd.MultiBoxDetection(mt.nd.array(cls_prob, ctx=CPU),
                                  mt.nd.array(loc_pred, ctx=CPU),
                                  mt.nd.array(anchors, ctx=CPU),
                                  nms_threshold=0.5).asnumpy()[0]
    assert out.shape == (3, 6)
    kept = out[out[:, 0] >= 0]
    # anchor1 suppressed by anchor0 (same class, IoU ~0.88)
    assert len(kept) == 2
    ids = sorted(kept[:, 0].tolist())
    assert ids == [0.0, 1.0]
    # zero loc_pred -> boxes equal anchors
    best = kept[np.argmax(kept[:, 1])]
    np.testing.assert_allclose(best[2:], [0.1, 0.1, 0.4, 0.4], atol=1e-5)


def test_multibox_detection_threshold():
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4]]], np.float32)
    cls_prob = np.array([[[0.99], [0.01]]], np.float32)
    out = mt.nd.MultiBoxDetection(mt.nd.array(cls_prob, ctx=CPU),
                                  mt.nd.zeros((1, 4), ctx=CPU),
                                  mt.nd.array(anchors, ctx=CPU),
                                  threshold=0.5).asnumpy()[0]
    assert (out[:, 0] == -1).all()


# ------------------------------------------------------- parity, random inputs
def _anchors():
    """The priors of a 4x6 map (96 anchors) from the JAX package, float32."""
    import mxnet_tpu as mx
    return mx.nd.MultiBoxPrior(mx.nd.zeros((1, 3, 4, 6)), sizes=(0.5, 0.25),
                               ratios=(1, 2, 0.5)).asnumpy()


def _labels(rs, b, classes, width=4):
    """Label width ``width``: 1-3 boxes an image, -1 padding rows, and the
    last image without ground truth."""
    label = np.full((b, width, 5), -1.0)
    for i in range(b - 1):
        for j in range(rs.randint(1, 4)):
            w, h = rs.uniform(0.1, 0.6, 2)
            x0, y0 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            label[i, j] = [rs.randint(0, classes), x0, y0, x0 + w, y0 + h]
    return label


def _close(got, want, tol, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (what, err)


def test_multibox_prior_bitwise(mx):
    for h, w in ((4, 6), (16, 16), (3, 7)):
        for sizes, ratios in (((0.5, 0.25), (1, 2, 0.5)),
                              ((0.2, 0.272), (1.0, 2.0, 0.5))):
            want = mx.nd.MultiBoxPrior(mx.nd.zeros((1, 3, h, w)),
                                       sizes=sizes, ratios=ratios,
                                       clip=True).asnumpy()
            got = mt.nd.MultiBoxPrior(
                mt.nd.zeros((1, 3, h, w), ctx=CPU, dtype=np.float64),
                sizes=sizes, ratios=ratios, clip=True).asnumpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


TARGET_CASES = [
    dict(),
    dict(negative_mining_ratio=3.0),
    dict(negative_mining_ratio=1.5, minimum_negative_samples=5,
         overlap_threshold=0.3, ignore_label=-2.0,
         variances=(0.1, 0.2, 0.3, 0.4)),
]


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("kw", TARGET_CASES, ids=["all_neg", "mined",
                                                  "mined_min5"])
def test_multibox_target_matches_mxnet_tpu(mx, kw, x64):
    import jax
    dtype = np.float64 if x64 else np.float32
    rs = np.random.RandomState(0)
    anchors = _anchors()
    classes, b = 3, 4
    label = _labels(rs, b, classes).astype(dtype)
    cls_pred = rs.randn(b, classes + 1, anchors.shape[1]).astype(dtype)
    jax.config.update("jax_enable_x64", x64)
    try:
        want = [o.asnumpy() for o in mx.nd.MultiBoxTarget(
            _nd(mx, anchors), _nd(mx, label), _nd(mx, cls_pred), **kw)]
    finally:
        jax.config.update("jax_enable_x64", False)
    got = [o.asnumpy() for o in mt.nd.MultiBoxTarget(
        _nd(mt, anchors), _nd(mt, label), _nd(mt, cls_pred), **kw)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[0], want[0], F64_TOL if x64 else F32_TOL, "loc_target")
    assert (want[2][-1] == 0).all()           # the image without a box
    if kw.get("negative_mining_ratio", -1) > 0:
        assert (want[2] == kw.get("ignore_label", -1.0)).any()


DETECT_CASES = [dict(), dict(force_suppress=True),
                dict(background_id=2, clip=False, nms_threshold=0.3),
                dict(threshold=0.3, nms_threshold=0.45)]


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("kw", DETECT_CASES, ids=["default", "force",
                                                  "bg2_noclip", "thresh"])
def test_multibox_detection_matches_mxnet_tpu(mx, kw, x64):
    import jax
    dtype = np.float64 if x64 else np.float32
    rs = np.random.RandomState(1)
    anchors = _anchors()
    b, c, a = 3, 4, anchors.shape[1]
    logits = rs.randn(b, c, a) * 2
    cls_prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .astype(dtype)
    loc_pred = (rs.randn(b, a * 4) * 0.5).astype(dtype)
    jax.config.update("jax_enable_x64", x64)
    try:
        want = mx.nd.MultiBoxDetection(_nd(mx, cls_prob), _nd(mx, loc_pred),
                                       _nd(mx, anchors), **kw).asnumpy()
    finally:
        jax.config.update("jax_enable_x64", False)
    got = mt.nd.MultiBoxDetection(_nd(mt, cls_prob), _nd(mt, loc_pred),
                                  _nd(mt, anchors), **kw).asnumpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    _close(got, want, F64_TOL if x64 else F32_TOL, "detections")
    kept = want[..., 0] >= 0
    assert 0 < kept.sum() < kept.size


def test_tied_scores_take_the_stable_order(mx):
    """Equal mining scores and equal detection scores: the port's stable
    argsort picks the rows the JAX package's does (an unstable sort would
    pick others among the ties)."""
    anchors = _anchors()
    a = anchors.shape[1]
    label = np.full((1, 2, 5), -1.0, np.float32)
    label[0, 0] = [0, 0.3, 0.3, 0.55, 0.6]
    # every anchor ties at one mining score: the negatives are the first
    # 3 x num_pos candidates in anchor order
    cls_pred = np.zeros((1, 3, a), np.float32)
    want = mx.nd.MultiBoxTarget(_nd(mx, anchors), _nd(mx, label),
                                _nd(mx, cls_pred),
                                negative_mining_ratio=3.0)[2].asnumpy()
    got = mt.nd.MultiBoxTarget(_nd(mt, anchors), _nd(mt, label),
                               _nd(mt, cls_pred),
                               negative_mining_ratio=3.0)[2].asnumpy()
    np.testing.assert_array_equal(got, want)
    neg = np.nonzero(want[0] == 0)[0]
    assert len(neg) == 3 * (want[0] > 0).sum()
    # detections: three score levels, each shared by a third of the rows
    cls_prob = np.zeros((1, 3, a), np.float32)
    cls_prob[0, 1] = np.repeat([0.6, 0.7, 0.8], a // 3)
    cls_prob[0, 0] = 1 - cls_prob[0, 1]
    loc = np.zeros((1, a * 4), np.float32)
    want = mx.nd.MultiBoxDetection(_nd(mx, cls_prob), _nd(mx, loc),
                                   _nd(mx, anchors)).asnumpy()
    got = mt.nd.MultiBoxDetection(_nd(mt, cls_prob), _nd(mt, loc),
                                  _nd(mt, anchors)).asnumpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["channel", "instance"])
def test_softmax_activation_matches_mxnet_tpu(mx64, mode):
    """Forward and the gradient of a weighted sum, float64."""
    import jax
    mx = mx64
    from mxnet_tpu.ops.registry import get_op as jget
    rs = np.random.RandomState(0)
    x = rs.randn(2, 4, 3, 5)
    w = rs.randn(2, 4, 3, 5)
    jfn = jget("SoftmaxActivation").fn
    jgrad = jax.grad(lambda v: (jfn(v, mode=mode) * w).sum())(x)
    want_out = np.asarray(jfn(x, mode=mode))
    tx = torch.tensor(x, requires_grad=True)
    out = mt.ops.registry.get_op("SoftmaxActivation").fn(tx, mode=mode)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=F64_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=F64_TOL)
    axes = (1,) if mode == "channel" else (1, 2, 3)
    np.testing.assert_allclose(want_out.sum(axis=axes), 1.0, atol=1e-12)
    # and through mt.nd in float32
    got = mt.nd.SoftmaxActivation(mt.nd.array(x, ctx=CPU),
                                  mode=mode).asnumpy()
    np.testing.assert_allclose(got, mx.nd.SoftmaxActivation(
        mx.nd.array(x.astype(np.float32)), mode=mode).asnumpy(),
        rtol=0, atol=F32_TOL)
