"""Proposal and CTCLoss in the port (``ops/contrib.py``) against
mxnet_tpu's, on the CPU.

Both ops go through ``_both`` of ``test_torch_ordering_misc.py`` at float64
inputs from a seed (JAX's x64 on): every output and every input's gradient
under one random cotangent within 1e-9 relative.  Proposal's rows are the
same rows (batch indices equal, zero rows at the same places) with tied
scores, boxes under the minimum size (scored -inf, alive through the NMS,
dropped after it), fewer survivors than ``post_n`` and ``output_score``;
its NMS is ``contrib.greedy_nms`` on zero ids of the boxes' dtype with
``force_suppress``.  CTCLoss covers repeated labels, an empty label and
labels that cannot fit in T steps (a loss near 1e30, where the JAX
package's log-zero rule fixes the gradient too).  Then the twins of the
Proposal and CTC cases of the JAX package's tests, a brute-force sum over
alignments among them."""
import itertools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib
from test_torch_ordering_misc import _both
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-12)
C = mt.cpu()


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _rpn(b, a, fh, fw, seed, tie_step=None, delta=0.2):
    """(cls_prob, bbox_pred) of an RPN head: scores in [0, 1) (on a grid of
    ``tie_step`` for ties), deltas ``delta`` x randn."""
    rs = np.random.RandomState(seed)
    cls = rs.rand(b, 2 * a, fh, fw)
    if tie_step:
        cls = np.floor(cls / tie_step) * tie_step
    return cls, rs.randn(b, 4 * a, fh, fw) * delta


def _info(*rows):
    return np.asarray(rows, np.float64)


ANCH = {"feature_stride": 8, "scales": (2, 4), "ratios": (0.5, 1, 2)}
PROPOSALS = [
    # attrs, (cls_prob, bbox_pred), im_info: scores on a grid of quarters
    # (ties); most boxes under the minimum size (-inf scores), fewer
    # survivors than post_n and zero rows after them
    (dict(ANCH, rpn_pre_nms_top_n=60, rpn_post_nms_top_n=30,
          rpn_min_size=16, output_score=True),
     _rpn(2, 6, 4, 5, 2, tie_step=0.25, delta=0.5),
     _info([32, 40, 1.0], [30, 28, 1.2])),
]


@pytest.mark.parametrize("case", PROPOSALS,
                         ids=["%d" % i for i in range(len(PROPOSALS))])
def test_proposal_f64_rows_equal_mxnet_tpu(case, f64):
    attrs, (cls_prob, bbox_pred), im_info = case
    pall, jall, pgrads, jgrads = _both("Proposal", attrs,
                                       [cls_prob, bbox_pred, im_info])
    assert len(pall) == len(jall) == (2 if attrs.get("output_score") else 1)
    rois, want = pall[0].detach().numpy(), np.asarray(jall[0])
    assert rois.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(rois[:, 0], want[:, 0])
    zero = ~want[:, 1:].any(1)
    np.testing.assert_array_equal(~rois[:, 1:].any(1), zero)
    assert zero.any()            # fewer survivors than post_n
    ties = np.asarray(jall[1])[:, 0]
    assert len(np.unique(ties[ties > 0])) < (ties > 0).sum()
    for p, j in zip(pall, jall):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **TOL)
    for i, (p, j) in enumerate(zip(pgrads, jgrads)):
        want = np.asarray(j)
        got = np.zeros_like(want) if p is None else p.numpy()
        np.testing.assert_allclose(got, want, err_msg="input %d" % i, **TOL)


def test_proposal_nms_is_greedy_nms_on_zero_ids(monkeypatch):
    """The pre-NMS rows go to contrib.greedy_nms: (B, pre_n, 4) boxes, zero
    ids in the boxes' dtype, force_suppress; the -inf rows among them."""
    seen = []
    real = contrib.greedy_nms

    def spy(boxes, ids, thr, force_suppress=False):
        seen.append((tuple(boxes.shape), ids.dtype, boxes.dtype,
                     bool((ids == 0).all()), thr, force_suppress))
        return real(boxes, ids, thr, force_suppress)
    monkeypatch.setattr(contrib, "greedy_nms", spy)
    attrs, (cls_prob, bbox_pred), im_info = PROPOSALS[0]
    ins = [torch.tensor(a, dtype=torch.float32)
           for a in (cls_prob, bbox_pred, im_info)]
    (rois, scores), _ = mt.ops.registry.imperative_invoke("Proposal", ins,
                                                          attrs)
    assert seen == [((2, 60, 4), torch.float32, torch.float32, True, 0.7,
                     True)]
    assert rois.shape == (60, 5) and scores.shape == (60, 1)
    assert torch.isfinite(scores).all() and (scores[:, 0] >= 0).all()


def test_proposal_iou_loss_is_refused():
    ins = [torch.zeros(1, 2, 2, 2), torch.zeros(1, 4, 2, 2),
           torch.tensor([[32.0, 32.0, 1.0]])]
    with pytest.raises(MXNetError):
        mt.ops.registry.imperative_invoke(
            "Proposal", ins, {"iou_loss": True, "scales": (1.0,),
                              "ratios": (1.0,)})


def _labels(*rows):
    return np.asarray(rows, np.float64)


CTC = [
    # activations (T, B, A), labels (B, L): repeats need a blank between,
    # an empty label
    ((6, 3, 5), _labels([1, 2, 0], [3, 3, 1], [0, 0, 0])),
    # [2, 2, 2] needs 5 steps: near 1e30 at T = 3; [1, 1, 0] and
    # [1, 2, 3] fit exactly in 3
    ((3, 3, 4), _labels([1, 1, 0], [2, 2, 2], [1, 2, 3])),
]


@pytest.mark.parametrize("case", CTC, ids=["%d" % i for i in range(len(CTC))])
def test_ctc_f64_matches_mxnet_tpu(case, f64):
    shape, labels = case
    acts = np.random.RandomState(shape[0]).randn(*shape)
    pall, jall, pgrads, jgrads = _both("CTCLoss", {}, [acts, labels])
    loss, want = pall[0].detach().numpy(), np.asarray(jall[0])
    np.testing.assert_allclose(loss, want, **TOL)
    np.testing.assert_allclose(pgrads[0].numpy(), np.asarray(jgrads[0]),
                               **TOL)
    assert pgrads[1] is None and not np.asarray(jgrads[1]).any()
    # a label fits in its length plus one blank a repeat
    for i, r in enumerate(labels):
        lab = r[r > 0]
        need = len(lab) + int(np.sum(lab[1:] == lab[:-1]))
        assert (loss[i] > 1e29) == (need > shape[0]), (i, loss[i])


def test_ctc_aliases_share_the_op():
    reg = mt.ops.registry
    assert reg.get_op("ctc_loss") is reg.get_op("CTCLoss") \
        is reg.get_op("_contrib_CTCLoss")
    assert reg.get_op("Proposal") is reg.get_op("_contrib_Proposal")


# ------------------------------------------ twins of the JAX package's tests
def test_proposal_shapes_and_clip():
    rs = np.random.RandomState(0)
    b, a, fh, fw = 1, 3, 4, 4
    cls_prob = rs.rand(b, 2 * a, fh, fw).astype(np.float32)
    bbox_pred = (rs.rand(b, 4 * a, fh, fw).astype(np.float32) - 0.5) * 0.1
    im_info = np.array([[64, 64, 1.0]], np.float32)
    rois = mt.nd.Proposal(mt.nd.array(cls_prob, ctx=C),
                          mt.nd.array(bbox_pred, ctx=C),
                          mt.nd.array(im_info, ctx=C), rpn_pre_nms_top_n=12,
                          rpn_post_nms_top_n=5, feature_stride=16,
                          scales=(2.0,), ratios=(0.5, 1.0, 2.0),
                          rpn_min_size=4).asnumpy()
    assert rois.shape == (5, 5)
    assert (rois[:, 0] == 0).all()
    assert rois[:, 1:].min() >= 0 and rois[:, 1:].max() <= 63


def test_proposal_output_score():
    cls_prob = mt.nd.ones((1, 2, 2, 2), ctx=C) * 0.5
    bbox_pred = mt.nd.zeros((1, 4, 2, 2), ctx=C)
    im_info = mt.nd.array(np.array([[32, 32, 1.0]], np.float32), ctx=C)
    out = mt.nd.Proposal(cls_prob, bbox_pred, im_info, rpn_post_nms_top_n=3,
                         scales=(1.0,), ratios=(1.0,), output_score=True)
    assert isinstance(out, (list, tuple)) and len(out) == 2
    assert out[0].shape == (3, 5) and out[1].shape == (3, 1)


def _ctc_brute_force(probs, label):
    """Sum over all alignments (tiny cases only). probs (T, A) softmaxed."""
    t_len, a = probs.shape

    def collapse(path):
        out = []
        prev = -1
        for p in path:
            if p != prev and p != 0:
                out.append(p)
            prev = p
        return tuple(out)

    total = 0.0
    for path in itertools.product(range(a), repeat=t_len):
        if collapse(path) == tuple(label):
            p = 1.0
            for t, s in enumerate(path):
                p *= probs[t, s]
            total += p
    return total


def test_ctc_loss_vs_brute_force():
    rs = np.random.RandomState(0)
    t_len, b, a = 4, 2, 3
    acts = rs.randn(t_len, b, a).astype(np.float32)
    labels = np.array([[1, 2], [1, 0]], np.float32)  # second has len 1
    loss = mt.nd.CTCLoss(mt.nd.array(acts, ctx=C),
                         mt.nd.array(labels, ctx=C)).asnumpy()
    probs = np.exp(acts) / np.exp(acts).sum(axis=2, keepdims=True)
    for i, lab in enumerate([[1, 2], [1]]):
        expect = -np.log(_ctc_brute_force(probs[:, i], lab))
        np.testing.assert_allclose(loss[i], expect, rtol=1e-4)


def test_ctc_loss_simple_case():
    """T=2, label 'a' over {blank, a}: the paths aa, a-, -a."""
    probs = np.array([[[0.4, 0.6]], [[0.3, 0.7]]], np.float32)  # (T,B,V)
    net = mt.sym.CTCLoss(mt.sym.Variable("data"), mt.sym.Variable("label"))
    ex = net.bind(C, {"data": mt.nd.array(np.log(probs), ctx=C),
                      "label": mt.nd.array(np.array([[1.0]], np.float32),
                                           ctx=C)}, grad_req="null")
    loss = ex.forward()[0].asnumpy()
    p = 0.6 * 0.7 + 0.6 * 0.3 + 0.4 * 0.7
    np.testing.assert_allclose(loss, [-np.log(p)], rtol=1e-4, atol=1e-5)


def test_ctc_loss_matches_mxnet_tpu_float32():
    """The eager frontends of both packages at float32 on the warpctc OCR
    example's label width (4 digits, 11 classes with the blank)."""
    rs = np.random.RandomState(5)
    acts = rs.randn(20, 4, 11).astype(np.float32)
    labels = rs.randint(1, 11, (4, 4)).astype(np.float32)
    labels[3, 2:] = 0
    got = mt.nd.CTCLoss(mt.nd.array(acts, ctx=C),
                        mt.nd.array(labels, ctx=C)).asnumpy()
    want = mx.nd.CTCLoss(mx.nd.array(acts), mx.nd.array(labels)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
