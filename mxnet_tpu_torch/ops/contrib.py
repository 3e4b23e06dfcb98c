"""Contrib operators (counterpart: mxnet_tpu/ops/contrib.py): the SSD
slice's MultiBoxPrior, MultiBoxTarget and MultiBoxDetection, Faster
R-CNN's Proposal, and CTCLoss, each also under its ``_contrib_`` name
(CTCLoss as ``ctc_loss`` too).

The JAX package writes them as fixed-shape XLA programs, not Pallas
kernels: every tensor keeps a static shape, "removed" boxes are masked
with -1 / -inf instead of compacted, and the per-image loops run under
``vmap``.  The port keeps that shape with a batch axis written out, in
stock PyTorch ops that never read a value back to the host (no ``.item()``,
no data-dependent shape), so that a training step stays free of host syncs.
The one loop that does not batch is ``MultiBoxDetection``'s greedy NMS, a
sequential walk over the score-sorted boxes: on the card it is the two
hand-written kernels of ``csrc/multibox_nms.cu``, a suppression mask over
the whole card and a scan over it, one launch each a band of rows
(``greedy_nms``, counted in ``nms_launches``); on the host its plain
version ``greedy_nms_ref``, a loop that mirrors ``_greedy_nms``.
``Proposal`` sends its pre-NMS rows through the same ``greedy_nms``.

CTCLoss is the JAX package's alpha recursion, a loop over time of stock
PyTorch ops with autograd's gradient; its log-add takes the JAX rule's
gradient (``_LogAddExp``), so that a label that cannot fit (log-zero
-1e30 on every path) gets the same gradient as in the JAX package.
"""
from __future__ import annotations

import ast
import ctypes

import numpy as _np
import torch

from ..base import MXNetError
from .kernel_build import CudaLibrary
from .registry import register, parse_bool, parse_float, parse_int

__all__ = ["greedy_nms", "greedy_nms_ref", "detection_rows", "build",
           "nms_plan", "nms_launch", "nms_launches", "proposal_rows"]

# launches of the NMS kernels since import (or since a caller reset it to 0)
nms_launches = 0
# rows are banded so that the NMS kernels' mask stays within this size, and
# a band holds at most NMS_MAX_BAND_ROWS (the scan keeps a band's removed
# words, one a 64 rows, in shared memory)
NMS_WORKSPACE_BYTES = 1 << 28
NMS_MAX_BAND_ROWS = 64 * 4096


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.multibox_nms_mask_launch.argtypes = [p, p, p, i, i, i, i,
                                             ctypes.c_double, i, i, p]
    lib.multibox_nms_mask_launch.restype = i
    lib.multibox_nms_scan_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.multibox_nms_scan_launch.restype = i


# --fmad=false: the IoU is rounded step by step as _iou_matrix's (see the
# source's note)
_kernel = CudaLibrary("multibox_nms", _bind, flags=["--fmad=false"])


def build():
    """Compile (once per source and flags) and load the NMS kernel; returns
    the compiler's output of this process's build, or None."""
    return _kernel.build()


def _parse_floats(v):
    if v is None:
        return v
    if isinstance(v, (int, float)):
        return (float(v),)
    if isinstance(v, (list, tuple)):
        return tuple(float(x) for x in v)
    out = ast.literal_eval(v.strip())
    if isinstance(out, (int, float)):
        return (float(out),)
    return tuple(float(x) for x in out)


def _inv(v, dtype):
    """1 / v rounded to ``dtype`` (float64, else float32), as a host scalar.
    XLA's algebraic simplifier turns the JAX package's divisions by a
    constant (the map size, the variances) into products with the
    constant's reciprocal; the port multiplies by the same reciprocal, so
    that anchors and box targets agree bit for bit."""
    if dtype == torch.float64:
        return 1.0 / v
    return float(_np.float32(1.0) / _np.float32(v))


# -------------------------------------------------------------- MultiBoxPrior
def _mbprior_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], None
    sizes = _parse_floats(attrs.get("sizes", (1.0,)))
    ratios = _parse_floats(attrs.get("ratios", (1.0,)))
    per = len(sizes) + len(ratios) - 1
    h, w = data[2], data[3]
    return list(in_shapes), [(1, h * w * per, 4)], None


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
          attr_types={"sizes": _parse_floats, "ratios": _parse_floats,
                      "clip": parse_bool},
          defaults={"sizes": (1.0,), "ratios": (1.0,), "clip": False},
          infer_shape=_mbprior_infer)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False):
    """SSD anchor boxes for every pixel of ``data``'s map, (1, h*w*P, 4)
    float32 whatever ``data``'s dtype: per pixel the sizes at ratio 1, then
    each extra ratio at ``sizes[0]``; corners normalised to [0, 1]."""
    h, w = int(data.shape[2]), int(data.shape[3])
    dt, dev = torch.float32, data.device
    cx = (torch.arange(w, dtype=dt, device=dev) + 0.5) * _inv(w, dt)
    cy = (torch.arange(h, dtype=dt, device=dev) + 0.5) * _inv(h, dt)
    half = [(s / 2.0, s / 2.0) for s in sizes]
    for r in ratios[1:]:
        rs = float(_np.sqrt(r))
        half.append((sizes[0] * rs / 2.0, sizes[0] / rs / 2.0))
    gx = cx[None, :].expand(h, w)
    gy = cy[:, None].expand(h, w)
    # the half widths as float32 values (the reference's jnp.asarray(half,
    # float32)), applied as host scalars: no host-to-device copy
    boxes = torch.stack(
        [torch.stack([gx - hx, gy - hy, gx + hx, gy + hy], -1)
         for hx, hy in _np.asarray(half, _np.float32).tolist()], 2)
    boxes = boxes.reshape(1, h * w * len(half), 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes


# --------------------------------------------------------------- box helpers
def _iou_matrix(a, b):
    """IoU between (..., N, 4) and (..., M, 4) corner boxes, (..., N, M);
    0 where the union is not positive."""
    ix = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp(
              min=0.0)
    iy = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp(
              min=0.0)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _encode_loc(anchors, gt, variances):
    """Box-regression targets of ``gt`` (..., 4) against ``anchors``
    (..., 4), divided by the variances (as products with their
    reciprocals, ``_inv``)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    dt = torch.promote_types(anchors.dtype, gt.dtype)
    vx, vy, vw, vh = (_inv(v, dt) for v in variances)
    eps = 1e-8
    return torch.stack(
        [(gx - ax) / aw.clamp(min=eps) * vx,
         (gy - ay) / ah.clamp(min=eps) * vy,
         torch.log((gw / aw.clamp(min=eps)).clamp(min=eps)) * vw,
         torch.log((gh / ah.clamp(min=eps)).clamp(min=eps)) * vh], -1)


# -------------------------------------------------------------- MultiBoxTarget
def _mbtarget_infer(attrs, in_shapes):
    anchors, labels, cls_preds = (list(in_shapes) + [None] * 3)[:3]
    if anchors is None or labels is None:
        return list(in_shapes), [None, None, None], None
    na = anchors[1]
    b = labels[0]
    return list(in_shapes), [(b, na * 4), (b, na * 4), (b, na)], None


def _take(x, idx):
    """x (B, L, ...) gathered along axis 1 by idx (B, A)."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                    .expand(idx.shape + x.shape[2:]))


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          arg_names=("anchor", "label", "cls_pred"), num_outputs=3,
          attr_types={"overlap_threshold": parse_float,
                      "ignore_label": parse_float,
                      "negative_mining_ratio": parse_float,
                      "negative_mining_thresh": parse_float,
                      "minimum_negative_samples": parse_int,
                      "variances": _parse_floats},
          defaults={"overlap_threshold": 0.5, "ignore_label": -1.0,
                    "negative_mining_ratio": -1.0,
                    "negative_mining_thresh": 0.5,
                    "minimum_negative_samples": 0,
                    "variances": (0.1, 0.1, 0.2, 0.2)},
          infer_shape=_mbtarget_infer)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: (loc_target (B, A*4), loc_mask (B, A*4),
    cls_target (B, A)).  Bipartite matching (each ground truth claims its
    best anchor, L rounds of a batched argmax over the flattened (A, L)
    overlaps), then threshold matching of the anchors left, then the
    negatives (all, or hard-mined on the softmax of ``cls_pred``), then the
    box targets with ``variances``.  cls_target is the class + 1 for a
    positive, 0 for a negative, ``ignore_label`` otherwise; an image with
    no ground truth gets zeros.  The op has no gradient: its outputs are
    computed without autograd."""
    with torch.no_grad():
        return _mbtarget(anchor.detach(), label.detach(), cls_pred.detach(),
                         overlap_threshold, ignore_label,
                         negative_mining_ratio, negative_mining_thresh,
                         minimum_negative_samples, variances)


def _mbtarget(anchor, label, cls_pred, overlap_threshold, ignore_label,
              negative_mining_ratio, negative_mining_thresh,
              minimum_negative_samples, variances):
    anchors = anchor.reshape(-1, 4)
    na = anchors.shape[0]
    b, nl = label.shape[0], label.shape[1]
    dev = label.device
    valid = label[:, :, 0] >= 0                              # (B, L)
    gt = label[:, :, 1:5]
    overlaps = _iou_matrix(anchors, gt)                      # (B, A, L)
    overlaps = torch.where(valid[:, None, :], overlaps, -1.0)

    # stage 1: bipartite matching, nl rounds of a global argmax an image
    match = torch.full((b, na), -1, dtype=torch.int64, device=dev)
    a_used = torch.zeros((b, na), dtype=torch.bool, device=dev)
    g_used = torch.zeros((b, nl), dtype=torch.bool, device=dev)
    for _ in range(nl):
        masked = torch.where(a_used[:, :, None] | g_used[:, None, :], -1.0,
                             overlaps).reshape(b, -1)
        flat = masked.argmax(dim=1, keepdim=True)           # (B, 1)
        ai, gi = flat // nl, flat % nl
        good = masked.gather(1, flat) > 1e-6
        match = match.scatter(1, ai, torch.where(good, gi,
                                                 match.gather(1, ai)))
        a_used = a_used.scatter(1, ai, good | a_used.gather(1, ai))
        g_used = g_used.scatter(1, gi, good | g_used.gather(1, gi))

    # stage 2: threshold matching of the anchors still unmatched
    best_iou = overlaps.amax(dim=2)
    best_gt = overlaps.argmax(dim=2)
    if overlap_threshold > 0:
        thresh_pos = ~a_used & (best_iou > overlap_threshold)
    else:
        thresh_pos = torch.zeros_like(a_used)
    positive = a_used | thresh_pos
    match = torch.where(thresh_pos, best_gt, match)

    # stage 3: the negatives, all or hard-mined by the best non-background
    # probability
    if negative_mining_ratio > 0:
        probs = torch.softmax(cls_pred, dim=1)              # (B, C, A)
        neg_score = probs[:, 1:].amax(dim=1)                # (B, A)
        cand = ~positive & (best_iou < negative_mining_thresh)
        num_pos = positive.sum(dim=1, dtype=torch.int32)
        num_neg = torch.minimum(
            torch.clamp((num_pos.to(torch.float32) * negative_mining_ratio)
                        .to(torch.int32), min=minimum_negative_samples),
            na - num_pos)
        score = torch.where(cand, neg_score, -float("inf"))
        # stable, as jnp.argsort: the -inf of the non-candidates tie
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(na, device=dev).expand(b, na))
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    midx = match.clamp(min=0)
    cls_t = torch.where(positive, _take(label[:, :, 0], midx) + 1.0,
                        torch.where(negative, 0.0, ignore_label)
                        .to(label.dtype))
    loc_t = _encode_loc(anchors, _take(gt, midx), variances)
    loc_t = torch.where(positive[:, :, None], loc_t, 0.0)
    loc_m = torch.where(positive[:, :, None],
                        torch.ones((), dtype=anchors.dtype, device=dev),
                        0.0).expand(b, na, 4)
    any_gt = valid.any(dim=1)
    cls_t = torch.where(any_gt[:, None], cls_t, 0.0)
    loc_t = torch.where(any_gt[:, None, None], loc_t, 0.0)
    loc_m = torch.where(any_gt[:, None, None], loc_m, 0.0)
    return loc_t.reshape(b, -1), loc_m.reshape(b, -1), cls_t


# ---------------------------------------------------------- MultiBoxDetection
def _mbdet_infer(attrs, in_shapes):
    cls_prob = in_shapes[0]
    if cls_prob is None:
        return list(in_shapes), [None], None
    return list(in_shapes), [(cls_prob[0], cls_prob[2], 6)], None


def greedy_nms_ref(boxes, ids, nms_threshold, force_suppress=False):
    """The plain version of the NMS kernels, on any device: boxes (B, A, 4)
    and ids (B, A), each image's rows sorted by descending score; returns
    the ids with every suppressed row at -1.  A loop over the rows that
    mirrors the JAX package's ``_greedy_nms``, batched over the images."""
    n = ids.shape[1]
    later = torch.arange(n, device=ids.device)
    for i in range(n):
        idi = ids[:, i:i + 1]
        iou = _iou_matrix(boxes[:, i:i + 1], boxes)[:, 0]   # (B, A)
        kill = (later > i) & (idi >= 0) & (ids >= 0) & (iou >= nms_threshold)
        if not force_suppress:
            kill = kill & (ids == idi)
        ids = torch.where(kill, -1.0, ids)
    return ids


def nms_plan(b, n):
    """(words a mask row, rows a band, bands) of the NMS kernels over ``b``
    images of ``n`` rows: a band's mask is b x rows x words 64-bit words,
    the rows the largest multiple of 64 that keeps it within
    NMS_WORKSPACE_BYTES, at most NMS_MAX_BAND_ROWS."""
    words = -(-n // 64)
    rows = NMS_WORKSPACE_BYTES // (8 * b * words) // 64 * 64
    rows = min(max(rows, 64), 64 * words, NMS_MAX_BAND_ROWS)
    return words, rows, -(-64 * words // rows)


def _refused(err, what):
    if err:
        raise MXNetError("%s kernel launch refused (error %d)" % (what, err))


def nms_launch(lib, boxes, ids, nms_threshold, force_suppress=False,
               stream=None, workspace=None, check=None):
    """Launch the NMS kernels of ``lib`` on contiguous ``boxes`` (B, A, 4)
    and ``ids`` (B, A) of one float dtype, updating ``ids`` in place: a band
    of rows at a time (``nms_plan``), the mask kernel then the scan.
    ``workspace``: int64, at least B x (rows + 1) x words elements (the
    band's mask, then the removed words), else made with ``torch.empty`` on
    the ids' device.  ``check(err, what)`` is called after each launch and
    raises on a refused one (default: an MXNetError with the code).
    Returns the number of launches."""
    check = check or _refused
    b, n = ids.shape
    words, rows, bands = nms_plan(b, n)
    need = b * (rows + 1) * words
    if workspace is None:
        workspace = torch.empty(need, dtype=torch.int64, device=ids.device)
    elif workspace.dtype != torch.int64 or workspace.numel() < need \
            or not workspace.is_contiguous():
        raise MXNetError("multibox_nms: the workspace must be contiguous "
                         "int64 of at least %d elements" % need)
    mask = workspace.data_ptr()
    removed = mask + 8 * b * rows * words
    f64 = int(boxes.dtype == torch.float64)
    for row0 in range(0, 64 * words, rows):
        check(lib.multibox_nms_mask_launch(
            boxes.data_ptr(), ids.data_ptr(), mask, b, n, row0, rows,
            float(nms_threshold), int(bool(force_suppress)), f64, stream),
            "multibox_nms mask")
        check(lib.multibox_nms_scan_launch(
            ids.data_ptr(), mask, removed, b, n, row0, rows, f64, stream),
            "multibox_nms scan")
    return 2 * bands


def greedy_nms(boxes, ids, nms_threshold, force_suppress=False):
    """Greedy NMS of score-sorted rows (see ``greedy_nms_ref``).  A CPU
    tensor goes to the plain version, a CUDA tensor to the kernels (float32
    or float64, boxes and ids of one dtype), or raises."""
    global nms_launches
    if not boxes.is_cuda:
        return greedy_nms_ref(boxes, ids, nms_threshold, force_suppress)
    if boxes.dtype not in (torch.float32, torch.float64) \
            or ids.dtype != boxes.dtype or ids.device != boxes.device:
        raise MXNetError("multibox_nms: boxes and ids must be float32 or "
                         "float64 of one dtype on one card, got %s and %s "
                         "on %s and %s" % (boxes.dtype, ids.dtype,
                                           boxes.device, ids.device))
    b, n = ids.shape
    if tuple(boxes.shape) != (b, n, 4):
        raise MXNetError("multibox_nms: boxes %s do not match ids %s"
                         % (tuple(boxes.shape), tuple(ids.shape)))
    lib = _kernel.get()
    bx = boxes.detach().contiguous()
    out = ids.detach().contiguous().clone()
    with torch.cuda.device(bx.device):
        nms_launches += nms_launch(
            lib, bx, out, nms_threshold, force_suppress,
            torch.cuda.current_stream(bx.device).cuda_stream,
            check=_kernel.check)
    return out


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          arg_names=("cls_prob", "loc_pred", "anchor"),
          attr_types={"clip": parse_bool, "threshold": parse_float,
                      "background_id": parse_int,
                      "nms_threshold": parse_float,
                      "force_suppress": parse_bool,
                      "variances": _parse_floats},
          defaults={"clip": True, "threshold": 0.01, "background_id": 0,
                    "nms_threshold": 0.5, "force_suppress": False,
                    "variances": (0.1, 0.1, 0.2, 0.2)},
          infer_shape=_mbdet_infer)
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                        background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2)):
    """Detections (B, A, 6), rows [class_id, score, x1, y1, x2, y2] sorted
    by score; a suppressed or invalid row has class_id -1 and score -1.
    The best non-background class (the background row masked to -inf, the
    id shifted past the background slot) is kept where its probability
    beats the background's and reaches ``threshold``; then greedy NMS."""
    cid, score, boxes = detection_rows(cls_prob, loc_pred, anchor, clip,
                                       threshold, background_id, variances)
    cid = greedy_nms(boxes, cid, nms_threshold, force_suppress)
    score = torch.where(cid >= 0, score, -1.0)
    return torch.cat([cid[..., None], score[..., None], boxes], -1)


def detection_rows(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                   background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection before its NMS: (class ids (B, A), scores (B, A),
    boxes (B, A, 4)) sorted by descending score (stable), at the promoted
    dtype of the three inputs; a row not kept has id -1 and score -1."""
    anchors = anchor.reshape(-1, 4)
    vx, vy, vw, vh = variances
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    lp = loc_pred.reshape(loc_pred.shape[0], -1, 4)
    ox = lp[..., 0] * vx * aw + ax
    oy = lp[..., 1] * vy * ah + ay
    ow = torch.exp(lp[..., 2] * vw) * aw / 2.0
    oh = torch.exp(lp[..., 3] * vh) * ah / 2.0
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    bg_row = torch.arange(cls_prob.shape[1],
                          device=cls_prob.device)[:, None] == background_id
    masked = torch.where(bg_row, -float("inf"), cls_prob)
    score = masked.amax(dim=1)
    raw = masked.argmax(dim=1)
    cid = torch.where(raw > background_id, raw - 1, raw).to(cls_prob.dtype)
    keep = (score > cls_prob[:, background_id]) & (score >= threshold)
    cid = torch.where(keep, cid, -1.0)
    score = torch.where(keep, score, -1.0)
    order = torch.argsort(-score, dim=1, stable=True)
    dt = torch.promote_types(cid.dtype, boxes.dtype)
    return (cid.gather(1, order).to(dt), score.gather(1, order).to(dt),
            boxes.gather(1, order[..., None].expand(-1, -1, 4)).to(dt))


# -------------------------------------------------------------------- Proposal
def _gen_base_anchors(base_size, ratios, scales):
    """py-faster-rcnn's anchor enumeration (GenerateAnchors), float32: for
    each ratio, for each scale, a box centred on the base box."""
    base = _np.array([0, 0, base_size - 1, base_size - 1], _np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + (w - 1) * 0.5
    cy = base[1] + (h - 1) * 0.5
    out = []
    size = w * h
    for r in ratios:
        ws = _np.round(_np.sqrt(size / r))
        hs = _np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            out.append([cx - (wss - 1) * 0.5, cy - (hss - 1) * 0.5,
                        cx + (wss - 1) * 0.5, cy + (hss - 1) * 0.5])
    return _np.array(out, _np.float32)


def _proposal_anchors(fh, fw, feature_stride, ratios, scales, device):
    """The shifted anchors (fh * fw * A, 4), float32, in the order (y, x,
    anchor): the base anchors added to each pixel's shift as host
    scalars, so that nothing is copied to the device."""
    base = _gen_base_anchors(feature_stride, ratios, scales)
    dt = torch.float32
    sx = (torch.arange(fw, dtype=dt, device=device)
          * feature_stride)[None, :].expand(fh, fw)
    sy = (torch.arange(fh, dtype=dt, device=device)
          * feature_stride)[:, None].expand(fh, fw)
    per = [torch.stack([sx + b[0], sy + b[1], sx + b[2], sy + b[3]], -1)
           for b in base.tolist()]
    return torch.stack(per, 2).reshape(-1, 4)


def _clip(x, lo, hi):
    """``jnp.clip``: max with ``lo``, then min with ``hi`` (a tie splits
    the gradient, as in the JAX package)."""
    def bound(v):
        return v if isinstance(v, torch.Tensor) \
            else torch.full((), v, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def _proposal_infer(attrs, in_shapes):
    cls = in_shapes[0]
    if cls is None:
        return list(in_shapes), [None], None
    post = int(attrs.get("rpn_post_nms_top_n", 300))
    shapes = [(cls[0] * post, 5)]
    if parse_bool(attrs.get("output_score", False)):
        shapes.append((cls[0] * post, 1))
    return list(in_shapes), shapes, None


def _proposal_nout(attrs):
    return 2 if parse_bool(attrs.get("output_score", False)) else 1


def proposal_rows(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                  rpn_min_size=16, scales=(4.0, 8.0, 16.0, 32.0),
                  ratios=(0.5, 1.0, 2.0), feature_stride=16):
    """Proposal before its NMS: (boxes (B, pre_n, 4), scores (B, pre_n)),
    the pre-NMS top N by score.  The shifted anchors decoded by
    ``bbox_pred`` and clipped to the image; a box under ``rpn_min_size`` *
    scale in either side scores -inf; a stable descending sort (ties: the
    lower index first, as ``lax.top_k``)."""
    b, twoa, fh, fw = cls_prob.shape
    na = twoa // 2
    anchors = _proposal_anchors(fh, fw, feature_stride, ratios, scales,
                               cls_prob.device)
    n = anchors.shape[0]
    pre_n = min(rpn_pre_nms_top_n, n) if rpn_pre_nms_top_n > 0 else n
    # foreground scores, channels A..2A of layout (A, fh, fw), and the
    # deltas (A, 4, fh, fw), both in the anchors' (y, x, anchor) order
    scores = cls_prob[:, na:].permute(0, 2, 3, 1).reshape(b, -1)
    deltas = bbox_pred.reshape(b, na, 4, fh, fw).permute(
        0, 3, 4, 1, 2).reshape(b, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(_clip(deltas[..., 2], -10.0, 10.0)) * aw
    hh = torch.exp(_clip(deltas[..., 3], -10.0, 10.0)) * ah
    ih, iw, im_scale = (im_info[:, k, None] for k in range(3))
    boxes = torch.stack(
        [_clip(cx - 0.5 * (w - 1), 0, iw - 1),
         _clip(cy - 0.5 * (hh - 1), 0, ih - 1),
         _clip(cx + 0.5 * (w - 1), 0, iw - 1),
         _clip(cy + 0.5 * (hh - 1), 0, ih - 1)], -1)
    min_size = rpn_min_size * im_scale
    bw = boxes[..., 2] - boxes[..., 0] + 1
    bh = boxes[..., 3] - boxes[..., 1] + 1
    scores = torch.where((bw >= min_size) & (bh >= min_size), scores,
                         -float("inf"))
    order = torch.sort(scores, dim=1, descending=True,
                       stable=True)[1][:, :pre_n]
    return (boxes.gather(1, order[..., None].expand(b, pre_n, 4)),
            scores.gather(1, order))


@register("_contrib_Proposal", aliases=("Proposal",),
          arg_names=("cls_prob", "bbox_pred", "im_info"),
          num_outputs=_proposal_nout,
          attr_types={"rpn_pre_nms_top_n": parse_int,
                      "rpn_post_nms_top_n": parse_int,
                      "threshold": parse_float, "rpn_min_size": parse_int,
                      "scales": _parse_floats, "ratios": _parse_floats,
                      "feature_stride": parse_int, "output_score": parse_bool,
                      "iou_loss": parse_bool},
          defaults={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                    "threshold": 0.7, "rpn_min_size": 16,
                    "scales": (4.0, 8.0, 16.0, 32.0),
                    "ratios": (0.5, 1.0, 2.0), "feature_stride": 16,
                    "output_score": False, "iou_loss": False},
          infer_shape=_proposal_infer)
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
              feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals: the pre-NMS rows of ``proposal_rows``; greedy NMS at
    ``threshold`` over them (``greedy_nms``, every row one class), the
    -inf rows alive in it; then the first ``post_n`` rows alive with a
    finite score, in score order, zero rows after them.
    Output (B * post_n, 5) rows [batch index, x1, y1, x2, y2], and with
    ``output_score`` the scores (B * post_n, 1).  Static shapes: nothing
    is read back to the host."""
    if iou_loss:
        raise MXNetError("Proposal: iou_loss=True not supported")
    top_boxes, top_scores = proposal_rows(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, rpn_min_size,
        scales, ratios, feature_stride)
    b, pre_n = top_scores.shape
    post_n = rpn_post_nms_top_n
    ids = greedy_nms(top_boxes, top_boxes.new_zeros((b, pre_n)), threshold,
                     force_suppress=True)
    alive = (ids >= 0) & torch.isfinite(top_scores)
    sel = torch.sort((~alive).to(torch.uint8), dim=1,
                     stable=True)[1][:, :post_n]
    keep = alive.gather(1, sel)
    out_boxes = torch.where(keep[..., None], top_boxes.gather(
        1, sel[..., None].expand(-1, -1, 4)), 0.0)
    out_scores = torch.where(keep, top_scores.gather(1, sel), 0.0)
    batch_idx = torch.arange(b, dtype=out_boxes.dtype,
                             device=out_boxes.device)[:, None, None]
    rois = torch.cat([batch_idx.expand(-1, out_boxes.shape[1], 1),
                      out_boxes], 2).reshape(-1, 5)
    if output_score:
        return rois, out_scores.reshape(-1, 1)
    return rois


# -------------------------------------------------------------------- CTCLoss
class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) as ``jnp.logaddexp``, with its gradient
    g * exp(a - out) (infinities read as 0): where both inputs are the
    recursion's log-zero, each gets the whole gradient (torch's rule
    would give each half)."""

    @staticmethod
    def forward(ctx, a, b):
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b, torch.maximum(a, b)
                          + torch.log1p(torch.exp(-torch.abs(delta))))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors

        def fin(x):
            return torch.where(torch.isinf(x), 0.0, x)
        return (g * torch.exp(fin(a) - fin(out)),
                g * torch.exp(fin(b) - fin(out)))


def _ctc_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return list(in_shapes), [None], None
    return list(in_shapes), [(data[1],)], None


@register("_contrib_CTCLoss", aliases=("CTCLoss", "ctc_loss"),
          arg_names=("data", "label"), infer_shape=_ctc_infer)
def _ctc_loss(data, label):
    """CTC's negative log-likelihood a sequence, (B,): ``data`` (T, B, A)
    activations (log-softmax taken here), ``label`` (B, L) class ids in
    1..A-1 padded with 0, blank 0, the label's length its nonzero
    entries.  The alpha recursion over the extended label (blank, l1,
    blank, ..., blank) in log space with -1e30 as log-zero, so a label
    that cannot fit in T steps gives a loss near 1e30."""
    t_len, b, _ = data.shape
    lab_w = label.shape[1]
    lp = torch.log_softmax(data, dim=2)
    labels = label.detach().to(torch.int64)
    label_len = (labels > 0).sum(1)
    s = 2 * lab_w + 1
    dev = data.device
    ext = torch.zeros((b, s), dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    neg = -1e30
    lae = _LogAddExp.apply
    first = lp[0].gather(1, ext[:, 1:2])[:, 0]
    alpha = torch.cat([lp[0, :, 0:1],
                       torch.where(label_len > 0, first, neg)[:, None],
                       torch.full((b, s - 2), neg, dtype=lp.dtype,
                                  device=dev)], 1)
    same = torch.cat([torch.ones((b, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], 1)
    no_skip = (ext == 0) | same
    pad1 = torch.full((b, 1), neg, dtype=lp.dtype, device=dev)
    pad2 = torch.full((b, 2), neg, dtype=lp.dtype, device=dev)
    for t in range(1, t_len):
        prev1 = torch.cat([pad1, alpha[:, :-1]], 1)
        prev2 = torch.cat([pad2, alpha[:, :-2]], 1)
        skip = torch.where(no_skip, neg, prev2)
        alpha = lae(lae(alpha, prev1), skip) + lp[t].gather(1, ext)
    last_blank = alpha.gather(1, (2 * label_len)[:, None])[:, 0]
    last_label = alpha.gather(
        1, torch.clamp(2 * label_len - 1, min=0)[:, None])[:, 0]
    return -lae(last_blank, torch.where(label_len > 0, last_label, neg))
