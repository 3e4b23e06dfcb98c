"""Spatial and warping operators (counterpart: mxnet_tpu/ops/spatial.py):
Crop, GridGenerator, BilinearSampler, SpatialTransformer, ROIPooling and
Correlation.

The JAX package writes them as XLA work, not Pallas kernels, and the port
as stock PyTorch ops with the same arithmetic: bilinear sampling as four
corner gathers and a weighted sum, Correlation as a static unroll over the
displacement grid.  None reads a value back to the host.

ROIPooling is the exception in form, not in result.  The JAX version masks
an (R, C, PH, PW, H, W) tensor and takes its max; XLA fuses the select into
the reduction, so the tensor is never built, but eager PyTorch would build
it (72 GB at Faster R-CNN's test width).  ``ROIPool`` computes the same
values a chunk of ROIs at a time, within ``ROI_CHUNK_BYTES`` of
temporaries, and writes its own backward: it saves the data, the ROIs and
the output, and gives each bin's gradient in equal parts to every position
of the bin equal to its max (the JAX package's rule for a max's ties),
summed over the bins a position lies in.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from .elemwise import _abs
from .registry import (register, parse_bool, parse_float, parse_int,
                       parse_str, parse_tuple)

__all__ = ["ROIPool", "roi_bins", "ROI_CHUNK_BYTES"]

# ROIPooling keeps its temporaries for a chunk of ROIs within about this
# many bytes a tensor (the chunk's gathered features and a few like it)
ROI_CHUNK_BYTES = 1 << 27


# ----------------------------------------------------------------------- Crop
def _crop_args(attrs):
    return ["data", "crop_like"] if int(attrs.get("num_args", 1)) > 1 \
        else ["data"]


def _crop_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], None
    h_w = parse_tuple(attrs.get("h_w", (0, 0)))
    if int(attrs.get("num_args", 1)) > 1:
        like = in_shapes[1]
        if like is None:
            return in_shapes, [None], None
        out = (data[0], data[1], like[2], like[3])
    else:
        out = (data[0], data[1], h_w[0], h_w[1])
    return list(in_shapes), [out], None


@register("Crop", arg_names=_crop_args,
          attr_types={"num_args": parse_int, "offset": parse_tuple,
                      "h_w": parse_tuple, "center_crop": parse_bool},
          defaults={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                    "center_crop": False},
          infer_shape=_crop_infer, key_var_num_args="num_args")
def _crop(data, crop_like=None, num_args=1, offset=(0, 0), h_w=(0, 0),
          center_crop=False):
    """``data`` cropped to (h, w) of ``h_w`` or of ``crop_like``'s spatial
    dims, at ``offset`` or centred; ``crop_like`` gives only its shape, so
    its gradient is zero."""
    if crop_like is not None:
        oh, ow = int(crop_like.shape[2]), int(crop_like.shape[3])
    else:
        oh, ow = int(h_w[0]), int(h_w[1])
    ih, iw = int(data.shape[2]), int(data.shape[3])
    if center_crop:
        y0, x0 = (ih - oh) // 2, (iw - ow) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    if y0 + oh > ih or x0 + ow > iw:
        raise MXNetError("Crop: offset+size exceeds input (%d+%d>%d or "
                         "%d+%d>%d)" % (y0, oh, ih, x0, ow, iw))
    return data[:, :, y0:y0 + oh, x0:x0 + ow]


# -------------------------------------------------------------- GridGenerator
def _grid_infer(attrs, in_shapes):
    data = in_shapes[0]
    tt = attrs.get("transform_type", "affine")
    if data is None:
        return in_shapes, [None], None
    if tt == "affine":
        th, tw = parse_tuple(attrs.get("target_shape", (0, 0)))
        return list(in_shapes), [(data[0], 2, th, tw)], None
    return list(in_shapes), [tuple(data)], None


@register("GridGenerator",
          attr_types={"transform_type": parse_str,
                      "target_shape": parse_tuple},
          defaults={"transform_type": "affine", "target_shape": (0, 0)},
          infer_shape=_grid_infer)
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid in [-1, 1], grid[:, 0] = x and grid[:, 1] = y.
    affine: ``data`` (N, 6) matrices applied to the target's normalised
    mesh, (N, 2, H, W); warp: ``data`` (N, 2, H, W) a flow added to each
    pixel's index, then normalised."""
    dt, dev = data.dtype, data.device
    if transform_type == "affine":
        th, tw = int(target_shape[0]), int(target_shape[1])
        xs = -1.0 + torch.arange(tw, dtype=dt, device=dev) * (2.0 / (tw - 1))
        ys = -1.0 + torch.arange(th, dtype=dt, device=dev) * (2.0 / (th - 1))
        dst = torch.stack([xs[None, :].expand(th, tw).reshape(-1),
                           ys[:, None].expand(th, tw).reshape(-1),
                           torch.ones(th * tw, dtype=dt, device=dev)])
        src = torch.matmul(data.reshape(-1, 2, 3), dst)   # (N, 2, H*W)
        return src.reshape(-1, 2, th, tw)
    if transform_type == "warp":
        h, w = int(data.shape[2]), int(data.shape[3])
        gx = torch.arange(w, dtype=dt, device=dev)[None, :].expand(h, w)
        gy = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
        return torch.stack([(data[:, 0] + gx) / ((w - 1) / 2.0),
                            (data[:, 1] + gy) / ((h - 1) / 2.0)], 1) - 1.0
    raise MXNetError("unknown transform_type %s" % transform_type)


# ------------------------------------------------------------ BilinearSampler
def _bilinear_sample(data, x_real, y_real):
    """``data`` (N, C, H, W) sampled at real coordinates x, y (N, P): four
    corner gathers, a corner outside the map weighted 0.  (N, C, P)."""
    n, c, ih, iw = data.shape
    x0 = torch.floor(x_real)
    y0 = torch.floor(y_real)
    wx = x_real - x0
    wy = y_real - y0
    flat = data.reshape(n, c, ih * iw)

    def corner(yc, xc, w):
        inb = (yc >= 0) & (yc < ih) & (xc >= 0) & (xc < iw)
        yi = yc.to(torch.int32).clamp(0, ih - 1).to(torch.int64)
        xi = xc.to(torch.int32).clamp(0, iw - 1).to(torch.int64)
        idx = (yi * iw + xi)[:, None, :].expand(n, c, yi.shape[1])
        vals = torch.gather(flat, 2, idx)                     # (N, C, P)
        return vals * (w * inb.to(w.dtype))[:, None, :]

    return (corner(y0, x0, (1 - wy) * (1 - wx))
            + corner(y0, x0 + 1, (1 - wy) * wx)
            + corner(y0 + 1, x0, wy * (1 - wx))
            + corner(y0 + 1, x0 + 1, wy * wx))


def _bs_infer(attrs, in_shapes):
    data, grid = (in_shapes + [None, None])[:2]
    out = None
    if data is not None and grid is not None:
        out = (data[0], data[1], grid[2], grid[3])
    return list(in_shapes), [out], None


@register("BilinearSampler", arg_names=("data", "grid"), infer_shape=_bs_infer)
def _bilinear_sampler(data, grid):
    """``data`` sampled at a normalised grid (N, 2, H', W') (grid[:, 0] = x,
    grid[:, 1] = y in [-1, 1]); reads outside the map are 0.  The gradients
    to both inputs are autograd's (``floor`` passes none)."""
    n, _, oh, ow = grid.shape
    ih, iw = data.shape[2], data.shape[3]
    gx = grid[:, 0].reshape(n, oh * ow)
    gy = grid[:, 1].reshape(n, oh * ow)
    x_real = (gx + 1) * (iw - 1) / 2.0
    y_real = (gy + 1) * (ih - 1) / 2.0
    out = _bilinear_sample(data, x_real, y_real)
    return out.reshape(n, data.shape[1], oh, ow)


# --------------------------------------------------------- SpatialTransformer
def _st_infer(attrs, in_shapes):
    data = in_shapes[0]
    ins = list(in_shapes)
    if data is not None:
        ins[1] = (data[0], 6)
    th, tw = parse_tuple(attrs.get("target_shape", (0, 0)))
    out = None if data is None else (data[0], data[1], th, tw)
    return ins, [out], None


@register("SpatialTransformer", arg_names=("data", "loc"),
          attr_types={"target_shape": parse_tuple, "transform_type": parse_str,
                      "sampler_type": parse_str},
          defaults={"target_shape": (0, 0), "transform_type": "affine",
                    "sampler_type": "bilinear"},
          infer_shape=_st_infer)
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear"):
    """GridGenerator (affine, from ``loc`` (N, 6)), then BilinearSampler."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports affine/bilinear")
    grid = _grid_generator(loc, transform_type="affine",
                           target_shape=target_shape)
    return _bilinear_sampler(data, grid)


# ----------------------------------------------------------------- ROIPooling
def _roi_infer(attrs, in_shapes):
    data, rois = (list(in_shapes) + [None, None])[:2]
    ph, pw = parse_tuple(attrs.get("pooled_size"))
    out = None
    if data is not None and rois is not None:
        out = (rois[0], data[1], ph, pw)
    return list(in_shapes), [out], None


def roi_bins(data, rois, ph, pw, spatial_scale):
    """(batch index (R,) int64, row mask (R, PH, H), column mask (R, PW, W))
    of ROIPooling: the ROI's corners rounded (half to even) after scaling,
    an inclusive extent of at least 1, floor/ceil bin edges clipped to the
    map, in the promoted dtype of the data and the ROIs."""
    n, _, h, w = data.shape
    dt = torch.promote_types(data.dtype, rois.dtype)
    r = rois.detach().to(dt)
    bidx = r[:, 0].to(torch.int32).to(torch.int64)
    bidx = torch.where(bidx < 0, bidx + n, bidx).clamp(0, n - 1)
    start_w = torch.round(r[:, 1] * spatial_scale)
    start_h = torch.round(r[:, 2] * spatial_scale)
    end_w = torch.round(r[:, 3] * spatial_scale)
    end_h = torch.round(r[:, 4] * spatial_scale)
    roi_h = torch.clamp(end_h - start_h + 1, min=1.0)
    roi_w = torch.clamp(end_w - start_w + 1, min=1.0)
    # divided by a tensor: PyTorch's CUDA division by a host scalar is a
    # product with its reciprocal, which moves a floor/ceil bin edge
    bin_h = roi_h / torch.full_like(roi_h, ph)
    bin_w = roi_w / torch.full_like(roi_w, pw)

    def mask(p, size, bin_, start):
        ps = torch.arange(p, dtype=dt, device=r.device)
        lo = torch.clamp(torch.floor(ps[None] * bin_[:, None])
                         + start[:, None], 0, size)
        hi = torch.clamp(torch.ceil((ps[None] + 1) * bin_[:, None])
                         + start[:, None], 0, size)
        at = torch.arange(size, dtype=dt, device=r.device)
        return (at[None, None] >= lo[:, :, None]) \
            & (at[None, None] < hi[:, :, None])
    return (bidx, mask(ph, h, bin_h, start_h), mask(pw, w, bin_w, start_w))


def _chunks(data, r):
    """Slices of ``r`` ROIs whose gathered features stay within
    ROI_CHUNK_BYTES."""
    per = data[0].numel() * data.element_size()
    step = max(1, ROI_CHUNK_BYTES // max(per, 1))
    return [slice(i, min(i + step, r)) for i in range(0, r, step)]


def _col_max(feat, m):
    """Each row's max over the columns of mask ``m`` (R, 1, 1, W): (R, C,
    H), -inf in an empty column bin."""
    return torch.where(m, feat, -float("inf")).amax(-1)


class ROIPool(torch.autograd.Function):
    """ROIPooling's values and the JAX package's gradient in bounded
    memory.  Forward, a chunk of ROIs at a time: each column bin's max of
    every row, then each row bin's max of those (the max of the bin's
    rectangle, exactly); empty bins 0.  Backward: a position of bin (i, j)
    equal to its max m gets g / count, count the positions of the bin
    equal to m.  Such a position's row has its column-bin max equal to m,
    and the position equals its row's max: so per column bin the rows
    whose max is m give the count (their equal positions summed) and the
    share, with no (R, C, PH, PW, H, W) tensor."""

    @staticmethod
    def forward(ctx, data, rois, ph, pw, spatial_scale):
        bidx, mask_h, mask_w = roi_bins(data, rois, ph, pw, spatial_scale)
        r = rois.shape[0]
        out = data.new_empty((r, data.shape[1], ph, pw))
        for sl in _chunks(data, r):
            feat = data.index_select(0, bidx[sl])
            cols = torch.stack([_col_max(feat, mask_w[sl, j, None, None])
                                for j in range(pw)], -1)     # (R, C, H, PW)
            for i in range(ph):
                mh = mask_h[sl, i][:, None, :, None]
                out[sl, :, i] = torch.where(mh, cols, -float("inf")).amax(2)
        out = torch.where(torch.isfinite(out), out, 0.0)
        ctx.save_for_backward(data, rois, out)
        ctx.args = (ph, pw, spatial_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois, out = ctx.saved_tensors
        ph, pw, spatial_scale = ctx.args
        bidx, mask_h, mask_w = roi_bins(data, rois, ph, pw, spatial_scale)
        grad = torch.zeros_like(data)
        for sl in _chunks(data, rois.shape[0]):
            feat = data.index_select(0, bidx[sl])
            gfeat = torch.zeros_like(feat)
            mh = mask_h[sl][:, None]                          # (R, 1, PH, H)
            for j in range(pw):
                m = mask_w[sl, j, None, None]                 # (R, 1, 1, W)
                cm = _col_max(feat, m)
                eq = (feat == cm[..., None]) & m              # row's maxima
                per_row = eq.sum(-1, dtype=data.dtype)         # (R, C, H)
                rows = (cm[:, :, None, :] == out[sl, :, :, j, None]) & mh
                count = (rows * per_row[:, :, None, :]).sum(-1)
                share = g[sl, :, :, j] / count.clamp(min=1)   # (R, C, PH)
                w = (rows * share[..., None]).sum(2)          # (R, C, H)
                gfeat += eq * w[..., None]
            grad.index_add_(0, bidx[sl], gfeat)
        return grad, None, None, None, None


@register("ROIPooling", arg_names=("data", "rois"),
          attr_types={"pooled_size": parse_tuple,
                      "spatial_scale": parse_float},
          infer_shape=_roi_infer)
def _roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0):
    """Each ROI [batch index, x1, y1, x2, y2] max-pooled into a fixed
    (ph, pw) grid over ``data`` (rounded corners, an inclusive extent,
    floor/ceil bin edges, empty bins 0): ``ROIPool``.  The ROIs get no
    gradient."""
    return ROIPool.apply(data, rois, int(pooled_size[0]),
                         int(pooled_size[1]), float(spatial_scale))


# ---------------------------------------------------------------- Correlation
def _corr_geometry(attrs, dshape):
    pad = int(attrs.get("pad_size", 0))
    ks = int(attrs.get("kernel_size", 1))
    md = int(attrs.get("max_displacement", 1))
    s1 = int(attrs.get("stride1", 1))
    s2 = int(attrs.get("stride2", 1))
    kr = (ks - 1) // 2
    border = md + kr
    padded_h = dshape[2] + 2 * pad
    padded_w = dshape[3] + 2 * pad
    top_h = int(_np.ceil((padded_h - border * 2) / float(s1)))
    top_w = int(_np.ceil((padded_w - border * 2) / float(s1)))
    ngr = md // s2
    ngw = ngr * 2 + 1
    return pad, ks, md, s1, s2, kr, border, top_h, top_w, ngr, ngw


def _corr_infer(attrs, in_shapes):
    d1 = in_shapes[0]
    if d1 is None:
        return list(in_shapes), [None], None
    (_, _, _, _, _, _, _, th, tw, _, ngw) = _corr_geometry(attrs, d1)
    return list(in_shapes), [(d1[0], ngw * ngw, th, tw)], None


@register("Correlation", arg_names=("data1", "data2"),
          attr_types={"kernel_size": parse_int, "max_displacement": parse_int,
                      "stride1": parse_int, "stride2": parse_int,
                      "pad_size": parse_int, "is_multiply": parse_bool},
          defaults={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                    "stride2": 1, "pad_size": 0, "is_multiply": True},
          infer_shape=_corr_infer)
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation: one output channel a displacement of the
    neighbourhood grid, each the mean over the kernel window and the
    channels of data1 x shift(data2) (|data1 - shift(data2)| for
    ``is_multiply=False``, whose gradient at 0 is +1, as ``jnp.abs``'s); a
    static unroll over the grid."""
    attrs = dict(kernel_size=kernel_size, max_displacement=max_displacement,
                 stride1=stride1, stride2=stride2, pad_size=pad_size)
    (pad, ks, md, s1, s2, kr, border, top_h, top_w, ngr,
     ngw) = _corr_geometry(attrs, data1.shape)
    c = data1.shape[1]
    p1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
    sumelems = ks * ks * c
    chans = []
    for pi in range(ngw):            # displacement rows
        for pj in range(ngw):        # displacement columns
            s2o = (pj - ngr) * s2
            s2p = (pi - ngr) * s2
            acc = 0
            for kh in range(-kr, kr + 1):
                for kw in range(-kr, kr + 1):
                    y1 = border + kh
                    x1 = border + kw
                    a = p1[:, :, y1:y1 + top_h * s1:s1,
                           x1:x1 + top_w * s1:s1]
                    b = p2[:, :, y1 + s2p:y1 + s2p + top_h * s1:s1,
                           x1 + s2o:x1 + s2o + top_w * s1:s1]
                    if is_multiply:
                        acc = acc + (a * b).sum(1)
                    else:
                        acc = acc + _abs(a - b).sum(1)
            chans.append(acc / sumelems)
    return torch.stack(chans, 1)
