"""Neural-network layers (counterpart: mxnet_tpu/ops/nn.py):
FullyConnected, Activation, SoftmaxActivation, Convolution, Pooling,
BatchNorm, the executor-fused _BatchNormReLU and Dropout.  Their backward
is autograd's, except where the JAX package writes its own: BatchNorm and
BatchNorm+ReLU in training (``BatchNormTrain``, ``BatchNormReLUTrain``,
counterparts of its custom VJPs ``_bn_train_core`` and
``_bn_relu_train_core``), the executor's fused input BatchNorm + stem
convolution (``InputBNConv``, counterpart of ``_input_bn_conv_core``) and
the max-pool equality-mask backward of ``MXNET_POOL_MASK_BWD``
(``MaxPoolMask``).

Under a data-parallel ``TrainStep`` (``global_batch_stats``) the training
BatchNorms take their statistics over the global batch, as the JAX
package's one GSPMD program does: the per-channel sums are all-reduced
across the ``dp`` group in the forward, and the backward all-reduces the
sums its data gradient needs (the parameter gradients stay the rank's
own, summed later with every other gradient).

Convolution and pooling call PyTorch's own (cuDNN on the card), as the JAX
package leaves them to XLA.  With ``layout='NHWC'`` (set by the executor's
layout pass) the activation arrives channel-last; it is handed to PyTorch as
a permuted view, which PyTorch treats as a ``channels_last`` tensor.
"""
from __future__ import annotations

import contextlib
import itertools
import threading

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import promoted, relu
from .registry import (register, parse_bool, parse_float, parse_int,
                       parse_str, parse_tuple, shape_is_complete)


def _to_cf(x):
    return torch.movedim(x, -1, 1)


def _to_cl(x):
    return torch.movedim(x, 1, -1)


def _tup(v, n, default):
    v = tuple(v) if v else ()
    return v + (default,) * (n - len(v))


# --------------------------------------------------------------- FullyConnected
def _fc_args(attrs):
    return ["data", "weight"] if attrs.get("no_bias", False) else \
        ["data", "weight", "bias"]


def _fc_infer(attrs, in_shapes):
    nh = int(attrs.get("num_hidden"))
    data = in_shapes[0]
    ins = list(in_shapes)
    if data is not None and shape_is_complete(data[1:]):
        ins[1] = (nh, int(_np.prod(data[1:])))
    if len(ins) > 2:
        ins[2] = (nh,)
    out = None if data is None else (data[0], nh)
    return ins, [out], None


def _fc_infer_backward(attrs, out_shapes, in_shapes):
    """A 2-D data shape deduced from the output and the weight (the
    backward half of shape inference: an RNN's begin state gets its batch
    through a shared h2h weight)."""
    out = out_shapes[0]
    weight = in_shapes[1] if len(in_shapes) > 1 else None
    ins = [None] * len(in_shapes)
    if out is None:
        return ins
    data = in_shapes[0]
    if weight is not None and (data is None or
                               (len(data) == 2 and 0 in data)):
        ins[0] = (out[0], weight[1])
    elif data is not None and data[0] == 0 and out[0] != 0:
        ins[0] = (out[0],) + tuple(data[1:])
    return ins


@register("FullyConnected", arg_names=_fc_args,
          attr_types={"num_hidden": parse_int, "no_bias": parse_bool},
          defaults={"no_bias": False}, infer_shape=_fc_infer,
          infer_shape_backward=_fc_infer_backward)
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False):
    """y = x·Wᵀ + b, at the promoted dtype of the three"""
    return F.linear(*promoted(data.reshape(data.shape[0], -1), weight, bias))


# ------------------------------------------------------------------ Activation
@register("Activation", attr_types={"act_type": parse_str},
          defaults={"act_type": "relu"}, layout_rule="transparent")
def _activation(data, act_type="relu"):
    if act_type == "relu":
        return relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    raise MXNetError("unknown act_type %s" % act_type)


@register("SoftmaxActivation", attr_types={"mode": parse_str},
          defaults={"mode": "instance"})
def _softmax_activation(data, mode="instance"):
    """Softmax over axis 1 (``channel``) or over every axis after the first
    (``instance``); autograd's gradient."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


# ----------------------------------------------------------------- Convolution
def _conv_args(attrs):
    return ["data", "weight"] if attrs.get("no_bias", False) else \
        ["data", "weight", "bias"]


def _conv_out_dim(i, k, s, p, d):
    return (i + 2 * p - (d * (k - 1) + 1)) // s + 1


def _conv_infer(attrs, in_shapes):
    data = in_shapes[0]
    nf = int(attrs.get("num_filter"))
    ng = int(attrs.get("num_group", 1))
    kernel = parse_tuple(attrs.get("kernel"))
    nd = len(kernel)
    stride = _tup(parse_tuple(attrs.get("stride", ())), nd, 1)
    pad = _tup(parse_tuple(attrs.get("pad", ())), nd, 0)
    dilate = _tup(parse_tuple(attrs.get("dilate", ())), nd, 1)
    ins = list(in_shapes)
    out = None
    if data is not None:
        ins[1] = (nf, data[1] // ng) + kernel
        spatial = tuple(_conv_out_dim(i, k, s, p, d) for i, k, s, p, d
                        in zip(data[2:], kernel, stride, pad, dilate))
        out = (data[0], nf) + spatial
    if len(ins) > 2:
        ins[2] = (nf,)
    return ins, [out], None


_CONV_ATTRS = {"kernel": parse_tuple, "stride": parse_tuple,
               "dilate": parse_tuple, "pad": parse_tuple,
               "num_filter": parse_int, "num_group": parse_int,
               "workspace": parse_int, "no_bias": parse_bool,
               "cudnn_tune": parse_str, "cudnn_off": parse_bool,
               "layout": parse_str}
_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("Convolution_v1",), arg_names=_conv_args,
          attr_types=_CONV_ATTRS,
          defaults={"stride": (), "dilate": (), "pad": (), "num_group": 1,
                    "no_bias": False},
          infer_shape=_conv_infer, layout_rule="aware")
def _convolution(data, weight, bias=None, kernel=None, stride=(), dilate=(),
                 pad=(), num_filter=None, num_group=1, workspace=None,
                 no_bias=False, cudnn_tune=None, cudnn_off=False,
                 layout=None):
    """N-D convolution; the weight keeps its logical (O, I, *k) shape."""
    nd = len(kernel)
    if nd not in _CONV_FN:
        raise MXNetError("Convolution supports 1-3 spatial dims")
    x = _to_cf(data) if layout == "NHWC" else data
    out = _CONV_FN[nd](x, weight, bias, stride=_tup(stride, nd, 1),
                       padding=_tup(pad, nd, 0),
                       dilation=_tup(dilate, nd, 1), groups=num_group)
    return _to_cl(out) if layout == "NHWC" else out


# --------------------------------------------------------------------- Pooling
def _pool_out_dim(i, k, s, p, convention):
    if convention == "full":
        return int(_np.ceil(float(i + 2 * p - k) / s)) + 1
    return (i + 2 * p - k) // s + 1


def _pool_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], None
    if attrs.get("global_pool", False):
        return in_shapes, [data[:2] + (1,) * (len(data) - 2)], None
    kernel = parse_tuple(attrs.get("kernel"))
    nd = len(kernel)
    stride = _tup(parse_tuple(attrs.get("stride", ())), nd, 1)
    pad = _tup(parse_tuple(attrs.get("pad", ())), nd, 0)
    conv = attrs.get("pooling_convention", "valid")
    spatial = tuple(_pool_out_dim(i, k, s, p, conv)
                    for i, k, s, p in zip(data[2:], kernel, stride, pad))
    return in_shapes, [data[:2] + spatial], None


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pad_widths(pads):
    """F.pad's widths (last axis first) of per-axis (low, high) pads."""
    widths = []
    for lo, hi in reversed(pads):
        widths += [lo, hi]
    return widths


class MaxPoolMask(torch.autograd.Function):
    """Max pooling whose backward is the equality mask (parity:
    mxnet_tpu/ops/nn.py ``_max_pool_core``, the reference's unpool): every
    element equal to its window's maximum takes that window's gradient,
    where PyTorch's own backward routes it to one of the tied maxima only.
    x is channel-first (N, C, *spatial); pads are per-axis (low, high),
    filled with -inf.  Taken for ``mask_bwd`` (MXNET_POOL_MASK_BWD=1)."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pads):
        xp = F.pad(x, _pad_widths(pads), value=float("-inf"))
        out = _MAX_POOL[len(kernel)](xp, kernel, stride)
        ctx.save_for_backward(xp, out)
        ctx.geom = (kernel, stride, pads, tuple(x.shape))
        return out

    @staticmethod
    def backward(ctx, dy):
        """dx[i] = sum over the windows w holding i of dy[w] * (x[i] ==
        max[w]), one kernel tap at a time: the tap's strided view of the
        padded input is compared with the pooled maxima."""
        xp, out = ctx.saved_tensors
        kernel, stride, pads, shape = ctx.geom
        dxp = torch.zeros_like(xp)
        for tap in itertools.product(*[range(k) for k in kernel]):
            idx = (Ellipsis,) + tuple(
                slice(t, t + s * (o - 1) + 1, s)
                for t, s, o in zip(tap, stride, out.shape[2:]))
            dxp[idx] += torch.where(xp[idx] == out, dy, 0.0)
        crop = (Ellipsis,) + tuple(slice(lo, lo + n)
                                   for (lo, _), n in zip(pads, shape[2:]))
        return dxp[crop], None, None, None


@register("Pooling", aliases=("Pooling_v1",),
          attr_types={"kernel": parse_tuple, "stride": parse_tuple,
                      "pad": parse_tuple, "pool_type": parse_str,
                      "global_pool": parse_bool,
                      "pooling_convention": parse_str, "layout": parse_str,
                      "mask_bwd": parse_bool},
          defaults={"stride": (), "pad": (), "pool_type": "max",
                    "global_pool": False, "pooling_convention": "valid"},
          env_attrs={"mask_bwd": ("MXNET_POOL_MASK_BWD", "0")},
          infer_shape=_pool_infer, layout_rule="aware")
def _pooling(data, kernel=None, stride=(), pad=(), pool_type="max",
             global_pool=False, pooling_convention="valid", layout=None,
             mask_bwd=None):
    """N-D max/avg/sum pooling (parity: mxnet_tpu/ops/nn.py _pooling).

    The low side pads by ``pad``; the high side pads as far as the
    convention needs ('full' rounds the output up).  Max pads with -inf;
    avg divides by the window clipped to dim+pad (count_include_pad)."""
    x = _to_cf(data) if layout == "NHWC" else data
    nd = x.dim() - 2
    sp_shape = tuple(x.shape[2:])
    if global_pool:
        kernel, stride, pad = sp_shape, (1,) * nd, (0,) * nd
    else:
        kernel = tuple(kernel)
        stride = _tup(stride, nd, 1)
        pad = _tup(pad, nd, 0)
    conv = "valid" if global_pool else pooling_convention
    outs = [_pool_out_dim(i, k, s, p, conv)
            for i, k, s, p in zip(sp_shape, kernel, stride, pad)]
    highs = [max((o - 1) * s + k - i - p, p)
             for i, k, s, p, o in zip(sp_shape, kernel, stride, pad, outs)]
    if pool_type == "max" and mask_bwd and not global_pool \
            and x.is_floating_point():
        # the reference's tie semantics in the backward (MXNET_POOL_MASK_BWD,
        # resolved to the mask_bwd attr at dispatch)
        out = MaxPoolMask.apply(x, kernel, stride, tuple(zip(pad, highs)))
    elif pool_type == "max" and highs == list(pad) \
            and all(2 * p <= k for p, k in zip(pad, kernel)):
        # symmetric pad: PyTorch's pooling pads with -inf itself
        out = _MAX_POOL[nd](x, kernel, stride, padding=pad)
    else:
        fill = float("-inf") if pool_type == "max" else 0.0
        widths = _pad_widths(list(zip(pad, highs)))
        xp = F.pad(x, widths, value=fill) if any(widths) else x
        if pool_type == "max":
            out = _MAX_POOL[nd](xp, kernel, stride)
        elif pool_type in ("avg", "sum"):
            out = _AVG_POOL[nd](xp, kernel, stride) * float(_np.prod(kernel))
            if pool_type == "avg":
                cnt = None
                for ax, (i, k, s, p, o) in enumerate(
                        zip(sp_shape, kernel, stride, pad, outs)):
                    # the counts are made on the output's device: a copy
                    # from host memory would wait for the device
                    starts = torch.arange(o, device=out.device) * s - p
                    d = (torch.clamp(starts + k, max=i + p) - starts).to(
                        out.dtype)
                    d = d.reshape((o,) + (1,) * (nd - ax - 1))
                    cnt = d if cnt is None else cnt * d
                out = out / cnt
        else:
            raise MXNetError("unknown pool_type %s" % pool_type)
    return _to_cl(out) if layout == "NHWC" else out


# ------------------------------------------------------------------- BatchNorm
_STATS = threading.local()


@contextlib.contextmanager
def global_batch_stats(sync):
    """Within the block, training BatchNorms take their statistics over the
    global batch: ``sync`` is ``(group, size)``, the data-parallel group
    and its rank count (None: this process's batch alone)."""
    prev = getattr(_STATS, "sync", None)
    _STATS.sync = sync
    try:
        yield
    finally:
        _STATS.sync = prev


def stats_sync():
    """The ``(group, size)`` of the enclosing ``global_batch_stats``, or
    None."""
    return getattr(_STATS, "sync", None)


def bn_scale_shift(gamma, beta, mean, var, eps, fix_gamma, dtype):
    """Per-channel (scale, shift) of an inference BatchNorm, in the
    accumulation dtype (at least float32)."""
    acc = torch.promote_types(dtype, torch.float32)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(var.to(acc) + eps)
    scale = g.to(acc) * inv
    shift = beta.to(acc) - mean.to(acc) * scale
    return scale, shift


def _bn_axes(ndim, caxis):
    """(the reduced axes, the per-channel broadcast shape) for channel axis
    ``caxis``."""
    caxis %= ndim
    axes = tuple(a for a in range(ndim) if a != caxis)
    return axes, [-1 if a == caxis else 1 for a in range(ndim)]


def _bn_train_fwd(x, g, b, eps, caxis):
    """Batch statistics and the normalised output (parity:
    ``_bn_train_fwd_impl``): the statistics accumulate in at least float32,
    var = E[x^2] - mean^2 clamped at 0, and the affine step runs in x's
    dtype with scale and shift cast down.  Returns (out, mean, var, inv)."""
    axes, cshape = _bn_axes(x.dim(), caxis)
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    sync = stats_sync()
    if sync is None:
        mean = x32.mean(dim=axes)
        var = (x32 * x32).mean(dim=axes) - mean * mean
    else:
        # sum x and sum x^2 over every rank's rows
        from ..parallel.dist import all_reduce_
        group, size = sync
        s = all_reduce_(torch.stack([x32.sum(dim=axes),
                                     (x32 * x32).sum(dim=axes)]),
                        group, "stats")
        n = x32.numel() // x32.shape[caxis % x.dim()] * size
        mean = s[0] / n
        var = s[1] / n - mean * mean
    var = var.clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    scale = g.to(acc) * inv
    shift = b.to(acc) - mean * scale
    out = x * scale.reshape(cshape).to(x.dtype) \
        + shift.reshape(cshape).to(x.dtype)
    return out, mean, var, inv


def _bn_bwd_shared(caxis, x, g, mean, inv, dy, dmean_ct, dvar_ct):
    """BatchNorm's training backward (parity: ``_bn_bwd_shared``): per-channel
    reductions of dy and dy*x in at least float32, folded with the
    cotangents of the mean and var outputs into dx = A*dy + B*x + C.
    Returns (dx, dgamma, dbeta)."""
    axes, cshape = _bn_axes(x.dim(), caxis)
    acc = torch.promote_types(x.dtype, torch.float32)
    n = 1
    for a in axes:
        n *= x.shape[a]
    g32 = g.to(acc)
    sum_dy = dy.to(acc).sum(dim=axes)
    sum_dy_x = (dy * x).to(acc).sum(dim=axes)
    sum_dy_xhat = inv * (sum_dy_x - mean * sum_dy)
    dg, db = sum_dy_xhat, sum_dy
    sync = stats_sync()
    if sync is not None:
        # dx needs the global sums and the statistics' cotangents summed
        # over the ranks; dgamma and dbeta stay this rank's
        from ..parallel.dist import all_reduce_
        group, size = sync
        cts = [c for c in (dmean_ct, dvar_ct) if c is not None]
        s = all_reduce_(torch.stack([sum_dy, sum_dy_x]
                                    + [c.to(acc) for c in cts]),
                        group, "stats")
        sum_dy, sum_dy_x = s[0], s[1]
        rest = iter(s[2:])
        dmean_ct = None if dmean_ct is None else next(rest)
        dvar_ct = None if dvar_ct is None else next(rest)
        sum_dy_xhat = inv * (sum_dy_x - mean * sum_dy)
        n *= size
    # dL/dvar = -1/2 inv^2 g sum(dy*xhat): inv^2, because xhat carries one
    # factor of inv already
    dvar = -0.5 * inv ** 2 * g32 * sum_dy_xhat
    dmean = -inv * g32 * sum_dy
    if dvar_ct is not None:
        dvar = dvar + dvar_ct.to(acc)
    if dmean_ct is not None:
        dmean = dmean + dmean_ct.to(acc)
    coef_dy = g32 * inv
    coef_x = 2.0 * dvar / n
    coef_1 = dmean / n - coef_x * mean
    dx = dy * coef_dy.reshape(cshape).to(x.dtype) \
        + x * coef_x.reshape(cshape).to(x.dtype) \
        + coef_1.reshape(cshape).to(x.dtype)
    return dx, dg.to(g.dtype), db.to(g.dtype)


class BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm with the JAX package's hand-written backward
    (counterpart: ``_bn_train_core``): ``apply(x, g, b, eps, caxis)`` ->
    (out, mean, var), mean and var in at least float32.  The only
    activation-sized tensor saved is x."""

    @staticmethod
    def forward(ctx, x, g, b, eps, caxis):
        out, mean, var, inv = _bn_train_fwd(x, g, b, eps, caxis)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.caxis = caxis
        ctx.sync = stats_sync()
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, g, mean, inv = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        with global_batch_stats(ctx.sync):
            dx, dg, db = _bn_bwd_shared(ctx.caxis, x, g, mean, inv, dy,
                                        dmean, dvar)
        return dx, dg, db, None, None


class BatchNormReLUTrain(torch.autograd.Function):
    """Training-mode BatchNorm followed by ReLU (counterpart:
    ``_bn_relu_train_core``): saves x, g, b, mean and inv, not the BN
    output; the backward recomputes the pre-activation in x's dtype, gates
    dy with ``pre > 0`` (the gradient is 0 at 0, as in the JAX package's
    fused op) and reuses the shared backward."""

    @staticmethod
    def forward(ctx, x, g, b, eps, caxis):
        out, mean, var, inv = _bn_train_fwd(x, g, b, eps, caxis)
        ctx.save_for_backward(x, g, b, mean, inv)
        ctx.caxis = caxis
        ctx.sync = stats_sync()
        ctx.set_materialize_grads(False)
        return torch.relu(out), mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, g, b, mean, inv = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        _, cshape = _bn_axes(x.dim(), ctx.caxis)
        acc = mean.dtype
        scale = g.to(acc) * inv
        shift = b.to(acc) - mean * scale
        pre = x * scale.reshape(cshape).to(x.dtype) \
            + shift.reshape(cshape).to(x.dtype)
        dy = torch.where(pre > 0, dy, 0.0)
        with global_batch_stats(ctx.sync):
            dx, dg, db = _bn_bwd_shared(ctx.caxis, x, g, mean, inv, dy,
                                        dmean, dvar)
        return dx, dg, db, None, None


def _bn_moving(moving, stat, momentum):
    """moving * mom + stat * (1 - mom), with mom rounded to float32 first
    as the JAX package's ``jnp.float32(momentum)`` is (so a float64 run
    matches it), in promote(moving, float32)."""
    mom = _np.float32(momentum)
    moving = moving.to(torch.promote_types(moving.dtype, torch.float32))
    return moving * float(mom) \
        + stat.detach().to(moving.dtype) * float(_np.float32(1) - mom)


def _bn_infer(attrs, in_shapes):
    data = in_shapes[0]
    c = None if data is None else (data[1],)
    ins = [data] + [c] * (len(in_shapes) - 1)
    nout = 3 if attrs.get("output_mean_var", False) else 1
    outs = [data] + ([c, c] if nout == 3 else [])
    return ins, outs, [c, c]


_BN_ATTRS = {"eps": parse_float, "momentum": parse_float,
             "fix_gamma": parse_bool, "use_global_stats": parse_bool,
             "output_mean_var": parse_bool, "layout": parse_str}
_BN_DEFAULTS = {"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                "use_global_stats": False, "output_mean_var": False}


def _bn_train(fn, data, gamma, beta, moving_mean, moving_var, eps, momentum,
              fix_gamma, layout):
    """The training branch of BatchNorm and _BatchNormReLU: ``fn`` (one of
    the two Functions) on the batch statistics, and the moving statistics
    updated from them, detached.  Returns (out, mean, var, new moving_mean,
    new moving_var)."""
    caxis = data.dim() - 1 if layout == "NHWC" else 1
    g = torch.ones_like(gamma) if fix_gamma else gamma
    out, mean, var = fn.apply(data, g, beta, float(eps), caxis)
    return (out, mean, var, _bn_moving(moving_mean, mean, momentum),
            _bn_moving(moving_var, var, momentum))


@register("BatchNorm", arg_names=("data", "gamma", "beta", "moving_mean",
                                  "moving_var"),
          aux_names=("moving_mean", "moving_var"),
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var", False)
          else 1,
          attr_types=_BN_ATTRS, defaults=_BN_DEFAULTS,
          infer_shape=_bn_infer, train_aware=True, layout_rule="aware")
def _batch_norm(data, gamma, beta, moving_mean, moving_var, is_train=False,
                eps=1e-3, momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, layout=None):
    """Batch normalization (parity: mxnet_tpu/ops/nn.py _batch_norm).
    Returns (out[, mean, var], moving_mean, moving_var): in training, the
    batch statistics normalise and the trailing two are the updated moving
    statistics, which the executor collects; otherwise the moving statistics
    normalise and come back unchanged.  ``fix_gamma`` normalises with a
    gamma of ones, so gamma's gradient is zero."""
    if is_train and not use_global_stats:
        out, mean, var, new_mm, new_mv = _bn_train(
            BatchNormTrain, data, gamma, beta, moving_mean, moving_var, eps,
            momentum, fix_gamma, layout)
        if output_mean_var:
            return out, mean, var, new_mm, new_mv
        return out, new_mm, new_mv
    caxis = data.dim() - 1 if layout == "NHWC" else 1
    cshape = [1] * data.dim()
    cshape[caxis] = -1
    scale, shift = bn_scale_shift(gamma, beta, moving_mean, moving_var, eps,
                                  fix_gamma, data.dtype)
    out = data * scale.reshape(cshape).to(data.dtype) \
        + shift.reshape(cshape).to(data.dtype)
    if output_mean_var:
        acc = scale.dtype
        return out, moving_mean.to(acc), moving_var.to(acc), moving_mean, \
            moving_var
    return out, moving_mean, moving_var


@register("_BatchNormReLU", arg_names=("data", "gamma", "beta", "moving_mean",
                                       "moving_var"),
          aux_names=("moving_mean", "moving_var"), num_outputs=1,
          attr_types=_BN_ATTRS, defaults=_BN_DEFAULTS,
          infer_shape=_bn_infer, train_aware=True, layout_rule="aware")
def _batch_norm_relu(data, gamma, beta, moving_mean, moving_var,
                     is_train=False, eps=1e-3, momentum=0.9, fix_gamma=True,
                     use_global_stats=False, output_mean_var=False,
                     layout=None):
    """Executor-fused BatchNorm + ReLU.  In training its backward
    recomputes the ReLU gate from the saved input (``BatchNormReLUTrain``)
    instead of keeping the BatchNorm output alive."""
    if is_train and not use_global_stats:
        out, _, _, new_mm, new_mv = _bn_train(
            BatchNormReLUTrain, data, gamma, beta, moving_mean, moving_var,
            eps, momentum, fix_gamma, layout)
        return out, new_mm, new_mv
    res = _batch_norm(data, gamma, beta, moving_mean, moving_var,
                      is_train=is_train, eps=eps, momentum=momentum,
                      fix_gamma=fix_gamma, use_global_stats=use_global_stats,
                      layout=layout)
    return (relu(res[0]),) + tuple(res[1:])


# ------------------------------------------------- fused input-BN + stem conv
def _s2d_eligible(x_shape, geom):
    """Space-to-depth applies when both strides are 2, the input's spatial
    dims are even, and the packed stride-1 conv gives the strided conv's
    output extent: it always gives H/2, which is floor((H + 2p - k)/2) + 1
    only when k - 2p is 1 or 2 (the 7x7/p3 ImageNet stem qualifies)."""
    k, s, p = geom
    return (tuple(s) == (2, 2)
            and x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0
            and k[0] - 2 * p[0] in (1, 2) and k[1] - 2 * p[1] in (1, 2))


def _s2d_taps(geom):
    """Where each tap (ih, iw) of the strided conv lands in the packed
    stride-1 conv (parity: ``_s2d_pack_weights``): input row 2i - p + kh
    splits into parity a = (kh - p) % 2 and packed tap u = (kh - p - a) / 2.
    Returns ((kh, kw) index arrays of the packed channel group a*2 + b, of
    the packed row and of the packed column), the packed kernel (khp, kwp)
    and the packed padding ((top, bottom), (left, right))."""
    k, _, p = geom

    def taps(kdim, pad):
        ms = [t - pad for t in range(kdim)]
        us = [(m - (m % 2)) // 2 for m in ms]
        return _np.array(us) - min(us), _np.array([m % 2 for m in ms]), \
            min(us), max(us)
    uh, ah, uhmin, uhmax = taps(k[0], p[0])
    uw, aw, uwmin, uwmax = taps(k[1], p[1])
    q = ah[:, None] * 2 + aw[None, :]
    rows = _np.broadcast_to(uh[:, None], q.shape)
    cols = _np.broadcast_to(uw[None, :], q.shape)
    return ((torch.as_tensor(q), torch.as_tensor(rows.copy()),
             torch.as_tensor(cols.copy())),
            (uhmax - uhmin + 1, uwmax - uwmin + 1),
            ((-uhmin, uhmax), (-uwmin, uwmax)))


def _s2d_pack_weights(w, geom):
    """Logical (O, C, kh, kw) stem weights -> the packed (O, 4C, khp, kwp)
    weights of the space-to-depth conv (packed channel (a*2 + b)*C + c),
    and the packed padding."""
    o, c = w.shape[:2]
    idx, (khp, kwp), pads = _s2d_taps(geom)
    wp = w.new_zeros((4, khp, kwp, o, c))
    wp[idx] = w.permute(2, 3, 0, 1)
    return wp.permute(3, 0, 4, 1, 2).reshape(o, 4 * c, khp, kwp), pads


def _s2d_unpack_weight_grad(dwp, geom):
    """The gradient of the logical weights from that of the packed ones:
    the transpose of ``_s2d_pack_weights``'s scatter."""
    o, c4, khp, kwp = dwp.shape
    idx, _, _ = _s2d_taps(geom)
    dwp = dwp.reshape(o, 4, c4 // 4, khp, kwp).permute(1, 3, 4, 0, 2)
    return dwp[idx].permute(2, 3, 0, 1)


def _s2d_pack_input(y):
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel (a*2 + b)*C + c."""
    n, h, w_, c = y.shape
    y = y.reshape(n, h // 2, 2, w_ // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h // 2, w_ // 2, 4 * c)


def _stem_operands(y, w, geom, s2d):
    """(input as an NCHW view, weight, stride, padding) of the stem
    convolution, packed by space-to-depth when ``s2d`` and eligible."""
    k, s, p = geom
    if s2d and _s2d_eligible(y.shape, geom):
        wp, ((t, b), (l, r)) = _s2d_pack_weights(w, geom)
        yp = F.pad(_s2d_pack_input(y).permute(0, 3, 1, 2), (l, r, t, b))
        return yp, wp, (1, 1), (0, 0)
    return y.permute(0, 3, 1, 2), w, tuple(s), tuple(p)


def _stem_conv(y, w, geom, s2d=False):
    """The stem convolution of channel-last ``y`` with logical (O, C, kh,
    kw) ``w``, via space-to-depth when eligible and ``s2d`` (parity:
    ``_stem_conv``; MXNET_STEM_S2D, default off, resolved by the
    executor); channel-last out."""
    inp, wt, s, p = _stem_operands(y, w, geom, s2d)
    return F.conv2d(inp, wt, stride=s, padding=p).permute(0, 2, 3, 1)


def _ibc_normalise(x, b, mean, inv):
    """x * inv + (b - mean * inv), inv and the shift cast to x's dtype:
    ``_bn_train_fwd``'s output with a gamma of ones, from its statistics
    (the backward recomputes it)."""
    shift = b.to(inv.dtype) - mean * inv
    return x * inv.reshape(1, 1, 1, -1).to(x.dtype) \
        + shift.reshape(1, 1, 1, -1).to(x.dtype)


def _ibc_fwd_impl(x, b, w, eps, geom, s2d):
    """Forward of the fused input BatchNorm(fix_gamma) + Convolution
    (parity: ``_ibc_fwd_impl``): channel-last x, logical w; returns
    (conv out channel-last, mean, var, inv), the statistics those of
    ``_bn_train_fwd`` with a gamma of ones."""
    y, mean, var, inv = _bn_train_fwd(x, torch.ones_like(b), b, eps, -1)
    return _stem_conv(y, w, geom, s2d), mean, var, inv


def _ibc_tap_ranges(in_dim, out_dim, k, s, p, device):
    """Per tap, the inclusive range of output indices whose input tap stays
    in bounds (tap t at output i reads input s*i - p + t): (lo, hi), two
    (k,) int64 tensors made on ``device``, so that indexing with them
    never copies from the host (which would wait for the device)."""
    t = torch.arange(k, device=device)
    # ceil((p - t) / s) = -floor((t - p) / s), clamped
    lo = torch.clamp(-torch.div(t - p, s, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(in_dim - 1 + p - t, s,
                               rounding_mode="floor"), max=out_dim - 1)
    return lo, hi


class InputBNConv(torch.autograd.Function):
    """BatchNorm(train, fix_gamma) on an input with no gradient, fused with
    the Convolution that consumes it: the ResNet stem bn_data -> conv0
    (counterpart: ``_input_bn_conv_core``).  ``apply(x, beta, w, eps,
    geom, s2d)`` with x channel-last and w logical returns (out
    channel-last, mean, var); mean and var carry no gradient.

    The backward takes dW by the weight gradient of the conv on the
    recomputed normalised input, and d(beta) without the data gradient of
    the conv: summed over the whole input grid, the transposed conv of the
    cotangent collapses, per kernel tap, to a rectangle sum of sum_n(g) over
    the outputs whose tap stays in bounds (2-D prefix sums), contracted with
    the weights.  dx is a hard zero: the executor fuses only an input
    declared gradient-free."""

    @staticmethod
    def forward(ctx, x, b, w, eps, geom, s2d):
        out, mean, var, inv = _ibc_fwd_impl(x, b, w, eps, geom, s2d)
        ctx.save_for_backward(x, b, w, mean, inv)
        ctx.geom, ctx.s2d = geom, s2d
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        x, b, w, mean, inv = ctx.saved_tensors
        k, s, p = ctx.geom
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        if g is None:
            return dx, None, None, None, None, None
        dw = db = None
        if ctx.needs_input_grad[2]:
            inp, wt, st, pd = _stem_operands(
                _ibc_normalise(x, b, mean, inv), w, ctx.geom, ctx.s2d)
            _, dw, _ = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), inp, wt, None, list(st), list(pd),
                [1, 1], False, [0, 0], 1, [False, True, False])
            if wt is not w:
                dw = _s2d_unpack_weight_grad(dw, ctx.geom)
        if ctx.needs_input_grad[1]:
            acc = inv.dtype
            big = g.to(acc).sum(dim=0)                          # (Ho, Wo, O)
            pre = F.pad(big.cumsum(0).cumsum(1), (0, 0, 1, 0, 1, 0))
            r0, r1 = (v[:, None] for v in _ibc_tap_ranges(
                x.shape[1], g.shape[1], k[0], s[0], p[0], pre.device))
            c0, c1 = (v[None, :] for v in _ibc_tap_ranges(
                x.shape[2], g.shape[2], k[1], s[1], p[1], pre.device))
            empty = (r0 > r1) | (c0 > c1)
            # an empty range's corners may fall off the table: clamp them
            # in (its sum is masked to 0 below)
            r0, c0 = r0.clamp(max=g.shape[1]), c0.clamp(max=g.shape[2])
            r1, c1 = r1.clamp(min=-1), c1.clamp(min=-1)
            taps = (pre[r1 + 1, c1 + 1] - pre[r0, c1 + 1]
                    - pre[r1 + 1, c0] + pre[r0, c0])           # (kh, kw, O)
            taps = torch.where(empty[..., None], 0.0, taps)
            db = torch.einsum("ocij,ijo->c", w.to(acc), taps).to(b.dtype)
        return dx, db, dw, None, None, None


def input_bn_conv(x_cl, beta, weight, eps, kernel, stride, pad, s2d=False):
    """The executor's entry: the fused training input BatchNorm + conv,
    channel-last (parity: ``input_bn_conv``).  Returns (out channel-last,
    mean, var), mean and var for the moving statistics."""
    geom = (tuple(int(v) for v in kernel), tuple(int(v) for v in stride),
            tuple(int(v) for v in pad))
    return InputBNConv.apply(x_cl, beta, weight, float(eps), geom, bool(s2d))


# --------------------------------------------------------------------- Dropout
@register("Dropout", attr_types={"p": parse_float}, defaults={"p": 0.5},
          needs_rng=True, train_aware=True,
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _dropout(data, rng=None, is_train=False, p=0.5):
    """Inverted dropout (parity: mxnet_tpu/ops/nn.py _dropout): the identity
    unless training; in training each element is kept with probability
    1 - p and scaled by 1 / (1 - p), the mask drawn from ``rng``, the
    generator of the device the op runs on."""
    if not is_train or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = dropout_mask(data.shape, keep, rng, data.device)
    return torch.where(mask, data / keep, 0.0).to(data.dtype)


def dropout_mask(shape, keep, rng, device):
    """The kept elements of one Dropout draw: each with probability
    ``keep``, from ``rng``.  A seam: a parity check replaces it to give
    two runs (the card and the host, or the two packages) the same
    masks."""
    return torch.rand(shape, generator=rng, device=device) < keep


# ------------------------------------------------------------------ LeakyReLU
def _lrelu_args(attrs):
    return ["data", "gamma"] if attrs.get("act_type", "leaky") == "prelu" \
        else ["data"]


def _lrelu_infer(attrs, in_shapes):
    ins = list(in_shapes)
    if len(ins) > 1 and ins[0] is not None:
        ins[1] = (ins[0][1],)
    return ins, [ins[0]], None


@register("LeakyReLU", arg_names=_lrelu_args,
          attr_types={"act_type": parse_str, "slope": parse_float,
                      "lower_bound": parse_float, "upper_bound": parse_float},
          defaults={"act_type": "leaky", "slope": 0.25, "lower_bound": 0.125,
                    "upper_bound": 0.334},
          input_init_attrs={"gamma": '["Constant", {"value": 0.25}]'},
          infer_shape=_lrelu_infer, needs_rng=True, train_aware=True,
          layout_rule=lambda attrs: None if attrs.get("act_type") == "prelu"
          else "transparent")
def _leaky_relu(data, gamma=None, rng=None, is_train=False, act_type="leaky",
                slope=0.25, lower_bound=0.125, upper_bound=0.334):
    """leaky, elu, prelu (a learnt slope a channel) and rrelu (slopes drawn
    from U[lower_bound, upper_bound) in training from ``rng``, their
    midpoint otherwise).  Each keeps x where x > 0, as the JAX package's
    ``where(data > 0, ...)`` does, so the gradient at exactly 0 is the
    slope.  Elementwise but for prelu, so the NHWC pass lets it through."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * (torch.exp(data) - 1.0))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data > 0, data, g * data)
    if act_type == "rrelu":
        if is_train:
            s = torch.rand(data.shape, generator=rng, device=data.device,
                           dtype=data.dtype) \
                * (upper_bound - lower_bound) + lower_bound
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise MXNetError("unknown act_type %s" % act_type)


# --------------------------------------------------------------- Deconvolution
_DECONV_FN = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
              3: F.conv_transpose3d}


def _deconv_geometry(kernel, stride, dilate, pad, adj):
    nd = len(kernel)
    stride = _tup(stride, nd, 1)
    dilate = _tup(dilate, nd, 1)
    keff = tuple((k - 1) * d + 1 for k, d in zip(kernel, dilate))
    return nd, stride, dilate, _tup(pad, nd, 0), _tup(adj, nd, 0), keff


def _deconv_target_totals(in_sp, keff, stride, target):
    """How far the largest output, (i - 1) * s + k_eff, overshoots
    ``target_shape`` on each axis; a target above it is refused."""
    if len(target) != len(keff):
        raise MXNetError("Deconvolution target_shape %s must have %d "
                         "spatial dims" % (tuple(target), len(keff)))
    totals = tuple((i - 1) * s + k - t
                   for i, k, s, t in zip(in_sp, keff, stride, target))
    if any(t < 0 for t in totals):
        raise MXNetError("Deconvolution target_shape %s is larger than the "
                         "maximal output for input %s"
                         % (tuple(target), tuple(in_sp)))
    return totals


def _deconv_infer(attrs, in_shapes):
    data = in_shapes[0]
    nf = int(attrs.get("num_filter"))
    ng = int(attrs.get("num_group", 1))
    kernel = parse_tuple(attrs.get("kernel"))
    nd, stride, _, pad, adj, keff = _deconv_geometry(
        kernel, parse_tuple(attrs.get("stride", ())),
        parse_tuple(attrs.get("dilate", ())),
        parse_tuple(attrs.get("pad", ())), parse_tuple(attrs.get("adj", ())))
    target = parse_tuple(attrs.get("target_shape", None) or ())
    if target and len(target) != nd:
        raise MXNetError("Deconvolution target_shape %s must have %d "
                         "spatial dims" % (target, nd))
    ins = list(in_shapes)
    out = None
    if data is not None:
        ins[1] = (data[1], nf // ng) + kernel
        if target:
            _deconv_target_totals(data[2:], keff, stride, target)
            spatial = tuple(target)
        else:
            spatial = tuple((i - 1) * s - 2 * p + k + a for i, k, s, p, a
                            in zip(data[2:], keff, stride, pad, adj))
        out = (data[0], nf) + spatial
    if len(ins) > 2:
        ins[2] = (nf,)
    return ins, [out], None


@register("Deconvolution", arg_names=_conv_args,
          attr_types=dict(_CONV_ATTRS, adj=parse_tuple,
                          target_shape=parse_tuple),
          defaults={"stride": (), "dilate": (), "pad": (), "adj": (),
                    "num_group": 1, "no_bias": True},
          infer_shape=_deconv_infer)
def _deconvolution(data, weight, bias=None, kernel=None, stride=(),
                   dilate=(), pad=(), adj=(), target_shape=None,
                   num_filter=None, num_group=1, workspace=None, no_bias=True,
                   cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution, the adjoint of ``Convolution`` (parity:
    mxnet_tpu/ops/nn.py _deconvolution); the weight is (in, out / group,
    *kernel), PyTorch's own layout for it.

    The output is the full transposed convolution, (i - 1) * s + k_eff
    long, less ``pad`` on the low side and ``pad - adj`` on the high side
    (zeros where adj > pad).  PyTorch's ``output_padding`` takes adj only
    below stride or dilation; past that the full output is cropped and
    padded here, which the JAX package's padded, input-dilated convolution
    gives too.  ``target_shape`` sets pad = ceil(total / 2) and adj =
    total % 2 of each axis's overshoot."""
    nd, stride, dilate, pad, adj, keff = _deconv_geometry(
        kernel, stride, dilate, pad, adj)
    if nd not in _DECONV_FN:
        raise MXNetError("Deconvolution supports 1-3 spatial dims")
    if target_shape:
        totals = _deconv_target_totals(tuple(data.shape[2:]), keff, stride,
                                       target_shape)
        pad = tuple((t + 1) // 2 for t in totals)
        adj = tuple(t % 2 for t in totals)
    fn = _DECONV_FN[nd]
    if all(0 <= a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        out = fn(data, weight, bias, stride=stride, padding=pad,
                 output_padding=adj, groups=num_group, dilation=dilate)
    else:
        full = fn(data, weight, None, stride=stride, groups=num_group,
                  dilation=dilate)
        out = F.pad(full, _pad_widths([(-p, a - p)
                                       for p, a in zip(pad, adj)]))
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# ---------------------------------------------------- InstanceNorm, L2, LRN
@register("InstanceNorm", arg_names=("data", "gamma", "beta"),
          attr_types={"eps": parse_float}, defaults={"eps": 1e-3},
          infer_shape=lambda attrs, ins: (
              [ins[0]] + [None if ins[0] is None else (ins[0][1],)] * 2,
              [ins[0]], None))
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Normalise each (instance, channel) over its spatial axes with the
    population variance (ddof 0, as ``jnp.var``), then scale and shift a
    channel."""
    axes = tuple(range(2, data.dim()))
    cshape = (1, -1) + (1,) * (data.dim() - 2)
    mean = data.mean(dim=axes, keepdim=True)
    var = (data - mean).square().mean(dim=axes, keepdim=True)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(cshape) \
        + beta.reshape(cshape)


_L2_AXES = {"instance": lambda n: tuple(range(1, n)),
            "channel": lambda n: (1,),
            "spatial": lambda n: tuple(range(2, n))}


@register("L2Normalization", attr_types={"eps": parse_float,
                                         "mode": parse_str},
          defaults={"eps": 1e-10, "mode": "instance"},
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _l2_normalization(data, eps=1e-10, mode="instance"):
    """x / sqrt(sum(x^2) + eps) over every axis after the first
    (``instance``), the channel axis or the spatial axes."""
    if mode not in _L2_AXES:
        raise MXNetError("unknown mode %s" % mode)
    axes = _L2_AXES[mode](data.dim())
    return data / torch.sqrt(data.square().sum(dim=axes, keepdim=True)
                             + eps)


@register("LRN", attr_types={"alpha": parse_float, "beta": parse_float,
                             "knorm": parse_float, "nsize": parse_int,
                             "layout": parse_str},
          defaults={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0, "nsize": 5},
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None),
          layout_rule="aware")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, layout=None):
    """Local response norm across channels: x / (knorm + alpha * S /
    nsize)^beta, S the sum of squares over a window of ``nsize`` channels
    zero-padded by nsize // 2 on both sides.

    S / nsize is an average pool that counts the padding.  Channel-last
    (layout='NHWC', from the executor's pass) the window runs along the
    minor axis, so AlexNet's activations are never laid out again."""
    half = nsize // 2
    sq = data.square()
    if layout == "NHWC":
        flat = sq.reshape(-1, 1, sq.shape[-1])
        mean = F.avg_pool1d(flat, nsize, 1, half).reshape(
            sq.shape[:-1] + (-1,))
    else:
        # (N, 1, C, rest): the window along C, one position of the rest
        cube = sq.reshape(sq.shape[0], 1, sq.shape[1], -1, 1)
        mean = F.avg_pool3d(cube, (nsize, 1, 1), 1, (half, 0, 0)).reshape(
            (sq.shape[0], -1) + tuple(sq.shape[2:]))
    return data / torch.pow(knorm + alpha * mean, beta)


# ------------------------------------------------------------------ UpSampling
@register("UpSampling",
          arg_names=lambda attrs: ["arg%d" % i for i in range(
              int(attrs.get("num_args", 1)))],
          key_var_num_args="num_args",
          attr_types={"scale": parse_int, "num_filter": parse_int,
                      "sample_type": parse_str, "multi_input_mode": parse_str,
                      "num_args": parse_int, "workspace": parse_int},
          defaults={"scale": 1, "sample_type": "nearest",
                    "multi_input_mode": "concat"})
def _upsampling(*args, num_args=None, scale=1, num_filter=0,
                sample_type="nearest", multi_input_mode="concat",
                workspace=None):
    """Each input brought to the first's size times ``scale``: ``nearest``
    repeats each pixel by the target over the input's own size,
    ``bilinear`` resamples with half-pixel centres (``jax.image.resize``'s
    rule; it takes no weight input, as in the JAX package).  Several inputs
    are concatenated on the channels or summed."""
    data = args[0]
    target = (data.shape[2] * scale, data.shape[3] * scale)
    outs = []
    for x in args:
        if sample_type == "nearest":
            y = x.repeat_interleave(target[0] // x.shape[2], dim=2) \
                .repeat_interleave(target[1] // x.shape[3], dim=3)
        else:
            y = F.interpolate(x, size=target, mode="bilinear",
                              align_corners=False, antialias=False)
        outs.append(y)
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for y in outs[1:]:
            out = out + y
        return out
    return torch.cat(outs, dim=1)


# ------------------------------------------------------ softmax, log_softmax
def _tempered(data, temperature):
    """data / temperature; a temperature of None or 0 means none, as the
    JAX package's ``if temperature`` reads it."""
    return data / temperature if temperature else data


@register("softmax", attr_types={"axis": parse_int,
                                 "temperature": parse_float},
          defaults={"axis": -1, "temperature": None},
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _softmax(data, axis=-1, temperature=None):
    return torch.softmax(_tempered(data, temperature), dim=axis)


@register("log_softmax", attr_types={"axis": parse_int,
                                     "temperature": parse_float},
          defaults={"axis": -1, "temperature": None},
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _log_softmax(data, axis=-1, temperature=None):
    return torch.log_softmax(_tempered(data, temperature), dim=axis)
