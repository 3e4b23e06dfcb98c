"""Neural-network layers (counterpart: mxnet_tpu/ops/nn.py):
FullyConnected, Activation, Convolution, Pooling, BatchNorm (inference) and
the executor-fused _BatchNormReLU.  Their backward is autograd's, except the
max-pool equality-mask backward of ``MXNET_POOL_MASK_BWD`` (``MaxPoolMask``).

Convolution and pooling call PyTorch's own (cuDNN on the card), as the JAX
package leaves them to XLA.  With ``layout='NHWC'`` (set by the executor's
layout pass) the activation arrives channel-last; it is handed to PyTorch as
a permuted view, which PyTorch treats as a ``channels_last`` tensor.
"""
from __future__ import annotations

import itertools

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import (register, parse_bool, parse_float, parse_int,
                       parse_str, parse_tuple, raise_if_training,
                       shape_is_complete)


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


@register("FullyConnected", arg_names=_fc_args,
          attr_types={"num_hidden": parse_int, "no_bias": parse_bool},
          defaults={"no_bias": False}, infer_shape=_fc_infer)
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False):
    """y = x·Wᵀ + b"""
    return F.linear(data.reshape(data.shape[0], -1), weight, bias)


# ------------------------------------------------------------------ Activation
@register("Activation", attr_types={"act_type": parse_str},
          defaults={"act_type": "relu"}, layout_rule="transparent")
def _activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    raise MXNetError("unknown act_type %s" % act_type)


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


@register("Convolution", arg_names=_conv_args, attr_types=_CONV_ATTRS,
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
                    starts = _np.arange(o) * s - p
                    d = _np.minimum(starts + k, i + p) - starts
                    d = torch.as_tensor(d, dtype=out.dtype,
                                        device=out.device)
                    d = d.reshape((o,) + (1,) * (nd - ax - 1))
                    cnt = d if cnt is None else cnt * d
                out = out / cnt
        else:
            raise MXNetError("unknown pool_type %s" % pool_type)
    return _to_cl(out) if layout == "NHWC" else out


# ------------------------------------------------------------------- BatchNorm
def bn_scale_shift(gamma, beta, mean, var, eps, fix_gamma, dtype):
    """Per-channel (scale, shift) of an inference BatchNorm, in the
    accumulation dtype (at least float32)."""
    acc = torch.promote_types(dtype, torch.float32)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(var.to(acc) + eps)
    scale = g.to(acc) * inv
    shift = beta.to(acc) - mean.to(acc) * scale
    return scale, shift


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
    """Inference batch norm from the moving statistics.  Returns
    (out[, mean, var], moving_mean, moving_var): the aux states come back
    unchanged."""
    raise_if_training("BatchNorm", is_train and not use_global_stats)
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
    """Executor-fused BatchNorm + ReLU."""
    res = _batch_norm(data, gamma, beta, moving_mean, moving_var,
                      is_train=is_train, eps=eps, momentum=momentum,
                      fix_gamma=fix_gamma, use_global_stats=use_global_stats,
                      layout=layout)
    return (torch.relu(res[0]),) + tuple(res[1:])
