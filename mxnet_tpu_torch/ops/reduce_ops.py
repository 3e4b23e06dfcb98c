"""Reduction and broadcasting ops (counterpart: mxnet_tpu/ops/reduce_ops.py):
sum, mean, prod, nansum, nanprod, max, min with ``axis`` / ``keepdims`` /
``exclude``; norm; argmax, argmin, argmax_channel; broadcast_to and
broadcast_axis.

Dtypes follow the JAX package's: a sum or product of 32-bit integers stays
int32 (torch would widen it to int64), a mean of integers is float32, and
the arg-reductions return indices in the input's dtype.
"""
from __future__ import annotations

import torch

from .registry import register, parse_bool, parse_int, parse_tuple


def _norm_axis(axis, ndim, exclude=False):
    if axis is None or axis == ():
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _reduce_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], None
    ax = _norm_axis(attrs.get("axis"), len(s), attrs.get("exclude", False))
    if attrs.get("keepdims", False):
        out = tuple(1 if i in ax else d for i, d in enumerate(s))
    else:
        out = tuple(d for i, d in enumerate(s) if i not in ax)
    return in_shapes, [out], None


_REDUCE_ATTRS = dict(
    attr_types={"axis": parse_tuple, "keepdims": parse_bool,
                "exclude": parse_bool},
    defaults={"axis": None, "keepdims": False, "exclude": False},
    infer_shape=_reduce_infer)


def _int_kept(f):
    """A sum-like reduction whose integer results keep a 32-bit input's
    dtype (jnp without 64-bit mode)."""
    def g(x, dim, keepdim):
        out = f(x, dim=dim, keepdim=keepdim)
        if not x.is_floating_point() and x.dtype != torch.int64:
            out = out.to(torch.int32)
        return out
    return g


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), 1.0, x)
    return _prod(x, dim, keepdim)


def _nansum(x, dim, keepdim):
    f = torch.nansum if x.is_floating_point() else torch.sum
    return f(x, dim=dim, keepdim=keepdim)


def _mean(x, dim, keepdim):
    return torch.mean(x if x.is_floating_point() else x.to(torch.float32),
                      dim=dim, keepdim=keepdim)


def _make_reduce(tfn):
    def f(data, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, data.dim(), exclude)
        if not ax:       # torch reads dim=() as every axis; jnp as none
            return tfn(data.unsqueeze(0), (0,), False)
        return tfn(data, ax, keepdims)
    return f


register("sum", aliases=("sum_axis",), **_REDUCE_ATTRS)(
    _make_reduce(_int_kept(torch.sum)))
register("mean", **_REDUCE_ATTRS)(_make_reduce(_mean))
register("prod", **_REDUCE_ATTRS)(_make_reduce(_int_kept(_prod)))
register("nansum", **_REDUCE_ATTRS)(_make_reduce(_int_kept(_nansum)))
register("nanprod", **_REDUCE_ATTRS)(_make_reduce(_int_kept(_nanprod)))
register("max", aliases=("max_axis",), **_REDUCE_ATTRS)(
    _make_reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k)))
register("min", aliases=("min_axis",), **_REDUCE_ATTRS)(
    _make_reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k)))


@register("norm")
def _norm(data):
    """Frobenius norm of the whole array (parity:
    broadcast_reduce_op_value.cc norm)."""
    data = data if data.is_floating_point() else data.to(torch.float32)
    return torch.sqrt(torch.sum(torch.square(data))).reshape((1,))


def _arg_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], None
    axis = attrs.get("axis")
    keepdims = attrs.get("keepdims", False)
    if axis is None:
        out = (1,) if not keepdims else tuple(1 for _ in s)
    else:
        a = axis % len(s)
        out = tuple(1 if i == a else d for i, d in enumerate(s)) if keepdims \
            else tuple(d for i, d in enumerate(s) if i != a)
        if out == ():
            out = (1,)
    return in_shapes, [out], None


def _make_arg(tfn):
    def f(data, axis=None, keepdims=False):
        # MXNet returns indices in the input's (real) dtype
        if axis is None:
            out = tfn(data.reshape(-1), dim=0)
            out = out.reshape((1,) * data.dim() if keepdims else (1,))
        else:
            out = tfn(data, dim=axis, keepdim=keepdims)
            if out.dim() == 0:
                out = out.reshape((1,))
        return out.to(data.dtype)
    return f


_ARG_ATTRS = dict(attr_types={"axis": parse_int, "keepdims": parse_bool},
                  defaults={"axis": None, "keepdims": False},
                  infer_shape=_arg_infer)
register("argmax", **_ARG_ATTRS)(_make_arg(torch.argmax))
register("argmin", **_ARG_ATTRS)(_make_arg(torch.argmin))


@register("argmax_channel")
def _argmax_channel(data):
    """argmax over axis 1 (parity: broadcast_reduce_op_index.cc
    argmax_channel)."""
    return torch.argmax(data, dim=1).to(data.dtype)


@register("broadcast_to", attr_types={"shape": parse_tuple},
          defaults={"shape": ()},
          infer_shape=lambda attrs, ins: (
              ins, [None if ins[0] is None else tuple(
                  t if t != 0 else s for s, t in zip(
                      ins[0], parse_tuple(attrs.get("shape", ()))))],
              None))
def _broadcast_to(data, shape=()):
    tgt = tuple(t if t != 0 else s for s, t in zip(data.shape, shape))
    return data.expand(tgt)


@register("broadcast_axis", aliases=("broadcast_axes",),
          attr_types={"axis": parse_tuple, "size": parse_tuple},
          defaults={"axis": (), "size": ()})
def _broadcast_axis(data, axis=(), size=()):
    ax = axis if isinstance(axis, (tuple, list)) else (axis,)
    sz = size if isinstance(size, (tuple, list)) else (size,)
    tgt = list(data.shape)
    for a, s in zip(ax, sz):
        tgt[a] = s
    return data.expand(tuple(tgt))
