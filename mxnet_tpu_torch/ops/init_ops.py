"""Creation operators (counterpart: mxnet_tpu/ops/init_ops.py): _zeros,
_ones, _full, _arange with ``repeat``, zeros_like, ones_like and
_state_init.

The ops without inputs build their tensor on the default device, which
``registry.imperative_invoke`` sets to the caller's context.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import torch_dtype
from .registry import register, parse_dtype, parse_tuple


def _init_infer(attrs, in_shapes):
    shape = parse_tuple(attrs.get("shape", ()))
    return [], [tuple(shape)], None


def _init_type(attrs, in_dtypes):
    return [], [attrs.get("dtype") or _np.float32], []


_INIT_ATTRS = dict(arg_names=(), infer_shape=_init_infer,
                   infer_type=_init_type)


@register("_zeros", aliases=("zeros",),
          attr_types={"shape": parse_tuple, "dtype": parse_dtype},
          defaults={"shape": (), "dtype": _np.float32}, **_INIT_ATTRS)
def _zeros(shape=(), dtype=_np.float32):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype))


@register("_ones", aliases=("ones",),
          attr_types={"shape": parse_tuple, "dtype": parse_dtype},
          defaults={"shape": (), "dtype": _np.float32}, **_INIT_ATTRS)
def _ones(shape=(), dtype=_np.float32):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype))


@register("_full", aliases=("full",),
          attr_types={"shape": parse_tuple, "dtype": parse_dtype,
                      "value": float},
          defaults={"shape": (), "dtype": _np.float32, "value": 0.0},
          **_INIT_ATTRS)
def _full(shape=(), dtype=_np.float32, value=0.0):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype))


def _arange_infer(attrs, in_shapes):
    start = float(attrs.get("start", 0.0))
    stop = attrs.get("stop", None)
    if stop is None or (isinstance(stop, str) and stop == "None"):
        start, stop = 0.0, start
    stop = float(stop)
    step = float(attrs.get("step", 1.0))
    repeat = int(attrs.get("repeat", 1))
    n = int(max(0, _np.ceil((stop - start) / step))) * repeat
    return [], [(n,)], None


@register("_arange", arg_names=(), aliases=("arange",),
          attr_types={"start": float,
                      "stop": lambda v: None if v in (None, "None")
                      else float(v),
                      "step": float, "repeat": int, "dtype": parse_dtype},
          defaults={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1,
                    "dtype": _np.float32},
          infer_shape=_arange_infer, infer_type=_init_type)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype=_np.float32):
    """arange with MXNet's repeat extension (parity: init_op.cc _arange):
    ceil((stop - start) / step) values start + i * step."""
    if stop is None:
        start, stop = 0.0, start
    n = int(max(0, _np.ceil((stop - start) / step)))
    dt = torch_dtype(dtype)
    i = torch.arange(n, dtype=torch.float64)
    if dt.is_floating_point:
        out = (start + i * step).to(dt)
    else:   # numpy's rule: the step is dtype(start + step) - dtype(start)
        out = (int(start) + i * (int(start + step) - int(start))).to(dt)
    if repeat != 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("zeros_like")
def _zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def _ones_like(data):
    return torch.ones_like(data)


def _state_init_infer(attrs, in_shapes):
    shape = parse_tuple(attrs.get("shape", ()))
    like = in_shapes[0]
    ba = int(attrs.get("batch_axis", 0))
    out = None
    if like is not None:
        out = tuple(like[ba] if s == 0 else int(s) for s in shape)
    return list(in_shapes), [out], None


def _state_init_type(attrs, in_dtypes):
    dt = attrs.get("dtype")
    out = dt if dt is not None else (in_dtypes[0] or _np.float32)
    return list(in_dtypes), [out], []


@register("_state_init", arg_names=("data",),
          attr_types={"shape": parse_tuple, "batch_axis": int,
                      "value": float, "dtype": parse_dtype},
          defaults={"batch_axis": 0, "value": 0.0},
          infer_shape=_state_init_infer, infer_type=_state_init_type,
          hidden=True)
def _state_init(data, shape=(), batch_axis=0, value=0.0, dtype=None):
    """Constant fill whose unknown (0) dims take the batch size of ``data``
    at ``batch_axis`` (MXNet's 0-means-unknown state shapes)."""
    b = data.shape[batch_axis]
    out = tuple(b if s == 0 else int(s) for s in shape)
    return torch.full(out, value, device=data.device,
                      dtype=data.dtype if dtype is None
                      else torch_dtype(dtype))
