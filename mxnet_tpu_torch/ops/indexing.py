"""Indexing ops (counterpart: mxnet_tpu/ops/indexing.py): Embedding, take,
batch_take, one_hot and where.

The JAX package's gather (``jnp.take`` in its default fill mode) fixes the
semantics kept here: float indices are truncated to integers, an index in
[-input_dim, 0) wraps, and any other index outside [0, input_dim) gives a row
of NaN.  The gather never reads out of range, so a bad token cannot trip a
device-side assert and take down the CUDA context of a serving process.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from .registry import register, parse_dtype, parse_float, parse_int, parse_str


def _embedding_infer(attrs, in_shapes):
    data, weight = in_shapes
    in_dim = int(attrs.get("input_dim"))
    out_dim = int(attrs.get("output_dim"))
    out = None if data is None else tuple(data) + (out_dim,)
    return [data, (in_dim, out_dim)], [out], None


@register("Embedding", arg_names=("data", "weight"),
          attr_types={"input_dim": parse_int, "output_dim": parse_int,
                      "dtype": parse_str},
          defaults={"dtype": _np.float32},
          infer_shape=_embedding_infer)
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype=_np.float32):
    """Embedding lookup (parity: indexing_op.h EmbeddingOp): weight[data]
    along axis 0 with the gather semantics above.  ``dtype`` is the table's
    declared type, kept for the JSON; the lookup returns the weight's."""
    n = weight.shape[0]
    idx = data.to(torch.int64)              # truncates toward zero
    valid = (idx >= -n) & (idx < n)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    rows = torch.index_select(weight, 0, idx.reshape(-1))
    rows = rows.reshape(tuple(data.shape) + tuple(weight.shape[1:]))
    if weight.dtype.is_floating_point:
        nan = torch.full((), float("nan"), dtype=weight.dtype,
                         device=weight.device)
        rows = torch.where(valid.unsqueeze(-1), rows, nan)
    return rows


@register("take", arg_names=("a", "indices"),
          attr_types={"axis": parse_int, "mode": str},
          defaults={"axis": 0, "mode": "clip"})
def _take(a, indices, axis=0, mode="clip"):
    """a's slices at ``indices`` along ``axis``; float indices truncate, and
    an index out of range is clipped into it or wrapped around it."""
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        raise MXNetError("take: mode must be 'clip' or 'wrap', got %r"
                         % (mode,))
    axis = axis % a.dim()
    rows = torch.index_select(a, axis, idx.reshape(-1))
    return rows.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                        + tuple(a.shape[axis + 1:]))


@register("batch_take", arg_names=("a", "indices"))
def _batch_take(a, indices):
    """out[i] = a[i, indices[i]] (parity: indexing_op.cc batch_take)."""
    return torch.gather(a, 1, indices.to(torch.int64).reshape(-1, 1))[:, 0]


@register("one_hot",
          attr_types={"depth": parse_int, "on_value": parse_float,
                      "off_value": parse_float, "dtype": parse_dtype},
          defaults={"depth": 1, "on_value": 1.0, "off_value": 0.0,
                    "dtype": _np.float32},
          infer_shape=lambda attrs, ins: (
              ins, [None if ins[0] is None else
                    tuple(ins[0]) + (int(attrs.get("depth", 1)),)], None),
          infer_type=lambda attrs, in_dt: (
              in_dt, [attrs.get("dtype") or _np.float32], []))
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype=_np.float32):
    """on_value where the last axis equals the index, else off_value; an
    index outside [0, depth) gives a row of off_value."""
    idx = indices.to(torch.int64).unsqueeze(-1)
    oh = (idx == torch.arange(depth, device=idx.device)).to(torch.float32)
    return (oh * (on_value - off_value) + off_value).to(torch_dtype(dtype))


@register("where", arg_names=("condition", "x", "y"),
          infer_shape=lambda attrs, ins: (
              ins, [next((s for s in ins[1:] if s is not None), None)],
              None))
def _where(condition, x, y):
    """x where condition is nonzero, else y; a 1-D condition picks rows
    (parity: src/operator/tensor/control_flow_op.cc where)."""
    cond = condition
    if cond.dim() == 1 and x.dim() > 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)
