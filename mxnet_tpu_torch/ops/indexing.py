"""Indexing ops (counterpart: mxnet_tpu/ops/indexing.py): Embedding.

The JAX package's gather (``jnp.take`` in its default fill mode) fixes the
semantics kept here: float indices are truncated to integers, an index in
[-input_dim, 0) wraps, and any other index outside [0, input_dim) gives a row
of NaN.  The gather never reads out of range, so a bad token cannot trip a
device-side assert and take down the CUDA context of a serving process.
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import register, parse_int, parse_str


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
