"""Ordering ops (counterpart: mxnet_tpu/ops/ordering.py): topk, sort and
argsort.

Every sort is ascending and stable, then reversed for descending order, as
the JAX package's: among equal values a descending order lists the later
index first (``torch.sort(descending=True, stable=True)`` would list the
earlier).  Indices come back in the data's dtype.
"""
from __future__ import annotations

import torch

from .registry import register, parse_bool, parse_int, parse_str


def _topk_infer(attrs, in_shapes):
    s = in_shapes[0]
    out = None
    if s is not None:
        axis = attrs.get("axis", -1)
        ax = (-1 if axis is None else axis) % len(s)
        k = int(attrs.get("k", 1))
        out = list(s)
        out[ax] = min(k, s[ax]) if k else s[ax]
        out = tuple(out)
    n = 2 if attrs.get("ret_typ", "indices") == "both" else 1
    return in_shapes, [out] * n, None


def _stable_sort(x, dim, ascend):
    vals, idxs = torch.sort(x, dim=dim, stable=True)
    if not ascend:
        vals, idxs = vals.flip(dim), idxs.flip(dim)
    return vals, idxs


def _flat_axis(data, axis):
    """``axis=None`` sorts the flattened data, as ``jnp.sort`` does."""
    return (data.reshape(-1), -1) if axis is None else (data, axis)


@register("topk",
          num_outputs=lambda attrs: 2 if attrs.get("ret_typ", "indices")
          == "both" else 1,
          attr_types={"axis": parse_int, "k": parse_int, "ret_typ": parse_str,
                      "is_ascend": parse_bool},
          defaults={"axis": -1, "k": 1, "ret_typ": "indices",
                    "is_ascend": False},
          infer_shape=_topk_infer)
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False):
    """The k largest (smallest with ``is_ascend``) along ``axis``; k = 0
    takes all.  ``ret_typ`` 'value', 'both' (values, indices) or anything
    else, 'mask' included, the indices."""
    ax = (axis if axis is not None else -1) % data.dim()
    vals, idxs = _stable_sort(data, ax, is_ascend)
    k = k if k else data.shape[ax]
    vals = vals.narrow(ax, 0, min(k, data.shape[ax]))
    idxs = idxs.narrow(ax, 0, min(k, data.shape[ax])).to(data.dtype)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxs
    return idxs


@register("sort", attr_types={"axis": parse_int, "is_ascend": parse_bool},
          defaults={"axis": -1, "is_ascend": True})
def _sort(data, axis=-1, is_ascend=True):
    data, axis = _flat_axis(data, axis)
    return _stable_sort(data, axis, is_ascend)[0]


@register("argsort", attr_types={"axis": parse_int, "is_ascend": parse_bool},
          defaults={"axis": -1, "is_ascend": True})
def _argsort(data, axis=-1, is_ascend=True):
    data, axis = _flat_axis(data, axis)
    return _stable_sort(data, axis, is_ascend)[1].to(data.dtype)
