"""Elementwise operators (counterpart: mxnet_tpu/ops/elemwise.py).

Only the residual add is on the serving path: ``_plus``, which
``Symbol.__add__`` builds, with its aliases.
"""
from __future__ import annotations

from .registry import register, shape_unify


def _same_shape_infer(attrs, in_shapes):
    unified = None
    for s in in_shapes:
        unified = shape_unify(unified, s)
    return [unified for _ in in_shapes], [unified], None


@register("_plus", arg_names=("lhs", "rhs"), aliases=("_add", "elemwise_add"),
          infer_shape=_same_shape_infer, layout_rule="transparent")
def _plus(lhs, rhs):
    """lhs + rhs (parity: elemwise_binary_op_basic.cc _plus)."""
    return lhs + rhs
