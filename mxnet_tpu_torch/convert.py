"""Carry weights into the port from host numpy arrays.

``params_from_numpy`` builds the ``{"arg:name" / "aux:name": NDArray}`` blob
that ``Predictor`` and ``ServedModel`` take, the same keys a ``.params``
checkpoint holds.  Weights written by the JAX package as a ``.params`` file
load directly (``Predictor(..., param_blob=path or bytes)``).
"""
from __future__ import annotations

import numpy as np

from .context import current_context
from . import ndarray as nd

__all__ = ["params_from_numpy"]


def params_from_numpy(arg_params, aux_params, ctx=None):
    """``{name: np.ndarray}`` arguments and aux states -> the name-keyed
    blob on ``ctx`` (default: the current context).  Each array keeps its
    dtype."""
    ctx = ctx or current_context()
    blob = {}
    for prefix, group in (("arg:", arg_params), ("aux:", aux_params or {})):
        for name, value in group.items():
            value = np.asarray(value)
            blob[prefix + name] = nd.array(value, ctx=ctx, dtype=value.dtype)
    return blob
