"""Carry weights and training state into the port from host numpy arrays.

``params_from_numpy`` builds the ``{"arg:name" / "aux:name": NDArray}`` blob
that ``Predictor`` and ``ServedModel`` take, the same keys a ``.params``
checkpoint holds.  Weights written by the JAX package as a ``.params`` file
load directly (``Predictor(..., param_blob=path or bytes)``).
``train_state_from_numpy`` builds the (params, opt_state, aux) dicts that
``TrainStep`` takes from the pytrees the JAX package's ``TrainStep.init``
returns, as numpy.
"""
from __future__ import annotations

import numpy as np

from .context import current_context
from . import ndarray as nd

__all__ = ["params_from_numpy", "train_state_from_numpy"]


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


def _tensor(value, dev):
    value = np.asarray(value)
    return nd._host_tensor(value, value.dtype).to(dev)


def train_state_from_numpy(params, opt_state, aux, ctx=None):
    """``{name: array}`` parameters, ``{name: tuple of arrays}`` optimizer
    state and ``{name: array}`` aux states (the JAX ``TrainStep.init``
    pytrees, through ``np.asarray``) -> the same dicts of tensors on ``ctx``
    (default: the current context), each a copy at its own dtype, ready for
    ``TrainStep`` to update in place."""
    dev = (ctx or current_context()).torch_device()
    return ({n: _tensor(v, dev) for n, v in params.items()},
            {n: tuple(_tensor(s, dev) for s in st)
             for n, st in opt_state.items()},
            {n: _tensor(v, dev) for n, v in (aux or {}).items()})
