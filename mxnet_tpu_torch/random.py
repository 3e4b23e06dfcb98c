"""RNG state (counterpart: mxnet_tpu/random.py).

``seed(s)`` seeds one explicit host ``torch.Generator`` (``generator()``),
which the initializers draw from; ``uniform`` and ``normal`` sample from it.
Its bits are not the JAX package's threefry bits: parity tests carry weights
across as numpy arrays and never compare initial draws.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "uniform", "normal"]

_state = threading.local()
_DEFAULT_SEED = 0


def generator():
    """The generator of this thread (seeded with 0 until ``seed``)."""
    gen = getattr(_state, "gen", None)
    if gen is None:
        gen = torch.Generator().manual_seed(_DEFAULT_SEED)
        _state.gen = gen
    return gen


def seed(seed_state):
    """Seed the generator (parity: mx.random.seed)."""
    _state.gen = torch.Generator().manual_seed(int(seed_state))


def uniform(low, high, shape, dtype=torch.float32):
    """U(low, high) samples on the host."""
    out = torch.empty(tuple(shape), dtype=dtype)
    return out.uniform_(low, high, generator=generator())


def normal(loc, scale, shape, dtype=torch.float32):
    """N(loc, scale) samples on the host."""
    out = torch.empty(tuple(shape), dtype=dtype)
    return out.normal_(loc, scale, generator=generator())
