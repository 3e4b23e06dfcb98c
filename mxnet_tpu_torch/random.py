"""RNG state (counterpart: mxnet_tpu/random.py).

One explicit ``torch.Generator`` per device: the host's (``generator()``),
which the initializers draw from, and one on each CUDA card
(``generator(device)``), which the sampling ops and SGLD's noise draw from,
so a sample for ``gpu(0)`` is drawn on the card, never on the host and
copied over.  ``seed(s)`` seeds every one of them, those made later
included.  Their bits are not the JAX package's threefry bits: parity tests
carry weights across as numpy arrays and compare samples by statistics.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "generator", "uniform", "normal", "replaying"]

_state = threading.local()
_DEFAULT_SEED = 0


def _gens():
    """{device: generator} of this thread."""
    gens = getattr(_state, "gens", None)
    if gens is None:
        gens = _state.gens = {}
    return gens


def generator(device=None):
    """The generator of ``device`` (a ``torch.device`` or its string; the
    host when None) in this thread, seeded with the last ``seed`` (0 until
    one is given)."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gens = _gens()
    gen = gens.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(
            getattr(_state, "seed", _DEFAULT_SEED))
        gens[dev] = gen
    return gen


@contextlib.contextmanager
def replaying(gen, state):
    """Run a block with ``gen`` as its device's generator in the calling
    thread (autograd's device threads included) and at ``state``; after it,
    ``gen`` is back where it stood and the thread's own generator is back in
    place.  A recomputed forward (``TrainStep(remat=...)``) draws the same
    Dropout masks as the forward it replays this way."""
    gens = _gens()
    own = gens.get(gen.device)
    now = gen.get_state()
    gens[gen.device] = gen
    gen.set_state(state)
    try:
        yield
    finally:
        gen.set_state(now)
        if own is None:
            del gens[gen.device]
        else:
            gens[gen.device] = own


def seed(seed_state):
    """Seed every device's generator (parity: mx.random.seed)."""
    _state.seed = int(seed_state)
    for gen in _gens().values():
        gen.manual_seed(_state.seed)


def uniform(low, high, shape, dtype=torch.float32):
    """U(low, high) samples on the host."""
    out = torch.empty(tuple(shape), dtype=dtype)
    return out.uniform_(low, high, generator=generator())


def normal(loc, scale, shape, dtype=torch.float32):
    """N(loc, scale) samples on the host."""
    out = torch.empty(tuple(shape), dtype=dtype)
    return out.normal_(loc, scale, generator=generator())
