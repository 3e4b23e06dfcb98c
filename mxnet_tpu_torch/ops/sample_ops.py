"""Random sampling ops (counterpart: mxnet_tpu/ops/sample_ops.py):
_random_uniform and _random_normal with their aliases.

Each draws float32 samples from the generator it is handed, which
``registry.imperative_invoke`` takes from ``random.generator`` of the
context's device: a sample for ``gpu(0)`` is drawn on the card.  The bits
are not the JAX package's threefry bits; tests compare statistics.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import torch_dtype
from .registry import register, parse_dtype, parse_float, parse_tuple


def _sample_infer(attrs, in_shapes):
    return [], [tuple(parse_tuple(attrs.get("shape", ())) or ())], None


_COMMON = dict(arg_names=(), needs_rng=True, infer_shape=_sample_infer,
               infer_type=lambda attrs, in_dt: (
                   [], [attrs.get("dtype") or _np.float32], []))


def _empty(rng, shape):
    return torch.empty(tuple(shape), dtype=torch.float32, device=rng.device)


@register("_random_uniform", aliases=("uniform", "_sample_uniform"),
          attr_types={"low": parse_float, "high": parse_float,
                      "shape": parse_tuple, "dtype": parse_dtype},
          defaults={"low": 0.0, "high": 1.0, "shape": (),
                    "dtype": _np.float32},
          **_COMMON)
def _uniform(rng=None, low=0.0, high=1.0, shape=(), dtype=_np.float32):
    return _empty(rng, shape).uniform_(low, high, generator=rng).to(
        torch_dtype(dtype))


@register("_random_normal", aliases=("normal", "_sample_normal"),
          attr_types={"loc": parse_float, "scale": parse_float,
                      "shape": parse_tuple, "dtype": parse_dtype},
          defaults={"loc": 0.0, "scale": 1.0, "shape": (),
                    "dtype": _np.float32},
          **_COMMON)
def _normal(rng=None, loc=0.0, scale=1.0, shape=(), dtype=_np.float32):
    out = _empty(rng, shape).normal_(generator=rng)
    return (out * scale + loc).to(torch_dtype(dtype))
