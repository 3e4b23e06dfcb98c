"""Sequence ops (counterpart: mxnet_tpu/ops/sequence.py): SequenceLast,
SequenceMask and SequenceReverse.

Time-major (T, N, ...) as in MXNet, with an optional ``sequence_length``
(N,) input gated by ``use_sequence_length``.
"""
from __future__ import annotations

import torch

from .registry import register, parse_bool, parse_float


def _seq_args(attrs):
    if attrs.get("use_sequence_length", False):
        return ["data", "sequence_length"]
    return ["data"]


_SEQ = dict(arg_names=_seq_args,
            attr_types={"use_sequence_length": parse_bool},
            defaults={"use_sequence_length": False})


def _per_batch(v, data, lead):
    """(N,) -> a shape that broadcasts against ``data`` with ``lead``
    leading axes of size 1 before the batch axis."""
    return v.reshape((1,) * lead + (-1,) + (1,) * (data.dim() - 2))


def _lengths(sequence_length):
    return sequence_length.to(torch.int64)


@register("SequenceLast",
          infer_shape=lambda attrs, ins: (
              ins, [None if ins[0] is None else tuple(ins[0][1:])], None),
          **_SEQ)
def _sequence_last(data, sequence_length=None, use_sequence_length=False):
    """The last valid step of each sequence."""
    if not use_sequence_length:
        return data[-1]
    idx = _per_batch(_lengths(sequence_length) - 1, data, 1)
    return torch.gather(data, 0, idx.expand((1,) + tuple(data.shape[1:])))[0]


@register("SequenceMask",
          arg_names=_seq_args,
          attr_types={"use_sequence_length": parse_bool, "value": parse_float},
          defaults={"use_sequence_length": False, "value": 0.0})
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length:
        return data
    T = data.shape[0]
    steps = torch.arange(T, device=data.device).reshape(
        (T, 1) + (1,) * (data.dim() - 2))
    mask = steps < _per_batch(_lengths(sequence_length), data, 1)
    return torch.where(mask, data, torch.as_tensor(
        value, dtype=data.dtype, device=data.device))


@register("SequenceReverse", **_SEQ)
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False):
    """Each sequence's valid steps reversed; the padding stays in place."""
    if not use_sequence_length:
        return torch.flip(data, (0,))
    T = data.shape[0]
    lens = _lengths(sequence_length).reshape(1, -1)
    t = torch.arange(T, device=data.device).reshape(-1, 1)
    src = torch.where(t < lens, lens - 1 - t, t)
    src = src.reshape(tuple(src.shape) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, src.expand(tuple(data.shape)))
