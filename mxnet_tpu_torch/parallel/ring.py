"""Plain full-sequence attention (counterpart: mxnet_tpu/parallel/ring.py
``attention_reference``): the ``impl='xla'`` rung of
``dot_product_attention`` and the reference the flash kernel's tests use.
``ring_attention`` is not ported yet."""
from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q, k, v, causal=False, scale=None):
    """softmax(q·kᵀ·scale)·v over (B, H, T, D); the causal mask is -inf above
    the diagonal and the default scale 1/sqrt(D)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", p, v) / p.sum(dim=-1,
                                                         keepdim=True)
