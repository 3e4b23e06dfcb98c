"""Attention operators (counterpart: mxnet_tpu/ops/attention.py):
dot_product_attention, position_ids, softmax_mask and LayerNorm.

``dot_product_attention`` is the core primitive: (B, H, T, D) q/k/v in, the
same shape out.  The ladder, as the JAX package's:
- a sequence mesh is active (``parallel.mesh.set_sequence_mesh``):
  ``parallel.ring.ring_attention`` over its axis, whatever ``impl`` says;
otherwise ``_use_flash`` decides:
- ``impl='flash'``: the flash wrapper (its plain version on a CPU tensor,
  the Hopper kernel on a CUDA tensor, and an error on a CUDA tensor the
  kernel does not take);
- ``impl='xla'``: ``parallel.ring.attention_reference``;
- ``impl='auto'``: the kernel for a CUDA tensor with T >= 512 that
  ``flash_available`` admits, else the reference, as the JAX package takes
  its Pallas kernel only on a TPU and from T = 512.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..parallel import mesh as _mesh
from ..parallel.ring import attention_reference, ring_attention
from .flash_attention import flash_attention, flash_available
from .registry import register, parse_bool, parse_float

IMPLS = ("auto", "flash", "xla")
# shortest sequence at which 'auto' takes the kernel (the JAX package's rule)
FLASH_MIN_T = 512


def _use_flash(impl, q_shape, k_shape, v_shape, dtype, is_cuda):
    """True when dot_product_attention goes to the flash wrapper."""
    if impl not in IMPLS:
        raise MXNetError("dot_product_attention: impl must be one of %s, "
                         "got %r" % (IMPLS, impl))
    if impl != "auto":
        return impl == "flash"
    return bool(is_cuda) and len(q_shape) == 4 \
        and q_shape[2] >= FLASH_MIN_T \
        and flash_available(q_shape, k_shape, v_shape, dtype=dtype)


def _attn_infer(attrs, in_shapes):
    return list(in_shapes), [in_shapes[0]], None


@register("dot_product_attention", arg_names=("query", "key", "value"),
          attr_types={"causal": parse_bool, "scale": parse_float,
                      "impl": str},
          defaults={"causal": False, "scale": None, "impl": "auto"},
          infer_shape=_attn_infer)
def _dot_product_attention(query, key, value, causal=False, scale=None,
                           impl="auto"):
    """Scaled dot-product attention over (B, H, T, D)."""
    mesh, axis = _mesh.sequence_mesh()
    if mesh is not None:
        return ring_attention(query, key, value, mesh, axis=axis,
                              causal=causal, scale=scale)
    if _use_flash(impl, tuple(query.shape), tuple(key.shape),
                  tuple(value.shape), query.dtype, query.is_cuda):
        return flash_attention(query, key, value, causal, scale)
    return attention_reference(query, key, value, causal=causal, scale=scale)


@register("position_ids", arg_names=("data",),
          attr_types={"seq_len": int}, defaults={"seq_len": 0},
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _position_ids(data, seq_len=0):
    """Token positions 0..T-1 (float32) broadcast over the batch of a (B, T)
    input; ``seq_len``, when given, must equal the data width."""
    t = data.shape[-1]
    if seq_len and int(seq_len) != int(t):
        raise ValueError("position_ids: seq_len=%d != data width %d"
                         % (seq_len, t))
    return torch.arange(t, dtype=torch.float32,
                        device=data.device).expand(data.shape)


@register("softmax_mask", arg_names=("data", "mask"))
def _softmax_mask(data, mask):
    """Masked softmax over the last axis (mask 1=keep, 0=drop)."""
    neg = torch.finfo(data.dtype).min
    return torch.softmax(data.masked_fill(mask == 0, neg), dim=-1)


def _ln_infer(attrs, in_shapes):
    data = in_shapes[0]
    c = None if data is None else (data[int(attrs.get("axis", -1))],)
    return [data, c, c], [data], None


@register("LayerNorm", arg_names=("data", "gamma", "beta"),
          attr_types={"axis": int, "eps": parse_float},
          defaults={"axis": -1, "eps": 1e-5}, infer_shape=_ln_infer)
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over ``axis``; gamma and beta broadcast against
    the last axis, as in the JAX package."""
    mu = data.mean(dim=axis, keepdim=True)
    var = ((data - mu) ** 2).mean(dim=axis, keepdim=True)
    xhat = (data - mu) * torch.rsqrt(var + eps)
    return xhat * gamma + beta
