"""Flash attention forward (counterpart: mxnet_tpu/ops/pallas_kernels.py).

``flash_attention_fwd`` takes a CPU tensor to ``flash_attention_ref``, the
plain PyTorch version, and a CUDA tensor to the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (which replaces the TPU kernel ``_fwd_kernel``).
A CUDA tensor the kernel cannot take raises; nothing falls back to the plain
version.  ``flash_attention`` returns the output only, as the JAX function
does.

The kernel reads q, k and v through their strides (the unit stride must be
the last axis), so the (B, H, T, D) views that the transformer's
``slice_axis`` over ``transpose`` produces reach it without a copy.  It is
compiled for ``sm_90a`` at its first use and loaded with ctypes
(``kernel_build``).  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .kernel_build import CudaLibrary

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "flash_available", "build", "launches"]

# kernel launches since import (or since a caller reset it to 0)
launches = 0

# the mask value of the TPU kernel: finite, so that a masked score minus a
# running maximum is never (-inf) - (-inf)
_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib):
    lib.flash_fwd_launch.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.flash_fwd_launch.restype = ctypes.c_int


_kernel = CudaLibrary("flash_attention", _bind)


def build():
    """Compile (once per source and flags) and load the kernel library;
    returns the compiler's output of this process's build, or None."""
    return _kernel.build()


def flash_available(q_shape, k_shape=None, v_shape=None,
                    dtype=torch.float32):
    """Shape guard of the kernel: the JAX guard's clauses (self-attention,
    rank 4, T a multiple of 128 and at least 128, D a multiple of 8 and at
    most 256) without its VMEM budget, which is the TPU's: the kernel
    stages 64-row tiles of K and V, so its shared memory does not grow with
    T.  float32 and bfloat16."""
    if len(q_shape) != 4 or dtype not in _KERNEL_DTYPES:
        return False
    for other in (k_shape, v_shape):
        if other is not None and tuple(other) != tuple(q_shape):
            return False
    t, d = q_shape[2], q_shape[3]
    return t % 128 == 0 and t >= 128 and d % 8 == 0 and d <= 256


def _scale(d, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def flash_attention_ref(q, k, v, causal=False, scale=None):
    """The plain PyTorch version of both outputs, on any device: the TPU
    kernel's arithmetic (q scaled before the product, float32 or wider
    scores, the -1e30 mask, l clamped at 1e-30) without its blocking.
    Returns (o in q's dtype, lse (B, H, T, 1) in the accumulation dtype)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(acc) * _scale(q.shape[-1], scale),
                     k.to(acc).transpose(-1, -2))
    if causal:
        t = q.shape[2]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.to(acc)) / l
    return o.to(q.dtype), m + torch.log(l)


def _launch(q, k, v, causal, scale):
    global launches
    if not (k.device == q.device and v.device == q.device):
        raise MXNetError("flash_attention: q, k and v must share one CUDA "
                         "device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k and v must share one dtype, "
                         "got %s, %s, %s" % (q.dtype, k.dtype, v.dtype))
    if not flash_available(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                           dtype=q.dtype):
        raise MXNetError("flash_attention kernel does not take q %s, k %s, "
                         "v %s of %s (flash_available)"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape),
                            q.dtype))
    # strides are passed; only a non-unit last stride needs a copy
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    lib = _kernel.get()
    b, h, t, d = q.shape
    o = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], b, h, t, d, _scale(d, scale), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    _kernel.check(err, "flash_attention")
    launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Attention over (B, H, T, D) self-attention q, k, v.

    returns : (o, lse); o (B, H, T, D) in q's dtype, lse (B, H, T, 1) the
              per-row log-sum-exp of the scaled scores (float32 from the
              kernel), the residual the blocked backward reads.

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
    raises."""
    if q.is_cuda:
        return _launch(q, k, v, bool(causal), scale)
    return flash_attention_ref(q, k, v, causal, scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """The output of :func:`flash_attention_fwd` only (parity:
    pallas_kernels.flash_attention)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
