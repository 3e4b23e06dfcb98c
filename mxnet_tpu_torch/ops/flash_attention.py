"""Flash attention, forward and backward (counterpart:
mxnet_tpu/ops/pallas_kernels.py).

``flash_attention_fwd`` takes a CPU tensor to ``flash_attention_ref``, the
plain PyTorch version, and a CUDA tensor to the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (which replaces the TPU kernel ``_fwd_kernel``).
``flash_attention_bwd`` does the same with ``flash_attention_bwd_ref`` and
the two kernels of ``csrc/flash_attention_bwd.cu`` (dQ, and dK/dV together;
they replace ``_dq_kernel`` and ``_dkv_kernel``).  A CUDA tensor the kernels
cannot take raises; nothing falls back to the plain versions.

``flash_attention`` returns the output only, as the JAX function does, and
is differentiable on every device: it runs through ``FlashAttention``, a
``torch.autograd.Function`` whose backward is ``flash_attention_bwd`` (the
JAX package's ``custom_vjp``), so the CPU tests drive the same plumbing the
card runs.

The kernels read q, k, v and dO through their strides (the unit stride must
be the last axis), so the (B, H, T, D) views that the transformer's
``slice_axis`` over ``transpose`` produces, and the permuted gradient of its
output transpose, reach them without a copy.  They are compiled for
``sm_90a`` at their first use and loaded with ctypes (``kernel_build``).
Each reads rows in 16-byte pieces where ``aligned16`` holds and element by
element otherwise; ``fwd_plan`` reports the forward's tile for a shape.
``launches``, ``bwd_dq_launches`` and ``bwd_dkv_launches`` count the
launches of the three kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .kernel_build import CudaLibrary

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_bwd", "flash_attention_bwd_ref", "FlashAttention",
           "flash_available", "build", "build_bwd", "launches",
           "bwd_dq_launches", "bwd_dkv_launches", "aligned16", "fwd_plan"]

# kernel launches since import (or since a caller reset them to 0): the
# forward, the dQ kernel and the dK/dV kernel
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0

# the mask value of the TPU kernel: finite, so that a masked score minus a
# running maximum is never (-inf) - (-inf)
_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib):
    # q, k, v and the outputs (o, lse), 9 strides, B, H, T, D, scale, then
    # causal, bf16 and the 16-byte alignment flag
    lib.flash_fwd_launch.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_fwd_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.flash_fwd_plan.restype = ctypes.c_int


def _bind_bwd(lib):
    # q, k, v, dO, lse, delta and the outputs (dq; dk, dv), 12 strides,
    # B, H, T, D, scale, then causal, bf16 and the 16-byte alignment flag
    for fn, n_out in ((lib.flash_bwd_dq_launch, 1),
                      (lib.flash_bwd_dkv_launch, 2)):
        fn.argtypes = [ctypes.c_void_p] * (6 + n_out) \
            + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4 \
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_kernel = CudaLibrary("flash_attention", _bind)
_bwd_kernel = CudaLibrary("flash_attention_bwd", _bind_bwd)


def build():
    """Compile (once per source and flags) and load the forward kernel's
    library; returns the compiler's output of this process's build, or
    None."""
    return _kernel.build()


def build_bwd():
    """The same for the backward kernels' library."""
    return _bwd_kernel.build()


def flash_available(q_shape, k_shape=None, v_shape=None,
                    dtype=torch.float32):
    """Shape guard of the kernels: the JAX guard's clauses (self-attention,
    rank 4, T a multiple of 128 and at least 128, D a multiple of 8 and at
    most 256) without its VMEM budget, which is the TPU's: each kernel
    streams one operand through shared memory in tiles of 32 or 64 rows,
    sized by D alone, so its shared memory does not grow with T.  float32
    and bfloat16."""
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


def _check(what, q, *others):
    """Raise unless every tensor shares q's CUDA device and dtype and the
    kernels take q's shape (``flash_available``)."""
    if any(x.device != q.device for x in others):
        raise MXNetError("%s: every tensor must be on one CUDA device" % what)
    if any(x.dtype != q.dtype for x in others):
        raise MXNetError("%s: q, k, v (and dO) must share one dtype, got %s"
                         % (what, [str(x.dtype) for x in (q,) + others]))
    shapes = [tuple(x.shape) for x in (q,) + others]
    if not flash_available(shapes[0], shapes[1], shapes[2], dtype=q.dtype) \
            or any(s != shapes[0] for s in shapes[3:]):
        raise MXNetError("%s kernel does not take %s of %s (flash_available)"
                         % (what, shapes, q.dtype))


def _unit_last(*xs):
    # strides are passed; only a non-unit last stride needs a copy
    return [x if x.stride(3) == 1 else x.contiguous() for x in xs]


def aligned16(*xs):
    """Whether every (B, H, T, D) tensor's base and (b, h, t) strides are
    multiples of 16 bytes, so that the kernels may read each row in 16-byte
    pieces; otherwise they read them element by element."""
    return all(x.data_ptr() % 16 == 0
               and all(s * x.element_size() % 16 == 0
                       for s in x.stride()[:3]) for x in xs)


def fwd_plan(shape, lib=None):
    """(tile, threads, BQ, BK, D bucket, blocks an SM, K/V buffers) that the
    forward kernel takes for a (B, H, T, D) shape on the current device
    (``flash_fwd_plan``: the tile by D bucket, and the bucket's small-grid
    tile where a grid of 64-query tiles has fewer blocks than the card has
    SMs).  ``lib``: the library to ask, by default the forward's."""
    lib = lib or _kernel.get()
    out = (ctypes.c_int * 7)()
    if lib.flash_fwd_plan(*(int(n) for n in shape), out):
        raise MXNetError("flash_attention: no kernel plan for %s"
                         % (tuple(shape),))
    return tuple(out)


def _launch(q, k, v, causal, scale):
    global launches
    _check("flash_attention", q, k, v)
    q, k, v = _unit_last(q, k, v)
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
            int(q.dtype == torch.bfloat16), int(aligned16(q, k, v)), stream)
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


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False, scale=None):
    """The plain PyTorch backward, on any device: ``_flash_bwd_xla``'s
    arithmetic without its blocking.  P = exp(s - lse) is recomputed from
    the saved lse (s = q·kᵀ·scale, masked scores -1e30), delta =
    rowsum(dO ⊙ O), dV = Pᵀ·dO, dS = P ⊙ (dO·Vᵀ - delta)·scale, dQ = dS·K,
    dK = dSᵀ·Q; float32 or wider throughout.  Returns (dq, dk, dv) in q's,
    k's and v's dtypes."""
    acc = torch.promote_types(q.dtype, torch.float32)
    sc = _scale(q.shape[-1], scale)
    qf, kf, vf, gf = (x.to(acc) for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sc
    if causal:
        t = q.shape[2]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(s - lse.to(acc))
    delta = (gf * o.to(acc)).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta) * sc
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BwdLaunch(object):
    """One backward on CUDA tensors: the checks, delta and the outputs are
    made once; ``dq()`` and ``dkv()`` launch the two kernels (each may be
    launched again, as ``chip_smoke.py`` does to time them apart)."""

    def __init__(self, q, k, v, o, lse, do, causal, scale):
        _check("flash_attention_bwd", q, k, v, do, o)
        b, h, t, d = q.shape
        if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t, 1) \
                or lse.device != q.device:
            raise MXNetError("flash_attention_bwd: lse must be float32 %s "
                             "on %s, got %s %s on %s"
                             % ((b, h, t, 1), q.device, lse.dtype,
                                tuple(lse.shape), lse.device))
        q, k, v, do = _unit_last(q, k, v, do)
        self.lse = lse.contiguous()
        # delta = rowsum(dO * O), a torch expression as XLA's outside the
        # TPU kernels (pallas_kernels.py:212-214)
        self.delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        self.dq = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
        self.dk = torch.empty_like(self.dq)
        self.dv = torch.empty_like(self.dq)
        self.device = q.device
        self._ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     self.lse.data_ptr(), self.delta.data_ptr())
        self._keep = (q, k, v, do)       # alive while the pointers are used
        self._tail = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      *do.stride()[:3], b, h, t, d, _scale(d, scale),
                      int(causal), int(q.dtype == torch.bfloat16))
        self.vec = aligned16(q, k, v, do)
        self._lib = _bwd_kernel.get()

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def dq_kernel(self):
        global bwd_dq_launches
        with torch.cuda.device(self.device):
            err = self._lib.flash_bwd_dq_launch(
                *self._ins, self.dq.data_ptr(), *self._tail, int(self.vec),
                self._stream())
        _bwd_kernel.check(err, "flash_attention_bwd (dQ)")
        bwd_dq_launches += 1

    def dkv_kernel(self):
        global bwd_dkv_launches
        with torch.cuda.device(self.device):
            err = self._lib.flash_bwd_dkv_launch(
                *self._ins, self.dk.data_ptr(), self.dv.data_ptr(),
                *self._tail, int(self.vec), self._stream())
        _bwd_kernel.check(err, "flash_attention_bwd (dK/dV)")
        bwd_dkv_launches += 1


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """Gradients of attention w.r.t. q, k and v, given the forward's output
    o and residual lse and the output gradient do, all (B, H, T, D) but lse
    (B, H, T, 1).  Returns (dq, dk, dv) in the inputs' dtypes.

    A CPU tensor runs the plain version; a CUDA tensor runs the dQ and the
    dK/dV kernels or raises."""
    if q.is_cuda:
        run = _BwdLaunch(q, k, v, o, lse, do, bool(causal), scale)
        run.dq_kernel()
        run.dkv_kernel()
        return run.dq, run.dk, run.dv
    return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward (parity: the JAX package's
    ``custom_vjp`` of ``_flash_fwd`` and ``_flash_bwd``).  The forward saves
    q, k, v, o and lse; the backward runs ``flash_attention_bwd`` and gives
    no gradient to ``causal`` and ``scale``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        want = ctx.needs_input_grad[:3]
        if not any(want):
            return None, None, None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                    ctx.scale)
        return tuple(g if w else None for g, w in zip(grads, want)) \
            + (None, None)


def flash_attention(q, k, v, causal=False, scale=None):
    """The output of :func:`flash_attention_fwd` only, differentiable
    through :class:`FlashAttention` (parity: pallas_kernels.flash_attention)."""
    return FlashAttention.apply(q, k, v, bool(causal), scale)
