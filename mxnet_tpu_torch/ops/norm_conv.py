"""NormConv: (BatchNorm apply + ReLU) -> Conv -> (per-channel stats) in one
pass (counterpart: mxnet_tpu/ops/pallas_conv.py).

``norm_conv`` takes a CPU tensor to ``norm_conv_ref``, the plain PyTorch
version, and a CUDA tensor to the hand-written Hopper kernel in
``csrc/norm_conv.cu`` (which replaces the TPU kernel ``_nc_kernel``).  A CUDA
tensor the kernel cannot take raises; nothing falls back to the plain
version.

The kernel is compiled for ``sm_90a`` at its first use and loaded with ctypes
(``kernel_build``).  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .kernel_build import CudaLibrary

__all__ = ["norm_conv", "norm_conv_ref", "norm_conv_available",
           "geometry_ok", "build", "launches"]

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib):
    lib.nc_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 \
        + [ctypes.c_void_p]
    lib.nc_launch.restype = ctypes.c_int


_kernel = CudaLibrary("norm_conv", _bind)


def _geom(h, w, k, s, p):
    return (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1


def geometry_ok(kernel, stride, pad):
    """The kernel's geometry rule, also the executor's NormConv peephole
    rule: a square 1x1/3x3 kernel, stride 1 or 2, pad 0 or 1, each the same
    on both axes.  (Grouping, dilation and bias are graph attributes the
    peephole checks; the kernel has no such arguments.)"""
    k, s, p = tuple(kernel), tuple(stride), tuple(pad)
    return (len(k) == 2 and k[0] == k[1] and k[0] in (1, 3)
            and len(s) == 2 and s[0] == s[1] and s[0] in (1, 2)
            and len(p) == 2 and p[0] == p[1] and p[0] in (0, 1))


def norm_conv_available(x_shape, w_shape, stride, pad, dtype=torch.float32):
    """Shape guard of the CUDA kernel.

    x_shape: (N, H, W, Cin) channel-last; w_shape: (K, K, Cin, Cout) HWIO.
    The kernel streams fixed 64 x 64 output tiles through 16-channel steps,
    so its shared memory does not grow with the image: unlike the TPU
    guard's VMEM budget there is no size limit.  It admits every geometry
    of :func:`geometry_ok` in float32 and bfloat16."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, h, w, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if wcin != cin or dtype not in _KERNEL_DTYPES or \
            not geometry_ok((kh, kw), stride, pad):
        return False
    oh, ow = _geom(h, w, kh, stride[0], pad[0])
    return n >= 1 and cin >= 1 and cout >= 1 and oh >= 1 and ow >= 1


def _apply(x, scale, shift, relu):
    """x*scale + shift (+ReLU) with scale/shift first cast to x's dtype,
    as the TPU kernel and the JAX package's ``_apply`` round it."""
    out = x * scale.to(x.dtype).reshape(1, 1, 1, -1) \
        + shift.to(x.dtype).reshape(1, 1, 1, -1)
    return torch.relu(out) if relu else out


def norm_conv_ref(x, w, scale, shift, kernel, stride, pad, relu=True,
                  prologue=True, stats=False):
    """The plain PyTorch version: same arguments and results as
    :func:`norm_conv`, on any device (parity: pallas_conv.norm_conv_ref)."""
    xh = _apply(x, scale, shift, relu) if prologue else x
    y = F.conv2d(xh.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad).permute(0, 2, 3, 1)
    if not stats:
        return y, None, None
    y32 = y.to(torch.promote_types(y.dtype, torch.float32))
    return y, y32.sum(dim=(0, 1, 2)), y32.square().sum(dim=(0, 1, 2))


def build():
    """Compile (once per source and flags) and load the kernel library;
    returns the compiler's output of this process's build, or None."""
    return _kernel.build()


def _launch(x, w, scale, shift, kernel, stride, pad, relu, prologue, stats):
    global launches
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise MXNetError("norm_conv kernel takes float32 or bfloat16 x and w "
                         "of one dtype, got %s and %s" % (x.dtype, w.dtype))
    if not (w.is_cuda and scale.device == x.device
            and shift.device == x.device and w.device == x.device):
        raise MXNetError("norm_conv: x, w, scale and shift must share one "
                         "CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise MXNetError("norm_conv kernel takes contiguous NHWC x and HWIO "
                         "w")
    if not norm_conv_available(tuple(x.shape), tuple(w.shape),
                               (stride, stride), (pad, pad), dtype=x.dtype) \
            or w.shape[0] != kernel:
        raise MXNetError("norm_conv kernel does not take x %s, w %s, "
                         "stride %d, pad %d" % (tuple(x.shape),
                                                tuple(w.shape), stride, pad))
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if scale.shape != (cin,) or shift.shape != (cin,):
        raise MXNetError("norm_conv: scale and shift must be (Cin,)=(%d,)"
                         % cin)
    lib = _kernel.get()
    oh, ow = _geom(h, wd, kernel, stride, pad)
    sc = scale.to(x.dtype).contiguous()
    sh = shift.to(x.dtype).contiguous()
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    # the kernel adds block partials into zeroed sums; without stats it
    # never touches them, so no buffer (and no fill kernel) is made
    ysum = ysq = None
    if stats:
        ysum = torch.zeros(cout, dtype=torch.float32, device=x.device)
        ysq = torch.zeros_like(ysum)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nc_launch(
            x.data_ptr(), w.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            y.data_ptr(), ysum.data_ptr() if stats else None,
            ysq.data_ptr() if stats else None, n, h, wd, cin, cout, kernel,
            stride, pad, oh, ow, int(relu), int(prologue), int(stats),
            int(x.dtype == torch.bfloat16), stream)
    _kernel.check(err, "norm_conv")
    launches += 1
    return y, ysum, ysq


def norm_conv(x, w, scale, shift, kernel, stride, pad, relu=True,
              prologue=True, stats=False):
    """Fused (apply + conv + stats) over channel-last tensors.

    x       : (N, H, W, Cin); w: (K, K, Cin, Cout) HWIO
    scale   : (Cin,) float — previous BN's gamma * rsqrt(var + eps)
    shift   : (Cin,) float — previous BN's beta - mean * scale
    returns : (y, ysum, ysumsq); the stats are float32 per-Cout sums of the
              conv output (None when stats=False).

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
    raises."""
    if x.is_cuda:
        return _launch(x, w, scale, shift, int(kernel), int(stride), int(pad),
                       bool(relu), bool(prologue), bool(stats))
    return norm_conv_ref(x, w, scale, shift, kernel, stride, pad, relu,
                         prologue, stats)
