"""NormConv: (BatchNorm apply + ReLU) -> Conv -> (per-channel stats) in one
pass (counterpart: mxnet_tpu/ops/pallas_conv.py).

``norm_conv`` takes a CPU tensor to ``norm_conv_ref``, the plain PyTorch
version, and a CUDA tensor to the hand-written Hopper kernel in
``csrc/norm_conv.cu`` (which replaces the TPU kernel ``_nc_kernel``).  A CUDA
tensor the kernel cannot take raises; nothing falls back to the plain
version.

The kernel is compiled for ``sm_90a`` at its first use and loaded with ctypes
(``kernel_build``).  ``launches`` counts ``norm_conv`` calls that launched the
kernel: one launch each, split-K included (the slice blocks of a tile sum
their partials inside that launch); ``stats_launches`` those of them with
the statistics epilogue on, ``bf16_launches`` those in bfloat16.

``NormConv`` is the autograd Function of training (counterpart: the custom
VJP ``_nc_core``): its forward is ``norm_conv``, its backward the JAX
package's ``_nc_core_bwd`` in PyTorch ops, where the conv's data and weight
gradients go to PyTorch's convolution backward (cuDNN on the card), as the
JAX package left them to XLA.  Only the forward is a kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import relu as _relu
from .kernel_build import CudaLibrary

__all__ = ["norm_conv", "norm_conv_ref", "norm_conv_available",
           "geometry_ok", "build", "launches", "stats_launches",
           "bf16_launches", "plan", "vec_flags", "NormConv",
           "PEEPHOLE_DTYPES"]

# kernel launches since import (or since a caller reset it to 0), those of
# them with the statistics epilogue on, and those in bfloat16
launches = 0
stats_launches = 0
bf16_launches = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the activation dtypes the executor's NormConv peephole fuses: the
# kernel's, and float64, which only the plain version takes (the CPU
# parity reference of the fused path).  Any other (float16) runs the
# unfused ops.
PEEPHOLE_DTYPES = _KERNEL_DTYPES + (torch.float64,)


def _bind(lib):
    lib.nc_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.nc_plan.restype = ctypes.c_int
    lib.nc_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 18 \
        + [ctypes.c_void_p]
    lib.nc_launch.restype = ctypes.c_int


_kernel = CudaLibrary("norm_conv", _bind)
# {(device index, n, oh, ow, cin, cout, k, forced tile and S):
#  (tile, bm, bn, S, tiles)}
_plans = {}
# {(device index, stream): int32 counters, all 0 between launches}
_counters = {}


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
    The kernel streams 64 x 64 or 64 x 128 output tiles (pixels x output
    channels, chosen by grid size) through steps of one tap and 16 input
    channels, and splits the reduction over several blocks (split-K) where
    the grid has fewer than two tiles an SM; its shared memory does not
    grow with the image, so unlike the TPU guard's VMEM budget there is no
    size limit.  Channel counts need not be multiples of 4 or of a tile
    (ragged pieces are read element by element).  It admits every geometry
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
    as the TPU kernel and the JAX package's ``_apply`` round it.  The ReLU
    is ``jnp.maximum(out, 0)``'s, whose gradient is 0.5 at a tie (the
    executor differentiates this where a BatchNorm has consumers besides
    its fused convolutions)."""
    out = x * scale.to(x.dtype).reshape(1, 1, 1, -1) \
        + shift.to(x.dtype).reshape(1, 1, 1, -1)
    return _relu(out) if relu else out


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


def vec_flags(x, w, scale, shift):
    """(vec_x, vec_w): whether the kernel may read x, scale and shift in
    16-byte pieces along channels (Cin a multiple of 16 bytes' elements and
    every base 16-byte aligned), and w along Cout; otherwise it reads them
    element by element."""
    per = 16 // x.element_size()
    vec_x = x.shape[3] % per == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, scale, shift))
    vec_w = w.shape[3] % per == 0 and w.data_ptr() % 16 == 0
    return int(vec_x), int(vec_w)


def plan(lib, x_shape, w_shape, stride, pad, tile=-1, splits=0,
         device_index=None):
    """(tile, BM, BN, S, tiles) of the kernel for these shapes: the output
    tile (0: 64 x 64, 1: 64 x 128) and S, the split-K slices, chosen by
    ``nc_plan`` from the grid and the current device's SM count (or forced,
    ``tile`` >= 0, ``splits`` >= 1), and the number of output tiles."""
    n, h, wd, cin = x_shape
    k, cout = w_shape[0], w_shape[3]
    oh, ow = _geom(h, wd, k, stride, pad)
    key = (device_index, n, oh, ow, cin, cout, k, tile, splits)
    got = _plans.get(key)
    if got is None:
        out = (ctypes.c_int * 5)()
        if lib.nc_plan(n, oh, ow, cin, cout, k, tile, splits, out):
            raise MXNetError("norm_conv: no kernel plan for x %s, w %s "
                             "(tile %d, splits %d)" % (tuple(x_shape),
                                                       tuple(w_shape), tile,
                                                       splits))
        got = _plans[key] = tuple(out)
    return got


def scratch(p, device, stream=None):
    """(workspace, counters) of a launch with plan ``p``: S partial tiles
    for each output tile, from the caching allocator on the current stream,
    and the int32 tile counters, which the kernel leaves at 0 (one zeroed
    buffer for each device and stream, grown as needed); (None, None)
    without split-K."""
    _, bm, bn, splits, tiles = p
    if splits == 1:
        return None, None
    ws = torch.empty(tiles * splits * bm * bn, dtype=torch.float32,
                     device=device)
    key = (device, stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < tiles:
        cnt = _counters[key] = torch.zeros(max(tiles, 1024),
                                           dtype=torch.int32, device=device)
    return ws, cnt


def launch(lib, x, w, sc, sh, y, ysum, ysq, kernel, stride, pad, relu,
           prologue, stats, p, stream):
    """One ``nc_launch`` of ``lib`` with plan ``p`` on the given stream
    (None on the CPU, where ``bench/host_emu.py`` runs the source); returns
    its error code."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    oh, ow = _geom(h, wd, kernel, stride, pad)
    ws, cnt = scratch(p, x.device, stream)
    vec_x, vec_w = vec_flags(x, w, sc, sh)
    return lib.nc_launch(
        x.data_ptr(), w.data_ptr(), sc.data_ptr(), sh.data_ptr(),
        y.data_ptr(), ysum.data_ptr() if stats else None,
        ysq.data_ptr() if stats else None,
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), n, h, wd, cin, cout, kernel,
        stride, pad, oh, ow, int(relu), int(prologue), int(stats),
        int(x.dtype == torch.bfloat16), vec_x, vec_w, p[0], p[3], stream)


def _launch(x, w, scale, shift, kernel, stride, pad, relu, prologue, stats):
    global launches, stats_launches, bf16_launches
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
        p = plan(lib, x.shape, w.shape, stride, pad,
                 device_index=x.device.index)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(lib, x, w, sc, sh, y, ysum, ysq, kernel, stride, pad,
                     relu, prologue, stats, p, stream)
    _kernel.check(err, "norm_conv")
    launches += 1
    stats_launches += int(stats)
    bf16_launches += int(x.dtype == torch.bfloat16)
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


def _fold(dy, dsum, dsq, y):
    """dy + dsum + 2 y dsq (d sum/dy = 1, d sum y^2/dy = 2y): the
    statistics' cotangents folded into one cotangent of y, in at least
    float32, then in dy's dtype (a None cotangent is 0)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    out = torch.zeros_like(y, dtype=acc) if dy is None else dy.to(acc)
    if dsum is not None:
        out = out + dsum.to(acc).reshape(1, 1, 1, -1)
    if dsq is not None:
        out = out + 2.0 * y.to(acc) * dsq.to(acc).reshape(1, 1, 1, -1)
    return out.to(y.dtype if dy is None else dy.dtype)


def _gate(xh, dxh):
    """The prologue ReLU's backward on the recomputed output xh: 0 where
    xh is not positive, a tie included."""
    return torch.where(xh > 0, dxh, 0.0)


class NormConv(torch.autograd.Function):
    """NormConv in training (counterpart: ``_nc_core`` with its custom VJP
    ``_nc_core_fwd`` / ``_nc_core_bwd``).

    ``apply(x, w, scale, shift, kernel, stride, pad, relu, prologue,
    stats)``: x channel-last (N, H, W, Cin), w the logical (O, I, k, k)
    weight, whose HWIO copy for the kernel is made here on every call (so
    the weight's gradient never meets a copy made outside autograd).
    Returns y, or (y, sum y, sum y^2) with ``stats``, all differentiable.
    Saves x, w, scale, shift and, with ``stats``, y.

    The backward folds the statistics' cotangents into dy (d sum/dy = 1,
    d sum y^2/dy = 2y) in at least float32, recomputes the prologue, takes
    the convolution's data and weight gradients (channels_last views, so
    NHWC needs no transpose), gates with ``xh > 0`` (0 at a tie, as the
    JAX package's VJP), and reduces dscale and dshift in at least
    float32.  dW comes back in (O, I, k, k)."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, kernel, stride, pad, relu,
                prologue, stats):
        y, ysum, ysq = norm_conv(x, w.permute(2, 3, 1, 0).contiguous(),
                                 scale, shift, kernel, stride, pad, relu,
                                 prologue, stats)
        ctx.save_for_backward(x, w, scale, shift, y if stats else None)
        ctx.geom = (int(kernel), int(stride), int(pad), bool(relu),
                    bool(prologue), bool(stats))
        ctx.set_materialize_grads(False)
        if stats:
            return y, ysum, ysq
        return y

    @staticmethod
    def backward(ctx, dy, dsum=None, dsq=None):
        x, w, scale, shift, y = ctx.saved_tensors
        _, stride, pad, relu, prologue, stats = ctx.geom
        need_x, need_w, need_sc, need_sh = ctx.needs_input_grad[:4]
        none = (None,) * 6
        if dy is None and dsum is None and dsq is None:
            return (None,) * 4 + none
        if stats and (dsum is not None or dsq is not None):
            dy_eff = _fold(dy, dsum, dsq, y)
        else:
            dy_eff = dy
        xh = _apply(x, scale, shift, relu) if prologue else x
        # the data gradient feeds dx and, through the prologue, dscale and
        # dshift; a data input with no gradient skips it
        need_dxh = need_x or (prologue and (need_sc or need_sh))
        dxh, dw, _ = torch.ops.aten.convolution_backward(
            dy_eff.permute(0, 3, 1, 2), xh.permute(0, 3, 1, 2), w, None,
            [stride, stride], [pad, pad], [1, 1], False, [0, 0], 1,
            [need_dxh, need_w, False])
        dx = dscale = dshift = None
        if need_dxh:
            dxh = dxh.permute(0, 2, 3, 1)
            if not prologue:
                return (dxh, dw, None, None) + none
            dpre = _gate(xh, dxh) if relu else dxh
            acc = torch.promote_types(x.dtype, torch.float32)
            if need_x:
                dx = dpre * scale.to(dpre.dtype).reshape(1, 1, 1, -1)
            if need_sc:
                dscale = (dpre * x).to(acc).sum(dim=(0, 1, 2)) \
                    .to(scale.dtype)
            if need_sh:
                dshift = dpre.to(acc).sum(dim=(0, 1, 2)).to(shift.dtype)
        return (dx, dw, dscale, dshift) + none
