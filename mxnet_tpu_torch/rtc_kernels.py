"""User kernels for ``rtc.Rtc``: CUDA C bodies written by hand for the card,
each beside its plain PyTorch version.

These are what a user of the imperative API pushes through ``Rtc``; they are
kept here, in one place, so that ``chip_smoke.py`` and
``tests/test_torch_rtc.py`` push the same sources and hold them against the
same plain versions.  Each ``make_*`` function returns ``(rtc, launch)``:
the ``Rtc`` for the given size (sizes and constants are formatted into the
source, as the reference MXRtc required) and the ``push`` keywords of its
grid and block.

- ``axpb``: out = x * 2 + y (the twin of the JAX package's
  ``test_rtc_pallas_kernel``); bound by bytes, 12 per element.  When x, y
  and out sit at one offset within 16 bytes (tested in the body: aligned
  arrays, or views one element off, as slices are), ``float4`` loads and
  stores, AXPB_UNROLL of each input in flight a thread, one tile of
  AXPB_UNROLL x BLOCK float4 a block, and the at most three elements
  before and after one at a time; otherwise one element at a time, four in
  flight a thread.  The grid is a multiple of the card's SM count that
  covers the tiles.
- ``exp5_shared``: y = expf(5 x) through a ``__shared__`` buffer, one
  block of 10 threads (the reference MXNet 0.9 Rtc test's body).
- ``transpose_tiled``: x (H, W) -> x^T through a 32 x 33 shared tile,
  grid (ceil(W/32), ceil(H/32)), block (32, 8).
- ``sgd_mom``: the sgd_mom_update rule in place on (w, g, m): three
  inputs, two outputs that are also inputs; the products and sums are
  rounded one by one (``__fmul_rn``, ``__fadd_rn``), as the op's separate
  elementwise kernels round them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from .rtc import Rtc

__all__ = ["make_axpb", "axpb_plain", "make_exp5_shared", "exp5_plain",
           "make_transpose_tiled", "transpose_plain", "make_sgd_mom",
           "sgd_mom_plain"]

BLOCK = 256
MAX_BLOCKS = 4096      # grid-stride loops: enough blocks to fill the card
AXPB_UNROLL = 4        # float4 loads of each input a thread

AXPB = r"""
  const long long n = %(n)dLL;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.x * blockDim.x;
  // float4 over the elements [h, h + 4 n4) when x, y and out sit at one
  // offset within 16 bytes; the rest one at a time
  const unsigned long long ax = reinterpret_cast<unsigned long long>(x) & 15;
  long long h = 0, n4 = 0;
  if (ax == (reinterpret_cast<unsigned long long>(y) & 15)
      && ax == (reinterpret_cast<unsigned long long>(out) & 15)) {
    h = (long long)((16 - ax) & 15) / 4;
    if (h > n) h = n;
    n4 = (n - h) / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x + h);
    const float4* y4 = reinterpret_cast<const float4*>(y + h);
    float4* o4 = reinterpret_cast<float4*>(out + h);
    const long long tile = %(unroll)d * (long long)blockDim.x;
    for (long long k = blockIdx.x * tile + threadIdx.x; k < n4;
         k += gridDim.x * tile) {
      float4 a[%(unroll)d], b[%(unroll)d];
#pragma unroll
      for (int u = 0; u < %(unroll)d; ++u)
        if (k + u * blockDim.x < n4) {
          a[u] = x4[k + u * blockDim.x];
          b[u] = y4[k + u * blockDim.x];
        }
#pragma unroll
      for (int u = 0; u < %(unroll)d; ++u)
        if (k + u * blockDim.x < n4)
          o4[k + u * blockDim.x] = make_float4(
              a[u].x * 2.0f + b[u].x, a[u].y * 2.0f + b[u].y,
              a[u].z * 2.0f + b[u].z, a[u].w * 2.0f + b[u].w);
    }
  }
  for (long long i = t; i < h; i += nt)
    out[i] = x[i] * 2.0f + y[i];
  long long i = h + 4 * n4 + t;
  for (; i + 3 * nt < n; i += 4 * nt) {
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = x[i + u * nt];
      b[u] = y[i + u * nt];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[i + u * nt] = a[u] * 2.0f + b[u];
  }
  for (; i < n; i += nt)
    out[i] = x[i] * 2.0f + y[i];
"""

EXP5_SHARED = r"""
  __shared__ float s_rec[10];
  s_rec[threadIdx.x] = x[threadIdx.x];
  y[threadIdx.x] = expf(s_rec[threadIdx.x] * 5.0);
"""

TRANSPOSE_TILED = r"""
  const int H = %(h)d, W = %(w)d;
  __shared__ float tile[32][33];
  int c = blockIdx.x * 32 + threadIdx.x;
  int r = blockIdx.y * 32 + threadIdx.y;
  for (int j = 0; j < 32; j += 8)
    if (c < W && r + j < H)
      tile[threadIdx.y + j][threadIdx.x] = x[(long long)(r + j) * W + c];
  __syncthreads();
  c = blockIdx.y * 32 + threadIdx.x;
  r = blockIdx.x * 32 + threadIdx.y;
  for (int j = 0; j < 32; j += 8)
    if (c < H && r + j < W)
      xt[(long long)(r + j) * H + c] = tile[threadIdx.x][threadIdx.y + j];
"""

SGD_MOM = r"""
  const long long n = %(n)dLL;
  const float lr = %(lr)s, momentum = %(momentum)s, wd = %(wd)s;
  const float rescale = %(rescale)s, clip = %(clip)s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const float wi = w[i];
    float gi = __fmul_rn(g[i], rescale);
    if (clip >= 0.0f) gi = fminf(fmaxf(gi, -clip), clip);
    gi = __fadd_rn(gi, __fmul_rn(wd, wi));
    const float mi = __fsub_rn(__fmul_rn(momentum, m[i]), __fmul_rn(lr, gi));
    m_out[i] = mi;
    w_out[i] = __fadd_rn(wi, mi);
  }
"""


def _f32(v):
    """A float literal that reads back as float32(v) exactly."""
    return "%.9ef" % float(np.float32(v))


def _stride_launch(n):
    return {"grid_dim_x": max(1, min(-(-n // BLOCK), MAX_BLOCKS)),
            "block_dim_x": BLOCK}


def sm_count():
    """The current card's SM count, or 1 without a card (where ``push``
    raises)."""
    if not torch.cuda.is_available():
        return 1
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def make_axpb(n):
    """out = x * 2 + y over ``n`` float32 elements.  The grid is a multiple
    of ``sm_count()``: one tile of AXPB_UNROLL x BLOCK float4 a block,
    rounded up to whole SMs."""
    sms = sm_count()
    tiles = -(-(n // 4) // (AXPB_UNROLL * BLOCK))
    grid = sms * min(max(1, -(-tiles // sms)), (2 ** 31 - 1) // sms)
    src = AXPB % {"n": n, "unroll": AXPB_UNROLL}
    return (Rtc("axpb", ["x", "y"], ["out"], src),
            {"grid_dim_x": grid, "block_dim_x": BLOCK})


def axpb_plain(x, y):
    return x * 2.0 + y


def make_exp5_shared():
    """y = expf(5 x) for 10 float32 elements, grid (1,1,1), block (10,1,1)."""
    return (Rtc("exp5_shared", ["x"], ["y"], EXP5_SHARED, grid=(1, 1, 1)),
            {"block_dim_x": 10})


def exp5_plain(x):
    return torch.exp(5 * x)


def make_transpose_tiled(h, w):
    """xt = x^T for a float32 (h, w) x."""
    return (Rtc("transpose_tiled", ["x"], ["xt"],
                TRANSPOSE_TILED % {"h": h, "w": w}),
            {"grid_dim_x": -(-w // 32), "grid_dim_y": -(-h // 32),
             "block_dim_x": 32, "block_dim_y": 8})


def transpose_plain(x):
    return x.t().contiguous()


def make_sgd_mom(n, lr, momentum, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """w, m <- sgd_mom_update(w, g, m) over ``n`` float32 elements, pushed
    as ``push([w, g, m], [w, m], ...)``."""
    src = SGD_MOM % {"n": n, "lr": _f32(lr), "momentum": _f32(momentum),
                     "wd": _f32(wd), "rescale": _f32(rescale_grad),
                     "clip": _f32(clip_gradient)}
    return (Rtc("sgd_mom", ["w", "g", "m"], ["w_out", "m_out"], src),
            _stride_launch(n))


def sgd_mom_plain(w, g, m, lr, momentum, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """The registered op on NDArrays: (new w, new m) as new NDArrays."""
    return nd.sgd_mom_update(w, g, m, lr=lr, momentum=momentum, wd=wd,
                             rescale_grad=rescale_grad,
                             clip_gradient=clip_gradient)
