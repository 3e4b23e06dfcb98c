#!/usr/bin/env python3
"""Rtc's ``axpb`` user kernel against other bodies and ``torch.add``, timed
on one card.

    python3 mxnet_tpu_torch/bench/axpb_variants.py

Pushes through ``rtc.Rtc``, over chip_smoke.py's 163,087,441 float32
elements (the LM's parameter count), each body below, checks that its
output equals ``x * 2 + y`` bit for bit, and times it in turns with
``torch.add(y, x, alpha=2)`` (variant, add, add, variant; CUDA events over
20 pushes each), two rounds:

- committed: ``rtc_kernels.make_axpb`` (float4, one tile a block, a grid
  of whole SMs);
- committed with streaming cache hints (``__ldcs`` / ``__stcs``);
- a persistent grid: 8 blocks of 256 an SM looping over the array by
  float4, 4 of each input in flight a thread, streaming hints;
- the same without the hints;
- the body before: one element a thread a step, a grid of at most 4,096
  blocks.

Prints the card's name and power limit first, and the byte bound (12
bytes an element at 3.35 TB/s).
"""
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import rtc  # noqa: E402
from mxnet_tpu_torch import rtc_kernels as rk  # noqa: E402

N = 163087441
HINTS = (("a[u] = x4[k + u * blockDim.x];",
          "a[u] = __ldcs(x4 + k + u * blockDim.x);"),
         ("b[u] = y4[k + u * blockDim.x];",
          "b[u] = __ldcs(y4 + k + u * blockDim.x);"),
         ("o4[k + u * blockDim.x] = make_float4(",
          "__stcs(o4 + k + u * blockDim.x, make_float4("),
         ("a[u].z * 2.0f + b[u].z, a[u].w * 2.0f + b[u].w);",
          "a[u].z * 2.0f + b[u].z, a[u].w * 2.0f + b[u].w));"))
PERSISTENT = r"""
  const long long n = %(n)dLL;
  const long long nt = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long n4 = n / 4;
  for (; i + 3 * nt < n4; i += 4 * nt) {
    float4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = LD(x4 + i + u * nt);
      b[u] = LD(y4 + i + u * nt);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      ST(o4 + i + u * nt, make_float4(a[u].x * 2.0f + b[u].x,
         a[u].y * 2.0f + b[u].y, a[u].z * 2.0f + b[u].z,
         a[u].w * 2.0f + b[u].w));
  }
  for (; i < n4; i += nt) {
    const float4 a = LD(x4 + i), b = LD(y4 + i);
    ST(o4 + i, make_float4(a.x * 2.0f + b.x, a.y * 2.0f + b.y,
                           a.z * 2.0f + b.z, a.w * 2.0f + b.w));
  }
  for (i = 4 * n4 + blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += nt)
    out[i] = x[i] * 2.0f + y[i];
"""
SCALAR = r"""
  const long long n = %(n)dLL;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    out[i] = x[i] * 2.0f + y[i];
"""


def main():
    if not torch.cuda.is_available():
        sys.exit("axpb_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    committed, launch = rk.make_axpb(N)
    hinted = committed.kernel
    for old, new in HINTS:
        if old not in hinted:
            sys.exit("axpb_variants: anchor not found:\n" + old)
        hinted = hinted.replace(old, new)
    plain_macros = "#define LD(p) (*(p))\n#define ST(p, v) (*(p) = (v))\n"
    hint_macros = "#define LD(p) __ldcs(p)\n#define ST(p, v) __stcs(p, v)\n"
    persistent = {"grid_dim_x": sms * 8, "block_dim_x": 256}
    bodies = [
        ("committed", committed.kernel, launch),
        ("committed with streaming hints", hinted, launch),
        ("persistent grid, streaming hints",
         hint_macros + PERSISTENT % {"n": N}, persistent),
        ("persistent grid", plain_macros + PERSISTENT % {"n": N},
         persistent),
        ("one element a thread a step (before)", SCALAR % {"n": N},
         {"grid_dim_x": min(-(-N // 256), 4096), "block_dim_x": 256})]
    gpu = mt.gpu(0)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    x = mt.nd.NDArray(torch.randn(N, device="cuda", generator=gen), ctx=gpu)
    y = mt.nd.NDArray(torch.randn(N, device="cuda", generator=gen), ctx=gpu)
    out = mt.nd.zeros((N,), ctx=gpu)
    want = rk.axpb_plain(x.value, y.value)
    print("axpb_variants n=%d bound_ms=%r" % (N, 12.0 * N / cs.PEAK_BYTES
                                              * 1e3))
    for i, (name, body, lk) in enumerate(bodies):
        r = rtc.Rtc("axpb_v%d" % i, ["x", "y"], ["out"], body)
        lib = r._library([torch.float32] * 2, [torch.float32])
        regs = re.findall(r"Used (\d+) registers", lib.log or "")
        out.value.zero_()
        r.push([x, y], [out], **lk)
        torch.cuda.synchronize()
        same = torch.equal(out.value, want)
        if not same:
            sys.exit("axpb_variants: %s differs from x * 2 + y" % name)
        for rnd in range(2):
            t = [cs.time_ms(torch, lambda: r.push([x, y], [out], **lk)),
                 cs.time_ms(torch, lambda: torch.add(y.value, x.value,
                                                     alpha=2.0)),
                 cs.time_ms(torch, lambda: torch.add(y.value, x.value,
                                                     alpha=2.0)),
                 cs.time_ms(torch, lambda: r.push([x, y], [out], **lk))]
            print("axpb_variants round=%d kernel_ms=%r add_ms=%r turns=%r "
                  "launch=%s registers=%s bitwise=%s variant=%s"
                  % (rnd, (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t, lk,
                     ",".join(regs), same, name), flush=True)


if __name__ == "__main__":
    main()
