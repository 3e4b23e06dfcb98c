#!/usr/bin/env python3
"""Run the port's CUDA kernel sources on the CPU.

    python3 mxnet_tpu_torch/bench/host_emu.py [--kernel fwd|bwd|nc|all]
                                              [--against OTHER.cu]

``host_library`` rewrites a source of ``csrc/`` into host C++ (each
``kernel<<<...>>>(...)`` launch into ``emu_launch``, each ``extern
__shared__`` array onto one static buffer), compiles it with the host's
C++20 compiler against ``host_emu.h`` and loads it with ctypes, every
``extern "C"`` launcher bound from its own source text.  The kernels then
run on CPU tensors, one std::thread per CUDA thread: their indexing,
tiling, masks and sum order can be checked where there is no card, at
small shapes.  What only the card shows (timing, registers, the
shared-memory banks) it does not.

Run as a script, it launches the forward kernel of
``csrc/flash_attention.cu`` at the small shapes of ``FWD_CASES`` (every D
bucket and both sides of the tile choice by grid size, float32 and
bfloat16, causal and full, a given scale, contiguous, LM-strided and
unaligned rows) and prints the plan it took, o's and lse's errors against
``flash_attention_ref`` and whether both are bitwise equal over two
launches; then both backward kernels of
``csrc/flash_attention_bwd.cu`` at small shapes of every D bucket (float32
and bfloat16, causal and full, contiguous, LM-strided and unaligned rows),
prints each output's error against the plain backward, relative to its
largest entry, and with ``--against`` whether each output equals bit for
bit that of another source of the same kernels.  ``--kernel nc`` launches
``csrc/norm_conv.cu`` at the small shapes of ``NC_CASES`` (split-K on
and off, both tiles, 16-byte and element-wise loads, float32 and
bfloat16)
and prints the plan it took and y's and the statistics' errors against
``norm_conv_ref``.
"""
import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mxnet_tpu_torch.ops import norm_conv as nc  # noqa: E402
from mxnet_tpu_torch.ops.kernel_build import c_argtypes  # noqa: E402

__all__ = ["translate", "host_library", "fwd_on_host", "bwd_on_host",
           "nc_on_host"]


def translate(text):
    """The CUDA source text as host C++ for ``host_emu.h``."""
    text = re.sub(r"(\w+<[^<>]*(?:<[^<>]*>[^<>]*)*>)<<<([^>]*)>>>\(",
                  r"emu_launch(\1, \2, ", text)
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", text)
    return text.replace("#include <cuda_runtime.h>", '#include "host_emu.h"') \
        .replace("#include <cuda_bf16.h>\n", "")


def host_library(cu, out_dir):
    """Compile the source file ``cu`` for the host into ``out_dir`` and load
    it, with the argtypes of every ``extern "C"`` int launcher set."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise MXNetError("host_emu: no host C++ compiler (g++ or c++)")
    with open(cu) as f:
        text = f.read()
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, os.path.basename(cu)[:-len(".cu")])
    with open(stem + ".cpp", "w") as f:
        f.write(translate(text))
    res = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", HERE, "-o", stem + ".so", stem + ".cpp"],
        capture_output=True, text=True)
    if res.returncode:
        raise MXNetError("host_emu: %s failed on %s:\n%s"
                         % (cxx, cu, res.stderr[-4000:]))
    lib = ctypes.CDLL(stem + ".so")
    for name in re.findall(r'extern "C" int (\w+)\(', text):
        fn = getattr(lib, name)
        fn.argtypes = c_argtypes(text, name)
        fn.restype = ctypes.c_int
    return lib


def fwd_on_host(lib, q, k, v, causal=False, scale=None):
    """(o, lse, plan) of the forward kernel of ``lib`` on CPU tensors,
    launched as ``ops/flash_attention._launch`` launches it on the card;
    plan is ``fwd_plan``'s tuple (the emulated card has 4 SMs)."""
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    b, h, t, d = q.shape
    o = torch.full(q.shape, float("nan"), dtype=q.dtype)
    lse = torch.full((b, h, t, 1), float("nan"))
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, h, t, d, fa._scale(d, scale), int(causal),
        int(q.dtype == torch.bfloat16), int(fa.aligned16(q, k, v)), None)
    if err:
        raise MXNetError("host_emu: launch refused (%d)" % err)
    return o, lse, fa.fwd_plan(q.shape, lib)


def bwd_on_host(lib, q, k, v, o, lse, do, causal=False, scale=None):
    """(dq, dk, dv) of the two backward kernels of ``lib`` on CPU tensors,
    launched as ``ops/flash_attention._BwdLaunch`` launches them on the
    card (a dQ launcher without the alignment flag, an older source's,
    takes one int fewer)."""
    q, k, v, do = (x if x.stride(3) == 1 else x.contiguous()
                   for x in (q, k, v, do))
    b, h, t, d = q.shape
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    outs = [torch.full(q.shape, float("nan"), dtype=q.dtype)
            for _ in range(3)]
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    tail = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], b, h, t, d, fa._scale(d, scale), int(causal),
            int(q.dtype == torch.bfloat16))
    vec = int(fa.aligned16(q, k, v, do))
    dq_flag = (vec,) if len(lib.flash_bwd_dq_launch.argtypes) == 28 else ()
    for err in (lib.flash_bwd_dq_launch(*ins, outs[0].data_ptr(), *tail,
                                        *dq_flag, None),
                lib.flash_bwd_dkv_launch(*ins, outs[1].data_ptr(),
                                         outs[2].data_ptr(), *tail, vec,
                                         None)):
        if err:
            raise MXNetError("host_emu: launch refused (%d)" % err)
    return tuple(outs)


def nc_on_host(lib, x, w, scale, shift, kernel, stride, pad, relu=True,
               prologue=True, stats=False, tile=-1, splits=0):
    """(y, ysum, ysq, plan) of the NormConv kernel of ``lib`` on CPU
    tensors, planned and launched as ``ops/norm_conv._launch`` does on the
    card (``tile`` >= 0 and ``splits`` >= 1 force a plan; the emulated card
    has 4 SMs)."""
    sc = scale.to(x.dtype).contiguous()
    sh = shift.to(x.dtype).contiguous()
    n, h, wd, _ = x.shape
    oh, ow = nc._geom(h, wd, kernel, stride, pad)
    y = torch.full((n, oh, ow, w.shape[3]), float("nan"), dtype=x.dtype)
    ysum = ysq = None
    if stats:
        ysum = torch.zeros(w.shape[3])
        ysq = torch.zeros(w.shape[3])
    p = nc.plan(lib, x.shape, w.shape, stride, pad, tile, splits)
    err = nc.launch(lib, x, w, sc, sh, y, ysum, ysq, kernel, stride, pad,
                    relu, prologue, stats, p, None)
    if err:
        raise MXNetError("host_emu: launch refused (%d)" % err)
    return y, ysum, ysq, p


# (N, H, Cin, Cout, K, S, P, dtype, relu, prologue, stats, tile, splits):
# tile -1 and splits 0 take nc_plan's choice (the emulated card has 4 SMs,
# so tile 1 needs 8 tiles of 64 x 128, and grids of fewer than 8 tiles of
# 64 x 64 are split).  Cin 10 (float32) and 12 or 36 (bfloat16) read x
# element by element, Cout 22 and 70 also w; ragged M and Cout throughout;
# split-K chosen (S 2 and 4) and not chosen (few steps, or a grid of 10
# tiles), tile 1 chosen and forced, and S forced to uneven slices and to
# one step a slice
NC_CASES = [
    (2, 6, 64, 24, 3, 1, 1, torch.float32, True, True, True, -1, 0),
    (2, 9, 128, 24, 3, 2, 1, torch.bfloat16, True, True, True, -1, 0),
    (2, 6, 64, 24, 3, 1, 1, torch.float32, False, True, False, -1, 0),
    (2, 6, 64, 24, 3, 1, 1, torch.float32, True, False, True, -1, 0),
    (2, 7, 10, 22, 3, 1, 1, torch.float32, True, True, True, -1, 0),
    (2, 7, 12, 24, 3, 2, 1, torch.bfloat16, True, True, False, -1, 0),
    (2, 8, 16, 24, 1, 1, 0, torch.float32, True, True, True, -1, 0),
    (2, 9, 16, 40, 1, 2, 0, torch.bfloat16, True, True, True, -1, 0),
    (2, 12, 64, 72, 3, 1, 1, torch.bfloat16, True, True, True, -1, 0),
    (2, 16, 16, 128, 1, 1, 0, torch.float32, True, True, True, -1, 0),
    (2, 15, 16, 256, 1, 1, 0, torch.bfloat16, True, True, True, -1, 0),
    (2, 6, 40, 72, 3, 1, 1, torch.float32, True, True, True, 0, 3),
    (2, 6, 36, 70, 3, 2, 1, torch.bfloat16, True, True, True, 1, 5),
    (2, 6, 20, 136, 3, 1, 1, torch.float32, True, True, True, 1, 1),
    (1, 4, 16, 8, 3, 1, 1, torch.float32, True, True, True, 0, 9),
]


def nc_inputs(n, h, cin, cout, k, dtype, gen):
    """x, w, scale, shift on the CPU, from ``gen``"""
    x = torch.randn(n, h, h, cin, generator=gen).to(dtype)
    w = (torch.randn(k, k, cin, cout, generator=gen)
         * (2.0 / (k * k * cin)) ** 0.5).to(dtype)
    sc = torch.rand(cin, generator=gen) + 0.5
    sh = torch.randn(cin, generator=gen) * 0.5
    return x, w, sc, sh


def nc_errors(case, got, gen):
    """(relative error of y, of the sums, of the sums of squares) of one
    NC_CASES launch against ``norm_conv_ref`` on the same inputs"""
    n, h, cin, cout, k, s, p, dtype, relu, pro, stats = case[:11]
    x, w, sc, sh = nc_inputs(n, h, cin, cout, k, dtype, gen)
    want = nc.norm_conv_ref(x, w, sc, sh, k, s, p, relu, pro, stats)
    return [None if b is None else
            ((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, want)]


# (B, H, T, D), causal, dtype, layout: every D bucket of both kernels
CASES = [((1, 2, 128, 64), True, torch.float32, "contiguous"),
         ((1, 1, 256, 64), False, torch.float32, "contiguous"),
         ((1, 1, 128, 8), True, torch.float32, "contiguous"),
         ((1, 1, 128, 16), True, torch.float32, "contiguous"),
         ((1, 1, 256, 72), True, torch.float32, "contiguous"),
         ((1, 1, 128, 96), False, torch.float32, "contiguous"),
         ((1, 1, 128, 128), True, torch.float32, "contiguous"),
         ((1, 1, 128, 136), True, torch.float32, "contiguous"),
         ((1, 1, 256, 256), True, torch.float32, "contiguous"),
         ((1, 1, 128, 64), True, torch.bfloat16, "contiguous"),
         ((1, 1, 128, 96), True, torch.bfloat16, "contiguous"),
         ((1, 1, 128, 256), False, torch.bfloat16, "contiguous"),
         ((1, 2, 256, 64), True, torch.float32, "lm-strided"),
         ((1, 1, 128, 64), True, torch.float32, "unaligned"),
         ((1, 1, 128, 128), True, torch.bfloat16, "unaligned"),
         ((1, 1, 128, 16), False, torch.float32, "unaligned")]


# (B, H, T, D), causal, dtype, layout, scale: the forward's six tiles (the
# emulated card has 4 SMs, so a grid of fewer than 4 64-query blocks takes
# the small-grid tile of its D bucket), D 8 to 256 with 72, 96 and 136
# between the buckets' edges, rows read in 16-byte pieces (contiguous,
# LM-strided) and element by element (unaligned)
FWD_CASES = [((1, 1, 256, 64), True, torch.float32, "contiguous", None),
             ((1, 1, 128, 64), False, torch.float32, "contiguous", None),
             ((1, 1, 128, 8), True, torch.float32, "contiguous", None),
             ((1, 1, 128, 16), False, torch.bfloat16, "unaligned", None),
             ((1, 2, 256, 64), True, torch.float32, "lm-strided", None),
             ((1, 1, 256, 64), True, torch.bfloat16, "lm-strided", None),
             ((1, 1, 256, 64), False, torch.float32, "contiguous", 0.3),
             ((1, 1, 128, 64), True, torch.float32, "unaligned", None),
             ((1, 1, 256, 72), True, torch.float32, "contiguous", None),
             ((1, 1, 128, 72), False, torch.bfloat16, "contiguous", None),
             ((1, 1, 256, 128), True, torch.float32, "contiguous", None),
             ((1, 1, 128, 96), False, torch.bfloat16, "contiguous", None),
             ((1, 1, 128, 128), True, torch.bfloat16, "unaligned", None),
             ((1, 1, 128, 136), True, torch.float32, "contiguous", None),
             ((1, 1, 256, 256), True, torch.bfloat16, "contiguous", None),
             ((1, 1, 128, 256), False, torch.float32, "lm-strided", None)]


def inputs(shape, dtype, layout, gen):
    """q, k, v, dO on the CPU: contiguous, strided as the LM makes them, or
    views whose row stride is not a multiple of 16 bytes"""
    b, h, t, d = shape
    if layout == "lm-strided":
        qkv = torch.randn(b, t, 3, h, d, generator=gen).to(dtype)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        do = torch.randn(b, t, h, d, generator=gen).to(dtype)
        return qkv[0], qkv[1], qkv[2], do.permute(0, 2, 1, 3)
    if layout == "unaligned":
        base = torch.randn(4, b, h, t, d + 2, generator=gen).to(dtype)
        return tuple(base[i, ..., :d] for i in range(4))
    return tuple(torch.randn(shape, generator=gen).to(dtype)
                 for _ in range(4))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd", "nc", "all"),
                    default="all")
    ap.add_argument("--against", help="another flash_attention_bwd.cu whose "
                    "outputs are compared bit for bit")
    args = ap.parse_args()
    out = os.path.join(ROOT, "build", "host_emu")
    csrc = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
    if args.kernel in ("nc", "all"):
        lib = host_library(os.path.join(csrc, "norm_conv.cu"), out)
        for i, case in enumerate(NC_CASES):
            n, h, cin, cout, k, s, p, dtype, relu, pro, stats, t, sp = case
            x, w, sc, sh = nc_inputs(n, h, cin, cout, k, dtype,
                                     torch.Generator().manual_seed(i))
            *got, plan = nc_on_host(lib, x, w, sc, sh, k, s, p, relu, pro,
                                    stats, t, sp)
            errs = nc_errors(case, got, torch.Generator().manual_seed(i))
            print("host_emu nc case=%d x=%s w=%s s=%d p=%d %s relu=%d "
                  "prologue=%d tile=%dx%d splits=%d vec=%s rel_err y=%.3g "
                  "sum=%s sumsq=%s" % (
                      i, tuple(x.shape), tuple(w.shape), s, p,
                      str(dtype).split(".")[1], relu, pro, plan[1], plan[2],
                      plan[3], nc.vec_flags(x, w, sc.to(dtype),
                                            sh.to(dtype)),
                      errs[0], errs[1], errs[2]), flush=True)
    if args.kernel in ("fwd", "all"):
        lib = host_library(os.path.join(csrc, "flash_attention.cu"), out)
        for i, (shape, causal, dtype, layout, scale) in enumerate(FWD_CASES):
            q, k, v, _ = inputs(shape, dtype, layout,
                                torch.Generator().manual_seed(i))
            o, lse, plan = fwd_on_host(lib, q, k, v, causal, scale)
            o2, lse2, _ = fwd_on_host(lib, q, k, v, causal, scale)
            want, wlse = fa.flash_attention_ref(q, k, v, causal, scale)
            print("host_emu fwd shape=%s %s %s %s scale=%s tile=%d "
                  "threads=%d bq=%d bk=%d vec=%s rel_err o=%.3g lse=%.3g "
                  "bitwise_repeat=%s" % (
                      shape, "causal" if causal else "full",
                      str(dtype).split(".")[1], layout, scale, plan[0],
                      plan[1], plan[2], plan[3], fa.aligned16(q, k, v),
                      ((o.float() - want.float()).abs().max()
                       / want.float().abs().max()).item(),
                      ((lse - wlse).abs().max()
                       / wlse.abs().max().clamp_min(1)).item(),
                      torch.equal(o, o2) and torch.equal(lse, lse2)),
                  flush=True)
    if args.kernel not in ("bwd", "all"):
        return
    lib = host_library(os.path.join(csrc, "flash_attention_bwd.cu"), out)
    other = args.against and host_library(args.against,
                                          os.path.join(out, "against"))
    gen = torch.Generator().manual_seed(0)
    for shape, causal, dtype, layout in CASES:
        q, k, v, do = inputs(shape, dtype, layout, gen)
        o, lse = fa.flash_attention_ref(q, k, v, causal)
        want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        got = bwd_on_host(lib, q, k, v, o, lse, do, causal)
        errs = ["%s=%.3g" % (n, ((a.float() - w.float()).abs().max()
                                 / w.float().abs().max()).item())
                for n, a, w in zip(("dq", "dk", "dv"), got, want)]
        line = "host_emu shape=%s %s %s %s rel_err %s" % (
            shape, "causal" if causal else "full", str(dtype).split(".")[1],
            layout, " ".join(errs))
        if other:
            theirs = bwd_on_host(other, q, k, v, o, lse, do, causal)
            line += " bitwise_equal_to_against=%s" % all(
                torch.equal(a, b) for a, b in zip(got, theirs))
        print(line, flush=True)


if __name__ == "__main__":
    main()
