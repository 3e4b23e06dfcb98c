#!/usr/bin/env python3
"""Run the port's CUDA kernel sources on the CPU.

    python3 mxnet_tpu_torch/bench/host_emu.py [--kernel fwd|bwd|nc|nms|all]
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
``norm_conv_ref``.  ``--kernel nms`` launches the two kernels of
``csrc/multibox_nms.cu`` at the cases of ``NMS_CASES`` (several images, row
counts of 1, 65 and 300 that are not a multiple of the 64-row word, the
SSD's 1,344 rows, 2,200 rows with more words than the scan stages,
rows in several bands, every box suppressed, ``force_suppress``, IoUs
exactly at the threshold, a workspace filled with all-ones bits, float32
and float64) and prints whether their ids equal ``greedy_nms_ref``'s.
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
from mxnet_tpu_torch.ops import contrib  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mxnet_tpu_torch.ops import norm_conv as nc  # noqa: E402
from mxnet_tpu_torch.ops.kernel_build import c_argtypes  # noqa: E402

__all__ = ["translate", "host_library", "fwd_on_host", "bwd_on_host",
           "nc_on_host", "nms_library", "nms_on_host"]


def translate(text):
    """The CUDA source text as host C++ for ``host_emu.h``."""
    text = re.sub(r"(\w+(?:<[^<>]*(?:<[^<>]*>[^<>]*)*>)?)<<<([^>]*)>>>\(",
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


# the scan cut down by nms_small_source: a block of at most
# SMALL_SCAN_THREADS threads (two word slots), and shared memory for
# SMALL_SCAN_STAGE words a staged row beside a band of SMALL_SCAN_BAND
# removed words
SMALL_SCAN_THREADS = 64
SMALL_SCAN_STAGE = 4
SMALL_SCAN_BAND = 16


def nms_small_source():
    """The text of ``csrc/multibox_nms.cu`` with its scan cut down
    (SMALL_SCAN_*) by substituting two constants, so that small cases reach
    the paths the card takes only at large A: a thread folding several
    words, and a fold reading words past the stage from global memory."""
    cu = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "multibox_nms.cu")
    with open(cu) as f:
        text = f.read()
    smem = 8 * (2 + (SMALL_SCAN_BAND + 1) // 2 * 2
                + 3 * 64 * (1 + SMALL_SCAN_STAGE))
    for old, new in (("NMS_SMEM = 232448;", "NMS_SMEM = %d;" % smem),
                     ("NMS_SCAN_THREADS = 512;",
                      "NMS_SCAN_THREADS = %d;" % SMALL_SCAN_THREADS)):
        if old not in text:
            raise MXNetError("host_emu: %r not found in %s" % (old, cu))
        text = text.replace(old, new)
    return text


def nms_library(out_dir, small_scan=False):
    """``csrc/multibox_nms.cu`` compiled for the host, with its scan cut
    down (``nms_small_source``) when ``small_scan``."""
    cu = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "multibox_nms.cu")
    if small_scan:
        os.makedirs(out_dir, exist_ok=True)
        cu = os.path.join(out_dir, "multibox_nms_small.cu")
        with open(cu, "w") as f:
            f.write(nms_small_source())
    return host_library(cu, out_dir)


def nms_band_bytes(b, n, band_rows):
    """An NMS_WORKSPACE_BYTES under which ``contrib.nms_plan`` bands ``b``
    images of ``n`` rows ``band_rows`` rows at a time."""
    return 8 * b * -(-n // 64) * band_rows


def nms_on_host(lib, boxes, ids, nms_threshold, force_suppress=False,
                band_rows=0, fill=None):
    """The ids after the NMS kernels of ``lib`` on CPU tensors, launched as
    ``ops/contrib.greedy_nms`` launches them on the card (``band_rows`` > 0:
    with ``contrib.NMS_WORKSPACE_BYTES`` set so that the rows are banded
    that many at a time; ``fill``: an int64 the workspace is filled with
    first, else it is left as ``torch.empty`` makes it)."""
    out = ids.contiguous().clone()
    b, n = ids.shape
    saved = contrib.NMS_WORKSPACE_BYTES
    if band_rows:
        contrib.NMS_WORKSPACE_BYTES = nms_band_bytes(b, n, band_rows)
    try:
        ws = None
        if fill is not None:
            words, rows, _ = contrib.nms_plan(b, n)
            ws = torch.full((b * (rows + 1) * words,), fill,
                            dtype=torch.int64)
        contrib.nms_launch(lib, boxes.contiguous(), out, nms_threshold,
                           force_suppress, None, ws)
    finally:
        contrib.NMS_WORKSPACE_BYTES = saved
    return out


# (images, rows, classes, kind, nms_threshold, force_suppress, dtype,
# launch options for nms_on_host): "dense" rows are random boxes, every
# one valid; "same" boxes are one box repeated, so every row after the
# first of a class is suppressed; "tie" boxes are unit-grid squares whose
# IoUs with each other are exactly 1/3, 1/7 or 0, held against thresholds
# at those values.  Rows of 1, 5, 40, 65 and 300
# end inside a 64-row word; 1,344 are the SSD's 21 words; 2,200 rows are 35
# words, more than the 2 word slots of the small scan (nms_library's
# small_scan) and more than the 4 words a row it stages, so its threads
# fold several words each, some read from global memory.  fill=-1 fills
# the workspace with all-ones bits, so that a word that the scan reads but
# no kernel wrote shows as a wrong suppression; band_rows splits the rows
# into bands whose state carries over.
NMS_CASES = [(3, 300, 3, "random", 0.5, False, torch.float32, {}),
             (2, 300, 3, "random", 0.45, True, torch.float64, {}),
             (2, 40, 1, "same", 0.5, False, torch.float32, {}),
             (2, 40, 4, "same", 0.5, True, torch.float32, {}),
             (2, 64, 2, "tie", 1.0 / 3.0, False, torch.float32, {}),
             (2, 64, 2, "tie", 1.0 / 7.0, True, torch.float64, {}),
             (1, 5, 2, "random", 0.5, False, torch.float32, {}),
             (1, 1, 2, "random", 0.5, False, torch.float32, {"fill": -1}),
             (2, 65, 3, "random", 0.5, False, torch.float64, {"fill": -1}),
             (2, 300, 3, "random", 0.5, False, torch.float32,
              {"fill": -1, "band_rows": 128}),
             (2, 1344, 3, "random", 0.5, False, torch.float32, {}),
             (1, 2200, 2, "dense", 0.45, True, torch.float64,
              {"fill": -1, "band_rows": 1024, "small_scan": True})]


def nms_case_id(case):
    """A test id for one NMS_CASES case."""
    return "%dx%d-c%d-%s-t%.3f-f%d-%s" % (
        case[0], case[1], case[2], case[3], case[4], case[5],
        str(case[6]).split(".")[1]) + "".join(
            "-%s%d" % (k, v) for k, v in sorted(case[7].items()))


def nms_inputs(case, gen):
    """(boxes, ids) on the CPU for one NMS_CASES case, the rows as
    MultiBoxDetection hands them over: score-sorted, with the rows past a
    random kept count at id -1 (none for "dense")."""
    b, n, classes, kind, _, _, dtype = case[:7]
    if kind in ("random", "dense"):
        xy = torch.rand(b, n, 2, generator=gen, dtype=torch.float64) * 0.7
        wh = torch.rand(b, n, 2, generator=gen, dtype=torch.float64) * 0.3 \
            + 0.05
        boxes = torch.cat([xy, xy + wh], -1)
    elif kind == "same":
        boxes = torch.tensor([0.1, 0.2, 0.5, 0.7],
                             dtype=torch.float64).expand(b, n, 4)
    else:   # unit squares on a grid of quarter steps
        xy = torch.randint(0, 8, (b, n, 2), generator=gen).double() * 0.25
        boxes = torch.cat([xy, xy + 1.0], -1)
    ids = torch.randint(0, classes, (b, n), generator=gen).double()
    if kind != "dense":
        kept = torch.randint(n // 2, n + 1, (b, 1), generator=gen)
        ids = torch.where(torch.arange(n) < kept, ids, -1.0)
    return boxes.to(dtype).contiguous(), ids.to(dtype)


# (N, H, Cin, Cout, K, S, P, dtype, relu, prologue, stats, tile, splits):
# tile -1 and splits 0 take nc_plan's choice (the emulated card has 4 SMs,
# so tile 1 needs 8 tiles of 64 x 128, and grids of fewer than 8 tiles of
# 64 x 64 are split).  Cin 10 (float32) and 12 or 36 (bfloat16) read x
# element by element, Cout 22 and 70 also w; ragged M and Cout throughout;
# split-K chosen (S 2 and 4) and not chosen (few steps, or a grid of 10
# tiles), tile 1 chosen and forced, and S forced to uneven slices and to
# one step a slice; 3x3 with pad 0 (Inception-v3's conv_1, conv_4 and its
# stride-2 reductions) at odd H, stride 1 and 2, Cin 32 and 96, float32 and
# bfloat16, with split-K chosen and forced
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
    (2, 9, 32, 32, 3, 1, 0, torch.float32, True, True, True, -1, 0),
    (2, 11, 96, 40, 3, 2, 0, torch.float32, True, True, False, -1, 0),
    (2, 9, 32, 24, 3, 2, 0, torch.bfloat16, True, True, True, -1, 0),
    (2, 7, 32, 40, 3, 1, 0, torch.float32, True, True, True, 0, 3),
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
    ap.add_argument("--kernel", choices=("fwd", "bwd", "nc", "nms", "all"),
                    default="all")
    ap.add_argument("--against", help="another flash_attention_bwd.cu whose "
                    "outputs are compared bit for bit")
    args = ap.parse_args()
    out = os.path.join(ROOT, "build", "host_emu")
    csrc = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
    if args.kernel in ("nms", "all"):
        libs = {}
        for i, case in enumerate(NMS_CASES):
            opts = dict(case[7])
            small = opts.pop("small_scan", False)
            if small not in libs:
                libs[small] = nms_library(out, small)
            boxes, ids = nms_inputs(case, torch.Generator().manual_seed(i))
            got = nms_on_host(libs[small], boxes, ids, case[4], case[5],
                              **opts)
            want = contrib.greedy_nms_ref(boxes, ids, case[4], case[5])
            print("host_emu nms case=%s kept=%d ids_equal=%s" % (
                nms_case_id(case), int((got >= 0).sum()),
                torch.equal(got, want)), flush=True)
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
