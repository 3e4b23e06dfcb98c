#!/usr/bin/env python3
"""Variants of the flash-attention forward kernel, timed on one card.

    python3 mxnet_tpu_torch/bench/fwd_variants.py [--sweep]
                                                  [--against OTHER.cu]

Builds ``csrc/flash_attention.cu`` as it is and with the text
substitutions below (each anchor must be found, or the script stops), one
nvcc each, started together, and prints ptxas's registers and spill
stores of every instantiation of each library.  Then it times
``flash_fwd_launch`` (the C launcher, without the Python wrapper) of each
library on the same inputs: the LM's shape, (4, 12, 1024, 64), causal, with
q, k, v strided as the LM makes them, and the shapes of chip_smoke.py's
FLASH_CHECKS.

- default: the committed kernel at every shape, float32; at the LM's shape
  the ablations, which compute something else and say where the time goes
  (phase 1 alone: S, the online softmax and P^T; phase 2 alone: the
  rescale and O += P.V; the K/V tiles loaded once instead of per tile);
  and each tile of the plan that has two K/V buffers (stage B: the next
  tile copied with cp.async while this one is used) with one, at the
  shapes of its D bucket, held to the committed kernel's result (max |d|);
- ``--sweep``: other tiles of each D bucket, rows_dot_f4 with its loop
  order turned (B rows held across A rows), and the grid rule (32-query
  tiles where a grid of 64-query tiles has fewer blocks than SMs) forced
  each way, at the shapes of their bucket and at a D = 256 grid that fills
  the card, float32, held to the committed kernel's result;
- ``--against``: another source of the kernel (the parent commit's, say),
  its launcher bound from its own text, timed beside the committed one at
  the LM's shape and every FLASH_CHECKS shape, float32 and bfloat16, in the
  order against, committed, committed, against, with each pair's ratio and
  both kernels' errors against ``flash_attention_ref`` (within O_TOL and
  LSE_TOL or not).

Times are ms a launch (CUDA events over 20 launches), two rounds in turns.
Prints the card's name and power limit first.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import FLASH_CHECKS, LSE_TOL, O_TOL, lm_qkv  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mxnet_tpu_torch.ops.kernel_build import (NVCC_FLAGS, _nvcc,  # noqa: E402
                                              c_argtypes)

SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "fwd_variants")
# (shape, causal, scale, strided as the LM makes them)
LM = ((4, 12, 1024, 64), True, None, True)
CASES = [LM] + [c + (False,) for c in FLASH_CHECKS]
D64 = [c for c in CASES if c[0][3] <= 64]
D128 = [c for c in CASES if 64 < c[0][3] <= 128]
D256 = [c for c in CASES if c[0][3] > 128]
# a D = 256 grid that fills the card, timed by the sweep only
SWEEP_ONLY = [((4, 8, 1024, 256), True, None, False)]

LOADS = """      load_rows<NTH>(KVs, kp, st.kt, k0, BK, D, ld, vec, tid, 1.f);
      load_rows<NTH>(KVs + BK * ld, vp, st.vt, k0, BK, D, ld, vec, tid,
                     1.f);"""
PHASE1 = "    rows_dot_f4<RQ, 8, RK, TK>(Qs, ld, tq, Ks, ld, tk, D4, s);"
PHASE1_STANDIN = """#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = Qs[tq + i] * Ks[tk + j];"""
PHASE2 = ("    cols_outer_f4<BK, MQ, 8, NB, TK>(Ps, LDP, tq, Vs, ld, tk, D4, "
          "acc);")
SMALL_GRID = "const bool small = (long long)B * H * (T_ / 64) < sms;"
TILE0 = "{128, 64, 32, 64, 3, 2}"
TILE1 = "{128, 32, 64, 64, 2, 2}"
TILE2 = "{128, 64, 32, 128, 2, 2}"
TILE3 = "{128, 32, 64, 128, 1, 2}"
TILE4 = "{256, 32, 32, 256, 2, 1}"
TILE5 = "{256, 32, 64, 256, 1, 1}"

ROWS_DOT = """    float4 a[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (a0 + SA * i) * lda +
                                              4 * d4);
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (b0 + SB * j) * ldb + 4 * d4);
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        float x = fmaf(a[i].x, b.x, acc[i][j]);
        x = fmaf(a[i].y, b.y, x);
        x = fmaf(a[i].z, b.z, x);
        acc[i][j] = fmaf(a[i].w, b.w, x);
      }
    }"""
# the same sums in the same order, with the RB rows of B held in registers
# across the RA rows of A instead of the other way round
ROWS_DOT_B = """    float4 b[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (b0 + SB * j) * ldb +
                                              4 * d4);
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (a0 + SA * i) * lda + 4 * d4);
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        float x = fmaf(a.x, b[j].x, acc[i][j]);
        x = fmaf(a.y, b[j].y, x);
        x = fmaf(a.z, b[j].z, x);
        acc[i][j] = fmaf(a.w, b[j].w, x);
      }
    }"""


def variants(src, sweep):
    """{name: (source text, [case, ...])}"""
    def sub(*pairs):
        text = src
        for old, new in pairs:
            if old not in text:
                sys.exit("fwd_variants: anchor not found in the source:\n"
                         + old)
            text = text.replace(old, new)
        return text

    def tile(old, new):
        return (old, "{%s}" % new)
    once = "      if (kb == 0) {\n" + LOADS + "\n      }"
    bstat = (ROWS_DOT, ROWS_DOT_B)
    out = {
        "committed": (src, CASES + (SWEEP_ONLY if sweep else [])),
        "ablation: K/V tiles loaded once": (sub((LOADS, once)), [LM]),
        "ablation: phase 1 alone": (sub((PHASE2, "")), [LM]),
        "ablation: phase 2 alone": (sub((PHASE1, PHASE1_STANDIN)), [LM]),
        "stage B off: tile 0 with 1 K/V buffer": (sub(
            tile(TILE0, "128, 64, 32, 64, 3, 1")), D64),
        "stage B off: tile 1 with 1 K/V buffer": (sub(
            tile(TILE1, "128, 32, 64, 64, 3, 1")), D64),
        "stage B off: tile 2 with 1 K/V buffer": (sub(
            tile(TILE2, "128, 64, 32, 128, 2, 1")), D128),
        "stage B off: tile 3 with 1 K/V buffer, 2 blocks an SM": (sub(
            tile(TILE3, "128, 32, 64, 128, 2, 1")), D128),
    }
    if not sweep:
        return out
    out.update({
        "rows_dot_f4 B-stationary": (sub(bstat), CASES + SWEEP_ONLY),
        "rows_dot_f4 B-stationary, tile 0 BK 64, 2 blocks an SM": (sub(
            bstat, tile(TILE0, "128, 64, 64, 64, 2, 2")), D64),
        "tile 0: BK 64, 2 blocks an SM": (sub(
            tile(TILE0, "128, 64, 64, 64, 2, 2")), D64),
        "tile 1: 3 blocks an SM": (sub(
            tile(TILE1, "128, 32, 64, 64, 3, 2")), D64),
        "tile 1: BK 32, 3 blocks an SM": (sub(
            tile(TILE1, "128, 32, 32, 64, 3, 2")), D64),
        "grid rule: 32-query tiles at every grid size": (sub(
            (SMALL_GRID, "const bool small = true;")), D64 + D128 + D256),
        "grid rule: 64-query tiles at every grid size": (sub(
            (SMALL_GRID, "const bool small = false;")), D64 + D128 + D256),
        "tile 3: BK 32, 2 blocks an SM": (sub(
            tile(TILE3, "128, 32, 32, 128, 2, 2")), D128),
        "tile 4: 2 K/V buffers, 1 block an SM": (sub(
            tile(TILE4, "256, 32, 32, 256, 1, 2")), D256 + SWEEP_ONLY),
        "tile 4: 128 threads": (sub(
            tile(TILE4, "128, 32, 32, 256, 2, 1")), D256 + SWEEP_ONLY),
        "tile 5: BK 32, 2 blocks an SM": (sub(
            tile(TILE5, "256, 32, 32, 256, 2, 1")), D256),
    })
    return out


def ptxas_fwd(log):
    """registers and spill stores of each instantiation of the kernel"""
    name, out = None, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)(\w*?)EEvPK",
                          line)
            name = None if m is None else "%s<%s>" % (
                "f32" if m.group(1) == "f" else "bf16",
                ",".join(re.findall(r"Li(\d+)E", m.group(2) + "E")))
        elif name and ("registers" in line or "spill stores" in line):
            out.append("%s %s" % (name, line.split(":", 1)[-1].strip()))
    return "; ".join(out)


def time_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


class Run(object):
    """One forward's inputs and outputs on the card, launched by any
    library's ``flash_fwd_launch`` (a launcher without the alignment flag,
    an older source's, takes one int fewer)."""

    def __init__(self, case, dtype, gen):
        shape, causal, scale, lm_strided = case
        b, h, t, d = shape
        if lm_strided:
            q, k, v = lm_qkv(torch, gen, b, h, t, d, dtype)
        else:
            q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
        self.q, self.k, self.v = q, k, v
        self.causal, self.scale = causal, scale
        self.o = torch.empty(shape, dtype=dtype, device="cuda")
        self.lse = torch.empty((b, h, t, 1), device="cuda")
        self.args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     self.o.data_ptr(), self.lse.data_ptr(),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     b, h, t, d, fa._scale(d, scale), int(causal),
                     int(dtype == torch.bfloat16))
        self.vec = int(fa.aligned16(q, k, v))

    def call(self, fn):
        flag = (self.vec,) if len(fn.argtypes) == 23 else ()
        err = fn(*self.args, *flag, torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit("fwd_variants: launch failed (%d)" % err)

    def errors(self):
        """(max |do| over max |o_ref|, max |dlse| over max(1, |lse_ref|))
        of the last launch against the plain version"""
        torch.cuda.synchronize()
        o, lse = fa.flash_attention_ref(self.q, self.k, self.v, self.causal,
                                        self.scale)
        eo = ((self.o.float() - o.float()).abs().max()
              / o.float().abs().max()).item()
        el = ((self.lse - lse).abs().max()
              / lse.abs().max().clamp_min(1.0)).item()
        return eo, el


def build(texts):
    """{name: (forward launch function, ptxas summary)}, one nvcc each,
    started together; each launcher bound from its own source text"""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(OUT, "v%d.cu" % i)
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + ["-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit("fwd_variants: nvcc failed on %s:\n%s" % (name, log))
        fn = ctypes.CDLL(so).flash_fwd_launch
        fn.argtypes = c_argtypes(texts[name], "flash_fwd_launch")
        fn.restype = ctypes.c_int
        out[name] = (fn, ptxas_fwd(log))
    return out


def label(case):
    shape, causal, scale, lm_strided = case
    return "shape=%s %s scale=%s%s" % (shape, "causal" if causal else "full",
                                       scale, " lm-strided" if lm_strided
                                       else "")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time the other tiles and the grid rule too")
    ap.add_argument("--against", help="another flash_attention.cu whose "
                    "forward kernel is timed beside the committed one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fwd_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    with open(SOURCE) as f:
        found = variants(f.read(), args.sweep)
    texts = {name: text for name, (text, _) in found.items()}
    if args.against:
        with open(args.against) as f:
            texts["against"] = f.read()
    libs = build(texts)
    for name, (_, ptx) in libs.items():
        print("fwd_variants ptxas variant=%s %s" % (name, ptx))

    gen = torch.Generator(device="cuda").manual_seed(0)
    runs, want = {}, {}
    for case in found["committed"][1]:
        runs[case] = Run(case, torch.float32, gen)
        runs[case].call(libs["committed"][0])
        torch.cuda.synchronize()
        want[case] = runs[case].o.clone()
    for rnd in range(2):
        for name, (_, cases) in found.items():
            for case in cases:
                run = runs[case]
                ms = time_ms(lambda: run.call(libs[name][0]))
                diff = ""
                if not name.startswith("ablation"):
                    diff = " max_abs_diff=%r" % (run.o - want[case]).abs() \
                        .max().item()
                print("fwd_variants round=%d %s float32 ms=%r%s variant=%s"
                      % (rnd, label(case), ms, diff, name), flush=True)

    if not args.against:
        return
    for case in CASES:
        for dt in (torch.float32, torch.bfloat16):
            run = Run(case, dt, gen)
            got, errs = {}, {}
            for name in ("against", "committed", "committed", "against"):
                got.setdefault(name, []).append(
                    time_ms(lambda: run.call(libs[name][0])))
                errs[name] = run.errors()
            dname = str(dt).split(".")[1]
            ratio = sum(got["committed"]) / sum(got["against"])
            ok = all(eo <= O_TOL[dname] and el <= LSE_TOL
                     for eo, el in errs.values())
            print("fwd_variants against %s dtype=%s committed_ms=%r "
                  "against_ms=%r ratio=%r rel_err_committed o=%r lse=%r "
                  "rel_err_against o=%r lse=%r within_tol=%s"
                  % (label(case), dname, got["committed"], got["against"],
                     ratio, *errs["committed"], *errs["against"], ok),
                  flush=True)


if __name__ == "__main__":
    main()
