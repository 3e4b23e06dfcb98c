#!/usr/bin/env python3
"""Variants of the dK/dV kernel, timed at the LM's shape on one card.

    python3 mxnet_tpu_torch/bench/dkv_variants.py

Builds ``csrc/flash_attention_bwd.cu`` as it is and with the text
substitutions below (each anchor must be found, or the script stops), one
nvcc each, started together, and times ``flash_bwd_dkv_launch`` of each
library on the same inputs: (4, 12, 1024, 64), causal, float32, q, k, v
strided as the LM makes them.  Two kinds of variant:

- ablations, which compute something else and say where the time goes:
  the Q/dO tiles loaded once instead of per tile, phase 1 (S^T, dP^T)
  alone, phase 2 (dV, dK) alone;
- other D <= 64 tilings, which compute the same function and are held to
  the committed kernel's result (max |d|): 64-query tiles with two blocks
  an SM, and 32-query tiles with two blocks an SM instead of three.

Prints the card's name and power limit, then one line per variant and
round (two rounds, in turns), with ptxas's registers and spill stores.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mxnet_tpu_torch.ops.kernel_build import NVCC_FLAGS, _nvcc  # noqa: E402

SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                      "flash_attention_bwd.cu")
OUT = os.path.join(ROOT, "build", "dkv_variants")
SHAPE = (4, 12, 1024, 64)

LOADS = """    load_rows<NTH>(Qs, qp, st.qt, q0, BQ, D, ld, vec, tid);
    load_rows<NTH>(Gs, gp, st.gt, q0, BQ, D, ld, vec, tid);"""
PHASE1 = ("    rows_dot_f4<RK, 8, RQ, TQ>(Ks, ld, tk, Qs, ld, tq, D4, s);",
          "    rows_dot_f4<RK, 8, RQ, TQ>(Vs, ld, tk, Gs, ld, tq, D4, dp);")
PHASE1_STANDIN = """#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        s[i][j] = Ks[tk + i] * Qs[tq + j];
        dp[i][j] = Vs[tk + i] * Gs[tq + j];
      }"""
PHASE2 = ("    cols_outer_f4<2, BQ, KV, 8, NV, TQ>(pa, LDP, tk, pb, ld, tq, D4, "
          "acc);")
TILE = "launch_dkv<T, DkvTile<128, 64, 32, 64, 3>>("


def variants(src):
    def sub(text, *pairs):
        for old, new in pairs:
            if old not in text:
                sys.exit("dkv_variants: anchor not found in the source:\n"
                         + old)
            text = text.replace(old, new)
        return text
    once = "    if (qb == qb0) {\n" + LOADS + "\n    }"
    return {
        "committed": src,
        "ablation: Q/dO tiles loaded once": sub(src, (LOADS, once)),
        "ablation: phase 1 alone": sub(src, (PHASE2, "")),
        "ablation: phase 2 alone": sub(src, (PHASE1[0], PHASE1_STANDIN),
                                       (PHASE1[1], "")),
        "tiling: 64-query tiles, 2 blocks an SM": sub(
            src, (TILE, "launch_dkv<T, DkvTile<128, 64, 64, 64, 2>>(")),
        "tiling: 32-query tiles, 2 blocks an SM": sub(
            src, (TILE, "launch_dkv<T, DkvTile<128, 64, 32, 64, 2>>(")),
    }


def ptxas_d64(log):
    """registers and spill stores of the float32 D <= 64 instantiation"""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "flash_bwd_dkv_kernelIfNS_7DkvTileILi128ELi64E" in line
        elif keep and ("registers" in line or "spill stores" in line):
            out.append(line.split(":", 1)[-1].strip())
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


def main():
    if not torch.cuda.is_available():
        sys.exit("dkv_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        texts = variants(f.read())
    builds = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(OUT, "v%d.cu" % i)
        with open(cu, "w") as f:
            f.write(text)
        builds[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + ["-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, t, d = SHAPE
    qkv = torch.randn(b, t, 3, h, d, device=dev, generator=gen)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    do = torch.randn(b, t, h, d, device=dev, generator=gen)
    do = do.permute(0, 2, 1, 3)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    run = fa._BwdLaunch(q, k, v, o, lse, do, True, None)
    stream = torch.cuda.current_stream(dev).cuda_stream

    launch = {}
    for name, (so, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit("dkv_variants: nvcc failed on %s:\n%s" % (name, log))
        fn = ctypes.CDLL(so).flash_bwd_dkv_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 12 \
            + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launch[name] = (fn, ptxas_d64(log))

    def call(fn):
        err = fn(*run._ins, run.dk.data_ptr(), run.dv.data_ptr(),
                 *run._tail, int(run.vec), stream)
        if err:
            sys.exit("dkv_variants: launch failed (%d)" % err)

    call(launch["committed"][0])
    torch.cuda.synchronize()
    want = (run.dk.clone(), run.dv.clone())
    for rnd in range(2):
        for name, (fn, ptx) in launch.items():
            ms = time_ms(lambda: call(fn))
            diff = ""
            if name == "committed" or name.startswith("tiling"):
                diff = " max_abs_diff=%r" % max(
                    (run.dk - want[0]).abs().max().item(),
                    (run.dv - want[1]).abs().max().item())
            print("dkv_variants round=%d shape=%s causal float32 ms=%r%s "
                  "ptxas=[%s] variant=%s" % (rnd, SHAPE, ms, diff, ptx, name),
                  flush=True)


if __name__ == "__main__":
    main()
