#!/usr/bin/env python3
"""Variants of the flash-attention dQ kernel, timed on one card.

    python3 mxnet_tpu_torch/bench/dq_variants.py [--against OTHER.cu]

Builds ``csrc/flash_attention_bwd.cu`` as it is and with the text
substitutions below (each anchor must be found, or the script stops), one
nvcc each, started together, and times ``flash_bwd_dq_launch`` of each
library on the same float32 inputs: the LM's shape, (4, 12, 1024, 64),
causal, with q, k, v strided as the LM makes them, and shapes of each D
bucket from chip_smoke.py's FLASH_CHECKS.  Three kinds of variant:

- ablations at the LM's shape, which compute something else and say where
  the time goes: the K/V tiles loaded once instead of per tile, phase 1
  (S, dP -> dS^T) alone, phase 2 (dQ += dS.K) alone;
- other tilings of each D bucket, which compute the same function and are
  held to the committed kernel's result (max |d|);
- stage B, the K/V tiles double-buffered with cp.async, in the D <= 64
  bucket, held to the committed kernel's result too.

With ``--against``, a second source of the same kernels (the parent
commit's, say) is built too, its launcher bound from its own text, and its
dQ kernel timed beside the committed one at the LM's shape and at every
FLASH_CHECKS shape, float32 and bfloat16, in the order against,
committed, committed, against.

Prints the card's name and power limit, ptxas's registers and spill stores
of each float32 dQ instantiation per library, then one line per variant,
shape and round (two rounds, in turns).
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

from chip_smoke import FLASH_CHECKS  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mxnet_tpu_torch.ops.kernel_build import (NVCC_FLAGS, _nvcc,  # noqa: E402
                                              c_argtypes)

SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                      "flash_attention_bwd.cu")
OUT = os.path.join(ROOT, "build", "dq_variants")
LM_SHAPE = (4, 12, 1024, 64)
# (shape, causal) cases: the LM's, and FLASH_CHECKS shapes of each D bucket
LM = (LM_SHAPE, True)
D64 = [LM, ((2, 2, 384, 64), True), ((2, 4, 512, 64), True)]
D128 = [((1, 16, 2048, 128), True), ((2, 4, 512, 72), True)]
D256 = [((1, 4, 512, 256), False)]

LOADS = """    load_rows<NTH>(Ks, kp, st.kt, k0, BK, D, ld, vec, tid);
    load_rows<NTH>(Vs, vp, st.vt, k0, BK, D, ld, vec, tid);"""
PHASE1 = ("    rows_dot_f4<RQ, 8, RK, TK>(Qs, ld, tq, Ks, ld, tk, D4, s);",
          "    rows_dot_f4<RQ, 8, RK, TK>(Gs, ld, tq, Vs, ld, tk, D4, dp);")
PHASE1_STANDIN = """#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = Qs[tq + i] * Ks[tk + j];
        dp[i][j] = Gs[tq + i] * Vs[tk + j];
      }"""
PHASE2 = ("    cols_outer_f4<1, BK, MQ, 8, NB, TK>(pa, LDS, tq, pb, ld, tk, "
          "D4, acc);")
TILE64 = "launch_dq<T, DqTile<128, 64, 32, 64, 3>>("
SMALL_GRID = "if (B * H * (T_ / 64) < sms)"
TILE128 = "launch_dq<T, DqTile<256, 64, 64, 128, 1>>("
TILE256 = "launch_dq<T, DqTile<256, 32, 64, 256, 1>>("

# Stage B: the K/V tiles double-buffered.  Float32 rows aligned to 16 bytes
# are copied with cp.async (16 bytes a thread, one commit group a tile,
# waited for one tile later); bfloat16 and unaligned rows go through
# registers as before.  The second K/V buffer sits after delta.
STAGE_B_HELPERS = """__device__ __forceinline__ void cp_async16(float* dst,
                                           const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s),
               "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait1() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\\n" ::);
#endif
}

template <int NTH>
__device__ __forceinline__ void fetch_rows(float* dst, const float* src,
                                           long long st, int row0, int rows,
                                           int D, int ld, int vec, int tid) {
  if (vec) {
    const int D4 = D >> 2;
    for (int i = tid; i < rows * D4; i += NTH) {
      const int r = i / D4, c = i - r * D4;
      cp_async16(dst + r * ld + 4 * c, src + (row0 + r) * st + 4 * c);
    }
  } else {
    load_rows<NTH>(dst, src, st, row0, rows, D, ld, vec, tid);
  }
}

template <int NTH>
__device__ __forceinline__ void fetch_rows(float* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int row0, int rows,
                                           int D, int ld, int vec, int tid) {
  load_rows<NTH>(dst, src, st, row0, rows, D, ld, vec, tid);
}

"""
LOOP_HEAD = """  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();   // the previous step is done with Ks, Vs and Ds
""" + LOADS + """
    __syncthreads();"""
STAGE_B_LOOP_HEAD = """  float* const k_buf0 = Ks;
  float* const v_buf0 = Vs;
  float* const k_buf1 = Es + BQ;
  float* const v_buf1 = k_buf1 + BK * ld;
  fetch_rows<NTH>(k_buf0, kp, st.kt, 0, BK, D, ld, vec, tid);
  fetch_rows<NTH>(v_buf0, vp, st.vt, 0, BK, D, ld, vec, tid);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    float* const Ks = (kb & 1) ? k_buf1 : k_buf0;
    float* const Vs = (kb & 1) ? v_buf1 : v_buf0;
    __syncthreads();   // the previous step is done with the next buffers
    if (kb + 1 < nkb) {
      fetch_rows<NTH>((kb & 1) ? k_buf0 : k_buf1, kp, st.kt, k0 + BK, BK, D,
                      ld, vec, tid);
      fetch_rows<NTH>((kb & 1) ? v_buf0 : v_buf1, vp, st.vt, k0 + BK, BK, D,
                      ld, vec, tid);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();"""
SMEM = "  const size_t smem = dq_smem_bytes(D, Tile::BQ, Tile::BK);"
STAGE_B_SMEM = ("  const size_t smem = dq_smem_bytes(D, Tile::BQ, Tile::BK) "
                "+\n      sizeof(float) * 2 * Tile::BK * (D + 4);")
TILING = "// The dQ kernel's tiling:"


def variants(src):
    """{name: (source text, [(shape, causal), ...])}"""
    def sub(*pairs):
        text = src
        for old, new in pairs:
            if old not in text:
                sys.exit("dq_variants: anchor not found in the source:\n"
                         + old)
            text = text.replace(old, new)
        return text

    def tile(old, new):
        return (old, "launch_dq<T, DqTile<%s>>(" % new)
    once = "    if (kb == 0) {\n" + LOADS + "\n    }"
    stage_b = ((TILING, STAGE_B_HELPERS + TILING),
               (LOOP_HEAD, STAGE_B_LOOP_HEAD), (SMEM, STAGE_B_SMEM))
    return {
        "committed": (src, D64 + D128 + D256),
        "ablation: K/V tiles loaded once": (sub((LOADS, once)), [LM]),
        "ablation: phase 1 alone": (sub((PHASE2, "")), [LM]),
        "ablation: phase 2 alone": (sub((PHASE1[0], PHASE1_STANDIN),
                                        (PHASE1[1], "")), [LM]),
        "tiling D<=64: BK 64, 2 blocks an SM": (sub(
            tile(TILE64, "128, 64, 64, 64, 2")), D64),
        "tiling D<=64: 64-query tiles at every grid size": (sub(
            (SMALL_GRID, "if (false)")), D64),
        "tiling D<=64: 32-query tiles at every grid size": (sub(
            (SMALL_GRID, "if (true)")), D64),
        "stage B: K/V double-buffered, BK 32, 2 blocks an SM": (sub(
            tile(TILE64, "128, 64, 32, 64, 2"), *stage_b), D64),
        "stage B: K/V double-buffered, BK 64, 1 block an SM": (sub(
            tile(TILE64, "128, 64, 64, 64, 1"), *stage_b), D64),
        "tiling D<=128: 128 threads, BK 32, 2 blocks an SM": (sub(
            tile(TILE128, "128, 64, 32, 128, 2")), D128),
        "tiling D<=128: 128 threads, BK 64, 1 block an SM": (sub(
            tile(TILE128, "128, 64, 64, 128, 1")), D128),
        "tiling D<=128: 128 threads, BQ 32, 3 blocks an SM": (sub(
            tile(TILE128, "128, 32, 32, 128, 3")), D128),
        "tiling D<=128: 128 threads, BQ 32, BK 64, 2 blocks an SM": (sub(
            tile(TILE128, "128, 32, 64, 128, 2")), D128),
        "tiling D<=256: BK 32": (sub(
            tile(TILE256, "256, 32, 32, 256, 1")), D256),
        "tiling D<=256: 128 threads, BK 32": (sub(
            tile(TILE256, "128, 32, 32, 256, 1")), D256),
    }


def ptxas_dq(log):
    """registers and spill stores of each float32 dQ instantiation"""
    name, out = None, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_bwd_dq_kernelIf(\w*?)EEvPK", line)
            name = None if m is None else ",".join(
                re.findall(r"Li(\d+)E", m.group(1) + "E"))
        elif name and ("registers" in line or "spill stores" in line):
            out.append("<%s> %s" % (name, line.split(":", 1)[-1].strip()))
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


def inputs(shape, causal, dtype, lm_strided, gen, scale=None):
    dev = torch.device("cuda", 0)
    b, h, t, d = shape
    if lm_strided:
        qkv = torch.randn(b, t, 3, h, d, device=dev, generator=gen)
        qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        do = torch.randn(b, t, h, d, device=dev, generator=gen)
        do = do.to(dtype).permute(0, 2, 1, 3)
    else:
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                       for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return fa._BwdLaunch(q, k, v, o, lse, do, causal, scale)


def build(texts):
    """{name: (dq launch function, ptxas summary)}, one nvcc each, started
    together; each launcher bound from its own source text"""
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
            sys.exit("dq_variants: nvcc failed on %s:\n%s" % (name, log))
        fn = ctypes.CDLL(so).flash_bwd_dq_launch
        fn.argtypes = c_argtypes(texts[name], "flash_bwd_dq_launch")
        fn.restype = ctypes.c_int
        out[name] = (fn, ptxas_dq(log))
    return out


def call(fn, run):
    # a launcher without the alignment flag (an older source) takes one
    # int fewer
    flag = (int(run.vec),) if len(fn.argtypes) == 28 else ()
    err = fn(*run._ins, run.dq.data_ptr(), *run._tail, *flag,
             torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit("dq_variants: launch failed (%d)" % err)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another flash_attention_bwd.cu whose "
                    "dQ kernel is timed beside the committed one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dq_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    with open(SOURCE) as f:
        found = variants(f.read())
    texts = {name: text for name, (text, _) in found.items()}
    if args.against:
        with open(args.against) as f:
            texts["against"] = f.read()
    libs = build(texts)
    for name, (_, ptx) in libs.items():
        print("dq_variants ptxas variant=%s %s" % (name, ptx))

    gen = torch.Generator(device="cuda").manual_seed(0)
    runs, want = {}, {}
    for case in found["committed"][1]:
        runs[case] = inputs(*case, torch.float32, case == LM, gen)
        call(libs["committed"][0], runs[case])
        torch.cuda.synchronize()
        want[case] = runs[case].dq.clone()
    for rnd in range(2):
        for name, (_, cases) in found.items():
            for case in cases:
                run = runs[case]
                ms = time_ms(lambda: call(libs[name][0], run))
                diff = ""
                if not name.startswith("ablation"):
                    diff = " max_abs_diff=%r" % (run.dq - want[case]).abs() \
                        .max().item()
                print("dq_variants round=%d shape=%s %s float32 ms=%r%s "
                      "variant=%s" % (rnd, case[0], "causal" if case[1]
                                      else "full", ms, diff, name),
                      flush=True)

    if not args.against:
        return
    cases = [(LM_SHAPE, True, None, True)] + [c + (False,)
                                              for c in FLASH_CHECKS]
    for shape, causal, scale, lm_strided in cases:
        for dt in (torch.float32, torch.bfloat16):
            run = inputs(shape, causal, dt, lm_strided, gen, scale)
            got = {}
            for rnd, name in enumerate(("against", "committed", "committed",
                                        "against")):
                ms = time_ms(lambda: call(libs[name][0], run))
                got.setdefault(name, []).append(ms)
                if rnd == 1:
                    torch.cuda.synchronize()
                    mine = run.dq.clone()
                if rnd == 3:
                    torch.cuda.synchronize()
                    diff = (run.dq - mine).abs().max().item()
            print("dq_variants against shape=%s %s scale=%s dtype=%s%s "
                  "committed_ms=%r against_ms=%r max_abs_diff=%r"
                  % (shape, "causal" if causal else "full", scale,
                     str(dt).split(".")[1], " lm-strided" if lm_strided
                     else "", got["committed"], got["against"], diff),
                  flush=True)


if __name__ == "__main__":
    main()
