#!/usr/bin/env python3
"""The NMS kernels against the kernel they replaced, timed on one card.

    python3 mxnet_tpu_torch/bench/nms_variants.py [--against OTHER.cu]

Builds ``csrc/multibox_nms.cu`` (the suppression mask, then the scan) and
the one-kernel greedy NMS that it replaced (one block an image, the state
in the id column, one ``__syncthreads`` a kept row: its text is kept below
as ``BARRIER_KERNEL``, or read from ``--against``, a source with the same
``multibox_nms_launch``), one nvcc each, started together, both with
``--fmad=false``, and prints ptxas's registers and spill stores of every
kernel.  Then the scan's walk alone (``WALK_KERNEL``, one warp, clock64
around 4,096 chunks of 64 rows): the cycles a row of the chain of
dependent steps (each row's word in a register: a bit test and a
conditional OR), which is the step cost of the NMS kernels' bound in
chip_smoke.py, and of the walk as the scan runs it (a chunk's words read
from shared memory and shuffled to every lane row by row), with the SM
clock that the cycles and the event-timed ms give; the walk's SASS is
written beside the builds (``build/nms_variants/walk.sass``).  Then at two
shapes, the SSD batch of chip_smoke.py's ``ssd`` phase (B=8, A=1,344:
MultiBoxDetection's rows from that phase's seeded head outputs, threshold
0.5) and chip_smoke.py's NMS_LARGE (SSD300's 8,732 anchors, 4 images of
random boxes): both kernels' ids against ``greedy_nms_ref`` on the card,
and their device ms (raw launches, event-timed behind a spin of the card
by ``chip_smoke.nms_kernel_ms``, the ids restored before each round and
the copy not counted; the new pair between one pair of events, and each
kernel apart) in turns (old, new, new, old), two rounds.  Then, at both
shapes, the committed source's text substitutions below (each anchor must
be found, or the script stops): other choices, which compute the same ids
and are held to the plain loop's (the scan's block capped at 64 to 256
threads among them), and ablations, which compute something else and say
where the time goes.  Prints the card's name and power limit first.
"""
import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.bench import host_emu  # noqa: E402
from mxnet_tpu_torch.models import ssd  # noqa: E402
from mxnet_tpu_torch.ops import contrib  # noqa: E402
from mxnet_tpu_torch.ops.kernel_build import (NVCC_FLAGS, _nvcc,  # noqa: E402
                                              c_argtypes)
from mxnet_tpu_torch.ops.registry import get_op  # noqa: E402

SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "multibox_nms.cu")
OUT = os.path.join(ROOT, "build", "nms_variants")
FLAGS = ["--fmad=false"]

# The kernel that csrc/multibox_nms.cu replaced, as it was committed.
BARRIER_KERNEL = r"""#include <cuda_runtime.h>
namespace {
constexpr int NMS_THREADS = 256;
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }
template <typename T>
__device__ __forceinline__ T iou(T a0, T a1, T a2, T a3, const T* b) {
  const T ix = tmax(T(0), tmin(a2, b[2]) - tmax(a0, b[0]));
  const T iy = tmax(T(0), tmin(a3, b[3]) - tmax(a1, b[1]));
  const T inter = ix * iy;
  const T area_a = (a2 - a0) * (a3 - a1);
  const T area_b = (b[2] - b[0]) * (b[3] - b[1]);
  const T uni = area_a + area_b - inter;
  return uni > T(0) ? inter / uni : T(0);
}
template <typename T>
__global__ void __launch_bounds__(NMS_THREADS)
multibox_nms_kernel(const T* __restrict__ boxes, T* ids, int n, T thresh,
                    int force_suppress) {
  const T* bx = boxes + (size_t)blockIdx.x * n * 4;
  T* id = ids + (size_t)blockIdx.x * n;
  for (int i = 0; i < n; ++i) {
    const T idi = id[i];
    if (idi < T(0)) continue;
    const T a0 = bx[4 * i], a1 = bx[4 * i + 1], a2 = bx[4 * i + 2],
            a3 = bx[4 * i + 3];
    for (int j = i + 1 + (int)threadIdx.x; j < n; j += NMS_THREADS) {
      const T idj = id[j];
      if (idj < T(0) || (!force_suppress && idj != idi)) continue;
      if (iou(a0, a1, a2, a3, bx + 4 * (size_t)j) >= thresh) id[j] = T(-1);
    }
    __syncthreads();
  }
}
template <typename T>
int launch(const void* boxes, void* ids, int b, int n, double thresh,
           int force_suppress, cudaStream_t s) {
  multibox_nms_kernel<T><<<b, NMS_THREADS, 0, s>>>(
      static_cast<const T*>(boxes), static_cast<T*>(ids), n, (T)thresh,
      force_suppress);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int multibox_nms_launch(const void* boxes, void* ids, int b,
                                   int n, double thresh, int force_suppress,
                                   int f64, void* stream) {
  if (b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(boxes, ids, b, n, thresh, force_suppress, s)
             : launch<float>(boxes, ids, b, n, thresh, force_suppress, s);
}
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


# The scan's walk alone, one warp over `chunks` chunks of 64 rows, each
# row one step of the chain (row r is kept iff bit r of cur is clear, and a
# kept row ORs its word into cur), cur complemented between chunks so that
# rows are kept and suppressed alike.  MODE 0: the 64 rows' words in
# registers, so that only the chain's dependent steps remain; MODE 1: the
# scan's warp 0 as built, a chunk's words read from shared memory, two a
# lane, and shuffled to every lane row by row.  out: the cycles between
# two clock64 reads around the chunks, the last bits, the kept rows.
WALK_KERNEL = r"""#include <cuda_runtime.h>
typedef unsigned long long u64;
template <int MODE>
__global__ void nms_walk(const u64* __restrict__ words, int chunks,
                         long long* out) {
  __shared__ u64 s_w[4][64];
  const int lane = threadIdx.x;
  for (int k = 0; k < 4; ++k) {
    s_w[k][lane] = words[64 * k + lane];
    s_w[k][32 + lane] = words[64 * k + 32 + lane];
  }
  __syncwarp();
  u64 d[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) d[r] = MODE == 0 ? s_w[0][r] : 0;
  u64 cur = 0, kept = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    if (MODE == 0) {
#pragma unroll
      for (int r = 0; r < 64; ++r)
        if (!((cur >> r) & 1)) cur |= d[r];
    } else {
      const u64 dl = s_w[c & 3][lane], dh = s_w[c & 3][32 + lane];
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const u64 w = __shfl_sync(0xffffffffu, r < 32 ? dl : dh, r & 31);
        if (!((cur >> r) & 1)) cur |= w;
      }
    }
    kept += __popcll(~cur);
    cur = ~cur;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = (long long)cur;
    out[2] = (long long)kept;
  }
}
extern "C" int nms_walk_launch(const void* words, int chunks, int mode,
                               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode)
    nms_walk<1><<<1, 32, 0, s>>>(static_cast<const u64*>(words), chunks,
                                 static_cast<long long*>(out));
  else
    nms_walk<0><<<1, 32, 0, s>>>(static_cast<const u64*>(words), chunks,
                                 static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
"""
WALK_CHUNKS = 4096
# the walk's words: random bits at this density, about what a row of the
# SSD batch's mask holds
WALK_DENSITY = 1.0 / 16

WALK = "        if (!((cur >> r) & 1)) cur |= w;"
FOLD = "        fold(s_keep[(c - 1) & 1], c - 1, c + 1);"
STAGE = "      stage_chunk(c + 1);"
IOU = ("      if (iou(a0, a1, a2, a3, area_a, sbox + 4 * c, sarea[c]) >= "
       "thresh)")
GUARD = "  return uni > T(0) && inter > T(0) ? inter / uni : T(0);"
PARTS = "constexpr int NMS_PARTS = 16; "
SCAN_THREADS = "constexpr int NMS_SCAN_THREADS = 512; "


def variants(src):
    """{name: source text}: choices (exact) and ablations (names starting
    with "ablation")"""
    def sub(*pairs):
        text = src
        for old, new in pairs:
            if old not in text:
                sys.exit("nms_variants: anchor not found in the source:\n"
                         + old)
            text = text.replace(old, new)
        return text
    caps = {"scan: a block of at most %d threads" % t: sub((
        SCAN_THREADS, "constexpr int NMS_SCAN_THREADS = %d; " % t))
        for t in (64, 128, 256)}
    return dict(caps, **{
        "scan: 8 threads a word": sub((PARTS,
                                       "constexpr int NMS_PARTS = 8; ")),
        "scan: 32 threads a word": sub((PARTS,
                                        "constexpr int NMS_PARTS = 32; ")),
        "mask: the division also where inter is +0": sub((
            GUARD, "  return uni > T(0) ? inter / uni : T(0);")),
        "ablation: mask without IoUs": sub((IOU, "      if (true)")),
        "ablation: walk without its chain": sub((WALK, "        (void)w;")),
        "ablation: no fold": sub((FOLD, "        ;")),
        "ablation: no fold, no chain, no staging": sub(
            (WALK, "        (void)w;"), (FOLD, "        ;"),
            (STAGE, "      ;")),
    })


def build(texts):
    """{name: (ctypes library, ptxas lines)}, one nvcc each, started
    together; each ``extern "C"`` int launcher bound from its own text"""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(OUT, "v%d.cu" % i)
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + FLAGS + ["-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit("nms_variants: nvcc failed on %s:\n%s" % (name, log))
        lib = ctypes.CDLL(so)
        for fn in re.findall(r'extern "C" int (\w+)\(', texts[name]):
            getattr(lib, fn).argtypes = c_argtypes(texts[name], fn)
            getattr(lib, fn).restype = ctypes.c_int
        out[name] = (lib, [line.strip() for line in log.splitlines()
                           if "Compiling entry" in line
                           or "registers" in line or "spill" in line])
    return out


def walk_cycles(lib, dev):
    """{mode: (cycles a row, SM GHz, kept rows)} of WALK_KERNEL: mode
    "step" the chain alone, "walk" the scan's warp 0; the GHz are the
    cycles over the event-timed ms of the same launch"""
    gen = torch.Generator().manual_seed(cs.SEED)
    bits = torch.rand(4 * 64, 64, generator=gen) < WALK_DENSITY
    words = (bits.long() << torch.arange(64)).sum(1).to(dev)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for mode, name in enumerate(("step", "walk")):
        def run():
            if lib.nms_walk_launch(words.data_ptr(), WALK_CHUNKS, mode,
                                   out.data_ptr(), stream):
                sys.exit("nms_variants: the walk's launch failed")
        run()
        ms = cs.time_ms(torch, run, iters=5)
        cycles, _, kept = out.tolist()
        rows = 64 * WALK_CHUNKS
        res[name] = (cycles / rows, cycles / ms / 1e6, kept / rows)
    return res


def write_sass(so, path):
    """cuobjdump's SASS of the library ``so`` into ``path``; False when
    cuobjdump is not found"""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return False
    with open(path, "w") as f:
        subprocess.run([tool, "-sass", so], stdout=f, check=True)
    return True


def ssd_rows(dev):
    """(boxes, ids) that MultiBoxDetection hands its NMS in chip_smoke.py's
    ssd phase, on ``dev``"""
    _, cls_prob, loc_pred = cs.ssd_head_outputs()
    anchors = cs.ssd_anchors(torch, get_op, ssd, dev)
    cid, _, boxes = contrib.detection_rows(
        torch.from_numpy(cls_prob).to(dev), torch.from_numpy(loc_pred)
        .to(dev), anchors)
    return boxes.contiguous(), cid.contiguous()


def old_ms(lib, boxes, ids, thr):
    """(device ms, ids) of the replaced kernel on ``boxes`` and ``ids``"""
    out = ids.clone()
    b, n = ids.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.multibox_nms_launch(boxes.data_ptr(), out.data_ptr(), b, n,
                                      thr, 0, 0, stream)
        if err:
            sys.exit("nms_variants: the replaced kernel's launch failed "
                     "(%d)" % err)
    ms = cs.queued_ms(torch, [lambda: out.copy_(ids), run],
                      cs.NMS_TIMING_ROUNDS)[1]
    return ms, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another greedy-NMS source with "
                    "multibox_nms_launch (default: BARRIER_KERNEL)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("nms_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    old = BARRIER_KERNEL
    if args.against:
        with open(args.against) as f:
            old = f.read()
    with open(SOURCE) as f:
        src = f.read()
    found = variants(src)
    texts = dict({"new": src, "old": old, "walk": WALK_KERNEL}, **found)
    libs = build(texts)
    for name, (_, lines) in libs.items():
        for line in lines:
            print("nms_variants ptxas %s %s" % (name, line))

    dev = mt.gpu(0).torch_device()
    sass = os.path.join(OUT, "walk.sass")
    if write_sass(os.path.join(OUT, "v%d.so" % list(texts).index("walk")),
                  sass):
        print("nms_variants walk SASS in %s" % sass)
    for rnd in range(2):
        for mode, (cyc, ghz, kept) in walk_cycles(libs["walk"][0],
                                                  dev).items():
            print("nms_variants walk round=%d mode=%s cycles_per_row=%r "
                  "sm_ghz=%r kept_share=%r rows=%d"
                  % (rnd, mode, cyc, ghz, kept, 64 * WALK_CHUNKS),
                  flush=True)
    b, n, classes, thr = cs.NMS_LARGE
    large = host_emu.nms_inputs((b, n, classes, "random", thr, False,
                                 torch.float32),
                                torch.Generator().manual_seed(cs.SEED))
    cases = [("ssd", ssd_rows(dev), 0.5),
             ("large", tuple(t.to(dev) for t in large), thr)]
    for name, (boxes, ids), thr in cases:
        want = contrib.greedy_nms_ref(boxes, ids, thr)
        kept = (want >= 0).sum(1)
        for rnd in range(2):
            got = {}
            for turn in ("old", "new", "new", "old"):
                lib = libs[turn][0]
                if turn == "old":
                    ms, out = old_ms(lib, boxes, ids, thr)
                else:
                    mask_ms, scan_ms, ms = cs.nms_kernel_ms(
                        torch, contrib, boxes, ids, thr, lib=lib)
                    out = ids.clone()
                    contrib.nms_launch(lib, boxes, out, thr, stream=torch.cuda
                                       .current_stream().cuda_stream)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    sys.exit("nms_variants: the %s kernel's ids differ from "
                             "greedy_nms_ref's (%s)" % (turn, name))
                got.setdefault(turn, []).append(ms)
            print("nms_variants case=%s B=%d A=%d kept=%d (fullest image %d) "
                  "round=%d ids_equal=True old_ms=%r new_ms=%r (apart, last "
                  "turn: mask %r, scan %r) old/new=%r"
                  % (name, ids.shape[0], ids.shape[1], int(kept.sum()),
                     int(kept.max()), rnd, got["old"], got["new"], mask_ms,
                     scan_ms, sum(got["old"]) / sum(got["new"])), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (boxes, ids), thr in cases:
        want = contrib.greedy_nms_ref(boxes, ids, thr)
        for rnd in range(2):
            for var in ["new"] + list(found):
                lib = libs[var][0]
                mask_ms, scan_ms, ms = cs.nms_kernel_ms(
                    torch, contrib, boxes, ids, thr, lib=lib)
                out = ids.clone()
                contrib.nms_launch(lib, boxes, out, thr, stream=stream)
                torch.cuda.synchronize()
                same = torch.equal(out, want)
                if not same and not var.startswith("ablation"):
                    sys.exit("nms_variants: %s: ids differ (%s)"
                             % (var, name))
                print("nms_variants case=%s round=%d ms=%r mask_ms=%r "
                      "scan_ms=%r ids_equal=%s variant=%s"
                      % (name, rnd, ms, mask_ms, scan_ms, same,
                         "committed" if var == "new" else var), flush=True)


if __name__ == "__main__":
    main()
