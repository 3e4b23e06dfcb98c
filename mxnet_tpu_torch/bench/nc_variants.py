#!/usr/bin/env python3
"""Variants of the NormConv kernel, timed on one card.

    python3 mxnet_tpu_torch/bench/nc_variants.py [--sweep] [--against OTHER.cu]

Builds ``csrc/norm_conv.cu`` as it is, with the next step's loads issued
before the FMAs instead of after them (prefetch), and with
its 64 x 64 tile (tile 0) replaced by 128 x 64 and 128 x 128 tiles of 256
threads, one nvcc each, started together, and prints ptxas's
registers and spill stores of every instantiation.  Then, at the 22
NormConv geometries of ResNet-50 at batch 8 (chip_smoke.py's), with the
prologue on and the statistics off:

- default: the committed kernel and the prefetch variant with the
  committed plan's S, float32, in turns (committed, variant, variant,
  committed), each held to the plain version (relative max |d|);
- ``--sweep``: both committed tiles (64 x 128 where Cout > 64) and the
  two others (128 x 128 where Cout > 64) at every split-K count S in
  SPLITS that leaves each slice at least 4 steps, float32, each timed and
  held to the plain version;
- ``--against``: another source of the kernel (the parent commit's, say),
  its launcher bound from its own text, timed beside the committed one at
  every geometry in float32 and bfloat16, in the order against, committed,
  committed, against, with each pair's ratio and whether both agree with
  the plain version within chip_smoke.py's Y_TOL.

Times are ms a launch (CUDA events over 20 launches of the C launcher,
without the Python wrapper), two rounds.  Prints the card's name and power
limit first.
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

import mxnet_tpu_torch as mt  # noqa: E402
from chip_smoke import BATCH, Y_TOL, resnet50_geometries  # noqa: E402
from mxnet_tpu_torch.ops import norm_conv as nc  # noqa: E402
from mxnet_tpu_torch.ops.kernel_build import (NVCC_FLAGS, _nvcc,  # noqa: E402
                                              c_argtypes)

SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "norm_conv.cu")
OUT = os.path.join(ROOT, "build", "nc_variants")
LOOP = """    compute(cur);
    if (more) load(s + 1);"""
PREFETCH = """    if (more) load(s + 1);
    compute(cur);"""
TILE = "using NcTile = Tile<64, 64, 4, 4>;"
TILES = {"tile 128x64": "using NcTile = Tile<128, 64, 4, 2>;",
         "tile 128x128": "using NcTile = Tile<128, 128, 8, 2>;"}
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def build(texts):
    """{name: (library, ptxas summary)}, one nvcc each, started together;
    every launcher bound from its own source text"""
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
            sys.exit("nc_variants: nvcc failed on %s:\n%s" % (name, log))
        lib = ctypes.CDLL(so)
        for fn in re.findall(r'extern "C" int (\w+)\(', texts[name]):
            getattr(lib, fn).argtypes = c_argtypes(texts[name], fn)
            getattr(lib, fn).restype = ctypes.c_int
        out[name] = (lib, ptxas(log))
    return out


def ptxas(log):
    """registers and spill stores of each nc_kernel instantiation"""
    name, out = None, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"nc_kernelI(f|\w*?bfloat16)\w*?TileILi(\d+)ELi"
                          r"(\d+)E", line)
            name = None if m is None else "%s,%sx%s" % (
                "f32" if m.group(1) == "f" else "bf16", m.group(2),
                m.group(3))
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


class Case(object):
    """One geometry's inputs on the card, its output buffer and its plain
    version's y"""

    def __init__(self, key, dtype, gen):
        h, w, cin, cout, k, s, p = key
        dev = torch.device("cuda", 0)
        self.key, self.dtype, self.k, self.s, self.p = key, dtype, k, s, p
        self.x = torch.randn(BATCH, h, w, cin, device=dev,
                             generator=gen).to(dtype)
        self.w = (torch.randn(k, k, cin, cout, device=dev, generator=gen)
                  * (2.0 / (k * k * cin)) ** 0.5).to(dtype)
        self.sc = (torch.rand(cin, device=dev, generator=gen) + 0.5).to(dtype)
        self.sh = (torch.randn(cin, device=dev, generator=gen)
                   * 0.5).to(dtype)
        oh, ow = nc._geom(h, w, k, s, p)
        self.y = torch.empty(BATCH, oh, ow, cout, dtype=dtype, device=dev)
        self.want = nc.norm_conv_ref(self.x, self.w, self.sc, self.sh, k, s,
                                     p)[0]

    def plan(self, lib, tile=-1, splits=0):
        """(tile, BM, BN, S, tiles) of ``lib`` for this case (``tile`` >= 0
        and ``splits`` >= 1 force them)"""
        out = (ctypes.c_int * 5)()
        h, w, cin, cout, k, s, p = self.key
        oh, ow = nc._geom(h, w, k, s, p)
        check(lib.nc_plan(BATCH, oh, ow, cin, cout, k, tile, splits, out))
        return tuple(out)

    def launcher(self, lib, plan=None):
        """a function that launches ``lib``'s kernel once on this case"""
        stream = torch.cuda.current_stream().cuda_stream
        h, w, cin, cout, k, s, p = self.key
        oh, ow = nc._geom(h, w, k, s, p)
        bf16 = int(self.dtype == torch.bfloat16)
        ptrs = (self.x.data_ptr(), self.w.data_ptr(), self.sc.data_ptr(),
                self.sh.data_ptr(), self.y.data_ptr(), None, None)
        geo = (BATCH, h, w, cin, cout, k, s, p, oh, ow, 1, 1, 0, bf16)
        if len(lib.nc_launch.argtypes) == 22:     # an older launcher
            return lambda: check(lib.nc_launch(*ptrs, *geo, stream))
        plan = plan or self.plan(lib)
        ws, cnt = nc.scratch(plan, self.x.device, stream)
        tail = (*nc.vec_flags(self.x, self.w, self.sc, self.sh), plan[0],
                plan[3], stream)
        extra = (None if ws is None else ws.data_ptr(),
                 None if cnt is None else cnt.data_ptr())

        def run():   # holds ws, so the workspace lives as long as run
            check(lib.nc_launch(*ptrs, *extra, *geo, *tail))
            return ws
        return run

    def rel_err(self):
        torch.cuda.synchronize()
        return ((self.y.float() - self.want.float()).abs().max()
                / self.want.float().abs().max()).item()


def check(err):
    if err:
        sys.exit("nc_variants: launch failed (%d)" % err)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time every tile and split-K count")
    ap.add_argument("--against", help="another norm_conv.cu timed beside "
                    "the committed one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("nc_variants: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    with open(SOURCE) as f:
        src = f.read()
    for anchor in (LOOP, TILE):
        if anchor not in src:
            sys.exit("nc_variants: anchor not found in the source:\n"
                     + anchor)
    texts = {"committed": src, "prefetch": src.replace(LOOP, PREFETCH)}
    texts.update((name, src.replace(TILE, line))
                 for name, line in TILES.items())
    if args.against:
        with open(args.against) as f:
            texts["against"] = f.read()
    libs = build(texts)
    for name, (_, ptx) in libs.items():
        print("nc_variants ptxas variant=%s %s" % (name, ptx), flush=True)
    mine = libs["committed"][0]

    geoms = sorted(resnet50_geometries(mt, BATCH).items())
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {key: Case(key, torch.float32, gen) for key, _ in geoms}
    for rnd in range(2):
        for key, count in geoms:
            case = cases[key]
            plan = case.plan(mine)
            got = {}
            for name in ("committed", "prefetch", "prefetch", "committed"):
                got.setdefault(name, []).append(time_ms(case.launcher(
                    libs[name][0], plan)))
                got.setdefault(name + " err", []).append(case.rel_err())
            print("nc_variants round=%d geom=%s count=%d float32 tile=%dx%d "
                  "splits=%d committed_ms=%r prefetch_ms=%r "
                  "rel_err=%r" % (rnd, key, count, plan[1], plan[2], plan[3],
                                  got["committed"], got["prefetch"],
                                  max(got["committed err"]
                                      + got["prefetch err"])),
                  flush=True)

    if args.sweep:
        for rnd in range(2):
            for key, count in geoms:
                case = cases[key]
                h, w, cin, cout, k, s, p = key
                steps = k * k * -(-cin // 16)
                runs = [("committed", 0)] + [(name, 0) for name in TILES]
                if cout > 64:
                    runs.insert(1, ("committed", 1))
                for name, tile in runs:
                    if name == "tile 128x128" and cout <= 64:
                        continue
                    lib = libs[name][0]
                    for sp in SPLITS:
                        if sp > 1 and steps < 4 * sp:
                            continue
                        plan = case.plan(lib, tile, sp)
                        ms = time_ms(case.launcher(lib, plan))
                        print("nc_variants sweep round=%d geom=%s count=%d "
                              "tile=%dx%d splits=%d ms=%r rel_err=%r"
                              % (rnd, key, count, plan[1], plan[2], sp, ms,
                                 case.rel_err()), flush=True)

    if not args.against:
        return
    other = libs["against"][0]
    for key, count in geoms:
        for dt in (torch.float32, torch.bfloat16):
            case = Case(key, dt, gen)
            got, errs = {}, {}
            for name in ("against", "committed", "committed", "against"):
                lib = other if name == "against" else mine
                got.setdefault(name, []).append(time_ms(case.launcher(lib)))
                errs[name] = case.rel_err()
            ratio = sum(got["committed"]) / sum(got["against"])
            tol = Y_TOL[str(dt).split(".")[1]]
            print("nc_variants against geom=%s count=%d dtype=%s "
                  "committed_ms=%r against_ms=%r ratio=%.4f "
                  "committed_within_tol=%s against_within_tol=%s"
                  % (key, count, str(dt).split(".")[1], got["committed"],
                     got["against"], ratio, errs["committed"] <= tol,
                     errs["against"] <= tol), flush=True)


if __name__ == "__main__":
    main()
