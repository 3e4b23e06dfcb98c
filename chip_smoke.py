#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).  Phases, each
fatal on failure:

1. build: compile the three kernel sources (csrc/norm_conv.cu,
   csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) for sm_90a, one
   nvcc each, started together;
2. kernels: at every distinct NormConv geometry of ResNet-50 at batch 8,
   224x224 (22 of them, read off the graph), hold the kernel against its
   plain PyTorch version in float32 and bfloat16, with TF32 off; check the
   statistics epilogue (float32, every geometry), the prologue off and the
   ReLU off, and y bitwise equal over two launches (split-K sums its
   slices in a fixed order); print the tile, the split-K slices and the
   16-byte load flags the kernel took; time the kernel, the plain version
   and cuDNN's conv alone;
3. serving: ResNet-50 at full width (1000 classes, 3x224x224, random
   weights from a seed) behind ``ServedModel`` with MXNET_NORM_CONV=1,
   max_batch 8, 24 requests from 4 client threads; every request answered,
   the kernel launched 52 times per forward, and every served row equal
   (within SERVE_TOL) to an unfused ``Predictor`` (cuDNN, TF32 off);
4. flash: the flash-attention forward kernel against its plain version
   (both outputs, TF32 off) at the LM's shape (4, 12, 1024, 64) made as the
   LM makes it (strided slices of one QKV projection), causal, and at the
   shapes of FLASH_CHECKS, each in float32 and bfloat16: within O_TOL and
   LSE_TOL, finite, o and lse bitwise equal over two launches; the tile
   the kernel took (``fwd_plan``) and whether it read rows in 16-byte
   pieces are printed; the kernel, the plain version and PyTorch's
   scaled_dot_product_attention (the yardstick; the port never calls it)
   are timed beside the bound;
5. lm: the transformer LM at GPT-2-small widths (12 layers, 768 hidden,
   12 heads, T=1024, vocab 50257, random weights from a seed) loaded
   through its JSON into ``Predictor`` at batch 4; 3 batches after one
   warm forward; the kernel launched 12 times per forward, and the
   probabilities equal (within LM_TOL) to a second ``Predictor`` of the
   same weights with ``attn_impl="xla"``, which launches it never; host
   time per forward and a torch.profiler breakdown of one forward;
6. flash_bwd: the flash-attention backward kernels (dQ, dK/dV) against the
   plain backward (TF32 off) at the LM's shape, causal, with q, k, v made
   as the LM makes them and dO a permuted view of a contiguous (B, T, H, D)
   tensor (the gradient of the LM's output transpose), and at the shapes of
   FLASH_CHECKS, in float32 and bfloat16: within BWD_TOL, finite, bitwise
   equal over two runs; the dQ kernel, the dK/dV kernel, the whole backward
   (delta + both), the plain backward and SDPA's backward (the yardstick)
   timed beside each kernel's bound;
7. lm_train: the LM at GPT-2-small widths trained through the port.  (a)
   One batch through ``Executor`` forward(is_train=True) + backward() on
   the kernel graph and on the attn_impl="xla" graph: every parameter's
   gradient within LM_GRAD_TOL (largest entry) and LM_GRAD_NORM_TOL
   (norm) of the xla graph's, beside the same measures between the xla
   graph in float32 and float64; 12 launches of each flash kernel on the
   kernel graph, none on the other.  (b) ``TrainStep``
   with Adam(1e-4) from those weights on one fixed batch: a warm step, 4
   steps through ``__call__`` and ``run_steps(..., 3)``; the loss (from
   the outputs, on the card) lower after the last step than after the
   first, 36 flash launches per step, host ms per step and tokens/s, and a
   torch.profiler breakdown of one step;
   graph_device: a graph of ``_ones`` plus a data variable, and one of a
   uniform sampler plus a data variable, bound to gpu(0), forward on the
   card with the right values;
8. imperative: the LM's 163,087,441 float32 parameters as NDArrays on the
   card with gradients drawn on the card (``mx.nd.normal`` from the card's
   generator); three ``Updater`` passes with Adam over every parameter, and
   three with SGD-momentum, each held within IMPERATIVE_TOL to TrainStep's
   fused rule (``_FunctionalOptimizer``) on copies of the same tensors; host
   ms per pass, device ms and launches of one profiled pass, and the fused
   rule's ms per pass;
9. rtc: four user kernels written in CUDA C (``rtc_kernels.py``) pushed
   through ``rtc.Rtc`` once each (the path whose launches are counted):
   axpb over 163,087,441 floats, exp5_shared over 10, transpose_tiled of
   the LM's (50257, 768) lm_head weight, sgd_mom in place over one buffer
   holding every LM parameter (the parameters are views of it); each held
   to its plain version (axpb and transpose bitwise, exp5 within EXP5_TOL
   relative, sgd_mom within IMPERATIVE_TOL of the largest |w|); first-push
   seconds (nvcc), ``rtc.builds`` unchanged on a second push, host us per
   push, kernel / plain / ``torch.add`` / bound ms of axpb; a source with
   a syntax error must raise MXNetError carrying nvcc's log.

Prints the card's name and power limit, per-geometry numbers, serving qps
and latency, flash timings, LM checks and profiles, flash backward timings,
LM training checks, rates and profile, Updater and Rtc numbers, a JSON line
of kernel numbers, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or the package is missing.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
BATCH = 8
IMAGE = 224
CLASSES = 1000
CLIENTS = 4
REQUESTS_PER_CLIENT = 6
# kernel vs plain version, max |y_kernel - y_plain| / max |y_plain|.
# float32: both accumulate in float32, in different orders, over up to
# 4608 products.  bfloat16: the prologue is bit-identical, the outputs are
# each rounded once to bfloat16 (2^-8 relative) from float32 sums taken in
# different orders: allow about two bfloat16 steps of the largest output.
Y_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# float32 statistics epilogue vs the plain version's sums of y, relative to
# the largest |sum| (the kernel adds per-tile partials with atomics)
STATS_TOL = 1e-4
# served softmax rows vs the unfused reference, relative to the largest
# probability: float32 throughout, so only summation order differs
SERVE_TOL = 1e-4
# flash kernel vs plain version.  o: max |o_kernel - o_plain| / max |o_plain|;
# float32 sums in another order over up to 2048 keys; bfloat16 rounds o once
# (2^-8 relative) from float32 sums: about two bfloat16 steps.  lse is
# float32 in both dtypes (the same upcast inputs): |dlse| / max(1, max|lse|).
O_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
LSE_TOL = 1e-4
# LM probabilities, flash graph vs attn_impl="xla" graph, relative to the
# largest probability: float32 throughout, the two attentions differ only in
# summation order (~1e-7 relative per layer, 12 layers)
LM_TOL = 1e-4
# flash backward kernels vs the plain backward, per output max |d_kernel -
# d_plain| / max |d_plain|.  float32: both sum float32 products in other
# orders (up to 2048 keys, then 64-256 head columns), as for the forward's
# O_TOL.  bfloat16: every input is the same bfloat16 value in both and all
# arithmetic is float32; each output is rounded once to bfloat16 (2^-8
# relative): about two bfloat16 steps of the largest output.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# LM parameter gradients, kernel graph vs attn_impl="xla" graph, both
# float32 (TF32 off).  The two attentions differ by rounding (~1e-7
# relative), which the ReLUs of the MLPs turn into O(1) changes: a
# pre-activation within rounding of zero is on one side of the kink in one
# graph and on the other in the second, and the gradient through that unit
# at that token is then kept in one and dropped in the other; every
# parameter upstream of such a flip sees it.  The same happens between the
# xla graph in float32 and in float64, which the run measures beside the
# check (the f32 floor).  So two measures per parameter: max |d| / max |g|
# within LM_GRAD_TOL and ||d|| / ||g|| within LM_GRAD_NORM_TOL.  On an
# H100 80GB HBM3 at 700 W the worst parameter measured 0.0134 and 0.00132,
# against a floor of 0.0107 and 0.00087: the tolerances sit about 4x above
# both.  A fault in a kernel or in its autograd wiring moves both by O(1).
LM_GRAD_TOL = 5e-2
LM_GRAD_NORM_TOL = 5e-3
LM = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_hidden=768,
          num_heads=12)
LM_LR = 1e-4
LM_BATCH = 4
LM_BATCHES = 3
# (B, H, T, D), causal, scale: the shapes checked besides the LM's, each in
# float32 and bfloat16
FLASH_CHECKS = [
    ((4, 12, 1024, 64), False, None),
    ((1, 16, 2048, 128), True, None),
    ((2, 4, 512, 72), True, None),
    ((1, 4, 512, 256), False, None),
    ((2, 2, 384, 64), True, None),          # three 128-blocks
    ((2, 4, 512, 64), True, 0.3),
]
# Updater vs the fused rule on the same tensors (float32), and the Rtc
# sgd_mom kernel vs the registered op: max |d| over the largest |w|.  The
# Updater keeps Adam's step scalars in float64 where the fused rule rounds
# them to float32, as the JAX package's Updater and TrainStep do: a relative
# 1e-7 of each update, orders below this bound.
IMPERATIVE_TOL = 1e-6
IMP_PASSES = 3
# exp5_shared vs torch.exp(5 x), relative: expf and torch's exp are each
# within 2 ulp of exp
EXP5_TOL = 2e-6
# H100 SXM published peaks (dense): float32 on the CUDA cores, bfloat16 on
# the tensor cores, HBM3 bandwidth
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITERS = 20


def fail(msg):
    print("FAIL: %s" % msg, file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, iters=ITERS):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def resnet50_geometries(mt, batch):
    """{(H, W, Cin, Cout, k, s, p): count} of the convolutions the NormConv
    peephole fuses in ResNet-50 at ``batch`` x 3 x IMAGE x IMAGE."""
    from mxnet_tpu_torch.executor import _Lowered
    net = mt.models.resnet.get_symbol(CLASSES, 50, "3,%d,%d" % (IMAGE, IMAGE))
    low = _Lowered(net)
    internals = net.get_internals()
    _, shapes, _ = internals.infer_shape(data=(batch, 3, IMAGE, IMAGE))
    shape_of = {(id(n), i): s for (n, i), s in zip(internals._outputs, shapes)}
    geoms = {}
    for node in low.order:
        if id(node) not in low.nc_conv:
            continue
        src, si = node.inputs[0]
        _, cin, h, w = shape_of[(id(src), si)]
        g = low._nc_conv_attrs(node)
        cout = int(node.op.normalize_attrs(node.params)["num_filter"])
        key = (h, w, cin, cout, g["k"], g["s"], g["p"])
        geoms[key] = geoms.get(key, 0) + 1
    return geoms


def conv_work(n, h, w, cin, cout, k, s, p):
    """(input elements read, multiply-adds) that the convolution needs: only
    the input pixels some tap reaches (a 1x1 stride-2 conv reads a quarter
    of x) and only in-bounds taps (a padded tap multiplies a zero)."""
    def axis(size):
        out = (size + 2 * p - k) // s + 1
        taps = [o * s - p + t for o in range(out) for t in range(k)]
        inside = [i for i in taps if 0 <= i < size]
        return len(set(inside)), len(inside)
    rows, row_taps = axis(h)
    cols, col_taps = axis(w)
    return n * rows * cols * cin, n * row_taps * col_taps * cin * cout


def kernel_phase(torch, nc, geoms):
    """Kernel vs plain version at every geometry; returns the float32
    main-path totals (each geometry weighted by its count in a forward)."""
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "ops_ms": 0.0, "bytes_ms": 0.0, "max_abs_err": 0.0}
    for gi, (key, count) in enumerate(sorted(geoms.items())):
        h, w, cin, cout, k, s, p = key
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            x = torch.randn(BATCH, h, w, cin, device=dev, generator=gen)
            wt = torch.randn(k, k, cin, cout, device=dev, generator=gen) \
                * (2.0 / (k * k * cin)) ** 0.5
            x, wt = x.to(dt), wt.to(dt)
            sc = torch.rand(cin, device=dev, generator=gen) + 0.5
            sh = torch.randn(cin, device=dev, generator=gen) * 0.5
            variants = [("main", dict(relu=True, prologue=True,
                                      stats=dt == torch.float32))]
            if gi == 0:
                variants.append(("no_prologue", dict(relu=True,
                                                     prologue=False,
                                                     stats=False)))
            if gi == 1:
                variants.append(("no_relu", dict(relu=False, prologue=True,
                                                 stats=False)))
            for vname, kw in variants:
                yk, sk, qk = nc.norm_conv(x, wt, sc, sh, k, s, p, **kw)
                yk2, _, _ = nc.norm_conv(x, wt, sc, sh, k, s, p, **kw)
                yp, spl, qp = nc.norm_conv_ref(x, wt, sc, sh, k, s, p, **kw)
                torch.cuda.synchronize()
                if not torch.equal(yk, yk2):
                    fail("kernel %s %s %s: y differs between two launches"
                         % (key, dname, vname))
                err = (yk.float() - yp.float()).abs().max().item()
                ref = yp.float().abs().max().item()
                if not torch.isfinite(yk).all() or err > Y_TOL[dname] * ref:
                    fail("kernel %s %s %s: max|dy| %.3g > %g * %.3g"
                         % (key, dname, vname, err, Y_TOL[dname], ref))
                if kw["stats"]:
                    for a, b, what in ((sk, spl, "sum"), (qk, qp, "sumsq")):
                        serr = (a - b).abs().max().item()
                        sref = b.abs().max().item()
                        if serr > STATS_TOL * sref:
                            fail("kernel %s stats %s: max err %.3g > %g * "
                                 "%.3g" % (key, what, serr, STATS_TOL, sref))
                if vname == "main":
                    main_err = err
                else:
                    print("check geom=%s dtype=%s variant=%s max_abs_err=%r "
                          "max_abs_ref=%r" % (key, dname, vname, err, ref))
            main = dict(relu=True, prologue=True, stats=False)
            kernel_ms = time_ms(torch, lambda: nc.norm_conv(
                x, wt, sc, sh, k, s, p, **main))
            plain_ms = time_ms(torch, lambda: nc.norm_conv_ref(
                x, wt, sc, sh, k, s, p, **main))
            xh = nc._apply(x, sc, sh, True).permute(0, 3, 1, 2)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            library_ms = time_ms(torch, lambda: F.conv2d(
                xh, w_oihw, stride=s, padding=p))
            oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            # bytes: x as read, w, scale, shift, y; operations: 2 per MAC
            # (the prologue's 2-3 per input element are under 1% and left out)
            x_read, macs = conv_work(BATCH, h, w, cin, cout, k, s, p)
            nbytes = (x_read + wt.numel() + 2 * cin
                      + BATCH * oh * ow * cout) * x.element_size()
            ops = 2.0 * macs
            ops_ms = ops / PEAK_OPS[dname] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            _, bm, bn, splits, _ = nc.plan(nc._kernel.get(), x.shape,
                                           wt.shape, s, p, device_index=0)
            vec_x, vec_w = nc.vec_flags(x, wt, sc.to(dt), sh.to(dt))
            print("geom H=%d W=%d Cin=%d Cout=%d k=%d s=%d p=%d count=%d "
                  "dtype=%s max_abs_err=%r kernel_ms=%r plain_ms=%r "
                  "library_ms=%r bound_ms=%r bound_by=%s tile=%dx%d "
                  "splits=%d vec16_x=%d vec16_w=%d bitwise_repeat=True"
                  % (h, w, cin, cout, k, s, p, count, dname, main_err,
                     kernel_ms, plain_ms, library_ms, bound_ms,
                     "operations" if ops_ms >= bytes_ms else "bytes",
                     bm, bn, splits, vec_x, vec_w))
            if dt == torch.float32:
                tot["ms"] += count * kernel_ms
                tot["plain_ms"] += count * plain_ms
                tot["library_ms"] += count * library_ms
                tot["bound_ms"] += count * bound_ms
                tot["ops_ms"] += count * ops_ms
                tot["bytes_ms"] += count * bytes_ms
                tot["max_abs_err"] = max(tot["max_abs_err"], main_err)
    return tot


def resnet50_params(mt, net):
    """Random ResNet-50 weights from SEED: He-scaled convolutions (the last
    1x1 of each residual branch scaled by 0.2 so the stream stays O(1)),
    BatchNorm with positive moving variances."""
    rng = np.random.default_rng(SEED)
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1, 3, IMAGE, IMAGE))
    args, aux = {}, {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            gain = 1.0 if name == "fc1_weight" else 2.0
            v = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32((gain / fan_in) ** 0.5)
            if name.endswith("_conv3_weight"):
                v *= np.float32(0.2)
        elif name.endswith("_gamma"):
            v = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif name.endswith("_beta"):
            v = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        else:
            v = np.zeros(shape, np.float32)
        args[name] = v
    for name, shape in zip(net.list_auxiliary_states(), aux_shapes):
        if name.endswith("_moving_var"):
            aux[name] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        else:
            aux[name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return mt.convert.params_from_numpy(args, aux, ctx=mt.gpu(0))


def serving_phase(torch, mt, nc, launches_per_forward):
    net = mt.models.resnet.get_symbol(CLASSES, 50,
                                      "3,%d,%d" % (IMAGE, IMAGE))
    blob = resnet50_params(mt, net)
    rng = np.random.default_rng(SEED + 1)
    n_req = CLIENTS * REQUESTS_PER_CLIENT
    images = rng.uniform(-1, 1, (n_req, 3, IMAGE, IMAGE)).astype(np.float32)

    os.environ["MXNET_NORM_CONV"] = "1"
    model = mt.serving.ServedModel(net, blob, {"data": (3, IMAGE, IMAGE)},
                                   name="resnet50", max_batch=BATCH)
    rows = [None] * n_req
    lat = [None] * n_req
    errors = []
    nc.launches = 0
    t_warm = time.perf_counter()
    model.warm(timeout=600)
    warm_s = time.perf_counter() - t_warm

    def client(c):
        try:
            for j in range(REQUESTS_PER_CLIENT):
                i = c * REQUESTS_PER_CLIENT + j
                t0 = time.perf_counter()
                rows[i] = model.predict({"data": images[i]}, timeout=600)[0]
                lat[i] = time.perf_counter() - t0
        except Exception as exc:   # reported below; the phase then fails
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    launches = nc.launches
    stats = model.stats()
    model.close()
    if errors or any(t.is_alive() for t in threads) or \
            any(r is None for r in rows):
        fail("serving: not every request was answered: %s" % errors)
    forwards = len(model.buckets) + stats["batches"]
    print("serving requests=%d batches=%d by_bucket=%s warm_forwards=%d "
          "norm_conv_launches=%d forwards=%d warm_s=%r"
          % (stats["requests"], stats["batches"], stats["batches_by_bucket"],
             len(model.buckets), launches, forwards, warm_s))
    if launches != launches_per_forward * forwards:
        fail("norm_conv launches %d != %d x %d forwards"
             % (launches, launches_per_forward, forwards))

    # reference: the unfused graph on cuDNN (TF32 off), same weights
    os.environ["MXNET_NORM_CONV"] = "0"
    ref = mt.Predictor(net, blob, {"data": (BATCH, 3, IMAGE, IMAGE)})
    want = []
    for i in range(0, n_req, BATCH):
        ref.forward(data=images[i:i + BATCH])
        want.append(ref.get_output(0))
    want = np.concatenate(want)
    if nc.launches != launches:
        fail("the unfused reference launched the NormConv kernel")
    got = np.stack(rows)
    if got.shape != (n_req, CLASSES) or not np.isfinite(got).all():
        fail("served rows: shape %s or non-finite values" % (got.shape,))
    if np.abs(got.sum(axis=1) - 1).max() > 1e-4:
        fail("served rows do not sum to 1")
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    print("serving check max_abs_diff=%r max_prob=%r tol=%g*max_prob "
          "argmax_agree=%d/%d" % (err, scale, SERVE_TOL, agree, n_req))
    if err > SERVE_TOL * scale or agree != n_req:
        fail("served rows differ from the unfused reference")
    lat_ms = np.array(lat) * 1e3
    print("serving qps=%r p50_ms=%r p99_ms=%r (%d requests, %d clients, "
          "closed loop, after warm)"
          % (n_req / wall, float(np.percentile(lat_ms, 50)),
             float(np.percentile(lat_ms, 99)), n_req, CLIENTS))
    forward_breakdown(torch, mt, net, blob, images[:BATCH])
    return launches


def forward_breakdown(torch, mt, net, blob, x, reps=5):
    """One batch-8 Predictor forward, unfused and fused: host time per
    forward (input staging included, ending in a synchronize), and for the
    fused one the device time by kernel from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for flag in ("0", "1"):
        os.environ["MXNET_NORM_CONV"] = flag
        pred = mt.Predictor(net, blob, {"data": x.shape})
        pred.forward(data=x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.forward(data=x)
        torch.cuda.synchronize()
        print("forward batch=%d MXNET_NORM_CONV=%s host_ms=%r"
              % (x.shape[0], flag, (time.perf_counter() - t0) / reps * 1e3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.forward(data=x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print("profile fused forward: wall_us=%r device_busy_us=%r "
          "device_busy_share=%r kernels=%d"
          % (wall_us, busy_us, busy_us / wall_us, len(kernels)))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print("profile kernel us=%r count=%d share=%r name=%s"
              % (e.self_device_time_total, e.count,
                 e.self_device_time_total / max(busy_us, 1e-9), e.key[:90]))


def lm_qkv(torch, gen, b, h, t, d, dtype):
    """q, k, v as the LM's graph hands them to attention: (B, H, T, D)
    strided views into one (B, T, 3, H, D) projection output."""
    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen)
    qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def flash_work(b, h, t, d, causal, elem):
    """(operations, bytes) the attention needs: 4·D per unmasked (q, k) pair
    (q·k and p·v, a multiply and an add each); q, k, v and o once plus the
    float32 lse."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 4.0 * b * h * d * pairs, 4.0 * b * h * t * d * elem + 4.0 * b * h * t


def bound(ops, nbytes, dname):
    """(bound ms, what bounds it) at the card's published peaks."""
    ops_ms = ops / PEAK_OPS[dname] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def flash_check(torch, fa, q, k, v, causal, scale, label):
    """Kernel vs plain version on the same inputs, and the kernel against
    itself over two launches; returns (max |do|, max |dlse|)."""
    ok, lk = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    ok2, lk2 = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    op, lp = fa.flash_attention_ref(q, k, v, causal, scale)
    torch.cuda.synchronize()
    if not (torch.equal(ok, ok2) and torch.equal(lk, lk2)):
        fail("flash %s: o or lse differs between two launches" % label)
    dname = str(q.dtype).split(".")[1]
    err = (ok.float() - op.float()).abs().max().item()
    ref = op.float().abs().max().item()
    lerr = (lk - lp).abs().max().item()
    lref = max(1.0, lp.abs().max().item())
    if not (torch.isfinite(ok).all() and torch.isfinite(lk).all()):
        fail("flash %s: non-finite output" % label)
    if ok.dtype != q.dtype or lk.dtype != torch.float32 or \
            ok.shape != q.shape or lk.shape != q.shape[:3] + (1,):
        fail("flash %s: outputs %s %s, %s %s" % (label, ok.dtype,
                                                  tuple(ok.shape), lk.dtype,
                                                  tuple(lk.shape)))
    if err > O_TOL[dname] * ref or lerr > LSE_TOL * lref:
        fail("flash %s: max|do| %.3g > %g * %.3g or max|dlse| %.3g > %g * "
             "%.3g" % (label, err, O_TOL[dname], ref, lerr, LSE_TOL, lref))
    return err, lerr


def sdpa_backend(torch, fn):
    """Names of the CUDA kernels one call of ``fn`` runs (which of SDPA's
    backends ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Memset")})


def flash_phase(torch, fa):
    """Kernel vs plain version, timed beside SDPA and the bound, at the LM's
    shape (q, k, v made as the LM makes them) and at FLASH_CHECKS, in float32
    and bfloat16.  Returns the float32 numbers per launch at the LM's
    shape."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lm_shape = (LM_BATCH, LM["num_heads"], LM["seq_len"],
                LM["num_hidden"] // LM["num_heads"])
    out = {}
    cases = [(lm_shape, True, None, True)] + [c + (False,)
                                              for c in FLASH_CHECKS]
    # the card's clocks drop in the earlier phases' idle gaps; 0.2 s of the
    # kernel first, so that the phase's first timing is not taken on the
    # way back up
    q, k, v = lm_qkv(torch, torch.Generator(device="cuda").manual_seed(SEED),
                     *lm_shape, torch.float32)
    t_end = time.perf_counter() + 0.2
    while time.perf_counter() < t_end:
        for _ in range(ITERS):
            fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
    for shape, causal, scale, main in cases:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            if main:
                q, k, v = lm_qkv(torch, gen, *shape, dt)
            else:
                q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                           .to(dt) for _ in range(3))
            label = "shape=%s %s scale=%s dtype=%s%s" % (
                shape, "causal" if causal else "full", scale, dname,
                " lm-strided" if main else "")
            err, lerr = flash_check(torch, fa, q, k, v, causal, scale,
                                    label)
            tile, nth, bq, bk, dmax, blocks, bufs = fa.fwd_plan(shape)
            kernel_ms = time_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, scale=scale))
            plain_ms = time_ms(torch, lambda: fa.flash_attention_ref(
                q, k, v, causal, scale))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, scale=scale)
            library_ms = time_ms(torch, library)
            bound_ms, bound_by = bound(
                *flash_work(*shape, causal, q.element_size()), dname)
            print("flash %s max_abs_err=%r lse_max_abs_err=%r kernel_ms=%r "
                  "plain_ms=%r library_ms=%r bound_ms=%r bound_by=%s "
                  "tile=%d threads=%d bq=%d bk=%d d_bucket=%d "
                  "blocks_per_sm=%d kv_buffers=%d vec16=%d "
                  "bitwise_repeat=True sdpa_kernels=%s"
                  % (label, err, lerr, kernel_ms, plain_ms, library_ms,
                     bound_ms, bound_by, tile, nth, bq, bk, dmax, blocks,
                     bufs, fa.aligned16(q, k, v),
                     sdpa_backend(torch, library)))
            if main and dt == torch.float32:
                out = {"ms": kernel_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err}
    return out


def lm_weights(net):
    """GPT-2-style random weights from SEED as numpy: N(0, 0.02), the
    residual projections (_proj, _mlp2) scaled by 1/sqrt(2 * layers),
    LayerNorm gamma 1 and beta 0, biases 0."""
    rng = np.random.default_rng(SEED)
    shapes = {"data": (1, LM["seq_len"]), "softmax_label": (1, LM["seq_len"])}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    args = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_weight"):
            v = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(0.02)
            if name.endswith(("_proj_weight", "_mlp2_weight")):
                v *= np.float32((2.0 * LM["num_layers"]) ** -0.5)
        elif name.endswith("_gamma"):
            v = np.ones(shape, np.float32)
        else:
            v = np.zeros(shape, np.float32)
        args[name] = v
    print("lm parameters=%d" % sum(v.size for v in args.values()))
    return args


def lm_phase(torch, mt, fa):
    """The LM served through Predictor from its JSON; returns the kernel's
    launches in the driven batches."""
    net = mt.models.transformer.get_symbol(**LM)
    ref_net = mt.models.transformer.get_symbol(attn_impl="xla", **LM)
    blob = mt.convert.params_from_numpy(lm_weights(net), {}, ctx=mt.gpu(0))
    shapes = {"data": (LM_BATCH, LM["seq_len"]),
              "softmax_label": (LM_BATCH, LM["seq_len"])}
    # both graphs reach Predictor as a checkpoint would: through JSON
    pred = mt.Predictor(net.tojson(), blob, shapes, copy_params=False)
    ref = mt.Predictor(ref_net.tojson(), blob, shapes, copy_params=False)
    rng = np.random.default_rng(SEED + 2)
    tokens = rng.integers(0, LM["vocab_size"],
                          (LM_BATCH * LM_BATCHES, LM["seq_len"]))
    pred.forward(data=tokens[:LM_BATCH])              # warm
    torch.cuda.synchronize()
    fa.launches = 0
    host_ms, d2h_ms, worst, agree, counted = [], [], 0.0, 0, 0
    for i in range(0, len(tokens), LM_BATCH):
        batch = tokens[i:i + LM_BATCH]
        t0 = time.perf_counter()
        pred.forward(data=batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = pred.get_output(0)
        host_ms.append((t1 - t0) * 1e3)
        d2h_ms.append((time.perf_counter() - t1) * 1e3)
        launched = fa.launches
        ref.forward(data=batch)
        want = ref.get_output(0)
        if fa.launches != launched:
            fail("the attn_impl='xla' graph launched the flash kernel")
        n_rows = LM_BATCH * LM["seq_len"]
        if got.shape != (n_rows, LM["vocab_size"]) or \
                not np.isfinite(got).all():
            fail("lm batch %d: shape %s or non-finite probabilities"
                 % (i // LM_BATCH, got.shape))
        if np.abs(got.sum(axis=1, dtype=np.float64) - 1).max() > 1e-4:
            fail("lm batch %d: rows do not sum to 1" % (i // LM_BATCH))
        err = float(np.abs(got - want).max())
        top = float(want.max())
        worst = max(worst, err / top)
        top2 = np.partition(want, -2, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LM_TOL * top
        same = got.argmax(1) == want.argmax(1)
        agree += int(same[clear].sum())
        counted += int(clear.sum())
        print("lm check batch=%d max_abs_diff=%r max_prob=%r tol=%g*max_prob "
              "argmax_agree=%d/%d (positions with top-2 gap > tol; "
              "%d of %d agree overall)"
              % (i // LM_BATCH, err, top, LM_TOL, int(same[clear].sum()),
                 int(clear.sum()), int(same.sum()), n_rows))
        if err > LM_TOL * top or not same[clear].all():
            fail("lm batch %d differs from the attn_impl='xla' graph"
                 % (i // LM_BATCH))
        del got, want
    launches = fa.launches
    forwards = LM_BATCHES
    print("lm batches=%d sequences=%d flash_launches=%d forwards=%d "
          "host_ms_per_forward=%r d2h_ms_per_batch=%r worst_rel_diff=%r "
          "argmax_agree=%d/%d"
          % (LM_BATCHES, len(tokens), launches, forwards,
             float(np.mean(host_ms)), float(np.mean(d2h_ms)), worst, agree,
             counted))
    if launches != LM["num_layers"] * forwards:
        fail("flash launches %d != %d x %d forwards"
             % (launches, LM["num_layers"], forwards))
    lm_breakdown(torch, pred, tokens[:LM_BATCH])
    return launches


def lm_breakdown(torch, pred, batch):
    """Device time of one LM forward and its output's copy to the host, by
    kernel and by group, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    groups = [("flash", ("flash_fwd_kernel",)),
              ("cublas", ("gemm", "cutlass", "cublas", "xmma")),
              ("softmax", ("softmax",)),
              ("d2h", ("memcpy dtoh",)), ("h2d", ("memcpy htod",)),
              ("copies", ("copy", "memcpy"))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.forward(data=batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred.get_output(0)
        t2 = time.perf_counter()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_us = (t2 - t0) * 1e6
    print("profile lm forward: forward_wall_us=%r d2h_wall_us=%r "
          "device_busy_us=%r device_busy_share=%r kernels=%d"
          % ((t1 - t0) * 1e6, (t2 - t1) * 1e6, busy_us, busy_us / wall_us,
             len(kernels)))
    by_group = {}
    for e in kernels:
        g = next((g for g, keys in groups
                  if any(key in e.key.lower() for key in keys)), "other")
        us, n = by_group.get(g, (0.0, 0))
        by_group[g] = (us + e.self_device_time_total, n + e.count)
    for g, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print("profile lm group=%s us=%r launches=%d share=%r"
              % (g, us, n, us / max(busy_us, 1e-9)))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        print("profile lm kernel us=%r count=%d share=%r name=%s"
              % (e.self_device_time_total, e.count,
                 e.self_device_time_total / max(busy_us, 1e-9),
                 e.key[:160]))


def bwd_work(b, h, t, d, causal, elem):
    """{kernel: (operations, bytes)} the backward needs: per unmasked (q, k)
    pair the dQ kernel does 3 products of length D (q·k, dO·v, dS·k), a
    multiply and an add each, and the dK/dV kernel 4 (q·k, dO·v, Pᵀ·dO,
    dSᵀ·Q); bytes are the tensors each reads and writes once (dQ: q, k, v,
    dO, lse, delta, dq; dK/dV: q, k, v, dO, lse, delta, dk, dv), lse and
    delta in float32."""
    pairs = t * (t + 1) // 2 if causal else t * t
    act = b * h * t * d * elem
    stats = 2 * 4 * b * h * t
    return {"dq": (6.0 * d * pairs * b * h, 5.0 * act + stats),
            "dkv": (8.0 * d * pairs * b * h, 6.0 * act + stats)}


def lm_grad_out(torch, gen, b, h, t, d, dtype):
    """dO as the LM's backward hands it to attention: the (B, H, T, D)
    permuted view of a contiguous (B, T, H, D) gradient of the output
    transpose."""
    g = torch.randn(b, t, h, d, device="cuda", generator=gen)
    return g.to(dtype).permute(0, 2, 1, 3)


def flash_bwd_phase(torch, fa):
    """Backward kernels vs the plain backward, timed beside SDPA's backward
    and the bounds, at the LM's shape (q, k, v and dO made as the LM makes
    them) and at FLASH_CHECKS, in float32 and bfloat16.  Returns the float32
    numbers per launch at the LM's shape."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lm_shape = (LM_BATCH, LM["num_heads"], LM["seq_len"],
                LM["num_hidden"] // LM["num_heads"])
    out = {}
    cases = [(lm_shape, True, None, True)] + [c + (False,)
                                              for c in FLASH_CHECKS]
    # the card's clocks drop in the earlier phases' idle gaps; 0.2 s of the
    # kernel first, so that the phase's first timing is not taken on the
    # way back up
    q, k, v = lm_qkv(torch, torch.Generator(device="cuda").manual_seed(SEED),
                     *lm_shape, torch.float32)
    t_end = time.perf_counter() + 0.2
    while time.perf_counter() < t_end:
        for _ in range(ITERS):
            fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
    for shape, causal, scale, main in cases:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            if main:
                q, k, v = lm_qkv(torch, gen, *shape, dt)
                do = lm_grad_out(torch, gen, *shape, dt)
            else:
                q, k, v, do = (torch.randn(shape, device="cuda",
                                           generator=gen).to(dt)
                               for _ in range(4))
            label = "shape=%s %s scale=%s dtype=%s%s" % (
                shape, "causal" if causal else "full", scale, dname,
                " lm-strided" if main else "")
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                            scale=scale)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                           scale)
            want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                              scale)
            torch.cuda.synchronize()
            errs = {}
            for name, a, b2, w in zip(("dq", "dk", "dv"), got, again, want):
                if a.dtype != dt or a.shape != q.shape:
                    fail("flash_bwd %s: %s is %s %s" % (label, name, a.dtype,
                                                       tuple(a.shape)))
                if not torch.isfinite(a).all():
                    fail("flash_bwd %s: non-finite %s" % (label, name))
                if not torch.equal(a, b2):
                    fail("flash_bwd %s: %s differs between two runs"
                         % (label, name))
                err = (a.float() - w.float()).abs().max().item()
                ref = w.float().abs().max().item()
                if err > BWD_TOL[dname] * ref:
                    fail("flash_bwd %s: max|d%s| %.3g > %g * %.3g"
                         % (label, name, err, BWD_TOL[dname], ref))
                errs[name] = (err, ref)
            run = fa._BwdLaunch(q, k, v, o, lse, do, causal, scale)
            dq_ms = time_ms(torch, run.dq_kernel)
            dkv_ms = time_ms(torch, run.dkv_kernel)
            whole_ms = time_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal, scale))
            plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal, scale))
            qs, ks, vs = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                scale=scale)
            sdpa_ms = time_ms(torch, lambda: torch.autograd.grad(
                so, (qs, ks, vs), do, retain_graph=True))
            del so, qs, ks, vs
            work = bwd_work(*shape, causal, q.element_size())
            dq_bound, dq_by = bound(*work["dq"], dname)
            dkv_bound, dkv_by = bound(*work["dkv"], dname)
            print("flash_bwd %s max_abs_err dq=%r dk=%r dv=%r max_abs_ref "
                  "dq=%r dk=%r dv=%r tol=%g*max_abs_ref repeat=bitwise"
                  % ((label,) + tuple(errs[n][0] for n in ("dq", "dk", "dv"))
                     + tuple(errs[n][1] for n in ("dq", "dk", "dv"))
                     + (BWD_TOL[dname],)))
            print("flash_bwd %s dq_ms=%r dq_bound_ms=%r dq_bound_by=%s "
                  "dkv_ms=%r dkv_bound_ms=%r dkv_bound_by=%s whole_ms=%r "
                  "plain_ms=%r sdpa_bwd_ms=%r"
                  % (label, dq_ms, dq_bound, dq_by, dkv_ms, dkv_bound,
                     dkv_by, whole_ms, plain_ms, sdpa_ms))
            if main and dt == torch.float32:
                out = {"dq_ms": dq_ms, "dkv_ms": dkv_ms,
                       "whole_ms": whole_ms, "plain_ms": plain_ms,
                       "library_ms": sdpa_ms, "dq_bound_ms": dq_bound,
                       "dq_bound_by": dq_by, "dkv_bound_ms": dkv_bound,
                       "dkv_bound_by": dkv_by, "dq_err": errs["dq"][0],
                       "dkv_err": max(errs["dk"][0], errs["dv"][0])}
            del got, again, want, run
    return out


def flash_counts(fa):
    return (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)


def reset_flash_counts(fa):
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0


def lm_train_phase(torch, mt, fa):
    """(a) the LM's gradients on the kernel graph against the xla graph's;
    (b) TrainStep with Adam on one fixed batch.  Returns the backward
    kernels' launches in the driven TrainStep steps."""
    net = mt.models.transformer.get_symbol(**LM)
    ref_net = mt.models.transformer.get_symbol(attn_impl="xla", **LM)
    weights = lm_weights(net)
    shapes = {"data": (LM_BATCH, LM["seq_len"]),
              "softmax_label": (LM_BATCH, LM["seq_len"])}
    rng = np.random.default_rng(SEED + 4)
    toks = rng.integers(0, LM["vocab_size"], (LM_BATCH, LM["seq_len"] + 1))
    batch = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    gpu = mt.gpu(0)
    grads = {}
    for name, sym, dt in (("flash", net, np.float32),
                          ("xla", ref_net, np.float32),
                          ("xla_f64", ref_net, np.float64)):
        args = mt.convert.params_from_numpy(
            {n: v.astype(dt) for n, v in dict(weights, **batch).items()}, {},
            ctx=gpu)
        ex = sym.bind(gpu, {k[4:]: v for k, v in args.items()}, args_grad={
            n: mt.nd.zeros(v.shape, ctx=gpu, dtype=dt)
            for n, v in weights.items()}, grad_req="write")
        reset_flash_counts(fa)
        ex.forward(is_train=True)
        ex.backward()
        torch.cuda.synchronize()
        counts = flash_counts(fa)
        print("lm_train grad graph=%s flash_fwd_launches=%d "
              "flash_dq_launches=%d flash_dkv_launches=%d" % ((name,) + counts))
        want = (LM["num_layers"],) * 3 if name == "flash" else (0, 0, 0)
        if counts != want:
            fail("lm_train: the %s graph launched %s flash kernels, want %s"
                 % (name, counts, want))
        grads[name] = {n: g.value.double() for n, g in ex.grad_dict.items()}
        del ex, args

    def dist(a, b):
        return (((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                .item(), ((a - b).norm() / b.norm().clamp_min(1e-300)).item())
    rows = []
    for n, g in grads["xla"].items():
        got = grads["flash"][n]
        if not torch.isfinite(got).all():
            fail("lm_train: non-finite gradient of %s" % n)
        rows.append(dist(got, g) + dist(g, grads["xla_f64"][n]) + (n,))
    rows.sort(reverse=True)
    for row in rows[:8]:
        print("lm_train grad param=%s max_rel=%r norm_rel=%r f32_floor "
              "max_rel=%r norm_rel=%r" % ((row[4],) + row[:4]))
    worst = {"check": [max(r[0] for r in rows), max(r[1] for r in rows)],
             "floor": [max(r[2] for r in rows), max(r[3] for r in rows)]}
    for rel, nrel, _, _, n in rows:
        if rel > LM_GRAD_TOL or nrel > LM_GRAD_NORM_TOL:
            fail("lm_train: gradient of %s differs from the xla graph's by "
                 "%.3g of its largest entry (tol %g), %.3g in norm (tol %g)"
                 % (n, rel, LM_GRAD_TOL, nrel, LM_GRAD_NORM_TOL))
    print("lm_train grad_check parameters=%d worst max_rel=%r norm_rel=%r "
          "(tol %g, %g); xla f32 vs f64 worst max_rel=%r norm_rel=%r"
          % ((len(grads["xla"]),) + tuple(worst["check"])
             + (LM_GRAD_TOL, LM_GRAD_NORM_TOL) + tuple(worst["floor"])))
    del grads

    ts = mt.TrainStep(net, mt.optimizer.Adam(learning_rate=LM_LR))
    zeros = {n: (np.zeros(v.shape, np.float32), np.zeros(v.shape,
                                                         np.float32))
             for n, v in weights.items()}
    params, state, aux = mt.convert.train_state_from_numpy(
        weights, zeros, {}, ctx=gpu)
    del zeros
    dev_batch = ts.shard_batch(batch)
    lab = dev_batch["softmax_label"].reshape(-1).long()
    rows = torch.arange(lab.numel(), device=lab.device)

    def loss(outs):
        # mean -log p(label), reduced on the card
        return -torch.log(outs[0][rows, lab]).mean().item()
    params, state, aux, outs = ts(params, state, aux, dev_batch)   # warm
    losses = [loss(outs)]
    torch.cuda.synchronize()
    reset_flash_counts(fa)
    host_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        params, state, aux, outs = ts(params, state, aux, dev_batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss(outs))
    t0 = time.perf_counter()
    params, state, aux, outs = ts.run_steps(params, state, aux, dev_batch, 3)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3 / 4
    losses.append(loss(outs))
    counts = flash_counts(fa)
    steps = 8
    tokens = LM_BATCH * LM["seq_len"]
    step_ms = float(np.mean(host_ms))
    print("lm_train steps=9 (1 warm + 4 calls + run_steps(3)) losses=%s"
          % [round(x, 6) for x in losses])
    print("lm_train loss_first=%r loss_last=%r num_update=%d"
          % (losses[0], losses[-1], ts.num_update))
    print("lm_train host_ms_per_step calls=%r run_steps=%r (to a "
          "synchronize) tokens_per_s calls=%r run_steps=%r"
          % (step_ms, run_ms, tokens / step_ms * 1e3,
             tokens / run_ms * 1e3))
    print("lm_train launches over %d steps flash_fwd=%d flash_dq=%d "
          "flash_dkv=%d" % ((steps,) + counts))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail("lm_train: the loss did not fall: %s" % losses)
    if counts != (steps * LM["num_layers"],) * 3:
        fail("lm_train: flash launches %s != 3 x %d x %d steps"
             % (counts, LM["num_layers"], steps))
    train_breakdown(torch, ts, params, state, aux, dev_batch)
    return counts[1], counts[2]


def train_breakdown(torch, ts, params, state, aux, batch):
    """Device time of one TrainStep call by group, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    groups = [("flash fwd", ("flash_fwd_kernel",)),
              ("flash dq", ("flash_bwd_dq_kernel",)),
              ("flash dkv", ("flash_bwd_dkv_kernel",)),
              ("cublas", ("gemm", "cutlass", "cublas", "xmma", "sm90_")),
              ("softmax", ("softmax",)),
              ("embedding backward", ("indexfunc", "index_add", "embedding",
                                      "index_put", "scatter")),
              ("copies", ("copy", "memcpy", "memset"))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts(params, state, aux, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print("profile train step: wall_us=%r device_busy_us=%r "
          "device_busy_share=%r kernels=%d"
          % (wall_us, busy_us, busy_us / wall_us, len(kernels)))
    by_group = {}
    for e in kernels:
        g = next((g for g, keys in groups
                  if any(key in e.key.lower() for key in keys)),
                 "elementwise/optimizer")
        us, n = by_group.get(g, (0.0, 0))
        by_group[g] = (us + e.self_device_time_total, n + e.count)
    for g, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print("profile train group=%s us=%r launches=%d share=%r"
              % (g, us, n, us / max(busy_us, 1e-9)))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        print("profile train kernel us=%r count=%d share=%r name=%s"
              % (e.self_device_time_total, e.count,
                 e.self_device_time_total / max(busy_us, 1e-9),
                 e.key[:160]))


def graph_device_phase(torch, mt):
    """Ops with no input inside a graph bound to gpu(0): ``_ones`` plus a
    data variable, and a sampler plus a data variable, forward on the card
    with the right values."""
    gpu = mt.gpu(0)
    data = mt.sym.Variable("data")
    ex = (mt.sym._ones(shape=(4, 8)) + data).bind(gpu, {
        "data": mt.nd.array(np.full((4, 8), 2, np.float32), ctx=gpu)})
    out = ex.forward()[0].value
    if not out.is_cuda or not bool((out == 3).all()):
        fail("graph_device: _ones + data gave %s on %s"
             % (out.flatten()[:4].tolist(), out.device))
    n = 1 << 16
    ex = (mt.sym.uniform(shape=(n,), low=2.0, high=3.0) + data).bind(gpu, {
        "data": mt.nd.zeros((n,), ctx=gpu)})
    u = ex.forward()[0].value
    if not u.is_cuda or not bool(((u >= 2) & (u < 3)).all()) \
            or abs(u.mean().item() - 2.5) > 0.01:
        fail("graph_device: uniform(2, 3) + data gave mean %r on %s"
             % (u.mean().item(), u.device))
    print("graph_device _ones+data device=%s ok; uniform(2,3)+data "
          "device=%s mean=%r" % (out.device, u.device, u.mean().item()))


def device_profile(torch, fn):
    """(device us, launches) of the CUDA kernels one call of ``fn`` runs,
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels),
            sum(e.count for e in kernels))


def imperative_phase(torch, mt, weights):
    """Updater passes over every LM parameter against the fused rule."""
    from mxnet_tpu_torch.train import _FunctionalOptimizer
    gpu = mt.gpu(0)
    names = sorted(weights)
    idx2name = dict(enumerate(names))
    mt.random.seed(SEED + 5)
    grads = [mt.nd.normal(loc=0.0, scale=1e-2, shape=weights[n].shape,
                          ctx=gpu) for n in names]
    common = dict(wd=1e-2, rescale_grad=0.5, clip_gradient=4e-3,
                  param_idx2name=idx2name)
    opts = (("adam", lambda: mt.optimizer.Adam(learning_rate=1e-3,
                                                **common)),
            ("sgd_momentum", lambda: mt.optimizer.SGD(
                learning_rate=0.1, momentum=0.9, **common)))
    for label, make in opts:
        params = [mt.nd.array(weights[n], ctx=gpu) for n in names]
        updater = mt.optimizer.get_updater(make())

        def one_pass():
            for i, (g, w) in enumerate(zip(grads, params)):
                updater(i, g, w)
        host_ms = []
        for _ in range(IMP_PASSES - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_pass()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_us, n_launch = device_profile(torch, one_pass)

        fopt = _FunctionalOptimizer(make(), names)
        fw = {n: torch.from_numpy(weights[n]).cuda() for n in names}
        state = fopt.init_state(fw)
        fused_ms = []
        for t in range(1, IMP_PASSES + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hyper = fopt.hyper(t - 1)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    nw, ns = fopt.update(n, fw[n], g.value, state[n], hyper,
                                         t)
                    fw[n].copy_(nw)
                    for s, v in zip(state[n], ns):
                        s.copy_(v)
            torch.cuda.synchronize()
            fused_ms.append((time.perf_counter() - t0) * 1e3)
        err, scale, serr = 0.0, 0.0, 0.0
        for i, n in enumerate(names):
            w = params[i].value
            if not torch.isfinite(w).all():
                fail("imperative %s: non-finite %s" % (label, n))
            err = max(err, (w - fw[n]).abs().max().item())
            scale = max(scale, fw[n].abs().max().item())
            st = updater.states[i]
            st = st if isinstance(st, tuple) else (st,)
            for a, b in zip(st, state[n]):
                serr = max(serr, ((a.value - b).abs().max()
                                  / b.abs().max().clamp_min(1e-30)).item())
        print("imperative %s parameters=%d arrays=%d passes=%d "
              "max_abs_diff_vs_fused=%r max_abs_w=%r tol=%g*max_abs_w "
              "state_max_rel_diff=%r" % (label, sum(w.size for w in params),
                                          len(params), IMP_PASSES, err, scale,
                                          IMPERATIVE_TOL, serr))
        print("imperative %s host_ms_per_pass=%s (to a synchronize; pass 1 "
              "creates the states) profiled_pass device_ms=%r launches=%d "
              "fused_rule host_ms_per_pass=%s"
              % (label, [round(x, 3) for x in host_ms], dev_us / 1e3,
                 n_launch, [round(x, 3) for x in fused_ms]))
        if err > IMPERATIVE_TOL * scale or serr > IMPERATIVE_TOL:
            fail("imperative %s: the Updater differs from the fused rule"
                 % label)
        del params, updater, fw, state


def rtc_phase(torch, mt, weights):
    """The four user kernels pushed through Rtc; returns the axpb numbers
    and its launches in the counted run."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch import rtc_kernels as rk
    gpu = mt.gpu(0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    names = sorted(weights)
    n = sum(weights[k].size for k in names)

    def card(t):
        return mt.nd.NDArray(t, ctx=gpu)
    x = card(torch.randn(n, device="cuda", generator=gen))
    y = card(torch.randn(n, device="cuda", generator=gen))
    out = mt.nd.zeros((n,), ctx=gpu)
    x10 = card(torch.rand(10, device="cuda", generator=gen) * 2 - 1)
    y10 = mt.nd.zeros((10,), ctx=gpu)
    head = mt.nd.array(weights["lm_head_weight"], ctx=gpu)
    head_t = mt.nd.zeros(head.shape[::-1], ctx=gpu)
    # one buffer holding every parameter; each parameter is a view of it
    w_all = mt.nd.zeros((n,), ctx=gpu)
    views, spans, at = {}, {}, 0
    for k in names:
        size = weights[k].size
        views[k] = w_all[at:at + size].reshape(weights[k].shape)
        views[k][:] = weights[k]
        spans[k] = (at, at + size)
        at += size
    g_all = card(torch.randn(n, device="cuda", generator=gen) * 1e-2)
    m_all = card(torch.randn(n, device="cuda", generator=gen) * 1e-3)
    sgd = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=0.5,
               clip_gradient=4e-3)
    w_want, m_want = rk.sgd_mom_plain(w_all, g_all, m_all, **sgd)
    kernels = [("axpb", rk.make_axpb(n), [x, y], [out]),
               ("exp5_shared", rk.make_exp5_shared(), [x10], [y10]),
               ("transpose_tiled", rk.make_transpose_tiled(*head.shape),
                [head], [head_t]),
               ("sgd_mom", rk.make_sgd_mom(n, **sgd), [w_all, g_all, m_all],
                [w_all, m_all])]
    torch.cuda.synchronize()
    rtc.launches = 0
    builds0 = rtc.builds
    per_kernel = {}
    for name, (r, launch), ins, outs in kernels:
        before = rtc.launches
        t0 = time.perf_counter()
        r.push(ins, outs, **launch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        per_kernel[name] = rtc.launches - before
        print("rtc first_push kernel=%s seconds=%r (nvcc build, load, "
              "launch) launch=%s" % (name, secs, launch))
    main_launches = rtc.launches
    builds1 = rtc.builds
    print("rtc counted run launches=%d by_kernel=%s builds=%d"
          % (main_launches, per_kernel, builds1 - builds0))
    if any(v != 1 for v in per_kernel.values()):
        fail("rtc: each user kernel must launch once, got %s" % per_kernel)

    axpb_err = (out.value - rk.axpb_plain(x.value, y.value)).abs().max() \
        .item()
    if axpb_err != 0.0:
        fail("rtc axpb differs from x * 2 + y by %r" % axpb_err)
    want = rk.exp5_plain(x10.value)
    exp_err = ((y10.value - want).abs() / want.abs()).max().item()
    if not exp_err <= EXP5_TOL:
        fail("rtc exp5_shared: max rel err %r > %g" % (exp_err, EXP5_TOL))
    if not torch.equal(head_t.value, rk.transpose_plain(head.value)):
        fail("rtc transpose_tiled differs from x.t()")
    scale = w_want.value.abs().max().item()
    sgd_err = max((w_all.value - w_want.value).abs().max().item(),
                  (m_all.value - m_want.value).abs().max().item())
    a, b = spans["lm_head_weight"]
    view_err = (views["lm_head_weight"].value
                - w_want.value[a:b].reshape(head.shape)).abs().max().item()
    print("rtc check axpb max_abs_err=%r exp5_shared max_rel_err=%r (tol %g) "
          "transpose_tiled=bitwise sgd_mom max_abs_err=%r max_abs_w=%r "
          "(tol %g*max_abs_w) view lm_head_weight max_abs_err=%r"
          % (axpb_err, exp_err, EXP5_TOL, sgd_err, scale, IMPERATIVE_TOL,
             view_err))
    if not torch.isfinite(w_all.value).all() or \
            max(sgd_err, view_err) > IMPERATIVE_TOL * scale:
        fail("rtc sgd_mom differs from sgd_mom_update")

    for name, (r, launch), ins, outs in kernels:
        r.push(ins, outs, **launch)
    torch.cuda.synchronize()
    print("rtc second push builds=%d (unchanged: %s)"
          % (rtc.builds - builds0, rtc.builds == builds1))
    if rtc.builds != builds1:
        fail("rtc: a second push built again")

    r, launch = kernels[1][1]
    reps = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        r.push([x10], [y10], **launch)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    print("rtc exp5_shared host_us_per_push=%r (%d pushes, before a "
          "synchronize)" % (host_us, reps))

    for name, (r, launch), ins, outs in kernels[1:]:
        ms = time_ms(torch, lambda: r.push(ins, outs, **launch))
        print("rtc time kernel=%s ms=%r" % (name, ms))
    r, launch = kernels[0][1]
    res = {"ms": time_ms(torch, lambda: r.push([x, y], [out], **launch)),
           "plain_ms": time_ms(torch, lambda: rk.axpb_plain(x.value,
                                                            y.value)),
           "library_ms": time_ms(torch, lambda: torch.add(
               y.value, x.value, alpha=2.0)),
           "bound_ms": 12.0 * n / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "max_abs_err": axpb_err, "launches": per_kernel["axpb"]}
    print("rtc axpb n=%d kernel_ms=%r plain_ms=%r library_ms=%r bound_ms=%r "
          "bound_by=bytes" % (n, res["ms"], res["plain_ms"],
                              res["library_ms"], res["bound_ms"]))

    bad = rtc.Rtc("broken", ["x"], ["y"], "  y[0] = x[0] +;")
    try:
        bad.push([x10], [y10], block_dim_x=1)
    except mt.MXNetError as exc:
        msg = str(exc)
        if "nvcc failed" not in msg or "error" not in msg:
            fail("rtc: a syntax error raised without nvcc's log: %s" % msg)
        print("rtc syntax error raised MXNetError with nvcc's log (%d "
              "chars): %s" % (len(msg), msg.strip().splitlines()[-1][:160]))
    else:
        fail("rtc: a source with a syntax error built")
    return res


def build_all(kernels):
    """Build every kernel library at once (one nvcc each, in threads: the
    compiler runs outside the GIL); fatal on any failure."""
    results = {}

    def one(name, build):
        t0 = time.perf_counter()
        try:
            results[name] = (build(), time.perf_counter() - t0)
        except Exception as exc:   # reported below; the phase then fails
            results[name] = exc
    threads = [threading.Thread(target=one, args=kv) for kv in kernels]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, _ in kernels:
        res = results.get(name)
        if not isinstance(res, tuple):
            fail("build %s: %s" % (name, res))
        log, secs = res
        print("build %s.cu seconds=%r" % (name, secs))
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas %s %s" % (name, line.strip()))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mxnet_tpu_torch as mt
        from mxnet_tpu_torch.ops import flash_attention as fa
        from mxnet_tpu_torch.ops import norm_conv as nc
    except ImportError as exc:
        fail("cannot import mxnet_tpu_torch: %s" % exc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi failed: %s" % smi.stderr
    print(card)
    print("torch %s cuda %s device %s" % (torch.__version__,
                                         torch.version.cuda,
                                         torch.cuda.get_device_name(0)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("settings cudnn.allow_tf32=%s matmul.allow_tf32=%s "
          "float32_matmul_precision=%s"
          % (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision()))

    t0 = time.perf_counter()
    build_all([("norm_conv", nc.build), ("flash_attention", fa.build),
               ("flash_attention_bwd", fa.build_bwd)])
    print("build all seconds=%r" % (time.perf_counter() - t0))

    geoms = resnet50_geometries(mt, BATCH)
    per_forward = sum(geoms.values())
    print("resnet50 norm_conv geometries=%d launches_per_forward=%d"
          % (len(geoms), per_forward))
    if len(geoms) != 22 or per_forward != 52:
        fail("expected 22 geometries and 52 launches per forward")
    tot = kernel_phase(torch, nc, geoms)
    print("kernel totals per batch-%d float32 forward (52 launches): "
          "kernel_ms=%r plain_ms=%r library_ms=%r bound_ms=%r"
          % (BATCH, tot["ms"], tot["plain_ms"], tot["library_ms"],
             tot["bound_ms"]))

    launches = serving_phase(torch, mt, nc, per_forward)

    fl = flash_phase(torch, fa)
    fl_launches = lm_phase(torch, mt, fa)
    per = LM["num_layers"]     # the launches of one float32 LM forward
    bw = flash_bwd_phase(torch, fa)
    dq_launches, dkv_launches = lm_train_phase(torch, mt, fa)
    graph_device_phase(torch, mt)
    weights = lm_weights(mt.models.transformer.get_symbol(**LM))
    imperative_phase(torch, mt, weights)
    rt = rtc_phase(torch, mt, weights)

    print(json.dumps({"kernels": [{
        "name": "norm_conv", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_conv.cu",
        "replaces": "mxnet_tpu/ops/pallas_conv.py:120",
        "launches": launches, "max_abs_err": tot["max_abs_err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"]
        else "bytes",
        "library_ms": tot["library_ms"]}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:47",
        "launches": fl_launches, "max_abs_err": fl["max_abs_err"],
        "ms": per * fl["ms"], "plain_ms": per * fl["plain_ms"],
        "bound_ms": per * fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": per * fl["library_ms"]}, {
        "name": "flash_attention_bwd_dq", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:137",
        "launches": dq_launches, "max_abs_err": bw["dq_err"],
        "ms": per * bw["dq_ms"], "plain_ms": per * bw["plain_ms"],
        "plain_covers": "dq+dk+dv",
        "bound_ms": per * bw["dq_bound_ms"], "bound_by": bw["dq_bound_by"],
        "library_ms": per * bw["library_ms"],
        "library_covers": "dq+dk+dv"}, {
        "name": "flash_attention_bwd_dkv", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:169",
        "launches": dkv_launches, "max_abs_err": bw["dkv_err"],
        "ms": per * bw["dkv_ms"], "plain_ms": per * bw["plain_ms"],
        "plain_covers": "dq+dk+dv",
        "bound_ms": per * bw["dkv_bound_ms"],
        "bound_by": bw["dkv_bound_by"],
        "library_ms": per * bw["library_ms"],
        "library_covers": "dq+dk+dv"}, {
        "name": "rtc_axpb", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc_kernels.py",
        "replaces": "mxnet_tpu/rtc.py:55",
        "launches": rt["launches"], "max_abs_err": rt["max_abs_err"],
        "ms": rt["ms"], "plain_ms": rt["plain_ms"],
        "bound_ms": rt["bound_ms"], "bound_by": rt["bound_by"],
        "library_ms": rt["library_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
