"""SSD trained through ``Module.fit``, then its detection symbol (the port's
twin of ``examples/ssd/train.py``, same flags and defaults).

    python -m mxnet_tpu_torch.bench.ssd_train
    python -m mxnet_tpu_torch.bench.ssd_train --num-classes 20 \\
        --batch-size 32

The model is ``models/ssd.py`` (64x64 input, 1,344 anchors); the data are
the example's synthetic detection batches (coloured rectangles on noise,
1-3 objects an image, label width 3), drawn from ``RandomState(0)`` as the
example draws them, so that both packages see the same batches.  The fit
is SGD (lr 0.005, momentum 0.9, wd 5e-4) with the example's ``LocL1``
metric (the mean smooth-L1 localisation loss, summed on the card) and its
``Speedometer``; then ``get_symbol`` is bound on the same device with the
trained parameters and run on the ``RandomState(1)`` batch.

Runs on ``gpu(0)`` (``--cpu`` for a toy run).  Prints one JSON line a fit:
images/s in steady state (``value``: the batches after each epoch's first,
over the gaps between their batch ends) and over the fit's wall time with
its set-up, the host ms a batch (median gap), ``LocL1`` at each epoch's
end, whether ``Module.fit`` took the fused ``TrainStep`` path, the
detection forward's ms, the kept detections, ``contrib.nms_launches`` of
the timed detection forwards, and on the card peak memory (the fit and the
detections), the device-busy share of the batch loop (one more epoch,
profiled after the detections) and the card's name and power limit.
"""
import argparse
import json
import logging
import subprocess
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import ssd
from mxnet_tpu_torch.ops import contrib

DETECT_REPS = 5


def synthetic_detection_batch(rs, batch_size, num_classes, size=64,
                              max_obj=3):
    """The example's batch: noise, 1..max_obj class-coloured rectangles an
    image; labels (batch, max_obj, 5) rows [class, x0, y0, x1, y1], -1 pad."""
    data = rs.rand(batch_size, 3, size, size).astype(np.float32) * 0.2
    label = np.full((batch_size, max_obj, 5), -1.0, np.float32)
    for i in range(batch_size):
        n_obj = rs.randint(1, max_obj + 1)
        for j in range(n_obj):
            cls = rs.randint(0, num_classes)
            w, h = rs.uniform(0.2, 0.5, 2)
            x0 = rs.uniform(0, 1 - w)
            y0 = rs.uniform(0, 1 - h)
            label[i, j] = [cls, x0, y0, x0 + w, y0 + h]
            xs, xe = int(x0 * size), int((x0 + w) * size)
            ys, ye = int(y0 * size), int((y0 + h) * size)
            data[i, cls % 3, ys:ye, xs:xe] += 0.8  # class-colored box
    return data, label


class SyntheticDetIter(mt.io.DataIter):
    """The example's iterator: ``num_batches`` synthetic batches from one
    ``RandomState(0)``, host NDArrays."""

    def __init__(self, batch_size, num_classes, num_batches=20, size=64):
        super().__init__(batch_size)
        self.rs = np.random.RandomState(0)
        self.num_classes = num_classes
        self.num_batches = num_batches
        self.size = size
        self.cur = 0

    @property
    def provide_data(self):
        return [mt.io.DataDesc("data", (self.batch_size, 3, self.size,
                                        self.size))]

    @property
    def provide_label(self):
        return [mt.io.DataDesc("label", (self.batch_size, 3, 5))]

    def reset(self):
        self.cur = 0

    def next(self):
        if self.cur >= self.num_batches:
            raise StopIteration
        self.cur += 1
        d, lab = synthetic_detection_batch(self.rs, self.batch_size,
                                           self.num_classes, self.size)
        return mt.io.DataBatch([mt.nd.array(d, ctx=mt.cpu())],
                               [mt.nd.array(lab, ctx=mt.cpu())], pad=0,
                               provide_data=self.provide_data,
                               provide_label=self.provide_label)

    def __next__(self):
        return self.next()

    def __iter__(self):
        self.reset()
        return self


class LocL1(mt.metric.EvalMetric):
    """Mean smooth-L1 localisation loss (the example's metric), summed on
    the device: no host read until ``get()``."""

    def __init__(self):
        super().__init__("loc_l1")

    def update(self, labels, preds):
        v = preds[1].value
        self.sum_metric = self.sum_metric + v.abs().sum()
        self.num_inst += v.shape[0]


def card_name():
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return "nvidia-smi: %s" % exc


def busy_share(fit_epoch, dev):
    """(device-busy share, kernel launches) of ``fit_epoch()`` profiled:
    the kernels' summed time over the wall time (the profiler's own host
    cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_epoch()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    return busy_us * 1e-6 / wall, sum(e.count for e in kernels)


def detect(mod, num_classes, batch_size, ctx, reps=DETECT_REPS):
    """The detection symbol bound on ``ctx`` with the fit's parameters, on
    the ``RandomState(1)`` batch: (detections as numpy, ms a forward over
    ``reps`` timed forwards after a warm one, NMS launches of the timed
    forwards)."""
    det = ssd.get_symbol(num_classes=num_classes)
    ex = det.simple_bind(ctx, data=(batch_size, 3, 64, 64))
    arg_params, aux_params = mod.get_params()
    ex.copy_params_from(arg_params, aux_params, allow_extra_params=True)
    d, _ = synthetic_detection_batch(np.random.RandomState(1), batch_size,
                                     num_classes)
    x = mt.nd.array(d, ctx=ctx)
    card = ctx.torch_device().type == "cuda"
    ex.forward(data=x)
    if card:
        torch.cuda.synchronize()
    launches = contrib.nms_launches
    t0 = time.perf_counter()
    for _ in range(reps):
        out = ex.forward(data=x)[0]
    if card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    return out.asnumpy(), ms, contrib.nms_launches - launches


def run(num_classes=3, batch_size=8, num_epochs=2, lr=0.005, num_batches=10,
        ctx=None, seed=0):
    """One fit and the detection run: (record dict, Module, detections).
    The initializer draws from ``seed`` (``np.random`` and the port's
    generators)."""
    ctx = ctx if ctx is not None else mt.gpu(0)
    np.random.seed(seed)
    mt.random.seed(seed)
    dev = ctx.torch_device()
    card = dev.type == "cuda"
    net = ssd.get_symbol_train(num_classes=num_classes)
    train = SyntheticDetIter(batch_size, num_classes, num_batches)
    mod = mt.Module(net, data_names=("data",), label_names=("label",),
                    context=ctx)
    metric = LocL1()
    gaps, loc_l1, last = [], [], [None]

    def batch_end(param):
        now = time.perf_counter()
        if last[0] is not None:
            gaps.append((now - last[0]) * 1e3)
        last[0] = now

    def epoch_end(epoch, symbol, arg, aux):
        loc_l1.append(metric.get()[1])
        last[0] = None              # the epoch's end work is not a batch
    if card:
        torch.cuda.synchronize(dev)       # the card's context first
        torch.cuda.reset_peak_memory_stats(dev)
    fit_kw = dict(eval_metric=metric, optimizer="sgd",
                  optimizer_params={"learning_rate": lr, "momentum": 0.9,
                                    "wd": 5e-4})
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=num_epochs,
            batch_end_callback=[mt.callback.Speedometer(batch_size, 5),
                                batch_end],
            epoch_end_callback=epoch_end, **fit_kw)
    if card:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    steady_s = sum(gaps) * 1e-3
    rec = {
        "metric": "ssd_train_img_per_sec_b%d" % batch_size,
        "value": len(gaps) * batch_size / steady_s, "unit": "images/s",
        "fit_img_per_s": num_epochs * num_batches * batch_size / seconds,
        "fit_seconds": seconds, "host_ms_per_batch": float(np.median(gaps)),
        "loc_l1": loc_l1,
        "fused_path": mod._fused_ts_cache is not None,
        "config": {"num_classes": num_classes, "batch": batch_size,
                   "epochs": num_epochs, "batches": num_batches, "lr": lr,
                   "anchors": 1344, "device": str(dev)}}
    out, rec["detect_ms"], rec["nms_launches"] = detect(
        mod, num_classes, batch_size, ctx)
    rec["detect_forwards"] = DETECT_REPS
    rec["detections_shape"] = list(out.shape)
    rec["kept_detections"] = int((out[:, :, 0] >= 0).sum())
    if card:
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        # one more epoch, after the detections: its parameters are not used
        rec["device_busy_share"], rec["profiled_launches"] = busy_share(
            lambda: mod.fit(train, num_epoch=1, **fit_kw), dev)
        rec["card"] = card_name()
    return rec, mod, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-classes", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--num-batches", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (a toy run)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rec, _, _ = run(args.num_classes, args.batch_size, args.num_epochs,
                    args.lr, args.num_batches,
                    mt.cpu() if args.cpu else None)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
