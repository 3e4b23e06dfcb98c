"""Train ImageNet-class networks with the port (the twin of
``examples/train_imagenet.py``: the same networks, flags and defaults).

    python -m mxnet_tpu_torch.bench.train_imagenet --network inception-v3 \\
        --image-shape 3,299,299 --benchmark 1
    python -m mxnet_tpu_torch.bench.train_imagenet --network vgg --benchmark 1
    python -m mxnet_tpu_torch.bench.train_imagenet --network inception-v3 \\
        --image-shape 3,299,299 --num-examples 256       # Module.fit
    python -m mxnet_tpu_torch.bench.train_imagenet --data-train train.rec \\
        --data-train-idx train.idx                        # from records
    python -m mxnet_tpu_torch.bench.train_imagenet --cpu --network vgg11 \\
        --num-classes 10 --image-shape 3,32,32 --batch-size 4 \\
        --benchmark 1 --benchmark-iters 2                 # a toy run

``--network`` takes ``resnet<depth>``, ``alexnet``, ``inception-v3`` and
``vgg<depth>`` (``vgg`` is VGG-16).  ``--benchmark 1`` trains on one
synthetic batch from ``RandomState(0)`` through ``TrainStep`` (SGD with
momentum 0.9, ``rescale_grad`` 1/batch): one warm step, then
``--benchmark-iters`` timed steps ending in the fetch of one scalar; it
prints img/s and ms a step.  Without it the network trains through
``Module.fit``, the per-batch cross-entropy kept on the card
(``BatchLoss``): with ``--data-train`` (and ``--data-train-idx``) from a
RecordIO pack (``bench/im2rec.py``) through ``ImageRecordIter`` with the
example's settings (shuffled, random crops and mirrors, the shorter side
resized to the largest image side + 32, the ImageNet means subtracted, 8
decode threads), else on ``--num-examples`` synthetic images.  A fit from
records records telemetry in memory (``MXNET_TELEMETRY_FUSED=1`` keeps
the fused path) and adds the fit loop's wait for each batch
(``data_wait``, ms, the mean over the batches after the first) and the
batch count to the JSON line.  ``MXNET_NORM_CONV=1`` runs the NormConv
kernel where the graph has a BatchNorm(+ReLU) before a bias-free 1x1/3x3
convolution (Inception-v3: 15 of its 94 convolutions).  TF32 is off.  Runs on
``gpu(0)`` (``--cpu`` for a toy run).  Prints one JSON line.
"""
import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models


def get_symbol(args):
    """The network ``args.network`` names (as the example's)."""
    name = args.network
    if name.startswith("resnet"):
        return models.resnet.get_symbol(
            num_classes=args.num_classes,
            num_layers=int(name[len("resnet"):] or 50),
            image_shape=args.image_shape)
    if name == "alexnet":
        return models.alexnet.get_symbol(num_classes=args.num_classes)
    if name == "inception-v3":
        return models.inception_v3.get_symbol(num_classes=args.num_classes)
    if name.startswith("vgg"):
        return models.vgg.get_symbol(num_classes=args.num_classes,
                                     num_layers=int(name[3:] or 16))
    raise ValueError("unknown network %s" % name)


def _shape(args):
    return tuple(int(x) for x in args.image_shape.split(","))


def synthetic(args, n, seed=0):
    """``n`` images uniform in [-1, 1] and labels, from ``seed``."""
    rs = np.random.RandomState(seed)
    data = rs.uniform(-1, 1, (n,) + _shape(args)).astype(np.float32)
    label = rs.randint(0, args.num_classes, (n,)).astype(np.float32)
    return data, label


def make_optimizer(args, batch):
    return mt.optimizer.create(args.optimizer, rescale_grad=1.0 / batch,
                               learning_rate=args.lr, momentum=0.9)


def benchmark(args, net, ctx):
    """Synthetic-data training throughput (the example's --benchmark 1):
    (img/s, ms a step)."""
    batch = args.batch_size
    dtype = "bfloat16" if args.dtype == "bfloat16" else None
    ts = mt.TrainStep(net, make_optimizer(args, batch), ctx=ctx,
                      dtype=dtype)
    params, state, aux = ts.init({"data": (batch,) + _shape(args)},
                                 {"softmax_label": (batch,)})
    data, label = synthetic(args, batch)
    dev_batch = ts.shard_batch({"data": data, "softmax_label": label})
    params, state, aux, outs = ts(params, state, aux, dev_batch)
    float(outs[0][0, 0])
    t0 = time.perf_counter()
    iters = args.benchmark_iters
    for _ in range(iters):
        params, state, aux, outs = ts(params, state, aux, dev_batch)
    float(outs[0][0, 0])
    dt = time.perf_counter() - t0
    ips = batch * iters / dt
    logging.info("benchmark: %s batch=%d %.2f img/s (%.1f ms/step)",
                 args.network, batch, ips, 1000 * dt / iters)
    return ips, 1000 * dt / iters


class BatchLoss(mt.metric.EvalMetric):
    """The cross-entropy of each batch's predictions, kept as device
    scalars, so that a fit's batch loop never waits for the card: ``get()``
    reports the mean since the last ``reset()`` (an epoch; the sum is a
    device scalar), ``values()`` every batch's since the metric was
    made."""

    def __init__(self, eps=1e-8):
        self.history = []
        super().__init__("batch-cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = pred.value
            idx = label.value.to(p.device).long().view(-1, 1)
            loss = -torch.log(p.gather(1, idx) + self.eps).mean().detach()
            self.history.append(loss)
            self.sum_metric = self.sum_metric + loss
            self.num_inst += 1

    def values(self):
        return [float(v) for v in self.history]


def record_iter(args, **kw):
    """``ImageRecordIter`` over ``args.data_train`` with the example's
    settings; ``kw`` overrides them."""
    shape = _shape(args)
    settings = dict(
        path_imgrec=args.data_train, path_imgidx=args.data_train_idx,
        data_shape=shape, batch_size=args.batch_size, shuffle=True,
        rand_crop=True, rand_mirror=True, resize=max(shape[1:]) + 32,
        mean_r=123.68, mean_g=116.78, mean_b=103.94, preprocess_threads=8)
    settings.update(kw)
    return mt.io.ImageRecordIter(**settings)


def fit(args, net, ctx, data=None, label=None, arg_params=None,
        aux_params=None, batch_end_callback=None, it=None):
    """``Module.fit`` for ``args.num_epochs`` over the iterator ``it``, or
    over synthetic images (or the given ``data`` and ``label``): (the
    Module, its BatchLoss)."""
    if it is None:
        if data is None:
            data, label = synthetic(args, args.num_examples)
        it = mt.io.NDArrayIter(data, label, batch_size=args.batch_size)
    mod = mt.Module(net, context=ctx)
    loss = BatchLoss()
    mod.fit(it, num_epoch=args.num_epochs, optimizer=args.optimizer,
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            eval_metric=loss, kvstore=args.kv_store, arg_params=arg_params,
            aux_params=aux_params,
            batch_end_callback=batch_end_callback or
            [mt.callback.Speedometer(args.batch_size, 20)])
    return mod, loss


def fit_records(args, net, ctx):
    """``fit`` from ``args.data_train`` with telemetry recording in memory
    on the fused path: (the BatchLoss, data_wait ms a batch over the
    batches after the first, the batch count)."""
    old = os.environ.get("MXNET_TELEMETRY_FUSED")
    os.environ["MXNET_TELEMETRY_FUSED"] = "1"
    mt.telemetry.start()
    try:
        _, loss = fit(args, net, ctx, it=record_iter(args))
        waits = [e["dur"] / 1e3 for e in mt.telemetry.events()
                 if e.get("type") == "span" and e["name"] == "data_wait"]
    finally:
        mt.telemetry.stop()
        if old is None:
            os.environ.pop("MXNET_TELEMETRY_FUSED", None)
        else:
            os.environ["MXNET_TELEMETRY_FUSED"] = old
    steady = waits[1:] or waits
    return loss, sum(steady) / max(len(steady), 1), len(waits)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="resnet50")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--benchmark", type=int, default=0)
    ap.add_argument("--benchmark-iters", type=int, default=20)
    ap.add_argument("--num-examples", type=int, default=128,
                    help="synthetic images of the Module.fit path")
    ap.add_argument("--data-train", default=None,
                    help="a RecordIO file from bench/im2rec.py")
    ap.add_argument("--data-train-idx", default=None)
    ap.add_argument("--kv-store", default="local")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (a toy run)")
    return ap


def main(argv=()):
    args = parser().parse_args(list(argv))
    logging.basicConfig(level=logging.INFO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = mt.cpu() if args.cpu else mt.gpu(0)
    net = get_symbol(args)
    rec = {"network": args.network, "batch": args.batch_size,
           "image_shape": args.image_shape, "dtype": args.dtype,
           "device": str(ctx),
           "norm_conv": mt.base.get_env("MXNET_NORM_CONV", "0") == "1"}
    if args.benchmark:
        rec["img_per_s"], rec["ms_per_step"] = benchmark(args, net, ctx)
    elif args.data_train:
        t0 = time.perf_counter()
        loss, rec["data_wait_ms"], rec["batches"] = fit_records(args, net,
                                                                ctx)
        rec["fit_seconds"] = time.perf_counter() - t0
        rec["batch_loss"] = loss.values()
    else:
        t0 = time.perf_counter()
        _, loss = fit(args, net, ctx)
        rec["fit_seconds"] = time.perf_counter() - t0
        rec["batch_loss"] = loss.values()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
