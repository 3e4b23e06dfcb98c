"""Train ImageNet-class networks with the port (the twin of
``examples/train_imagenet.py``: the same networks, flags and defaults).

    python -m mxnet_tpu_torch.bench.train_imagenet --network inception-v3 \\
        --image-shape 3,299,299 --benchmark 1
    python -m mxnet_tpu_torch.bench.train_imagenet --network vgg --benchmark 1
    python -m mxnet_tpu_torch.bench.train_imagenet --network inception-v3 \\
        --image-shape 3,299,299 --num-examples 256       # Module.fit
    python -m mxnet_tpu_torch.bench.train_imagenet --cpu --network vgg11 \\
        --num-classes 10 --image-shape 3,32,32 --batch-size 4 \\
        --benchmark 1 --benchmark-iters 2                 # a toy run

``--network`` takes ``resnet<depth>``, ``alexnet``, ``inception-v3`` and
``vgg<depth>`` (``vgg`` is VGG-16).  ``--benchmark 1`` trains on one
synthetic batch from ``RandomState(0)`` through ``TrainStep`` (SGD with
momentum 0.9, ``rescale_grad`` 1/batch): one warm step, then
``--benchmark-iters`` timed steps ending in the fetch of one scalar; it
prints img/s and ms a step.  Without it the network trains through
``Module.fit`` on ``--num-examples`` synthetic images (the real-data
reader, ``ImageRecordIter``, comes with the image slice: ``--data-train``
is refused), the per-batch cross-entropy kept on the card
(``BatchLoss``).  ``MXNET_NORM_CONV=1`` runs the NormConv kernel where
the graph has a BatchNorm(+ReLU) before a bias-free 1x1/3x3 convolution
(Inception-v3: 15 of its 94 convolutions).  TF32 is off.  Runs on
``gpu(0)`` (``--cpu`` for a toy run).  Prints one JSON line.
"""
import argparse
import json
import logging
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
    reports the mean since the last ``reset()`` (an epoch), ``values()``
    every batch's since the metric was made."""

    def __init__(self, eps=1e-8):
        self.history = []
        super().__init__("batch-cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = pred.value
            idx = label.value.to(p.device).long().view(-1, 1)
            self.history.append(
                -torch.log(p.gather(1, idx) + self.eps).mean().detach())
            self.num_inst += 1

    def get(self):
        if not self.num_inst:
            return self.name, float("nan")
        return self.name, float(torch.stack(
            self.history[-self.num_inst:]).mean())

    def values(self):
        return [float(v) for v in self.history]


def fit(args, net, ctx, data=None, label=None, arg_params=None,
        aux_params=None, batch_end_callback=None):
    """``Module.fit`` over synthetic images (or the given ``data`` and
    ``label``) for ``args.num_epochs``: (the Module, its BatchLoss)."""
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
                    help="a RecordIO file (refused: the image slice)")
    ap.add_argument("--data-train-idx", default=None)
    ap.add_argument("--kv-store", default="local")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (a toy run)")
    return ap


def main(argv=()):
    args = parser().parse_args(list(argv))
    logging.basicConfig(level=logging.INFO)
    if args.data_train:
        raise mt.MXNetError("--data-train needs ImageRecordIter, which comes "
                            "with the image slice; train on synthetic data "
                            "(--num-examples) or --benchmark 1")
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
    else:
        t0 = time.perf_counter()
        _, loss = fit(args, net, ctx)
        rec["fit_seconds"] = time.perf_counter() - t0
        rec["batch_loss"] = loss.values()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
