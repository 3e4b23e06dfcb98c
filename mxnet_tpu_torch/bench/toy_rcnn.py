"""The toy Faster R-CNN trained through ``Module.fit`` (the port's twin of
``examples/rcnn/train_toy_rcnn.py``: the same functions, defaults and
assertion).

    python -m mxnet_tpu_torch.bench.toy_rcnn              # the card
    python -m mxnet_tpu_torch.bench.toy_rcnn --cpu --epochs 2

Synthetic task: each 1-channel 64x64 image holds one bright square; the
label is its size class (small or large).  One symbol holds a stride-8
backbone, an RPN head (objectness and box deltas), ``Proposal`` (8
post-NMS ROIs an image from 64 pre-NMS rows, one band of the NMS kernels:
a mask launch and a scan launch a forward on the card), ``ROIPooling``
over the backbone's features and a classifier, trained with two losses
(the classifier's softmax and an objectness ``MakeLoss`` toward a centre
heat map).  The fit is the example's: batch 8, 192 images, Adam at 1e-3
with ``rescale_grad`` 1/8, ``Xavier(magnitude=2)``, ``metric.np`` on the
classifier head with ``allow_extra_outputs``; then ``Module.score`` on the
same images.  With the example's 12 epochs the accuracy must exceed 0.8.
That bound sits inside the spread over initial parameters (``run``'s
``seed``): on the host the JAX example scores 0.734-0.922 over its seeds
0-4 (0.802 at its default) and this twin 0.797-0.974 (0.797 at seed 0).

Runs on ``gpu(0)`` (``--cpu``: the host).  Prints one JSON line: the
accuracy (and the training accuracy and mean objectness loss of each
epoch), images/s in steady state (the batches after each epoch's first,
over the gaps between their batch ends) and over the fit's wall time, the
host ms a batch (median gap), whether ``Module.fit`` took the fused
``TrainStep`` path, ``contrib.nms_launches`` of the fit and of the score
(0 on the host, whose NMS is the plain loop) and a forward's; on the card
also peak memory, the device-busy share of one more epoch profiled, and
the card's name and power limit.
"""
import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench.ssd_train import busy_share, card_name
from mxnet_tpu_torch.ops import contrib

BATCH = 8
SIZE = 64
IMAGES = 192
EPOCHS = 12


def make_data(n, size=64, rng=None):
    rng = rng or np.random.RandomState(0)
    x = rng.rand(n, 1, size, size).astype(np.float32) * 0.1
    labels = np.zeros((n,), np.float32)
    heat = np.zeros((n, 1, size // 8, size // 8), np.float32)
    for i in range(n):
        big = rng.randint(0, 2)
        side = rng.randint(18, 26) if big else rng.randint(6, 12)
        y0 = rng.randint(0, size - side)
        x0 = rng.randint(0, size - side)
        x[i, 0, y0:y0 + side, x0:x0 + side] += 1.0
        labels[i] = big
        cy, cx = (y0 + side // 2) // 8, (x0 + side // 2) // 8
        heat[i, 0, cy, cx] = 1.0
    return x, labels, heat


def build_symbol(batch, num_anchors=6):
    data = mt.sym.Variable("data")
    # backbone: stride-8 feature map
    body = data
    for i, nf in enumerate((8, 16, 32)):
        body = mt.sym.Convolution(body, kernel=(3, 3), stride=(2, 2),
                                  pad=(1, 1), num_filter=nf,
                                  name="conv%d" % i)
        body = mt.sym.Activation(body, act_type="relu", name="relu%d" % i)
    # RPN head
    rpn = mt.sym.Convolution(body, kernel=(3, 3), pad=(1, 1), num_filter=16,
                             name="rpn_conv")
    rpn = mt.sym.Activation(rpn, act_type="relu", name="rpn_relu")
    rpn_cls = mt.sym.Convolution(rpn, kernel=(1, 1),
                                 num_filter=2 * num_anchors,
                                 name="rpn_cls_score")
    rpn_bbox = mt.sym.Convolution(rpn, kernel=(1, 1),
                                  num_filter=4 * num_anchors,
                                  name="rpn_bbox_pred")
    # objectness probabilities for Proposal: softmax over {bg, fg}
    cls_resh = mt.sym.Reshape(rpn_cls, shape=(0, 2, -1), name="rpn_resh")
    cls_prob = mt.sym.softmax(cls_resh, axis=1, name="rpn_prob")
    cls_prob = mt.sym.Reshape(cls_prob,
                              shape=(batch, 2 * num_anchors, 8, 8),
                              name="rpn_prob_resh")
    im_info = mt.sym.Variable("im_info")
    rois = mt.sym.Proposal(
        cls_prob=cls_prob, bbox_pred=rpn_bbox, im_info=im_info,
        feature_stride=8, scales=(2, 4), ratios=(0.5, 1, 2),
        rpn_pre_nms_top_n=64, rpn_post_nms_top_n=8, threshold=0.7,
        rpn_min_size=4, name="proposal")
    # ROI features -> classifier
    pooled = mt.sym.ROIPooling(mt.sym.BlockGrad(body),
                               mt.sym.BlockGrad(rois),
                               pooled_size=(4, 4), spatial_scale=1.0 / 8,
                               name="roi_pool")
    # (post_nms * batch, C, 4, 4) -> pool over ROIs per image via reshape
    flat = mt.sym.Flatten(mt.sym.Reshape(pooled, shape=(batch, -1)),
                          name="roi_flat")
    fc = mt.sym.FullyConnected(flat, num_hidden=32, name="fc1")
    fc = mt.sym.Activation(fc, act_type="relu", name="fc_relu")
    cls = mt.sym.FullyConnected(fc, num_hidden=2, name="cls")
    label = mt.sym.Variable("softmax_label")
    cls_loss = mt.sym.SoftmaxOutput(cls, label, name="softmax")
    # RPN objectness auxiliary loss: push the fg map toward the heat target
    heat = mt.sym.Variable("rpn_heat")
    fg = mt.sym.slice_axis(cls_prob, axis=1, begin=num_anchors,
                           end=num_anchors + 1, name="fg_slice")
    rpn_loss = mt.sym.MakeLoss(
        mt.sym.mean(mt.sym.square(fg - heat)), grad_scale=8.0,
        name="rpn_loss")
    return mt.sym.Group([cls_loss, rpn_loss])


def head_acc(label, pred):
    """The classifier head's accuracy (the Group's first output)."""
    return float((pred.argmax(axis=1) == label).mean())


def _iter(x, y, heat):
    im_info = np.tile(np.array([[SIZE, SIZE, 1.0]], np.float32),
                      (len(x), 1))
    return mt.io.NDArrayIter({"data": x, "im_info": im_info,
                              "rpn_heat": heat}, {"softmax_label": y},
                             batch_size=BATCH)


def run(epochs=EPOCHS, ctx=None, seed=0, profile=True):
    """The example's fit and score on ``ctx`` (default gpu(0)): (record,
    Module).  ``np.random`` and the port's generators are seeded with
    ``seed`` before the data are drawn, as the example seeds numpy; the
    initial parameters come from the port's generator.  On the card,
    ``profile`` adds the profiled epoch."""
    ctx = ctx if ctx is not None else mt.gpu(0)
    dev = ctx.torch_device()
    card = dev.type == "cuda"
    np.random.seed(seed)
    mt.random.seed(seed)
    x, y, heat = make_data(IMAGES, SIZE)
    net = build_symbol(BATCH)
    mod = mt.Module(net, data_names=("data", "im_info", "rpn_heat"),
                    label_names=("softmax_label",), context=ctx)
    metric = mt.metric.np(head_acc, name="accuracy",
                          allow_extra_outputs=True)
    gaps, last, train_acc, rpn_loss = [], [None], [], []
    loss_sum = [0.0, 0]

    def batch_end(param):
        now = time.perf_counter()
        if last[0] is not None:
            gaps.append((now - last[0]) * 1e3)
        last[0] = now
        # the objectness loss summed where it lies: no host read a batch
        # (the fused step's outputs; the executor's on the general path)
        outs = param.locals.get("outputs") or mod.get_outputs()
        loss_sum[0] = loss_sum[0] + outs[1].value.detach().sum()
        loss_sum[1] += 1

    def epoch_end(epoch, symbol, arg, aux):
        train_acc.append(metric.get()[1])
        rpn_loss.append(float(loss_sum[0]) / loss_sum[1])
        loss_sum[:] = [0.0, 0]
        last[0] = None              # the epoch's end work is not a batch
    fit_kw = dict(optimizer="adam",
                  optimizer_params={"learning_rate": 1e-3,
                                    "rescale_grad": 1.0 / BATCH},
                  eval_metric=metric)
    if card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    n0 = contrib.nms_launches
    t0 = time.perf_counter()
    mod.fit(_iter(x, y, heat), num_epoch=epochs,
            initializer=mt.initializer.Xavier(magnitude=2.0),
            batch_end_callback=batch_end, epoch_end_callback=epoch_end,
            **fit_kw)
    if card:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    fit_launches = contrib.nms_launches - n0
    n0 = contrib.nms_launches
    score = mod.score(_iter(x, y, heat), metric)
    score_launches = contrib.nms_launches - n0
    acc = dict(score)["accuracy"]
    batches = IMAGES // BATCH
    rec = {
        "metric": "toy_rcnn_train_img_per_sec_b%d" % BATCH,
        "value": len(gaps) * BATCH / (sum(gaps) * 1e-3),
        "unit": "images/s", "accuracy": acc, "train_accuracy": train_acc,
        "rpn_loss": rpn_loss,
        "fit_img_per_s": epochs * IMAGES / seconds,
        "fit_seconds": seconds, "host_ms_per_batch": float(np.median(gaps)),
        "fused_path": mod._fused_ts_cache is not None,
        "nms_launches_fit": fit_launches,
        "nms_launches_score": score_launches,
        "nms_launches_per_forward": score_launches / batches,
        "config": {"batch": BATCH, "images": IMAGES, "size": SIZE,
                   "epochs": epochs, "pre_nms": 64, "post_nms": 8,
                   "seed": seed, "device": str(dev)}}
    if card:
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["card"] = card_name()
    if card and profile:
        # one more epoch after the score: its parameters are not used
        rec["device_busy_share"], rec["profiled_launches"] = busy_share(
            lambda: mod.fit(_iter(x, y, heat), num_epoch=1,
                            **fit_kw), dev)
    return rec, mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rec, _ = run(args.epochs, mt.cpu() if args.cpu else None)
    print(json.dumps(rec))
    acc = rec["accuracy"]
    print("toy rcnn train accuracy: %.3f" % acc)
    if args.epochs >= EPOCHS:
        assert acc > 0.8, "detection head did not learn (%.3f)" % acc
        print("PASS")


if __name__ == "__main__":
    sys.exit(main())
