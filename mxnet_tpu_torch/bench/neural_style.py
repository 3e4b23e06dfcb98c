"""Neural style transfer: optimising the input image (the port's twin of
``examples/neural_style/neural_style.py``: the same networks, losses,
flags and defaults).

    python -m mxnet_tpu_torch.bench.neural_style            # 60 steps, card
    python -m mxnet_tpu_torch.bench.neural_style --cpu --steps 10

Nothing in the network trains.  The loss graph is bound with a gradient
buffer for ``data`` only (every weight at grad_req 'null'); its in-graph
loss compares Gram matrices and content features against fixed targets
fed as variables, and the pixels are updated imperatively by an Adam
updater (``optimizer.get_updater``) on the card.  As in the example, a
small random-feature network (Xavier, magnitude 2, from ``seed``) stands
in for the pretrained VGG-19, whose weights the repository does not hold;
``transfer(weights=...)`` takes the feature weights from elsewhere (a test
passes the JAX example's).  Runs on ``gpu(0)`` (``--cpu`` for a toy run).
Prints one JSON line: the first and last loss, steps/s, and the image's
path with ``--out``.
"""
import argparse
import json
import logging
import sys
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import sym

SIZE = 48
CHANNELS = (8, 16, 24)          # feature widths of the three levels


def feature_net():
    """Three conv levels; returns (symbol grouping the level outputs)."""
    x = sym.Variable("data")
    feats = []
    h = x
    for i, c in enumerate(CHANNELS):
        h = sym.Convolution(h, name="feat%d" % i, num_filter=c,
                            kernel=(3, 3), pad=(1, 1),
                            stride=(2, 2) if i else (1, 1), no_bias=True)
        h = sym.Activation(h, act_type="relu")
        feats.append(h)
    return sym.Group(feats)


def gram(feat, channels):
    """(1, C, H, W) feature map -> normalised (C, C) Gram matrix."""
    flat = sym.Reshape(feat, shape=(channels, -1))
    return sym.dot(flat, flat, transpose_b=True) / (channels * SIZE * SIZE)


def style_loss_net(content_weight=1.0, style_weight=50.0):
    """Scalar loss vs fixed targets fed as no-grad variables."""
    feats = feature_net()
    losses = []
    # content: match the deepest level's features directly
    tgt_c = sym.Variable("target_content")
    diff = feats[2] - tgt_c
    losses.append(content_weight * sym.sum(diff * diff))
    # style: match every level's Gram matrix
    for i, c in enumerate(CHANNELS):
        tgt_g = sym.Variable("target_gram%d" % i)
        gdiff = gram(feats[i], c) - tgt_g
        losses.append(style_weight * sym.sum(gdiff * gdiff))
    total = losses[0]
    for term in losses[1:]:
        total = total + term
    return sym.MakeLoss(total)


def _images(seed=0):
    """Synthetic content (soft blob) and style (diagonal stripes)."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    content = np.exp(-(((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05))
    stripes = 0.5 + 0.5 * np.sin((xx + yy) * 24.0)

    def to3(img):
        return np.stack([img, img * 0.8, 1.0 - img])[None].astype(np.float32)
    return to3(content), to3(stripes)


def feature_weights(seed=0, ctx=None):
    """The feature net's weights as the example draws them (Xavier,
    magnitude 2, after ``random.seed(seed)``): {name: float32 numpy}."""
    mt.random.seed(seed)
    feats = feature_net()
    shape = _images(seed)[0].shape
    fex = feats.simple_bind(ctx or mt.cpu(), grad_req="null", data=shape)
    init = mt.initializer.Xavier(magnitude=2.0)
    for name, arr in fex.arg_dict.items():
        if name != "data":
            init(mt.initializer.InitDesc(name), arr)
    return {n: a.asnumpy() for n, a in fex.arg_dict.items() if n != "data"}


def transfer(steps=60, lr=0.05, seed=0, log=None, ctx=None, weights=None):
    """Optimise the pixels for ``steps`` Adam steps on ``ctx`` (default
    ``gpu(0)``) from the feature ``weights`` (default
    ``feature_weights(seed)``): (the image as numpy, the loss of each
    step)."""
    log = log or logging.getLogger("neural_style")
    ctx = ctx or mt.gpu(0)
    content, style = _images(seed)
    shape = content.shape
    if weights is None:
        weights = feature_weights(seed)

    # 1. extract targets with a forward-only binding of the feature net
    fex = feature_net().simple_bind(ctx, grad_req="null", data=shape)
    for n, v in weights.items():
        fex.arg_dict[n][:] = v

    def run_feats(img):
        fex.forward(is_train=False, data=mt.nd.array(img, ctx=ctx))
        return [o.asnumpy() for o in fex.outputs]

    style_feats = run_feats(style)
    content_feats = run_feats(content)

    def gram_np(f):
        c = f.shape[1]
        flat = f.reshape(c, -1)
        return flat @ flat.T / (c * SIZE * SIZE)

    targets = {"target_content": content_feats[2]}
    for i, f in enumerate(style_feats):
        targets["target_gram%d" % i] = gram_np(f).astype(np.float32)

    # 2. bind the loss with a gradient ONLY for the image pixels
    net = style_loss_net()
    reqs = {n: "write" if n == "data" else "null"
            for n in net.list_arguments()}
    ex = net.simple_bind(ctx, grad_req=reqs, data=shape,
                         **{k: v.shape for k, v in targets.items()})
    for n, v in weights.items():
        ex.arg_dict[n][:] = v
    for n, v in targets.items():
        ex.arg_dict[n][:] = v

    # 3. optimise the pixels imperatively (Adam updater on the buffer)
    img = mt.nd.array(content + 0.1 *
                      np.random.RandomState(seed).randn(*shape)
                      .astype(np.float32), ctx=ctx)
    updater = mt.optimizer.get_updater(
        mt.optimizer.Adam(learning_rate=lr))
    history = []
    for step in range(steps):
        ex.arg_dict["data"][:] = img
        ex.forward(is_train=True)
        ex.backward()
        loss = float(ex.outputs[0].asnumpy().sum())
        history.append(loss)
        updater(0, ex.grad_dict["data"], img)
        if step % 10 == 0:
            log.info("step %d loss %.4f", step, loss)
    return img.asnumpy(), history


def main(argv=()):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", type=str, default=None,
                    help="save the stylised image here (.npy)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (a toy run)")
    args = ap.parse_args(list(argv))
    logging.basicConfig(level=logging.INFO)
    t0 = time.perf_counter()
    img, hist = transfer(steps=args.steps,
                         ctx=mt.cpu() if args.cpu else mt.gpu(0))
    secs = time.perf_counter() - t0
    if args.out:
        np.save(args.out, img)
    print(json.dumps({"steps": args.steps, "first_loss": hist[0],
                      "last_loss": hist[-1], "steps_per_s": args.steps / secs,
                      "out": args.out}))
    return 0 if hist[-1] < hist[0] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
