"""DCGAN: adversarial training with two Modules and imperative updates (the
port's twin of ``examples/gan/dcgan.py``: the same functions, flags and
defaults).

    python -m mxnet_tpu_torch.bench.dcgan                 # 3 epochs x 25
    python -m mxnet_tpu_torch.bench.dcgan --epochs 1 --steps 10
    python -m mxnet_tpu_torch.bench.dcgan --cpu --batch 8 --steps 4

It drives the symbolic and imperative mix end to end: a generator and a
discriminator, each a ``Module`` with its own Adam; the label flipped in
place (``label[:] = 0/1``) between forward passes of the same bound
discriminator; the discriminator's gradients of the fake and the real
batch added on its executor's gradient arrays (``grad += stash``) before
one ``update()``; the generator trained from the discriminator's input
gradients (``get_input_grads()`` fed to ``backward``).  The data are the
example's synthetic two-blob images.

Runs on ``gpu(0)`` (``--cpu`` for a toy run).  Prints one JSON line a run:
iterations/s over the iterations after the first, the host ms an
iteration (median; each iteration reads three outputs back, so the host
waits for the card), the last ``d_loss`` and ``g_loss``, and on the card
the device-busy share of two more iterations of the trained pair,
profiled, and the card's name and power limit.  ``--out`` saves 16 samples (``.npy``).
"""
import argparse
import json
import logging
import sys
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import sym
from mxnet_tpu_torch.bench.ssd_train import busy_share, card_name


def make_generator(code_dim=64, ngf=32, channels=1, fix_gamma=False,
                   eps=1e-5):
    """4x4 -> 8x8 -> 16x16 -> 32x32 transposed-conv stack, tanh output."""
    code = sym.Variable("code")
    h = sym.Deconvolution(code, name="g_up0", kernel=(4, 4),
                          num_filter=ngf * 4, no_bias=True)
    h = sym.BatchNorm(h, name="g_bn0", fix_gamma=fix_gamma, eps=eps)
    h = sym.Activation(h, act_type="relu")
    for i, nf in enumerate((ngf * 2, ngf)):
        h = sym.Deconvolution(h, name="g_up%d" % (i + 1), kernel=(4, 4),
                              stride=(2, 2), pad=(1, 1), num_filter=nf,
                              no_bias=True)
        h = sym.BatchNorm(h, name="g_bn%d" % (i + 1), fix_gamma=fix_gamma,
                          eps=eps)
        h = sym.Activation(h, act_type="relu")
    h = sym.Deconvolution(h, name="g_out", kernel=(4, 4), stride=(2, 2),
                          pad=(1, 1), num_filter=channels, no_bias=True)
    return sym.Activation(h, act_type="tanh")


def make_discriminator(ndf=32, fix_gamma=False, eps=1e-5):
    """32x32 -> 1 logit; LogisticRegressionOutput gives sigmoid + BCE grad."""
    x = sym.Variable("data")
    h = sym.Convolution(x, name="d_c0", kernel=(4, 4), stride=(2, 2),
                        pad=(1, 1), num_filter=ndf, no_bias=True)
    h = sym.LeakyReLU(h, act_type="leaky", slope=0.2)
    for i, nf in enumerate((ndf * 2, ndf * 4)):
        h = sym.Convolution(h, name="d_c%d" % (i + 1), kernel=(4, 4),
                            stride=(2, 2), pad=(1, 1), num_filter=nf,
                            no_bias=True)
        h = sym.BatchNorm(h, name="d_bn%d" % (i + 1), fix_gamma=fix_gamma,
                          eps=eps)
        h = sym.LeakyReLU(h, act_type="leaky", slope=0.2)
    h = sym.Convolution(h, name="d_out", kernel=(4, 4), num_filter=1,
                        no_bias=True)
    return sym.LogisticRegressionOutput(sym.Flatten(h), name="dloss")


def blob_batches(batch, steps, size=32, seed=0):
    """Synthetic 'real' images: soft two-blob fields in [-1, 1] — enough
    structure for the discriminator to separate from early noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for _ in range(steps):
        imgs = np.empty((batch, 1, size, size), np.float32)
        for b in range(batch):
            cx, cy = rs.rand(2) * 0.5 + 0.25
            r = 0.08 + 0.1 * rs.rand()
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / r ** 2))
            imgs[b, 0] = blob * 2.0 - 1.0
        yield imgs


def _cast(mod, dtype):
    """Every array of ``mod``'s executors (arguments, gradients, auxiliary
    states) rebound at ``dtype``: what follows runs in it, the optimizer's
    states too.  (The Module binds float32; a float64 run is the parity
    checks' reference.)"""
    for ex in mod._exec_group.execs:
        for arr in list(ex.arg_dict.values()) + list(ex.aux_dict.values()) \
                + list(ex.grad_dict.values()):
            arr._set_value(arr.value.to(mt.base.torch_dtype(dtype)))


def bce(pred, target):
    p = np.clip(pred.reshape(-1), 1e-6, 1 - 1e-6)
    return float(-np.mean(target * np.log(p)
                          + (1 - target) * np.log(1 - p)))


def iterate(mod_g, mod_d, label, code, real):
    """One iteration of the example's loop on numpy ``code`` and ``real``:
    the discriminator's step (fake then real, gradients folded), then the
    generator's.  Returns D's outputs (as numpy) on the fake, the real and
    the fake again.  The numpy inputs go in at the Modules' dtype (float32
    unless ``train`` cast them)."""
    ctx = mod_g._exec_group.contexts[0]
    dt = mod_g._exec_group.execs[0].arg_dict["code"].dtype
    mod_g.forward(mt.io.DataBatch(data=[mt.nd.array(code, ctx=ctx,
                                                    dtype=dt)],
                                  label=[]), is_train=True)
    fake = mod_g.get_outputs()[0]

    # --- discriminator on the fake half: backward, stash grads
    label[:] = 0.0
    mod_d.forward(mt.io.DataBatch(data=[fake], label=[label]),
                  is_train=True)
    mod_d.backward()
    stash = [[g.copyto(g.context) if g is not None else None
              for g in per_arg]
             for per_arg in mod_d._exec_group.grad_arrays]
    p_fake = mod_d.get_outputs()[0].asnumpy()

    # --- discriminator on the real half: backward, then fold the stashed
    # fake-half gradients in imperatively and step once
    label[:] = 1.0
    mod_d.forward(mt.io.DataBatch(data=[mt.nd.array(real, ctx=ctx,
                                                    dtype=dt)],
                                  label=[label]), is_train=True)
    mod_d.backward()
    for per_arg, stashed in zip(mod_d._exec_group.grad_arrays, stash):
        for g, s in zip(per_arg, stashed):
            if g is not None and s is not None:
                g += s
    mod_d.update()
    p_real = mod_d.get_outputs()[0].asnumpy()

    # --- generator: D(fake) labelled real; chain D's input grads
    label[:] = 1.0
    mod_d.forward(mt.io.DataBatch(data=[fake], label=[label]),
                  is_train=True)
    mod_d.backward()
    mod_g.backward(mod_d.get_input_grads())
    mod_g.update()
    p_gen = mod_d.get_outputs()[0].asnumpy()
    return p_fake, p_real, p_gen


def train(epochs=1, batch=32, steps_per_epoch=25, code_dim=64, lr=2e-4,
          seed=0, log=None, ctx=None, params=None, dtype="float32"):
    """The example's loop.  ``ctx`` defaults to ``gpu(0)``.  ``params``
    ({name: numpy} over both networks' parameters and moving statistics)
    replaces the ``Normal(0.02)`` initialisation; ``dtype`` other than
    float32 casts both Modules after it.  Returns (mod_g, mod_d, history:
    each iteration's d_loss, g_loss and wall seconds)."""
    log = log or logging.getLogger("dcgan")
    rs = np.random.RandomState(seed + 1)
    mt.random.seed(seed)   # deterministic init: same seed => same G/D start
    ctx = ctx if ctx is not None else mt.gpu(0)

    def module(net, data, label):
        mod = mt.Module(net, data_names=(data[0],),
                        label_names=(label[0],) if label else None,
                        context=ctx)
        mod.bind(data_shapes=[data], label_shapes=[label] if label else None,
                 inputs_need_grad=True)
        if params is None:
            mod.init_params(mt.initializer.Normal(0.02))
        else:
            args, auxs = mod._exec_group.execs[0].arg_dict, \
                mod._exec_group.execs[0].aux_dict
            mod.init_params(arg_params={n: mt.nd.array(params[n], ctx=ctx)
                                        for n in args if n in params},
                            aux_params={n: mt.nd.array(params[n], ctx=ctx)
                                        for n in auxs})
        if dtype != "float32":
            _cast(mod, dtype)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": lr,
                                             "beta1": 0.5, "wd": 0.0})
        return mod

    mod_g = module(make_generator(code_dim=code_dim),
                   ("code", (batch, code_dim, 1, 1)), None)
    mod_d = module(make_discriminator(), ("data", (batch, 1, 32, 32)),
                   ("dloss_label", (batch, 1)))

    # imperative label buffer, flipped in place between D passes
    label = mt.nd.zeros((batch, 1), ctx=ctx, dtype=dtype)
    history = {"d_loss": [], "g_loss": [], "seconds": []}

    for epoch in range(epochs):
        for it, real in enumerate(blob_batches(batch, steps_per_epoch,
                                               seed=seed + epoch)):
            t0 = time.perf_counter()
            code = rs.randn(batch, code_dim, 1, 1).astype(np.float32)
            p_fake, p_real, p_gen = iterate(mod_g, mod_d, label, code, real)
            d_loss = 0.5 * (bce(p_fake, 0.0) + bce(p_real, 1.0))
            g_loss = bce(p_gen, 1.0)
            history["d_loss"].append(d_loss)
            history["g_loss"].append(g_loss)
            history["seconds"].append(time.perf_counter() - t0)
            if it % 10 == 0:
                log.info("epoch %d iter %d  d_loss %.4f  g_loss %.4f",
                         epoch, it, d_loss, g_loss)
    return mod_g, mod_d, history


def sample(mod_g, n, code_dim=64, seed=123):
    """Generate n images with the trained generator (forward, is_train
    False so BN uses its moving statistics)."""
    code = np.random.RandomState(seed).randn(n, code_dim, 1, 1) \
        .astype(np.float32)
    ctx = mod_g._exec_group.contexts[0]
    mod_g.forward(mt.io.DataBatch(data=[mt.nd.array(code, ctx=ctx)],
                                  label=[]), is_train=False)
    return mod_g.get_outputs()[0].asnumpy()


def run(epochs=1, batch=32, steps=25, code_dim=64, lr=2e-4, seed=0,
        ctx=None):
    """One ``train``: (record dict, mod_g, mod_d, history)."""
    ctx = ctx if ctx is not None else mt.gpu(0)
    dev = ctx.torch_device()
    card = dev.type == "cuda"
    t0 = time.perf_counter()
    mod_g, mod_d, hist = train(epochs, batch, steps, code_dim, lr, seed,
                               ctx=ctx)
    seconds = time.perf_counter() - t0
    steady = hist["seconds"][1:] or hist["seconds"]
    rec = {
        "metric": "dcgan_iterations_per_sec_b%d" % batch,
        "value": len(steady) / sum(steady), "unit": "iterations/s",
        "host_ms_per_iteration": float(np.median(steady)) * 1e3,
        "first_iteration_ms": hist["seconds"][0] * 1e3,
        "train_seconds": seconds, "iterations": len(hist["seconds"]),
        "d_loss": hist["d_loss"][-1], "g_loss": hist["g_loss"][-1],
        "config": {"batch": batch, "code_dim": code_dim, "ngf": 32,
                   "ndf": 32, "image": [1, 32, 32], "lr": lr, "beta1": 0.5,
                   "epochs": epochs, "steps": steps, "device": str(dev)}}
    if card:
        # two more iterations of the trained pair, profiled
        rs = np.random.RandomState(seed + 2)
        label = mt.nd.zeros((batch, 1), ctx=ctx)
        more = [(rs.randn(batch, code_dim, 1, 1).astype(np.float32), real)
                for real in blob_batches(batch, 2, seed=seed + epochs)]
        rec["device_busy_share"], rec["profiled_launches"] = busy_share(
            lambda: [iterate(mod_g, mod_d, label, c, r) for c, r in more],
            dev)
        rec["card"] = card_name()
    return rec, mod_g, mod_d, hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--out", type=str, default="",
                    help="save 16 samples here (.npy); none by default")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (a toy run)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rec, mod_g, _, _ = run(args.epochs, args.batch, args.steps,
                           ctx=mt.cpu() if args.cpu else None)
    if args.out:
        np.save(args.out, sample(mod_g, 16))
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
