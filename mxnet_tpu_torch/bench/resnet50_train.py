"""ResNet-50 training throughput of the port on one card (the twin of
``bench.py``'s ``bench_resnet50_train``).

    python -m mxnet_tpu_torch.bench.resnet50_train                 # bf16 AMP
    MXNET_AMP=0 python -m mxnet_tpu_torch.bench.resnet50_train     # bf16 cast
    python -m mxnet_tpu_torch.bench.resnet50_train --dtype float32
    MXNET_NORM_CONV=1 python -m mxnet_tpu_torch.bench.resnet50_train

The setup is ``bench.py``'s: ResNet-50 v2 (1000 classes, 3x224x224), batch
32 of synthetic data from ``RandomState(0)``, ``TrainStep`` with
``SGD(0.1, momentum 0.9, wd 1e-4, rescale_grad 1/batch)``.  One warm
``run_steps(chunk)`` (chunk + 1 steps), then ``rounds`` timed ones, and one
scalar of the outputs fetched at the end.  TF32 is off.

Precision, as ``bench.py`` chooses it: by default the policy of
``amp.resolve_policy(default=Policy("bfloat16"))``, bfloat16 compute with
float32 master weights and dynamic loss scaling (``MXNET_AMP`` and
``MXNET_LOSS_SCALE`` tune it; ``MXNET_AMP=0`` gives the pure bfloat16
cast, ``dtype="bfloat16"``), metric ``resnet50_train_img_per_sec_b32``.
``--dtype float32`` trains in float32, metric
``resnet50_train_img_per_sec_b32_f32``.  The graph is the one
``MXNET_NORM_CONV`` selects: unfused by default (0, as in the JAX
package), or the fused NormConv path (1: the NormConv kernel runs 52
convolutions of each step's forward, 32 of them with the statistics of the
next BatchNorm), whose metric gains ``_normconv``.  The stem fuse
(``MXNET_STEM_FUSE``, default on as in the JAX package) runs in both.
Runs on ``gpu(0)``.  Prints one JSON line with ``bench.py``'s keys:
``metric``, ``value`` (img/s), ``unit`` and ``vs_baseline`` (against the
published P100 figure ``bench.py`` uses, 181.53 img/s), plus the
``config``, whose ``amp`` is the policy's ``describe()`` or None.
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

BASELINE_P100 = 181.53
METRIC = "resnet50_train_img_per_sec_b32"
METRIC_F32 = METRIC + "_f32"


def setup(batch=32, image=224, num_layers=50, num_classes=1000, ctx=None,
          policy=None, dtype=None):
    """The trainer and its state as ``bench.py`` builds them (``policy``
    and ``dtype`` go to ``TrainStep``): returns (TrainStep, params,
    opt_state, aux, the batch on the step's device)."""
    import mxnet_tpu_torch as mt
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = mt.models.resnet.get_symbol(num_classes, num_layers,
                                      "3,%d,%d" % (image, image))
    opt = mt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                           rescale_grad=1.0 / batch, wd=1e-4)
    ts = mt.TrainStep(net, opt, ctx=ctx, policy=policy, dtype=dtype)
    params, state, aux = ts.init({"data": (batch, 3, image, image)},
                                 {"softmax_label": (batch,)})
    rng = np.random.RandomState(0)
    data = rng.uniform(-1, 1, (batch, 3, image, image)).astype(np.float32)
    label = rng.randint(0, num_classes, (batch,)).astype(np.float32)
    dev_batch = ts.shard_batch({"data": data, "softmax_label": label})
    return ts, params, state, aux, dev_batch


def timed_chunks(ts, params, state, aux, batch, chunk=40, rounds=10):
    """One warm ``run_steps(chunk)``, then ``rounds`` timed ones ending in
    the fetch of one scalar.  Returns (img/s, host seconds of the timed
    rounds, the last outputs)."""
    params, state, aux, outs = ts.run_steps(params, state, aux, batch, chunk)
    float(outs[0][0, 0])
    t0 = time.perf_counter()
    for _ in range(rounds):
        params, state, aux, outs = ts.run_steps(params, state, aux, batch,
                                                chunk)
    float(outs[0][0, 0])
    dt = time.perf_counter() - t0
    n = batch["data"].shape[0]
    return n * (chunk + 1) * rounds / dt, dt, outs


def bench_resnet50_train(batch=32, image=224, chunk=40, rounds=10,
                         num_layers=50, num_classes=1000, ctx=None,
                         policy=None, dtype=None):
    """img/s of ``TrainStep`` over ``rounds`` timed chunks of ``chunk`` + 1
    steps (``ctx``: the device, ``gpu(0)`` by default)."""
    ts, params, state, aux, dev_batch = setup(batch, image, num_layers,
                                              num_classes, ctx, policy,
                                              dtype)
    img_per_sec, _, _ = timed_chunks(ts, params, state, aux, dev_batch,
                                     chunk, rounds)
    return img_per_sec


def record(img_per_sec, config, fused=False):
    """The JSON record of one run (``fused``: MXNET_NORM_CONV=1); the
    metric follows ``config["dtype"]``."""
    metric = METRIC if config["dtype"] == "bfloat16" else METRIC_F32
    return {"metric": metric + ("_normconv" if fused else ""),
            "value": round(img_per_sec, 2), "unit": "img/s",
            "vs_baseline": round(img_per_sec / BASELINE_P100, 3),
            "config": config}


def precision(dtype):
    """(policy, cast dtype) of a run: bench.py's bf16 policy by default
    (``MXNET_AMP=0``: the pure bf16 cast), nothing for float32."""
    from mxnet_tpu_torch import amp
    if dtype == "float32":
        return None, None
    policy = amp.resolve_policy(default=amp.Policy("bfloat16"))
    return policy, (None if policy is not None else "bfloat16")


def main(argv=()):
    import mxnet_tpu_torch as mt
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(list(argv))
    policy, dtype = precision(args.dtype)
    config = dict(batch=32, image=224, chunk=40, rounds=10, num_layers=50,
                  num_classes=1000, dtype=args.dtype,
                  amp=policy.describe() if policy is not None else None,
                  device="gpu(0)")
    img_per_sec = bench_resnet50_train(ctx=mt.gpu(0), policy=policy,
                                       dtype=dtype)
    fused = mt.base.get_env("MXNET_NORM_CONV", "0") == "1"
    print(json.dumps(record(img_per_sec, config, fused)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
