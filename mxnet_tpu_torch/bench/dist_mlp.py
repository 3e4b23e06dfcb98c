"""Data-parallel training over the ranks of a world through
``Module.fit(kvstore="dist_sync")`` (the port's twin of
``tests/python/dist/dist_mlp.py``; ``--network resnet50`` trains ResNet-50
v2 at full width the same way):

    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.dist_mlp [--out DIR]
    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.dist_mlp --network resnet50 \\
        --ctx gpu --batch 16 --batches 3 --epochs 1 --params P --out DIR

Each rank fits its half of the data (rank r: rows ``[r n / w, (r + 1) n /
w)``) from the same initial parameters (``--params``: a ``.params`` file
of ``arg:`` / ``aux:`` entries; otherwise ``random.seed(7)`` and the
module's initializer on every rank), SGD with momentum on the store; the
gradients are summed across the ranks at every push, so the replicas stay
equal.  The MLP runs on the reference's separable blobs (400 rows of 32
features, 4 classes, batch 25 a rank) and must score above 0.9 on the whole
set; ResNet-50 runs on seeded synthetic images (``--batches`` batches of
``--batch`` a rank, 3x224x224, 1000 classes unless ``--image`` /
``--classes`` say otherwise).  On the card TF32 is off.  Then, as the
reference checks, the mean over the ranks of the flattened parameters
equals each rank's own.

``--out DIR`` writes ``rank<r>.params`` (the final parameters and aux
states) and ``rank<r>.json``; every rank prints its JSON line: accuracy
(MLP), img/s of the world, host ms a batch (median after the first), the
host ms a batch of ``Module.update`` (the pushes, the store's updates and
the pulls; the card drained at its entry and exit) and of the collectives
inside the fit, the ms of one batch's pushes timed alone (the parameters'
shapes, one collective a key), NormConv
launches a step (``MXNET_NORM_CONV=1``), and the route.  ``--ckpt DIR``
then saves a seed-0 ``TrainStep`` state of the MLP after one step through
an asynchronous ``checkpoint.Checkpointer`` under ``DIR/ck``: the ranks
write its shard files round-robin.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import dist

N, NC, DIM = 400, 4, 32


def blobs():
    """The reference's data: the same on every rank."""
    rng = np.random.RandomState(0)
    centers = rng.randn(NC, DIM) * 3
    y = rng.randint(0, NC, N)
    x = (centers[y] + rng.randn(N, DIM)).astype(np.float32)
    return x, y.astype(np.float32)


def images(batch, batches, world, image=224, classes=1000, seed=0):
    """Seeded synthetic images and labels for the whole world."""
    rng = np.random.default_rng(seed)
    n = batch * batches * world
    x = rng.uniform(-1, 1, (n, 3, image, image)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.float32)
    return x, y


def half(x, y, rank, world):
    """Rank r's rows: the r-th of ``world`` equal blocks."""
    n = x.shape[0]
    sl = slice(rank * n // world, (rank + 1) * n // world)
    return x[sl], y[sl]


def network(name, image=224, classes=1000):
    if name == "mlp":
        return mt.models.get_mlp(num_classes=NC)
    return mt.models.resnet.get_symbol(classes, 50,
                                       "3,%d,%d" % (image, image))


def load_params(path):
    """(arg_params, aux_params) of a ``.params`` file, on the host."""
    raw = mt.nd.load(path, ctx=mt.cpu())
    args = {k[4:]: v for k, v in raw.items() if k.startswith("arg:")}
    aux = {k[4:]: v for k, v in raw.items() if k.startswith("aux:")}
    return args, aux


def push_ms(mod, reps=3):
    """Host ms of one batch's pushes timed alone: a dist.allreduce_arrays
    call a parameter, on gradient-shaped tensors of the module's device,
    the card synchronised before and after; the median of ``reps``."""
    import torch
    grads = [g[0].value for g in mod._exec_group.grad_arrays
             if g[0] is not None]
    cuda = grads[0].is_cuda
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in grads:
            dist.allreduce_arrays([g])
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], len(grads)


def checkpoint_save(out):
    """One step of a seed-0 TrainStep state of the MLP, saved through an
    asynchronous Checkpointer (the writer thread meets its peers on the
    store); returns the checkpoint's directory."""
    ts = mt.TrainStep(mt.models.get_mlp(num_classes=NC),
                      mt.optimizer.SGD(learning_rate=0.1, momentum=0.9),
                      ctx=mt.cpu())
    p, s, a = ts.init({"data": (8, DIM)}, {"softmax_label": (8,)}, seed=0)
    x, y = blobs()
    ts(p, s, a, {"data": x[:8], "softmax_label": y[:8]})
    ck = mt.checkpoint.Checkpointer(os.path.join(out, "ck"), async_=True)
    path = ck.save(ts, p, s, a, epoch=0, nbatch=0)
    ck.close()
    return path


def run(args):
    from mxnet_tpu_torch.ops import norm_conv as nc
    dist.init_process_group()
    rank, world = dist.rank(), dist.num_workers()
    import torch
    if args.ctx == "cpu":
        ctx = mt.cpu()
    else:
        # float32 means float32 on the card: no TF32 in cuDNN or cuBLAS
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ctx = mt.gpu(dist.local_rank() if dist.route() == "nccl" else 0)
    if args.network == "mlp":
        x, y = blobs()
        batch = args.batch or 25
    else:
        batch = args.batch or 16
        x, y = images(batch, args.batches, world, args.image, args.classes)
    xs, ys = half(x, y, rank, world)
    it = mt.io.NDArrayIter(xs, ys, batch_size=batch)
    arg_params = aux_params = None
    if args.params:
        arg_params, aux_params = load_params(args.params)
    else:
        mt.random.seed(7)
    mod = mt.Module(network(args.network, args.image, args.classes),
                    context=ctx)
    marks = []
    upd = [0.0]
    cuda = args.ctx == "gpu"

    def timed_update(real=mod.update):
        # the update's host time: the card drained at entry (the backward
        # is not counted) and at exit
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        real()
        if cuda:
            torch.cuda.synchronize()
        upd[0] += time.perf_counter() - t0
    mod.update = timed_update
    nc.launches = nc.stats_launches = 0
    calls0 = dist.collective_calls.get("all_reduce", 0)
    secs0 = dist.collective_seconds.get("all_reduce", 0.0)
    mod.fit(it, num_epoch=args.epochs, kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            arg_params=arg_params, aux_params=aux_params,
            batch_end_callback=lambda p: marks.append(time.perf_counter()))
    steps = len(marks)
    res = {"rank": rank, "world": world, "route": dist.route(),
           "network": args.network, "batch": batch, "steps": steps,
           "nc_launches": nc.launches, "nc_stats_launches": nc.stats_launches,
           "collective_calls":
               dist.collective_calls.get("all_reduce", 0) - calls0,
           "collective_ms_per_batch":
               (dist.collective_seconds.get("all_reduce", 0.0) - secs0)
               * 1e3 / max(1, steps),
           "update_ms_per_batch": upd[0] * 1e3 / max(1, steps)}
    gaps = np.diff(marks) * 1e3
    if len(gaps):
        res["host_ms_per_batch"] = float(np.median(gaps))
        res["img_per_s"] = world * batch * 1e3 / res["host_ms_per_batch"]
    res["push_alone_ms"], res["keys"] = push_ms(mod)
    checks = {}
    if args.network == "mlp":
        val = mt.io.NDArrayIter(x, y, batch_size=batch)
        res["accuracy"] = float(mod.score(val, "acc")[0][1])
        checks["accuracy"] = res["accuracy"] > 0.9
    params, aux = mod.get_params()
    digest = np.concatenate([params[k].asnumpy().ravel()
                             for k in sorted(params)])
    merged = dist.allreduce(mt.nd.array(digest, ctx=mt.cpu())).asnumpy()
    checks["lockstep"] = bool(np.allclose(merged / world, digest,
                                          rtol=1e-5, atol=1e-6))
    if args.out:
        mt.nd.save(os.path.join(args.out, "rank%d.params" % rank),
                   dict([("arg:%s" % k, v) for k, v in params.items()]
                        + [("aux:%s" % k, v) for k, v in aux.items()]))
        if args.ckpt:
            res["ckpt"] = checkpoint_save(args.out)
    res["checks"] = checks
    res["ok"] = all(checks.values())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--network", choices=("mlp", "resnet50"), default="mlp")
    ap.add_argument("--ctx", choices=("cpu", "gpu"), default="cpu")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="a rank's batch (mlp 25, resnet50 16)")
    ap.add_argument("--batches", type=int, default=3,
                    help="resnet50: batches a rank an epoch")
    ap.add_argument("--image", type=int, default=224,
                    help="resnet50: the images' side")
    ap.add_argument("--classes", type=int, default=1000,
                    help="resnet50: the classes")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--params", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt", action="store_true")
    args = ap.parse_args(argv)
    res = run(args)
    line = json.dumps(res, sort_keys=True)
    print(line, flush=True)
    if args.out:
        with open(os.path.join(args.out, "rank%d.json" % res["rank"]),
                  "w") as f:
            f.write(line)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
