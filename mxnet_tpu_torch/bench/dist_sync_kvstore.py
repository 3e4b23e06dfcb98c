"""The dist kvstore's arithmetic over the ranks of a world (the port's twin
of ``tests/python/dist/dist_sync_kvstore.py``), with the runtime's other
calls beside it:

    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.dist_sync_kvstore [--ctx gpu]

Each rank pushes rank-dependent values; the store's Test optimizer (w +=
rate * merged) makes the result exact: after ``nrepeat`` pushes every
element is ``(nworker + 1) * nworker / 2 * rate * nrepeat + 1``, on a 2x2
key and on a 1200x1200 key; without an updater a pull gives the merged
value (replace semantics).  Then: ``init_process_group`` is idempotent,
``allreduce_arrays`` sums float32, float64 and int64 tensors in one call
(one collective a dtype), ``kv_set`` / ``kv_get`` and
``coordination_barrier`` (also from a thread), ``health_check`` and
``num_dead_node``, ``peer_world``.  Arrays live on ``--ctx`` (``gpu``:
the rank's card on the ``nccl`` route, card 0 otherwise).  Each rank
prints one JSON line (``--out DIR`` also writes ``rank<r>.json``) with its
checks, the route and the host ms of the pushes; any failed check exits
1.
"""
import argparse
import json
import os
import sys
import threading
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import dist, elastic

KEYS = [3, 5, 7]
RATE = 2
SHAPE = (2, 2)
BIG_SHAPE = (1200, 1200)   # larger than the reference's BIGARRAY_BOUND
NREPEAT = 3


def context(kind):
    """The rank's context: the host, or its card."""
    if kind == "cpu":
        return mt.cpu()
    return mt.gpu(dist.local_rank() if dist.route() == "nccl" else 0)


def exact(arr, x):
    return float(np.abs(arr.asnumpy() - x).sum()) == 0.0


def reduces():
    """The all-reduces this process has made."""
    return dist.collective_calls.get("all_reduce", 0)


def run(ctx_kind):
    dist.init_process_group()
    dist.init_process_group()            # idempotent
    ctx = context(ctx_kind)
    checks = {}
    kv = mt.kv.create("dist_sync")
    kv.init(KEYS, [mt.nd.ones(SHAPE, ctx=ctx)] * len(KEYS))
    kv.init(99, mt.nd.ones(BIG_SHAPE, ctx=ctx))
    kv.set_optimizer(mt.optimizer.create("test", rescale_grad=RATE))
    my_rank, nworker = kv.rank, kv.num_workers
    checks["world"] = nworker == int(os.environ.get("MXTPU_NUM_PROCESSES",
                                                    "1"))
    dist.barrier()
    calls0 = reduces()
    t0 = time.perf_counter()
    for _ in range(NREPEAT):
        kv.push(3, mt.nd.ones(SHAPE, ctx=ctx) * (my_rank + 1))
        kv.push(99, mt.nd.ones(BIG_SHAPE, ctx=ctx) * (my_rank + 1))
    val = mt.nd.zeros(SHAPE, ctx=ctx)
    kv.pull(3, out=val)
    push_ms = (time.perf_counter() - t0) * 1e3
    num = (nworker + 1) * nworker * RATE / 2 * NREPEAT + 1
    checks["small_key"] = exact(val, num)
    val2 = mt.nd.zeros(BIG_SHAPE, ctx=ctx)
    kv.pull(99, out=val2)
    checks["big_key"] = exact(val2, num)
    checks["one_collective_a_push"] = \
        reduces() - calls0 == (2 * NREPEAT if nworker > 1 else 0)
    checks["on_context"] = val2.value.device == ctx.torch_device()
    # no updater: the pull gives the merged value
    kv2 = mt.kv.KVStore("dist_sync")
    kv2.init(11, mt.nd.ones(SHAPE, ctx=ctx))
    kv2.push(11, mt.nd.ones(SHAPE, ctx=ctx) * (my_rank + 2))
    val3 = mt.nd.zeros(SHAPE, ctx=ctx)
    kv2.pull(11, out=val3)
    checks["replace"] = exact(val3, sum(r + 2 for r in range(nworker)))
    # one call, three dtypes: one collective each
    dev = ctx.torch_device()
    import torch
    ins = [torch.full((5,), my_rank + 1.0, dtype=torch.float32, device=dev),
           torch.full((2, 3), my_rank + 0.5, dtype=torch.float64,
                      device=dev),
           torch.full((4,), my_rank + 7, dtype=torch.int64, device=dev),
           torch.full((3, 1), -1.0 - my_rank, dtype=torch.float32,
                      device=dev)]
    calls0 = reduces()
    outs = dist.allreduce_arrays(ins)
    want = [sum(r + 1.0 for r in range(nworker)),
            sum(r + 0.5 for r in range(nworker)),
            sum(r + 7 for r in range(nworker)),
            sum(-1.0 - r for r in range(nworker))]
    checks["multi_dtype"] = all(
        o.dtype == i.dtype and o.shape == i.shape and bool((o == w).all())
        for o, i, w in zip(outs, ins, want)) and \
        reduces() - calls0 == (3 if nworker > 1 else 0)
    checks["inputs_kept"] = float(ins[0][0]) == my_rank + 1.0
    # the store's service calls
    world, rk = dist.peer_world()
    checks["peer_world"] = (world, rk) == (nworker, my_rank)
    if nworker > 1:
        dist.kv_set("twin/%d" % my_rank, "hello %d" % my_rank)
        got = [dist.kv_get("twin/%d" % r, timeout_ms=60000)
               for r in range(nworker)]
        checks["kv"] = got == ["hello %d" % r for r in range(nworker)]
        errs = []

        def side():
            try:
                dist.coordination_barrier("twin-thread", timeout_ms=60000)
            except Exception as exc:          # reported below
                errs.append(exc)
        th = threading.Thread(target=side)
        th.start()
        th.join()
        checks["thread_barrier"] = not errs
    checks["health"] = elastic.health_check(timeout=60)
    checks["num_dead_node"] = kv.num_dead_node(0, 60) == 0
    kv.barrier()
    return {"rank": my_rank, "world": nworker, "route": dist.route(),
            "device": str(dev), "push_ms": push_ms,
            "allreduce_calls": reduces(),
            "allreduce_bytes": dist.collective_bytes.get("all_reduce", 0),
            "checks": checks,
            "ok": all(checks.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ctx", choices=("cpu", "gpu"), default="cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.ctx)
    line = json.dumps(res, sort_keys=True)
    print(line, flush=True)
    if args.out:
        with open(os.path.join(args.out, "rank%d.json" % res["rank"]),
                  "w") as f:
            f.write(line)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
