"""The ZeRO ladder over the ranks of a world (the port's twin of the ZeRO
block of ``__graft_entry__.py``'s multichip dryrun): ``TrainStep`` over a
``dp`` mesh of every rank at ZeRO levels 0-3, each from the same state on
the same global batches.

    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.zero_ladder --ctx cpu --out DIR
    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.zero_ladder --num-layers 50 \\
        --image 224 --classes 1000 --batch 32 --dtype float32 --steps 3 \\
        --optimizers sgd --amp bfloat16 --elastic 4 --floor-nudge 1e-6 \\
        --out DIR

Every rank builds the same state (``--params``: a ``.params`` file of
``arg:`` / ``aux:`` entries; otherwise ``TrainStep.init`` from ``--seed``)
and the same global batches (``--data``: a ``.params`` file of ``data`` and
``softmax_label``, stacked one batch a step; otherwise seeded uniform
images), and each step takes its rows of them.  The network is ResNet v2
(``--num-layers``, ``--image``, ``--classes``), or with ``--network mlp``
the JAX package's ZeRO-test MLP (three FullyConnected layers of 16, 16 and
``--classes`` over 10 features); on the card TF32 is off.

For each optimizer (``sgd``: SGD with momentum and wd; ``adam``) and level
the report holds: the per-device bytes of the placement plan
(``TrainStep.zero_bytes``) and, on the card, the bytes the placement
allocated and the gradients' bytes at the update; the collectives a step
by kind (calls and bytes, ``dist.collective_calls``); NormConv launches
a step; the step and update ms (the update drained at its entry and
exit) and img/s over the steps after the first; whether the replicated leaves are bitwise equal across the
ranks; and each level's largest distance to level 0's logical parameters
over ``--floor-x`` times their float32 floor (``--floor-nudge``: the
largest distance of ``--floor-samples`` runs of level 0 from parameters
nudged by that relative amount).

Variants of the SGD rungs, compared with SGD level 0 as the levels are
(``variants`` in the report): ``--norm-conv-levels`` runs those levels
again under ``MXNET_NORM_CONV=1`` (the executor's NormConv peephole, whose
statistics epilogue sums across the ranks; on the CPU its plain version),
``--remat-levels`` with ``remat=True`` (the forward recomputed in the
backward), and ``--single`` one ``TrainStep`` without a mesh over the whole
global batch on every rank.  ``--backward-thread`` drives every step's
backward from a thread of its own, as autograd's device threads drive a
CUDA backward, so a recompute on the CPU meets what it meets on the card.
``norm_conv_calls_per_step`` counts ``ops.norm_conv.norm_conv`` calls, the
kernel's and the plain version's alike.

``--amp DTYPE``: a level-3 step under ``Policy(DTYPE)`` on a batch with an
inf in its first row (rank 0's rows): every rank must skip (masters,
optimizer rows and moving statistics bitwise unchanged), the scale must
halve and one overflow count; then a clean step must move the masters.
``--fit``: ``Module.fit`` under ``MXNET_ZERO=2`` of a two-layer MLP on the
JAX package's ZeRO-fit data (64 rows of 16 features, batch 16, 4 epochs,
SGD 0.5) from ``--fit-params``.  ``--ckpt``: the level-2 SGD state saved
as a sharded checkpoint under ``DIR/ck`` (each rank writes its ZeRO row);
``--restore PATH``: a checkpoint restored onto a level-2 step.
``--elastic N``: ``parallel.elastic.fit_elastic`` under ``MXNET_ZERO=2``
over N batches with a checkpoint every 2 steps, stopped after 2 and
resumed, the restored state bitwise the saved one.  ``--eval``:
``EvalStep`` over the mesh on the first global batch against ``EvalStep``
without one on the whole batch, and a level-2 step of an MLP whose
SoftmaxOutput normalizes by "batch" and by "valid" (ignoring label 0)
against the same step without a mesh.  ``--refusals``: the mesh refusals
(a batch that does not divide), a ``tp`` axis of size 2 with the
parameters replicated over it and with a row-parallel ``fc1_weight``, each
against one process's step ("stepped"), and ``MXNET_PP`` composed with
``MXNET_ZERO``, which trains.

``--out DIR`` writes ``rank<r>.json`` (printed too) and, with
``--save-arrays``, ``rank<r>.params``: every run's logical parameters, aux
states, optimizer state and this rank's optimizer rows.
"""
import argparse
import json
import os
import sys
import threading
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import norm_conv as nc
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh

FIT_EPOCHS, FIT_BATCH, FIT_LR = 4, 16, 0.5
ELASTIC_EVERY = 2

# ops.norm_conv.norm_conv calls since count_norm_conv_calls
_NC_CALLS = [0]


def count_norm_conv_calls():
    """Count every ``ops.norm_conv.norm_conv`` call, the kernel's and its
    plain version's alike: on the CPU, where no kernel launches, they show
    that a step went through the NormConv peephole."""
    real = nc.norm_conv

    def counted(*a, **k):
        _NC_CALLS[0] += 1
        return real(*a, **k)
    nc.norm_conv = counted


def backward_on_a_thread():
    """Drive every ``TrainStep`` backward from a new thread, as autograd's
    device threads drive a CUDA backward: what the backward recomputes
    sees none of the stepping thread's thread-local settings."""
    from mxnet_tpu_torch import train as _train
    real = _train.head_grads

    def on_thread(*a, **k):
        box = {}

        def body():
            try:
                box["out"] = real(*a, **k)
            except BaseException as exc:  # re-raised on the caller
                box["err"] = exc
        th = threading.Thread(target=body, name="backward")
        th.start()
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    _train.head_grads = on_thread


def fit_net(mt_, classes=2):
    """The JAX package's ZeRO-fit network (tests/python/unittest/
    test_zero.py ``_fit_net``)."""
    S = mt_.sym
    h = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=32)
    h = S.Activation(h, act_type="relu")
    h = S.FullyConnected(h, name="fc2", num_hidden=classes)
    return S.SoftmaxOutput(h, name="softmax")


def mlp_net(mt_, classes):
    """The JAX package's ZeRO-test MLP (test_zero.py ``_mlp``)."""
    S = mt_.sym
    h = S.Variable("data")
    for i, width in enumerate((16, 16, classes)):
        h = S.FullyConnected(h, name="fc%d" % (i + 1), num_hidden=width)
        if i < 2:
            h = S.Activation(h, act_type="relu")
    return S.SoftmaxOutput(h, name="softmax")


def fit_data(seed=0):
    """The JAX package's ZeRO-fit data (``_fit_data``)."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (64, 16)).astype(np.float32)
    w = rs.uniform(-1, 1, (16,))
    return x, (x @ w > 0).astype(np.float32)


def make_opt(name, batch, lr=None):
    if name == "sgd":
        return mt.optimizer.SGD(learning_rate=0.1 if lr is None else lr,
                                momentum=0.9, wd=1e-4,
                                rescale_grad=1.0 / batch)
    return mt.optimizer.Adam(learning_rate=1e-3 if lr is None else lr,
                             rescale_grad=1.0 / batch)


def load_state(path, dtype):
    """({name: tensor}, {name: tensor}) of a .params file's arg:/aux:."""
    raw = mt.nd.load(path, ctx=mt.cpu())
    arg = {k[4:]: v.value.to(dtype) for k, v in raw.items()
           if k.startswith("arg:")}
    aux = {k[4:]: v.value.to(dtype) for k, v in raw.items()
           if k.startswith("aux:")}
    return arg, aux


def _sync(torch, card):
    if card:
        torch.cuda.synchronize()


def _replicated_equal(torch, ts, params, aux):
    """Whether this rank's replicated leaves (parameters below level 3,
    the aux states) equal every other rank's, bit for bit."""
    leaves = [aux[n] for n in ts.aux_names]
    if not ts.plan.shard_params:
        leaves += [params[n] for n in ts.param_names]
    flat = torch.cat([v.detach().reshape(-1).view(torch.uint8)
                      if v.dtype != torch.bool else v.reshape(-1)
                      for v in leaves])
    allr = dist.all_gather_rows(flat, ts._group, ts._dp)
    return bool(all(torch.equal(allr[0], allr[i])
                    for i in range(1, ts._dp)))


def run_level(torch, net, opt_name, level, mesh, params, aux, batches,
              ctx, card, steps, remat=False):
    """One ladder rung (``mesh`` None: one process's step over the whole
    global batch): (report, ts, params, state, aux)."""
    batch = batches["data"].shape[1]
    ts = mt.TrainStep(net, make_opt(opt_name, batch), mesh=mesh, zero=level,
                      ctx=ctx, remat=remat)
    _sync(torch, card)
    m0 = torch.cuda.memory_allocated() if card else None
    p, s, a = ts.place_checkpoint(params, None, aux)
    _sync(torch, card)
    resident = torch.cuda.memory_allocated() - m0 if card else None
    zb = ts.zero_bytes(p, s)
    upd, grad_mem, step_base = [], [], [0]
    real_reduce, real_update = ts._reduce, ts._update

    def timed(fn, mem=False):
        def wrapped(*a_, **k_):
            _sync(torch, card)
            if mem and card:
                # the reduced gradients (and the step's few outputs): what
                # the step holds at the update beyond what it started with
                grad_mem.append(torch.cuda.memory_allocated()
                                - step_base[0])
            t0 = time.perf_counter()
            out = fn(*a_, **k_)
            _sync(torch, card)
            upd.append(time.perf_counter() - t0)
            return out
        return wrapped
    ts._reduce, ts._update = timed(real_reduce), timed(real_update, True)
    dist.reset_collectives()
    launched = (nc.launches, nc.stats_launches, _NC_CALLS[0])
    marks, upd_steps = [], []
    for i in range(steps):
        _sync(torch, card)
        if card:
            step_base[0] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        del upd[:]
        p, s, a, outs = ts(p, s, a, {k: v[i] for k, v in batches.items()})
        _sync(torch, card)
        marks.append(time.perf_counter() - t0)
        upd_steps.append(sum(upd))
    ts._reduce, ts._update = real_reduce, real_update
    calls = {k: v / steps for k, v in dist.collective_calls.items()}
    mbytes = {k: v / steps / 1e6 for k, v in dist.collective_bytes.items()}
    launches = ((nc.launches - launched[0]) / steps,
                (nc.stats_launches - launched[1]) / steps,
                (_NC_CALLS[0] - launched[2]) / steps)
    same = _replicated_equal(torch, ts, p, a) if mesh is not None else True
    later = marks[1:] or marks
    rep = {"level": level, "optimizer": opt_name,
           "plan_bytes": zb, "resident_bytes": resident,
           # the last step's: the first allocates the kernels' buffers
           "grad_resident_bytes": grad_mem[-1] if grad_mem else None,
           "collectives_per_step": calls, "collective_mb_per_step": mbytes,
           "norm_conv_per_step": launches[0],
           "norm_conv_stats_per_step": launches[1],
           "norm_conv_calls_per_step": launches[2],
           "step_ms": float(np.median(later)) * 1e3,
           "update_ms": float(np.median(upd_steps[1:] or upd_steps)) * 1e3,
           "img_per_s": batch / float(np.median(later)),
           "replicated_bitwise_equal": same}
    return rep, ts, p, s, a


def host(v):
    return v.detach().cpu()


def logical(ts, p, s, a):
    """Host copies of the logical parameters, optimizer state and aux."""
    gp = ts.gather_params(p)
    gs = ts.gather_state(s)
    return ({n: host(v) for n, v in gp.items()},
            {n: tuple(host(x) for x in st) for n, st in gs.items()},
            {n: host(v) for n, v in a.items()})


def worst_over_floor(got, want, floors, floor_x):
    worst = (0.0, None)
    for n, w in want.items():
        d = float((got[n].double() - w.double()).abs().max())
        r = d / (floor_x * floors[n])
        if r > worst[0]:
            worst = (r, n)
    return worst


def amp_check(torch, net, mesh, params, aux, batches, ctx, card, dtype,
              scale):
    """The level-3 overflow skip under ``Policy(dtype)`` (see the module's
    docstring): (report, logical parameters after the clean step)."""
    batch = batches["data"].shape[1]
    pol = mt.amp.Policy(dtype, loss_scale=scale, growth_interval=50)
    ts = mt.TrainStep(net, make_opt("sgd", batch), mesh=mesh, zero=3,
                      policy=pol, ctx=ctx)
    p, s, a = ts.place_checkpoint(
        {n: v.float() for n, v in params.items()}, None,
        {n: v.float() for n, v in aux.items()})
    bad = {k: v[0].clone() for k, v in batches.items()}
    bad["data"] = bad["data"].float()
    bad["data"].reshape(-1)[0] = float("inf")
    before = [{n: v.clone() for n, v in d.items()} for d in (p, a)]
    st_before = {n: tuple(x.clone() for x in st) for n, st in s.items()}
    p, s, a, _ = ts(p, s, a, bad)
    kept = all(torch.equal(before[0][n], p[n]) for n in p) and all(
        torch.equal(before[1][n], a[n]) for n in a) and all(
        torch.equal(x, y) for n in s for x, y in zip(st_before[n], s[n]))
    host_scale = ts.scale_state_host()
    flag = torch.tensor([1.0 if kept else 0.0], device=p[ts.param_names[0]]
                        .device)
    every = dist.all_gather_rows(flag, ts._group, ts._dp)
    good = {k: v[0].float() for k, v in batches.items()}
    p, s, a, _ = ts(p, s, a, good)
    moved = any(not torch.equal(before[0][n], p[n]) for n in p)
    _sync(torch, card)
    rep = {"dtype": dtype, "skipped": kept,
           "every_rank_skipped": bool((every == 1).all()),
           "scale_before": scale, "scale": host_scale["scale"],
           "overflow": host_scale["overflow"],
           "clean_step_moved": moved}
    return rep, logical(ts, p, s, a)[0]


def fit_check(params_path):
    """Module.fit under MXNET_ZERO=2 (see the module's docstring): (report,
    the fitted parameters)."""
    x, y = fit_data()
    arg, aux = load_state(params_path, mt.base.torch_dtype("float32"))
    it = mt.io.NDArrayIter(x, y, batch_size=FIT_BATCH, shuffle=False,
                           label_name="softmax_label")
    mod = mt.Module(fit_net(mt), context=mt.cpu())
    os.environ["MXNET_ZERO"] = "2"
    try:
        mod.fit(it, num_epoch=FIT_EPOCHS, optimizer="sgd",
                optimizer_params={"learning_rate": FIT_LR},
                arg_params={k: mt.nd.NDArray(v) for k, v in arg.items()},
                aux_params={k: mt.nd.NDArray(v) for k, v in aux.items()},
                eval_metric="acc")
    finally:
        del os.environ["MXNET_ZERO"]
    ts = mod._fused_ts_cache[1]
    it.reset()
    score = dict(mod.score(it, mt.metric.Accuracy()))
    out = {k: v.value.clone() for k, v in mod.get_params()[0].items()}
    return {"zero": ts.zero, "dp": ts._dp, "accuracy": score["accuracy"],
            "fc1_weight_shape": list(out["fc1_weight"].shape)}, out


def eval_check(torch, net, mesh, params, aux, batches):
    """EvalStep over the mesh (each rank its rows, the outputs gathered)
    against EvalStep without one on the whole batch."""
    batch = {k: v[0] for k, v in batches.items()}
    got = mt.EvalStep(net, mesh=mesh)(params, aux, batch)
    want = mt.EvalStep(net)(params, aux, batch)
    flat = torch.cat([o.reshape(-1) for o in got])
    allr = dist.all_gather_rows(flat, pmesh.axis_group(mesh, "dp"),
                                pmesh.axis_size(mesh, "dp"))
    return {"shapes": [list(o.shape) for o in got],
            "max_abs": max(float((g - w).abs().max())
                           for g, w in zip(got, want)),
            "equal_across_ranks": bool(all(torch.equal(allr[0], x)
                                           for x in allr[1:]))}


def loss_norm_check(mesh):
    """A level-2 step of a SoftmaxOutput normalized by "batch" and by
    "valid" over the mesh against the same step without one: the largest
    parameter difference of each (the counts are the global batch's)."""
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (8, 10))
    y = rs.randint(0, 3, 8).astype(np.float64)
    out = {}
    for norm in ("batch", "valid"):
        S = mt.sym
        h = S.FullyConnected(S.Variable("data"), name="fc", num_hidden=3)
        net = S.SoftmaxOutput(h, name="softmax", normalization=norm,
                              use_ignore=norm == "valid", ignore_label=0)
        res = []
        for kw in ({"mesh": mesh, "zero": 2}, {}):
            ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=0.5),
                              ctx=mt.cpu(), **kw)
            p, s, a = ts.init({"data": (8, 10)}, {"softmax_label": (8,)})
            p = {k: v.double() for k, v in p.items()}
            s = {k: tuple(t.double() for t in st) for k, st in s.items()}
            p, s, a, _ = ts(p, s, a, {"data": x, "softmax_label": y})
            res.append(ts.gather_params(p))
        out[norm] = max(float((res[0][k] - res[1][k]).abs().max())
                        for k in res[1])
    return out


def refusal_checks(net, mesh, batches, ctx):
    """Each refusal of the mesh slice raises MXNetError naming its part."""
    MXNetError = mt.base.MXNetError

    def raises(fn, words):
        try:
            fn()
        except MXNetError as exc:
            return words in str(exc)
        return False
    batch = batches["data"].shape[1]
    res = {}
    tp_mesh = pmesh.make_mesh({"dp": 1, "tp": -1})
    one = {k: v[0] for k, v in batches.items()}

    def step(mesh_, specs):
        ts = mt.TrainStep(net, make_opt("sgd", batch), mesh=mesh_, ctx=ctx,
                          param_shardings=specs)
        p, s, a = ts.init({"data": tuple(one["data"].shape)},
                          {"softmax_label": (batch,)})
        p = {k: v.to(one["data"].dtype) for k, v in p.items()}
        s = {k: tuple(x.to(one["data"].dtype) for x in st)
             for k, st in s.items()}
        p, s, a, _ = ts(p, s, a, one)
        return ts.gather_params(p)
    # a tp axis of size 2 (the parameters replicated over it, or the
    # classifier row-parallel) steps as one process does
    want = step(None, None)
    for key, specs in (("tp_axis", None),
                       ("tp_spec", {"fc1_weight": (None, "tp")})):
        got = step(tp_mesh, specs)
        res[key] = "stepped" if all(float((got[n] - want[n]).abs().max())
                                    <= 1e-9 for n in want) else "differs"
    res["dp_spec_accepted"] = mt.TrainStep(
        net, make_opt("sgd", batch), mesh=mesh, ctx=ctx,
        param_shardings={"fc1_weight": ("dp", None)}).param_shardings \
        == {"fc1_weight": ("dp", None)}
    ts = mt.TrainStep(net, make_opt("sgd", batch), mesh=mesh, zero=2,
                      ctx=ctx)
    odd = {k: v[0][:batch - 1] for k, v in batches.items()}
    res["batch_not_divisible"] = raises(lambda: ts.shard_batch(odd),
                                        "not divisible")
    x, y = fit_data()
    env = {"MXNET_ZERO": "2"}
    os.environ.update(env)
    try:
        mod = mt.Module(fit_net(mt), context=ctx)
        res["fit_MXNET_ZERO"] = raises(lambda: mod.fit(
            mt.io.NDArrayIter(x[:14], y[:14], batch_size=7), num_epoch=1,
            optimizer="sgd"), "not divisible")
        # composed with MXNET_PP the level shards each stage over its dp
        # group: the fit trains through a PipelineTrainStep
        os.environ["MXNET_PP"] = str(dist.num_workers())
        mod = mt.Module(fit_net(mt), context=ctx)
        mod.fit(mt.io.NDArrayIter(x[:FIT_BATCH * 2], y[:FIT_BATCH * 2],
                                  batch_size=FIT_BATCH), num_epoch=1,
                optimizer="sgd")
        ts = mod._fused_ts_cache[1]
        res["fit_MXNET_PP"] = "stepped" if (
            type(ts).__name__ == "PipelineTrainStep" and ts.zero == 2
            and ts.num_update == 2) else repr(ts)
    finally:
        for k in ("MXNET_ZERO", "MXNET_PP"):
            os.environ.pop(k, None)
    return res


def elastic_check(torch, net, params, aux, batches, ctx, card, out_dir):
    """``fit_elastic`` under MXNET_ZERO=2 (see the module's docstring)."""
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.module import module as mmod
    from mxnet_tpu_torch.parallel import elastic
    x = torch.cat(list(batches["data"])).float().cpu().numpy()
    y = torch.cat(list(batches["softmax_label"])).float().cpu().numpy()
    batch = batches["data"].shape[1]

    class Stop(RuntimeError):
        pass

    def run(prefix, stop_after=None):
        class Feed(mt.io.NDArrayIter):
            def next(self):
                self._served = getattr(self, "_served", 0) + 1
                if stop_after is not None and self._served > stop_after:
                    raise Stop("stopped after %d batches" % stop_after)
                return super().next()
        mod = mt.Module(net, context=ctx)
        try:
            elastic.fit_elastic(
                mod, Feed(x, y, batch_size=batch), prefix, num_epoch=1,
                optimizer="sgd", optimizer_params={
                    "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
                arg_params={k: mt.nd.NDArray(v.float().cpu())
                            for k, v in params.items()},
                aux_params={k: mt.nd.NDArray(v.float().cpu())
                            for k, v in aux.items()})
        except Stop:
            return None
        return mod
    saved, restored = {}, {}
    real_save, real_resume = mmod._FusedFit.save_checkpoint, \
        mmod._FusedFit._resume

    def snap(ff):
        return {"step": ff._ts.num_update,
                "params": {k: v.clone() for k, v in ff._params.items()},
                "state": {k: tuple(t.clone() for t in st)
                          for k, st in ff._state.items()},
                "aux": {k: v.clone() for k, v in ff._aux.items()}}

    def spy_save(self, *a, **kw):
        if not saved:
            saved.update(snap(self))
        return real_save(self, *a, **kw)

    def spy_resume(self, resume):
        real_resume(self, resume)
        restored.update(snap(self))
    prefix = os.path.join(out_dir, "elastic", "m")
    env = {"MXNET_ZERO": "2", "MXNET_CKPT_EVERY_N_STEPS": str(ELASTIC_EVERY)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    mmod._FusedFit.save_checkpoint = spy_save
    mmod._FusedFit._resume = spy_resume
    try:
        stopped = run(prefix, stop_after=ELASTIC_EVERY)
        # rank 0 writes the manifest after every rank's shards
        dist.barrier()
        path = ck.latest_sharded(prefix)
        man = ck.load_manifest(path)
        run(prefix)
    finally:
        mmod._FusedFit.save_checkpoint = real_save
        mmod._FusedFit._resume = real_resume
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _sync(torch, card)
    bitwise = bool(restored) and restored["step"] == saved["step"] and all(
        torch.equal(restored[g][k], saved[g][k]) for g in ("params", "aux")
        for k in saved[g]) and all(
        torch.equal(u, v) for k in saved["state"]
        for u, v in zip(restored["state"][k], saved["state"][k]))
    return {"stopped": stopped is None, "saved_step": saved.get("step"),
            "restored_step": restored.get("step"),
            "checkpoint": os.path.basename(path),
            "zero": man["topology"]["zero"],
            "shards": sorted(man["shards"]),
            "restored_bitwise": bitwise}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ctx", choices=("cpu", "gpu"), default="gpu")
    ap.add_argument("--network", choices=("resnet", "mlp"),
                    default="resnet")
    ap.add_argument("--num-layers", type=int, default=20)
    ap.add_argument("--image", type=int, default=16)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch of a step")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--params", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--levels", default="0,1,2,3")
    ap.add_argument("--optimizers", default="sgd,adam")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--floor-nudge", type=float, default=None)
    ap.add_argument("--floor-samples", type=int, default=2)
    ap.add_argument("--floor-x", type=float, default=4.0)
    ap.add_argument("--floor-min", type=float, default=1e-7)
    ap.add_argument("--amp", default=None)
    ap.add_argument("--amp-scale", type=float, default=16.0)
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--fit-params", default=None)
    ap.add_argument("--ckpt", action="store_true")
    ap.add_argument("--restore", default=None)
    ap.add_argument("--elastic", type=int, default=0)
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--refusals", action="store_true")
    ap.add_argument("--save-arrays", action="store_true")
    ap.add_argument("--norm-conv-levels", default="")
    ap.add_argument("--remat-levels", default="")
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--backward-thread", action="store_true")
    args = ap.parse_args(argv)
    import torch
    card = args.ctx == "gpu"
    if card:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group()
    rank, world = dist.rank(), dist.num_workers()
    ctx = mt.gpu(0) if card else mt.cpu()
    dtype = mt.base.torch_dtype(args.dtype)
    mesh = pmesh.make_mesh({"dp": -1})
    if args.network == "mlp":
        net = mlp_net(mt, args.classes)
        shape = (args.batch, 10)
    else:
        net = mt.models.resnet.get_symbol(
            args.classes, args.num_layers,
            "3,%d,%d" % (args.image, args.image))
        shape = (args.batch, 3, args.image, args.image)
    if args.params:
        params, aux = load_state(args.params, dtype)
    else:
        ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
        p0, _, a0 = ts0.init({"data": shape}, {"softmax_label": shape[:1]},
                             seed=args.seed)
        params = {k: v.to(dtype) for k, v in p0.items()}
        aux = {k: v.to(dtype) for k, v in a0.items()}
    if args.data:
        raw = mt.nd.load(args.data, ctx=mt.cpu())
        batches = {k: raw[k].value.to(dtype) for k in ("data",
                                                        "softmax_label")}
    else:
        rng = np.random.default_rng(args.seed + 11)
        batches = {
            "data": torch.from_numpy(rng.uniform(
                -1, 1, (args.steps,) + shape)).to(dtype),
            "softmax_label": torch.from_numpy(rng.integers(
                0, args.classes, (args.steps, args.batch))).to(dtype)}
    dev = ctx.torch_device()
    batches = {k: v.to(dev) for k, v in batches.items()}
    report = {"rank": rank, "world": world, "route": dist.route(),
              "device": str(dev), "levels": [], "ok": True}
    arrays = {}

    def ints(text):
        return [int(v) for v in text.split(",") if v]

    def compare(rep, lp, base, floors):
        if floors is not None:
            rep["worst_over_floor"] = worst_over_floor(
                lp, base, floors, args.floor_x)
        rep["max_abs_vs_first_level"] = max(
            float((lp[k].double() - base[k].double()).abs().max())
            for k in base)

    def keep(tag, ts, lp, ls, la, s):
        if not args.save_arrays:
            return
        for n, v in lp.items():
            arrays[tag + "arg:" + n] = v
        for n, v in la.items():
            arrays[tag + "aux:" + n] = v
        for n, st in ls.items():
            for i, x in enumerate(st):
                arrays[tag + "opt:%s:%d" % (n, i)] = x
        if ts.plan.shard_state:
            for n, st in s.items():
                for i, x in enumerate(st):
                    arrays[tag + "row:%s:%d" % (n, i)] = host(x)

    if args.backward_thread:
        backward_on_a_thread()
    count_norm_conv_calls()
    levels = ints(args.levels)
    bases = {}
    for opt_name in [v for v in args.optimizers.split(",") if v]:
        base = floors = None
        for level in levels:
            rep, ts, p, s, a = run_level(torch, net, opt_name, level, mesh,
                                         params, aux, batches, ctx, card,
                                         args.steps)
            lp, ls, la = logical(ts, p, s, a)
            if base is None:
                base = lp
                if args.floor_nudge is not None:
                    floors = {k: args.floor_min for k in base}
                    g = torch.Generator().manual_seed(args.seed + 21)
                    for _ in range(args.floor_samples):
                        nudged = {k: (v.double() * (1 + args.floor_nudge * (
                            2 * torch.rand(v.shape, generator=g,
                                           dtype=torch.float64) - 1)))
                                  .to(v.dtype) for k, v in params.items()}
                        _, tsn, pn, sn, an = run_level(
                            torch, net, opt_name, level, mesh, nudged, aux,
                            batches, ctx, card, args.steps)
                        ln = logical(tsn, pn, sn, an)[0]
                        floors = {k: max(floors[k], float(
                            (ln[k].double() - w.double()).abs().max()))
                            for k, w in base.items()}
                        del tsn, pn, sn, an, ln
                bases[opt_name] = (base, floors)
            compare(rep, lp, base, floors)
            report["levels"].append(rep)
            print(json.dumps({"rank": rank, "zero_level": rep},
                             sort_keys=True), flush=True)
            keep("L%d-%s/" % (level, opt_name), ts, lp, ls, la, s)
            if args.ckpt and level == 2 and opt_name == "sgd":
                from mxnet_tpu_torch import checkpoint as ck
                c = ck.Checkpointer(os.path.join(args.out, "ck", "m"),
                                    async_=False)
                report["ckpt"] = c.save(ts, p, s, a)
                dist.barrier()
            del ts, p, s, a
            if card:
                torch.cuda.empty_cache()
    # the SGD variants, each against SGD's first level
    report["variants"] = []
    variants = [("nc", v) for v in ints(args.norm_conv_levels)] + [
        ("remat", v) for v in ints(args.remat_levels)] + (
        [("single", 0)] if args.single else [])
    for kind, level in variants:
        base, floors = bases["sgd"]
        was = os.environ.get("MXNET_NORM_CONV")
        if kind == "nc":
            os.environ["MXNET_NORM_CONV"] = "1"
        try:
            rep, ts, p, s, a = run_level(
                torch, net, "sgd", level, None if kind == "single" else mesh,
                params, aux, batches, ctx, card, args.steps,
                remat=kind == "remat")
        finally:
            if was is None:
                os.environ.pop("MXNET_NORM_CONV", None)
            else:
                os.environ["MXNET_NORM_CONV"] = was
        rep["variant"] = kind
        lp, ls, la = logical(ts, p, s, a)
        compare(rep, lp, base, floors)
        report["variants"].append(rep)
        print(json.dumps({"rank": rank, "zero_variant": rep},
                         sort_keys=True), flush=True)
        keep("%s-L%d-sgd/" % (kind, level), ts, lp, ls, la, s)
        del ts, p, s, a
        if card:
            torch.cuda.empty_cache()
    if args.restore:
        from mxnet_tpu_torch import checkpoint as ck
        ts = mt.TrainStep(net, make_opt("sgd", args.batch), mesh=mesh,
                          zero=2, ctx=ctx)
        p, s, a, man = ck.restore_into(ts, args.restore)
        report["restore"] = {"step": ts.num_update,
                             "zero": man["topology"]["zero"]}
        for n, st in s.items():
            for i, x in enumerate(st):
                arrays["restore/row:%s:%d" % (n, i)] = host(x)
        for n, v in p.items():
            arrays["restore/arg:" + n] = host(v)
    if args.amp:
        rep, lp = amp_check(torch, net, mesh, params, aux, batches, ctx,
                            card, args.amp, args.amp_scale)
        report["amp"] = rep
        print(json.dumps({"rank": rank, "amp": rep}, sort_keys=True),
              flush=True)
        for n, v in lp.items():
            arrays["amp/arg:" + n] = v
    if args.fit:
        rep, fp = fit_check(args.fit_params)
        report["fit"] = rep
        for n, v in fp.items():
            arrays["fit/arg:" + n] = v
    if args.eval:
        report["eval"] = eval_check(
            torch, net, mesh, {k: v.to(dev) for k, v in params.items()},
            {k: v.to(dev) for k, v in aux.items()}, batches)
        report["eval"]["loss_norm_max_abs"] = loss_norm_check(mesh)
    if args.refusals:
        report["refusals"] = refusal_checks(net, mesh, batches, ctx)
    if args.elastic:
        rng = np.random.default_rng(args.seed + 31)
        eb = {"data": torch.from_numpy(rng.uniform(
            -1, 1, (args.elastic,) + shape)).float(),
            "softmax_label": torch.from_numpy(rng.integers(
                0, args.classes, (args.elastic, args.batch))).float()}
        report["elastic"] = elastic_check(torch, net, params, aux, eb, ctx,
                                          card, args.out)
    report["norm_conv_launches"] = nc.launches
    report["ok"] = all(r["replicated_bitwise_equal"]
                       for r in report["levels"] + report["variants"]) and (
        "amp" not in report or (report["amp"]["every_rank_skipped"]
                                and report["amp"]["clean_step_moved"]))
    os.makedirs(args.out, exist_ok=True)
    if args.save_arrays:
        mt.nd.save(os.path.join(args.out, "rank%d.params" % rank),
                   {k: mt.nd.NDArray(v.contiguous()) for k, v in
                    arrays.items()})
    with open(os.path.join(args.out, "rank%d.json" % rank), "w") as f:
        json.dump(report, f, sort_keys=True)
    print(json.dumps({"rank": rank, "ok": report["ok"]}), flush=True)
    dist.barrier()
    dist.shutdown_process_group()
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
