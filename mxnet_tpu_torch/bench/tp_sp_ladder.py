"""Tensor and sequence parallelism over the ranks of a world (the port's
twin of the dp x tp and ring-attention blocks of ``__graft_entry__.py``'s
multichip dryrun).  One launch a world:

    python -m mxnet_tpu_torch.launch -n 4 \\
        python -m mxnet_tpu_torch.bench.tp_sp_ladder --ctx cpu --out DIR \\
        --mesh dp2xtp2 --cases col:sgd,row:adam,gather:sgd --eval \\
        --refusals --ring sp4,dp2xsp2
    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.tp_sp_ladder --out DIR --mesh tp2 \\
        --cases row:sgd --num-layers 50 --image 224 --classes 1000 \\
        --batch 32 --dtype float32 --single

**Tensor parallelism** (``--mesh``: ``dp<a>xtp<b>`` or ``tp<b>``, over
every rank; ``--cases route:optimizer,...``): ``TrainStep(mesh=,
param_shardings=SPECS[route])`` on a ResNet v2 (``--num-layers``,
``--image``, ``--classes``) from the same state (``--params``, a
``.params`` file of ``arg:`` / ``aux:`` entries; else ``TrainStep.init``
from ``SEED``) over the same global batches (``--data``, ``data`` and
``softmax_label`` stacked one batch a step; else seeded), ``STEPS``
steps, SGD with momentum and wd (``sgd``) or Adam (``adam``).  The routes:
``col`` (the dryrun's ``fc1_weight`` ``("tp", None)`` and ``fc1_bias``
``("tp",)``: the column-parallel classifier), ``row`` (``fc1_weight``
``(None, "tp")``: row-parallel), ``gather`` (``conv0_weight`` split on its
output channels: gathered where it is read).  A case reports its
collectives a step by kind, calls and bytes, beside
``predicted_collectives`` (the one prediction the tests and
``chip_smoke.py`` hold them to), whether the replicated parameters and the
moving statistics are bitwise equal across the ``tp`` ranks, the bytes of
this rank's split parameters, the step ms, whether every rank holds the
same whole parameters and moving statistics, and with ``--single`` (on
rank 0: the others hold the same whole leaves) the distance to one
process's ``TrainStep`` over the whole global batch, also over ``FLOOR_X``
times that step's float32 floor (the largest distance of ``FLOOR_SAMPLES``
runs from parameters nudged by ``FLOOR_NUDGE``).  Of the first case:
``--norm-conv`` runs it again under ``MXNET_NORM_CONV=1``; ``--bn-world``
runs it with BatchNorm's sums taken over the world with the dp count (a
planted fault the tests must see); ``--ckpt`` saves its state
(``--ckpt-state``: a ``.params`` file's ``arg:`` / ``aux:`` /
``opt:<name>:<i>`` state placed first, at update count ``STEPS``) as a
sharded checkpoint under ``DIR/ck``, restores it into the mesh's step
(bitwise) and, on rank 0, loads it in one process (the split parameters
whole, bitwise the gathered slices).  ``--eval``: ``EvalStep`` over the
mesh on whole parameters against ``EvalStep`` without one;
``--refusals``: ZeRO with a ``tp`` spec, ``PipelineTrainStep`` on a ``tp``
axis, a split that does not divide, an ``sp`` axis on a step's mesh.

**Sequence parallelism** (``--ring MESH,...``, each ``sp<n>`` or
``dp<a>xsp<n>`` over every rank): ``ring_attention`` forward and its
gradients of ``sum(out ** 2)`` on seeded (B, H, T, D) inputs
(``RING_SHAPE``, the JAX package's test's), float32 causal and not, and
float64 causal (the softmax state stays float32, as the JAX package's).
``--lm MESH``: the transformer LM (``--lm-vocab``, ``--lm-seq-len``,
``--lm-layers``, ``--lm-hidden``, ``--lm-heads``, ``--lm-batch``) under
``set_sequence_mesh``: its forward and ``--lm-steps`` SGD steps
(``--lm-lr``) from ``--lm-params`` (or ``TrainStep.init`` from ``SEED``)
on a seeded batch, each against the same without the sequence mesh
(``--single``, on rank 0, also over ``FLOOR_X`` times the one-process
step's floor), the ring's sends and gathers and the gradients' mean a
step against ``predicted_ring``, whether the trained parameters are
bitwise equal across the ``sp`` ranks, ms a step and, on the card, peak
memory beside one process's.  A ring call's saved bytes are measured
against ``predicted_ring_saved``.

``--out DIR`` writes ``rank<r>.json`` (printed too) and, with
``--save-arrays``, ``rank<r>.params`` (every case's logical parameters and
moving statistics, the ring's outputs and gradients, the LM's outputs and
parameters).  On the card TF32 is off.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench.zero_ladder import _NC_CALLS, count_norm_conv_calls
from mxnet_tpu_torch.ops import norm_conv as nc
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh

# the split parameters of each route
SPECS = {"col": {"fc1_weight": ("tp", None), "fc1_bias": ("tp",)},
         "row": {"fc1_weight": (None, "tp")},
         "gather": {"conv0_weight": ("tp", None, None, None)}}
# the ring's inputs: the JAX package's ring test's (B, H, T, D), seeds
RING_SHAPE = (2, 3, 64, 16)
RING_SEEDS = {False: 0, True: 3}
SEED = 0
STEPS = 2
# the float32 floor rule: FLOOR_SAMPLES runs from parameters nudged by
# FLOOR_NUDGE (relative), the largest distance, FLOOR_MIN at least
FLOOR_X = 4.0
FLOOR_NUDGE = 2.0 ** -18
FLOOR_SAMPLES = 2
FLOOR_MIN = 1e-6
LM_LR = 0.1


def parse_mesh(text):
    """``dp2xtp2`` -> {"dp": 2, "tp": 2}."""
    axes = {}
    for part in text.split("x"):
        name = part.rstrip("0123456789")
        axes[name] = int(part[len(name):])
    return axes


def predicted_collectives(route, shapes, dp, tp, rows, elem, nbn,
                          aux_numel):
    """{kind: [calls, bytes]} a step on a rank of ``TrainStep`` over a
    ``dp x tp`` mesh with ``SPECS[route]`` split, without the NormConv
    peephole: ``shapes`` the whole parameters' shapes, ``rows`` a rank's
    batch rows, ``elem`` the bytes of an element, ``nbn`` the BatchNorm
    layers (their sums: one collective each in the forward, one in the
    backward of each but the input's; bytes not predicted),
    ``aux_numel`` the moving statistics' elements.  The route's own
    collectives; the moving statistics' mean over ``tp``; the replicated
    gradients summed over the world and, at dp > 1, the split ones over
    dp (``all_reduce``)."""
    def numel(s):
        return int(np.prod(s))
    out = {}
    classes, feat = shapes["fc1_weight"]
    if route == "col":
        out["tp_all_gather"] = [1, rows * classes * elem]
        out["tp_all_reduce"] = [1, rows * feat * elem]
    elif route == "row":
        out["tp_all_reduce"] = [1, rows * classes * elem]
        out["tp_all_gather"] = [1, rows * feat * elem]
    else:
        out["tp_all_gather"] = [1, sum(numel(shapes[n]) for n in
                                       SPECS[route]) * elem]
    if aux_numel:
        calls, nbytes = out.get("tp_all_reduce", [0, 0])
        out["tp_all_reduce"] = [calls + 1, nbytes + aux_numel * elem]
    split = sum(numel(shapes[n]) for n in SPECS[route])
    rep = sum(numel(s) for s in shapes.values()) - split
    out["all_reduce"] = [1, rep * elem]
    if dp > 1:
        out["all_reduce"] = [2, (rep + split // tp) * elem]
        out["stats"] = [2 * nbn - 1, None]
    return out


def predicted_ring(layers, sp, shape, elem, grad_bytes=0):
    """{kind: [calls, bytes]} a training step on a rank of the ring over
    ``sp`` ranks, ``layers`` attention layers of (B, H, T, D) ``shape``:
    the forward sends K and V one hop ``sp - 1`` times and gathers the
    output blocks; the backward sends K, V, dK and dV (dK/dV in float32)
    ``sp - 1`` times and gathers (dQ, dK, dV) in float32.  A TrainStep
    under the sequence mesh also averages its ``grad_bytes`` of gradients
    (one dtype) over the ranks: one ``sp_all_reduce``."""
    b, h, t, d = shape
    blk = b * h * (t // sp) * d
    hops = sp - 1
    send = layers * hops * (2 * blk * elem + 2 * blk * elem + 2 * blk * 4)
    out = {"ring_send": [layers * hops * 6, send],
           "ring_recv": [layers * hops * 6, send],
           "sp_all_gather": [layers * 2, layers * (b * h * t * d * elem
                                                   + 3 * b * h * t * d * 4)]}
    if grad_bytes:
        out["sp_all_reduce"] = [1, grad_bytes]
    return out


def predicted_ring_saved(sp, shape, elem):
    """The bytes one ring call keeps for its backward on a rank: its Q, K
    and V blocks, its float32 output block and its float32 ``m`` and
    ``l``."""
    b, h, t, d = shape
    rows = b * h * (t // sp)
    return 3 * rows * d * elem + rows * d * 4 + 2 * rows * 4


def make_opt(name, batch):
    if name == "sgd":
        return mt.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                                rescale_grad=1.0 / batch)
    return mt.optimizer.Adam(learning_rate=1e-3, rescale_grad=1.0 / batch)


def load_state(path, dtype):
    """({name: tensor}, {name: tensor}, {name: (tensor, ...)}) of a .params
    file's arg: / aux: / opt:<name>:<i> entries."""
    raw = mt.nd.load(path, ctx=mt.cpu())
    arg = {k[4:]: v.value.to(dtype) for k, v in raw.items()
           if k.startswith("arg:")}
    aux = {k[4:]: v.value.to(dtype) for k, v in raw.items()
           if k.startswith("aux:")}
    opt = {}
    for k in sorted(raw):
        if k.startswith("opt:"):
            name, i = k[4:].rsplit(":", 1)
            opt.setdefault(name, {})[int(i)] = raw[k].value.to(dtype)
    opt = {n: tuple(v[i] for i in sorted(v)) for n, v in opt.items()}
    return arg, aux, opt


def _sync(torch, card):
    if card:
        torch.cuda.synchronize()


def host(v):
    return v.detach().cpu()


def tp_equal(torch, ts, params, aux):
    """Whether this rank's replicated parameters and moving statistics equal
    every other rank's of its ``tp`` slice, bit for bit."""
    tp = ts._tp
    leaves = [aux[n] for n in ts.aux_names] + [
        params[n] for n in ts.param_names if n not in tp.dims]
    flat = torch.cat([v.detach().reshape(-1).view(torch.uint8)
                      for v in leaves])
    allr = dist.all_gather_rows(flat, tp.group, tp.size)
    return bool(all(torch.equal(allr[0], allr[i])
                    for i in range(1, tp.size)))


def digest(torch, *trees):
    """sha256 of the trees' host bytes, leaves in name order."""
    import hashlib
    h = hashlib.sha256()
    for tree in trees:
        for n in sorted(tree):
            h.update(tree[n].detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return h.digest()


def world_equal(torch, *trees, group=None, size=None):
    """Whether every rank of ``group`` (None: the world, ``size`` ranks)
    holds the same whole parameters and moving statistics, bit for bit (a
    digest of the host bytes, gathered)."""
    mine = torch.tensor(list(digest(torch, *trees)[:16]), dtype=torch.uint8)
    dev = torch.device("cuda", 0) if dist.route() == "gloo-cuda" \
        else torch.device("cpu")
    allr = dist.all_gather_rows(mine.to(dev), group,
                                size or dist.num_workers())
    return bool((allr == allr[0]).all())


def run_case(torch, net, route, opt_name, mesh, params, aux, batches, ctx,
             card):
    """One case (``mesh`` None: one process's step over the whole global
    batch; ``route`` None: no spec): (report, ts, params, state, aux)."""
    batch = batches["data"].shape[1]
    ts = mt.TrainStep(net, make_opt(opt_name, batch), mesh=mesh, ctx=ctx,
                      param_shardings=SPECS[route] if route else None)
    p, s, a = ts.place_checkpoint(params, None, aux)
    dist.reset_collectives()
    launched = (nc.launches, nc.stats_launches, _NC_CALLS[0])
    marks = []
    for i in range(STEPS):
        _sync(torch, card)
        t0 = time.perf_counter()
        p, s, a, outs = ts(p, s, a, {k: v[i] for k, v in batches.items()})
        _sync(torch, card)
        marks.append(time.perf_counter() - t0)
    later = marks[1:] or marks
    rep = {"route": route, "optimizer": opt_name,
           "collectives_per_step": {k: v / STEPS for k, v in
                                    dist.collective_calls.items()},
           "collective_bytes_per_step": {k: v / STEPS for k, v in
                                         dist.collective_bytes.items()},
           "norm_conv_per_step": (nc.launches - launched[0]) / STEPS,
           "norm_conv_stats_per_step": (nc.stats_launches - launched[1])
           / STEPS,
           "norm_conv_calls_per_step": (_NC_CALLS[0] - launched[2]) / STEPS,
           "step_ms": float(np.median(later)) * 1e3,
           "img_per_s": batch / float(np.median(later)),
           "outputs": [list(o.shape) for o in outs]}
    if ts._tp is not None:
        rep["routes"], rep["gathered"] = ts._tp.route_names(ts._low)
        rep["split_bytes"] = sum(p[n].numel() * p[n].element_size()
                                 for n in ts._tp.dims)
        rep["tp_bitwise_equal"] = tp_equal(torch, ts, p, a)
    return rep, ts, p, s, a


def logical(ts, p, a):
    """Host copies of the whole parameters and the moving statistics."""
    gp = ts.gather_params(p)
    return ({n: host(v) for n, v in gp.items()},
            {n: host(v) for n, v in a.items()})


def worst_over_floor(got, want, floors):
    """(largest distance over FLOOR_X x the leaf's floor, its leaf); a
    leaf that is not finite on either side is infinitely far."""
    worst = (0.0, None)
    for n, w in want.items():
        d = float((got[n].double() - w.double()).abs().max())
        r = d / (FLOOR_X * floors[n]) if d == d else float("inf")
        if not (r <= worst[0]):
            worst = (r, n)
    return worst


def max_abs(got, want):
    return max(float((got[n].double() - w.double()).abs().max())
               for n, w in want.items())


def nudged(torch, params, seed):
    """``params`` nudged by FLOOR_NUDGE (relative, uniform)."""
    g = torch.Generator().manual_seed(seed)
    return {k: (v.double() * (1 + FLOOR_NUDGE * (2 * torch.rand(
        v.shape, generator=g, dtype=torch.float64) - 1))).to(v.dtype)
        for k, v in params.items()}


def single_refs(torch, net, opt_names, params, aux, batches, ctx, card):
    """{optimizer: (whole parameters, moving statistics, floors, step ms)}
    of one process's step over the whole global batch."""
    out = {}
    for opt in opt_names:
        rep, ts, p, s, a = run_case(torch, net, None, opt, None, params, aux,
                                    batches, ctx, card)
        lp, la = logical(ts, p, a)
        floors = {k: FLOOR_MIN for k in lp}
        for j in range(FLOOR_SAMPLES):
            _, tsn, pn, _, an = run_case(
                torch, net, None, opt, None,
                nudged(torch, params, SEED + 21 + j), aux, batches, ctx,
                card)
            ln = logical(tsn, pn, an)[0]
            floors = {k: max(floors[k], float(
                (ln[k].double() - w.double()).abs().max()))
                for k, w in lp.items()}
        out[opt] = (lp, la, floors, rep["step_ms"])
        del ts, p, s, a
    return out


def ckpt_check(torch, net, case, mesh, aux, batches, ctx, state_path,
               out_dir, dtype, trained):
    """Save a case's state (see the module's docstring), restore it into
    the mesh's step and, on rank 0, load it in one process."""
    from mxnet_tpu_torch import checkpoint as ck
    route, opt = case.split(":")
    batch = batches["data"].shape[1]
    ts = mt.TrainStep(net, make_opt(opt, batch), mesh=mesh, ctx=ctx,
                      param_shardings=SPECS[route])
    if state_path:
        hp, ha, hs = load_state(state_path, dtype)
        p, s, a = ts.place_checkpoint(hp, hs, ha)
    else:
        p, s, a = trained
    ts.num_update = STEPS
    path = ck.Checkpointer(os.path.join(out_dir, "ck", "m"),
                           async_=False).save(ts, p, s, a)
    dist.barrier()
    ts2 = mt.TrainStep(net, make_opt(opt, batch), mesh=mesh, ctx=ctx,
                       param_shardings=SPECS[route])
    rp, rs, ra, man = ck.restore_into(ts2, path)
    same = all(torch.equal(rp[n], p[n]) for n in p) and all(
        torch.equal(x, y) for n in s for x, y in zip(rs[n], s[n])) and all(
        torch.equal(ra[n], a[n]) for n in a)
    whole = ts.gather_params(p)
    rep = {"path": os.path.relpath(path, out_dir),
           "shards": sorted(man["shards"]), "restored_bitwise": bool(same),
           "step": ts2.num_update}
    if dist.rank() == 0:
        one = mt.TrainStep(net, make_opt(opt, batch), ctx=ctx)
        op, _, _, _ = ck.restore_into(one, path)
        rep["one_process_shapes"] = {n: list(op[n].shape)
                                     for n in SPECS[route]}
        rep["one_process_bitwise"] = all(
            torch.equal(op[n].cpu(), whole[n].cpu()) for n in op)
    return rep


def eval_check(torch, net, mesh, whole, aux, batches):
    """EvalStep over the mesh (each rank its dp rows, gathered) on whole
    parameters against EvalStep without one on the whole batch."""
    batch = {k: v[0] for k, v in batches.items()}
    got = mt.EvalStep(net, mesh=mesh)(whole, aux, batch)
    want = mt.EvalStep(net)(whole, aux, batch)
    flat = torch.cat([o.reshape(-1) for o in got])
    allr = dist.all_gather_rows(flat, None, dist.num_workers())
    return {"shapes": [list(o.shape) for o in got],
            "max_abs": max(float((g - w).abs().max())
                           for g, w in zip(got, want)),
            "equal_across_ranks": bool(all(torch.equal(allr[0], x)
                                           for x in allr[1:]))}


def refusal_checks(net, mesh, batch, ctx, image):
    """Each refusal that stays raises MXNetError with its words."""
    from mxnet_tpu_torch.train import PipelineTrainStep
    MXNetError = mt.base.MXNetError

    def raises(fn, words):
        try:
            fn()
        except MXNetError as exc:
            return words in str(exc)
        return False
    shapes = {"data": (batch, 3, image, image)}
    return {
        "zero_with_tp_spec": raises(lambda: mt.TrainStep(
            net, make_opt("sgd", batch), mesh=mesh, zero=1, ctx=ctx,
            param_shardings=SPECS["col"]),
            "combine it with tensor-parallel param_shardings is not "
            "supported yet"),
        "pipeline_tp_axis": raises(lambda: PipelineTrainStep(
            net, make_opt("sgd", batch), ctx=ctx,
            mesh=pmesh.make_mesh({"pp": 1, "tp": -1})),
            "PipelineTrainStep composes with dp only; mesh axes ['tp'] "
            "are not supported yet"),
        "uneven_split": raises(lambda: mt.TrainStep(
            net, make_opt("sgd", batch), mesh=mesh, ctx=ctx,
            param_shardings={"conv0_weight": (None, "tp", None, None)})
            .init(shapes, {"softmax_label": (batch,)}),
            "should be divisible by %d, but it is equal to 3"
            % pmesh.axis_size(mesh, "tp")),
        "sp_axis_on_a_step": raises(lambda: mt.TrainStep(
            net, make_opt("sgd", batch), ctx=ctx,
            mesh=pmesh.make_mesh({"sp": -1})), "set_sequence_mesh")}


def tp_phase(torch, args, ctx, card, dtype, report, arrays):
    mesh = pmesh.make_mesh(parse_mesh(args.mesh))
    dp = pmesh.axis_size(mesh, "dp")
    tp = pmesh.axis_size(mesh, "tp")
    net = mt.models.resnet.get_symbol(args.classes, args.num_layers,
                                      "3,%d,%d" % (args.image, args.image))
    shape = (args.batch, 3, args.image, args.image)
    if args.params:
        params, aux, _ = load_state(args.params, dtype)
    else:
        ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
        p0, _, a0 = ts0.init({"data": shape}, {"softmax_label": shape[:1]},
                             seed=SEED)
        params = {k: v.to(dtype) for k, v in p0.items()}
        aux = {k: v.to(dtype) for k, v in a0.items()}
    if args.data:
        raw = mt.nd.load(args.data, ctx=mt.cpu())
        batches = {k: raw[k].value.to(dtype) for k in ("data",
                                                        "softmax_label")}
    else:
        rng = np.random.default_rng(SEED + 11)
        batches = {
            "data": torch.from_numpy(rng.uniform(
                -1, 1, (STEPS,) + shape)).to(dtype),
            "softmax_label": torch.from_numpy(rng.integers(
                0, args.classes, (STEPS, args.batch))).to(dtype)}
    dev = ctx.torch_device()
    batches = {k: v.to(dev) for k, v in batches.items()}
    shapes = {n: tuple(v.shape) for n, v in params.items()}
    nbn = sum(1 for n in aux if n.endswith("moving_mean"))
    elem = torch.empty((), dtype=dtype).element_size()
    cases = [c for c in args.cases.split(",") if c]
    refs = {}
    if args.single and dist.rank() == 0:
        refs = single_refs(torch, net, sorted({c.split(":")[1]
                                                for c in cases}),
                           params, aux, batches, ctx, card)
    report["single_step_ms"] = {k: v[3] for k, v in refs.items()}
    report["mesh"] = {"dp": dp, "tp": tp}
    report["cases"] = []
    trained = {}

    def one(case, tag, env=None, sync=False):
        route, opt = case.split(":")
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            if sync:
                # the planted fault: BatchNorm's sums over the world,
                # divided by the dp count
                real = mt.TrainStep.__init__

                def planted(self, *a_, **k_):
                    real(self, *a_, **k_)
                    self._sync = (None, self._dp)
                mt.TrainStep.__init__ = planted
            try:
                rep, ts, p, s, a = run_case(torch, net, route, opt, mesh,
                                            params, aux, batches, ctx, card)
            finally:
                if sync:
                    mt.TrainStep.__init__ = real
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        rep["case"] = tag
        rep["predicted"] = predicted_collectives(
            route, shapes, dp, tp, args.batch // dp, elem, nbn,
            sum(v.numel() for v in aux.values()))
        lp, la = logical(ts, p, a)
        rep["whole_equal_across_world"] = world_equal(torch, lp, la)
        if opt in refs:
            base, base_aux, floors, _ = refs[opt]
            rep["max_abs_vs_single"] = max_abs(lp, base)
            rep["aux_max_abs_vs_single"] = max_abs(la, base_aux)
            rep["worst_over_floor"] = worst_over_floor(lp, base, floors)
        if args.save_arrays:
            for n, v in lp.items():
                arrays["%s/arg:%s" % (tag, n)] = v
            for n, v in la.items():
                arrays["%s/aux:%s" % (tag, n)] = v
        report["cases"].append(rep)
        print(json.dumps({"rank": dist.rank(), "tp_case": rep},
                         sort_keys=True), flush=True)
        return ts, p, s, a
    for case in cases:
        ts, p, s, a = one(case, case)
        if case == cases[0]:
            trained[case] = (p, s, a)
        if args.eval and case == cases[0]:
            report["eval"] = eval_check(
                torch, net, mesh, {n: v.to(dev) for n, v in
                                   ts.gather_params(p).items()}, a, batches)
        del ts, p, s, a
        if card:
            torch.cuda.empty_cache()
    if args.norm_conv:
        one(cases[0], "nc-" + cases[0], {"MXNET_NORM_CONV": "1"})
    if args.bn_world:
        one(cases[0], "bnworld-" + cases[0], sync=True)
    if args.ckpt:
        report["ckpt"] = ckpt_check(torch, net, cases[0], mesh, aux,
                                    batches, ctx, args.ckpt_state, args.out,
                                    dtype, trained[cases[0]])
    if args.refusals:
        report["refusals"] = refusal_checks(net, mesh, args.batch, ctx,
                                            args.image)
    return all(r.get("tp_bitwise_equal", True) for r in report["cases"])


def ring_inputs(torch, causal, dtype):
    rng = np.random.RandomState(RING_SEEDS[causal])
    return [torch.from_numpy(rng.randn(*RING_SHAPE).astype(np.float32))
            .to(dtype) for _ in range(3)]


def ring_phase(torch, args, dev, report, arrays):
    from mxnet_tpu_torch.parallel.ring import ring_attention
    report["ring"] = []
    for spec in [m for m in args.ring.split(",") if m]:
        mesh = pmesh.make_mesh(parse_mesh(spec))
        for causal, dtype in ((False, torch.float32),
                              (True, torch.float32), (True, torch.float64)):
            q, k, v = (x.to(dev).requires_grad_() for x in
                       ring_inputs(torch, causal, dtype))
            dist.reset_collectives()
            saved = []

            def pack(t):
                saved.append(t.numel() * t.element_size())
                return t
            with torch.autograd.graph.saved_tensors_hooks(pack,
                                                          lambda t: t):
                out = ring_attention(q, k, v, mesh, causal=causal)
            (out ** 2).sum().backward()
            tag = "ring-%s-%s-%s" % (spec, "causal" if causal else "full",
                                     str(dtype).replace("torch.", ""))
            report["ring"].append({
                "case": tag, "collectives": dict(dist.collective_calls),
                "collective_bytes": dict(dist.collective_bytes),
                "predicted": predicted_ring(1, pmesh.axis_size(mesh, "sp"),
                                            RING_SHAPE, q.element_size()),
                "saved_bytes": sum(saved),
                "predicted_saved_bytes": predicted_ring_saved(
                    pmesh.axis_size(mesh, "sp"), RING_SHAPE,
                    q.element_size())})
            for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                            ("dv", v.grad)):
                arrays["%s/%s" % (tag, name)] = host(t)


def lm_phase(torch, args, ctx, card, report, arrays):
    from mxnet_tpu_torch.parallel.mesh import set_sequence_mesh
    mesh = pmesh.make_mesh(parse_mesh(args.lm))
    sp = pmesh.axis_size(mesh, "sp")
    widths = dict(vocab_size=args.lm_vocab, seq_len=args.lm_seq_len,
                  num_layers=args.lm_layers, num_hidden=args.lm_hidden,
                  num_heads=args.lm_heads)
    net = mt.models.transformer.get_symbol(**widths)
    B, T = args.lm_batch, args.lm_seq_len
    shapes = ({"data": (B, T)}, {"softmax_label": (B, T)})
    if args.lm_params:
        params, aux, _ = load_state(args.lm_params, torch.float32)
    else:
        ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
        params, _, aux = ts0.init(*shapes, seed=SEED)
        del ts0
    rng = np.random.RandomState(SEED + 1)
    x = rng.randint(0, args.lm_vocab, (B, T)).astype(np.float32)
    y = rng.randint(0, args.lm_vocab, (B, T)).astype(np.float32)
    batch = {"data": x, "softmax_label": y}
    dev = ctx.torch_device()
    rep = {"mesh": args.lm, "sp": sp, "widths": widths, "batch": B}

    def forward():
        vals = {k: v.to(dev) for k, v in params.items()}
        out = mt.EvalStep(net)(vals, {k: v.to(dev) for k, v in aux.items()},
                               batch)[0]
        _sync(torch, card)
        return out

    def train(p0):
        ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=args.lm_lr),
                          ctx=ctx)
        p, s, a = ts.place_checkpoint(p0, None, aux)
        marks = []
        dist.reset_collectives()
        if card:
            torch.cuda.reset_peak_memory_stats()
        for _ in range(args.lm_steps):
            _sync(torch, card)
            t0 = time.perf_counter()
            p, s, a, _ = ts(p, s, a, batch)
            _sync(torch, card)
            marks.append(time.perf_counter() - t0)
        calls = {k: v / args.lm_steps
                 for k, v in dist.collective_calls.items()}
        mbytes = {k: v / args.lm_steps
                  for k, v in dist.collective_bytes.items()}
        peak = torch.cuda.max_memory_allocated() if card else None
        return ({n: host(v) for n, v in p.items()}, calls, mbytes,
                float(np.median(marks[1:] or marks)) * 1e3, peak)
    from mxnet_tpu_torch.ops import flash_attention as fa
    set_sequence_mesh(mesh)
    try:
        flash0 = fa.launches
        ring_out = forward()
        lp, calls, mbytes, ms, peak = train(params)
        rep["flash_launches_under_ring"] = fa.launches - flash0
    finally:
        set_sequence_mesh(None)
    rep.update(collectives_per_step=calls, collective_bytes_per_step=mbytes,
               step_ms=ms, peak_bytes=peak,
               predicted=predicted_ring(
                   args.lm_layers, sp,
                   (B, args.lm_heads, T, args.lm_hidden // args.lm_heads),
                   4, sum(v.numel() * v.element_size()
                          for v in params.values())),
               # the sequence replicas take the same update bit for bit
               sp_bitwise_equal=world_equal(
                   torch, lp, group=pmesh.axis_group(mesh, "sp"), size=sp))
    if args.single and dist.rank() == 0:
        flash0 = fa.launches
        plain_out = forward()
        rep["single_forward_flash_launches"] = fa.launches - flash0
        rep["forward_max_abs"] = float((ring_out - plain_out).abs().max())
        # the scale LM_TOL-style bounds are relative to: the largest
        # probability
        rep["forward_scale"] = float(plain_out.abs().max())
        sp_, _, _, sms, speak = train(params)
        rep.update(single_step_ms=sms, single_peak_bytes=speak,
                   max_abs_vs_single=max_abs(lp, sp_))
        floors = {k: FLOOR_MIN for k in sp_}
        for j in range(FLOOR_SAMPLES):
            ln = train(nudged(torch, params, SEED + 21 + j))[0]
            floors = {k: max(floors[k], float(
                (ln[k].double() - w.double()).abs().max()))
                for k, w in sp_.items()}
        rep["worst_over_floor"] = worst_over_floor(lp, sp_, floors)
        del plain_out
    if args.save_arrays:
        arrays["lm/out"] = host(ring_out)
        for n, v in lp.items():
            arrays["lm/arg:" + n] = v
    report["lm"] = rep
    print(json.dumps({"rank": dist.rank(), "lm": rep}, sort_keys=True),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ctx", choices=("cpu", "gpu"), default="gpu")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--cases", default="")
    ap.add_argument("--num-layers", type=int, default=20)
    ap.add_argument("--image", type=int, default=16)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch of a step")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--params", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--norm-conv", action="store_true")
    ap.add_argument("--bn-world", action="store_true")
    ap.add_argument("--ckpt", action="store_true")
    ap.add_argument("--ckpt-state", default=None)
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--refusals", action="store_true")
    ap.add_argument("--ring", default="")
    ap.add_argument("--lm", default="")
    ap.add_argument("--lm-params", default=None)
    ap.add_argument("--lm-vocab", type=int, default=16)
    ap.add_argument("--lm-seq-len", type=int, default=32)
    ap.add_argument("--lm-layers", type=int, default=1)
    ap.add_argument("--lm-hidden", type=int, default=16)
    ap.add_argument("--lm-heads", type=int, default=2)
    ap.add_argument("--lm-batch", type=int, default=2)
    ap.add_argument("--lm-steps", type=int, default=3)
    ap.add_argument("--lm-lr", type=float, default=LM_LR,
                    help="SGD's rate (the head's gradient is summed over "
                         "the batch's tokens)")
    ap.add_argument("--save-arrays", action="store_true")
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
    t0 = time.perf_counter()
    report = {"rank": rank, "world": world, "route": dist.route(),
              "device": str(ctx.torch_device()), "ok": True}
    arrays = {}
    ok = True
    count_norm_conv_calls()
    if args.mesh:
        ok = tp_phase(torch, args, ctx, card, dtype, report, arrays)
    if args.ring:
        ring_phase(torch, args, ctx.torch_device(), report, arrays)
    if args.lm:
        lm_phase(torch, args, ctx, card, report, arrays)
    from mxnet_tpu_torch.ops import flash_attention as fa
    report["norm_conv_launches"] = nc.launches
    report["flash_launches"] = [fa.launches, fa.bwd_dq_launches,
                                fa.bwd_dkv_launches]
    report["seconds"] = time.perf_counter() - t0
    report["ok"] = bool(ok)
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
