"""The pipeline ladder over the ranks of a world (the port's twin of the
pipeline block of ``__graft_entry__.py``'s multichip dryrun):
``PipelineTrainStep`` over ``make_pp_mesh(pp, dp)`` of every rank, each
case from the same state on the same global batches.

    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.pp_ladder --ctx cpu
    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.pp_ladder --network resnet \\
        --num-layers 50 --image 224 --classes 1000 --batch 32 \\
        --dtype float32 --cases gpipe:2:1:1,gpipe:2:1:4,1f1b:2:1:4,\\
interleaved:2:1:4:2 --single --micro-ref 4 --floor-nudge 1e-6 --out DIR

Every rank builds the same state (``--params``: a ``.params`` file of
``arg:`` / ``aux:`` entries; otherwise ``TrainStep.init`` from ``--seed``)
and the same global batches (``--data``: a ``.params`` file of ``data``
and ``softmax_label``, stacked one batch a step; otherwise seeded
uniform images).  The network is ResNet v2 (``--network resnet``,
``--num-layers``, ``--image``, ``--classes``) or a small BatchNorm conv
net whose BatchNorms the NormConv peephole fuses (``--network convnet``:
three 3x3 convolutions of 8 filters, each with a BatchNorm and a ReLU,
then a global average pool and a classifier).  The optimizer is SGD with
momentum 0.9, wd 1e-4, lr 0.1; on the card TF32 is off.

``--cases`` lists ``schedule:pp:dp:M[:v]``; each runs ``--steps`` steps
(pp x dp must be the world).  A case's row, under the field names of
``MULTICHIP_PP_r02.json``: ``pp_bubble_fraction``, ``stage_param_mb``
(each slice's parameter MB), ``pp_stage_param_mb_max``,
``replicated_param_mb``, ``pp_live_bytes_max_mb`` and
``pp_step_time_ms`` (the median of the steps after the first), with the
update's ms, img/s, ``last_live_bytes``, this rank's peak of
``torch.cuda.max_memory_allocated`` (card), its P2P transfers a step
(``dist.collective_calls`` / ``_bytes`` / ``_seconds`` by kind, and the
pinned staging copies), and its NormConv launches a step (with
statistics; ``norm_conv_calls_per_step`` counts the calls of the kernel's
and the plain version's alike).  ``--norm-conv`` runs every case again
under ``MXNET_NORM_CONV=1`` (tag ``nc-``).

References, each over the whole global batch on every rank: ``--single``
one process's ``TrainStep`` (tag ``single/``), ``--micro-ref M`` one
process's ``PipelineTrainStep`` with pp=1 and M microbatches (tag
``micro<M>/``).  ``--floor-nudge x`` also runs each reference from
``--floor-samples`` nudges of the parameters by a relative ``x`` (shared
out over the ranks); a case's ``worst_over_floor`` is its largest
distance to its reference (``single`` at M=1, ``micro<M>`` otherwise)
over ``--floor-x`` times that leaf's floor (``--floor-refs`` names the
references with nudged runs; a case whose reference has none takes the
first one's floor).

``--live M1,M2`` runs gpipe and 1f1b at pp=world with ``--live-rows``
rows a microbatch at each M, one step each (the live-bytes ladder).
``--ckpt`` saves the loaded state under every case's topology before its
first step (``DIR/ck0-<case>``) and the first case's state after its
steps (``DIR/ck``), then restores that into the same pipeline and into one
process's ``TrainStep`` (bitwise), and a one-process save (``DIR/ck1``)
into the pipeline.  ``--fit N``: ``Module.fit`` under ``MXNET_PP=world``
and ``MXNET_PP_MICROBATCH=1`` over the first N global batches, against a
``PipelineTrainStep`` over the same batches.  ``--semantics``: a
``'batch'``-normalized head at M=world against one process's step, and a
``'valid'`` one refused at M > 1.  ``--refusals``: ZeRO, AMP, the pure
bfloat16 cast, a ``tp`` axis, and ``MXNET_PP`` with ``MXNET_ZERO`` /
``MXNET_AMP`` in a fit.

``--out DIR`` writes ``rank<r>.json`` (printed too) and, with
``--save-arrays``, rank 0's ``rank0.params``: every case's and
reference's logical parameters and aux states.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench.zero_ladder import (_NC_CALLS, count_norm_conv_calls,
                                               load_state)
from mxnet_tpu_torch.ops import norm_conv as nc
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh
from mxnet_tpu_torch.train import PipelineTrainStep, pipeline_bubble_fraction

LR, MOMENTUM, WD = 0.1, 0.9, 1e-4


def convnet(mt_, classes, norm=None):
    """Three 3x3 convolutions of 8 filters, each with a BatchNorm and a
    ReLU (the NormConv peephole takes bn1 and bn2 as the prologues of c2
    and c3, and their statistics from c2's and c3's epilogues), a global
    average pool and a classifier."""
    S = mt_.sym
    h = S.Variable("data")
    for i in (1, 2, 3):
        h = S.Convolution(h, name="c%d" % i, num_filter=8, kernel=(3, 3),
                          pad=(1, 1), no_bias=True)
        h = S.BatchNorm(h, name="bn%d" % i, fix_gamma=False)
        h = S.Activation(h, act_type="relu")
    h = S.Pooling(h, global_pool=True, pool_type="avg", kernel=(1, 1))
    h = S.FullyConnected(S.Flatten(h), name="fc", num_hidden=classes)
    kw = {"normalization": norm} if norm else {}
    return S.SoftmaxOutput(h, name="softmax", **kw)


def make_opt(batch):
    return mt.optimizer.SGD(learning_rate=LR, momentum=MOMENTUM, wd=WD,
                            rescale_grad=1.0 / batch)


def parse_cases(text):
    out = []
    for c in [c for c in text.split(",") if c]:
        f = c.split(":")
        out.append((f[0], int(f[1]), int(f[2]), int(f[3]),
                    int(f[4]) if len(f) > 4 else (2 if f[0] == "interleaved"
                                                  else 1)))
    return out


def case_tag(case):
    sched, pp, dp, m, v = case
    return "%s-pp%d-dp%d-m%d-v%d" % (sched, pp, dp, m, v)


def host(v):
    return v.detach().cpu()


def own_mesh(world, rank):
    """A pp=1 mesh of this rank alone (every rank makes every rank's, so
    the groups are made collectively)."""
    meshes = [pmesh.make_pp_mesh(1, dp=1, devices=[r]) for r in range(world)]
    return meshes[rank]


class Runner(object):
    def __init__(self, torch, net, params, aux, batches, ctx, card, steps):
        self.torch, self.net = torch, net
        self.params, self.aux = params, aux
        self.batches, self.ctx, self.card = batches, ctx, card
        self.steps = steps
        self.batch = batches["data"].shape[1]

    def sync(self):
        if self.card:
            self.torch.cuda.synchronize()

    def step_batch(self, i):
        return {k: v[i] for k, v in self.batches.items()}

    def pipeline(self, mesh, schedule, m, v, params=None, ckpt=None,
                 gather=True):
        """One case: (row, logical params and aux (None unless
        ``gather``), step, placed)."""
        torch = self.torch
        ts = PipelineTrainStep(self.net, make_opt(self.batch), mesh=mesh,
                               num_microbatches=m, schedule=schedule,
                               interleave=v, ctx=self.ctx)
        upd = []
        real_update = ts._update

        def timed_update(*a_, **k_):
            # the update's seconds, the card drained at its entry and exit
            self.sync()
            t0 = time.perf_counter()
            real_update(*a_, **k_)
            self.sync()
            upd.append(time.perf_counter() - t0)
        ts._update = timed_update
        p, s, a = ts.place_checkpoint(params or self.params, None, self.aux)
        if ckpt is not None:
            ckpt(ts, p, s, a)
        if self.card:
            torch.cuda.reset_peak_memory_stats()
        dist.reset_collectives()
        launched = (nc.launches, nc.stats_launches, _NC_CALLS[0])
        marks = []
        for i in range(self.steps):
            self.sync()
            t0 = time.perf_counter()
            p, s, a, outs = ts(p, s, a, self.step_batch(i))
            self.sync()
            marks.append(time.perf_counter() - t0)
        steps = self.steps
        later = marks[1:] or marks
        p2p = {k: {"calls": dist.collective_calls.get(k, 0) / steps,
                   "mb": dist.collective_bytes.get(k, 0) / steps / 1e6,
                   "seconds": dist.collective_seconds.get(k, 0.0) / steps}
               for k in dist.collective_calls}
        row = {
            "launches_per_step": (nc.launches - launched[0]) / steps,
            "stats_launches_per_step":
                (nc.stats_launches - launched[1]) / steps,
            "norm_conv_calls_per_step": (_NC_CALLS[0] - launched[2]) / steps,
            "pp_step_time_ms": float(np.median(later)) * 1e3,
            "update_ms": float(np.median(upd[1:] or upd)) * 1e3,
            "img_per_s": self.batch / float(np.median(later)),
            "collectives_per_step": p2p,
            "p2p_staged_copies_per_step": dist.p2p_staged_copies[0] / steps,
            "last_live_bytes": list(ts.last_live_bytes),
            "pp_live_bytes_max_mb": round(max(ts.last_live_bytes) / 1e6, 3),
            "max_memory_allocated_mb": torch.cuda.max_memory_allocated()
            / 1e6 if self.card else None,
            "outputs_finite": bool(all(torch.isfinite(o).all()
                                       for o in outs)),
            "output_shapes": [list(o.shape) for o in outs]}
        lp = la = None
        if gather:
            lp, _, la = ts.gather_host(p, None, a)
        return row, lp, la, ts, (p, s, a)

    def single(self, params):
        ts = mt.TrainStep(self.net, make_opt(self.batch), ctx=self.ctx)
        p, s, a = ts.place_checkpoint(params, None, self.aux)
        marks = []
        for i in range(self.steps):
            self.sync()
            t0 = time.perf_counter()
            p, s, a, _ = ts(p, s, a, self.step_batch(i))
            self.sync()
            marks.append(time.perf_counter() - t0)
        # the steps after the first (its kernels' set-up aside)
        self.single_step_ms = float(np.median(marks[1:] or marks)) * 1e3
        return ({n: host(v) for n, v in p.items()},
                {n: host(v) for n, v in a.items()})

    def micro(self, params, m, mesh):
        ts = PipelineTrainStep(self.net, make_opt(self.batch), mesh=mesh,
                               num_microbatches=m, ctx=self.ctx)
        p, s, a = ts.place_checkpoint(params, None, self.aux)
        for i in range(self.steps):
            p, s, a, _ = ts(p, s, a, self.step_batch(i))
        return ({n: host(v) for n, v in p.items()},
                {n: host(v) for n, v in a.items()})


def slice_mb(ts, params):
    """Each device slice's parameter MB (a slice owns v chunks)."""
    pp = ts._pp
    out = [0.0] * pp
    for st in ts.stages():
        out[st.index % pp] += sum(
            int(params[n].numel()) * params[n].element_size()
            for n in st.params) / 1e6
    return out


def flat(torch, lp, la):
    """(names, one flat vector of every leaf at the leaves' widest
    dtype)."""
    keys = sorted(lp) + sorted(la)
    vals = [lp[k] for k in sorted(lp)] + [la[k] for k in sorted(la)]
    dt = vals[0].dtype
    for v in vals[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return keys, torch.cat([v.to(dt).reshape(-1) for v in vals])


def shared_references(torch, jobs, world, rank, shapes, dtype):
    """Run ``jobs`` ([(name, fn() -> (params, aux))]), job j on rank j %
    world, all at once, then give every rank every result (one broadcast
    a job)."""
    out = {}
    for j, (name, fn) in enumerate(jobs):
        if j % world == rank:
            lp, la = fn()
            out[name] = flat(torch, lp, la)[1]
    for j, (name, _) in enumerate(jobs):
        if j % world != rank:
            out[name] = torch.empty(shapes, dtype=dtype)
        if world > 1:
            dist.broadcast_(out[name], j % world)
    return out


def unflat(keys, vec, like):
    res, off = {}, 0
    for k in keys:
        c = like[k].numel()
        res[k] = vec[off:off + c].view(like[k].shape)
        off += c
    return res


def worst_over_floor(got, want, floors, floor_x, floor_min):
    worst = (0.0, None)
    for n, w in want.items():
        d = float((got[n].double() - w.double()).abs().max())
        r = d / (floor_x * max(floors[n], floor_min))
        if r > worst[0]:
            worst = (r, n)
    return worst


def refusal_checks(torch, net, ctx, world, batch):
    MXNetError = mt.base.MXNetError

    def raises(fn, words):
        try:
            fn()
        except MXNetError as exc:
            return words in str(exc)
        return False
    part = "ZeRO and AMP part of the pipeline"
    mesh = pmesh.make_pp_mesh(world)
    res = {
        "zero": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), mesh=mesh, zero=1, ctx=ctx), part),
        "policy": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), mesh=mesh, ctx=ctx,
            policy=mt.amp.Policy("bfloat16")), part),
        "dtype": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), mesh=mesh, ctx=ctx, dtype="bfloat16"),
            part),
        "tp_axis": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), ctx=ctx,
            mesh=pmesh.make_mesh({"pp": 1, "tp": -1})),
            "tensor-parallel part of the distributed slice"),
        "no_pp_axis": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), mesh=pmesh.make_mesh({"dp": -1}),
            ctx=ctx), "needs a mesh with a 'pp' axis"),
        "trainstep_pp_axis": raises(lambda: mt.TrainStep(
            net, make_opt(batch), mesh=mesh, ctx=ctx), "PipelineTrainStep")}
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (2 * world, 3, 8, 8)).astype(np.float32)
    y = rs.randint(0, 4, 2 * world).astype(np.float32)
    for knob, value in (("MXNET_ZERO", "1"), ("MXNET_AMP", "1")):
        os.environ["MXNET_PP"] = str(world)
        os.environ[knob] = value
        try:
            mod = mt.Module(convnet(mt, 4), context=ctx)
            res["fit_MXNET_PP+%s" % knob] = raises(lambda: mod.fit(
                mt.io.NDArrayIter(x, y, batch_size=2 * world),
                num_epoch=1, optimizer="sgd"), part)
        finally:
            del os.environ[knob], os.environ["MXNET_PP"]
    return res


def semantics_checks(torch, ctx, world):
    """'batch' heads at M = world against one process's step; 'valid'
    refused at M > 1."""
    rs = np.random.RandomState(3)
    b = 4 * world
    x = torch.from_numpy(rs.uniform(-1, 1, (b, 3, 6, 6)))
    y = torch.from_numpy(rs.randint(0, 4, b).astype(np.float64))
    net = convnet(mt, 4, norm="batch")
    ts0 = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=0.5),
                       ctx=mt.cpu())
    p0, _, a0 = ts0.init({"data": (b, 3, 6, 6)}, {"softmax_label": (b,)})
    p0 = {k: v.double() for k, v in p0.items()}
    a0 = {k: v.double() for k, v in a0.items()}
    out = {}
    # M=1 is the only one-program match for BatchNorm nets: the 'batch'
    # fold is checked where the statistics agree too, on an MLP of the
    # same head
    S = mt.sym
    h = S.FullyConnected(S.Flatten(S.Variable("data")), name="fc1",
                         num_hidden=8)
    h = S.FullyConnected(S.Activation(h, act_type="tanh"), name="fc2",
                         num_hidden=4)
    mlp = S.SoftmaxOutput(h, name="softmax", normalization="batch")
    tsm = mt.TrainStep(mlp, mt.optimizer.SGD(learning_rate=0.5),
                       ctx=mt.cpu())
    pm, _, _ = tsm.init({"data": (b, 3, 6, 6)}, {"softmax_label": (b,)})
    pm = {k: v.double() for k, v in pm.items()}
    want = {k: v.clone() for k, v in pm.items()}
    tsm(want, tsm.fopt.init_state(want), {}, {"data": x,
                                               "softmax_label": y})
    mesh = pmesh.make_pp_mesh(world)
    pt = PipelineTrainStep(mlp, mt.optimizer.SGD(learning_rate=0.5),
                           mesh=mesh, num_microbatches=world, ctx=ctx)
    p, s, a = pt.place_checkpoint(pm, None, {})
    pt(p, s, a, {"data": x, "softmax_label": y})
    got = pt.gather_params(p)
    out["batch_head_max_abs"] = max(float((got[k] - want[k]).abs().max())
                                    for k in want)
    valid = convnet(mt, 4, norm="valid")
    try:
        PipelineTrainStep(valid, mt.optimizer.SGD(), mesh=mesh,
                          num_microbatches=2, ctx=ctx).place_checkpoint(
            p0, None, a0)
        out["valid_refused"] = False
    except mt.base.MXNetError as exc:
        out["valid_refused"] = "normalization='valid'" in str(exc)
    return out


def fit_check(torch, run, world, nbatch):
    """Module.fit under MXNET_PP=world (M=1) over the first ``nbatch``
    global batches, against a PipelineTrainStep over the same batches:
    the largest parameter and aux difference."""
    b = run.batch
    x = run.batches["data"][:nbatch].reshape((-1,) + tuple(
        run.batches["data"].shape[2:])).float().cpu().numpy()
    y = run.batches["softmax_label"][:nbatch].reshape(-1).float() \
        .cpu().numpy()
    params = {k: v.float() for k, v in run.params.items()}
    aux = {k: v.float() for k, v in run.aux.items()}
    os.environ["MXNET_PP"] = str(world)
    os.environ["MXNET_PP_MICROBATCH"] = "1"
    try:
        mod = mt.Module(run.net, context=run.ctx)
        launched = nc.launches
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=b, shuffle=False,
                                  label_name="softmax_label"),
                num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": LR,
                                  "momentum": MOMENTUM, "wd": WD},
                arg_params={k: mt.nd.NDArray(v.clone())
                            for k, v in params.items()},
                aux_params={k: mt.nd.NDArray(v.clone())
                            for k, v in aux.items()},
                eval_metric="acc")
        fit_launches = nc.launches - launched
    finally:
        del os.environ["MXNET_PP"], os.environ["MXNET_PP_MICROBATCH"]
    ts = mod._fused_ts_cache[1]
    got_p, got_a = mod.get_params()
    ref = PipelineTrainStep(run.net, make_opt(b), mesh=pmesh.make_pp_mesh(
        world), num_microbatches=1, ctx=run.ctx)
    p, s, a = ref.place_checkpoint(params, None, aux)
    for i in range(nbatch):
        p, s, a, _ = ref(p, s, a, {k: v[i].float() for k, v in
                                   run.batches.items()})
    want_p, _, want_a = ref.gather_host(p, None, a)
    got_p = {k: v.value.cpu() for k, v in got_p.items()}
    got_a = {k: v.value.cpu() for k, v in got_a.items()}
    return {"pipeline": type(ts).__name__, "pp": ts._pp,
            "microbatches": ts._micro, "batches": nbatch,
            "norm_conv_launches": fit_launches,
            "host_backed": all(v.device.type == "cpu"
                               for v in got_p.values()),
            "max_abs": max(float((got_p[k] - want_p[k]).abs().max())
                           for k in want_p),
            "aux_max_abs": max([float((got_a[k] - want_a[k]).abs().max())
                                for k in want_a] or [0.0])}, got_p, want_p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ctx", choices=("cpu", "gpu"), default="gpu")
    ap.add_argument("--network", choices=("resnet", "convnet"),
                    default="convnet")
    ap.add_argument("--num-layers", type=int, default=20)
    ap.add_argument("--image", type=int, default=8)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch of a step")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--params", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--cases", default="gpipe:2:1:1,gpipe:2:1:4,"
                    "1f1b:2:1:4,interleaved:2:1:4:2")
    ap.add_argument("--norm-conv", action="store_true")
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--micro-ref", type=int, default=0)
    ap.add_argument("--floor-nudge", type=float, default=None)
    ap.add_argument("--floor-samples", type=int, default=2)
    ap.add_argument("--floor-refs", default="",
                    help="the references with nudged runs (default: all)")
    ap.add_argument("--floor-x", type=float, default=4.0)
    ap.add_argument("--floor-min", type=float, default=1e-7)
    ap.add_argument("--live", default="")
    ap.add_argument("--live-rows", type=int, default=1)
    ap.add_argument("--ckpt", action="store_true")
    ap.add_argument("--fit", type=int, default=0)
    ap.add_argument("--semantics", action="store_true")
    ap.add_argument("--refusals", action="store_true")
    ap.add_argument("--save-arrays", action="store_true")
    args = ap.parse_args(argv)
    import torch
    t_start = time.perf_counter()
    marks = {}
    card = args.ctx == "gpu"
    if card:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group()
    dist.ensure_group()
    marks["group"] = time.perf_counter()
    rank, world = dist.rank(), dist.num_workers()
    ctx = mt.gpu(0) if card else mt.cpu()
    dtype = mt.base.torch_dtype(args.dtype)
    shape = (args.batch, 3, args.image, args.image)
    if args.network == "convnet":
        net = convnet(mt, args.classes)
    else:
        net = mt.models.resnet.get_symbol(
            args.classes, args.num_layers,
            "3,%d,%d" % (args.image, args.image))
    if args.params:
        params, aux = load_state(args.params, dtype)
    else:
        ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
        p0, _, a0 = ts0.init({"data": shape}, {"softmax_label": shape[:1]},
                             seed=args.seed)
        params = {k: v.to(dtype) for k, v in p0.items()}
        aux = {k: v.to(dtype) for k, v in a0.items()}
    marks["state"] = time.perf_counter()
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
    run = Runner(torch, net, params, aux, batches, ctx, card, args.steps)
    run.single_step_ms = None
    report = {"rank": rank, "world": world, "route": dist.route(),
              "p2p_route": dist.p2p_route(
                  torch.empty(1, device=ctx.torch_device())),
              "device": str(ctx.torch_device()), "cases": [], "ok": True}
    arrays = {}
    t_setup = time.perf_counter() - t_start
    marks["setup_end"] = time.perf_counter()

    def keep(tag, lp, la):
        if args.save_arrays and rank == 0:
            for n, v in lp.items():
                arrays[tag + "arg:" + n] = v
            for n, v in la.items():
                arrays[tag + "aux:" + n] = v

    count_norm_conv_calls()
    # the references over the whole global batch, and their floors
    t0 = time.perf_counter()
    refs, floors = {}, {}
    jobs = []
    gen = torch.Generator().manual_seed(args.seed + 21)
    nudges = []
    if args.floor_nudge is not None:
        for _ in range(args.floor_samples):
            nudges.append({k: (v.double() * (1 + args.floor_nudge * (
                2 * torch.rand(v.shape, generator=gen,
                               dtype=torch.float64) - 1))).to(v.dtype)
                for k, v in params.items()})
    mesh1 = own_mesh(world, rank) if args.micro_ref else None
    kinds = (["single"] if args.single else []) + (
        ["micro%d" % args.micro_ref] if args.micro_ref else [])
    floor_kinds = [k for k in (args.floor_refs.split(",")
                               if args.floor_refs else kinds) if k in kinds]
    for kind in kinds:
        for i, src in enumerate([params] + (nudges if kind in floor_kinds
                                            else [])):
            if kind == "single":
                fn = (lambda src=src: run.single(src))
            else:
                fn = (lambda src=src: run.micro(src, args.micro_ref, mesh1))
            jobs.append(("%s/%d" % (kind, i), fn))
    if jobs:
        like_p = {k: v for k, v in params.items()}
        keys, vec = flat(torch, like_p, aux)
        got = shared_references(torch, jobs, world, rank, vec.shape,
                                vec.dtype)
        like = dict(params, **aux)
        for kind in kinds:
            base = unflat(keys, got["%s/0" % kind], like)
            refs[kind] = base
            keep(kind + "/", {k: base[k] for k in params},
                 {k: base[k] for k in aux})
            if kind not in floor_kinds:
                continue
            fl = {k: 0.0 for k in base}
            for i in range(1, len(nudges) + 1):
                other = unflat(keys, got["%s/%d" % (kind, i)], like)
                fl = {k: max(fl[k], float((other[k].double()
                                           - base[k].double()).abs().max()))
                      for k in base}
            floors[kind] = fl
        report["floors"] = {k: {"max": max(v.values()), "samples":
                                len(nudges)} for k, v in floors.items()}
        # one process's TrainStep over the global batch, on the rank that
        # ran its last job (beside the pipeline's step)
        report["single_step_ms"] = run.single_step_ms
        report["single_img_per_s"] = args.batch / run.single_step_ms \
            * 1e3 if run.single_step_ms else None
    t_refs = time.perf_counter() - t0
    marks["references_end"] = time.perf_counter()

    cases = parse_cases(args.cases)
    variants = [False] + ([True] if args.norm_conv else [])
    first = None
    for nc_on in variants:
        was = os.environ.get("MXNET_NORM_CONV")
        if nc_on:
            os.environ["MXNET_NORM_CONV"] = "1"
        try:
            for case in cases:
                sched, pp, dp, m, v = case
                if pp * dp != world:
                    raise SystemExit("case %s: pp x dp != world %d"
                                     % (case_tag(case), world))
                tag = ("nc-" if nc_on else "") + case_tag(case)
                mesh = pmesh.make_pp_mesh(pp, dp=dp)
                ck = None
                if args.ckpt and not nc_on:
                    def ck(ts, p, s, a, tag=tag):
                        from mxnet_tpu_torch import checkpoint as ckm
                        c = ckm.Checkpointer(os.path.join(
                            args.out, "ck0-" + tag, "m"), async_=False)
                        c.save(ts, p, s, a)
                        dist.barrier()
                row, lp, la, ts, live = run.pipeline(mesh, sched, m, v,
                                                     ckpt=ck)
                mb = slice_mb(ts, lp)
                row.update({
                    "tag": tag, "schedule": sched, "pp": pp, "dp": dp,
                    "microbatches": m, "interleave": v,
                    "norm_conv": nc_on,
                    "my_stages": ts.my_stages(),
                    "pp_bubble_fraction": round(
                        pipeline_bubble_fraction(pp, m, v), 4),
                    "stage_param_mb": [round(x, 3) for x in mb],
                    "pp_stage_param_mb_max": round(max(mb), 3),
                    "replicated_param_mb": round(sum(mb), 3)})
                ref = "single" if m == 1 else "micro%d" % m
                if ref in refs:
                    row["reference"] = ref
                    want = refs[ref]
                    got = dict(lp, **la)
                    row["max_abs_vs_reference"] = max(
                        float((got[k].double() - want[k]).abs().max())
                        for k in want)
                    fkind = ref if ref in floors else (
                        floor_kinds[0] if floor_kinds else None)
                    if fkind in floors:
                        row["floor_of"] = fkind
                        row["worst_over_floor"] = worst_over_floor(
                            got, want, floors[fkind], args.floor_x,
                            args.floor_min)
                keep(tag + "/", lp, la)
                report["cases"].append(row)
                print(json.dumps({"rank": rank, "pp_case": row},
                                 sort_keys=True), flush=True)
                if first is None:
                    first = (ts, live, lp, la)
                else:
                    del ts, live
                if card:
                    torch.cuda.empty_cache()
        finally:
            if was is None:
                os.environ.pop("MXNET_NORM_CONV", None)
            else:
                os.environ["MXNET_NORM_CONV"] = was
    t_cases = time.perf_counter() - t0 - t_refs

    marks["cases_end"] = time.perf_counter()
    if args.live:
        lad = []
        for sched in ("gpipe", "1f1b"):
            for m in [int(x) for x in args.live.split(",")]:
                blb = args.live_rows * m * world
                rs = np.random.default_rng(args.seed + 2)
                lb = {"data": torch.from_numpy(rs.uniform(
                    -1, 1, (1, blb) + shape[1:])).to(dtype),
                    "softmax_label": torch.from_numpy(rs.integers(
                        0, args.classes, (1, blb))).to(dtype)}
                lrun = Runner(torch, net, params, aux, lb, ctx, card, 1)
                row = lrun.pipeline(pmesh.make_pp_mesh(world), sched, m, 1,
                                    gather=False)[0]
                lad.append({"schedule": sched, "pp": world,
                            "microbatches": m,
                            "microbatch_rows": args.live_rows * world,
                            "pp_live_bytes_max_mb":
                                row["pp_live_bytes_max_mb"],
                            "last_live_bytes": row["last_live_bytes"],
                            "max_memory_allocated_mb":
                                row["max_memory_allocated_mb"]})
                if card:
                    torch.cuda.empty_cache()
        report["live_bytes_ladder"] = lad

    marks["live_end"] = time.perf_counter()
    if args.ckpt and first is not None:
        from mxnet_tpu_torch import checkpoint as ckm
        ts, (p, s, a), lp, la = first
        path = ckm.Checkpointer(os.path.join(args.out, "ck", "m"),
                                async_=False).save(ts, p, s, a)
        dist.barrier()
        # into the same pipeline: this rank's tensors, bitwise
        ts2 = PipelineTrainStep(net, make_opt(args.batch), mesh=ts.mesh,
                                num_microbatches=ts._micro,
                                schedule=ts._schedule, interleave=ts._v,
                                ctx=ctx)
        p2, s2, a2, man = ckm.restore_into(ts2, path)
        same_pp = all(torch.equal(p2[n], p[n]) for n in p) and all(
            torch.equal(a2[n], a[n]) for n in a) and all(
            torch.equal(x, y) for n in s for x, y in zip(s2[n], s[n]))
        # into one process's TrainStep: every logical tensor, bitwise
        t1 = mt.TrainStep(net, make_opt(args.batch), ctx=ctx)
        p1, s1, a1, _ = ckm.restore_into(t1, path)
        lp_, ls_, la_ = ts.gather_host(p, s, a)
        same_one = all(torch.equal(p1[n].cpu(), lp_[n]) for n in lp_) and \
            all(torch.equal(a1[n].cpu(), la_[n]) for n in la_) and all(
                torch.equal(x.cpu(), y) for n in ls_
                for x, y in zip(s1[n], ls_[n]))
        # a one-process save restored into the pipeline
        path1 = ckm.Checkpointer(os.path.join(args.out, "ck1", "m"),
                                 async_=False).save(t1, p1, s1, a1)
        dist.barrier()
        ts3 = PipelineTrainStep(net, make_opt(args.batch), mesh=ts.mesh,
                                num_microbatches=ts._micro,
                                schedule=ts._schedule, interleave=ts._v,
                                ctx=ctx)
        p3, s3, a3, _ = ckm.restore_into(ts3, path1)
        same_back = all(torch.equal(p3[n], p[n]) for n in p) and all(
            torch.equal(a3[n], a[n]) for n in a)
        report["ckpt"] = {"path": path, "topology": man["topology"],
                          "step": ts2.num_update, "pp_bitwise": same_pp,
                          "one_process_bitwise": same_one,
                          "one_to_pp_bitwise": same_back}
        del ts2, ts3, t1, p1, s1, a1, p2, s2, a2, p3, s3, a3
    first = None
    if card:
        torch.cuda.empty_cache()
    marks["ckpt_end"] = time.perf_counter()
    if args.fit:
        rep, fp, wp = fit_check(torch, run, world, args.fit)
        report["fit"] = rep
        keep("fit/", fp, {})
        keep("fitref/", wp, {})
    marks["fit_end"] = time.perf_counter()
    if args.semantics:
        report["semantics"] = semantics_checks(torch, ctx, world)
    if args.refusals:
        report["refusals"] = refusal_checks(torch, net, ctx, world,
                                            args.batch)
    report["norm_conv_launches"] = nc.launches
    report["norm_conv_stats_launches"] = nc.stats_launches
    marks["end"] = time.perf_counter()
    report["seconds"] = {"setup": t_setup, "references": t_refs,
                         "cases": t_cases,
                         "total": time.perf_counter() - t_start,
                         "parts": {k: marks[k] - t_start
                                   for k in sorted(marks)}}
    report["ok"] = all(r["outputs_finite"] for r in report["cases"])
    os.makedirs(args.out, exist_ok=True)
    if args.save_arrays and rank == 0:
        mt.nd.save(os.path.join(args.out, "rank0.params"),
                   {k: mt.nd.NDArray(v.contiguous()) for k, v in
                    arrays.items()})
    with open(os.path.join(args.out, "rank%d.json" % rank), "w") as f:
        json.dump(report, f, sort_keys=True)
    print(json.dumps({"rank": rank, "ok": report["ok"],
                      "seconds": report["seconds"]}), flush=True)
    dist.barrier()
    dist.shutdown_process_group()
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
