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

``--cases`` lists ``schedule:pp:dp:M[:v][:z<level>][:<precision>]``; each
runs ``--steps`` steps (pp x dp must be the world) at that ZeRO level
(default 0) and precision: ``f32`` (default), ``bf16`` (the bfloat16
policy), ``cast`` (``dtype="bfloat16"``) or ``amp32`` (the float32 policy
at a loss scale of LOSS_SCALE).  A case's row, under the field names of
``MULTICHIP_PP_r02.json``: ``pp_bubble_fraction``, ``stage_param_mb``
(each slice's parameter MB), ``pp_stage_param_mb_max``,
``replicated_param_mb``, ``pp_live_bytes_max_mb`` and
``pp_step_time_ms`` (the median of the steps after the first), with the
update's ms, img/s, ``last_live_bytes``, this rank's peak of
``torch.cuda.max_memory_allocated`` (card), its P2P transfers a step
(``dist.collective_calls`` / ``_bytes`` / ``_seconds`` by kind, and the
pinned staging copies), and its NormConv launches a step (with
statistics, and in bfloat16; ``norm_conv_calls_per_step`` counts the calls
of the kernel's and the plain version's alike), the plan's bytes
(``zero_bytes``, ``zero_bytes_by_slice``; ``plan_bytes_mine`` with the
moving statistics beside ``resident_bytes``, what the placement
allocated on the card), the shapes of this rank's parameters and state
rows, ``amp_stats`` and the outputs' dtypes.  ``--norm-conv`` runs every
case again under ``MXNET_NORM_CONV=1`` (tag ``nc-``); ``--mlp-cases`` runs
cases on a three-layer MLP of 32 inputs in float32 (``--mlp-params``,
``--mlp-data``; tag ``mlp-``).

References, each over the whole global batch on every rank: ``--single``
one process's ``TrainStep`` (tag ``single/``), ``--micro-ref M[,M]`` one
process's ``PipelineTrainStep`` with pp=1 and M microbatches (tag
``micro<M>/``); with ``--single``, each case that rounds to bfloat16
(``bf16``, ``cast``) also gets its own under its precision
(``single-bf16/`` at M=1, ``micro<M>-bf16/`` otherwise).  The float32
references that ``--floor-refs`` names also run from ``--floor-samples``
nudges of the parameters by a relative ``--floor-nudge``, the bfloat16
ones by BF16_FLOOR_NUDGE (shared out over the ranks): a leaf's floor is
the largest distance of those runs from the reference.  A case's
``worst_over_floor`` is its largest distance to its reference (``single``
at M=1, ``micro<M>`` otherwise, with the precision's suffix) over
``--floor-x`` times that leaf's floor (its reference's, else
``single``'s).
``--floors-out`` / ``--refs-out PATH:KIND,..`` write the floors and
references rank 0 holds, which another world reads with ``--floors-in`` /
``--refs-in``: after its cases, waiting up to SHARED_WAIT_S for the files,
so both worlds may run at once.

``--live M1,M2`` runs gpipe and 1f1b at pp=world with ``--live-rows``
rows a microbatch at each M, one step each (the live-bytes ladder).
``--ckpt`` saves the loaded state under every case's topology before its
first step (``DIR/ck0-<case>``) and the first case's state after its
steps (``DIR/ck``), then restores that into the same pipeline and into one
process's ``TrainStep`` (bitwise), and a one-process save (``DIR/ck1``)
into the pipeline.  ``--restore-check CASE``: the case's state after its
steps saved, restored into the same mesh at ZeRO level 0 and into one
process's ``TrainStep``, each continued as far (and the loss-scale state
carried).  ``--overflow CASE``: one step of a policy's case on a batch
with an inf in the first microbatch (nothing may move).
``--row-overflow CASE[,CASE]``: one step of each (a policy's, with a
bucket) on a clean batch, rank 0 alone finding an inf in its first
stage's bucket row: every rank must skip on the world's verdict.  ``--fit N``:
``Module.fit`` under ``MXNET_PP=world`` and ``MXNET_PP_MICROBATCH=1`` over
the first N global batches, against a ``PipelineTrainStep`` over the same
batches; ``--toy-fit``: ``Module.fit`` of a linearly separable toy under
``MXNET_PP=2`` with ``MXNET_ZERO=3`` and with ``MXNET_AMP=1``, each against
its ``PipelineTrainStep``.  ``--semantics``: a ``'batch'``-normalized head
at M=world against one process's step, and a ``'valid'`` one refused at
M > 1.  ``--refusals``: the refusals that stay (a ``tp`` axis, no ``pp``
axis, ``TrainStep`` on a ``pp`` mesh, ``dtype=`` with ``policy=``, ZeRO
without a ``dp`` axis) and a step each of ZeRO, AMP, the pure bfloat16
cast and ``MXNET_PP`` with ``MXNET_ZERO`` / ``MXNET_AMP`` in a fit.

``--out DIR`` writes ``rank<r>.json`` (printed too) and, with
``--save-arrays``, rank 0's ``rank0.params``: every case's and
reference's logical parameters and aux states.
"""
import argparse
import gc
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
# the float32 policy's initial loss scale (the JAX package's AMP tests')
LOSS_SCALE = 1024.0
# the seconds a world waits for another's --floors-in / --refs-in files
SHARED_WAIT_S = 600.0


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


def mlp(mt_, classes=8):
    """Three fully connected layers (16 relu, 16 tanh, ``classes``) and a
    softmax head over 32 inputs: cut into four stages, the bare loss head
    is a stage without parameters."""
    S = mt_.sym
    h = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=16)
    h = S.FullyConnected(S.Activation(h, act_type="relu"), name="fc2",
                         num_hidden=16)
    h = S.FullyConnected(S.Activation(h, act_type="tanh"), name="fc3",
                         num_hidden=classes)
    return S.SoftmaxOutput(h, name="softmax")


def toy_net(mt_, classes=2):
    S = mt_.sym
    h = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=32)
    h = S.FullyConnected(S.Activation(h, act_type="relu"), name="fc2",
                         num_hidden=classes)
    return S.SoftmaxOutput(h, name="softmax")


def make_opt(batch):
    return mt.optimizer.SGD(learning_rate=LR, momentum=MOMENTUM, wd=WD,
                            rescale_grad=1.0 / batch)


# the precisions of a case: no policy; the bfloat16 policy; the pure
# bfloat16 cast; the float32 policy (the loss scale's machinery, float32
# numerics) at LOSS_SCALE
PRECISIONS = ("f32", "bf16", "cast", "amp32")


def parse_case(text):
    """``schedule:pp:dp:M[:v][:z<level>][:<precision>]`` -> (schedule, pp,
    dp, M, v, level, precision); v defaults to 2 for the interleaved
    schedule, else 1, the level to 0 and the precision to f32."""
    f = text.split(":")
    v = 2 if f[0] == "interleaved" else 1
    level, prec = 0, "f32"
    for x in f[4:]:
        if x.isdigit():
            v = int(x)
        elif x.startswith("z"):
            level = int(x[1:])
        elif x in PRECISIONS:
            prec = x
        else:
            raise SystemExit("case %s: field %r is no interleave, z<level> "
                             "or precision %s" % (text, x, PRECISIONS))
    return (f[0], int(f[1]), int(f[2]), int(f[3]), v, level, prec)


def parse_cases(text):
    return [parse_case(c) for c in text.split(",") if c]


def case_tag(case):
    sched, pp, dp, m, v, level, prec = case
    return "%s-pp%d-dp%d-m%d-v%d%s%s" % (
        sched, pp, dp, m, v, "-z%d" % level if level else "",
        "" if prec == "f32" else "-" + prec)


def precision_kw(prec):
    """PipelineTrainStep / TrainStep keywords of a precision."""
    if prec == "bf16":
        return {"policy": mt.amp.Policy("bfloat16")}
    if prec == "cast":
        return {"dtype": "bfloat16"}
    if prec == "amp32":
        return {"policy": mt.amp.Policy("float32", loss_scale=LOSS_SCALE)}
    return {}


# the precisions that round to bfloat16, held to references of their own
LOW_PRECISIONS = ("bf16", "cast")
# the relative nudge of the bfloat16 references' floor runs (the JAX
# package's bf16 floor, and chip_smoke's AMP phase's)
BF16_FLOOR_NUDGE = 2.0 ** -9


def ref_kind(m, prec):
    """The reference a case of M microbatches is held to: one process's
    TrainStep at M=1, its pp=1 step of M microbatches otherwise, under the
    case's precision where it rounds to bfloat16 (the float32 policy
    computes the float32 step's math)."""
    base = "single" if m == 1 else "micro%d" % m
    return base + "-" + prec if prec in LOW_PRECISIONS else base


def predicted_collectives(case, rank, stages):
    """A step's collectives by kind on ``rank`` for ``case`` (BatchNorm's
    ``stats`` and the P2P kinds aside); ``stages`` has one entry a virtual
    stage, true where the stage holds parameters.  In the bucket (ZeRO
    2-3, or 1f1b / interleaved at dp > 1) a reduce-scatter a microbatch a
    stage, below it one all-reduce a stage (gpipe, levels 0-1); the
    all-gathers of the updated rows (levels 1-2), of the stage's gradient
    row (level 0 under the overlap) and of level 3's parameters (2 M a
    stage); the outputs' gathers on the final slice (M); one verdict under
    a policy."""
    sched, pp, dp, m, v, level, prec = case
    s = rank % pp
    overlap = dp > 1 and sched != "gpipe"
    bucket = level >= 2 or overlap
    want = {}

    def add(kind, n):
        if n:
            want[kind] = want.get(kind, 0) + n
    for k, holds in enumerate(stages):
        if k % pp != s or not holds or dp == 1:
            continue
        add("reduce_scatter", m if bucket else 0)
        add("all_reduce", 0 if bucket else 1)
        add("all_gather", (2 * m if level == 3 else 0)
            + (1 if level in (1, 2) else 0)
            + (1 if overlap and level == 0 else 0))
    add("all_gather", m if s == pp - 1 and dp > 1 else 0)
    add("verdict", 1 if prec in ("amp32", "bf16") else 0)
    return want


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

    def make(self, mesh, schedule, m, v, zero=0, prec="f32"):
        return PipelineTrainStep(self.net, make_opt(self.batch), mesh=mesh,
                                 num_microbatches=m, schedule=schedule,
                                 interleave=v, zero=zero, ctx=self.ctx,
                                 **precision_kw(prec))

    def pipeline(self, mesh, schedule, m, v, zero=0, prec="f32",
                 params=None, ckpt=None, gather=True):
        """One case: (row, logical params and aux (None unless
        ``gather``), step, placed)."""
        torch = self.torch
        ts = self.make(mesh, schedule, m, v, zero, prec)
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
        if self.card:
            # the earlier cases' steps and their freed blocks out of the
            # allocator's way: the placement's bytes alone
            gc.collect()
            torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated() if self.card else 0
        p, s, a = ts.place_checkpoint(params or self.params, None, self.aux)
        resident = torch.cuda.memory_allocated() - m0 if self.card else None
        if ckpt is not None:
            ckpt(ts, p, s, a)
        if self.card:
            torch.cuda.reset_peak_memory_stats()
        dist.reset_collectives()
        launched = (nc.launches, nc.stats_launches, _NC_CALLS[0],
                    nc.bf16_launches)
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
        by_slice = ts.zero_bytes(p, s, by_slice=True)
        mine = by_slice[ts._slice]
        aux_nb = sum(int(x.numel()) * x.element_size() for x in a.values())
        row = {
            "launches_per_step": (nc.launches - launched[0]) / steps,
            "stats_launches_per_step":
                (nc.stats_launches - launched[1]) / steps,
            "norm_conv_calls_per_step": (_NC_CALLS[0] - launched[2]) / steps,
            "bf16_launches_per_step": (nc.bf16_launches - launched[3])
            / steps,
            "pp_step_time_ms": float(np.median(later)) * 1e3,
            "update_ms": float(np.median(upd[1:] or upd)) * 1e3,
            "img_per_s": self.batch / float(np.median(later)),
            "collectives_per_step": p2p,
            "p2p_staged_copies_per_step": dist.p2p_staged_copies[0] / steps,
            "last_live_bytes": list(ts.last_live_bytes),
            "pp_live_bytes_max_mb": round(max(ts.last_live_bytes) / 1e6, 3),
            "max_memory_allocated_mb": torch.cuda.max_memory_allocated()
            / 1e6 if self.card else None,
            "zero_bytes": ts.zero_bytes(p, s),
            "zero_bytes_by_slice": by_slice,
            # this rank's placement against the plan's bytes of its slice
            # and its moving statistics
            "plan_bytes_mine": mine["param"] + mine["opt"] + aux_nb,
            "resident_bytes": resident,
            "row_shapes": {n: [list(p[n].shape)]
                           + [list(x.shape) for x in s[n]] for n in p},
            "stage_holds_params": [bool(st.params) for st in ts.stages()],
            "amp_stats": ts.amp_stats(),
            "outputs_finite": bool(all(torch.isfinite(o).all()
                                       for o in outs)),
            "output_shapes": [list(o.shape) for o in outs],
            "output_dtypes": [str(o.dtype).replace("torch.", "")
                              for o in outs]}
        lp = la = None
        if gather:
            lp, _, la = ts.gather_host(p, None, a)
        return row, lp, la, ts, (p, s, a)

    def single(self, params, prec="f32"):
        ts = mt.TrainStep(self.net, make_opt(self.batch), ctx=self.ctx,
                          **precision_kw(prec))
        p, s, a = ts.place_checkpoint(params, None, self.aux)
        marks = []
        for i in range(self.steps):
            self.sync()
            t0 = time.perf_counter()
            p, s, a, _ = ts(p, s, a, self.step_batch(i))
            self.sync()
            marks.append(time.perf_counter() - t0)
        if prec == "f32":
            # the steps after the first (its kernels' set-up aside)
            self.single_step_ms = float(np.median(marks[1:] or marks)) * 1e3
        return ({n: host(v) for n, v in p.items()},
                {n: host(v) for n, v in a.items()})

    def micro(self, params, m, mesh, prec="f32"):
        ts = PipelineTrainStep(self.net, make_opt(self.batch), mesh=mesh,
                               num_microbatches=m, ctx=self.ctx,
                               **precision_kw(prec))
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
    """The refusals that stay (True: raised with their words), and the
    ZeRO level, policy, pure cast and fit knobs that the pipeline once
    refused ("stepped": built, and one step taken)."""
    MXNetError = mt.base.MXNetError

    def raises(fn, words):
        try:
            fn()
        except MXNetError as exc:
            return words in str(exc)
        return False
    mesh = pmesh.make_pp_mesh(world)
    res = {
        "tp_axis": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), ctx=ctx,
            mesh=pmesh.make_mesh({"pp": 1, "tp": -1})),
            "composes with dp only"),
        "no_pp_axis": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), mesh=pmesh.make_mesh({"dp": -1}),
            ctx=ctx), "needs a mesh with a 'pp' axis"),
        "trainstep_pp_axis": raises(lambda: mt.TrainStep(
            net, make_opt(batch), mesh=mesh, ctx=ctx), "PipelineTrainStep"),
        "dtype_with_policy": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), mesh=mesh, ctx=ctx, dtype="bfloat16",
            policy=mt.amp.Policy("bfloat16")), "not both"),
        "zero_without_dp_axis": raises(lambda: PipelineTrainStep(
            net, make_opt(batch), mesh=pmesh.make_mesh({"pp": -1}), zero=1,
            ctx=ctx), "needs a mesh with a 'dp' axis")}
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (2 * world, 3, 8, 8)).astype(np.float32)
    y = rs.randint(0, 4, 2 * world).astype(np.float32)
    small = convnet(mt, 4)
    for key, kw in (("zero", {"zero": 1}),
                    ("policy", {"policy": mt.amp.Policy("bfloat16")}),
                    ("dtype", {"dtype": "bfloat16"})):
        ts = PipelineTrainStep(small, make_opt(2 * world), mesh=mesh,
                               num_microbatches=2, ctx=ctx, **kw)
        p, s, a = ts.init({"data": x.shape}, {"softmax_label": y.shape})
        _, _, _, outs = ts(p, s, a, {"data": x, "softmax_label": y})
        res[key] = "stepped" if all(bool(torch.isfinite(o).all())
                                    for o in outs) else "not finite"
    for knob, value in (("MXNET_ZERO", "1"), ("MXNET_AMP", "1")):
        os.environ["MXNET_PP"] = str(world)
        os.environ[knob] = value
        try:
            mod = mt.Module(small, context=ctx)
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=2 * world),
                    num_epoch=1, optimizer="sgd")
            ts = mod._fused_ts_cache[1]
            took = isinstance(ts, PipelineTrainStep) and ts.num_update == 1
            res["fit_MXNET_PP+%s" % knob] = "stepped" if took else repr(ts)
        finally:
            del os.environ[knob], os.environ["MXNET_PP"]
    return res


def overflow_check(torch, run, case, row=False):
    """One step of ``case`` (a policy's) on a batch with one inf in the
    first microbatch's data, or, with ``row``, on a clean batch while rank
    0 alone finds an inf in its first stage's bucket row (its share of the
    reduced gradients): this rank's own verdict before the world's, its
    parameters, optimizer state and aux states bitwise their pre-step
    values, and the loss-scale state after it."""
    sched, pp, dp, m, v, level, prec = case
    ts = run.make(pmesh.make_pp_mesh(pp, dp=dp), sched, m, v, level, prec)
    p, s, a = ts.place_checkpoint(run.params, None, run.aux)
    before = ({n: x.clone() for n, x in p.items()},
              {n: tuple(x.clone() for x in st) for n, st in s.items()},
              {n: x.clone() for n, x in a.items()})
    b = {k: x.clone() for k, x in run.step_batch(0).items()}
    if not row:
        b["data"].view(-1)[0] = float("inf")
    elif not ts._bucket:
        raise SystemExit("--row-overflow %s: no bucket rows (ZeRO level >= "
                         "2, or 1f1b / interleaved at dp > 1)"
                         % case_tag(case))
    elif dist.rank() == 0:
        accumulate, k0 = ts._accumulate, ts.my_stages()[0]

        def poisoned(k, acc, leaves, grads):
            accumulate(k, acc, leaves, grads)
            if k == k0:
                acc[k].view(-1)[0] = float("inf")
        ts._accumulate = poisoned
    own = []
    agree = ts._agree

    def judged(finite):
        own.append(bool(finite))
        return agree(finite)
    ts._agree = judged
    p, s, a, outs = ts(p, s, a, b)
    run.sync()
    return {"tag": case_tag(case), "own_verdict": own,
            "params_bitwise": all(torch.equal(p[n], before[0][n])
                                  for n in p),
            "state_bitwise": all(torch.equal(x, y) for n in s
                                 for x, y in zip(s[n], before[1][n])),
            "aux_bitwise": all(torch.equal(a[n], before[2][n]) for n in a),
            "amp_stats": ts.amp_stats(),
            "scale_state": ts.scale_state_host()}


def restore_check(torch, run, case, out):
    """``case`` (M=1) for the run's steps, saved, then restored into the
    same mesh at ZeRO level 0 and into one process's ``TrainStep`` (the
    case's precision); each of the three goes on for the same steps again.
    The largest difference of each continuation from the case's own, the
    restores against the saved state, and the loss-scale state before and
    after the restore."""
    from mxnet_tpu_torch import checkpoint as ckm
    sched, pp, dp, m, v, level, prec = case
    mesh = pmesh.make_pp_mesh(pp, dp=dp)
    ts = run.make(mesh, sched, m, v, level, prec)
    p, s, a = ts.place_checkpoint(run.params, None, run.aux)
    for i in range(run.steps):
        p, s, a, _ = ts(p, s, a, run.step_batch(i))
    path = ckm.Checkpointer(os.path.join(out, "ckz", "m"),
                            async_=False).save(ts, p, s, a)
    dist.barrier()
    saved = ts.gather_host(p, s, a)
    scale = ts.scale_state_host()
    t0 = run.make(mesh, sched, m, v, 0, prec)
    p0, s0, a0, man = ckm.restore_into(t0, path)
    t1 = mt.TrainStep(run.net, make_opt(run.batch), ctx=run.ctx,
                      **precision_kw(prec))
    p1, s1, a1, _ = ckm.restore_into(t1, path)
    got0 = t0.gather_host(p0, s0, a0)
    same = all(torch.equal(x, y) for t_, u_ in zip(got0, saved)
               for n in u_ for x, y in zip(
                   t_[n] if isinstance(t_[n], tuple) else (t_[n],),
                   u_[n] if isinstance(u_[n], tuple) else (u_[n],)))
    same1 = all(torch.equal(p1[n].cpu(), saved[0][n]) for n in p1) and \
        all(torch.equal(x.cpu(), y) for n in s1
            for x, y in zip(s1[n], saved[1][n]))
    scales = (t0.scale_state_host(), t1.scale_state_host())
    for i in range(run.steps):
        b = run.step_batch(i)
        p, s, a, _ = ts(p, s, a, b)
        p0, s0, a0, _ = t0(p0, s0, a0, b)
        p1, s1, a1, _ = t1(p1, s1, a1, b)
    want_p, _, want_a = ts.gather_host(p, None, a)
    got_p, _, got_a = t0.gather_host(p0, None, a0)

    def worst(gp, ga):
        return max(float((gp[k].cpu().double() - want_p[k].double())
                         .abs().max()) for k in want_p) if not ga else max(
            max(float((gp[k].cpu().double() - want_p[k].double()).abs()
                      .max()) for k in want_p),
            max(float((ga[k].cpu().double() - want_a[k].double()).abs()
                      .max()) for k in want_a))
    return {"tag": case_tag(case), "path": path,
            "topology": man["topology"], "restored_bitwise": same,
            "one_process_restored_bitwise": same1,
            "scale_saved": scale, "scale_restored": list(scales),
            "zero0_max_abs": worst(got_p, got_a),
            "one_process_max_abs": worst(p1, a1),
            "step": t0.num_update}


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


# the toy fits: (label, environment knobs)
TOY_FITS = (("zero3", {"MXNET_PP": "2", "MXNET_PP_MICROBATCH": "2",
                       "MXNET_ZERO": "3"}),
            ("amp", {"MXNET_PP": "2", "MXNET_PP_MICROBATCH": "2",
                     "MXNET_AMP": "1"}))


def toy_fit(torch, ctx, env, epochs=4, batch=16, lr=0.5):
    """``Module.fit`` of a linearly separable toy (64 rows of 16 inputs, two
    classes) under the knobs ``env`` for ``epochs`` epochs, against a
    ``PipelineTrainStep`` of the same level and policy over the same
    batches: the largest parameter difference and the fit's accuracy."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (64, 16)).astype(np.float32)
    w = rs.uniform(-1, 1, (16,))
    y = (x @ w > 0).astype(np.float32)
    net = toy_net(mt)
    p0, _, a0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu()).init(
        {"data": (batch, 16)}, {"softmax_label": (batch,)}, seed=0)

    def it():
        return mt.io.NDArrayIter(x, y, batch_size=batch, shuffle=False,
                                 label_name="softmax_label")
    os.environ.update(env)
    try:
        policy = mt.amp.resolve_policy()
        mod = mt.Module(net, context=ctx)
        mod.fit(it(), num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": lr},
                arg_params={k: mt.nd.NDArray(v.clone())
                            for k, v in p0.items()},
                aux_params={}, eval_metric="acc")
    finally:
        for k in env:
            del os.environ[k]
    ts = mod._fused_ts_cache[1]
    acc = dict(mod.score(it(), mt.metric.Accuracy()))["accuracy"]
    pp = int(env["MXNET_PP"])
    ref = PipelineTrainStep(
        net, mt.optimizer.SGD(learning_rate=lr, rescale_grad=1.0 / batch),
        mesh=pmesh.make_pp_mesh(pp),
        num_microbatches=int(env["MXNET_PP_MICROBATCH"]),
        zero=int(env.get("MXNET_ZERO", 0)), policy=policy, ctx=ctx)
    p, s, a = ref.place_checkpoint(p0, None, {})
    for _ in range(epochs):
        for b in range(x.shape[0] // batch):
            p, s, a, _ = ref(p, s, a, {
                "data": x[b * batch:(b + 1) * batch],
                "softmax_label": y[b * batch:(b + 1) * batch]})
    want = ref.gather_params(p)
    got = {k: v.value.cpu() for k, v in mod.get_params()[0].items()}
    return {"pipeline": type(ts).__name__, "zero": ts.zero,
            "policy": None if ts.policy is None else ts.policy.describe(),
            "pp": ts._pp, "dp": ts._dp, "updates": ts.num_update,
            "accuracy": acc,
            "max_abs": max(float((got[k] - want[k]).abs().max())
                           for k in want)}


def compare(args, row, got, refs, floors):
    """A case's logical state ``got`` against its reference: the largest
    difference and ``worst_over_floor`` in ``row``."""
    ref = ref_kind(row["microbatches"], row["precision"])
    if ref not in refs:
        return
    row["reference"] = ref
    want = refs[ref]
    row["max_abs_vs_reference"] = max(
        float((got[k].double() - want[k].double()).abs().max())
        for k in want)
    fkind = ref if ref in floors else "single"
    if fkind in floors:
        row["floor_of"] = fkind
        row["worst_over_floor"] = worst_over_floor(
            got, want, floors[fkind], args.floor_x, args.floor_min)


def run_cases(args, torch, run, cases, variants, report, refs, floors,
              keep, prefix="", late=None):
    """Every case of ``cases`` (again under MXNET_NORM_CONV=1 for each True
    of ``variants``): its row in ``report["cases"]``, its logical state
    kept, compared with its reference (or, with ``late``, a list, kept
    there for ``compare`` once the references are in); returns the first
    case's (step, placed, params, aux)."""
    rank, world, card = report["rank"], report["world"], run.card
    first = None
    for nc_on in variants:
        was = os.environ.get("MXNET_NORM_CONV")
        if nc_on:
            os.environ["MXNET_NORM_CONV"] = "1"
        try:
            for case in cases:
                sched, pp, dp, m, v, level, prec = case
                if pp * dp != world:
                    raise SystemExit("case %s: pp x dp != world %d"
                                     % (case_tag(case), world))
                tag = prefix + ("nc-" if nc_on else "") + case_tag(case)
                mesh = pmesh.make_pp_mesh(pp, dp=dp)
                ck = None
                if args.ckpt and not nc_on:
                    def ck(ts, p, s, a, tag=tag):
                        from mxnet_tpu_torch import checkpoint as ckm
                        c = ckm.Checkpointer(os.path.join(
                            args.out, "ck0-" + tag, "m"), async_=False)
                        c.save(ts, p, s, a)
                        dist.barrier()
                row, lp, la, ts, live = run.pipeline(mesh, sched, m, v, level,
                                                     prec, ckpt=ck)
                mb = slice_mb(ts, lp)
                row.update({
                    "tag": tag, "schedule": sched, "pp": pp, "dp": dp,
                    "microbatches": m, "interleave": v, "zero": level,
                    "precision": prec, "norm_conv": nc_on,
                    "my_stages": ts.my_stages(),
                    "pp_bubble_fraction": round(
                        pipeline_bubble_fraction(pp, m, v), 4),
                    "stage_param_mb": [round(x, 3) for x in mb],
                    "pp_stage_param_mb_max": round(max(mb), 3),
                    "replicated_param_mb": round(sum(mb), 3)})
                if late is None:
                    compare(args, row, dict(lp, **la), refs, floors)
                else:
                    late.append((row, dict(lp, **la)))
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
    return first


def reference_jobs(args, torch, run, params, world, rank, cases):
    """The references over the whole global batch (``--single``,
    ``--micro-ref``, and with ``--single`` the one of each case of
    ``cases`` that rounds to bfloat16) and their floors (nudged runs: the
    float32 references of ``--floor-refs`` by ``--floor-nudge``, the
    bfloat16 ones by BF16_FLOOR_NUDGE): (refs, floors, kinds)."""
    refs, floors = {}, {}
    kinds = (["single"] if args.single else []) + [
        "micro%d" % int(m) for m in args.micro_ref.split(",")
        if m and int(m)]
    low = sorted({ref_kind(c[3], c[6]) for c in cases
                  if c[6] in LOW_PRECISIONS}) if args.single else []
    kinds += low
    f32 = [k for k in (args.floor_refs.split(",") if args.floor_refs
                       else kinds) if k in kinds and k not in low]
    gen = torch.Generator().manual_seed(args.seed + 21)

    def nudge(x):
        return [{k: (v.double() * (1 + x * (
            2 * torch.rand(v.shape, generator=gen, dtype=torch.float64)
            - 1))).to(v.dtype) for k, v in params.items()}
            for _ in range(args.floor_samples)]
    nudges = {"f32": nudge(args.floor_nudge) if f32 and args.floor_nudge
              is not None else [],
              "low": nudge(BF16_FLOOR_NUDGE) if low else []}
    meshes = {}
    jobs = []
    for kind in kinds:
        base, _, prec = kind.partition("-")
        prec = prec or "f32"
        extra = nudges["low"] if kind in low else (
            nudges["f32"] if kind in f32 else [])
        for i, src in enumerate([params] + extra):
            if base == "single":
                fn = (lambda src=src, prec=prec: run.single(src, prec))
            else:
                m = int(base[len("micro"):])
                if "own" not in meshes:
                    meshes["own"] = own_mesh(world, rank)
                fn = (lambda src=src, m=m, prec=prec: run.micro(
                    src, m, meshes["own"], prec))
            jobs.append(("%s/%d" % (kind, i), fn))
    if not jobs:
        return refs, floors, kinds
    keys, vec = flat(torch, params, run.aux)
    got = shared_references(torch, jobs, world, rank, vec.shape, vec.dtype)
    like = dict(params, **run.aux)
    for kind in kinds:
        refs[kind] = base = unflat(keys, got["%s/0" % kind], like)
        if kind not in f32 and kind not in low:
            continue
        # no nudged runs: a floor of 0 (``--floor-min`` then bounds)
        n = sum(1 for name, _ in jobs if name.startswith(kind + "/")) - 1
        fl = {k: 0.0 for k in base}
        for i in range(1, n + 1):
            other = unflat(keys, got["%s/%d" % (kind, i)], like)
            fl = {k: max(fl[k], float((other[k].double()
                                       - base[k].double()).abs().max()))
                  for k in base}
        floors[kind] = fl
    return refs, floors, kinds


def read_shared(args, torch, params, aux, refs, floors):
    """The floors and references another world writes (``--floors-in``,
    ``--refs-in``), waiting up to SHARED_WAIT_S for each file: that world
    may still be running beside this one."""
    for path in (args.floors_in, args.refs_in):
        t0 = time.perf_counter()
        while path and not os.path.exists(path):
            if time.perf_counter() - t0 > SHARED_WAIT_S:
                raise SystemExit("no %s after %r s" % (path, SHARED_WAIT_S))
            time.sleep(0.1)
    if args.floors_in:
        with open(args.floors_in) as f:
            floors.update(json.load(f))
    if args.refs_in:
        saved = torch.load(args.refs_in)
        like = dict(params, **aux)
        for kind in sorted(k for k in saved if k != "keys"):
            refs[kind] = unflat(saved["keys"], saved[kind], like)


def load_inputs(args, torch, dtype, path_params, path_data, net, shape):
    if path_params:
        params, aux = load_state(path_params, dtype)
    else:
        ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
        p0, _, a0 = ts0.init({"data": shape}, {"softmax_label": shape[:1]},
                             seed=args.seed)
        params = {k: v.to(dtype) for k, v in p0.items()}
        aux = {k: v.to(dtype) for k, v in a0.items()}
    if path_data:
        raw = mt.nd.load(path_data, ctx=mt.cpu())
        batches = {k: raw[k].value.to(dtype) for k in ("data",
                                                        "softmax_label")}
    else:
        rng = np.random.default_rng(args.seed + 11)
        batches = {
            "data": torch.from_numpy(rng.uniform(
                -1, 1, (args.steps,) + shape)).to(dtype),
            "softmax_label": torch.from_numpy(rng.integers(
                0, args.classes, (args.steps, args.batch))).to(dtype)}
    return params, aux, batches


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
    ap.add_argument("--micro-ref", default="")
    ap.add_argument("--floor-nudge", type=float, default=None)
    ap.add_argument("--floor-samples", type=int, default=2)
    ap.add_argument("--floor-refs", default="",
                    help="the references with nudged runs (default: all)")
    ap.add_argument("--floors-in", default=None)
    ap.add_argument("--floors-out", default=None)
    ap.add_argument("--refs-in", default=None)
    ap.add_argument("--refs-out", default=None,
                    help="PATH:KIND,KIND the references another world reads")
    ap.add_argument("--floor-x", type=float, default=4.0)
    ap.add_argument("--floor-min", type=float, default=1e-7)
    ap.add_argument("--live", default="")
    ap.add_argument("--live-rows", type=int, default=1)
    ap.add_argument("--ckpt", action="store_true")
    ap.add_argument("--restore-check", default=None)
    ap.add_argument("--overflow", default=None)
    ap.add_argument("--row-overflow", default=None)
    ap.add_argument("--fit", type=int, default=0)
    ap.add_argument("--toy-fit", action="store_true")
    ap.add_argument("--mlp-cases", default="")
    ap.add_argument("--mlp-params", default=None)
    ap.add_argument("--mlp-data", default=None)
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
    params, aux, batches = load_inputs(args, torch, dtype, args.params,
                                       args.data, net, shape)
    marks["state"] = time.perf_counter()
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
    t0 = time.perf_counter()
    cases = parse_cases(args.cases)
    refs, floors, kinds = reference_jobs(args, torch, run, params, world,
                                         rank, cases)
    for kind in kinds:
        base = refs[kind]
        keep(kind + "/", {k: base[k] for k in params},
             {k: base[k] for k in aux})
    if kinds or floors:
        report["floors"] = {k: {"max": max(v.values()), "samples":
                                args.floor_samples}
                            for k, v in floors.items()}
        # one process's TrainStep over the global batch, on the rank that
        # ran its last job (beside the pipeline's step)
        report["single_step_ms"] = run.single_step_ms
        report["single_img_per_s"] = args.batch / run.single_step_ms \
            * 1e3 if run.single_step_ms else None
    if args.floors_out and rank == 0:
        with open(args.floors_out + ".tmp", "w") as f:
            json.dump(floors, f, sort_keys=True)
        os.replace(args.floors_out + ".tmp", args.floors_out)
    if args.refs_out and rank == 0:
        # another world's cases read these references (``--refs-in``)
        path, _, names = args.refs_out.partition(":")
        keys = flat(torch, params, aux)[0]
        saved = {"keys": keys}
        for kind in names.split(","):
            saved[kind] = flat(torch, {k: refs[kind][k] for k in params},
                               {k: refs[kind][k] for k in aux})[1]
        torch.save(saved, path + ".tmp")
        os.replace(path + ".tmp", path)
    t_refs = time.perf_counter() - t0
    marks["references_end"] = time.perf_counter()

    variants = [False] + ([True] if args.norm_conv else [])
    shared = args.floors_in or args.refs_in
    late = [] if shared else None
    first = run_cases(args, torch, run, cases, variants, report, refs,
                      floors, keep, late=late)
    t_cases = time.perf_counter() - t0 - t_refs
    marks["cases_end"] = time.perf_counter()
    if shared:
        read_shared(args, torch, params, aux, refs, floors)
        for row, got in late:
            compare(args, row, got, refs, floors)
        del late
        marks["shared_end"] = time.perf_counter()
    if args.mlp_cases:
        mp, ma, mbat = load_inputs(args, torch, torch.float32,
                                   args.mlp_params, args.mlp_data, mlp(mt),
                                   (args.batch, 32))
        mrun = Runner(torch, mlp(mt), mp, ma, mbat, ctx, card, args.steps)
        run_cases(args, torch, mrun, parse_cases(args.mlp_cases), [False],
                  report, {}, {}, keep, prefix="mlp-")
    marks["mlp_end"] = time.perf_counter()
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
                                zero=ts.zero, ctx=ctx)
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
                                zero=ts.zero, ctx=ctx)
        p3, s3, a3, _ = ckm.restore_into(ts3, path1)
        same_back = all(torch.equal(p3[n], p[n]) for n in p) and all(
            torch.equal(a3[n], a[n]) for n in a)
        report["ckpt"] = {"path": path, "topology": man["topology"],
                          "step": ts2.num_update, "pp_bitwise": same_pp,
                          "one_process_bitwise": same_one,
                          "one_to_pp_bitwise": same_back}
        del ts2, ts3, t1, p1, s1, a1, p2, s2, a2, p3, s3, a3
    first = None
    if args.restore_check:
        report["restore_check"] = restore_check(
            torch, run, parse_case(args.restore_check), args.out)
    if args.overflow:
        report["overflow"] = overflow_check(torch, run,
                                            parse_case(args.overflow))
        print(json.dumps({"rank": rank, "pp_overflow": report["overflow"]},
                         sort_keys=True), flush=True)
    if args.row_overflow:
        report["row_overflow"] = [overflow_check(torch, run, c, row=True)
                                  for c in parse_cases(args.row_overflow)]
        if world > 2:
            # the verdict is the world's: a policy on a mesh of part of it
            # (two of the world's ranks) refuses on every rank
            part = pmesh.make_pp_mesh(2, dp=1, devices=[0, 1])
            try:
                PipelineTrainStep(net, make_opt(args.batch), mesh=part,
                                  ctx=ctx, policy=mt.amp.Policy(
                                      "float32", loss_scale=LOSS_SCALE))
                report["part_mesh_policy_refused"] = False
            except mt.base.MXNetError as exc:
                report["part_mesh_policy_refused"] = \
                    "agreed over the whole world" in str(exc)
    if card:
        torch.cuda.empty_cache()
    marks["ckpt_end"] = time.perf_counter()
    if args.fit:
        rep, fp, wp = fit_check(torch, run, world, args.fit)
        report["fit"] = rep
        keep("fit/", fp, {})
        keep("fitref/", wp, {})
    if args.toy_fit:
        report["toy_fit"] = {label: toy_fit(torch, ctx, env)
                             for label, env in TOY_FITS}
    marks["fit_end"] = time.perf_counter()
    if args.semantics:
        report["semantics"] = semantics_checks(torch, ctx, world)
    if args.refusals:
        report["refusals"] = refusal_checks(torch, net, ctx, world,
                                            args.batch)
    report["norm_conv_launches"] = nc.launches
    report["norm_conv_stats_launches"] = nc.stats_launches
    report["norm_conv_bf16_launches"] = nc.bf16_launches
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
