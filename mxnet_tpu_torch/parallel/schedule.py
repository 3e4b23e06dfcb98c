"""Pipeline dispatch schedules (GPipe, 1F1B, interleaved virtual stages);
a copy of mxnet_tpu/parallel/schedule.py, which is pure stdlib.

The pipelined training step (``train.PipelineTrainStep``) runs each device
slice's work items on the rank that owns it (one rank a slice of the
``pp`` axis), IN DISPATCH ORDER, while the ranks overlap against each
other and exchange boundary activations and cotangents point to point.  The
*schedule* is therefore exactly two things: the per-device-slice order of
work items, and the lifetime of the stashed boundary activations that order
implies.  This module generates those orders and scores them:

- ``gpipe``:       all forwards (fill), then all backwards (drain).  The
  idle share is ``(pp-1)/(pp-1+M)`` and every in-flight microbatch's
  boundary activations stay stashed through the whole forward wave, so
  activation memory grows with M.
- ``1f1b``:        stage ``s`` runs ``min(M, pp-s-1)`` warm-up forwards,
  then the steady state interleaves one forward with one backward, then
  drains.  Same bubble as GPipe, but a microbatch's backward starts as
  soon as the pipeline allows, so at most ``min(M, pp-s)`` microbatches'
  boundary activations are ever stashed on stage ``s`` — bounded by pp,
  not M.
- ``interleaved``: the symbol is cut into ``pp x v`` *virtual* stages and
  device slice ``d`` owns the ``v`` non-contiguous chunks
  ``{d, d+pp, d+2pp, ...}`` (the Megatron-LM interleaved 1F1B schedule).
  Each fill/drain ramp costs one *chunk* (1/v of a stage), shrinking the
  bubble to ``(pp-1)/((pp-1) + v*M)``.  Requires ``M % pp == 0`` (the
  schedule walks microbatches in groups of pp).

``simulate`` scores a generated order under the equal-cost slot model (one
slot per chunk forward = per chunk backward — the model the closed-form
bubble fractions assume) and the executed schedule is asserted against the
closed form at plan-build time in train.py.  Pure stdlib.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["SCHEDULES", "stage_orders", "simulate", "dispatch_order",
           "validate_schedule"]

SCHEDULES = ("gpipe", "1f1b", "interleaved")


def validate_schedule(schedule, pp, microbatches, interleave):
    """Validate a (schedule, pp, M, v) combination, normalising the
    schedule name.  Raises MXNetError with the operator-facing message
    (these arrive from MXNET_PP_SCHEDULE / MXNET_PP_INTERLEAVE)."""
    schedule = str(schedule).lower()
    if schedule not in SCHEDULES:
        raise MXNetError(
            "unknown pipeline schedule %r: MXNET_PP_SCHEDULE takes %s"
            % (schedule, "/".join(SCHEDULES)))
    v = int(interleave)
    if v < 1:
        raise MXNetError("pipeline interleave must be >= 1, got %d" % v)
    if schedule != "interleaved" and v != 1:
        raise MXNetError(
            "MXNET_PP_INTERLEAVE=%d needs MXNET_PP_SCHEDULE=interleaved "
            "(%s runs one chunk per device slice)" % (v, schedule))
    if schedule == "interleaved":
        if v < 2:
            raise MXNetError(
                "interleaved schedule needs an interleave factor >= 2 "
                "(MXNET_PP_INTERLEAVE; v=1 is plain 1f1b)")
        if microbatches % pp:
            raise MXNetError(
                "interleaved schedule walks microbatches in groups of pp: "
                "num_microbatches=%d is not divisible by pp=%d"
                % (microbatches, pp))
    return schedule, v


def _orders_gpipe(pp, M):
    return [[("fwd", m, d) for m in range(M)]
            + [("bwd", m, d) for m in reversed(range(M))]
            for d in range(pp)]


def _orders_1f1b(pp, M):
    orders = []
    for d in range(pp):
        warm = min(M, pp - d - 1)
        order = [("fwd", m, d) for m in range(warm)]
        for i in range(M - warm):
            order.append(("fwd", warm + i, d))
            order.append(("bwd", i, d))
        order += [("bwd", m, d) for m in range(M - warm, M)]
        orders.append(order)
    return orders


def _orders_interleaved(pp, M, v):
    """Megatron-style interleaved 1F1B over pp*v virtual stages: unit i of
    device d walks microbatch groups of size pp, chunks ascending on the
    forward side and descending on the backward side."""
    group = pp * v

    def f_unit(d, i):
        g, r = divmod(i, group)
        chunk, mb = divmod(r, pp)
        return ("fwd", g * pp + mb, chunk * pp + d)

    def b_unit(d, j):
        g, r = divmod(j, group)
        chunk, mb = r // pp, r % pp
        return ("bwd", g * pp + mb, (v - 1 - chunk) * pp + d)

    total = v * M
    orders = []
    for d in range(pp):
        warm = min(total, (pp - d - 1) * 2 + (v - 1) * pp)
        order = [f_unit(d, i) for i in range(warm)]
        for i in range(total - warm):
            order.append(f_unit(d, warm + i))
            order.append(b_unit(d, i))
        order += [b_unit(d, j) for j in range(total - warm, total)]
        orders.append(order)
    return orders


def stage_orders(pp, microbatches, schedule="gpipe", interleave=1):
    """Per-device-slice work-item orders: ``orders[d]`` is the dispatch
    order of ``("fwd"|"bwd", microbatch, virtual_stage)`` items for slice
    ``d``.  Virtual stage ``k`` lives on slice ``k % pp``; with
    ``interleave == 1`` virtual stages are the physical stages."""
    schedule, v = validate_schedule(schedule, pp, microbatches, interleave)
    if schedule == "gpipe":
        return _orders_gpipe(pp, microbatches)
    if schedule == "1f1b":
        return _orders_1f1b(pp, microbatches)
    return _orders_interleaved(pp, microbatches, v)


def simulate(orders, pp, interleave=1):
    """Score an order table under the equal-cost slot model: every item
    takes one slot, an item starts at max(its slice is free, its carry
    dependencies finished).  Returns ``{"start": {item: slot}, "span":
    slots, "bubble": idle-slot share}`` — the executed schedule's bubble,
    the number `pipeline_bubble_fraction` predicts."""
    V = pp * interleave
    finish = {}
    start = {}
    free = [0] * pp
    pos = [0] * pp
    remaining = sum(len(o) for o in orders)
    while remaining:
        progressed = False
        for d in range(pp):
            while pos[d] < len(orders[d]):
                kind, m, k = item = orders[d][pos[d]]
                deps = []
                if kind == "fwd":
                    if k > 0:
                        deps.append(("fwd", m, k - 1))
                else:
                    deps.append(("fwd", m, k))
                    if k < V - 1:
                        deps.append(("bwd", m, k + 1))
                if not all(dep in finish for dep in deps):
                    break
                t = max([free[d]] + [finish[dep] for dep in deps])
                start[item] = t
                finish[item] = t + 1
                free[d] = t + 1
                pos[d] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            stuck = [orders[d][pos[d]] for d in range(pp)
                     if pos[d] < len(orders[d])]
            raise MXNetError(
                "pipeline schedule deadlock: no dispatchable item among %r"
                % stuck[:4])
    span = max(finish.values())
    busy = len(finish)
    return {"start": start, "span": span,
            "bubble": 1.0 - busy / float(span * pp)}


def dispatch_order(orders, pp, interleave=1):
    """One merged, dependency-valid global dispatch order: items sorted by
    their simulated start slot (ties by device slice) — the host dispatch
    sequence that realises the schedule's overlap.  Returns
    ``(items, simulated)``."""
    sim = simulate(orders, pp, interleave)
    items = [it for o in orders for it in o]
    items.sort(key=lambda it: (sim["start"][it], it[2] % pp))
    return items, sim
