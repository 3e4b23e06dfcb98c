"""The multi-process runtime (counterpart: mxnet_tpu/parallel/dist.py) on
``torch.distributed``.

Environment contract, the JAX package's:
- ``MXTPU_COORDINATOR``   address of process 0 (host:port)
- ``MXTPU_NUM_PROCESSES`` world size
- ``MXTPU_PROCESS_ID``    this process's rank
A process with none of them set is rank 0 of 1 and starts nothing.
``python -m mxnet_tpu_torch.launch -n N cmd...`` starts N processes with
the contract set.

Rank 0 hosts a ``torch.distributed.TCPStore`` at the coordinator's address.
It carries the process group's rendezvous and the service calls of this
module (``kv_set`` / ``kv_get`` / ``coordination_barrier`` /
``membership_barrier``), which take no collective and are safe from any
thread: a thread other than the main one talks to the store through a
client connection of its own.  Every connection and the group itself are
made with a timeout (``init_process_group(timeout=)``, ``TIMEOUT_S`` by
default), so a peer that never comes is an error, not a hang.

The collective route is chosen once, by rule, when the group comes up, and
logged (``route()``):
- ``gloo``: host tensors, and every tensor of a world without a card;
- ``nccl``: CUDA tensors when each rank of every host has a card of its own
  (the ranks' host names are exchanged through the store); the group is
  ``cpu:gloo,cuda:nccl`` and rank r of a host uses card r of it;
- ``gloo-cuda``: CUDA tensors when ranks share a card.  NCCL refuses two
  ranks on one device, so the tensors go through gloo, which stages them
  through pinned host buffers itself.

``allreduce_arrays`` / ``allreduce`` / ``allreduce_tree`` sum across the
ranks with all the arrays of one call in one collective a dtype: the
tensors of one dtype and device are flattened into one bucket, summed by
one ``all_reduce``, and split back (``bucket_allreduce``), the shape of the
JAX package's one fused reduction a push.  At world 1 they return their
inputs.  While telemetry records, each call is the span
``dist.allreduce`` (cat ``comm``, waiting for the result) with the
``dist_allreduce`` and ``dist_allreduce_bytes`` counters.

The ZeRO step's collectives (``all_reduce_``, ``reduce_scatter_rows``,
``all_gather_rows``, ``all_gather_batch``, ``all_finite``, ``sum_across``)
run over a mesh axis's group.

The tensor-parallel step inserts by hand the collectives XLA inserted for a
``tp`` sharding, as four autograd functions over the ``tp`` group:
``gather_along`` (all-gather along a dimension; the backward takes this
rank's slice), its mirror ``scatter_along`` (this rank's slice; the
backward all-gathers), ``copy_to_group`` (the identity; the backward
all-reduces) and its mirror ``reduce_from_group`` (all-reduce; the backward
is the identity).  The slice's gradient is exact because every rank of the
group computes the same loss from the gathered values.  Ring attention's
K/V blocks go one hop around its ``sp`` group by ``ring_exchange``.

The pipeline's point-to-point transfers (``send_`` / ``recv_``, over
``isend`` / ``irecv``) return a handle whose ``wait()`` finishes the
transfer; they count as the kinds ``send`` and ``recv`` (``send_outputs``
/ ``recv_outputs`` for the step's outputs handed to the other stages), the
seconds being the host's time to post the transfer and to wait for it.
gloo sends and receives host memory only (its buffers are raw host
pointers: on the H100 box, torch 2.11, a CUDA tensor's ``isend`` kills
the sender with "writev ... Bad address"), so on the ``gloo-cuda`` route
a CUDA tensor crosses through a pinned host buffer: copied there before the send and from there after the
receive (``p2p_route()`` names the rule, ``p2p_staged_copies`` counts the
copies); NCCL and host tensors go direct.

Every collective counts by kind into three module dicts:
``collective_calls`` (calls), ``collective_bytes`` (the bytes of its
buffer) and ``collective_seconds`` (host seconds; on the ``gloo-cuda``
route the host waits for the buffer's producer first);
``reset_collectives`` zeroes them.  The kinds: ``all_reduce`` (a
kvstore's buckets, gradients at ZeRO 0-1), ``reduce_scatter`` (the bucket
at 2-3), ``all_gather`` (updated rows, level-3 parameters, eval outputs),
``verdict`` (the AMP overflow flag), ``stats`` (BatchNorm's per-channel
sums, ``sum_across``, whose backward sums the cotangents across the ranks
too), ``broadcast`` (a pipeline's stages gathered on every rank), the P2P
kinds above, ``tp_all_gather`` / ``tp_all_reduce`` (the tensor-parallel
functions), ``ring_send`` / ``ring_recv`` (ring attention's hops) and
``sp_all_gather`` (its output blocks, and its gradients in the
backward).  gloo takes every collective on CUDA tensors when ranks
share a card (checked on the H100 with torch 2.11), but not send and
receive.  ``ensure_group`` gives a world of
1 a one-rank gloo group, so a mesh works in one process.

Not ported here: the reference's hooks into the sanitizer and diagnostics,
and its clock offset, straggler and wire-byte exchanges (``clock_offset``,
``straggler``, ``wire_bytes``); they arrive with the numerics and
sanitizer slices.  ``shutdown_process_group`` tears the group down
(``destroy_process_group``); the live re-initialisation of a resized world
arrives with the live-resize part of the distributed slice.
"""
from __future__ import annotations

import datetime
import logging
import socket
import threading
import time

import torch
import torch.distributed as tdist

from ..base import MXNetError, get_env

__all__ = ["init_process_group", "shutdown_process_group", "rank",
           "num_workers", "local_rank", "route", "barrier", "peer_world",
           "membership_barrier", "kv_set", "kv_get", "coordination_barrier",
           "allreduce_arrays", "allreduce", "allreduce_tree",
           "bucket_allreduce", "ensure_group", "reset_collectives",
           "all_reduce_", "reduce_scatter_rows", "all_gather_rows",
           "all_gather_batch", "all_finite", "sum_across", "send_",
           "recv_", "p2p_route", "broadcast_", "gather_along",
           "scatter_along", "copy_to_group", "reduce_from_group",
           "ring_exchange", "gather_cat", "slice_of"]

_LOG = logging.getLogger(__name__)

# seconds any rendezvous, service call or collective may wait for a peer
TIMEOUT_S = 300.0

# every collective by kind: {kind: calls}, {kind: bytes}, {kind: seconds}
collective_calls = {}
collective_bytes = {}
collective_seconds = {}
# pinned host copies of the P2P transfers of CUDA tensors over gloo
p2p_staged_copies = [0]

_lock = threading.Lock()
_state = {"initialized": False, "world": 1, "rank": 0, "local_rank": 0,
          "route": "gloo", "store": None, "address": None,
          "timeout": TIMEOUT_S}
_thread_stores = threading.local()


def _parse(coord):
    host, _, port = str(coord).rpartition(":")
    if not host or not port.isdigit():
        raise MXNetError("MXTPU_COORDINATOR must be host:port, got %r"
                         % (coord,))
    return host, int(port)


def _pick_route(local_world, cards):
    """The CUDA tensors' route: NCCL when every rank of a host has a card
    of its own, else gloo over CUDA tensors; gloo without a card."""
    if cards == 0:
        return "gloo"
    return "nccl" if local_world <= cards else "gloo-cuda"


def _connect(coord, nproc, pid, timeout=TIMEOUT_S):
    """Bring up the store and the process group of the (coord, nproc, pid)
    world, any size, 1 included (``init_process_group`` calls it for a
    world of 2 or more)."""
    import torch
    import torch.distributed as tdist
    host, port = _parse(coord)
    td = datetime.timedelta(seconds=float(timeout))
    try:
        store = tdist.TCPStore(host, port, nproc, pid == 0, timeout=td,
                               wait_for_workers=True)
    except Exception as exc:
        raise MXNetError(
            "init_process_group: rank %d of %d cannot meet its peers at "
            "%s within %r s: %s" % (pid, nproc, coord, float(timeout), exc))
    me = socket.gethostname()
    store.set("mxtpu/host/%d" % pid, me)
    hosts = [store.get("mxtpu/host/%d" % r).decode() for r in range(nproc)]
    local = [r for r in range(nproc) if hosts[r] == me]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rt = _pick_route(len(local), cards)
    backend = "cpu:gloo,cuda:nccl" if rt == "nccl" else "gloo"
    lr = local.index(pid)
    if rt == "nccl":
        torch.cuda.set_device(lr)
    tdist.init_process_group(backend=backend,
                             store=tdist.PrefixStore("mxtpu-pg", store),
                             world_size=nproc, rank=pid, timeout=td)
    _state.update(initialized=True, world=nproc, rank=pid, local_rank=lr,
                  route=rt, store=store, address=(host, port),
                  timeout=float(timeout))
    _LOG.info("dist: rank %d of %d (%d on this host, %d card(s)), "
              "backend %s, CUDA tensors by %s", pid, nproc, len(local),
              cards, backend, rt)


def init_process_group(timeout=TIMEOUT_S):
    """Bring up the world of the MXTPU_* contract (idempotent).  A process
    without the contract, or with a world of 1, is rank 0 of 1."""
    with _lock:
        if _state["initialized"]:
            return
        coord = get_env("MXTPU_COORDINATOR")
        nproc = get_env("MXTPU_NUM_PROCESSES", typ=int)
        pid = get_env("MXTPU_PROCESS_ID", 0, typ=int) or 0
        if coord and nproc and nproc > 1:
            _connect(coord, nproc, pid, timeout)
        else:
            _state["initialized"] = True
    from .. import telemetry as _tel
    if _tel._enabled:
        _tel.gauge("dist_world_size", _state["world"])
        _tel.gauge("dist_rank", _state["rank"])


def shutdown_process_group():
    """Destroy the process group and drop the store, so that
    ``init_process_group`` can bring up another world."""
    import torch.distributed as tdist
    with _lock:
        if tdist.is_available() and tdist.is_initialized():
            tdist.destroy_process_group()
        _state.update(initialized=False, world=1, rank=0, local_rank=0,
                      route="gloo", store=None, address=None)
        _thread_stores.__dict__.clear()


def rank():
    init_process_group()
    return _state["rank"]


def num_workers():
    init_process_group()
    return _state["world"]


def local_rank():
    """This rank's index among the ranks of its host (its card on the
    ``nccl`` route)."""
    init_process_group()
    return _state["local_rank"]


def route():
    """The CUDA tensors' route of this world: ``nccl``, ``gloo-cuda`` or
    ``gloo`` (see the module's docstring)."""
    init_process_group()
    return _state["route"]


def peer_world():
    """``(world, rank)`` of this process's peer group; standalone
    ``(1, 0)``."""
    init_process_group()
    return _state["world"], _state["rank"]


def _store():
    """The store connection of the calling thread (None in a world of
    1)."""
    base = _state["store"]
    if base is None:
        return None
    if threading.current_thread() is threading.main_thread():
        return base
    st = getattr(_thread_stores, "store", None)
    if st is None:
        import torch.distributed as tdist
        host, port = _state["address"]
        st = tdist.TCPStore(host, port, _state["world"], False,
                            timeout=datetime.timedelta(
                                seconds=_state["timeout"]),
                            wait_for_workers=False)
        _thread_stores.store = st
    return st


def kv_set(key, value):
    """Publish ``value`` (str) under ``key`` on the store."""
    init_process_group()
    st = _store()
    if st is None:
        raise MXNetError("kv_set: no store (a world of 1)")
    st.set(str(key), str(value))


def kv_get(key, timeout_ms=600000):
    """Blocking read of ``key`` from the store, bounded by
    ``timeout_ms``."""
    init_process_group()
    st = _store()
    if st is None:
        raise MXNetError("kv_get: no store (a world of 1)")
    try:
        st.wait([str(key)], datetime.timedelta(milliseconds=timeout_ms))
    except Exception as exc:
        raise MXNetError("kv_get(%r) timed out after %d ms: %s"
                         % (key, timeout_ms, exc))
    return st.get(str(key)).decode("utf-8")


def _store_barrier(name, timeout_ms):
    """Every rank meets at ``name`` on the store: the last to arrive
    publishes the release key.  Raises on timeout."""
    st = _store()
    key = "mxtpu/barrier/%s" % name
    if st.add(key, 1) == _state["world"]:
        st.set(key + "/done", "1")
    st.wait([key + "/done"], datetime.timedelta(milliseconds=timeout_ms))


def coordination_barrier(name, timeout_ms=600000):
    """Process barrier over the store (no collective): safe from any
    thread; the checkpoint writer's thread meets its peers here.  ``name``
    must be unique a use.  Standalone: returns at once."""
    init_process_group()
    if _state["store"] is None:
        return
    try:
        _store_barrier(name, timeout_ms)
    except MXNetError:
        raise
    except Exception as exc:
        raise MXNetError("coordination_barrier %r: the peers did not all "
                         "arrive within %d ms: %s" % (name, timeout_ms, exc))


def membership_barrier(name, timeout_ms=30000):
    """A bounded barrier expected to fail when a peer is gone: True when
    every rank arrived within ``timeout_ms``, False otherwise.
    Standalone: True."""
    init_process_group()
    if _state["store"] is None:
        return True
    try:
        _store_barrier(name, timeout_ms)
        return True
    except Exception:
        return False


_barrier_seq_lock = threading.Lock()
_barrier_seq = [0]


def barrier(name=None):
    """Global process barrier.  ``name=None`` takes a sequenced id, so
    repeated barriers (the kvstore's epoch barrier) never reuse one;
    every rank calls it the same number of times."""
    init_process_group()
    if _state["world"] <= 1:
        return
    if name is None:
        with _barrier_seq_lock:
            _barrier_seq[0] += 1
            name = "kvstore-%d" % _barrier_seq[0]
    coordination_barrier(name, timeout_ms=int(_state["timeout"] * 1000))


def bucket_allreduce(tensors):
    """Sum a list of tensors across the ranks: the tensors of one dtype and
    device flattened into one bucket, one ``all_reduce`` a bucket, the
    sums split back into new tensors of the inputs' shapes (the inputs are
    not changed).  Runs in any world the group spans, 1 included."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        # the group's backend takes the route: gloo stages a CUDA bucket
        # through host buffers itself, NCCL sums it on the cards
        all_reduce_(flat, None)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def allreduce_arrays(arrays):
    """Sum a list of tensors across the ranks in one collective a dtype;
    at world 1 the inputs come back."""
    init_process_group()
    if _state["world"] <= 1:
        return list(arrays)
    from .. import telemetry as _tel
    if not _tel._enabled:
        return bucket_allreduce(arrays)
    from .. import engine as _engine
    with _tel.span("dist.allreduce", cat="comm", narrays=len(arrays),
                   rank=_state["rank"]):
        outs = bucket_allreduce(arrays)
        _tel.counter("dist_allreduce")
        _tel.counter("dist_allreduce_bytes",
                     sum(_tel.nbytes_of(a) for a in arrays))
        _engine._wait(_engine._devices(outs, set()))
    return outs


def allreduce(value):
    """Sum one NDArray across the ranks."""
    init_process_group()
    if _state["world"] <= 1:
        return value
    from .. import ndarray as nd
    return nd.NDArray(allreduce_arrays([value.value])[0], ctx=value.context)


def allreduce_tree(values):
    """Sum a dict ``{key: NDArray}`` across the ranks in one collective a
    dtype (keys in sorted order, as in the JAX package)."""
    init_process_group()
    if _state["world"] <= 1:
        return dict(values)
    from .. import ndarray as nd
    keys = sorted(values)
    outs = allreduce_arrays([values[k].value for k in keys])
    return {k: nd.NDArray(o, ctx=values[k].context)
            for k, o in zip(keys, outs)}


# ------------------------------------------------------ mesh collectives
def ensure_group():
    """Bring up the world and make sure a torch process group exists: a
    world of 1 gets a one-rank gloo group over an in-process store."""
    init_process_group()
    if not tdist.is_initialized():
        tdist.init_process_group("gloo", store=tdist.HashStore(),
                                 rank=0, world_size=1)


def reset_collectives():
    """Zero the collectives' counters (the P2P staging copies too)."""
    collective_calls.clear()
    collective_bytes.clear()
    collective_seconds.clear()
    p2p_staged_copies[0] = 0


def _count(kind, t, t0):
    collective_calls[kind] = collective_calls.get(kind, 0) + 1
    collective_bytes[kind] = collective_bytes.get(kind, 0) \
        + t.numel() * t.element_size()
    collective_seconds[kind] = collective_seconds.get(kind, 0.0) \
        + time.perf_counter() - t0


def all_reduce_(t, group, kind="all_reduce"):
    """Sum ``t`` across ``group`` (None: the world) in place; returns
    it."""
    t0 = time.perf_counter()
    tdist.all_reduce(t, group=group)
    _count(kind, t, t0)
    return t


def reduce_scatter_rows(bucket, group):
    """Sum a (dp, C) bucket across ``group`` and keep this rank's row: a
    (C,) tensor (gloo takes flat buffers only)."""
    bucket = bucket.contiguous()
    out = torch.empty(bucket.shape[1:], dtype=bucket.dtype,
                      device=bucket.device)
    t0 = time.perf_counter()
    tdist.reduce_scatter_tensor(out, bucket.reshape(-1), group=group)
    _count("reduce_scatter", bucket, t0)
    return out


def all_gather_rows(row, group, dp, async_op=False, kind="all_gather"):
    """Every rank's (C,) row -> the (dp, C) stack, on every rank.  With
    ``async_op`` the gather runs while the caller goes on: the return is a
    handle whose ``wait()`` gives the stack (``row`` must stay unchanged
    until then)."""
    row = row.contiguous()
    out = torch.empty(dp * row.numel(), dtype=row.dtype, device=row.device)
    t0 = time.perf_counter()
    work = tdist.all_gather_into_tensor(out, row.reshape(-1), group=group,
                                        async_op=async_op)
    _count(kind, out, t0)
    out = out.reshape((dp,) + tuple(row.shape))
    return _P2P(work, kind, out, keep=row) if async_op else out


def all_gather_batch(x, group, dp):
    """Every rank's rows of a batch-major tensor, concatenated along axis
    0 in rank order."""
    return all_gather_rows(x, group, dp).reshape(
        (dp * x.shape[0],) + tuple(x.shape[1:]))


def all_finite(finite, group):
    """True on every rank when ``finite`` (a 0-d bool tensor) holds on
    every rank of ``group``: one sum of the ranks' non-finite flags."""
    bad = (~finite).to(torch.float32).reshape(1)
    all_reduce_(bad, group, "verdict")
    return bad[0] == 0


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.detach().clone(), group, "stats")

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group, "stats"), None


def sum_across(t, group):
    """``t`` summed across ``group``; its gradient is the cotangents summed
    across the group (each rank's loss reads the same sum)."""
    return _SumAcross.apply(t, group)


# ------------------------------------------- tensor and sequence axes
def gather_cat(t, dim, group, size, kind="all_gather"):
    """Every rank's ``t`` of ``group`` (``size`` ranks) concatenated along
    ``dim`` in the group's rank order, on every rank."""
    stack = all_gather_rows(t, group, size, kind=kind)
    return torch.cat(stack.unbind(0), dim=dim)


def slice_of(t, dim, index, size):
    """Slice ``index`` of ``size`` equal slices of ``t`` along ``dim``."""
    k = t.shape[dim] // size
    return t.narrow(dim, index * k, k).contiguous()


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, size, index, kind):
        ctx.args = (dim, index, size)
        return gather_cat(t.detach(), dim, group, size, kind)

    @staticmethod
    def backward(ctx, g):
        return (slice_of(g, *ctx.args),) + (None,) * 5


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, size, index, kind):
        ctx.args = (dim, group, size, kind)
        return slice_of(t.detach(), dim, index, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, size, kind = ctx.args
        return (gather_cat(g.contiguous(), dim, group, size, kind),) \
            + (None,) * 5


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.args = (group, kind)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), *ctx.args), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, kind):
        return all_reduce_(t.detach().contiguous().clone(), group, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_along(t, dim, group, size, index, kind="tp_all_gather"):
    """``t`` gathered from every rank of ``group`` along ``dim`` (this
    rank is slice ``index`` of ``size``); the backward keeps this rank's
    slice of the cotangent."""
    return _GatherAlong.apply(t, dim, group, size, index, kind)


def scatter_along(t, dim, group, size, index, kind="tp_all_gather"):
    """Slice ``index`` of ``size`` of ``t`` along ``dim``; the backward
    all-gathers the slices' cotangents over ``group``."""
    return _ScatterAlong.apply(t, dim, group, size, index, kind)


def copy_to_group(t, group, kind="tp_all_reduce"):
    """``t`` unchanged; the backward sums its cotangent over ``group``
    (each rank's share of a replicated input's gradient)."""
    return _CopyToGroup.apply(t, group, kind)


def reduce_from_group(t, group, kind="tp_all_reduce"):
    """``t`` summed over ``group``; the backward passes the (replicated)
    cotangent on unchanged."""
    return _ReduceFromGroup.apply(t, group, kind)


def ring_exchange(tensors, right, left, tag):
    """One hop of a ring: each of ``tensors`` goes to global rank
    ``right`` and as many of the same shapes and dtypes come from global
    rank ``left`` (tags ``tag``, ``tag + 1``, ...).  Every receive is
    posted before any send and neither blocks until both are posted, so
    two neighbours never wait on each other.  Returns the received
    tensors."""
    recvs = [recv_(torch.empty_like(t, memory_format=torch.contiguous_format),
                   left, tag + i, kind="ring_recv")
             for i, t in enumerate(tensors)]
    sends = [send_(t, right, tag + i, kind="ring_send")
             for i, t in enumerate(tensors)]
    out = [r.wait() for r in recvs]
    for h in sends:
        h.wait()
    return out


# ------------------------------------------------------ point to point
def p2p_route(t):
    """How ``send_`` / ``recv_`` move ``t``: ``direct`` (host tensors, and
    CUDA tensors on the ``nccl`` route) or ``host-staged`` (CUDA tensors
    over gloo, through a pinned host buffer)."""
    if t.device.type == "cuda" and route() != "nccl":
        return "host-staged"
    return "direct"


def _add_seconds(kind, dt):
    collective_seconds[kind] = collective_seconds.get(kind, 0.0) + dt


class _P2P(object):
    """A posted transfer or asynchronous collective: ``wait()`` blocks
    until it is done (a staged receive then copies into its tensor) and
    returns the tensor."""

    def __init__(self, work, kind, tensor, staged=None, keep=None,
                 recv=False):
        self._work, self._kind = work, kind
        self.tensor, self._staged = tensor, staged
        # a staged receive copies its host buffer into ``tensor``
        self._recv = recv
        # the source of an asynchronous collective, alive until wait()
        self._keep = keep
        self._done = False

    def is_completed(self):
        return self._done or self._work.is_completed()

    def wait(self):
        if not self._done:
            t0 = time.perf_counter()
            self._work.wait()
            if self._staged is not None and self._recv:
                self.tensor.copy_(self._staged, non_blocking=True)
                p2p_staged_copies[0] += 1
            _add_seconds(self._kind, time.perf_counter() - t0)
            self._done = True
            self._staged = self._keep = None
        return self.tensor


def _staging(t):
    """The pinned host buffer a staged transfer of ``t`` crosses."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def send_(t, dst, tag, kind="send"):
    """Post the send of ``t`` to global rank ``dst`` under ``tag``;
    returns its handle (``t`` must stay unchanged until ``wait()``)."""
    t0 = time.perf_counter()
    t = t.detach().contiguous()
    staged = None
    if p2p_route(t) == "host-staged":
        staged = _staging(t)
        staged.copy_(t)
        p2p_staged_copies[0] += 1
    work = tdist.isend(staged if staged is not None else t, int(dst),
                       tag=int(tag))
    _count(kind, t, t0)
    return _P2P(work, kind, t, staged)


def recv_(t, src, tag, kind="recv"):
    """Post the receive into ``t`` (contiguous) from global rank ``src``
    under ``tag``; ``wait()`` on the handle gives ``t`` filled."""
    t0 = time.perf_counter()
    staged = None
    if p2p_route(t) == "host-staged":
        staged = _staging(t)
    work = tdist.irecv(staged if staged is not None else t, int(src),
                       tag=int(tag))
    _count(kind, t, t0)
    return _P2P(work, kind, t, staged, recv=True)


def broadcast_(t, src, group=None, kind="broadcast"):
    """``t`` from global rank ``src`` to every rank of ``group`` (None:
    the world), in place.  Returns ``t``."""
    t0 = time.perf_counter()
    tdist.broadcast(t, int(src), group=group)
    _count(kind, t, t0)
    return t
