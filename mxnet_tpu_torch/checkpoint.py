"""Sharded, asynchronous, any-topology checkpoints (counterpart:
mxnet_tpu/checkpoint.py), in the JAX package's format byte for byte.

A checkpoint is a directory ``<prefix>-stepNNNNNNNN.ckpt`` of shard files
in the ``.params`` byte format (``ndarray.serialize_arrays``) and a
``manifest.json``:

- ``stage<k>.params``: the parameters (``arg:``) and aux states (``aux:``)
  of pipeline stage ``k`` (one program: everything in stage 0);
- ``stage<k>-opt.params``: stage ``k``'s optimizer state (``opt:<name>:<i>``,
  the i-th tensor of the JAX ``_FunctionalOptimizer.init_state`` tuple);
- a ``TrainStep``'s ``tp``-split parameters and their optimizer states
  whole (all-gathered over ``tp`` by ``snapshot``), as the JAX package's
  ``device_get`` of the global arrays writes them; restoring cuts them back
  to the restoring step's slice, whatever mesh saved them;
- ``stage<k>-zero<j>.params``: row ``j`` of stage ``k``'s ZeRO ``(dp,
  chunk)`` shards (optimizer state at level >= 1, ``argz:`` parameters at
  level 3), written by the rank that holds row ``j`` (a ``TrainStep`` over
  a ``dp`` mesh keeps only its own row), byte for byte the JAX package's
  shard of the same topology;
- ``manifest.json``: format and version, step, epoch, batch, topology,
  the stage map, logical shapes and dtypes, the optimizer state's tuple
  lengths, ``extra`` (the loss-scale state), and a crc32 and size a shard;
  ``json.dumps(sort_keys=True, indent=1)``, written last.

In a world of several processes the ZeRO rows are owned by the ranks that
hold them, a ``PipelineTrainStep``'s ``stage<k>`` and ``stage<k>-opt``
groups by the rank of dp row 0 that runs stage ``k``
(``checkpoint_topology()["stage_owner"]``; the manifest's shapes and
dtypes come from its ``meta``, since no rank holds every stage), and the
other groups round-robin over the ranks (group i, in sorted order, by
rank ``i % world``): each rank writes its own, rank 0
serialises every group it holds for the checksum table, the other ranks
publish their rows' checksums on the store, and rank 0 writes the manifest
after the writers meet at ``dist.coordination_barrier`` (from the writer's
thread).  Every file goes through ``base.atomic_write``
(write to a temporary, fsync, rename), so a checkpoint is complete or
invisible to ``latest_sharded``.

``Checkpointer.save`` takes the host snapshot (``snapshot``: the tensors of
one dtype and card flattened into one buffer on the card and copied to the
host in one transfer, host tensors cloned, since the step updates its
tensors in place) and hands it to a daemon writer thread started at the
first asynchronous save, through a queue of depth 2.  ``wait`` is the
durability barrier; a writer failure is raised by the next ``save``,
``wait`` or ``close``, and never touches a finished checkpoint.

The reading side (``load_manifest``, ``load_sharded``, ``reassemble``,
``latest_sharded``, ``verify_checkpoint``, ``export_monolithic``) runs on
the host only and takes every topology the JAX package writes (pipeline
stages merged, ZeRO rows concatenated, unpadded and reshaped), giving
logical CPU tensors; ``restore_loaded`` / ``restore_into`` place them on a
``TrainStep`` (``place_checkpoint``) with its update count and loss scale.

Telemetry, while it records: the ``ckpt.save`` / ``ckpt.wait`` /
``ckpt.write`` spans, the ``ckpt_bytes`` and ``ckpt_pending`` gauges and
the ``ckpt_saves`` counter, as in the JAX package.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import re
import threading
import time
import zlib

import torch

from .base import MXNetError, atomic_write, get_env
from . import telemetry as _tel

_LOG = logging.getLogger(__name__)

__all__ = ["Checkpointer", "snapshot", "write_snapshot", "load_manifest",
           "load_sharded", "reassemble", "restore_loaded", "restore_into",
           "latest_sharded", "export_monolithic", "verify_checkpoint",
           "FORMAT", "VERSION"]

FORMAT = "mxtpu-sharded-checkpoint"
VERSION = 1
SUFFIX = ".ckpt"
MANIFEST = "manifest.json"

_STEP_RE = re.compile(r"-step(\d{8,})" + re.escape(SUFFIX) + r"$")


def checkpoint_dir(prefix, step):
    """The directory of the sharded checkpoint of ``step``."""
    return "%s-step%08d%s" % (prefix, int(step), SUFFIX)


def _world():
    return max(1, int(get_env("MXTPU_NUM_PROCESSES", "1") or 1))


def _rank():
    return int(get_env("MXTPU_PROCESS_ID", "0") or 0)


# the process-wide save counter: a multi-process writer barrier's id is
# unique a save, across Checkpointers (saves are collective, so every rank
# counts alike)
_seq_lock = threading.Lock()
_save_seq = [0]


def _next_seq():
    with _seq_lock:
        _save_seq[0] += 1
        return _save_seq[0]


def _dtype_name(t):
    """The numpy name of a tensor's dtype, as the JAX manifest writes it."""
    return str(t.dtype).replace("torch.", "")


def _host_fetch(trees):
    """Host copies of the tensors of ``trees`` (a list of dicts of tensors
    or of tuples of tensors): the CUDA tensors of one dtype and card are
    flattened into one buffer there and copied to the host in one
    transfer; host tensors are cloned."""
    leaves = []
    for tree in trees:
        for v in tree.values():
            leaves.extend(v if isinstance(v, (tuple, list)) else [v])
    host = {}
    groups = {}
    for t in leaves:
        if t.device.type == "cpu":
            host[id(t)] = t.detach().clone()
        else:
            groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts]).cpu()
        off = 0
        for t in ts:
            n = t.numel()
            host[id(t)] = flat[off:off + n].view(t.shape)
            off += n
    out = []
    for tree in trees:
        out.append({k: tuple(host[id(x)] for x in v)
                    if isinstance(v, (tuple, list)) else host[id(v)]
                    for k, v in tree.items()})
    return out


# ----------------------------------------------------------------- snapshot
def snapshot(ts, params, opt_state, aux, *, step=None, epoch=0, nbatch=0,
             extra=None):
    """The host snapshot of a training state (a job for the writer): the
    groups of host tensors by ownership and the manifest's fields.  It
    holds no device tensor, so the step may go on updating its tensors in
    place while a writer thread serialises the job."""
    topo = ts.checkpoint_topology()
    if step is None:
        step = ts.num_update
    has_opt = opt_state is not None
    if int(topo.get("tp", 1)) > 1:
        # tp-split parameters and their optimizer states are written whole,
        # as the JAX package's device_get of the global arrays gives them
        # (a collective over the tp group: every rank snapshots)
        params = ts.gather_params(params)
        if has_opt:
            opt_state = ts.gather_state(opt_state)
    # the JAX package's device_get returns the dicts with sorted keys, the
    # order its shards list their entries in
    params = {n: params[n] for n in sorted(params)}
    aux = {n: aux[n] for n in sorted(aux)}
    opt_state = {n: tuple(opt_state[n]) for n in sorted(opt_state)} \
        if has_opt else {}
    host_params, host_state, host_aux = _host_fetch(
        [params, opt_state, aux])
    stage_of = topo["stage_of"]
    # the ZeRO level: optimizer state at >= 1, and the parameters at 3, are
    # this rank's row ``row`` of their flat (dp, chunk) views
    zlevel = int(topo["zero"])
    row = int(topo.get("row", 0))
    pshapes = topo.get("param_shapes") or {}
    ranks = int(topo["dp"]) * int(topo["pp"])
    if zlevel and ranks != _world() and _world() > 1:
        raise MXNetError(
            "snapshot: a ZeRO level %d step over a mesh of %d ranks in a "
            "world of %d ranks: every rank must hold one row of the mesh"
            % (zlevel, ranks, _world()))
    groups = {}
    zero_groups = []

    def grp(name):
        return groups.setdefault(name, {})

    for n, v in host_params.items():
        if zlevel >= 3:
            grp("stage%d-zero%d" % (stage_of[n], row))["argz:%s" % n] = v
        else:
            grp("stage%d" % stage_of[n])["arg:%s" % n] = v
    for n, v in host_aux.items():
        grp("stage%d" % stage_of[n])["aux:%s" % n] = v
    for n, st in host_state.items():
        for i, leaf in enumerate(st):
            g = "stage%d-zero%d" % (stage_of[n], row) if zlevel \
                else "stage%d-opt" % stage_of[n]
            grp(g)["opt:%s:%d" % (n, i)] = leaf
    if zlevel:
        # every row's group, this rank's and its peers'
        stages = sorted({stage_of[n] for n in host_state} | (
            {stage_of[n] for n in host_params} if zlevel >= 3 else set()))
        zero_groups = ["stage%d-zero%d" % (k, j) for k in stages
                       for j in range(int(topo["dp"]))]
    owners = {}
    pmeta = {n: {"shape": [int(d) for d in (
        pshapes[n] if zlevel >= 3 else v.shape)], "dtype": _dtype_name(v)}
        for n, v in host_params.items()}
    ameta = {n: {"shape": [int(d) for d in v.shape],
                 "dtype": _dtype_name(v)} for n, v in host_aux.items()}
    opt_len = {n: len(st) for n, st in host_state.items()}
    if "stage_owner" in topo:
        # a pipeline: this rank holds its stages' groups only; each stage's
        # owner writes them, the rank of dp row j of a stage's slice its
        # ZeRO rows, and the manifest lists every stage's variables
        meta = topo["meta"]
        names = [n for n in stage_of if n in meta]
        aux_names = set(topo.get("aux_names") or ())
        pmeta = {n: {"shape": list(meta[n][0]), "dtype": meta[n][1]}
                 for n in names if n not in aux_names}
        ameta = {n: {"shape": list(meta[n][0]), "dtype": meta[n][1]}
                 for n in names if n in aux_names}
        opt_len = {n: int(topo["opt_len"][n]) for n in pmeta}
        zstages = set()
        for n in names:
            k = stage_of[n]
            if n in ameta or zlevel < 3:
                owners["stage%d" % k] = int(topo["stage_owner"][k])
            rows = n in pmeta and (zlevel >= 3 or (has_opt and opt_len[n]))
            if rows and zlevel:
                zstages.add(k)
            elif has_opt and n in pmeta and opt_len[n]:
                owners["stage%d-opt" % k] = int(topo["stage_owner"][k])
        zero_groups = []
        for k in sorted(zstages):
            for j, r in enumerate(topo["zero_owner"][k]):
                zero_groups.append("stage%d-zero%d" % (k, j))
                owners["stage%d-zero%d" % (k, j)] = int(r)
        if not topo.get("writes", True):
            # a rank of dp row > 0 writes its ZeRO rows only
            groups = {g: v for g, v in groups.items() if _ZERO_RE.match(g)}
    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "step": int(step),
        "epoch": int(epoch),
        "nbatch": int(nbatch),
        "topology": {"pp": int(topo["pp"]), "dp": int(topo["dp"]),
                     "zero": zlevel,
                     "microbatches": topo["microbatches"],
                     "world": _world()},
        "stage_of": {n: int(s) for n, s in stage_of.items()},
        "params": pmeta,
        "aux": ameta,
        "opt_state": opt_len if has_opt else None,
        "extra": dict(extra or {}),
    }
    scale = ts.scale_state_host()
    if scale is not None:
        manifest["extra"]["loss_scale"] = scale
    return {"manifest": manifest, "groups": groups,
            "zero_groups": zero_groups, "owners": owners,
            "world": _world(), "rank": _rank()}


# ------------------------------------------------------------------- writer
def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_snapshot(dirname, job):
    """Write a snapshot job as a checkpoint directory (the synchronous core
    of both save modes): the owned shards, each through ``atomic_write``,
    then, after the ranks meet, rank 0's manifest with the whole checksum
    table.  Returns the payload bytes this rank serialised."""
    from . import ndarray as nd
    wall0 = time.time()
    t0 = time.perf_counter()
    os.makedirs(dirname, exist_ok=True)
    world, rank = job["world"], job["rank"]
    stale = os.path.join(dirname, MANIFEST)
    if os.path.exists(stale):
        # a rewrite of an existing directory (a resumed run can reuse a
        # step number): the old manifest goes before any shard is renamed,
        # so a kill mid-rewrite leaves an invisible directory
        try:
            os.remove(stale)
        except OSError:
            pass
        _fsync_dir(dirname)
    manifest = dict(job["manifest"])
    shards = {}
    total = 0
    zero = set(job.get("zero_groups", ()))
    # groups of a fixed owner: a ZeRO row's (row j on rank j, or the rank
    # the pipeline names) and a pipeline stage's; their owners publish the
    # checksums
    fixed = dict(job.get("owners") or {})
    for g in zero:
        fixed.setdefault(g, int(_ZERO_RE.match(g).group(2)))
    save_id = "ckpt-%d-%d" % (manifest["step"], job.get("_seq", 0))
    peers = []
    for i, g in enumerate(sorted(set(job["groups"]) | set(fixed))):
        owner = fixed[g] if g in fixed else i % world
        fname = "%s.params" % g
        if g not in job["groups"] or (g in fixed and owner != rank
                                      and rank == 0):
            peers.append(fname)
            continue
        if owner != rank and rank != 0:
            continue
        if g in fixed and owner != rank:
            continue
        blob = nd.serialize_arrays(job["groups"][g])
        meta = {"group": g, "rank": owner,
                "crc32": zlib.crc32(blob) & 0xFFFFFFFF, "bytes": len(blob)}
        shards[fname] = meta
        total += len(blob)
        if owner == rank:
            with atomic_write(os.path.join(dirname, fname)) as f:
                f.write(blob)
            if g in fixed and rank != 0:
                # rank 0 lists this row's checksum in the manifest
                from .parallel import dist
                dist.kv_set("mxtpu/%s/%s" % (save_id, fname),
                            json.dumps(meta))
    if world > 1:
        # every rank's shards are durable before the manifest makes the
        # checkpoint visible; the writers meet on the store (no collective:
        # the main thread may be in one), bounded, with an id unique a save
        from .parallel import dist
        dist.coordination_barrier(save_id, timeout_ms=300000)
        if rank == 0:
            for fname in peers:
                shards[fname] = json.loads(dist.kv_get(
                    "mxtpu/%s/%s" % (save_id, fname), timeout_ms=300000))
    manifest["shards"] = shards
    if rank == 0:
        with atomic_write(os.path.join(dirname, MANIFEST)) as f:
            f.write(json.dumps(manifest, sort_keys=True,
                               indent=1).encode("utf-8"))
    _fsync_dir(dirname)
    _fsync_dir(os.path.dirname(os.path.abspath(dirname)))
    if _tel._enabled:
        _tel.record_span("ckpt.write", wall0, time.perf_counter() - t0,
                         cat="checkpoint", step=manifest["step"])
        _tel.gauge("ckpt_bytes", total)
        _tel.counter("ckpt_saves")
    return total


class Checkpointer(object):
    """The sharded checkpoint writer, asynchronous unless ``async_`` is
    False (default: ``MXNET_CKPT_ASYNC``, on unless "0").  The writer
    thread starts at the first asynchronous save; the queue holds
    ``queue_depth`` snapshots, so a slow disk applies backpressure.
    ``last_save_seconds`` / ``last_write_seconds`` are the host seconds of
    the last snapshot and the last finished write."""

    def __init__(self, prefix, async_=None, queue_depth=2):
        if async_ is None:
            async_ = get_env("MXNET_CKPT_ASYNC", "1") != "0"
        self._prefix = prefix
        self._async = bool(async_)
        self._depth = int(queue_depth)
        self._lock = threading.Lock()
        self._queue = None
        self._thread = None
        self._error = None
        self._stop = object()
        self.last_save_seconds = None
        self.last_write_seconds = None

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise MXNetError(
                "checkpoint writer failed (the previous complete "
                "checkpoint is intact; this one was discarded): %s: %s"
                % (type(err).__name__, err)) from err

    def _ensure_thread(self):
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            import queue as _queue
            self._queue = _queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=self._drain, name="mxtpu-ckpt-writer", daemon=True)
            self._thread.start()

    def _write(self, job):
        t0 = time.perf_counter()
        write_snapshot(job["_dir"], job)
        self.last_write_seconds = time.perf_counter() - t0

    def _drain(self):
        q = self._queue
        while True:
            job = q.get()
            try:
                if job is self._stop:
                    return
                self._write(job)
            except BaseException as exc:   # raised in the training loop
                with self._lock:
                    self._error = exc
            finally:
                q.task_done()
                if _tel._enabled:
                    _tel.gauge("ckpt_pending", q.qsize())

    def save(self, ts, params, opt_state, aux, *, step=None, epoch=0,
             nbatch=0, extra=None):
        """Checkpoint one training state: the host snapshot here (the
        ``ckpt.save`` span), the shard files on the writer thread (or here
        when synchronous).  Returns the directory, complete after
        ``wait``."""
        self._raise_pending()
        wall0 = time.time()
        t0 = time.perf_counter()
        job = snapshot(ts, params, opt_state, aux, step=step, epoch=epoch,
                       nbatch=nbatch, extra=extra)
        path = checkpoint_dir(self._prefix, job["manifest"]["step"])
        job["_dir"] = path
        job["_seq"] = _next_seq()
        self.last_save_seconds = time.perf_counter() - t0
        if _tel._enabled:
            _tel.record_span("ckpt.save", wall0, self.last_save_seconds,
                             cat="checkpoint", step=job["manifest"]["step"],
                             mode="async" if self._async else "sync")
        if not self._async:
            self._write(job)
            return path
        self._ensure_thread()
        self._queue.put(job)
        if _tel._enabled:
            _tel.gauge("ckpt_pending", self._queue.qsize())
        return path

    def wait(self):
        """Block until every queued checkpoint is on disk (the ``ckpt.wait``
        span), then raise a writer failure if there was one."""
        q = self._queue
        if q is not None:
            if _tel._enabled:
                wall0 = time.time()
                t0 = time.perf_counter()
                q.join()
                _tel.record_span("ckpt.wait", wall0,
                                 time.perf_counter() - t0, cat="checkpoint")
            else:
                q.join()
        self._raise_pending()

    def close(self):
        """Write what is queued and stop the writer thread."""
        with self._lock:
            thread, q = self._thread, self._queue
            self._thread = None
        if thread is not None and thread.is_alive():
            q.put(self._stop)
            thread.join()
        self._raise_pending()


# -------------------------------------------------------------------- load
def load_manifest(path):
    """A checkpoint directory's manifest, checked for format and
    version."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise MXNetError(
            "not a complete sharded checkpoint (no %s): %s; an interrupted "
            "save leaves shards without a manifest, invisible to "
            "latest_sharded()" % (MANIFEST, path))
    with open(mpath) as f:
        man = json.load(f)
    if man.get("format") != FORMAT:
        raise MXNetError("not an mxtpu sharded checkpoint: %s (format=%r)"
                         % (path, man.get("format")))
    if int(man.get("version", -1)) != VERSION:
        raise MXNetError(
            "checkpoint format version mismatch: %s was written as version "
            "%s, this runtime reads version %d"
            % (path, man.get("version"), VERSION))
    return man


def _iter_shards(path, man, verify=True, parse=True):
    """(meta, entries) a shard, its presence and checksum checked; one read
    a shard serves both."""
    from . import ndarray as nd
    for fname in sorted(man["shards"]):
        meta = man["shards"][fname]
        full = os.path.join(path, fname)
        if not os.path.isfile(full):
            raise MXNetError(
                "checkpoint %s is missing shard %s (group %s, written by "
                "rank %d): a partial copy or a lost rank's filesystem"
                % (path, fname, meta["group"], meta["rank"]))
        with open(full, "rb") as f:
            blob = f.read()
        if verify:
            crc = zlib.crc32(blob) & 0xFFFFFFFF
            if crc != meta["crc32"] or len(blob) != meta["bytes"]:
                raise MXNetError(
                    "checkpoint %s shard %s (group %s, rank %d) is corrupt: "
                    "crc32 %08x / %d bytes on disk vs %08x / %d in the "
                    "manifest" % (path, fname, meta["group"], meta["rank"],
                                  crc, len(blob), meta["crc32"],
                                  meta["bytes"]))
        yield meta, nd.deserialize_arrays(blob) if parse else None


_ZERO_RE = re.compile(r"^stage(\d+)-zero(\d+)$")


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _rows(rows, shape, what, where):
    """ZeRO rows {j: chunk} concatenated, unpadded to ``shape``."""
    if sorted(rows) != list(range(len(rows))):
        raise MXNetError("checkpoint %s: ZeRO rows of %s are not contiguous "
                         "(%s)" % (where, what, sorted(rows)))
    flat = torch.cat([rows[j].reshape(-1) for j in sorted(rows)])
    return flat[:_numel(shape)].reshape(tuple(shape))


def _reassemble(man, group_entries, where):
    """Logical host trees ``(params, opt_state, aux)`` from ``(group,
    entries)`` pairs: ZeRO rows concatenated, unpadded and reshaped, stage
    groups merged.  Shared by the file loader and ``reassemble``."""
    params, aux = {}, {}
    flat_leaves = {}
    zparams = {}
    for group, entries in group_entries:
        m = _ZERO_RE.match(group)
        zrow = int(m.group(2)) if m else None
        for ename, arr in entries.items():
            kind, rest = ename.split(":", 1)
            if kind == "arg":
                params[rest] = arr
            elif kind == "argz":
                zparams.setdefault(rest, {})[zrow] = arr
            elif kind == "aux":
                aux[rest] = arr
            elif kind == "opt":
                n, i = rest.rsplit(":", 1)
                key = (n, int(i))
                if zrow is None:
                    flat_leaves[key] = arr
                else:
                    flat_leaves.setdefault(key, {})[zrow] = arr
    for n, rows in zparams.items():
        params[n] = _rows(rows, man["params"][n]["shape"], n, where)
    if man["opt_state"] is None:
        return params, None, aux
    opt_state = {}
    for n, count in man["opt_state"].items():
        leaves = []
        shape = man["params"][n]["shape"]
        for i in range(count):
            leaf = flat_leaves.get((n, i))
            if leaf is None:
                raise MXNetError(
                    "checkpoint %s: optimizer-state leaf %d of %s is absent "
                    "from every shard" % (where, i, n))
            if isinstance(leaf, dict):
                leaf = _rows(leaf, shape, "%s[%d]" % (n, i), where)
            leaves.append(leaf)
        opt_state[n] = tuple(leaves)
    return params, opt_state, aux


def load_sharded(path, verify=True):
    """``(manifest, params, opt_state, aux)`` of a checkpoint directory in
    logical CPU tensors, whatever topology wrote it; ``place_checkpoint``
    on the restoring step places them (``restore_into`` does both)."""
    man = load_manifest(path)
    pairs = ((meta["group"], entries)
             for meta, entries in _iter_shards(path, man, verify=verify))
    params, opt_state, aux = _reassemble(man, pairs, path)
    return man, params, opt_state, aux


def reassemble(job):
    """``(manifest, params, opt_state, aux)`` of an in-memory
    ``snapshot`` job: a save and ``load_sharded`` without the disk,
    through the same group arithmetic."""
    man = job["manifest"]
    params, opt_state, aux = _reassemble(man, sorted(job["groups"].items()),
                                         "<live snapshot>")
    return man, params, opt_state, aux


def restore_loaded(ts, man, params, opt_state, aux, device=None,
                   where="<loaded checkpoint>"):
    """Place loaded logical host trees on ``ts`` (``place_checkpoint``) and
    resume its update count and loss-scale state.  Absent optimizer state
    (a parameters-only save) restores fresh state.  Returns ``(params,
    opt_state, aux, manifest)``."""
    missing = [n for n in ts.param_names if n not in params]
    if missing:
        raise MXNetError("checkpoint %s does not cover parameter(s) %s of "
                         "this model" % (where, ", ".join(sorted(missing))))
    missing_aux = [n for n in ts.aux_names if n not in aux]
    if missing_aux:
        raise MXNetError("checkpoint %s does not cover aux state %s of this "
                         "model" % (where, ", ".join(sorted(missing_aux))))
    if opt_state is None:
        opt_state = ts.fopt.init_state(
            {n: torch.as_tensor(params[n]) for n in ts.param_names})
    p, s, a = ts.place_checkpoint(params, opt_state, aux, device=device)
    ts.num_update = int(man["step"])
    ts.load_scale_state((man.get("extra") or {}).get("loss_scale"))
    return p, s, a, man


def restore_into(ts, path, verify=True, device=None):
    """Restore a checkpoint directory onto ``ts``: ``load_sharded`` then
    ``restore_loaded``."""
    man, params, opt_state, aux = load_sharded(path, verify=verify)
    return restore_loaded(ts, man, params, opt_state, aux, device=device,
                          where=path)


# ------------------------------------------------------------------ listing
def latest_sharded(prefix):
    """The newest complete checkpoint directory of ``prefix``, or None.
    Complete: its manifest parses and every shard it names is present at
    its recorded size.  Newest: by the manifest's data position ``(epoch,
    nbatch, step)``, not the name's step (a resumed run whose count
    restarted writes lower steps).  Other candidates are skipped with a
    warning."""
    best = None
    for d in glob.glob("%s-step*%s" % (prefix, SUFFIX)):
        if _STEP_RE.search(d) is None or not os.path.isdir(d):
            continue
        try:
            man = load_manifest(d)
        except (MXNetError, ValueError, OSError) as e:
            _LOG.warning("latest_sharded: skipping unreadable candidate %s "
                         "(%s)", d, e)
            continue
        complete = True
        for fname, meta in man.get("shards", {}).items():
            full = os.path.join(d, fname)
            if not os.path.isfile(full) \
                    or os.path.getsize(full) != meta["bytes"]:
                complete = False
                break
        if not complete:
            _LOG.warning("latest_sharded: skipping incomplete candidate %s "
                         "(missing or short shard)", d)
            continue
        pos = (int(man.get("epoch", 0)), int(man.get("nbatch", 0)),
               int(man["step"]))
        if best is None or pos > best[0]:
            best = (pos, d)
    return best[1] if best else None


def verify_checkpoint(path):
    """Check every shard's presence, size and checksum; returns the
    manifest."""
    man = load_manifest(path)
    for _meta, _entries in _iter_shards(path, man, verify=True,
                                        parse=False):
        pass
    return man


def export_monolithic(path, fname):
    """A checkpoint directory as one ``.params`` file of ``arg:`` and
    ``aux:`` entries (``model.load_checkpoint`` / ``Module.load_params``
    read it); returns the manifest."""
    from . import ndarray as nd
    man, params, _opt, aux = load_sharded(path)
    nd.save(fname,
            dict([("arg:%s" % n, v) for n, v in sorted(params.items())]
                 + [("aux:%s" % n, v) for n, v in sorted(aux.items())]))
    return man
