"""KVStore: the key-value store (counterpart: mxnet_tpu/kvstore.py).

``init`` keeps a copy of each key's value on that value's context.  ``push``
sums the values given for a key, one per device, at the first value's
context (``_reduce``: each value on another device is copied there first),
sums duplicate keys of one push, and hands the sum to the updater
(``set_optimizer``: the optimizer runs where the stored value is) or,
without one, stores it in place of the value (the reference's
``local = merged``).  ``pull`` copies the stored value into each output
array.  While telemetry records, ``push`` counts ``kvstore_push`` (keys)
and ``kvstore_push_bytes`` (the summed values' bytes), ``pull`` counts
``kvstore_pull`` (output arrays) and ``kvstore_pull_bytes``, as in the JAX
package.  ``local`` and ``device`` share these semantics, as in the JAX
package; the reference's CommCPU / CommDevice split is not kept.

The ``dist*`` types (``dist_sync``, ``dist_async``, ``dist_sync_device``,
``dist_async_device``, ``dist``, ``dist_tpu``) span the processes of the
world (``parallel.dist``): ``rank`` and ``num_workers`` come from the
runtime, and a push sums each key over this process's devices first, then
all the keys of the push across the ranks in one ``dist.allreduce_tree``
(one collective a dtype).  Every rank keeps a replica of the store and runs
the updater on the summed value, so the replicas stay equal.  The async
modes are the same synchronous sum, as in the JAX package.
``set_optimizer`` on a ``dist*`` store goes through the command channel
(``_send_command_to_servers``: the optimizer pickled, then installed in
this process); ``barrier`` is a process barrier of the world and
``num_dead_node`` probes it (``parallel.elastic``).  In a process without
the MXTPU_* contract a ``dist*`` store is rank 0 of 1.
"""
from __future__ import annotations

import pickle

from .base import MXNetError, atomic_write, string_types
from . import ndarray as nd
from . import optimizer as opt
from . import telemetry as _tel
from .telemetry import nbytes_of as _nbytes

__all__ = ["KVStore", "create"]

LOCAL_TYPES = ("local", "device", "local_allreduce_cpu",
               "local_allreduce_device")
DIST_TYPES = ("dist_sync", "dist_async", "dist_sync_device",
              "dist_async_device", "dist", "dist_tpu")


def _key_list(key):
    if isinstance(key, (int, string_types)):
        return [key], True
    return list(key), False


def _value_list(vals, single):
    """One list of per-device values for each key."""
    if single:
        if isinstance(vals, list) and vals and isinstance(vals[0], list):
            return vals
        return [vals if isinstance(vals, list) else [vals]]
    return [v if isinstance(v, list) else [v] for v in vals]


def _reduce(vlist):
    """The sum of per-device values at the first value's context (parity:
    the JAX package's ``_reduce``), summed left to right."""
    if len(vlist) == 1:
        return vlist[0]
    dev = vlist[0].value.device
    out = vlist[0].value
    for v in vlist[1:]:
        out = out + v.value.to(dev)
    return nd.NDArray(out, ctx=vlist[0].context)


class KVStore(object):
    """A key-value store for parameter synchronisation (parity:
    mx.kvstore.KVStore)."""

    def __init__(self, kv_type="local"):
        if kv_type not in LOCAL_TYPES + DIST_TYPES:
            raise MXNetError("unknown kvstore type %s" % kv_type)
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._rank = 0
        self._num_workers = 1
        self._dist = kv_type in DIST_TYPES
        if self._dist:
            from .parallel import dist as _dist
            self._rank = _dist.rank()
            self._num_workers = _dist.num_workers()

    def init(self, key, value):
        """Keep a copy of each key's (first) value; a key is initialised
        once."""
        keys, single = _key_list(key)
        for k, vlist in zip(keys, _value_list(value, single)):
            if k in self._store:
                raise MXNetError("key %s already initialized" % str(k))
            self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Sum each key's values and update the stored value with the sum
        (the updater) or replace it by the sum (no updater)."""
        keys, single = _key_list(key)
        merged_by_key = {}
        uniq = []
        for k, vlist in zip(keys, _value_list(value, single)):
            m = _reduce(vlist)
            if k in merged_by_key:
                merged_by_key[k] = merged_by_key[k] + m
            else:
                merged_by_key[k] = m
                uniq.append(k)
        if self._dist:
            # every key of the push crosses the ranks in one collective a
            # dtype (dist.allreduce's span times it while telemetry
            # records)
            from .parallel import dist as _dist
            merged_by_key = _dist.allreduce_tree(merged_by_key)
        for k in uniq:
            merged = merged_by_key[k]
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError("key %s not initialized" % str(k))
                local = self._store[k]
                if merged.value.device != local.value.device:
                    merged = merged.copyto(local.context)
                self._updater(k, merged, local)
            else:
                self._store[k] = merged.copy()
        # counted after the loop, so a raising push reports no traffic
        if _tel._enabled:
            _tel.counter("kvstore_push", len(uniq))
            _tel.counter("kvstore_push_bytes",
                         sum(_nbytes(merged_by_key[k]) for k in uniq))

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into its output array(s)."""
        assert out is not None
        keys, single = _key_list(key)
        telem = _tel._enabled
        pulls = 0
        pulled_bytes = 0
        for k, olist in zip(keys, _value_list(out, single)):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            src = self._store[k].value
            for o in olist:
                o._set_value(src)
            if telem:
                # one pull an output array: a fan-out over several devices
                # moves that many copies of the key
                pulls += len(olist)
                pulled_bytes += _nbytes(src) * len(olist)
        # counted after the loop, so a raising pull reports no traffic
        if telem:
            _tel.counter("kvstore_pull", pulls)
            _tel.counter("kvstore_pull_bytes", pulled_bytes)

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the stored values at each push (the
        reference's update on the store); a ``dist*`` store receives it
        through the command channel, pickled, as MXNet's servers do."""
        if self._dist:
            self._send_command_to_servers(0, pickle.dumps(optimizer))
        else:
            self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    def set_updater(self, updater):
        """``updater(key, merged, stored)`` updates ``stored`` in place at
        each push."""
        self._set_updater(updater)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    def barrier(self):
        """A process barrier of the world for a ``dist*`` store (a
        sequenced id a call, so every rank calls it equally often), then
        wait for every card's pending work."""
        if self._dist:
            from .parallel import dist as _dist
            _dist.barrier()
        nd.waitall()

    def set_barrier_before_exit(self, barrier_before_exit=True):
        """Kept for the API (one process: no peer to wait for at exit)."""
        self._barrier_before_exit = bool(barrier_before_exit)

    def num_dead_node(self, node_id=0, timeout=30):
        """Unreachable peers: 0 when every rank reaches a bounded barrier
        within ``timeout`` seconds, else the other ranks' count
        (``parallel.elastic.num_dead_node``); 0 for a local store."""
        if not self._dist:
            return 0
        from .parallel import elastic as _elastic
        return _elastic.num_dead_node(node_id, timeout)

    def _send_command_to_servers(self, head, body):
        """The command channel's one command, 0 (set the optimizer, its
        pickle in ``body``), run in this process, which is the server;
        the pickle comes from this program's own caller, as in MXNet."""
        if int(head) != 0:
            raise MXNetError("unknown kvstore server command %d" % head)
        self._set_updater(opt.get_updater(pickle.loads(body)))

    def save_optimizer_states(self, fname):
        """The updater's states, pickled, through ``atomic_write``."""
        if self._updater is None:
            raise MXNetError("the store has no optimizer: set_optimizer "
                             "first")
        with atomic_write(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("the store has no optimizer: set_optimizer "
                             "first")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


def create(name="local"):
    """A KVStore of type ``name``: ``local``, ``device``,
    ``local_allreduce_cpu``, ``local_allreduce_device`` or one of the
    ``dist*`` types."""
    if not isinstance(name, string_types):
        raise TypeError("name must be a string")
    return KVStore(name)
