"""Data iterators (counterpart: mxnet_tpu/io.py).

The iterator protocol is the JAX package's (``provide_data`` /
``provide_label``, ``DataBatch`` with ``pad`` and ``index``, ``reset`` /
``next``), and every iterator yields **host** NDArrays: ``NDArrayIter``
gathers each batch on the CPU, and the trainer moves it to the card.
``NDArrayIter`` keeps the JAX package's gather schedule, its ``pad`` /
``discard`` / ``roll_over`` handling and its ``np.random`` shuffling, so
``np.random.seed`` gives both packages the same order.

``DevicePrefetchIter`` runs a ``stage`` callback on a producer thread
through a bounded queue; ``StagedInputs`` is the staging ``Module.fit``
hands it: the producer pins a batch's host tensors and copies them to the
card with ``non_blocking`` on a side stream, recording a CUDA event after
the copies, and the consumer makes its compute stream wait on that event
and marks the staged tensors as used by that stream (``record_stream``)
before the step reads them.

While telemetry records, ``DataIter.next`` and the image iterators count
``io_batches`` (tagged with the iterator's class), ``PrefetchingIter``
times its wait on the producers as the span ``io.queue_wait`` and counts
``io_prefetch_batches``, and ``DevicePrefetchIter`` counts
``io_device_prefetch_batches``, as in the JAX package.

``ImageRecordIter`` and ``ImageIter`` live in ``image.py``; this module
resolves them lazily (``image`` imports this module).
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError, get_env
from .context import cpu
from . import ndarray as nd
from . import telemetry as _tel
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "StagedInputs", "device_prefetch_depth"]


def _count_batch(it):
    """Count one batch of ``it`` as ``io_batches`` while telemetry records
    (the iterators that build their batches without ``DataIter.next``
    call it before returning one)."""
    if _tel._enabled:
        _tel.counter("io_batches", iter=type(it).__name__)


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name and shape of an input, with its dtype and layout (parity:
    io.DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch(object):
    """One mini-batch (parity: io.DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Iterator base (parity: io.DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            batch = DataBatch(data=self.getdata(), label=self.getlabel(),
                              pad=self.getpad(), index=self.getindex())
            # counted once the batch exists: a getdata() that raises
            # reports no batch
            _count_batch(self)
            return batch
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """The input as an ordered list of (name, numpy array) pairs."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.ascontiguousarray(np.asarray(v))))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (parity: io.NDArrayIter).

    Each epoch is a gather schedule, a list of ``(indices, pad)`` batches
    built at every reset: a batch is one fancy-index gather on the host,
    ``pad`` wraps the short last batch to the epoch's start, ``roll_over``
    carries the tail into the next epoch's first batch, ``discard`` drops
    it.  ``shuffle`` draws the order from ``np.random``."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise MXNetError("source %s has %d rows, expected %d"
                                 % (k, v.shape[0], self.num_data))
        if self.num_data < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size.")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._carry = np.array([], dtype=np.int64)  # roll_over tail
        self._schedule = []
        self._pos = 0
        self._build_schedule()

    def _build_schedule(self):
        order = np.arange(self.num_data, dtype=np.int64)
        if self.shuffle:
            order = np.random.permutation(self.num_data).astype(np.int64)
        if self.last_batch_handle == "roll_over" and self._carry.size:
            order = np.concatenate([self._carry, order])
            self._carry = np.array([], dtype=np.int64)
        b = self.batch_size
        n_full = order.size // b
        batches = [(order[i * b:(i + 1) * b], 0) for i in range(n_full)]
        tail = order[n_full * b:]
        if tail.size:
            if self.last_batch_handle == "pad":
                fill = order[:b - tail.size]
                batches.append((np.concatenate([tail, fill]), b - tail.size))
            elif self.last_batch_handle == "roll_over":
                self._carry = tail
        self._schedule = batches
        self._pos = 0

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self._carry = np.array([], dtype=np.int64)
        self._build_schedule()

    def reset(self):
        self._build_schedule()

    def iter_next(self):
        if self._pos >= len(self._schedule):
            return False
        self._pos += 1
        return True

    def _current(self):
        if not 0 < self._pos <= len(self._schedule):
            raise MXNetError("DataIter needs reset.")
        return self._schedule[self._pos - 1]

    def getdata(self):
        idx, _ = self._current()
        return [nd.array(v[idx], ctx=cpu()) for _, v in self.data]

    def getlabel(self):
        idx, _ = self._current()
        return [nd.array(v[idx], ctx=cpu()) for _, v in self.label]

    def getpad(self):
        return self._current()[1]


class _Wrapped(DataIter):
    """An iterator that delegates to an inner NDArrayIter."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class MNISTIter(_Wrapped):
    """MNIST idx-format reader (parity: io.MNISTIter)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=False, num_parts=1, part_index=0,
                 input_shape=None, **_):
        super().__init__(batch_size)
        imgs = self._read_idx(image)
        labs = self._read_idx(label)
        assert imgs.shape[0] == labs.shape[0]
        if shuffle:
            rng = np.random.RandomState(seed)
            idx = rng.permutation(imgs.shape[0])
            imgs, labs = imgs[idx], labs[idx]
        if num_parts > 1:
            n = imgs.shape[0] // num_parts
            imgs = imgs[part_index * n:(part_index + 1) * n]
            labs = labs[part_index * n:(part_index + 1) * n]
        imgs = imgs.astype(np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1], imgs.shape[2])
        if input_shape is not None:
            imgs = imgs.reshape((imgs.shape[0],) + tuple(input_shape))
        self._inner = NDArrayIter(imgs, labs.astype(np.float32),
                                  batch_size=batch_size,
                                  last_batch_handle="discard")

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path, opener = path + ".gz", gzip.open
        with opener(path, "rb") as f:
            data = f.read()
        magic = struct.unpack(">I", data[:4])[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
        arr = np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim)
        return arr.reshape(dims)


class CSVIter(_Wrapped):
    """CSV reader (parity: io.CSVIter)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **_):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches per epoch (parity:
    io.ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _Raised(object):
    """A producer's exception, forwarded through the queue."""

    def __init__(self, exc):
        self.exc = exc


_STOP = object()   # the end-of-epoch sentinel in a producer's queue


def _drain_queue(q, thread):
    """Empty ``q`` until ``thread`` (a producer blocked in ``q.put``) has
    ended, then join it."""
    while thread.is_alive():
        try:
            q.get(timeout=0.01)
        except queue.Empty:
            pass
    thread.join()


class PrefetchingIter(DataIter):
    """Prefetch batches of one or more iterators on producer threads
    through bounded queues of ``prefetch_depth`` (parity:
    io.PrefetchingIter).  ``ctx`` copies each batch's arrays there on the
    producer thread; the end of an epoch is a sentinel in each queue."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, ctx=None):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        assert self.iters, "need at least one child iterator"
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.prefetch_depth = max(1, prefetch_depth)
        self._ctx = ctx
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = None
        self._queues = None
        self._threads = []
        self._alive = False
        self._exhausted = False
        self._start_epoch()

    def _stage(self, arrays):
        if self._ctx is None:
            return arrays
        return [a.copyto(self._ctx) if a.context != self._ctx else a
                for a in arrays]

    def _producer(self, child, q):
        while True:
            try:
                b = child.next()
                b.data = self._stage(b.data)
                if b.label is not None:
                    b.label = self._stage(b.label)
            except StopIteration:
                q.put(_STOP)
                return
            except Exception as exc:   # forwarded to the consumer
                q.put(_Raised(exc))
                return
            q.put(b)
            if not self._alive:
                return

    def _start_epoch(self):
        self._drain()
        self._alive = True
        self._exhausted = False
        self._queues = [queue.Queue(maxsize=self.prefetch_depth)
                        for _ in self.iters]
        self._threads = [threading.Thread(target=self._producer, args=(c, q),
                                          daemon=True)
                         for c, q in zip(self.iters, self._queues)]
        for t in self._threads:
            t.start()

    def _drain(self):
        """Stop the producers and empty their queues."""
        self._alive = False
        for q, t in zip(self._queues or [], self._threads):
            _drain_queue(q, t)
        self._queues = None
        self._threads = []

    def _descs(self, which, renames):
        descs = []
        for i, child in enumerate(self.iters):
            ren = renames[i] if renames else {}
            for x in getattr(child, which):
                d = x if isinstance(x, DataDesc) else DataDesc(*x)
                descs.append(DataDesc(ren.get(d.name, d.name), d.shape,
                                      d.dtype, getattr(d, "layout", "NCHW")))
        return descs

    @property
    def provide_data(self):
        return self._descs("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._descs("provide_label", self.rename_label)

    def reset(self):
        self._drain()
        for child in self.iters:
            child.reset()
        self._start_epoch()

    def iter_next(self):
        if self._exhausted:
            return False
        telem = _tel._enabled
        if telem:
            # the wait on the producers apart: a long one means the
            # pipeline is input-bound despite the prefetch depth
            wall = time.time()
            t0 = time.perf_counter()
            parts = [q.get() for q in self._queues]
            wait = time.perf_counter() - t0
            if not any(p is _STOP or isinstance(p, _Raised)
                       for p in parts):
                _tel.record_span("io.queue_wait", wall, wait, cat="io")
                _tel.counter("io_prefetch_batches")
        else:
            parts = [q.get() for q in self._queues]
        for p in parts:
            if isinstance(p, _Raised):
                self._exhausted = True
                raise p.exc
        done = [p is _STOP for p in parts]
        if any(done):
            self._exhausted = True
            if not all(done):
                raise MXNetError(
                    "child iterators ended at different batch counts")
            return False
        pad0 = parts[0].pad
        if any(p.pad != pad0 for p in parts):
            raise MXNetError("child iterators disagree on pad")
        self.current_batch = DataBatch(
            sum([p.data for p in parts], []),
            sum([p.label for p in parts], []),
            pad0, parts[0].index)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def __del__(self):
        try:
            self._drain()   # unblock producers stuck in q.put
        except Exception:   # interpreter teardown: nothing left to free
            pass


def device_prefetch_depth():
    """The device prefetch depth from ``MXNET_DEVICE_PREFETCH``: unset or
    ``1`` -> 2 (double buffering, the default), ``0`` -> 0 (off),
    ``N >= 2`` -> N.  Read when a fit epoch starts."""
    raw = get_env("MXNET_DEVICE_PREFETCH", "1")
    try:
        n = int(raw)
    except (TypeError, ValueError):
        raise MXNetError("MXNET_DEVICE_PREFETCH=%r: expected 0 (off), 1 "
                         "(double buffering) or a queue depth >= 2" % raw)
    if n <= 0:
        return 0
    return max(2, n)


class StagedInputs(object):
    """Input tensors staged on a device (the producer half of the device
    prefetch).

    On a CUDA device the host tensors are pinned and copied with
    ``non_blocking`` on ``stream`` (a side stream), and an event is recorded
    on it after the copies; the pinned sources are kept until the staged
    tensors are dropped.  A tensor already on the device is used as it is,
    and so is every tensor when the device is the CPU.
    ``take()`` is the consumer half."""

    __slots__ = ("tensors", "_event", "_pinned")

    def __init__(self, host, device, stream=None):
        self._event = None
        self._pinned = None
        if device.type != "cuda":
            self.tensors = {n: t.to(device) for n, t in host.items()}
            return
        with torch.cuda.stream(stream):
            self._pinned = {n: t.pin_memory() for n, t in host.items()
                            if t.device.type == "cpu"}
            self.tensors = {n: self._pinned[n].to(device, non_blocking=True)
                            if n in self._pinned else t.to(device)
                            for n, t in host.items()}
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def take(self):
        """The staged tensors, ready for work on the current stream: that
        stream waits on the copies' event (on the device; the host does not
        block), and the caching allocator learns that it uses tensors
        allocated on the side stream."""
        if self._event is not None:
            dev = next(iter(self.tensors.values())).device
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(self._event)
            for t in self.tensors.values():
                t.record_stream(cur)
        return self.tensors


class DevicePrefetchIter(object):
    """A producer thread that pulls items from ``source``, runs ``stage`` on
    each and queues up to ``depth`` staged items (parity:
    io.DevicePrefetchIter): staging batch N+1 overlaps the step on batch N.

    ``stage`` receives whatever ``source`` yields and its result is what
    ``next()`` returns (``Module.fit`` attaches a ``StagedInputs`` to each
    DataBatch).  Exceptions in ``source`` or ``stage`` reach the consumer;
    the end is a queue sentinel.  One epoch per instance: ``drain()`` (the
    fit loop calls it on the way out) stops the producer."""

    def __init__(self, source, stage=None, depth=2):
        # an iterator is used as it is: iter() on it again would restart
        # one whose __iter__ resets (ImageRecordIter starts a second
        # producer, whose crops race the first's for one generator)
        self._source = source if hasattr(source, "__next__") \
            else iter(source)
        self._stage = stage if stage is not None else (lambda b: b)
        self._queue = queue.Queue(maxsize=max(1, int(depth)))
        self._alive = True
        self._exhausted = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while True:
            try:
                item = self._stage(next(self._source))
            except StopIteration:
                self._queue.put(_STOP)
                return
            except Exception as exc:   # forwarded to the consumer
                self._queue.put(_Raised(exc))
                return
            self._queue.put(item)
            if not self._alive:
                return

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        item = self._queue.get()
        if item is _STOP:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _Raised):
            self._exhausted = True
            raise item.exc
        if _tel._enabled:
            _tel.counter("io_device_prefetch_batches")
        return item

    next = __next__

    def drain(self):
        """Stop the producer and empty the queue (idempotent)."""
        self._alive = False
        _drain_queue(self._queue, self._thread)
        self._exhausted = True

    def __del__(self):
        try:
            self.drain()   # unblock a producer stuck in queue.put
        except Exception:   # interpreter teardown: nothing left to free
            pass


def __getattr__(name):
    """``ImageRecordIter`` and ``ImageIter`` from ``image`` (parity:
    mxnet_tpu.io's lazy aliases)."""
    if name in ("ImageRecordIter", "ImageIter"):
        from . import image
        return getattr(image, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
