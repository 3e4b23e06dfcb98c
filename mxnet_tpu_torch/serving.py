"""Serving — concurrent predictor with dynamic bucketed batching
(counterpart: mxnet_tpu/serving.py, without its HTTP front end, which
arrives in a later slice).

Concurrent callers ``submit()`` single-sample requests into a queue; a
batcher thread coalesces whatever is in flight into one forward per tick,
padded up to a ladder of batch sizes (1/2/4/8/.../``max_batch``, one
``Predictor`` binding per rung, all sharing one weight set on the card), and
scatters the rows back to per-request futures.  Padded rows are zeros and
their outputs are dropped before the scatter, so padding never leaks into a
result.  The first request of a tick waits at most ``max_wait_ms`` (default
2 ms, ``MXNET_SERVE_WAIT_MS``) for company.

While telemetry records, each tick records every request's
``serve.queue_wait`` span, the ``serve_batch_size`` and
``serve_queue_depth`` gauges and the ``serve.batch`` span, and counts
``serve_requests`` and ``serve_padded_slots``, tagged with the model's
name, as in the JAX package.
"""
from __future__ import annotations

import contextlib as _contextlib
import queue as _queue_mod
import threading
import time
from concurrent.futures import Future

import numpy as _np

from .base import MXNetError, get_env
from .context import Context
from .predictor import Predictor, _load_params, _on_ctx, read_checkpoint
from . import telemetry as _tel

__all__ = ["bucket_ladder", "ServedModel", "Server"]


def bucket_ladder(max_batch):
    """Power-of-two batch-size ladder up to ``max_batch`` inclusive:
    ``bucket_ladder(8) == [1, 2, 4, 8]``; a non-power-of-two max is
    appended as the top rung (``bucket_ladder(6) == [1, 2, 4, 6]``)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise MXNetError("max_batch must be >= 1, got %d" % max_batch)
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


def _env_max_batch():
    """``MXNET_SERVE_MAX_BATCH`` (default 8), read only when the
    constructor did not set ``max_batch``."""
    max_batch = get_env("MXNET_SERVE_MAX_BATCH", 8, typ=int)
    if max_batch < 1:
        raise MXNetError("MXNET_SERVE_MAX_BATCH=%d: must be >= 1"
                         % max_batch)
    return max_batch


def _env_wait_s():
    """``MXNET_SERVE_WAIT_MS`` (default 2 ms) in seconds, read only when
    the constructor did not set ``max_wait_ms``."""
    wait_ms = get_env("MXNET_SERVE_WAIT_MS", 2.0, typ=float)
    if wait_ms < 0:
        raise MXNetError("MXNET_SERVE_WAIT_MS=%g: must be >= 0" % wait_ms)
    return wait_ms / 1e3


class _Request(object):
    """One enqueued sample: staged inputs + the future its row resolves."""

    __slots__ = ("inputs", "future", "wall", "t0")

    def __init__(self, inputs):
        self.inputs = inputs
        self.future = Future()
        self.wall = time.time()          # span start (wall clock)
        self.t0 = time.perf_counter()    # queue-wait base


class _WarmRequest(object):
    """A ladder-warm command, run on the batcher thread so warming never
    races a live forward."""

    __slots__ = ("future",)

    def __init__(self):
        self.future = Future()


_STOP = object()


class ServedModel(object):
    """One model under dynamic bucketed batching.

    symbol : Symbol or saved-symbol JSON string
    param_blob : params dict / ``.params`` path / raw bytes (as Predictor)
    input_shapes : {name: per-SAMPLE shape}; the batcher owns the batch axis
    name : registry label
    max_batch : top of the bucket ladder (default ``MXNET_SERVE_MAX_BATCH``
        or 8)
    max_wait_ms : dynamic-batching deadline (default ``MXNET_SERVE_WAIT_MS``
        or 2 ms; 0 serves whatever is already queued)
    buckets : explicit ladder (sorted, deduped; its top is max_batch)
    input_types / output_names / dev_type / dev_id : forwarded to each
        bucket's ``Predictor``; the default device is ``gpu(0)``
    """

    def __init__(self, symbol, param_blob, input_shapes, name=None,
                 max_batch=None, max_wait_ms=None, buckets=None,
                 input_types=None, output_names=None, dev_type="gpu",
                 dev_id=0):
        from . import symbol as sym_mod
        ctx = Context(dev_type, dev_id)
        ctx.torch_device()          # raises here when the device is missing
        if isinstance(symbol, (str, bytes)):
            symbol = sym_mod.load_json(
                symbol.decode() if isinstance(symbol, bytes) else symbol)
        self.name = name or "model"
        self._symbol = symbol
        # params land on the device once; every rung shares them
        arg_p, aux_p = _load_params(param_blob)
        self._param_blob = {}
        for prefix, group in (("arg:", arg_p), ("aux:", aux_p)):
            for k, v in group.items():
                self._param_blob[prefix + k] = _on_ctx(v, ctx, share=True)
        self._output_names = output_names
        self._dev = (dev_type, dev_id)
        self._sample_shapes = {k: tuple(int(x) for x in v)
                               for k, v in input_shapes.items()}
        self._input_types = {k: _np.dtype(_np.float32)
                             for k in self._sample_shapes}
        unknown_types = set(input_types or {}) - set(self._sample_shapes)
        if unknown_types:
            raise MXNetError("input_types names non-inputs %s"
                             % sorted(unknown_types))
        for k, t in (input_types or {}).items():
            self._input_types[k] = _np.dtype(t)
        if buckets:
            if any(b != int(b) for b in buckets):
                raise MXNetError("bucket sizes must be integers, got %s"
                                 % (sorted(buckets),))
            ladder = sorted({int(b) for b in buckets})
            if ladder[0] < 1:
                raise MXNetError("bucket sizes must be >= 1, got %s"
                                 % (sorted(buckets),))
            self.max_batch = ladder[-1]
            self.buckets = ladder
        else:
            self.max_batch = int(max_batch) if max_batch is not None \
                else _env_max_batch()
            self.buckets = bucket_ladder(self.max_batch)
        self._wait_s = (_env_wait_s() if max_wait_ms is None
                        else float(max_wait_ms) / 1e3)
        if self._wait_s < 0:
            raise MXNetError("max_wait_ms must be >= 0")
        self._lock = threading.RLock()
        self._predictors = {}     # bucket size -> Predictor binding
        self._queue = _queue_mod.Queue()
        self._thread = None
        self._closed = False
        self._stats = {"requests": 0, "batches": 0, "slots": 0,
                       "padded_slots": 0, "errors": 0,
                       "batches_by_bucket": {}}

    # ------------------------------------------------------------- lifecycle
    def _enqueue(self, item):
        """Closed-check, lazy batcher start and enqueue under one lock
        hold, so ``close()`` can never slip its stop sentinel ahead of an
        accepted request."""
        with self._lock:
            if self._closed:
                raise MXNetError("ServedModel %r is closed" % self.name)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._batch_loop, daemon=True,
                    name="mxtorch-serve-%s" % self.name)
                self._thread.start()
            self._queue.put(item)

    def close(self, timeout=5.0):
        """Stop the batcher thread after in-flight requests drain.
        Idempotent; further ``submit`` calls raise."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t = self._thread
            if t is not None:
                self._queue.put(_STOP)
        if t is not None:
            t.join(timeout)

    # ------------------------------------------------------------------- api
    def submit(self, inputs):
        """Enqueue one request (one sample per input) and return its
        ``concurrent.futures.Future``, which resolves to a list of
        per-output numpy rows.  Inputs are validated and copied here, in
        the caller's thread."""
        staged = {}
        for k, shape in self._sample_shapes.items():
            if k not in inputs:
                raise MXNetError("request for %r is missing input %r"
                                 % (self.name, k))
            arr = _np.array(inputs[k], dtype=self._input_types[k], copy=True)
            if tuple(arr.shape) != shape:
                raise MXNetError(
                    "request input %r has shape %s, want per-sample %s "
                    "(the batcher owns the batch axis)"
                    % (k, tuple(arr.shape), shape))
            staged[k] = arr
        unknown = set(inputs) - set(self._sample_shapes)
        if unknown:
            raise MXNetError("unknown request inputs %s (model %r takes %s)"
                             % (sorted(unknown), self.name,
                                sorted(self._sample_shapes)))
        req = _Request(staged)
        self._enqueue(req)
        return req.future

    def predict(self, inputs, timeout=None):
        """Blocking convenience: ``submit(inputs).result(timeout)``."""
        return self.submit(inputs).result(timeout)

    def warm(self, timeout=None):
        """Create every rung's binding and run one zero batch through it,
        on the batcher thread; blocks until done."""
        req = _WarmRequest()
        self._enqueue(req)
        req.future.result(timeout)
        return self

    def _do_warm(self, req):
        try:
            for b in self.buckets:
                self._predictor(b).forward(**{
                    k: _np.zeros((b,) + s, dtype=self._input_types[k])
                    for k, s in self._sample_shapes.items()})
            req.future.set_result(True)
        except Exception as exc:
            req.future.set_exception(exc)

    def stats(self):
        """Snapshot: requests, batches, slots, padded_slots, errors,
        batches_by_bucket, and mean ``occupancy`` (requests / slots)."""
        with self._lock:
            s = dict(self._stats)
            s["batches_by_bucket"] = dict(self._stats["batches_by_bucket"])
        s["occupancy"] = (s["requests"] / s["slots"]) if s["slots"] else None
        s["buckets"] = list(self.buckets)
        s["max_batch"] = self.max_batch
        s["max_wait_ms"] = self._wait_s * 1e3
        s["inputs"] = {k: list(v) for k, v in self._sample_shapes.items()}
        return s

    # ---------------------------------------------------------------- batcher
    def _predictor(self, bucket):
        """The rung's ``Predictor``, created on first use (batcher thread
        only, outside the lock)."""
        with self._lock:
            pred = self._predictors.get(bucket)
        if pred is None:
            shapes = {k: (bucket,) + s
                      for k, s in self._sample_shapes.items()}
            types = {k: t for k, t in self._input_types.items()
                     if t != _np.dtype(_np.float32)}
            pred = Predictor(self._symbol, self._param_blob, shapes,
                             dev_type=self._dev[0], dev_id=self._dev[1],
                             output_names=self._output_names,
                             input_types=types or None, copy_params=False)
            with self._lock:
                self._predictors[bucket] = pred
        return pred

    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _batch_loop(self):
        """Block for the first request, give it at most the deadline to
        attract company, then run the coalesced forward."""
        while True:
            req = self._queue.get()
            if req is _STOP:
                return
            if isinstance(req, _WarmRequest):
                self._do_warm(req)
                continue
            batch = [req]
            warms = []
            deadline = req.t0 + self._wait_s
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                try:
                    nxt = (self._queue.get_nowait() if remaining <= 0
                           else self._queue.get(timeout=remaining))
                except _queue_mod.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                if isinstance(nxt, _WarmRequest):
                    warms.append(nxt)   # after the in-flight batch
                    continue
                batch.append(nxt)
            self._run_batch(batch)
            for w in warms:
                self._do_warm(w)
            if stop:
                return

    def _run_batch(self, batch):
        n = len(batch)
        bucket = self._bucket_for(n)
        try:
            if _tel._enabled:
                now = time.perf_counter()
                for r in batch:
                    # enqueue -> tick start, with the request's own stamps
                    _tel.record_span("serve.queue_wait", r.wall, now - r.t0,
                                     cat="serve", mirror=False,
                                     model=self.name)
                _tel.gauge("serve_batch_size", n, model=self.name)
                _tel.gauge("serve_queue_depth", self._queue.qsize(),
                           model=self.name)
                batch_span = _tel.span("serve.batch", cat="serve",
                                       model=self.name, bucket=bucket, n=n)
            else:
                batch_span = _contextlib.nullcontext()
            with batch_span:
                pred = self._predictor(bucket)
                padded = {}
                for k, shape in self._sample_shapes.items():
                    buf = _np.zeros((bucket,) + shape,
                                    dtype=self._input_types[k])
                    for i, r in enumerate(batch):
                        buf[i] = r.inputs[k]
                    padded[k] = buf
                pred.forward(**padded)
                outs = [pred.get_output(j) for j in range(pred.num_outputs)]
                # only the n real rows are extracted: padding cannot leak
                rows = [[_np.array(o[i]) for o in outs] for i in range(n)]
        except Exception as exc:   # scatter the failure, keep serving
            with self._lock:
                self._stats["errors"] += n
            for r in batch:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(exc)
            return
        if _tel._enabled:
            _tel.counter("serve_requests", n, model=self.name)
            if bucket > n:
                _tel.counter("serve_padded_slots", bucket - n,
                             model=self.name)
        with self._lock:
            st = self._stats
            st["requests"] += n
            st["batches"] += 1
            st["slots"] += bucket
            st["padded_slots"] += bucket - n
            by = st["batches_by_bucket"]
            by[bucket] = by.get(bucket, 0) + 1
        for r, row in zip(batch, rows):
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(row)


class Server(object):
    """Named registry of :class:`ServedModel`s (multi-model hosting)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._models = {}

    def register(self, name, model=None, **kwargs):
        """Register ``model`` under ``name``, or build one from ``kwargs``
        (the ServedModel constructor's).  Re-registering a name replaces
        and closes the old model."""
        if model is None:
            model = ServedModel(name=name, **kwargs)
        elif not isinstance(model, ServedModel):
            raise MXNetError("register() wants a ServedModel (or kwargs "
                             "to build one), got %s" % type(model).__name__)
        else:
            if kwargs:
                raise MXNetError("register(model=...) takes no build "
                                 "kwargs; got %s" % sorted(kwargs))
            model.name = name
        with self._lock:
            old = self._models.get(name)
            self._models[name] = model
        if old is not None and old is not model:
            old.close()
        return model

    def register_checkpoint(self, name, prefix, epoch, input_shapes,
                            **kwargs):
        """Register from ``prefix-symbol.json`` + ``prefix-%04d.params``;
        ``input_shapes`` are per-sample."""
        sym_json, blob = read_checkpoint(prefix, epoch)
        return self.register(name, symbol=sym_json, param_blob=blob,
                             input_shapes=input_shapes, **kwargs)

    def unregister(self, name):
        with self._lock:
            model = self._models.pop(name, None)
        if model is not None:
            model.close()

    def names(self):
        with self._lock:
            return sorted(self._models)

    def model(self, name):
        with self._lock:
            model = self._models.get(name)
        if model is None:
            raise MXNetError("no model %r is registered (have %s)"
                             % (name, self.names()))
        return model

    def submit(self, name, inputs):
        return self.model(name).submit(inputs)

    def predict(self, name, inputs, timeout=None):
        return self.model(name).predict(inputs, timeout=timeout)

    def models(self):
        """{name: stats snapshot} for every registered model."""
        with self._lock:
            items = list(self._models.items())
        return {name: model.stats() for name, model in items}

    def close(self):
        with self._lock:
            models, self._models = list(self._models.values()), {}
        for model in models:
            model.close()
