"""Serving — concurrent predictor with dynamic bucketed batching and its
HTTP front end (counterpart: mxnet_tpu/serving.py).

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

The HTTP front end (``start_server`` / ``stop_server``, or
``MXNET_SERVE_PORT=<port>`` or ``<host>:<port>`` read at import) exposes a
:class:`Server`, :func:`default_server` unless another is given:
``GET /`` and ``/models`` (each model's stats), ``GET /healthz``, and
``POST /predict/<model>`` with ``{"inputs": {name: nested list}}`` (or the
inputs at the top level) and an optional ``timeout_s``.  A request fault
answers 400, a fault of the model's forward 500, a timeout 504, an unknown
route or model 404; every answer is JSON, non-finite floats as strings.
"""
from __future__ import annotations

import contextlib as _contextlib
import json
import math as _math
import queue as _queue_mod
import threading
import time
import warnings
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from .base import MXNetError, get_env
from .context import Context
from .predictor import Predictor, _load_params, _on_ctx, read_checkpoint
from . import telemetry as _tel

__all__ = ["bucket_ladder", "ServedModel", "Server", "default_server",
           "start_server", "stop_server", "server_port"]


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


# ------------------------------------------------------------- HTTP frontend
_lock = threading.Lock()
_http = None
_http_thread = None
_default_server = None
_default_lock = threading.Lock()


def default_server():
    """The process-wide :class:`Server` the HTTP front end exposes
    (created on first use; creating it starts nothing)."""
    global _default_server
    with _default_lock:
        if _default_server is None:
            _default_server = Server()
        return _default_server


def _parse_endpoint(value):
    """``<port>`` or ``<host>:<port>`` -> (host, port), the host
    ``127.0.0.1`` by default; ValueError on a malformed value (the JAX
    package's ``metrics_server.parse_endpoint``)."""
    value = str(value).strip()
    host, sep, port = value.rpartition(":")
    return (host if sep else "") or "127.0.0.1", int(port)


def _json_safe(obj):
    """Non-finite floats as their string forms, so that every answer stays
    RFC 8259 JSON (a model that starts emitting NaN must stay readable)."""
    if isinstance(obj, float) and not _math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code, doc):
        body = json.dumps(_json_safe(doc)).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass   # the client went away mid-answer

    def do_GET(self):   # noqa: N802 (http.server's name)
        path = self.path.split("?", 1)[0]
        registry = self.server.mx_registry
        if path in ("/models", "/"):
            self._send(200, {"models": registry.models()})
        elif path == "/healthz":
            self._send(200, {"ok": True, "models": registry.names()})
        else:
            self._send(404, {"error": "no route %s (have /models, /healthz, "
                                      "POST /predict/<model>)" % path})

    def do_POST(self):  # noqa: N802 (http.server's name)
        path = self.path.split("?", 1)[0]
        registry = self.server.mx_registry
        if not path.startswith("/predict/"):
            self._send(404, {"error": "POST route is /predict/<model>"})
            return
        name = path[len("/predict/"):]
        try:
            model = registry.model(name)
        except MXNetError as e:
            self._send(404, {"error": str(e)})
            return
        # a request fault (bad JSON, a bad input name or shape, raised by
        # the parsing or by submit itself) answers 400 ...
        try:
            length = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            if "inputs" in doc:
                inputs = doc["inputs"]
            else:
                # the top-level object holds the inputs, less the
                # envelope's own key
                inputs = {k: v for k, v in doc.items() if k != "timeout_s"}
            if not isinstance(inputs, dict):
                raise ValueError('"inputs" must be an object of '
                                 "{input_name: nested list}")
            timeout = float(doc.get("timeout_s", 30.0))
            fut = model.submit(inputs)
        except (ValueError, TypeError, MXNetError) as e:
            # TypeError too: float(None) for a null timeout_s, or a
            # non-numeric nested input
            self._send(400, {"error": str(e)})
            return
        # ... and whatever the future carries is a fault of the server
        # (a failed bind or forward, MXNetError included): 500
        try:
            outs = fut.result(timeout)
        except (TimeoutError, _FutureTimeout):
            self._send(504, {"error": "predict timed out"})
            return
        except Exception as e:   # the model's fault, answered as JSON
            self._send(500, {"error": "%s: %s" % (type(e).__name__, e)})
            return
        self._send(200, {"model": name,
                         "outputs": [o.tolist() for o in outs]})

    def log_message(self, *args):
        """No stderr line a request."""


def start_server(port=None, host=None, registry=None):
    """Start the HTTP endpoint and return its bound port; a running
    endpoint's port is returned as it is.  ``port=None`` reads
    ``MXNET_SERVE_PORT`` (``<port>`` or ``<host>:<port>``) and returns
    None when it is unset or 0, starting nothing; ``port=0`` binds an
    ephemeral port.  ``registry`` defaults to :func:`default_server`."""
    global _http, _http_thread
    with _lock:
        if _http is not None:
            return _http.server_address[1]
        if port is None:
            raw = get_env("MXNET_SERVE_PORT")
            if not raw:
                return None
            env_host, port = _parse_endpoint(raw)
            if port <= 0:
                return None
            if host is None:
                host = env_host
        srv = ThreadingHTTPServer((host or "127.0.0.1", port), _Handler)
        srv.daemon_threads = True
        srv.mx_registry = registry if registry is not None \
            else default_server()
        _http = srv
        _http_thread = threading.Thread(target=srv.serve_forever,
                                        name="mxtorch-serve-http",
                                        daemon=True)
        _http_thread.start()
        return srv.server_address[1]


def stop_server():
    """Shut the HTTP endpoint down and close its socket (the registered
    models keep running: close them through their Server).  Idempotent."""
    global _http, _http_thread
    with _lock:
        srv, _http = _http, None
        t, _http_thread = _http_thread, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None and t.is_alive():
        t.join(timeout=5.0)


def server_port():
    """The bound port while the HTTP endpoint runs, else None."""
    with _lock:
        return _http.server_address[1] if _http is not None else None


def _autostart():
    """``MXNET_SERVE_PORT=<port>`` (or ``<host>:<port>``) starts the HTTP
    front end at import (user code registers models on
    :func:`default_server`).  A malformed value or a port that cannot be
    bound warns and leaves the endpoint off; unset, nothing happens."""
    raw = get_env("MXNET_SERVE_PORT")
    if not raw:
        return False
    try:
        _, port = _parse_endpoint(raw)
    except ValueError:
        warnings.warn("MXNET_SERVE_PORT=%r is not <port> or <host>:<port>; "
                      "serving endpoint disabled" % raw)
        return False
    if port <= 0:
        return False
    try:
        return start_server() is not None
    except OSError as e:
        warnings.warn("MXNET_SERVE_PORT=%s: cannot bind (%s); serving "
                      "endpoint disabled" % (raw, e))
        return False


_autostart()
