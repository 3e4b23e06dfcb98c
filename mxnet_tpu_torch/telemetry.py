"""Runtime telemetry: counters, gauges, timed spans, histograms and
scalars (counterpart: mxnet_tpu/telemetry.py, the same events under the
same names and schema, so ``tools/telemetry_report.py``,
``tools/telemetry_agg.py`` and ``tools/run_compare.py`` read the port's
files unchanged).

A process-wide, thread-safe registry of

* **counters**   — accumulated values (``kvstore_push_bytes``,
  ``fit_samples``, ...),
* **gauges**     — last-value-wins measurements (``epoch_time``, ``mfu``),
* **spans**      — timed regions with tags (``data_wait``, ``forward``,
  ``backward``, ``update`` a fit batch); every span close also feeds a
  latency histogram of the same name,
* **histograms** — fixed log-spaced buckets with p50/p90/p99 estimation,
* **scalars**    — per-step time-series points (``train_accuracy``,
  ``lr``, ``grad_norm``, ...); ``MXNET_SCALARS_EVERY=N`` samples the
  per-step producers whose values cost a host read down to every N-th
  step through ``scalar_due(step)``,

exported as JSON-lines events.  Every span is also forwarded to
``profiler.record_event`` so the chrome trace and the JSON-lines stream
describe one timeline.

Zero overhead by default: while telemetry is off every entry point is one
module-global bool check — ``span()`` returns a shared no-op singleton,
``counter``/``gauge`` return at once, no thread starts and no hot path
gains a synchronize.  Call sites in hot loops also guard with ``if
telemetry._enabled:`` so they do not even build the tags dict.

Enable with ``start(path)`` / ``stop()``, or for a whole process with
``MXNET_TELEMETRY=<path.jsonl>`` (started at import, flushed at exit).

Flight recorder: ``MXNET_FLIGHT_RECORDER=N`` arms a bounded in-memory
ring of the last N closed events without a file sink, threads or
synchronizes.  The hot call sites light up (``_enabled`` goes True) but
``enabled()`` stays False, so nothing that keys a behaviour change on
full telemetry (the fused fit's fall back to the general path, the
``scalar_due`` reads, file export) reacts.  The ring is read by
``flight_recorder()``; the diagnostics bundle that embeds it in the JAX
package arrives with the numerics slice.
"""
from __future__ import annotations

import atexit
import json
import math
import threading
import time
from collections import deque

from .base import get_env

__all__ = ["start", "stop", "enabled", "span", "record_span", "counter",
           "gauge", "histogram", "scalar", "scalar_due", "value",
           "counters", "gauges", "histograms", "scalars", "quantile",
           "quantile_from_hist", "hist_bound", "events", "recent_events",
           "flush", "reset", "sink_path", "flight_recorder",
           "flight_recorder_armed"]

_lock = threading.RLock()
_enabled = False
_path = None
_buffer = deque()     # pending event dicts (drained to _path on flush)
_counters = {}
_gauges = {}
_histograms = {}      # name -> [count, sum, min, max, {bucket_index: n}]
_scalars = {}         # series key -> [n, last_step, last_value]
_scalars_every = 1    # MXNET_SCALARS_EVERY, re-read at every start()
_atexit_armed = False
_FLUSH_EVERY = 1024   # buffered events before an automatic file flush
_BUFFER_CAP = 262144  # in-memory mode: drop oldest beyond this
_RECENT_CAP = 512     # event-stream tail kept past flushes (diagnostics)
_recent = deque(maxlen=_RECENT_CAP)
_dropped = 0
# Flight recorder (MXNET_FLIGHT_RECORDER=N): a bounded ring of the last N
# events, fed by _emit_locked whenever armed.  In *fr-only* mode (_enabled
# True purely because the recorder armed it) events go ONLY to the ring —
# no buffer growth, no file sink, no _recent churn — and enabled() stays
# False so behaviour keyed on "full telemetry" (fused-path downgrade,
# scalar_due syncs) does not change.
_fr_ring = None       # deque(maxlen=_fr_cap) while armed, else None
_fr_cap = 0
_fr_only = False


def enabled():
    """True while the registry is recording a FULL session (``start()`` /
    ``MXNET_TELEMETRY``).  Deliberately False in flight-recorder-only mode:
    call sites that key behaviour — not just emission — on telemetry (the
    Module.fit fused-path downgrade, per-step device syncs) must not react
    to a crash ring that promises zero overhead."""
    return _enabled and not _fr_only


def start(path=None):
    """Begin a recording session.  ``path`` (optional) is a JSON-lines
    sink; without it events stay in memory (``events()``), capped at
    ``_BUFFER_CAP``.  Any state left by a previous session (buffered
    events, counter totals) is cleared — one session per file."""
    global _enabled, _path, _atexit_armed, _dropped, _scalars_every, _fr_only
    with _lock:
        if path:
            open(path, "w").close()   # truncate: one run per file
        _buffer.clear()
        _recent.clear()
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _scalars.clear()
        if _fr_ring is not None:
            _fr_ring.clear()
        _dropped = 0
        _fr_only = False   # the recorder keeps riding along under a session
        _path = path
        try:
            _scalars_every = max(1, int(get_env("MXNET_SCALARS_EVERY", 1)))
        except (TypeError, ValueError):
            import warnings
            warnings.warn("MXNET_SCALARS_EVERY=%r is not an integer; "
                          "recording every step"
                          % get_env("MXNET_SCALARS_EVERY"))
            _scalars_every = 1
        if path and not _atexit_armed:
            atexit.register(stop)
            _atexit_armed = True
        _enabled = True


def stop():
    """Stop recording: emit a summary event (final counter/gauge values),
    flush any file sink, and disable.  Idempotent.  While the flight
    recorder is armed the registry drops back to fr-only mode instead of
    fully disabling — the crash ring keeps recording."""
    global _enabled, _path, _fr_only
    with _lock:
        if not _enabled or _fr_only:
            return
        summary = {"type": "summary", "ts": time.time() * 1e6,
                   "counters": dict(_counters), "gauges": dict(_gauges)}
        if _histograms:
            summary["histograms"] = {name: _hist_export(h)
                                     for name, h in _histograms.items()}
        if _scalars:
            summary["scalars"] = {k: {"n": s[0], "step": s[1],
                                      "value": s[2]}
                                  for k, s in _scalars.items()}
        if _dropped:
            # in-memory cap evicted the run's oldest events — say so
            summary["dropped_events"] = _dropped
        _buffer.append(summary)
        if _fr_ring is not None:
            _flush_locked()
            _path = None
            _fr_only = True
        else:
            _enabled = False
            _flush_locked()


def reset():
    """Clear all recorded state (test helper)."""
    global _dropped
    with _lock:
        _buffer.clear()
        _recent.clear()
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _scalars.clear()
        if _fr_ring is not None:
            _fr_ring.clear()
        _dropped = 0


def sink_path():
    """Path of the JSON-lines sink of the current session (None while
    disabled or recording in memory) — lets a run stamp WHERE its event/
    scalar stream went into artifacts it emits (bench.py writes it into
    BENCH_*.json so ``tools/run_compare.py`` can chain from the benchmark
    record to its training curves)."""
    with _lock:
        return _path if _enabled else None


def _emit_locked(ev):
    global _dropped
    if _fr_ring is not None:
        _fr_ring.append(ev)      # bounded: deque(maxlen) evicts the oldest
        if _fr_only:
            return               # fr-only: the ring is the ONLY sink
    _buffer.append(ev)
    _recent.append(ev)
    if _path is not None:
        if len(_buffer) >= _FLUSH_EVERY:
            _flush_locked()
    elif len(_buffer) > _BUFFER_CAP:
        _buffer.popleft()
        _dropped += 1


def _emit(ev):
    with _lock:
        if not _enabled:
            return
        _emit_locked(ev)


def _flush_locked():
    global _path
    if _path is None or not _buffer:
        return
    try:
        with open(_path, "a") as f:
            for ev in _buffer:
                f.write(json.dumps(ev) + "\n")
    except OSError as e:
        # an observability feature must not abort training: a sink that
        # turns unwritable mid-run (dir removed, disk full) degrades to
        # in-memory recording with a warning
        import warnings
        warnings.warn("telemetry sink %s became unwritable (%s); file "
                      "export disabled, events stay in memory" % (_path, e))
        _path = None
        return
    _buffer.clear()


def flush():
    """Drain buffered events to the file sink (no-op without a path)."""
    with _lock:
        _flush_locked()


# ------------------------------------------------------------------ counters
def counter(name, value=1, **tags):
    """Accumulate ``value`` into counter ``name`` and emit one event.  The
    total update and the event emission share ONE lock acquisition, so
    concurrent threads can't write out-of-order ``total`` values."""
    if not _enabled:
        return
    ev = {"type": "counter", "name": name, "ts": time.time() * 1e6,
          "value": value}
    if tags:
        ev["tags"] = tags
    with _lock:
        if not _enabled:
            return
        total = _counters.get(name, 0) + value
        _counters[name] = total
        ev["total"] = total
        _emit_locked(ev)


def gauge(name, value, **tags):
    """Record the current value of gauge ``name`` and emit one event."""
    if not _enabled:
        return
    ev = {"type": "gauge", "name": name, "ts": time.time() * 1e6,
          "value": value}
    if tags:
        ev["tags"] = tags
    with _lock:
        if not _enabled:
            return
        _gauges[name] = value
        _emit_locked(ev)


# ---------------------------------------------------------------- histograms
# Fixed log-spaced buckets shared by every histogram: 20 buckets per decade
# (~5.9% relative resolution) with finite upper bounds 10**-1 .. 10**10,
# plus an implicit overflow bucket.  Fixed process-independent bounds are
# what make cross-rank merging associative — tools/telemetry_agg.py sums
# bucket counts by upper bound, no re-binning.  Values are unit-agnostic;
# the span-fed latency histograms record MICROSECONDS (matching span
# ``dur``).
_HIST_PER_DECADE = 20
_HIST_MIN_EXP = -1
_HIST_MAX_EXP = 10
_HIST_NFINITE = (_HIST_MAX_EXP - _HIST_MIN_EXP) * _HIST_PER_DECADE
_HIST_RATIO = 10.0 ** (1.0 / _HIST_PER_DECADE)


def hist_bound(index):
    """Upper bound of bucket ``index`` (0.._HIST_NFINITE; beyond is +inf).
    Bucket i holds values in (hist_bound(i-1), hist_bound(i)]; bucket 0
    additionally absorbs everything at or below its bound."""
    if index > _HIST_NFINITE:
        return float("inf")
    return 10.0 ** (_HIST_MIN_EXP + index / _HIST_PER_DECADE)


def _hist_index(value):
    if value <= 10.0 ** _HIST_MIN_EXP:
        return 0
    if value > 10.0 ** _HIST_MAX_EXP:
        return _HIST_NFINITE + 1
    idx = int(math.ceil((math.log10(value) - _HIST_MIN_EXP)
                        * _HIST_PER_DECADE))
    return min(max(idx, 1), _HIST_NFINITE)


def _hist_update_locked(name, value):
    if not math.isfinite(value):
        # an observability layer must never crash (or poison sums/quantiles
        # in) the run it observes; NaN/Inf *detection* is the diagnostics
        # sentinel's job (MXNET_CHECK_NUMERICS), not the histogram's
        return
    h = _histograms.get(name)
    if h is None:
        h = _histograms[name] = [0, 0.0, value, value, {}]
    h[0] += 1
    h[1] += value
    if value < h[2]:
        h[2] = value
    if value > h[3]:
        h[3] = value
    idx = _hist_index(value)
    h[4][idx] = h[4].get(idx, 0) + 1


def _hist_export(h):
    """Self-describing export: sparse ``{upper_bound: count}`` buckets (the
    overflow bucket keys as ``"inf"``) plus the bucket ratio, so consumers
    (summary event, metrics endpoint, tools/telemetry_agg.py) need no
    knowledge of the bucket scheme — merging sums counts by bound key and
    quantile estimation derives each bucket's lower edge as bound/ratio."""
    buckets = {}
    for idx, n in sorted(h[4].items()):
        b = hist_bound(idx)
        buckets["inf" if math.isinf(b) else "%.6g" % b] = n
    return {"count": h[0], "sum": h[1], "min": h[2], "max": h[3],
            "ratio": _HIST_RATIO, "buckets": buckets}


def histogram(name, value, **tags):
    """Record one observation into histogram ``name``.  Observations
    aggregate in-registry (no per-observation memory growth); one ``hist``
    event is emitted per explicit call so the JSON-lines stream keeps the
    raw value.  Span closes feed their histogram WITHOUT a ``hist`` event —
    the span event already carries the raw duration.  Non-finite values
    are dropped (NaN/Inf detection belongs to the diagnostics sentinel)."""
    if not _enabled:
        return
    value = float(value)
    if not math.isfinite(value):
        return
    ev = {"type": "hist", "name": name, "ts": time.time() * 1e6,
          "value": value}
    if tags:
        ev["tags"] = tags
    with _lock:
        if not _enabled:
            return
        _hist_update_locked(name, value)
        _emit_locked(ev)


def histograms():
    """Snapshot of all histograms in export form (see ``_hist_export``)."""
    with _lock:
        return {name: _hist_export(h) for name, h in _histograms.items()}


def quantile(name, q):
    """Estimated q-quantile (q in [0, 1]) of histogram ``name``, or None
    when it doesn't exist.  Log-linear interpolation inside the winning
    bucket, clamped to the observed [min, max]."""
    with _lock:
        h = _histograms.get(name)
        exp = _hist_export(h) if h is not None else None
    return quantile_from_hist(exp, q) if exp else None


def quantile_from_hist(h, q):
    """Quantile estimate from an exported histogram dict (pure function;
    tools/telemetry_agg.py carries a stdlib copy for offline use — the
    two are held together by a test)."""
    count = h.get("count", 0)
    if not count:
        return None
    q = min(max(float(q), 0.0), 1.0)
    lo_all = h.get("min")
    hi_all = h.get("max")
    ratio = h.get("ratio") or _HIST_RATIO
    entries = sorted(((float("inf") if k == "inf" else float(k), n)
                      for k, n in h.get("buckets", {}).items()),
                     key=lambda kv: kv[0])
    target = q * count
    cum = 0
    for i, (bound, n) in enumerate(entries):
        if cum + n < target and i < len(entries) - 1:
            cum += n
            continue
        if math.isinf(bound):
            lo = entries[i - 1][0] if i else lo_all
            hi = hi_all
        else:
            # the first occupied bucket contains the observed min, so its
            # effective lower edge is exactly that (also covers the
            # underflow bucket, whose nominal lower edge is meaningless)
            lo = lo_all if (i == 0 and lo_all is not None) else bound / ratio
            hi = bound
        if hi_all is not None:
            hi = min(hi, hi_all)
        if lo_all is not None:
            lo = min(max(lo, lo_all), hi)
        frac = (target - cum) / n if n else 1.0
        frac = min(max(frac, 0.0), 1.0)
        if lo <= 0 or hi <= 0:
            return lo + (hi - lo) * frac
        return lo * (hi / lo) ** frac
    return hi_all


# ------------------------------------------------------------------ scalars
def series_key(name, tags=None):
    """Display/series key of a scalar: the bare name, or ``name[k=v,...]``
    when tags distinguish several series under one name (``grad_norm``
    per parameter group, ``monitor`` per tensor).  ``tools/run_compare.py``
    carries a stdlib copy so offline curve alignment builds the SAME keys."""
    if not tags:
        return name
    return "%s[%s]" % (name, ",".join("%s=%s" % (k, tags[k])
                                      for k in sorted(tags)))


def scalar_due(step):
    """True when per-step scalar producers should record ``step`` — the
    sampling gate behind ``MXNET_SCALARS_EVERY=N`` (default 1: every
    step).  Producers whose values cost a device sync (fit metric values,
    optimizer introspection) check this BEFORE computing, so the knob
    bounds syncs, not just file volume.  Producers with their own cadence
    (Speedometer ``frequent``, Monitor ``interval``, epoch-end rollups,
    lr decay boundaries) emit directly — decimating those would drop the
    few points that matter most.  Always False in flight-recorder-only
    mode: the crash ring must never buy a device sync."""
    return _enabled and not _fr_only and int(step) % _scalars_every == 0


def scalar(name, step, value, **tags):
    """Record one time-series point: ``value`` of series ``name`` at
    integer ``step``.  Append-only into the same per-rank JSON-lines
    stream as every other event (``type: "scalar"``); the registry keeps
    only the last value per series (no per-point memory growth), exported
    with the summary event.  Non-finite values are RECORDED — unlike
    histogram observations, a NaN in a loss curve is the finding, and
    consumers (``run_compare``, ``--curves``) handle it.  Strict no-op
    while disabled."""
    if not _enabled:
        return
    step = int(step)
    value = float(value)
    ev = {"type": "scalar", "name": name, "ts": time.time() * 1e6,
          "step": step, "value": value}
    if tags:
        ev["tags"] = tags
    key = series_key(name, tags)
    with _lock:
        if not _enabled:
            return
        s = _scalars.get(key)
        if s is None:
            _scalars[key] = [1, step, value]
        else:
            s[0] += 1
            s[1] = step
            s[2] = value
        _emit_locked(ev)


def scalars():
    """Snapshot of every scalar series' last recorded point:
    ``{series_key: {"n": points, "step": last_step, "value": last}}``."""
    with _lock:
        return {k: {"n": s[0], "step": s[1], "value": s[2]}
                for k, s in _scalars.items()}


def value(name, default=None):
    """Current accumulated value of a counter (or gauge), else ``default``."""
    with _lock:
        if name in _counters:
            return _counters[name]
        return _gauges.get(name, default)


def counters():
    """Snapshot of all counter totals."""
    with _lock:
        return dict(_counters)


def gauges():
    """Snapshot of all gauge values."""
    with _lock:
        return dict(_gauges)


def registry_snapshot():
    """All four registries under ONE lock acquisition:
    ``{"counters", "gauges", "histograms", "scalars"}``.  The separate
    ``counters()``/``gauges()``/... accessors each lock independently, so
    a scraper stitching them together can observe a torn step — counters
    from step N, gauges from step N+1.  metrics_server builds its
    ``/metrics.json`` document from this snapshot so one scrape is one
    consistent point in time."""
    with _lock:
        return {
            "counters": dict(_counters),
            "gauges": dict(_gauges),
            "histograms": {name: _hist_export(h)
                           for name, h in _histograms.items()},
            "scalars": {k: {"n": s[0], "step": s[1], "value": s[2]}
                        for k, s in _scalars.items()},
        }


def events():
    """Snapshot of buffered (not yet flushed) events."""
    with _lock:
        return list(_buffer)


def recent_events(n=None):
    """Tail of the event stream (last ``_RECENT_CAP``, surviving file
    flushes) — the "last N events" a diagnostics bundle embeds so a hang
    or crash shows what the run was doing right before it died."""
    with _lock:
        evs = list(_recent)
    if n is None:
        return evs
    n = int(n)
    return evs[-n:] if n > 0 else []


def nbytes_of(arr):
    """Payload size of a tensor, an NDArray or a numpy array (host-side
    arithmetic, no synchronize); 0 when the size can't be derived.  The
    kvstore's byte counters read it."""
    t = getattr(arr, "value", arr)
    if hasattr(t, "element_size") and hasattr(t, "numel"):
        return int(t.numel()) * int(t.element_size())
    try:
        import numpy as _np
        return int(arr.size) * _np.dtype(arr.dtype).itemsize
    except Exception:
        return 0


# --------------------------------------------------------------------- spans
def record_span(name, start_wall_s, dur_s, cat="runtime", mirror=True,
                **tags):
    """Record one already-timed span (seconds in, microseconds stored).

    This is the single sink both ``span()`` and manually-timed call sites
    feed; it also mirrors the span into the profiler's chrome-trace stream
    so both outputs stay consistent.  Call sites whose region is ALREADY
    wrapped in a ``profiler.Scope`` (executor forward/backward, train_step)
    pass ``mirror=False`` so a profiler+telemetry run doesn't record the
    same region twice in the trace.

    Every close also feeds the latency histogram of the same name (µs), so
    spans get p50/p90/p99 visibility for free — ``quantile("step", 0.99)``,
    the metrics endpoint, and the cross-rank straggler report all read it.
    """
    if not _enabled:
        return
    ev = {"type": "span", "name": name, "cat": cat,
          "ts": start_wall_s * 1e6, "dur": dur_s * 1e6}
    if tags:
        ev["tags"] = tags
    with _lock:
        if not _enabled:
            return
        _hist_update_locked(name, ev["dur"])
        _emit_locked(ev)
    if not mirror:
        return
    from . import profiler as _profiler
    cur = threading.current_thread()
    _profiler.record_event(name, start_wall_s * 1e6, dur_s * 1e6, cat,
                           tid=0 if cur is threading.main_thread()
                           else threading.get_ident())


class _Span(object):
    """Context manager timing a region into the telemetry stream.  Extra
    tags may be attached mid-flight via ``self.tags[...] = ...`` (they are
    read at ``__exit__``); ``cancel()`` suppresses emission."""

    __slots__ = ("name", "cat", "tags", "mirror", "_t0", "_wall",
                 "_cancelled")

    def __init__(self, name, cat, tags, mirror=True):
        self.name = name
        self.cat = cat
        self.tags = tags
        self.mirror = mirror
        self._cancelled = False

    def __enter__(self):
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cancelled:
            return
        record_span(self.name, self._wall, time.perf_counter() - self._t0,
                    self.cat, mirror=self.mirror, **self.tags)

    def cancel(self):
        self._cancelled = True


class _NullSpan(object):
    """Shared no-op span handed out while telemetry is disabled."""

    __slots__ = ()
    tags = {}   # class-level scratch dict: writes are cheap and ignored

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def cancel(self):
        pass


_NULL_SPAN = _NullSpan()


def span(name, cat="runtime", mirror=True, **tags):
    """Timed-region context manager; a shared no-op while disabled."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, cat, tags, mirror)


# ------------------------------------------------------- flight recorder
def flight_recorder_armed():
    """True while the crash ring (``MXNET_FLIGHT_RECORDER=N``) is armed."""
    return _fr_ring is not None


def flight_recorder():
    """Snapshot of the flight-recorder ring for a diagnostics bundle, or
    None while disarmed: capacity, the ring contents (oldest first), and
    the last completed step derived from them — ``last_step`` is the tag
    dict of the newest closed ``step`` span (epoch/nbatch), and
    ``last_scalar_step`` the newest scalar event's global step, so a crash
    report names where each rank got to without replaying the ring."""
    with _lock:
        if _fr_ring is None:
            return None
        evs = list(_fr_ring)
    last_step = None
    last_scalar_step = None
    for ev in reversed(evs):
        t = ev.get("type")
        if last_step is None and t == "span" and ev.get("name") == "step":
            last_step = dict(ev.get("tags") or {})
        if last_scalar_step is None and t == "scalar":
            last_scalar_step = ev.get("step")
        if last_step is not None and last_scalar_step is not None:
            break
    return {"capacity": _fr_cap, "recorded": len(evs),
            "last_step": last_step, "last_scalar_step": last_scalar_step,
            "events": evs}


def _fr_arm(capacity):
    """Arm the flight recorder with a ring of ``capacity`` events.  Flips
    the registry into fr-only mode unless a full session is already
    recording (then the ring simply rides along)."""
    global _enabled, _fr_ring, _fr_cap, _fr_only
    capacity = int(capacity)
    if capacity <= 0:
        raise ValueError("flight recorder capacity must be > 0 "
                         "(got %d)" % capacity)
    with _lock:
        _fr_cap = capacity
        _fr_ring = deque(_fr_ring or (), maxlen=capacity)
        if not _enabled:
            _fr_only = True
            _enabled = True


def _fr_disarm():
    """Disarm the recorder and drop the ring (test helper)."""
    global _enabled, _fr_ring, _fr_cap, _fr_only
    with _lock:
        _fr_ring = None
        _fr_cap = 0
        if _fr_only:
            _fr_only = False
            _enabled = False


def _fr_autostart():
    """MXNET_FLIGHT_RECORDER=N arms the crash ring at import time.  No
    threads, no file, no atexit — the ring only surfaces through the
    diagnostics bundle.  A malformed or non-positive value degrades to
    disarmed-with-a-warning rather than failing the import."""
    raw = get_env("MXNET_FLIGHT_RECORDER")
    if raw is None or raw == "" or str(raw) == "0":
        return False
    try:
        cap = int(raw)
        if cap <= 0:
            raise ValueError(raw)
        _fr_arm(cap)
    except (TypeError, ValueError):
        import warnings
        warnings.warn("MXNET_FLIGHT_RECORDER=%r is not a positive integer; "
                      "flight recorder disarmed" % (raw,))
        return False
    return True


# ------------------------------------------------- autostart (env contract)
def _autostart():
    """MXNET_TELEMETRY=<path.jsonl> starts recording at import time.  In a
    multi-process run (the MXTPU_* launch contract, tools/launch.py) every
    worker would otherwise truncate and interleave the same file, so the
    worker rank is appended — one file per process.  An unwritable path
    degrades to disabled-with-a-warning rather than failing the import."""
    path = get_env("MXNET_TELEMETRY")
    if not path:
        return False
    rank = get_env("MXTPU_PROCESS_ID")
    if rank is not None:
        path = "%s.rank%s" % (path, rank)
    try:
        start(path)
    except OSError as e:
        import warnings
        warnings.warn("MXNET_TELEMETRY=%s is unwritable (%s); telemetry "
                      "disabled" % (path, e))
        return False
    return True


_autostart()
_fr_autostart()
