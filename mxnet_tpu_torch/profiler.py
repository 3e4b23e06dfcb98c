"""Profiler (counterpart: mxnet_tpu/profiler.py; parity: reference
python/mxnet/profiler.py).

``dump_profile`` writes a chrome://tracing JSON of the ranges the port
records (``Scope``: ``executor.forward[...]``, ``executor.backward``,
``train_step[n]``; the telemetry spans mirrored into it; per-op events in
``imperative``/``all`` mode), as the JAX package's does.

``set_state("run")`` also starts a ``torch.profiler.profile`` session, where
the JAX package starts ``jax.profiler.start_trace``: CPU activity, and CUDA
activity when a card is present.  While it runs, every ``Scope`` also opens
a ``torch.profiler.record_function`` range of the same name, so the device
kernels nest under ``executor.forward[train]`` and ``train_step[n]``.
``set_state("stop")`` stops it and exports its chrome trace to
``<filename>.torch.json`` (the counterpart of ``<filename>.xplane/``).

Kineto runs one profiler session a process.  ``set_state("run")`` while
another ``torch.profiler`` session is open, or while this one runs, raises
``MXNetError``; a session that cannot start raises too, and the profiler
stays off.
"""
from __future__ import annotations

import json
import threading
import time

from .base import MXNetError, get_env

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "set_config", "set_state", "Scope", "is_running", "record_event"]

_state = {"mode": "symbolic", "filename": "profile.json", "running": False,
          "events": [], "torch_prof": None, "torch_trace": None}
_lock = threading.Lock()


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """(parity: MXSetProfilerConfig)"""
    if mode not in ("symbolic", "imperative", "api", "mem", "all"):
        raise MXNetError("invalid profiler mode %s" % mode)
    _state["mode"] = mode
    _state["filename"] = filename


set_config = profiler_set_config


def _start_torch_session():
    """Start the torch profiler session of a run; raises MXNetError when
    another session is open or the session cannot start."""
    import torch
    if _state["torch_prof"] is not None or \
            torch._C._autograd._profiler_enabled():
        raise MXNetError(
            "profiler.set_state('run'): a torch.profiler session is already "
            "open in this process (kineto runs one at a time); stop it "
            "before starting mxnet_tpu_torch's profiler")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
    except Exception as exc:
        raise MXNetError("profiler.set_state('run'): torch.profiler did "
                         "not start: %s" % exc) from exc
    _state["torch_prof"] = prof
    _state["torch_trace"] = _state["filename"] + ".torch.json"


def profiler_set_state(state="stop"):
    """(parity: MXSetProfilerState) — 'run' | 'stop'."""
    if state == "run":
        if _state["running"]:
            raise MXNetError("profiler.set_state('run'): the profiler is "
                             "already running")
        _start_torch_session()
        _state["t0"] = time.time()
        _state["running"] = True
    elif state == "stop":
        _state["running"] = False
        prof = _state["torch_prof"]
        if prof is not None:
            _state["torch_prof"] = None
            prof.stop()
            prof.export_chrome_trace(_state["torch_trace"])
    else:
        raise MXNetError("invalid profiler state %s" % state)


set_state = profiler_set_state


def is_running():
    return _state["running"]


def record_event(name, start_us, dur_us, cat="operator", tid=0):
    """Append one chrome-trace complete event (engine-level op timing)."""
    if not _state["running"]:
        return
    with _lock:
        _state["events"].append({"name": name, "cat": cat, "ph": "X",
                                 "ts": start_us, "dur": dur_us, "pid": 0,
                                 "tid": tid})


class Scope(object):
    """Context manager timing a region into the profile; a
    ``torch.profiler.record_function`` range of the same name while the
    torch session runs."""

    __slots__ = ("name", "cat", "_t0", "_range")

    def __init__(self, name, cat="operator"):
        self.name = name
        self.cat = cat
        self._range = None

    def __enter__(self):
        if _state["torch_prof"] is not None:
            import torch
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        t1 = time.time()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        record_event(self.name, self._t0 * 1e6, (t1 - self._t0) * 1e6,
                     self.cat)


def dump_profile():
    """Write chrome://tracing JSON (parity: MXDumpProfile / DumpProfile).

    Emits ``process_name``/``thread_name`` metadata events (ph='M') so the
    trace viewer labels rows, and DRAINS the recorded events: back-to-back
    dumps each contain only the events recorded since the previous dump.
    Each dump overwrites ``filename`` with its delta.  The process row
    keeps the JAX package's label, so a trace reader keyed on it reads
    both packages' files.
    """
    with _lock:
        # written under the lock and drained only after a successful
        # write: a failing open keeps the events for a retry
        events = _state["events"]
        meta = [{"name": "process_name", "ph": "M", "pid": 0,
                 "args": {"name": "mxnet_tpu"}}]
        for tid in sorted({e.get("tid", 0) for e in events} | {0}):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid,
                         "args": {"name": "python-main" if tid == 0
                                  else "worker-%d" % tid}})
        trace = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        with open(_state["filename"], "w") as f:
            json.dump(trace, f)
        _state["events"] = []


# autostart parity: MXNET_PROFILER_AUTOSTART
if get_env("MXNET_PROFILER_AUTOSTART", "0") == "1":
    profiler_set_config(get_env("MXNET_PROFILER_MODE", "symbolic"),
                        "profile_output.json")
    profiler_set_state("run")
