"""Execution-engine selection (counterpart: mxnet_tpu/engine.py; parity:
reference src/engine/engine.cc and the ``MXNET_ENGINE_TYPE`` debug
affordance).

The reference ships three engines (ThreadedEnginePerDevice,
ThreadedEnginePooled, NaiveEngine) selected by ``MXNET_ENGINE_TYPE``;
swapping to the synchronous NaiveEngine is its way to bisect asynchronous
scheduling bugs.  In the port the asynchronous engine is the CUDA stream:
an op returns once its kernels are queued.  So:

- ``ThreadedEnginePerDevice`` (default) and ``ThreadedEngine``: launches
  queue on the stream; a fault in a kernel surfaces at the next
  synchronizing read.
- ``NaiveEngine``: every imperative op and every executor forward and
  backward waits until the card has finished its work
  (``torch.cuda.synchronize`` on the result's device), so a fault surfaces
  at the op that caused it.  On the CPU there is nothing to wait for.

``MXNET_ENGINE_NOJIT=1`` asks the JAX package for op-by-op dispatch with
the jit cache bypassed.  PyTorch dispatches op by op always and the port
compiles no graph, so the knob is accepted and changes nothing here.
"""
from __future__ import annotations

from .base import MXNetError, get_env

__all__ = ["engine_type", "set_engine_type", "is_naive", "maybe_wait",
           "wait_all"]

_VALID = ("ThreadedEnginePerDevice", "ThreadedEngine", "NaiveEngine")
_state = {"type": None}


def engine_type():
    """Current engine name (env MXNET_ENGINE_TYPE, parity: engine.cc:14)."""
    if _state["type"] is None:
        t = get_env("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
        if t not in _VALID:
            raise MXNetError("unknown MXNET_ENGINE_TYPE %s" % t)
        _state["type"] = t
    return _state["type"]


def set_engine_type(t):
    if t not in _VALID:
        raise MXNetError("unknown engine type %s" % t)
    _state["type"] = t


def is_naive():
    return engine_type() == "NaiveEngine"


def _devices(arrays, out):
    """Collect the torch devices of the tensors in a nest of tensors,
    NDArrays, lists, tuples and dicts."""
    if arrays is None:
        return out
    if isinstance(arrays, dict):
        arrays = arrays.values()
    elif not isinstance(arrays, (list, tuple)):
        arrays = (arrays,)
    for a in arrays:
        if isinstance(a, (list, tuple, dict)):
            _devices(a, out)
            continue
        t = getattr(a, "_data", a)
        dev = getattr(t, "device", None)
        if dev is not None:
            out.add(dev)
    return out


def _wait(devices):
    """Wait until every card among ``devices`` has finished its queued
    work: one ``torch.cuda.synchronize`` a card; host devices need none.
    Every wait the engine, the executor, the trainer and the fit loop make
    goes through here."""
    import torch
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def maybe_wait(arrays):
    """Wait for the results' cards under NaiveEngine (sync debugging),
    no-op otherwise."""
    if is_naive():
        _wait(_devices(arrays, set()))
    return arrays


def settle(arrays):
    """Wait for the results' cards while NaiveEngine, the profiler or
    telemetry is on, so a fault surfaces at its op and a span or profiler
    range covers the device time, not the launch time.  With all three
    off it reads three flags and returns."""
    from . import profiler as _profiler
    from . import telemetry as _tel
    if _tel._enabled or _profiler._state["running"] or is_naive():
        _wait(_devices(arrays, set()))
    return arrays


def wait_all():
    """Engine::WaitForAll — drain the work queued on every card."""
    from . import ndarray as _nd
    _nd.waitall()
