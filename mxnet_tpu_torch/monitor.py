"""Monitor — per-tensor statistics of a training step (counterpart:
mxnet_tpu/monitor.py; parity: reference python/mxnet/monitor.py).

Lifecycle, set by the ``Module.fit`` contract: ``install(executor)`` hooks
the executor's monitor callback; ``tic()`` arms collection for the batches
where ``step % interval == 0``; the executor streams (name, NDArray) pairs
of every node output of its one real forward into the armed monitor;
``toc()`` adds the executor's argument arrays, disarms, and returns
``(step, tensor_name, stat_string)`` rows.  On the fused fit path the
rows are the parameters' RMS, computed on the card by the step
(``module._FusedFit.monitor_feed``).

The JAX package's Monitor also checks each statistic for NaN/Inf under
``MXNET_CHECK_NUMERICS`` and names the first bad tensor; that check
arrives with the numerics slice, which brings the diagnostics it reports
through.
"""
from __future__ import annotations

import logging
import math
import re

from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Monitor"]

_LOG = logging.getLogger(__name__)


def _rms(x):
    """Default statistic: RMS magnitude of the tensor (norm / sqrt(size))."""
    return nd.norm(x) / math.sqrt(x.size)


def _render(stat):
    """A stat result (NDArray, number, or list of either) -> display string."""
    items = stat if isinstance(stat, list) else [stat]
    return ",".join(
        str(v.asnumpy()) if isinstance(v, NDArray) else str(v)
        for v in items)


def _scalar_stat(stat):
    """A stat result as a float when it is scalar-valued (a number, or a
    size-1 NDArray like the default RMS), else None.  The NDArray branch
    reads one scalar from the card — toc() already waits for it
    (_drain_pending), and the Monitor's ``interval`` bounds how often this
    runs."""
    if isinstance(stat, (int, float)):
        return float(stat)
    if isinstance(stat, NDArray) and stat.size == 1:
        return float(stat.asnumpy().reshape(-1)[0])
    return None


class Monitor(object):
    """Collects per-tensor statistics every ``interval`` batches.

    Parameters
    ----------
    interval : arm collection once every this many ``tic()`` calls
    stat_func : NDArray -> NDArray/number/list; default RMS magnitude
    pattern : regex — only tensor names matching it are recorded
    sort : sort the rows of each ``toc()`` by tensor name
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func if stat_func is not None else _rms
        self.sort = sort
        self._name_ok = re.compile(pattern).match
        self._armed = False
        self._step = 0
        self._armed_step = 0     # batch index the current arming refers to
        self._rows = []          # (step, tensor name, raw stat)
        self._installed = []     # executors hooked via install()
        # public alias: executors are handed this callable via install()
        self.stat_helper = self._observe

    def _observe(self, name, array):
        """Executor callback: record one tensor if armed and name matches."""
        if self._armed and self._name_ok(name):
            self._rows.append((self._armed_step, name, self.stat_func(array)))

    def install(self, exe):
        """Hook an executor (parity: Monitor.install / set_monitor_callback)."""
        exe.set_monitor_callback(self.stat_helper)
        self._installed.append(exe)

    def _drain_pending(self):
        """Finish any in-flight executor work so stats read settled values."""
        for exe in self._installed:
            for array in exe.arg_arrays:
                array.wait_to_read()

    def tic(self):
        """Begin a batch; arms collection on the interval boundary.  The
        armed batch's index is captured before the step counter advances,
        so rows report the batch that was observed."""
        if self._step % self.interval == 0:
            self._drain_pending()
            self._rows = []
            self._armed = True
            self._armed_step = self._step
        self._step += 1

    def toc(self):
        """End an armed batch: snapshot argument arrays of every installed
        executor, disarm, and return the collected rows as
        ``(step, name, stat_string)`` tuples."""
        if not self._armed:
            return []
        self._drain_pending()
        for exe in self._installed:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self._name_ok(name):
                    self._rows.append((self._armed_step, name,
                                       self.stat_func(array)))
        self._armed = False
        rows = self._rows
        self._rows = []
        if self.sort:
            rows.sort(key=lambda row: row[1])
        from . import telemetry as _tel
        if _tel._enabled:
            # scalar-valued rows flow into the telemetry scalar stream as
            # one `monitor` series per tensor; Monitor's own step counter
            # never resets, so it is a clean curve axis
            for step, name, stat in rows:
                v = _scalar_stat(stat)
                if v is not None:
                    _tel.scalar("monitor", step, v, tensor=name)
        return [(step, name, _render(stat)) for step, name, stat in rows]

    def toc_print(self):
        """``toc()`` + log each row (parity: Monitor.toc_print)."""
        for step, name, shown in self.toc():
            _LOG.info("Batch: %7d %30s %s", step, name, shown)
