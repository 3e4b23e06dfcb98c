"""Training-loop callbacks (counterpart: mxnet_tpu/callback.py).

Batch-end callbacks receive a ``model.BatchEndParam`` (``epoch``,
``nbatch``, ``eval_metric``, ``locals``); epoch-end callbacks receive
``(epoch, symbol, arg_params, aux_params)``.  ``Speedometer`` reads the
fit loop's ``fit_samples`` telemetry counter while telemetry records, and
``nbatch * batch_size`` otherwise, as in the JAX package;
``do_step_checkpoint`` writes sharded checkpoints of the fused fit's live
state every N updates.
"""
from __future__ import annotations

import logging
import time

from . import telemetry as _tel

__all__ = ["do_checkpoint", "module_checkpoint", "do_step_checkpoint",
           "log_train_metric", "Speedometer", "ProgressBar"]

_LOG = logging.getLogger(__name__)


def _metric_pairs(metric):
    return [] if metric is None else metric.get_name_value()


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback that saves ``mod`` every ``period`` epochs
    (parity: callback.module_checkpoint)."""
    every = max(1, int(period))

    def save_module(epoch, sym=None, arg=None, aux=None):
        done = epoch + 1
        if done % every == 0:
            mod.save_checkpoint(prefix, done, save_optimizer_states)

    return save_module


def do_checkpoint(prefix, period=1):
    """Epoch-end callback that saves the symbol and parameters every
    ``period`` epochs (parity: callback.do_checkpoint)."""
    from .model import save_checkpoint
    every = max(1, int(period))

    def save_params(epoch, sym, arg, aux):
        done = epoch + 1
        if done % every == 0:
            save_checkpoint(prefix, done, sym, arg, aux)

    return save_params


def do_step_checkpoint(module, checkpointer, every_n_steps, resume_epoch=0,
                       nbatch_offset=0):
    """Batch-end callback: every ``every_n_steps`` updates, a sharded
    checkpoint of the fused fit's live state through ``checkpointer`` (a
    ``checkpoint.Checkpointer``), the cadence of
    ``MXNET_CKPT_EVERY_N_STEPS`` (parity: callback.do_step_checkpoint).

    ``nbatch_offset`` adds the batches a mid-epoch resume skipped to the
    recorded batch index of ``resume_epoch``, so the manifest holds the
    true data position.  On the general path (no fused fit) it warns once
    and saves nothing; the per-epoch checkpoints remain."""
    every = max(1, int(every_n_steps))
    state = {"warned": False, "last": -1}

    def save_step(param):
        ff = getattr(module, "_active_fused", None)
        if ff is None:
            if not state["warned"]:
                state["warned"] = True
                _LOG.warning(
                    "step checkpointing: the fused fit path is not active; "
                    "mid-epoch sharded checkpoints are skipped (per-epoch "
                    "checkpoints still run)")
            return
        step = ff.num_update()
        if step % every or step == state["last"]:
            return
        state["last"] = step
        nbatch = param.nbatch + (nbatch_offset
                                 if param.epoch == resume_epoch else 0)
        ff.save_checkpoint(checkpointer, epoch=param.epoch, nbatch=nbatch)

    return save_step


def log_train_metric(period, auto_reset=False):
    """Batch-end callback that logs the training metric every ``period``
    batches, optionally resetting it (parity: callback.log_train_metric)."""

    def emit(param):
        if param.nbatch % period != 0:
            return
        for name, value in _metric_pairs(param.eval_metric):
            _LOG.info("epoch %d batch %d: train %s = %f",
                      param.epoch, param.nbatch, name, value)
        if auto_reset and param.eval_metric is not None:
            param.eval_metric.reset()

    return emit


class Speedometer(object):
    """Batch-end callback that logs samples/s every ``frequent`` batches
    (parity: callback.Speedometer).  It keeps one (batch index, samples,
    clock, source) mark; each report measures the span since the mark and
    re-arms, and a batch index that moves back (a new epoch) drops the
    mark.

    While telemetry records, the sample position is the fit loop's
    ``fit_samples`` counter (variable batch sizes report true throughput),
    else ``nbatch * batch_size``; a window where the counter did not move
    (a ``score()`` loop) falls back to the batch index.  Each reported
    rate is also a ``throughput`` scalar.  A report reads the metric,
    which waits for the card."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        # (nbatch, samples, perf_counter, source) of the last report
        self._mark = None

    def _position(self, nbatch):
        """(cumulative sample count, source) at this callback."""
        if _tel.enabled():
            pos = _tel.value("fit_samples")
            if pos is not None:
                return pos, "telemetry"
        return nbatch * self.batch_size, "batch"

    def __call__(self, param):
        now = time.perf_counter()
        n = param.nbatch
        pos, src = self._position(n + 1)  # the callback fires after it
        if self._mark is not None and n < self._mark[0]:
            self._mark = None
        if self._mark is None:
            self._mark = (n, pos, now, src)
            return
        if n % self.frequent != 0 or n == self._mark[0]:
            return
        span = max(now - self._mark[2], 1e-12)
        delta = pos - self._mark[1]
        stale = delta <= 0 or src != self._mark[3]
        if stale:
            # the counter did not move over the window, or telemetry
            # toggled within it: batch-index arithmetic
            delta = (n - self._mark[0]) * self.batch_size
        rate = delta / span
        if _tel.enabled():
            # the logged number as a curve point, on the fit loop's global
            # batch axis while the counter feeds (the loop's own index
            # otherwise)
            gb = None if stale else _tel.value("fit_batches")
            _tel.scalar("throughput", gb - 1 if gb else n, rate)
        pairs = _metric_pairs(param.eval_metric)
        if pairs:
            param.eval_metric.reset()
            shown = "  ".join("train-%s=%f" % nv for nv in pairs)
            _LOG.info("Epoch[%d] Batch[%d]  %.2f samples/s  %s",
                      param.epoch, n, rate, shown)
        else:
            _LOG.info("Epoch[%d] Batch[%d]  %.2f samples/s",
                      param.epoch, n, rate)
        self._mark = (n, pos, now, src)


class ProgressBar(object):
    """Batch-end callback that logs an ASCII progress bar over ``total``
    batches (parity: callback.ProgressBar)."""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        fill = int(round(self.length * frac))
        bar = "#" * fill + "." * (self.length - fill)
        _LOG.info("|%s| %3d%%", bar, int(frac * 100 + 0.5))
