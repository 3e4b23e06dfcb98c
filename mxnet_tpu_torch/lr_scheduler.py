"""Learning-rate schedules (counterpart: mxnet_tpu/lr_scheduler.py).

The schedulers are pure functions of ``num_update``, as in the JAX package:
the decayed rate is recomputed each call, so ``TrainStep.run_steps`` may
jump the update count by a whole chunk between calls.  ``base_lr`` stays a
plain attribute because the Optimizer assigns it after construction.
While telemetry records, each decay boundary is an ``lr`` scalar at its
update count, as in the JAX package: the fit loop samples its per-step
``lr`` point by ``MXNET_SCALARS_EVERY``, and the step where the rate
changes must never be sampled away.
"""
from __future__ import annotations

import logging

from . import telemetry as _tel

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]

_LOG = logging.getLogger(__name__)


def _record_decay(lr, num_update):
    """Publish an ``lr`` scalar at a decay boundary (parity:
    lr_scheduler._record_decay)."""
    if _tel._enabled:
        _tel.scalar("lr", num_update, lr)


class LRScheduler(object):
    """Maps an update count to a learning rate; subclasses implement
    ``__call__(num_update) -> float``."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError(
            "%s does not implement __call__" % type(self).__name__)


class FactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` every ``step`` updates, never below
    ``stop_factor_lr`` (the k-th decay takes effect at num_update ==
    k*step + 1)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError(
                "FactorScheduler: step was %r; need a positive update "
                "interval" % (step,))
        if factor > 1.0:
            raise ValueError(
                "FactorScheduler: factor was %r; a decay factor cannot "
                "exceed 1" % (factor,))
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._last_logged = 0

    def _decays_at(self, num_update):
        # num_update in [k*step+1, (k+1)*step] has had k decays applied
        return max(0, int(num_update) - 1) // self.step

    def __call__(self, num_update):
        k = self._decays_at(num_update)
        lr = self.base_lr * (self.factor ** k)
        floored = lr < self.stop_factor_lr
        lr = max(lr, self.stop_factor_lr)
        if k != self._last_logged:
            self._last_logged = k
            if floored:
                _LOG.info("lr schedule: floor %.5e reached at update %d; "
                          "holding there", lr, num_update)
            else:
                _LOG.info("lr schedule: %.5e after %d decay(s) "
                          "(update %d)", lr, k, num_update)
            _record_decay(lr, num_update)
        return lr


class MultiFactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` once at each boundary in ``step`` (a
    strictly increasing list of update counts; a boundary ``b`` takes effect
    at num_update == b + 1)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError(
                "MultiFactorScheduler: step must be a non-empty list of "
                "update counts, got %r" % (step,))
        prev = 0
        for b in step:
            if b < 1:
                raise ValueError(
                    "MultiFactorScheduler: boundary %r is not a positive "
                    "update count" % (b,))
            if b <= prev:
                raise ValueError(
                    "MultiFactorScheduler: boundaries must be strictly "
                    "increasing, got %r" % (step,))
            prev = b
        if factor > 1.0:
            raise ValueError(
                "MultiFactorScheduler: factor was %r; a decay factor "
                "cannot exceed 1" % (factor,))
        self.step = step
        self.factor = factor
        self._last_logged = 0

    def _decays_at(self, num_update):
        # count of boundaries already crossed (crossing happens at b+1)
        return sum(1 for b in self.step if num_update > b)

    def __call__(self, num_update):
        k = self._decays_at(num_update)
        lr = self.base_lr * (self.factor ** k)
        if k != self._last_logged:
            self._last_logged = k
            _LOG.info("lr schedule: %.5e after boundary %d of %d "
                      "(update %d)", lr, k, len(self.step), num_update)
            _record_decay(lr, num_update)
        return lr
