"""BaseModule: the training API (counterpart:
mxnet_tpu/module/base_module.py): ``fit``, ``score``, ``predict`` and
``iter_predict`` over the intermediate API (``forward`` / ``backward`` /
``update``) that a Module implements.

``fit`` trains through ``Module._start_fused_fit``'s fused ``TrainStep``
when it engages (one step a batch, batches staged on the card by a producer
thread) and through forward, backward and the ``Updater`` otherwise.
While telemetry records (``MXNET_TELEMETRY``, ``telemetry.start``), each
batch is the spans ``data_wait``, ``forward``/``backward`` (or
``forward_backward``, or ``fused_step``), ``update``, ``metric`` and
``step``, with the counters ``fit_batches``/``fit_samples``/``fit_epochs``,
the ``epoch_time`` gauge, the ``train_*``, ``lr``, ``samples_per_sec`` and
``val_*`` scalars and, on the fused path with a known peak, the MFU gauges
``model_flops``, ``achieved_flops`` and ``mfu``, under the JAX package's
names.  ``fit(monitor=)`` and ``install_monitor`` take a ``Monitor``.

The JAX package's numerics sentinel, watchdog, diagnostics snapshots and
``MXNET_MONITOR`` arrive with the numerics slice: ``fit`` raises
``MXNetError`` when one of their knobs is set rather than ignore it.
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError, get_env
from ..context import cpu
from .. import amp as _amp
from .. import cost as _cost
from .. import io as _io
from .. import metric as metric_mod
from .. import ndarray as nd
from .. import telemetry as _tel
from ..model import BatchEndParam, _split_params

__all__ = ["BaseModule"]

# the JAX package's fit reads these knobs; they turn on work of the
# numerics slice (the numerics sentinel, the step-anomaly sentinel, the
# watchdog and crash snapshots, the numerics monitor).  "" and "0" leave
# them off.
NUMERICS_KNOBS = ("MXNET_CHECK_NUMERICS", "MXNET_SENTINEL",
                  "MXNET_WATCHDOG_SEC", "MXNET_DIAG_DIR", "MXNET_MONITOR")


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, list) else [obj]


def _check_input_names(symbol, names, typename, throw):
    """Verify that declared data/label names exist among the symbol's
    arguments."""
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if not arg.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = "You created Module with Module(..., %s_names=%s) but input " \
              "with name '%s' is not found in symbol.list_arguments(). " \
              "Did you mean one of:\n\t%s" % (
                  typename, str(names), name, "\n\t".join(candidates))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _lr_point(module, default_step):
    """(lr, step) of the fit loop's ``lr`` curve point, or (None, _)
    (parity: base_module._lr_point).  The step axis is the optimizer's
    update count, the axis schedules are functions of; on the fused path
    the live count is the TrainStep's."""
    opt = getattr(module, "_optimizer", None)
    if opt is None:
        return None, default_step
    ff = getattr(module, "_active_fused", None)
    num_update = ff._ts.num_update if ff is not None \
        else getattr(opt, "num_update", None)
    step = default_step if num_update is None else num_update
    sched = getattr(opt, "lr_scheduler", None)
    if sched is not None and num_update is not None:
        return sched(num_update), step
    return getattr(opt, "lr", None), step


def _refuse_unported():
    """Raise for every fit knob whose work is not ported."""
    for knob in NUMERICS_KNOBS:
        if get_env(knob, "") not in ("", "0"):
            raise MXNetError("%s=%r is not ported yet: it arrives with the "
                             "numerics slice; unset it"
                             % (knob, get_env(knob)))


class BaseModule(object):
    """The module API: high level (fit, score, predict) over intermediate
    (forward, backward, update) over low level (bind, init_params)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------ high level
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate over an iterator: ``[(metric name, value)]`` (parity:
        BaseModule.score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()

        def notify(cbs, n, loc):
            for cb in _as_list(cbs):
                cb(BatchEndParam(epoch=epoch, nbatch=n,
                                 eval_metric=eval_metric, locals=loc))
        seen = 0
        for eval_batch in eval_data:
            if num_batch is not None and seen == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            notify(batch_end_callback, seen, locals())
            seen += 1
        if score_end_callback:
            notify(score_end_callback, seen, locals())
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs without the pad rows, batch index, batch) (parity:
        BaseModule.iter_predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over an iterator, without pad rows (parity:
        BaseModule.predict)."""
        # iter_predict yields views of the bound outputs: own them first
        per_batch = [[o.copy() for o in outs] for outs, _, _
                     in self.iter_predict(eval_data, num_batch=num_batch,
                                          reset=reset)]
        if not per_batch or not merge_batches:
            return per_batch
        widths = {len(outs) for outs in per_batch}
        if len(widths) != 1:
            raise MXNetError(
                "predict(merge_batches=True): batches produced differing "
                "output counts %s" % sorted(widths))
        merged = [nd.concatenate([outs[i] for outs in per_batch])
                  for i in range(widths.pop())]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, policy=None):
        """Train over ``num_epoch`` epochs of ``train_data`` (parity:
        BaseModule.fit).  ``policy`` (an ``amp.Policy``, True or a dtype
        string; by default ``MXNET_AMP`` decides) trains in mixed precision
        on the fused path.  ``monitor`` (a ``Monitor``) collects per-tensor
        statistics.  The numerics and parallel knobs raise ``MXNetError``:
        not ported yet."""
        assert num_epoch is not None, "please specify number of epochs"
        _refuse_unported()
        from .. import initializer as init_mod
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        fast = getattr(self, "_start_fused_fit",
                       lambda policy=None, monitor=None: None)(
                           policy=policy, monitor=monitor)
        if fast is None:
            if monitor is not None:
                # the general path: per-op observation through the
                # executors' callback
                self.install_monitor(monitor)
            if _amp.resolve_policy(policy) is not None:
                # never train float32 silently while the caller asked for
                # AMP
                self.logger.warning(
                    "fit: mixed-precision policy (MXNET_AMP/policy=) "
                    "ignored: the general path trains float32%s",
                    " (a custom Monitor stat_func forces the general path)"
                    if monitor is not None else "")
        # per-step MFU: only while telemetry records on the fused path and
        # a peak FLOP rate resolves (MXNET_PEAK_FLOPS or the card's row)
        mfu_on = fast is not None and _tel._enabled and _cost.enabled()
        peak_flops = _cost.resolve_peaks()[0] if mfu_on else None
        # the batch axis for sample counting: time-major iterators
        # (layout 'TN') put the batch on axis 1
        desc0 = (train_data.provide_data or [None])[0]
        batch_axis = max(0, _io.DataDesc.get_batch_axis(
            getattr(desc0, "layout", None))) if desc0 is not None else 0

        # the global batch index over the whole fit: the step axis of the
        # training-curve scalars
        gstep = 0
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            epoch_samples = 0
            data_iter = iter(train_data)
            if fast is not None:
                # batch N+1 is staged on the card while step N runs
                data_iter = fast.prefetch(data_iter)
            try:
                while True:
                    # with telemetry off the loop body is the untimed one:
                    # no span objects, no tag dicts, no clock reads
                    telem = _tel._enabled
                    if telem:
                        step_wall = time.time()
                        step_t0 = time.perf_counter()
                        # the iterator's fetch apart, so the breakdown
                        # tells input starvation from compute
                        with _tel.span("data_wait", cat="step", epoch=epoch,
                                       nbatch=nbatch) as dsp:
                            try:
                                data_batch = next(data_iter)
                            except StopIteration:
                                dsp.cancel()
                                break
                    else:
                        try:
                            data_batch = next(data_iter)
                        except StopIteration:
                            break
                    if monitor is not None:
                        monitor.tic()
                        if fast is not None:
                            # an armed tic() has the step sample its
                            # parameter norms on the card
                            fast.monitor_tic(monitor)
                    if fast is not None:
                        if telem:
                            with _tel.span("fused_step", cat="step",
                                           epoch=epoch, nbatch=nbatch):
                                outputs, dev_labels = fast.step(data_batch)
                            with _tel.span("metric", cat="step", epoch=epoch,
                                           nbatch=nbatch):
                                eval_metric.update(
                                    dev_labels or data_batch.label, outputs)
                        else:
                            outputs, dev_labels = fast.step(data_batch)
                            eval_metric.update(dev_labels or data_batch.label,
                                               outputs)
                    elif telem:
                        if type(self).forward_backward is not \
                                BaseModule.forward_backward:
                            # a subclass's own forward_backward is one span
                            with _tel.span("forward_backward", cat="step",
                                           epoch=epoch, nbatch=nbatch):
                                self.forward_backward(data_batch)
                        else:
                            with _tel.span("forward", cat="step", epoch=epoch,
                                           nbatch=nbatch):
                                self.forward(data_batch, is_train=True)
                            with _tel.span("backward", cat="step",
                                           epoch=epoch, nbatch=nbatch):
                                self.backward()
                        with _tel.span("update", cat="step", epoch=epoch,
                                       nbatch=nbatch):
                            self.update()
                        with _tel.span("metric", cat="step", epoch=epoch,
                                       nbatch=nbatch):
                            self.update_metric(eval_metric, data_batch.label)
                    else:
                        self.forward_backward(data_batch)
                        self.update()
                        self.update_metric(eval_metric, data_batch.label)
                    if monitor is not None:
                        if fast is not None:
                            # rows for toc() from the sampled step's norms
                            fast.monitor_feed(monitor)
                        monitor.toc_print()
                    if telem:
                        # counted before the callbacks, so the Speedometer
                        # reads a position that includes this batch; the
                        # pad rows of a short last batch are no samples
                        bs = data_batch.data[0].shape[batch_axis] \
                            if data_batch.data else 0
                        bs -= getattr(data_batch, "pad", None) or 0
                        epoch_samples += bs
                        _tel.counter("fit_batches")
                        _tel.counter("fit_samples", bs)
                        if _tel.scalar_due(gstep):
                            # the metric's running values and the lr: a
                            # host read, which MXNET_SCALARS_EVERY bounds
                            for mname, mval in eval_metric.get_name_value():
                                _tel.scalar("train_%s" % mname, gstep, mval)
                            lr, lr_step = _lr_point(self, gstep)
                            if lr is not None:
                                _tel.scalar("lr", lr_step, lr)
                            amp = fast.amp_stats() if fast is not None \
                                else None
                            if amp is not None:
                                _tel.scalar("train_loss_scale", gstep, amp[0])
                                _tel.gauge("loss_scale", amp[0])
                                if amp[1]:
                                    _tel.counter("amp_overflow_steps", amp[1])
                    if batch_end_callback is not None:
                        param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric,
                                              locals=locals())
                        for callback in _as_list(batch_end_callback):
                            callback(param)
                    if telem:
                        # the whole step: data_wait + compute + callbacks
                        total_s = time.perf_counter() - step_t0
                        _tel.record_span("step", step_wall, total_s,
                                         cat="step", epoch=epoch,
                                         nbatch=nbatch)
                        if mfu_on and total_s > 0:
                            # the graph's FLOPs over the step's wall time,
                            # against the resolved peak
                            flops = fast.step_flops()
                            if flops:
                                achieved = flops / total_s
                                _tel.gauge("model_flops", flops)
                                _tel.gauge("achieved_flops",
                                           round(achieved, 3))
                                _tel.gauge("mfu",
                                           round(achieved / peak_flops, 4))
                    nbatch += 1
                    gstep += 1
            finally:
                # an exception mid-epoch must not leave the prefetch
                # producer blocked in queue.put holding staged batches
                drain = getattr(data_iter, "drain", None)
                if drain is not None:
                    drain()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)
            if _tel._enabled:
                _tel.counter("fit_epochs")
                _tel.gauge("epoch_time", toc - tic, epoch=epoch)
                _tel.record_span("epoch", tic, toc - tic, cat="epoch",
                                 epoch=epoch, batches=nbatch,
                                 samples=epoch_samples)
                if epoch_samples and toc > tic:
                    _tel.scalar("samples_per_sec", gstep,
                                epoch_samples / (toc - tic))
            if fast is not None:
                fast.sync_back()
            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            for callback in _as_list(epoch_end_callback):
                callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
                    if _tel._enabled:
                        # the eval curve on the train_* scalars' step axis
                        _tel.scalar("val_%s" % name, gstep, val)
            train_data.reset()

    # ------------------------------------------------------------- param API
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Save the parameters as ``arg:``/``aux:`` entries of a
        ``.params`` file."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        self.set_params(*_split_params(nd.load(fname, ctx=cpu())))

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value

    def install_monitor(self, mon):
        raise NotImplementedError()

    # ----------------------------------------------------------- computation
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    # ----------------------------------------------------------------- setup
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()
