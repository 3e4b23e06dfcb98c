"""BaseModule: the training API (counterpart:
mxnet_tpu/module/base_module.py): ``fit``, ``score``, ``predict`` and
``iter_predict`` over the intermediate API (``forward`` / ``backward`` /
``update``) that a Module implements.

``fit`` trains through ``Module._start_fused_fit``'s fused ``TrainStep``
when it engages (one step a batch, batches staged on the card by a producer
thread) and through forward, backward and the ``Updater`` otherwise.  The
JAX package's telemetry spans, sentinel, diagnostics snapshots and MFU
gauges are not ported: they arrive with the observability slice, and
``fit`` raises ``MXNetError`` when one of their knobs is set rather than
ignore it.
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError, get_env
from ..context import cpu
from .. import amp as _amp
from .. import metric as metric_mod
from .. import ndarray as nd
from ..model import BatchEndParam, _split_params

__all__ = ["BaseModule"]

# the JAX package's fit reads these knobs; they turn on work of the
# observability slice (telemetry, the numerics sentinel, the watchdog and
# crash snapshots, the numerics monitor).  "" and "0" leave them off.
OBSERVABILITY_KNOBS = ("MXNET_TELEMETRY", "MXNET_TELEMETRY_FUSED",
                       "MXNET_CHECK_NUMERICS", "MXNET_SENTINEL",
                       "MXNET_WATCHDOG_SEC", "MXNET_DIAG_DIR",
                       "MXNET_MONITOR")
# the fused fit's pipeline and ZeRO levers (the distributed slice), with
# the values that leave them off: one pipeline stage, ZeRO level 0
PARALLEL_KNOBS = (("MXNET_PP", ("", "0", "1")), ("MXNET_ZERO", ("", "0")))


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


def _refuse_unported(monitor):
    """Raise for every fit argument and knob whose work is not ported."""
    if monitor is not None:
        raise MXNetError("fit(monitor=...) is not ported yet: the Monitor "
                         "arrives with the observability slice")
    for knob in OBSERVABILITY_KNOBS:
        if get_env(knob, "") not in ("", "0"):
            raise MXNetError("%s=%r is not ported yet: it arrives with the "
                             "observability slice; unset it"
                             % (knob, get_env(knob)))
    for knob, off in PARALLEL_KNOBS:
        if get_env(knob, "") not in off:
            raise MXNetError("%s=%r is not ported yet: it arrives with the "
                             "distributed slice; unset it"
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
        on the fused path.  ``monitor`` and the observability and parallel
        knobs raise ``MXNetError``: not ported yet."""
        assert num_epoch is not None, "please specify number of epochs"
        _refuse_unported(monitor)
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
                       lambda policy=None: None)(policy=policy)
        if fast is None and _amp.resolve_policy(policy) is not None:
            # never train float32 silently while the caller asked for AMP
            self.logger.warning("fit: mixed-precision policy (MXNET_AMP/"
                                "policy=) ignored: the general path trains "
                                "float32")

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            data_iter = iter(train_data)
            if fast is not None:
                # batch N+1 is staged on the card while step N runs
                data_iter = fast.prefetch(data_iter)
            try:
                for nbatch, data_batch in enumerate(data_iter):
                    if fast is not None:
                        outputs, dev_labels = fast.step(data_batch)
                        eval_metric.update(dev_labels or data_batch.label,
                                           outputs)
                    else:
                        self.forward_backward(data_batch)
                        self.update()
                        self.update_metric(eval_metric, data_batch.label)
                    if batch_end_callback is not None:
                        param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric,
                                              locals=locals())
                        for callback in _as_list(batch_end_callback):
                            callback(param)
            finally:
                # an exception mid-epoch must not leave the prefetch
                # producer blocked in queue.put holding staged batches
                drain = getattr(data_iter, "drain", None)
                if drain is not None:
                    drain()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
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
        raise MXNetError("install_monitor is not ported yet: the Monitor "
                         "arrives with the observability slice")

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
