"""Model-level helpers shared by Module and FeedForward (counterpart:
mxnet_tpu/model.py): the kvstore decision, the parameter update loop, the
checkpoint format and the legacy ``FeedForward``.

One device only: a kvstore object and the ``dist*`` kvstores arrive with
the parallel slice.  Checkpoints are ``prefix-symbol.json`` and
``prefix-%04d.params`` in the JAX package's byte format, so a checkpoint
saved by either package loads in the other.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from .base import MXNetError, string_types
from .context import cpu
from . import io
from . import ndarray as nd
from . import symbol as sym_mod

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) (parity: model._create_kvstore): for
    one device, ``None``, ``"local"`` and ``"device"`` need no kvstore and
    give ``(None, False)``.  Anything that would make one raises."""
    if kvstore is None:
        return None, False
    if not isinstance(kvstore, string_types):
        raise MXNetError("kvstore=%r: a KVStore object is not ported yet "
                         "(it arrives with the parallel slice); pass None, "
                         "'local' or 'device'" % (kvstore,))
    if "dist" in kvstore or num_device != 1:
        raise MXNetError("kvstore=%r over %d device(s) is not ported yet: it "
                         "arrives with the parallel slice"
                         % (kvstore, num_device))
    return None, False


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Apply ``updater`` to every parameter that has a gradient (parity:
    model._update_params, one device without a kvstore)."""
    if kvstore is not None or num_device != 1:
        raise MXNetError("aggregating gradients over devices is not ported "
                         "yet: it arrives with the parallel slice")
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        updater(index, grad_list[0], arg_list[0])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` and ``prefix-%04d.params`` (parity:
    model.save_checkpoint), each through ``base.atomic_write``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def _split_params(save_dict):
    """``{"arg:name"/"aux:name": array}`` -> (arg_params, aux_params)."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise ValueError("invalid parameter name %r" % k)
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint, the arrays on the
    host (parity: model.load_checkpoint)."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=cpu())
    return (symbol,) + _split_params(save_dict)


class FeedForward(object):
    """Legacy training API over ``Module`` (parity: model.FeedForward).
    ``ctx=None`` trains on ``gpu(0)``, as ``Module`` does."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _get_module(self, data_iter):
        from .module import Module
        labels = [d.name for d in (data_iter.provide_label or [])]
        return Module(self.symbol, context=self.ctx,
                      data_names=[d.name for d in data_iter.provide_data],
                      label_names=labels or None)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        train_data = self._prepare_data(X, y)
        self._module = self._get_module(train_data)
        self._module.fit(train_data, eval_data=eval_data,
                         eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore,
                         optimizer=self.optimizer,
                         optimizer_params=self.kwargs or
                         {"learning_rate": 0.01},
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback,
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params,
                         begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()

    def _prepare_data(self, X, y=None):
        if isinstance(X, io.DataIter):
            return X
        return io.NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                              shuffle=False)

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._prepare_data(X)
        if self._module is None:
            raise MXNetError("model has not been trained")
        outs = self._module.predict(data, num_batch)
        return outs.asnumpy() if not isinstance(outs, list) else \
            [o.asnumpy() for o in outs]

    def score(self, X, eval_metric="acc", num_batch=None):
        data = self._prepare_data(X)
        res = self._module.score(data, eval_metric, num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)
