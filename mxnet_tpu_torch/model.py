"""Model-level helpers shared by Module and FeedForward (counterpart:
mxnet_tpu/model.py): the kvstore decision, the parameter update loops, the
checkpoint format and the legacy ``FeedForward``.

With several devices or a ``KVStore``, gradients are summed across the
devices by the store (``local`` or ``device``) or in process, and each
device's parameters are updated, on the store or by the ``Updater`` with a
state per device.  A ``dist*`` store also sums them across the processes
of the world (``parallel.dist``), and the update then always runs on the
store.  Checkpoints are ``prefix-symbol.json`` and ``prefix-%04d.params``
in the JAX package's byte format, so a checkpoint saved by either package
loads in the other.
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from .base import MXNetError, string_types
from .context import cpu
from . import io
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym_mod
from . import telemetry as _tel

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

# a "local" store above this many elements in one parameter leaves the
# update to each device (parity: the reference's model.py:58-62)
UPDATE_ON_KVSTORE_MAX = 1024 * 1024 * 16


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) (parity: model._create_kvstore): one
    device and a store name that is not ``dist*`` need no store; a
    ``local`` store leaves the update to the devices when one parameter has
    more than ``UPDATE_ON_KVSTORE_MAX`` elements (read from the shapes);
    without a store there is no update on it."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, string_types):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(param.shape))
                               for param in arg_params.values())
                if max_size > UPDATE_ON_KVSTORE_MAX:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, string or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Each parameter into the store under its index; with the update on
    the store every device pulls it (parity: model._initialize_kvstore)."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push every gradient, pull every updated parameter (parity:
    model._update_params_on_kvstore); while telemetry records, the count
    of updated parameters is the counter ``param_updates``."""
    updated = 0
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        kvstore.push(index, grad_list, priority=-index)
        kvstore.pull(index, arg_list, priority=-index)
        updated += 1
    if _tel._enabled:
        _tel.counter("param_updates", updated, on_kvstore=True)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Sum each gradient across the devices, through the store (push, then
    pull the sum back into every gradient) or in process, then update each
    device's copy with ``updater`` under index ``index * num_device + k``,
    so that each device keeps its own optimizer state (parity:
    model._update_params)."""
    updated = 0
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, grad_list, priority=-index)
        elif num_device > 1:
            merged = grad_list[0].copy()
            for g in grad_list[1:]:
                merged += g.copyto(merged.context)
            for g in grad_list:
                g._set_value(merged.value)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)
        updated += 1
    if _tel._enabled:
        _tel.counter("param_updates", updated, on_kvstore=False)


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
