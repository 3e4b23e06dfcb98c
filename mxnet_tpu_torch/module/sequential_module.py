"""SequentialModule: a chain of modules trained as one (counterpart:
mxnet_tpu/module/sequential_module.py).

Stage i+1's data is stage i's outputs.  Every stage steps its own
executor and optimizer; the backward hands each stage's input gradients
(``get_input_grads``) to the stage before it as its output gradients.
Outputs and gradients stay NDArrays on the stages' device: nothing
crosses to the host between stages.  A chain is a ``BaseModule``, so its
``fit`` takes the general path (forward, backward, update a batch).
"""
from __future__ import annotations

import logging

from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class _Stage(object):
    """One link of the chain and its wiring options."""

    __slots__ = ("module", "takes_labels", "rewire")

    def __init__(self, module, takes_labels, rewire):
        self.module = module
        self.takes_labels = takes_labels
        self.rewire = rewire


class SequentialModule(BaseModule):
    """Chain modules (parity: mxnet_tpu.module.SequentialModule).

    ``add(module, take_labels=..., auto_wiring=...)`` appends a stage:
    ``take_labels`` feeds it the labels (typically the last stage only);
    ``auto_wiring`` renames the incoming shapes to the stage's own
    ``data_names``."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"
    _STAGE_OPTIONS = frozenset((META_TAKE_LABELS, META_AUTO_WIRING))

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []
        self._bound_label_shapes = None

    def add(self, module, **options):
        """Append a stage; unknown option names raise TypeError."""
        bad = set(options) - self._STAGE_OPTIONS
        if bad:
            raise TypeError(
                "SequentialModule.add: unsupported option(s) %s; valid "
                "options are %s" % (sorted(bad), sorted(self._STAGE_OPTIONS)))
        self._stages.append(_Stage(
            module,
            takes_labels=bool(options.get(self.META_TAKE_LABELS, False)),
            rewire=bool(options.get(self.META_AUTO_WIRING, False))))
        # the chain changed: whatever was derived from it is stale
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ------------------------------------------------------------ properties
    @property
    def _modules(self):
        return [s.module for s in self._stages]

    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._bound_label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._stages[-1].module.output_shapes

    # ------------------------------------------------------------ parameters
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for stage in self._stages:
            a, x = stage.module.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "bind the chain before init_params"
        for stage in self._stages:
            stage.module.init_params(
                initializer=initializer, arg_params=arg_params,
                aux_params=aux_params, allow_missing=allow_missing,
                force_init=force_init)
        self._reject_shadowed_params()
        self.params_initialized = True

    def _reject_shadowed_params(self):
        """A name in two stages would train two copies under one name."""
        owner = {}
        for i, stage in enumerate(self._stages):
            for group in stage.module.get_params():
                for name in group:
                    if name in owner:
                        raise ValueError(
                            "parameter %r exists in both stage %d and "
                            "stage %d of the chain; give the layers "
                            "distinct name prefixes" % (name, owner[name], i))
                    owner[name] = i

    # ------------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind every stage, each on the output shapes of the one before
        (parity: SequentialModule.bind)."""
        if self.binded and not force_rebind:
            self.logger.warning("SequentialModule: already bound; pass "
                                "force_rebind=True to rebind")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, \
            "SequentialModule does not support shared_module"
        assert self._stages, "cannot bind a chain with no stages"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        incoming = data_shapes
        labels_used = False
        for i, stage in enumerate(self._stages):
            if stage.rewire:
                names = stage.module.data_names
                assert len(names) == len(incoming), (
                    "auto_wiring: stage %d expects %d inputs, got %d"
                    % (i, len(names), len(incoming)))
                incoming = [(name, shape) for name, (_, shape)
                            in zip(names, incoming)]
            stage.module.bind(
                data_shapes=incoming,
                label_shapes=label_shapes if stage.takes_labels else None,
                for_training=for_training,
                # an interior stage hands its input gradients back; the
                # first follows the caller
                inputs_need_grad=bool(for_training
                                      and (inputs_need_grad or i > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            labels_used = labels_used or stage.takes_labels
            incoming = stage.module.output_shapes
        self._bound_label_shapes = label_shapes if labels_used else None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("SequentialModule: optimizer already "
                                "initialized; ignoring")
            return
        for stage in self._stages:
            stage.module.init_optimizer(
                kvstore=kvstore, optimizer=optimizer,
                optimizer_params=optimizer_params, force_init=force_init)
        self.optimizer_initialized = True

    # -------------------------------------------------------------- stepping
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        # a copy: threading the outputs through must not edit the
        # caller's batch
        flowing = DataBatch(data=data_batch.data, label=data_batch.label,
                            pad=data_batch.pad, index=data_batch.index,
                            provide_data=data_batch.provide_data,
                            provide_label=data_batch.provide_label)
        last = len(self._stages) - 1
        for i, stage in enumerate(self._stages):
            stage.module.forward(flowing, is_train=is_train)
            if i == last:
                break
            outs = stage.module.get_outputs()
            flowing.data = outs
            flowing.provide_data = [
                (name, out.shape)
                for name, out in zip(stage.module.output_names, outs)]

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i in range(len(self._stages) - 1, -1, -1):
            stage = self._stages[i]
            stage.module.backward(out_grads=out_grads)
            if i:
                out_grads = stage.module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for stage in self._stages:
            stage.module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._stages[-1].module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._stages[0].module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for stage in self._stages:
            if stage.takes_labels:
                stage.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for stage in self._stages:
            stage.module.install_monitor(mon)
