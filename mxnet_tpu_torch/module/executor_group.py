"""DataParallelExecutorGroup on one device (counterpart:
mxnet_tpu/module/executor_group.py).

The group binds one ``Executor`` on its context with ``simple_bind`` and a
grad_req per argument, loads each batch into the bound input arrays (one
copy per input to the bound device) and runs forward and backward there.
Data parallelism over several contexts arrives with the parallel slice, and
executors shared between bucketed modules with the sequences slice.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _descs(shapes):
    """``[(name, shape)]`` or DataDescs as DataDescs; None when empty."""
    if not shapes:
        return None
    return [d if isinstance(d, DataDesc) else DataDesc(*d) for d in shapes]


class DataParallelExecutorGroup(object):
    """The bound executor of a Module (parity: DataParallelExecutorGroup
    with one context)."""

    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        if len(contexts) != 1:
            raise MXNetError("an executor group over %d contexts is not "
                             "ported yet: data parallelism arrives with the "
                             "parallel slice" % len(contexts))
        if shared_group is not None:
            raise MXNetError("an executor group shared with another is not "
                             "ported yet: it arrives with the sequences "
                             "slice (bucketing)")
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = list(state_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self._default_grad_req = grad_req
        self.execs = []
        self.bind_exec(data_shapes, label_shapes)

    def _grad_req_dict(self):
        req = {}
        for name in self.arg_names:
            if not self.for_training or name in self.fixed_param_names:
                req[name] = "null"
            elif name in self.param_names:
                req[name] = self._default_grad_req
            elif name in self.data_names and self.inputs_need_grad:
                req[name] = self._default_grad_req
            else:
                req[name] = "null"
        return req

    def bind_exec(self, data_shapes, label_shapes):
        """Bind the executor for these input shapes; a rebind (``reshape``)
        shares every array whose shape is unchanged, the parameters among
        them (parity: executor_group.bind_exec)."""
        self.data_shapes = _descs(data_shapes)
        self.label_shapes = _descs(label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes or []]
        self.batch_size = self.data_shapes[0].shape[0]
        shapes = {d.name: tuple(d.shape)
                  for d in self.data_shapes + (self.label_shapes or [])}
        if self.execs:
            ex = self.execs[0].reshape(**shapes)
        else:
            ex = self.symbol.simple_bind(ctx=self.contexts[0],
                                         grad_req=self._grad_req_dict(),
                                         **shapes)
        self.execs = [ex]
        # per-parameter lists of per-device arrays (parity: param_arrays)
        names = [n for n in self.param_names if n in ex.arg_dict]
        self.param_arrays = [[ex.arg_dict[n]] for n in names]
        self.grad_arrays = [[ex.grad_dict.get(n)] for n in names]
        self.aux_arrays = [[ex.aux_dict[n]] for n in self.aux_names]

    def reshape(self, data_shapes, label_shapes):
        """Rebind for new input shapes, sharing the parameters."""
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes)

    def set_params(self, arg_params, aux_params):
        """Copy the parameters into the bound arrays (never aliases)."""
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copies of the bound parameters into the given dicts."""
        ex = self.execs[0]
        for name in self.param_names:
            if name in ex.arg_dict:
                arg_params[name] = ex.arg_dict[name].copy()
        for name in self.aux_names:
            aux_params[name] = ex.aux_dict[name].copy()

    def _load_batch(self, data, label):
        """Each input of the batch into its bound array: one copy to the
        bound device (parity: _load_data/_load_label)."""
        ex = self.execs[0]
        for name, arr in zip(self.data_names, data):
            ex.arg_dict[name]._set_value(arr.value)
        for name, arr in zip(self.label_names, label or []):
            if name in ex.arg_dict:
                ex.arg_dict[name]._set_value(arr.value)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load_batch(data_batch.data,
                         data_batch.label if self.label_shapes else None)
        self.execs[0].forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.for_training, "re-bind with for_training=True to backward"
        self.execs[0].backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [self.execs[0].grad_dict[n] for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    def get_states(self, merge_multi_context=True):
        states = [self.execs[0].arg_dict[n] for n in self.state_names]
        return states if merge_multi_context else [[s] for s in states]

    def set_states(self, states=None, value=None):
        """The recurrent-state inputs from arrays (one per state, or a list
        of one per device) or a scalar fill."""
        ex = self.execs[0]
        if states is not None:
            assert value is None
            for name, blocks in zip(self.state_names, states):
                if isinstance(blocks, (list, tuple)):
                    blocks = blocks[0]
                ex.arg_dict[name][:] = blocks
        else:
            assert value is not None
            for name in self.state_names:
                ex.arg_dict[name][:] = value

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
