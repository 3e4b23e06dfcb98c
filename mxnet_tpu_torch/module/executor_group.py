"""DataParallelExecutorGroup (counterpart:
mxnet_tpu/module/executor_group.py).

The group binds one ``Executor`` a context with ``simple_bind`` and a
grad_req per argument.  Each batch is split along axis 0 by the workload
(``_split_input_slice``), each slice copied into its executor's bound
input arrays (one copy to that executor's device), and each executor runs
forward and backward on its own device; the gradients stay per device for
the kvstore or the ``Updater`` to sum.  Outputs, input gradients and
states merge by ``nd.concatenate`` on the first context.  A group bound
with ``shared_group`` (a bucket of a ``BucketingModule``) takes that
group's parameter, gradient and aux arrays as they are, executor by
executor, so every bucket trains one set of tensors.  The same context may
be listed twice: each executor still has arrays of its own.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from .. import telemetry as _tel
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup", "_split_input_slice"]


def _descs(shapes):
    """``[(name, shape)]`` or DataDescs as DataDescs; None when empty."""
    if not shapes:
        return None
    return [d if isinstance(d, DataDesc) else DataDesc(*d) for d in shapes]


def _split_input_slice(batch_size, work_load_list):
    """The rows of each device, by workload (parity: the JAX package's
    ``_split_input_slice``): each device but the last takes
    round(batch * its share), the last the rest."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise ValueError("batch size must be larger than the device count")
    slices = []
    start = 0
    for i, wl in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * wl / total))
        slices.append(slice(start, end))
        start = end
    return slices


def _merge(blocks):
    """One array from the per-device blocks, on the first one's context."""
    return blocks[0] if len(blocks) == 1 else nd.concatenate(blocks, axis=0)


class DataParallelExecutorGroup(object):
    """The bound executors of a Module, one a context (parity:
    DataParallelExecutorGroup)."""

    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload if workload else [1] * len(contexts)
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
        self.bind_exec(data_shapes, label_shapes, shared_group)

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

    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        """Bind one executor a context for its slice of these input shapes;
        a rebind (``reshape``) shares every array whose shape is unchanged,
        the parameters among them, and so does a first bind with
        ``shared_group`` with that group's executors (parity:
        executor_group.bind_exec)."""
        self.data_shapes = _descs(data_shapes)
        self.label_shapes = _descs(label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes or []]
        self.batch_size = self.data_shapes[0].shape[0]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        old = self.execs
        execs = []
        for i, ctx in enumerate(self.contexts):
            sl = self.slices[i]
            shapes = {d.name: (sl.stop - sl.start,) + tuple(d.shape[1:])
                      for d in self.data_shapes + (self.label_shapes or [])}
            if old:
                ex = old[i].reshape(**shapes)
            else:
                ex = self.symbol.simple_bind(
                    ctx=ctx, grad_req=self._grad_req_dict(),
                    shared_exec=shared_group.execs[i]
                    if shared_group is not None else None, **shapes)
            execs.append(ex)
        self.execs = execs
        # per-parameter lists of per-device arrays (parity: param_arrays)
        names = [n for n in self.param_names if n in execs[0].arg_dict]
        self.param_arrays = [[ex.arg_dict[n] for ex in execs] for n in names]
        self.grad_arrays = [[ex.grad_dict.get(n) for ex in execs]
                            for n in names]
        self.aux_arrays = [[ex.aux_dict[n] for ex in execs]
                           for n in self.aux_names]

    def reshape(self, data_shapes, label_shapes):
        """Rebind for new input shapes, sharing the parameters."""
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes)

    def set_params(self, arg_params, aux_params):
        """Copy the parameters into every executor's arrays (never
        aliases)."""
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copies of the first device's parameters into the given dicts
        (parity: the JAX package's get_params: the devices hold the same
        values)."""
        ex = self.execs[0]
        for name in self.param_names:
            if name in ex.arg_dict:
                arg_params[name] = ex.arg_dict[name].copy()
        for name in self.aux_names:
            aux_params[name] = ex.aux_dict[name].copy()

    def _load_batch(self, data, label):
        """Each executor's slice of each input into its bound array: one
        copy to its device (parity: _load_data/_load_label)."""
        whole = len(self.execs) == 1
        for ex, sl in zip(self.execs, self.slices):
            for name, arr in zip(self.data_names, data):
                ex.arg_dict[name]._set_value(
                    arr.value if whole else arr.value[sl])
            for name, arr in zip(self.label_names, label or []):
                if name in ex.arg_dict:
                    ex.arg_dict[name]._set_value(
                        arr.value if whole else arr.value[sl])

    def forward(self, data_batch, is_train=None):
        """Copy each executor's slices in, then run every executor's
        forward; while telemetry records, the copies are the span
        ``exec_group.load_data`` (parity: executor_group.forward)."""
        if is_train is None:
            is_train = self.for_training
        label = data_batch.label if self.label_shapes else None
        if _tel._enabled:
            with _tel.span("exec_group.load_data", cat="io"):
                self._load_batch(data_batch.data, label)
        else:
            self._load_batch(data_batch.data, label)
        for ex in self.execs:
            ex.forward(is_train=is_train)

    def backward(self, out_grads=None):
        """Each executor's backward, with its slice of ``out_grads``."""
        assert self.for_training, "re-bind with for_training=True to backward"
        for ex, sl in zip(self.execs, self.slices):
            og = None
            if out_grads is not None:
                og = [g if len(self.execs) == 1 else g[sl.start:sl.stop]
                      for g in out_grads]
            ex.backward(og)

    def get_outputs(self, merge_multi_context=True):
        """Each output, merged over the devices on the first context, or
        as a list per device."""
        outs = [[ex.outputs[i] for ex in self.execs]
                for i in range(len(self.execs[0].outputs))]
        return [_merge(o) for o in outs] if merge_multi_context else outs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [[ex.grad_dict[n] for ex in self.execs]
                 for n in self.data_names]
        return [_merge(g) for g in grads] if merge_multi_context else grads

    def get_states(self, merge_multi_context=True):
        states = [[ex.arg_dict[n] for ex in self.execs]
                  for n in self.state_names]
        return [_merge(s) for s in states] if merge_multi_context \
            else states

    def set_states(self, states=None, value=None):
        """The recurrent-state inputs from arrays (a list a device, or one
        merged array sliced across the executors) or a scalar fill."""
        if states is not None:
            assert value is None
            for name, blocks in zip(self.state_names, states):
                if not isinstance(blocks, (list, tuple)):
                    blocks = [blocks]
                if len(blocks) == 1 and len(self.execs) > 1:
                    merged = blocks[0]
                    for ex, sl in zip(self.execs, self.slices):
                        ex.arg_dict[name][:] = merged[sl.start:sl.stop]
                else:
                    for ex, block in zip(self.execs, blocks):
                        ex.arg_dict[name][:] = block
        else:
            assert value is not None
            for name in self.state_names:
                for ex in self.execs:
                    ex.arg_dict[name][:] = value

    def install_monitor(self, mon):
        """Hook ``mon`` into every executor (parity:
        executor_group.install_monitor)."""
        for ex in self.execs:
            mon.install(ex)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
