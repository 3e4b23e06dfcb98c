"""Inference-only predictor (counterpart: mxnet_tpu/predictor.py).

Load a symbol (JSON or Symbol) and parameters, bind a forward-only executor
on the card, feed inputs, read outputs.  The default device is ``gpu(0)``;
without a CUDA device construction raises unless ``dev_type="cpu"`` is asked
for.  (The JAX package's Predictor defaults to the CPU.)
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import Context
from . import ndarray as nd
from . import symbol as sym_mod
from . import telemetry as _tel

__all__ = ["Predictor", "read_checkpoint"]


def read_checkpoint(prefix, epoch):
    """``(symbol_json, params_blob)`` of a ``save_checkpoint`` pair
    (``prefix-symbol.json`` + ``prefix-%04d.params``)."""
    with open("%s-symbol.json" % prefix) as f:
        sym_json = f.read()
    with open("%s-%04d.params" % (prefix, epoch), "rb") as f:
        blob = f.read()
    return sym_json, blob


def _load_params(param_blob):
    """A dict, a ``.params`` path, or the raw bytes of one ->
    (arg_params, aux_params) split on the ``arg:``/``aux:`` prefixes."""
    if isinstance(param_blob, dict):
        raw = param_blob
    else:
        if not isinstance(param_blob, (bytes, bytearray)):
            with open(param_blob, "rb") as f:
                param_blob = f.read()
        raw = nd.deserialize_arrays(bytes(param_blob))
    if any(k == "" for k in raw):
        raise MXNetError(
            "Predictor params must be name-keyed ('arg:name'/'aux:name', "
            "as written by save_checkpoint); got a positional array list")
    arg_params, aux_params = {}, {}
    for k, v in raw.items():
        if k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k[4:] if k.startswith("arg:") else k] = v
    return arg_params, aux_params


def _on_ctx(value, ctx, share=False):
    """An NDArray on ``ctx`` from an NDArray, tensor or numpy array; with
    ``share`` an NDArray already there is used as it is."""
    if isinstance(value, nd.NDArray):
        if share and value.context == ctx:
            return value
        return value.copyto(ctx)
    if isinstance(value, torch.Tensor):
        return nd.NDArray(value.to(ctx.torch_device(), copy=True), ctx=ctx)
    value = _np.asarray(value)
    return nd.array(value, ctx=ctx, dtype=value.dtype)


class Predictor(object):
    """Forward-only bound model (parity: mxnet_tpu.predictor.Predictor).

    symbol : Symbol or JSON string (the ``-symbol.json`` content)
    param_blob : dict of params, a ``.params`` path, or raw bytes of one
    input_shapes : {name: shape} for all data inputs
    dev_type / dev_id : placement; default ``gpu`` 0, i.e. ``cuda:0``
    input_types : optional {name: dtype} for inputs that are not float32
    copy_params : default True (each binding owns a copy of the weights);
        False binds NDArrays already on the target device as they are —
        safe because a forward-only executor never writes its weights, and
        what lets the serving ladder share one weight set.
    """

    def __init__(self, symbol, param_blob, input_shapes, dev_type="gpu",
                 dev_id=0, output_names=None, input_types=None,
                 copy_params=True):
        ctx = Context(dev_type, dev_id)
        ctx.torch_device()          # raises here when the device is missing
        if isinstance(symbol, (str, bytes)):
            symbol = sym_mod.load_json(
                symbol.decode() if isinstance(symbol, bytes) else symbol)
        if output_names:
            # feature extraction: outputs become the named internal outputs
            internals = symbol.get_internals()
            names = internals.list_outputs()
            picked = []
            for key in output_names:
                if key in names:
                    picked.append(names.index(key))
                elif key + "_output" in names:
                    picked.append(names.index(key + "_output"))
                else:
                    raise MXNetError("output %r not found in graph (%d "
                                     "internal outputs)" % (key, len(names)))
            symbol = sym_mod.Symbol([internals._outputs[i] for i in picked])
        self.symbol = symbol
        arg_params, aux_params = _load_params(param_blob)
        input_shapes = {k: tuple(int(x) for x in v)
                        for k, v in input_shapes.items()}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError("Predictor: cannot infer shapes from %r"
                             % (input_shapes,))
        self._input_names = list(input_shapes)
        input_types = {k: _np.dtype(v)
                       for k, v in (input_types or {}).items()}
        unknown_types = set(input_types) - set(input_shapes)
        if unknown_types:
            raise MXNetError("input_types names non-inputs %s"
                             % sorted(unknown_types))
        share = not copy_params
        # args missing from the params (the loss head's label) bind as zeros
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in arg_params and name not in input_shapes:
                args[name] = _on_ctx(arg_params[name], ctx, share)
            else:
                args[name] = nd.zeros(shape, ctx=ctx,
                                      dtype=input_types.get(name,
                                                            _np.float32))
        auxs = {}
        for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
            auxs[name] = _on_ctx(aux_params[name], ctx, share) \
                if name in aux_params else nd.zeros(shape, ctx=ctx)
        self._executor = symbol.bind(ctx, args, aux_states=auxs)
        self._outputs = None

    def set_input(self, name, value):
        """Stage one input at the bound argument's dtype."""
        if name not in self._input_names:
            raise MXNetError("unknown input %s (have %s)"
                             % (name, self._input_names))
        arr = self._executor.arg_dict[name]
        if _tel._enabled:
            # the host-to-card staging copy, timed (parity: the JAX
            # package's predict.set_input span)
            with _tel.span("predict.set_input", cat="serve", input=name):
                arr[:] = _np.asarray(value, dtype=arr.dtype)
        else:
            arr[:] = _np.asarray(value, dtype=arr.dtype)

    def forward(self, **inputs):
        """Run the forward; keyword arguments stage inputs first, each at
        its bound dtype, as ``set_input`` does.  While telemetry records,
        each call is a ``predict.forward`` span (the executor waits for
        the card then, so the span is the serving latency) and counts
        ``predict_requests`` and ``predict_samples``."""
        staged = {}
        for name, value in inputs.items():
            if name not in self._input_names:
                raise MXNetError("unknown input %s (have %s)"
                                 % (name, self._input_names))
            staged[name] = _np.asarray(
                value, dtype=self._executor.arg_dict[name].dtype)
        if not _tel._enabled:
            self._outputs = self._executor.forward(is_train=False, **staged)
            return
        with _tel.span("predict.forward", cat="serve"):
            self._outputs = self._executor.forward(is_train=False, **staged)
        _tel.counter("predict_requests")
        if self._input_names:
            _tel.counter("predict_samples", int(
                self._executor.arg_dict[self._input_names[0]].shape[0]))

    def partial_forward(self, step):
        """The stepwise-forward protocol (parity: the JAX package's
        ``partial_forward``, MXPredPartialForward): the first call runs the
        whole forward, and each call returns ``step_left``, the number of
        non-variable nodes on the outputs' path less ``step`` (at least
        0), so a ``while (step_left > 0) partial_forward(++step)`` loop
        ends with the outputs ready."""
        n_steps = max(1, sum(
            1 for n in sym_mod._topo([node for node, _ in
                                      self.symbol._outputs])
            if not n.is_var))
        if self._outputs is None:
            self.forward()
        return max(0, n_steps - int(step))

    def get_output_shape(self, index=0):
        outs = self._outputs or self._executor.outputs
        return tuple(outs[index].shape)

    def get_output(self, index=0):
        """Blocking copy of one output to host numpy."""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs[index].asnumpy()

    @property
    def num_outputs(self):
        return len(self._executor.outputs)

    @staticmethod
    def from_checkpoint(prefix, epoch, input_shapes, dev_type="gpu",
                        dev_id=0, output_names=None, input_types=None):
        """Load ``prefix-symbol.json`` + ``prefix-%04d.params``."""
        sym_json, blob = read_checkpoint(prefix, epoch)
        return Predictor(sym_json, blob, input_shapes, dev_type, dev_id,
                         output_names=output_names, input_types=input_types)
