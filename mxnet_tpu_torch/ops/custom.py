"""The ``Custom`` operator (counterpart: mxnet_tpu/ops/custom.py): runs a
user-registered Python :class:`~mxnet_tpu_torch.operator.CustomOp`
imperatively (``mx.nd.Custom``) and inside Symbol graphs, executors,
``TrainStep`` and ``Module.fit``.

The JAX package embeds the user's code as host callbacks
(``jax.pure_callback``) with a ``jax.custom_vjp``; here a
``torch.autograd.Function`` (``_CustomFunction``) takes their place.  Its
forward calls the user's ``forward`` (``req`` all 'write', no aux) on
NDArrays that wrap the walk's own tensors, on their device and without a
copy (a non-contiguous view, such as a channel-first view of a
channel-last activation, is made contiguous first), and into fresh zeroed
outputs; its backward calls the user's
``backward`` with the output gradients and the saved inputs and outputs.
So the op leaves the card only where the user's code calls ``asnumpy()``.
The user's code runs with the op's context as the default context
(``with ctx:``), so an ``mx.nd.array(...)`` it makes lands beside the op's
tensors, and ``create_operator`` gets that context.

Props are cached one a set of attrs and instances one a set of (attrs,
input shapes, input dtypes), so forward and backward share ``self`` (the
JAX package's cache: two same-shaped executors whose forwards interleave
before their backwards share an instance too).

The op declares no layout rule: under the executor's NHWC pass it is handed
channel-first tensors, as the user's code expects.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from .registry import register, attr_key

_PROP_CACHE = {}
_OP_CACHE = {}


def _split_attrs(attrs):
    """(op_type, the user's kwargs as strings, as the reference passes them
    through its C API)."""
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("Custom op requires op_type=")
    user = {k: str(v) for k, v in attrs.items() if k != "op_type"}
    return op_type, user


def _get_prop(attrs):
    key = attr_key(attrs)
    prop = _PROP_CACHE.get(key)
    if prop is None:
        from .. import operator as _operator
        op_type, user = _split_attrs(attrs)
        prop = _operator.get_prop_cls(op_type)(**user)
        _PROP_CACHE[key] = prop
    return prop


def _get_instance(attrs, in_shapes, in_dtypes, ctx):
    """The instance of (attrs, shapes, dtypes), made by the prop's
    ``create_operator`` under ``ctx`` at the first call."""
    key = (attr_key(attrs), tuple(in_shapes),
           tuple(str(d) for d in in_dtypes))
    inst = _OP_CACHE.get(key)
    if inst is None:
        prop = _get_prop(attrs)
        with ctx:
            inst = prop.create_operator(ctx, list(in_shapes),
                                        list(in_dtypes))
        _OP_CACHE[key] = inst
    return inst


def _custom_arg_names(attrs):
    return list(_get_prop(attrs).list_arguments())


def _custom_num_outputs(attrs):
    return len(_get_prop(attrs).list_outputs())


def _custom_infer_shape(attrs, in_shapes):
    prop = _get_prop(attrs)
    if any(s is None for s in in_shapes):
        return in_shapes, [None] * _custom_num_outputs(attrs), None
    res = prop.infer_shape([list(s) for s in in_shapes])
    ins, outs = res[0], res[1]
    aux = res[2] if len(res) > 2 else []
    return ([tuple(s) for s in ins], [tuple(s) for s in outs],
            [tuple(s) for s in aux] or None)


def _custom_infer_type(attrs, in_dtypes):
    prop = _get_prop(attrs)
    known = [d for d in in_dtypes if d is not None]
    base = known[0] if known else _np.float32
    res = prop.infer_type([d if d is not None else base for d in in_dtypes])
    return list(res[0]), list(res[1]), list(res[2]) if len(res) > 2 else []


def _context_of(t):
    from ..context import Context
    return Context("gpu", t.device.index or 0) if t.is_cuda \
        else Context("cpu", 0)


class _Call(object):
    """One application of a custom op: the instance, its context, the
    output shapes and dtypes, and the ``is_train`` flag."""

    def __init__(self, attrs, inputs, is_train):
        in_shapes = [tuple(x.shape) for x in inputs]
        in_dtypes = [numpy_dtype(x.dtype) for x in inputs]
        _, self.out_shapes, _ = _custom_infer_shape(attrs, in_shapes)
        _, out_dtypes, _ = _custom_infer_type(attrs, in_dtypes)
        self.out_dtypes = [torch_dtype(d) for d in out_dtypes]
        self.device = inputs[0].device
        self.ctx = _context_of(inputs[0])
        self.op = _get_instance(attrs, in_shapes, in_dtypes, self.ctx)
        self.is_train = is_train

    def forward(self, inputs):
        from ..ndarray import NDArray
        in_nd = [NDArray(x.detach().contiguous()) for x in inputs]
        out_nd = [NDArray(torch.zeros(s, dtype=d, device=self.device))
                  for s, d in zip(self.out_shapes, self.out_dtypes)]
        with self.ctx:
            self.op.forward(is_train=self.is_train,
                            req=["write"] * len(out_nd), in_data=in_nd,
                            out_data=out_nd, aux=[])
        return tuple(o.value for o in out_nd)

    def backward(self, inputs, outputs, grads):
        from ..ndarray import NDArray
        in_grad = [NDArray(torch.zeros_like(x)) for x in inputs]
        with self.ctx:
            self.op.backward(req=["write"] * len(inputs),
                             out_grad=[NDArray(g.detach()) for g in grads],
                             in_data=[NDArray(x.detach().contiguous())
                                      for x in inputs],
                             out_data=[NDArray(y.detach()) for y in outputs],
                             in_grad=in_grad, aux=[])
        return [g.value for g in in_grad]


class _CustomFunction(torch.autograd.Function):
    """The user's forward and backward as one autograd node."""

    @staticmethod
    def forward(ctx, call, *inputs):
        outs = call.forward(inputs)
        ctx.call = call
        ctx.n_in = len(inputs)
        ctx.save_for_backward(*inputs, *outs)
        integral = [o for o in outs if not o.is_floating_point()]
        if integral:
            ctx.mark_non_differentiable(*integral)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        got = ctx.call.backward(ins, outs, grads)
        return (None,) + tuple(g if need else None for g, need in
                               zip(got, ctx.needs_input_grad[1:]))


@register("Custom", arg_names=_custom_arg_names,
          num_outputs=_custom_num_outputs,
          infer_shape=_custom_infer_shape, infer_type=_custom_infer_type,
          train_aware=True)
def _custom(*inputs, is_train=False, **attrs):
    """A registered CustomOp (``op_type=``) on the inputs."""
    outs = _CustomFunction.apply(_Call(attrs, inputs, is_train), *inputs)
    return outs if len(outs) > 1 else outs[0]
