"""Custom operators written in Python (counterpart: mxnet_tpu/operator.py).

A user subclasses :class:`CustomOpProp` (arity, shapes, types, the instance
factory) and :class:`CustomOp` (forward and backward on NDArrays), registers
the prop with :func:`register`, and uses it as ``mx.sym.Custom(...,
op_type=name)`` or ``mx.nd.Custom(..., op_type=name)``.  The ``Custom`` op
(``ops/custom.py``) runs the user's code as a ``torch.autograd.Function``
on the executor's own tensors.

The legacy PythonOp/NumpyOp/NDArrayOp generations stay dropped, as in the
JAX package: CustomOp is their successor.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError, Registry

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls"]

_CUSTOM = Registry("custom_op")


class CustomOp(object):
    """Base class of a custom operator instance (parity: CustomOp).
    Subclasses implement forward/backward over lists of NDArrays and write
    their results through :meth:`assign`, which honours the request."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` asks: 'write' and
        'inplace' overwrite, 'add' accumulates, 'null' (or None) leaves
        ``dst``.  ``src`` may be an NDArray on another context, a tensor, a
        numpy array or a scalar, as ``dst[:] = src`` takes them."""
        if req in ("null", None):
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + _beside(dst, src)
        else:
            raise MXNetError("unknown req %s" % req)


def _beside(dst, src):
    """``src`` as an operand of ``dst``'s arithmetic: a scalar as it is,
    anything else an NDArray on ``dst``'s context."""
    from .ndarray import NDArray, array
    if isinstance(src, (int, float, _np.number)):
        return src
    if not isinstance(src, NDArray):
        return array(src, ctx=dst.context, dtype=dst.dtype)
    return src.as_in_context(dst.context)


class CustomOpProp(object):
    """Operator properties: arity, shapes, types, instance factory (parity:
    CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under ``reg_name``
    (parity: mx.operator.register), usable afterwards as
    ``mx.sym.Custom(..., op_type=reg_name)``.  Registering a name again
    replaces the class and drops the props and instances built from the
    old one."""

    def deco(prop_cls):
        _CUSTOM.register(reg_name, prop_cls, override=True)
        from .ops import custom as _custom_op
        _custom_op._PROP_CACHE.clear()
        _custom_op._OP_CACHE.clear()
        return prop_cls

    return deco


def get_prop_cls(op_type):
    """The CustomOpProp class registered as ``op_type``."""
    cls = _CUSTOM.find(op_type)
    if cls is None:
        raise MXNetError("custom op type %r not registered "
                         "(use mx.operator.register)" % op_type)
    return cls
