"""Operator registry (counterpart: mxnet_tpu/ops/registry.py).

An operator is a plain function on tensors plus the metadata the symbol graph
and the ``mx.nd`` frontends need: argument names, attribute parsers and
defaults, and shape and type inference.  Ops without their own shape rule are
inferred by running the function on ``device="meta"`` tensors, which carry
shapes and no data (the JAX package uses ``jax.eval_shape`` for the same
job).

``imperative_invoke`` runs one op eagerly on tensors: PyTorch dispatches each
call as it comes, so the JAX package's per-(op, attrs) jit cache has no
counterpart here.
"""
from __future__ import annotations

import ast

import numpy as _np
import torch

from ..base import MXNetError, Registry, get_env
from .. import engine as _engine
from .. import profiler as _prof

__all__ = ["OpDef", "register", "get_op", "list_ops", "OPS", "parse_tuple",
           "parse_int", "parse_float", "parse_bool", "parse_str",
           "parse_dtype", "shape_unify", "eval_shape_infer",
           "imperative_invoke", "attr_key"]

OPS = Registry("operator")


# ---------------------------------------------------------------- attr parsing
def parse_tuple(v):
    if v is None or isinstance(v, tuple):
        return v
    if isinstance(v, list):
        return tuple(v)
    if isinstance(v, (int, float)):
        return (int(v),)
    out = ast.literal_eval(v.strip())
    if isinstance(out, (int, float)):
        return (int(out),)
    return tuple(int(x) for x in out)


def parse_int(v):
    if v is None:
        return None
    if isinstance(v, str) and v in ("None", ""):
        return None
    return int(v)


def parse_float(v):
    """``None``, ``"None"`` and ``""`` read as None, as in ``parse_int``: the
    JSON writer stores a float attribute left at None (attention's
    ``scale``) as the string ``"None"``."""
    if v is None or (isinstance(v, str) and v in ("None", "")):
        return None
    return float(v)


def parse_bool(v):
    if isinstance(v, str):
        return v not in ("0", "False", "false", "")
    return bool(v)


def parse_str(v):
    return None if v is None else str(v)


def parse_dtype(v):
    """A dtype attribute: names become numpy dtypes (``"bfloat16"`` becomes
    ``torch.bfloat16``, which numpy lacks); dtype objects pass through."""
    if v is None or not isinstance(v, str):
        return v
    return torch.bfloat16 if v == "bfloat16" else _np.dtype(v)


class OpDef(object):
    """One registered operator.

    fn : fn(*inputs, is_train=False, **attrs) -> tensor | tuple.  With
        ``aux_names`` the tuple carries the visible outputs followed by the
        (unchanged, at inference) auxiliary states.
    arg_names : input names, or callable(attrs) -> list
    aux_names : trailing inputs that are auxiliary states (BatchNorm's
        moving statistics)
    infer_shape : optional callable(attrs, in_shapes) -> (in, out, aux);
        the default runs ``fn`` on meta tensors (forward only)
    infer_shape_backward : optional callable(attrs, out_shapes, in_shapes)
        -> in_shapes: the inputs deduced from known outputs (the
        FullyConnected rule resolves a data shape through its weight)
    layout_rule : how the executor's NHWC pass treats the op: None (rigid:
        inputs restored to NCHW), 'aware' (``fn`` takes layout='NHWC' for
        the inputs in ``layout_inputs``) or 'transparent' (shape-agnostic)
    is_loss : a loss head whose backward ignores the incoming gradient
        (the executor seeds such outputs with implicit ones silently)
    infer_type : optional callable(attrs, in_dtypes) -> (in, out, aux)
    needs_rng : ``fn`` takes ``rng=``, a ``torch.Generator`` on the device
        the op runs on
    key_var_num_args : the attr naming the input count of a variadic op
        ('num_args'); the ``mx.nd`` frontend fills it in
    hidden : marks an internal op (metadata: as in the JAX package,
        nothing filters on it)
    env_attrs : {attr: (MXNET_* variable, default string)}: an attr the
        caller leaves unset is read from the environment at dispatch
    input_init_attrs : {input name: ``__init__`` JSON} given to the inputs
        that composition creates as variables (LeakyReLU's prelu gamma
        starts at 0.25)
    """

    def __init__(self, name, fn, arg_names=("data",), aux_names=(),
                 num_outputs=1, attr_types=None, defaults=None,
                 infer_shape=None, infer_type=None,
                 infer_shape_backward=None, train_aware=False,
                 needs_rng=False, key_var_num_args=None, aliases=(),
                 hidden=False, doc=None, layout_rule=None, layout_inputs=(0,),
                 is_loss=False, env_attrs=None, input_init_attrs=None):
        self.name = name
        self.fn = fn
        self._arg_names = arg_names
        self.aux_names = tuple(aux_names)
        self.num_aux = len(self.aux_names)
        self._num_outputs = num_outputs
        self.attr_types = dict(attr_types or {})
        self.defaults = dict(defaults or {})
        self._infer_shape = infer_shape
        self._infer_type = infer_type
        self.infer_shape_backward = infer_shape_backward
        self.train_aware = train_aware
        self.needs_rng = needs_rng
        self.key_var_num_args = key_var_num_args
        self.hidden = hidden
        self.env_attrs = dict(env_attrs or {})
        self.input_init_attrs = dict(input_init_attrs or {})
        self.aliases = tuple(aliases)
        self.doc = doc or (fn.__doc__ if fn is not None else None)
        self.layout_rule = layout_rule
        self.layout_inputs = tuple(layout_inputs)
        self.is_loss = is_loss

    # ------------------------------------------------------------------ meta
    def arg_names_for(self, attrs):
        names = self._arg_names(attrs) if callable(self._arg_names) \
            else self._arg_names
        return list(names)

    def num_outputs_for(self, attrs):
        no = self._num_outputs
        return no(attrs) if callable(no) else no

    def normalize_attrs(self, attrs):
        """Apply defaults and parse string-valued attrs (JSON round-trip)."""
        out = dict(self.defaults)
        for k, v in attrs.items():
            if k in self.attr_types:
                try:
                    out[k] = self.attr_types[k](v)
                except (ValueError, SyntaxError, KeyError, TypeError):
                    out[k] = v
            else:
                out[k] = v
        return out

    def resolve_env_attrs(self, attrs):
        """Fill the env-backed attrs (``env_attrs``) the caller left unset
        from their MXNET_* variables; an attr passed explicitly wins.  An
        on/off lever is on for exactly "1", as everywhere in the repo."""
        if not self.env_attrs:
            return attrs
        out = dict(attrs)
        for a, (env, dflt) in self.env_attrs.items():
            if out.get(a) is None:
                v = get_env(env, dflt)
                parser = self.attr_types.get(a)
                if parser is parse_bool:
                    out[a] = v == "1"
                else:
                    out[a] = parser(v) if parser is not None else v
        return out

    # ---------------------------------------------------------------- compute
    def make_callable(self, attrs, is_train):
        """A positional-args-only closure over normalized attrs; an op with
        ``needs_rng`` takes its generator first: ``call(rng, *args)``."""
        attrs = self.resolve_env_attrs(attrs)
        fn = self.fn
        kw = {"is_train": is_train} if self.train_aware else {}
        if self.needs_rng:
            def call(rng, *args):
                return fn(*args, rng=rng, **kw, **attrs)
        else:
            def call(*args):
                return fn(*args, **kw, **attrs)
        return call

    # -------------------------------------------------------------- inference
    def infer_shape(self, attrs, in_shapes):
        if self._infer_shape is not None:
            return self._infer_shape(attrs, list(in_shapes))
        return eval_shape_infer(self, attrs, in_shapes)[:2] + (None,)

    def infer_type(self, attrs, in_dtypes):
        """The op's own rule, else every input and output takes the first
        known input dtype."""
        if self._infer_type is not None:
            return self._infer_type(attrs, list(in_dtypes))
        known = [d for d in in_dtypes if d is not None]
        d = known[0] if known else _np.float32
        n_in = len(in_dtypes)
        return [d] * n_in, [d] * self.num_outputs_for(attrs), \
            [d] * self.num_aux


def eval_shape_infer(op, attrs, in_shapes):
    """Forward-only inference by running the op on meta tensors."""
    if any(s is None for s in in_shapes):
        return list(in_shapes), [None] * op.num_outputs_for(attrs), \
            [None] * op.num_aux
    call = op.make_callable(op.normalize_attrs(attrs), is_train=False)
    out = call(*[torch.empty(tuple(int(x) for x in s), device="meta")
                 for s in in_shapes])
    if not isinstance(out, (tuple, list)):
        out = (out,)
    shapes = [tuple(o.shape) for o in out]
    n_out = op.num_outputs_for(attrs)
    return (list(in_shapes), shapes[:n_out],
            shapes[n_out:n_out + op.num_aux] if op.num_aux else None)


def shape_unify(a, b):
    """Merge two partially-known shapes (``None`` unknown, 0 an unknown
    dim); raises ValueError on conflict."""
    if a is None:
        return None if b is None else tuple(b)
    if b is None:
        return tuple(a)
    if len(a) != len(b):
        raise ValueError("shape rank mismatch %r vs %r" % (a, b))
    out = []
    for x, y in zip(a, b):
        if x == 0:
            out.append(y)
        elif y == 0 or x == y:
            out.append(x)
        else:
            raise ValueError("shape conflict %r vs %r" % (a, b))
    return tuple(out)


def shape_is_complete(s):
    return s is not None and 0 not in tuple(s)


def register(name, **kwargs):
    """Decorator: register ``fn`` as operator ``name``."""

    def deco(fn):
        op = OpDef(name, fn, **kwargs)
        OPS.register(name, op)
        for al in op.aliases:
            OPS.register(al, op)
        return fn

    return deco


def get_op(name):
    return OPS.get(name)


def list_ops():
    return OPS.list_names()


def attr_key(attrs):
    """A hashable canonical key of an attr dict."""
    def freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(freeze(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, freeze(x)) for k, x in v.items()))
        if isinstance(v, _np.dtype):
            return v.name
        if isinstance(v, type):
            return v.__name__
        return v

    return tuple(sorted((k, freeze(v)) for k, v in attrs.items()))


def imperative_invoke(op_name, inputs, attrs=None, is_train=False, rng=None,
                      device=None):
    """Run one op eagerly on tensors (parity: MXImperativeInvoke).  Returns
    (tuple of tensors: the visible outputs, then the aux updates; the
    OpDef).

    ``device`` is where the op runs when it has no inputs (creation and
    sampling ops build their tensors there); an op with inputs runs where
    its inputs are.  An op with ``needs_rng`` draws from ``rng``, by default
    the generator of that device (``random.generator``).  Under
    ``MXNET_ENGINE_TYPE=NaiveEngine`` the op waits for its results (parity:
    naive_engine.cc); while the profiler runs in ``imperative`` or ``all``
    mode each op is one chrome-trace event, timed to its results.  The JAX
    package's sanitizer hooks arrive with a later slice."""
    op = get_op(op_name) if isinstance(op_name, str) else op_name
    attrs = op.normalize_attrs(attrs or {})
    dev = inputs[0].device if inputs else torch.device(device or "cpu")
    call = op.make_callable(attrs, is_train)
    args = tuple(inputs)
    if op.needs_rng:
        if rng is None:
            from .. import random as _random
            rng = _random.generator(dev)
        args = (rng,) + args
    profiling = _prof._state["running"] and \
        _prof._state["mode"] in ("imperative", "all")
    if profiling:
        import time as _time
        t0 = _time.time()
    if inputs:
        out = call(*args)
    else:
        with torch.device(dev):
            out = call(*args)
    if not isinstance(out, (tuple, list)):
        out = (out,)
    if profiling:
        _engine._wait({dev})
        _prof.record_event(op.name, t0 * 1e6, (_time.time() - t0) * 1e6,
                           "imperative")
    _engine.maybe_wait(out)
    return tuple(out), op
