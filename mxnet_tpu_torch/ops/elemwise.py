"""Elementwise operators (counterpart: mxnet_tpu/ops/elemwise.py): the unary
table, BlockGrad, Cast, the binary, broadcast and scalar tables, smooth_l1,
add_n and clip.

Result dtypes follow the JAX package's (without 64-bit mode): a comparison
returns its left input's dtype, not bool; an integer array with a float
scalar, true division of integers and the transcendental functions of
integers give float32; maximum and minimum with a scalar cast the scalar to
the array's dtype.

Gradients at kinks follow the JAX package's too: relu and clip are
maximum/minimum, whose ties split the gradient (0.5 at relu's 0 and at a
clip bound); abs takes the sign of x >= 0 (1 at 0); hypot is jnp.hypot's
formula (0.5 to each side at (0, 0)).
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from ..base import torch_dtype
from .registry import register, parse_dtype, parse_int, shape_unify


def _same_shape_infer(attrs, in_shapes):
    unified = None
    for s in in_shapes:
        unified = shape_unify(unified, s)
    return [unified for _ in in_shapes], [unified], None


def promoted(*xs):
    """The tensors (None passes through) at their promoted dtype, as
    ``jnp.dot`` promotes its operands: float32 with bfloat16 gives float32.
    torch's matrix products refuse mixed dtypes."""
    dt = None
    for x in xs:
        if x is not None:
            dt = x.dtype if dt is None else torch.promote_types(dt, x.dtype)
    return tuple(x if x is None or x.dtype == dt else x.to(dt) for x in xs)


def _inexact(x):
    """``x`` itself when floating, else as float32 (jnp's promotion of
    integers to the default float type)."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _float_fn(f):
    """A function of floats that also takes integers, as jnp's do."""
    return lambda x: f(_inexact(x))


# ------------------------------------------------------------------ unary ops
def _gamma(x):
    """Gamma through exp(lgamma) with the sign of Γ for negative x (parity:
    the JAX package's ``_gamma``)."""
    x = _inexact(x)
    c = torch.cos(math.pi * x)
    return torch.exp(torch.lgamma(x)) * torch.where(x > 0, 1.0, c / c.abs())


def relu(x):
    """max(x, 0) as the JAX package's ``jnp.maximum(x, 0)``: a tie splits
    the gradient, so it is 0.5 at x = 0 (``torch.relu`` gives 0).  The 0 is
    a 0-dim host tensor, which a CUDA ``x`` takes as a scalar: one launch."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype))


class _Abs(torch.autograd.Function):
    """|x| whose gradient is 1 at x = 0, as ``jnp.abs``'s (sign of x >= 0;
    ``torch.abs`` gives 0 there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    return _Abs.apply(x) if x.is_floating_point() else torch.abs(x)


_UNARY = {
    "relu": relu,
    "sigmoid": torch.sigmoid,
    "_copy": lambda x: x,
    "negative": torch.neg,
    "reciprocal": torch.reciprocal,
    "abs": _abs,
    "sign": torch.sign,
    "round": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "rint": _float_fn(torch.round),
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.arcsin, "arccos": torch.arccos, "arctan": torch.arctan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.arcsinh, "arccosh": torch.arccosh,
    "arctanh": torch.arctanh,
    "gamma": _gamma,
    "gammaln": _float_fn(torch.lgamma),
    "degrees": _float_fn(torch.rad2deg),
    "radians": _float_fn(torch.deg2rad),
}

for _name, _f in _UNARY.items():
    register(_name, aliases=("identity",) if _name == "_copy" else ())(
        (lambda f: lambda data: f(data))(_f))

register("BlockGrad", aliases=("stop_gradient",))(
    lambda data: data.detach())


@register("Cast", aliases=("cast",),
          attr_types={"dtype": parse_dtype}, defaults={"dtype": _np.float32},
          infer_type=lambda attrs, in_dt: (
              in_dt, [attrs.get("dtype", _np.float32)], []))
def _cast(data, dtype=_np.float32):
    """Cast to dtype (parity: elemwise_unary_op.cc Cast)."""
    return data.to(torch_dtype(dtype))


@register("_identity_with_attr_like_rhs", arg_names=("lhs", "rhs"),
          hidden=True)
def _identity_like_rhs(lhs, rhs):
    return lhs


# ----------------------------------------------------------------- binary ops
def _maximum_f(a, b):
    # where-form so ties route the full gradient to lhs (the reference's
    # mshadow_op::ge; torch.maximum splits it at ties)
    return torch.where(a >= b, a, b)


def _minimum_f(a, b):
    return torch.where(a <= b, a, b)


def _hypot(a, b):
    """jnp.hypot's formula: hi * sqrt(1 + (lo / hi)^2) of |a| and |b|, 0
    where both are 0 and inf where either is; its gradient at (0, 0) is 0.5
    to each side (``torch.hypot``'s is NaN)."""
    a, b = _abs(_inexact(a)), _abs(_inexact(b))
    inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    ratio = lo / torch.where(zero, torch.ones_like(hi), hi)
    h = torch.where(zero, hi, hi * torch.sqrt(1 + ratio * ratio))
    return torch.where(inf, torch.full_like(h, math.inf), h)


def _cmp(f):
    """A comparison returning its left input's dtype."""
    return lambda a, b: f(a, b).to(a.dtype)


_EQ = _cmp(torch.eq)
_NE = _cmp(torch.ne)
_GT = _cmp(torch.gt)
_GE = _cmp(torch.ge)
_LT = _cmp(torch.lt)
_LE = _cmp(torch.le)

_BINARY = {
    "_minus": (torch.sub, ("_sub", "elemwise_sub")),
    "_mul": (torch.mul, ("elemwise_mul",)),
    "_div": (torch.true_divide, ("elemwise_div",)),
    "_power": (torch.pow, ()),
    "_maximum": (_maximum_f, ()),
    "_minimum": (_minimum_f, ()),
    "_hypot": (_hypot, ()),
    "_grad_add": (torch.add, ()),
    "_equal": (_EQ, ()),
    "_not_equal": (_NE, ()),
    "_greater": (_GT, ()),
    "_greater_equal": (_GE, ()),
    "_lesser": (_LT, ()),
    "_lesser_equal": (_LE, ()),
}


@register("_plus", arg_names=("lhs", "rhs"), aliases=("_add", "elemwise_add"),
          infer_shape=_same_shape_infer, layout_rule="transparent")
def _plus(lhs, rhs):
    """lhs + rhs (parity: elemwise_binary_op_basic.cc _plus); the residual
    add of ResNet, which the NHWC layout pass lets through."""
    return lhs + rhs


for _name, (_f, _al) in _BINARY.items():
    register(_name, arg_names=("lhs", "rhs"), aliases=_al,
             infer_shape=_same_shape_infer)(
        (lambda f: lambda lhs, rhs: f(lhs, rhs))(_f))

# broadcast variants (parity: elemwise_binary_broadcast_op_*.cc)
_BCAST = {
    "broadcast_add": (torch.add, ("broadcast_plus",)),
    "broadcast_sub": (torch.sub, ("broadcast_minus",)),
    "broadcast_mul": (torch.mul, ()),
    "broadcast_div": (torch.true_divide, ()),
    "broadcast_power": (torch.pow, ()),
    "broadcast_maximum": (_maximum_f, ()),
    "broadcast_minimum": (_minimum_f, ()),
    "broadcast_hypot": (_hypot, ()),
    "broadcast_equal": (_EQ, ()),
    "broadcast_not_equal": (_NE, ()),
    "broadcast_greater": (_GT, ()),
    "broadcast_greater_equal": (_GE, ()),
    "broadcast_lesser": (_LT, ()),
    "broadcast_lesser_equal": (_LE, ()),
}
for _name, (_f, _al) in _BCAST.items():
    register(_name, arg_names=("lhs", "rhs"), aliases=_al)(
        (lambda f: lambda lhs, rhs: f(lhs, rhs))(_f))


# ----------------------------------------------------------------- scalar ops
def _as(x, s):
    """The scalar cast to x's dtype, on x's device (jnp.asarray(s,
    x.dtype): a float scalar truncates toward zero for an integer x)."""
    return torch.tensor(s, dtype=torch.float64, device=x.device).to(x.dtype)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: _maximum_f(x, _as(x, s)),
    "_minimum_scalar": lambda x, s: _minimum_f(x, _as(x, s)),
    "_hypot_scalar": lambda x, s: _hypot(x, _as(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
}
for _name, _f in _SCALAR.items():
    register(_name, attr_types={"scalar": float}, defaults={"scalar": 0.0})(
        (lambda f: lambda data, scalar=0.0: f(data, scalar))(_f))


@register("smooth_l1", attr_types={"scalar": float}, defaults={"scalar": 1.0})
def _smooth_l1(data, scalar=1.0):
    """Smooth-L1 (parity: mshadow_op.h smooth_l1_loss)."""
    s2 = scalar * scalar
    data = _inexact(data)
    absd = data.abs()
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


# ---------------------------------------------------------------- variadic sum
@register("add_n", aliases=("ElementWiseSum", "_sum"),
          arg_names=lambda attrs: ["arg%d" % i
                                   for i in range(int(attrs.get("num_args",
                                                                1)))],
          key_var_num_args="num_args",
          attr_types={"num_args": parse_int},
          infer_shape=lambda attrs, ins: (
              [next((s for s in ins if s is not None), None)] * len(ins),
              [next((s for s in ins if s is not None), None)], None))
def _add_n(*args, num_args=None):
    """Variadic sum (parity: elemwise_sum.cc ElementWiseSum)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# --------------------------------------------------------------------- clip
@register("clip", attr_types={"a_min": float, "a_max": float},
          defaults={"a_min": 0.0, "a_max": 0.0})
def _clip(data, a_min=0.0, a_max=0.0):
    """Clip to [a_min, a_max] (parity: matrix_op.cc clip): jnp.clip's
    minimum(maximum(x, a_min), a_max) for floats, so a value at a bound
    takes half the gradient."""
    if not data.is_floating_point():
        return torch.clamp(data, a_min, a_max)
    lo = torch.full((), a_min, dtype=data.dtype)
    hi = torch.full((), a_max, dtype=data.dtype)
    return torch.minimum(torch.maximum(data, lo), hi)
