"""The imperative ``mx.nd`` API of mxnet_tpu_torch against mxnet_tpu's: every
op of elemwise, reduce_ops, init_ops, matrix, indexing and sample_ops through
its ``mx.nd.<op>`` frontend (one test per family, the ops as cases), the
arithmetic and comparison operators with an array, a broadcast array and a
scalar, result dtypes included, and sequences on views: a view read after a
write to its base, writes through ``x[1:3]``, ``x[2]`` and ``x.reshape``,
``__setitem__`` on a key, ``out=`` and the aux write-back.

The same numpy inputs go to both packages on the CPU; float64 ops agree to
1e-9 relative (JAX with 64-bit mode on), float32 and integer ones to 1e-6,
and every result's dtype is the JAX package's (64-bit mode off, its
default, where integer and float32 promotion is checked)."""
import pickle

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import elemwise as pelem
from mxnet_tpu_torch.ops import registry as preg
from test_torch_threads import torch_threads_per_worker  # noqa: F401

F64 = 1e-9
F32 = 1e-6


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _j(a, dtype=np.float64):
    return mx.nd.array(np.asarray(a), dtype=dtype)


def _p(a, dtype=np.float64):
    return mt.nd.array(np.asarray(a), ctx=mt.cpu(), dtype=dtype)


def _listify(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _same(got, want, rtol=F64, of_largest=False):
    """Same dtypes and shapes, and values within ``rtol`` of each entry
    (``of_largest``: of the largest magnitude of the result)."""
    got, want = _listify(got), _listify(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.dtype(g.dtype) == np.dtype(w.dtype), (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        wv = w.asnumpy()
        atol = rtol * (np.abs(wv).max() if of_largest and wv.size
                       else 1e-3)
        np.testing.assert_allclose(g.asnumpy(), wv, rtol=rtol, atol=atol)


def _both(name, arrays, dtype=np.float64, rtol=F64, of_largest=False,
          **attrs):
    """mx.nd.<name> of both packages on the same inputs."""
    want = getattr(mx.nd, name)(*[_j(a, dtype) for a in arrays], **attrs)
    got = getattr(mt.nd, name)(*[_p(a, dtype) for a in arrays], **attrs)
    _same(got, want, rtol, of_largest)
    return got


def _u(seed, shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape)


# ------------------------------------------------------------------- unary
_DOMAIN = {"log": (0.1, 3), "log10": (0.1, 3), "log2": (0.1, 3),
           "sqrt": (0.1, 3), "rsqrt": (0.1, 3), "gammaln": (0.1, 4),
           "log1p": (-0.5, 2), "arcsin": (-0.9, 0.9),
           "arccos": (-0.9, 0.9), "arctanh": (-0.9, 0.9),
           "arccosh": (1.1, 3)}
_ROUNDING = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 1.2, -1.7, 0.0, 3.49])


def _unary_input(name):
    if name in ("round", "rint", "ceil", "floor", "fix", "sign", "relu"):
        return _ROUNDING
    if name == "gamma":
        return np.array([-2.5, -1.3, -0.7, 0.3, 1.0, 2.6, 4.1, 5.5])
    if name == "reciprocal":
        return np.array([-2.0, -0.3, 0.25, 1.0, 3.0])
    lo, hi = _DOMAIN.get(name, (-2.0, 2.0))
    return _u(0, (3, 5), lo, hi)


@pytest.mark.parametrize("name", sorted(pelem._UNARY) + [
    "identity", "BlockGrad", "stop_gradient"])
def test_unary(f64, name):
    _both(name, [_unary_input(name)])


@pytest.mark.parametrize("name", sorted(set(pelem._UNARY)
                                        - {"sigmoid", "rsqrt"}))
def test_unary_int32_dtype(name):
    """Integer inputs: the JAX result dtype (int kept by relu, abs, round,
    ...; float32 from sqrt, exp, rint, gamma, ...).  Values within 1e-6 of
    the largest: XLA's float32 lgamma(1) is 4.8e-7, not 0."""
    _both(name, [np.array([[1, 2], [3, 4]])], np.int32, F32,
          of_largest=True)


@pytest.mark.parametrize("dtype", ["float16", "int32", "uint8", "float64"])
def test_cast(f64, dtype):
    x = np.array([-1.7, 0.2, 2.9, 100.5])
    _both("Cast", [x], dtype=dtype)
    got = _p(x).astype(dtype)
    assert np.dtype(got.dtype) == np.dtype(dtype)


def test_identity_with_attr_like_rhs(f64):
    _both("_identity_with_attr_like_rhs", [_u(1, (2, 3)), _u(2, (2, 3))])


# ------------------------------------------------------- binary and scalar
def _binary_inputs(name, shape_a, shape_b):
    a, b = _u(3, shape_a), _u(4, shape_b)
    if "power" in name:
        a = np.abs(a) + 0.5
    if "div" in name:
        b = np.sign(b) * (np.abs(b) + 0.5)
    if "equal" in name or "greater" in name or "lesser" in name:
        b = np.where(_u(5, shape_b) > 0, np.broadcast_to(a, np.broadcast(
            a, b).shape)[tuple(slice(0, s) for s in shape_b)], b)
    return a, b


@pytest.mark.parametrize("name", ["_plus", "_add", "elemwise_add"]
                         + sorted(n for n in pelem._BINARY)
                         + ["_sub", "elemwise_sub", "elemwise_mul",
                            "elemwise_div"])
def test_binary(f64, name):
    _both(name, list(_binary_inputs(name, (3, 4), (3, 4))))


@pytest.mark.parametrize("name", sorted(pelem._BCAST)
                         + ["broadcast_plus", "broadcast_minus"])
def test_broadcast(f64, name):
    _both(name, list(_binary_inputs(name, (3, 1, 4), (1, 5, 4))))


@pytest.mark.parametrize("name", sorted(pelem._SCALAR))
def test_scalar(f64, name):
    x = _u(6, (3, 4))
    if "power" in name:
        x = np.abs(x) + 0.5
    if name == "_rdiv_scalar":
        x = np.sign(x) * (np.abs(x) + 0.5)
    x[0, :2] = 2.5        # ties for the comparisons and max/min
    _both(name, [x], scalar=2.5)


@pytest.mark.parametrize("name", sorted(pelem._SCALAR))
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scalar_dtype(name, dtype):
    """An int32 array with a float scalar gives float32 except for max/min
    (the scalar cast to int) and the comparisons (the array's dtype)."""
    _both(name, [np.array([[1, 2], [3, 4]])], dtype, F32, scalar=2.5)


def test_misc_elemwise(f64):
    x = _u(7, (4, 6))
    _both("smooth_l1", [x], scalar=1.5)
    _both("smooth_l1", [x])
    _both("clip", [x], a_min=-0.5, a_max=0.7)
    for name in ("add_n", "ElementWiseSum", "_sum"):
        _both(name, [x, _u(8, (4, 6)), _u(9, (4, 6))])
    _both("add_n", [x])


# ------------------------------------------------------------------ reduce
_REDUCE_CASES = [{}, {"axis": 1}, {"axis": (0, 2)}, {"axis": 1,
                                                      "keepdims": True},
                 {"axis": (1,), "exclude": True}, {"axis": (0, 1, 2),
                                                   "exclude": True},
                 {"axis": -1}]


@pytest.mark.parametrize("name", ["sum", "sum_axis", "mean", "prod",
                                  "nansum", "nanprod", "max", "max_axis",
                                  "min", "min_axis"])
@pytest.mark.parametrize("case", range(len(_REDUCE_CASES)))
def test_reduce(f64, name, case):
    x = _u(10, (3, 4, 5), 0.5, 1.5)
    if name.startswith("nan"):
        x[1, 2, 3] = np.nan
    _both(name, [x], **_REDUCE_CASES[case])


@pytest.mark.parametrize("name", ["sum", "mean", "prod", "nansum", "max"])
def test_reduce_int32_dtype(name):
    _both(name, [np.arange(12).reshape(3, 4)], np.int32, F32, axis=1)


@pytest.mark.parametrize("name,attrs", [
    ("norm", {}), ("argmax", {}), ("argmax", {"axis": 1}),
    ("argmax", {"axis": 0, "keepdims": True}),
    ("argmax", {"keepdims": True}), ("argmin", {"axis": -1}),
    ("argmin", {}), ("argmax_channel", {}),
    ("broadcast_to", {"shape": (2, 3, 4)}),
    ("broadcast_to", {"shape": (0, 3, 0)}),
    ("broadcast_axis", {"axis": 1, "size": 3}),
    ("broadcast_axes", {"axis": (1,), "size": (3,)})])
def test_reduce_index_broadcast(f64, name, attrs):
    x = _u(11, (2, 1, 4))
    x[1, 0, 2] = x[1, 0, 1]          # a tie: the first index wins
    _both(name, [x], **attrs)


# -------------------------------------------------------------------- init
@pytest.mark.parametrize("name,attrs", [
    ("_zeros", {"shape": (2, 3)}), ("zeros", {"shape": (4,)}),
    ("_ones", {"shape": (2, 3), "dtype": "int32"}),
    ("_full", {"shape": (3, 2), "value": 2.5}),
    ("_full", {"shape": (3,), "value": -1.0, "dtype": "float64"}),
    ("_arange", {"start": 1.0, "stop": 7.0, "step": 1.5}),
    ("arange", {"start": 5.0}),
    ("_arange", {"start": 0.0, "stop": 3.0, "repeat": 3}),
    ("_arange", {"start": 0.0, "stop": 5.0, "step": 1.5, "dtype": "int32"}),
    ("_arange", {"start": 2.0, "stop": -3.0, "step": -0.5,
                 "dtype": "float64"})])
def test_init(f64, name, attrs):
    want = getattr(mx.nd, name)(ctx=mx.cpu(), **attrs)
    got = getattr(mt.nd, name)(ctx=mt.cpu(), **attrs)
    _same(got, want)


def test_init_like_and_state_init(f64):
    x = _u(12, (3, 4))
    _both("zeros_like", [x])
    _both("ones_like", [x])
    _both("_state_init", [x], shape=(0, 5), value=1.5)
    _both("_state_init", [x], shape=(2, 0), batch_axis=1, dtype="float32")


def test_constructors(f64):
    c = mt.cpu()
    for name, args in (("zeros", ((2, 3),)), ("ones", ((2, 3),)),
                       ("empty", (4,)), ("full", ((2, 2), 7.0))):
        got = getattr(mt.nd, name)(*args, ctx=c, dtype=np.float64)
        want = getattr(mx.nd, name)(*args, dtype=np.float64)
        _same(got, want)
    _same(mt.nd.arange(0, 6, 2, repeat=2, ctx=c),
          mx.nd.arange(0, 6, 2, repeat=2))
    _same(mt.nd.ones(3, ctx=c, dtype=np.int32),
          mx.nd.ones(3, dtype=np.int32))
    a, b = _u(13, (2, 3)), _u(14, (1, 3))
    _same(mt.nd.concatenate([_p(a), _p(b)]),
          mx.nd.concatenate([_j(a), _j(b)]))
    _same(mt.nd.concatenate([_p(a), _p(a)], axis=1),
          mx.nd.concatenate([_j(a), _j(a)], axis=1))
    idx = np.array([0, 2, 1, 3])
    got = mt.nd.zeros((4, 5), ctx=c)
    mt.nd.onehot_encode(_p(idx, np.float32), got)
    want = mx.nd.zeros((4, 5))
    mx.nd.onehot_encode(_j(idx, np.float32), want)
    _same(got, want)
    for f in ("maximum", "minimum"):
        _same(getattr(mt.nd, f)(_p(a), _p(b)), getattr(mx.nd, f)(_j(a),
                                                              _j(b)))
        _same(getattr(mt.nd, f)(_p(a), 0.1), getattr(mx.nd, f)(_j(a), 0.1))
        _same(getattr(mt.nd, f)(0.1, _p(a)), getattr(mx.nd, f)(0.1, _j(a)))
        assert getattr(mt.nd, f)(1.0, 2.0) == getattr(mx.nd, f)(1.0, 2.0)
    mt.nd.waitall()


# ------------------------------------------------------------------ matrix
@pytest.mark.parametrize("name,shapes,attrs", [
    ("expand_dims", [(3, 4)], {"axis": 1}),
    ("expand_dims", [(3, 4)], {"axis": -1}),
    ("SwapAxis", [(2, 3, 4)], {"dim1": 0, "dim2": 2}),
    ("swapaxes", [(2, 3, 4)], {"dim1": 1, "dim2": 2}),
    ("slice", [(5, 6, 3)], {"begin": (1, 0), "end": (4, 5)}),
    ("crop", [(5, 6)], {"begin": (0, 2), "end": (None, 5)}),
    ("slice_axis", [(5, 6)], {"axis": 1, "begin": -4, "end": None}),
    ("transpose", [(2, 3, 4)], {}),
    ("transpose", [(2, 3, 4)], {"axes": (1, 0, 2)}),
    ("Reshape", [(2, 3, 4)], {"shape": (0, -1)}),
    ("reshape", [(2, 3, 4)], {"shape": (-3, -2)}),
    ("Flatten", [(2, 3, 4)], {}),
    ("dot", [(3, 4), (4, 5)], {}),
    ("dot", [(4, 3), (4, 5)], {"transpose_a": True}),
    ("dot", [(3, 4), (5, 4)], {"transpose_b": True}),
    ("dot", [(4,), (4,)], {}),
    ("dot", [(3, 4), (4,)], {}),
    ("dot", [(2, 3, 4), (4, 5)], {}),
    ("batch_dot", [(2, 3, 4), (2, 4, 5)], {}),
    ("batch_dot", [(2, 4, 3), (2, 5, 4)], {"transpose_a": True,
                                           "transpose_b": True}),
    ("repeat", [(2, 3)], {"repeats": 2}),
    ("repeat", [(2, 3)], {"repeats": 3, "axis": 1}),
    ("tile", [(2, 3)], {"reps": (2, 2)}),
    ("tile", [(2, 3)], {"reps": (3,)}),
    ("reverse", [(2, 3, 4)], {"axis": 1}),
    ("flip", [(2, 3, 4)], {"axis": (0, 2)}),
    ("Concat", [(2, 3), (2, 5)], {"dim": 1}),
    ("concat", [(2, 3), (4, 3), (1, 3)], {"dim": 0}),
    ("stack", [(2, 3), (2, 3), (2, 3)], {"axis": 1}),
    ("SliceChannel", [(2, 6, 3)], {"num_outputs": 3}),
    ("split", [(4, 6)], {"num_outputs": 2, "axis": 0,
                         "squeeze_axis": False}),
    ("split", [(3, 2)], {"num_outputs": 2, "axis": 1,
                         "squeeze_axis": True}),
    ("Pad", [(1, 2, 3, 4)], {"mode": "constant",
                             "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                             "constant_value": 1.5}),
    ("pad", [(1, 2, 3, 4)], {"mode": "edge",
                             "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}),
    ("Pad", [(1, 2, 4, 5)], {"mode": "reflect",
                             "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)})])
def test_matrix(f64, name, shapes, attrs):
    _both(name, [_u(20 + i, s) for i, s in enumerate(shapes)], **attrs)


def test_dot_int32():
    a = np.arange(6).reshape(2, 3)
    _both("dot", [a, a.T], np.int32, F32)


# ---------------------------------------------------------------- indexing
@pytest.mark.parametrize("name,arrays,attrs", [
    ("take", [(5, 3), [[0, 4], [7, -2]]], {}),
    ("take", [(5, 3), [0, 4, 7, -2, 2.7]], {"mode": "wrap"}),
    ("take", [(4, 6, 2), [[1, 0], [5, 9]]], {"axis": 1, "mode": "clip"}),
    ("batch_take", [(4, 3), [2, 0, 1, 1]], {}),
    ("one_hot", [[0, 2, 4, 5, -1]], {"depth": 5}),
    ("one_hot", [[[1, 0], [3, 2]]], {"depth": 4, "on_value": 2.5,
                                     "off_value": -1.0, "dtype": "int32"})])
def test_indexing(f64, name, arrays, attrs):
    ins = [_u(30, a) if isinstance(a, tuple) else np.asarray(a, np.float64)
           for a in arrays]
    _both(name, ins, **attrs)


def test_where(f64):
    x, y = _u(31, (3, 4)), _u(32, (3, 4))
    cond = (_u(33, (3, 4)) > 0).astype(np.float64)
    _both("where", [cond, x, y])
    _both("where", [np.array([1.0, 0.0, 2.0]), x, y])


# ------------------------------------------------------------------ sample
@pytest.mark.parametrize("name,attrs,mean,std", [
    ("_random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 4 / 12 ** 0.5),
    ("uniform", {}, 0.5, 1 / 12 ** 0.5),
    ("_sample_uniform", {"low": 2.0, "high": 2.5}, 2.25, 0.5 / 12 ** 0.5),
    ("_random_normal", {"loc": 1.5, "scale": 2.0}, 1.5, 2.0),
    ("normal", {}, 0.0, 1.0),
    ("_sample_normal", {"loc": -3.0, "scale": 0.1}, -3.0, 0.1)])
def test_sample_statistics(name, attrs, mean, std):
    """Samples by statistics (the bits are not threefry's): the mean within
    5 standard errors, the standard deviation within 1%; shape and dtype as
    the JAX package's."""
    n = 200000
    mt.random.seed(11)
    got = getattr(mt.nd, name)(shape=(n // 100, 100), ctx=mt.cpu(), **attrs)
    want = getattr(mx.nd, name)(shape=(n // 100, 100), **attrs)
    assert got.shape == want.shape and got.dtype == want.dtype
    v = got.asnumpy().astype(np.float64)
    assert abs(v.mean() - mean) < 5 * std / n ** 0.5
    assert abs(v.std() / std - 1) < 0.01
    if "uniform" in name:
        lo, hi = attrs.get("low", 0.0), attrs.get("high", 1.0)
        assert v.min() >= lo and v.max() <= hi
    again = getattr(mt.nd, name)(shape=(3,), ctx=mt.cpu(), **attrs)
    mt.random.seed(11)
    first = getattr(mt.nd, name)(shape=(n // 100, 100), ctx=mt.cpu(),
                                 **attrs)
    np.testing.assert_array_equal(first.asnumpy(), got.asnumpy())
    assert not np.array_equal(again.asnumpy(), got.asnumpy()[0, :3])


def test_sample_dtype_and_device_generator():
    mt.random.seed(3)
    a = mt.nd.normal(shape=(4,), ctx=mt.cpu(), dtype="float64")
    assert a.dtype == np.float64
    b = mt.nd.uniform(shape=(2, 2), ctx=mt.cpu(), dtype="float16")
    assert b.dtype == np.float16
    assert mt.random.generator(torch.device("cpu")) is mt.random.generator()


# --------------------------------------------------------------- operators
_OPS = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
        "pow": lambda a, b: a ** b, "eq": lambda a, b: a == b,
        "ne": lambda a, b: a != b, "gt": lambda a, b: a > b,
        "ge": lambda a, b: a >= b, "lt": lambda a, b: a < b,
        "le": lambda a, b: a <= b}
_ROPS = {"radd": lambda a, s: s + a, "rsub": lambda a, s: s - a,
         "rmul": lambda a, s: s * a, "rdiv": lambda a, s: s / a,
         "rpow": lambda a, s: s ** a, "neg": lambda a, s: -a}


def _op_input(dtype, seed, shape):
    if np.dtype(dtype).kind == "i":
        return np.random.RandomState(seed).randint(1, 4, shape)
    return np.abs(_u(seed, shape)) + 0.5


@pytest.mark.parametrize("op", sorted(_OPS))
@pytest.mark.parametrize("other", ["array", "broadcast", "scalar"])
def test_operators(f64, op, other):
    a = _op_input(np.float64, 40, (3, 4))
    b = {"array": _op_input(np.float64, 41, (3, 4)),
         "broadcast": _op_input(np.float64, 42, (1, 4))}.get(other)
    if b is not None:
        b[0, :2] = a[0, :2]
    f = _OPS[op]
    got = f(_p(a), _p(b) if b is not None else 2.0)
    want = f(_j(a), _j(b) if b is not None else 2.0)
    _same(got, want)


@pytest.mark.parametrize("op", sorted(_OPS) + sorted(_ROPS))
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("other", ["int_array", "float_array", "scalar"])
def test_operator_dtypes(op, dtype, other):
    """Result dtypes with JAX's promotion: int32 with a float scalar and
    int32 / int32 give float32, comparisons keep the left dtype."""
    a = _op_input(dtype, 43, (2, 3))
    b = {"int_array": (_op_input(np.int32, 44, (2, 3)), np.int32),
         "float_array": (_op_input(np.float32, 45, (2, 3)), np.float32)
         }.get(other)
    f = _OPS.get(op) or _ROPS[op]
    if op in _ROPS:
        if b is not None:
            return _same(f(_p(a, dtype), 2.5), f(_j(a, dtype), 2.5), F32)
        got, want = f(_p(a, dtype), 1.5), f(_j(a, dtype), 1.5)
    elif b is None:
        got, want = f(_p(a, dtype), 2.5), f(_j(a, dtype), 2.5)
    else:
        got = f(_p(a, dtype), _p(b[0], b[1]))
        want = f(_j(a, dtype), _j(b[0], b[1]))
    _same(got, want, F32)


@pytest.mark.parametrize("op", ["iadd", "isub", "imul", "idiv"])
@pytest.mark.parametrize("other", ["array", "broadcast", "scalar"])
def test_inplace_operators(f64, op, other):
    a = _op_input(np.float64, 46, (3, 4))
    b = {"array": _op_input(np.float64, 47, (3, 4)),
         "broadcast": _op_input(np.float64, 48, (1, 4))}.get(other)

    def run(x, y):
        if op == "iadd":
            x += y
        elif op == "isub":
            x -= y
        elif op == "imul":
            x *= y
        else:
            x /= y
        return x
    p, j = _p(a), _j(a)
    pv = p[1:3]                               # a view sees the in-place op
    got = run(p, _p(b) if b is not None else 1.5)
    want = run(j, _j(b) if b is not None else 1.5)
    assert got is p
    _same(got, want)
    np.testing.assert_allclose(pv.asnumpy(), want.asnumpy()[1:3], rtol=F64)


def test_inplace_int_with_float_rebinds_like_jax():
    """int32 += 0.5 makes the array float32 in both packages."""
    p, j = _p([1, 2, 3], np.int32), _j([1, 2, 3], np.int32)
    p += 0.5
    j += 0.5
    _same(p, j, F32)


# ------------------------------------------------------------------- views
def test_views_see_writes_to_base(f64):
    x = np.arange(24, dtype=np.float64).reshape(4, 6)
    p, j = _p(x), _j(x)
    pviews = [p[1:3], p[2], p.reshape((6, 4)), p[1:3].reshape((3, 4))[1]]
    jviews = [j[1:3], j[2], j.reshape((6, 4)), j[1:3].reshape((3, 4))[1]]
    p[:] = 7.0
    j[:] = 7.0
    for a, b in zip(pviews, jviews):
        _same(a, b)
    p[:] = _p(x * 2)
    j[:] = _j(x * 2)
    for a, b in zip(pviews, jviews):
        _same(a, b)
    mt.nd.sgd_update(p, _p(np.ones((4, 6))), lr=0.5, out=p)
    mx.nd.sgd_update(j, _j(np.ones((4, 6))), lr=0.5, out=j)
    for a, b in zip(pviews, jviews):
        _same(a, b)


@pytest.mark.parametrize("view", ["slice", "at", "reshape", "chain"])
def test_writes_through_views(f64, view):
    x = np.arange(24, dtype=np.float64).reshape(4, 6)
    p, j = _p(x), _j(x)

    def take(a):
        return {"slice": lambda: a[1:3], "at": lambda: a[2],
                "reshape": lambda: a.reshape((2, 12)),
                "chain": lambda: a[1:4].reshape((9, 2))[3:5]}[view]()
    pv, jv = take(p), take(j)
    pv[:] = -1.0
    jv[:] = -1.0
    _same(p, j)
    val = _u(50, pv.shape)
    pv[:] = val
    jv[:] = val
    _same(p, j)
    pv += 1.0
    jv += 1.0
    _same(p, j)
    pv[0] = 5.0
    jv[0] = 5.0
    _same(p, j)
    assert pv.shape == jv.shape and pv.context == mt.cpu()


def test_setitem_on_key(f64):
    x = np.arange(20, dtype=np.float64).reshape(4, 5)
    p, j = _p(x), _j(x)
    base = p.value
    for key, val in ((1, 9.0), (slice(1, 3), _u(51, (2, 5))),
                     ((2, 3), -4.0), ((slice(None), 0), np.arange(4.0)),
                     (slice(None), 0.5), ((0, slice(1, 4)), [1.0, 2, 3])):
        p[key] = val
        j[key] = val
        _same(p, j)
    assert p.value is base                    # in place: no new tensor
    p[1:3] = p[0:2]                           # overlapping source
    j[1:3] = j[0:2]
    _same(p, j)


def test_view_errors():
    p = _p(np.zeros((4, 6)))
    with pytest.raises(mt.MXNetError, match="step"):
        p[::2]
    with pytest.raises(IndexError):
        p[4]
    with pytest.raises(mt.MXNetError):
        p[[0, 1]]
    with pytest.raises(mt.MXNetError, match="view"):
        p[1:3]._set_value(torch.zeros(3))
    with pytest.raises(mt.MXNetError, match="truth value"):
        bool(p)
    ro = mt.nd.NDArray(torch.zeros(3), writable=False)
    with pytest.raises(mt.MXNetError):
        ro[:] = 1.0


def test_out_and_ops_never_alias_inputs(f64):
    x = _u(52, (3, 4))
    p, j = _p(x), _j(x)
    po, jo = mt.nd.zeros((3, 4), ctx=mt.cpu(), dtype=np.float64), \
        mx.nd.zeros((3, 4), dtype=np.float64)
    view = po[1:3]
    assert mt.nd.exp(p, out=po) is po
    mx.nd.exp(j, out=jo)
    _same(po, jo)
    _same(view, jo[1:3])
    a, b = mt.nd.zeros((3, 2), ctx=mt.cpu(), dtype=np.float64), \
        mt.nd.zeros((3, 2), ctx=mt.cpu(), dtype=np.float64)
    mt.nd.split(p, num_outputs=2, axis=1, out=[a, b])
    ja, jb = mx.nd.split(j, num_outputs=2, axis=1)
    _same(a, ja)
    _same(b, jb)
    for name, kw in (("transpose", {}), ("Reshape", {"shape": (4, 3)}),
                     ("_copy", {}), ("identity", {}),
                     ("expand_dims", {"axis": 0}),
                     ("broadcast_to", {"shape": (3, 4)}),
                     ("slice_axis", {"axis": 0, "begin": 1, "end": 2})):
        src = _p(x)
        out = getattr(mt.nd, name)(src, **kw)
        out[:] = 0.0
        np.testing.assert_array_equal(src.asnumpy(), x)
        assert out.value.is_contiguous()
    t = p.T
    t[:] = 0.0
    np.testing.assert_array_equal(p.asnumpy(), x)
    c = p.copy()
    c[:] = 1.0
    np.testing.assert_array_equal(p.asnumpy(), x)


def test_aux_write_back(f64):
    """BatchNorm's aux states are written back in place (unchanged at
    inference, in both packages)."""
    rs = np.random.RandomState(53)
    x, gamma, beta = rs.randn(2, 3, 4, 4), rs.rand(3) + 0.5, rs.randn(3)
    mean, var = rs.randn(3), rs.rand(3) + 0.5
    pins = [_p(a) for a in (x, gamma, beta, mean, var)]
    jins = [_j(a) for a in (x, gamma, beta, mean, var)]
    pview = pins[3][0:2]
    got = mt.nd.BatchNorm(*pins, fix_gamma=False)
    want = mx.nd.BatchNorm(*jins, fix_gamma=False)
    _same(got, want)
    _same(pins[3], jins[3])
    _same(pins[4], jins[4])
    np.testing.assert_array_equal(pview.asnumpy(), mean[:2])


def test_ndarray_methods(f64):
    x = _u(54, (2, 3))
    p, j = _p(x), _j(x)
    _same(p.T, j.T)
    _same(p.astype(np.float32), j.astype(np.float32))
    _same(p.copy(), j.copy())
    _same(p[1:2].broadcast_to((4, 3)), j[1:2].broadcast_to((4, 3)))
    assert _p([3.5]).asscalar() == _j([3.5]).asscalar() == 3.5
    with pytest.raises(mt.MXNetError):
        p.asscalar()
    p.wait_to_read()
    q = pickle.loads(pickle.dumps(p[1:2]))
    assert q.context == mt.cpu() and q.dtype == np.float64
    np.testing.assert_array_equal(q.asnumpy(), x[1:2])
    assert len(p) == 2 and p.size == 6 and p.ndim == 2
    assert hash(p) == id(p)


# --------------------------------------------------------------- frontends
def test_every_registered_op_has_a_frontend():
    names = preg.list_ops()
    assert set(names) == set(jreg.list_ops()) & set(names)
    for name in names:
        fn = getattr(mt.nd, name)
        assert callable(fn), name
    for name in ("sgd_update", "sgd_mom_update", "adam_update",
                 "rmsprop_update", "rmspropalex_update", "relu", "dot",
                 "Concat", "uniform", "FullyConnected", "SoftmaxOutput",
                 "dot_product_attention"):
        assert getattr(mt.nd, name).__name__ == preg.get_op(name).name
    # the hand-written helpers are not shadowed by the ops of those names
    assert mt.nd.zeros.__module__ == "mxnet_tpu_torch.ndarray"
    assert mt.nd.zeros.__name__ == "zeros"


def test_optimizer_op_frontends(f64):
    rs = np.random.RandomState(55)
    w, g, m, v = rs.randn(4, 3), rs.randn(4, 3), rs.randn(4, 3), \
        rs.rand(4, 3)
    kw = dict(lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.4)
    _both("sgd_update", [w, g], **kw)
    _both("sgd_mom_update", [w, g, m], momentum=0.9, **kw)
    _both("adam_update", [w, g, m, v], beta1=0.8, beta2=0.99, **kw)
    _both("rmsprop_update", [w, g, v], gamma1=0.9, **kw)
    _both("rmspropalex_update", [w, g, v, m * 0.1, m], gamma1=0.9,
          gamma2=0.8, **kw)


def test_variadic_num_args_and_list_inputs(f64):
    xs = [_u(56 + i, (2, 3)) for i in range(3)]
    _same(mt.nd.add_n(*[_p(a) for a in xs]),
          mx.nd.add_n(*[_j(a) for a in xs]))
    _same(mt.nd.Concat([_p(a) for a in xs], dim=0),
          mx.nd.Concat([_j(a) for a in xs], dim=0))
    _same(mt.nd.stack(*[_p(a) for a in xs], axis=2),
          mx.nd.stack(*[_j(a) for a in xs], axis=2))
    # a non-NDArray input goes where the first NDArray lives
    got = mt.nd.broadcast_add(_p(xs[0]), np.ones((1, 3)))
    assert got.context == mt.cpu()


def test_invoke_on_cuda_context_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(mt.MXNetError, match="CUDA device"):
        mt.nd.zeros((2,), ctx=mt.gpu(0))


def test_registry_fields(monkeypatch):
    """The OpDef fields the frontends read: env-backed attrs resolved at
    dispatch, the generator handed to a sampling op, infer_type,
    key_var_num_args and hidden."""
    def fn(data, flag=None, level=None):
        return data + (1 if flag else 0) + level
    op = preg.OpDef("probe", fn, attr_types={"flag": preg.parse_bool,
                                             "level": int},
                    env_attrs={"flag": ("MXNET_PROBE_FLAG", "0"),
                               "level": ("MXNET_PROBE_LEVEL", "2")})
    x = torch.zeros(2)
    monkeypatch.setenv("MXNET_PROBE_FLAG", "1")
    outs, _ = preg.imperative_invoke(op, [x], {})
    assert outs[0].tolist() == [3.0, 3.0]
    outs, _ = preg.imperative_invoke(op, [x], {"flag": False, "level": 5})
    assert outs[0].tolist() == [5.0, 5.0]
    monkeypatch.setenv("MXNET_PROBE_FLAG", "true")   # only "1" turns it on
    assert op.resolve_env_attrs({})["flag"] is False
    gen = torch.Generator().manual_seed(4)
    outs, sop = preg.imperative_invoke("_random_uniform", [],
                                       {"shape": (3,)}, rng=gen)
    want = torch.empty(3).uniform_(0.0, 1.0,
                                   generator=torch.Generator().manual_seed(4))
    assert sop.needs_rng and torch.equal(outs[0], want)
    cast = preg.get_op("Cast")
    assert cast.infer_type({"dtype": np.float16}, [np.float32])[1] == \
        [np.float16]
    assert preg.get_op("Concat").key_var_num_args == "num_args"
    assert preg.get_op("_state_init").hidden
    assert preg.get_op("_identity_with_attr_like_rhs").hidden
