"""The operator surface's ordering and ``misc`` ops in the port against
mxnet_tpu: topk, sort, argsort, choose_element_0index, fill_element_0index,
``_broadcast``, ``_onehot_encode``, IdentityAttachKLSparseReg,
``_slice_assign`` / ``_crop_assign``, ``_crop_assign_scalar`` and the
``Convolution_v1`` alias; and the registry, which holds every op of the JAX
package (``Custom`` since the custom-op bridge).

The parity cases feed the same float64 numpy inputs from a seed (JAX's x64
on) to the JAX op (forward, ``jax.vjp``) and the port's (forward,
``torch.autograd.grad``): forward and gradients within 1e-9 relative.
Ties, out-of-range and negative indices get cases of their own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import OPS as JOPS, get_op as jget_op
from mxnet_tpu_torch.ops.registry import OPS as POPS, get_op as pget_op
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-12)

# the JAX package's ops that a later part of the operator surface ports:
# none since the custom-op bridge brought ``Custom``
LATER = ()


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _ties(shape, seed):
    """Values on a grid of halves: many ties."""
    return np.round(np.random.RandomState(seed).randn(*shape) * 2) / 2


def _idx(vals):
    return np.asarray(vals, np.float64)


CASES = [
    # op, attrs, inputs (arrays, or shapes drawn from randn)
    ("topk", {"k": 3}, [_ties((4, 9), 1)]),
    ("topk", {"k": 3, "ret_typ": "value"}, [_ties((4, 9), 2)]),
    ("topk", {"k": 2, "ret_typ": "both", "axis": 0}, [_ties((5, 3, 2), 3)]),
    ("topk", {"k": 0, "ret_typ": "both", "is_ascend": True},
     [_ties((3, 7), 4)]),
    ("topk", {"k": 4, "ret_typ": "mask", "axis": 1}, [_ties((2, 6, 3), 5)]),
    ("topk", {"k": 20, "ret_typ": "value"}, [(3, 5)]),
    ("sort", {}, [_ties((4, 8), 6)]),
    ("sort", {"axis": 0, "is_ascend": False}, [_ties((6, 3), 7)]),
    ("sort", {"axis": None}, [_ties((3, 4), 8)]),
    ("argsort", {}, [_ties((4, 8), 9)]),
    ("argsort", {"axis": 0, "is_ascend": False}, [_ties((6, 3), 10)]),
    ("argsort", {"axis": None, "is_ascend": False}, [_ties((3, 4), 11)]),
    ("choose_element_0index", {}, [(3, 4), _idx([1, 0, 3])]),
    # out of range reads NaN; [-n, 0) wraps; fractions truncate toward 0
    ("choose_element_0index", {}, [(5, 4), _idx([4, -1, 7, -5, -0.5])]),
    ("choose_element_0index", {}, [(3, 4), _idx([1.7, -4, 2.9])]),
    ("fill_element_0index", {}, [(3, 4), (3,), _idx([1, 0, 3])]),
    # out of range drops the write
    ("fill_element_0index", {}, [(5, 4), (5,), _idx([4, -1, 7, -5, -4])]),
    ("_broadcast", {"axis": 0, "size": 3}, [(1, 4)]),
    ("_broadcast", {"axis": 2, "size": 5}, [(2, 3, 1)]),
    ("_onehot_encode", {}, [_idx([0, 2, 3, 1.7]), (4, 5)]),
    # out of range and negative give a zero row
    ("_onehot_encode", {}, [_idx([5, -1, -4, 100, 4]), (5, 5)]),
    ("_slice_assign", {"begin": (1, 1), "end": (3, 3)}, [(4, 4), (2, 2)]),
    ("_crop_assign", {"begin": (0, 2), "end": (2, 5)}, [(3, 6), (2, 3)]),
    ("_slice_assign", {"begin": (1,), "end": (3,)}, [(4, 3), (2, 3)]),
    ("_crop_assign_scalar", {"begin": (0, 0), "end": (2, 2), "scalar": 5.0},
     [(4, 4)]),
    ("_crop_assign_scalar", {"begin": (1, 0, 2), "end": (2, 3, 4)},
     [(3, 3, 5)]),
    ("Convolution_v1", {"kernel": (3, 3), "num_filter": 2, "pad": (1, 1)},
     [(2, 3, 5, 5), (2, 3, 3, 3), (2,)]),
]
IDS = ["%d-%s" % (i, c[0]) for i, c in enumerate(CASES)]


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [s if isinstance(s, np.ndarray) else rng.randn(*s)
            for s in shapes]


def _both(name, attrs, ins, is_train=False):
    """(port outputs, JAX outputs, port gradients, JAX gradients): every
    output of the op (visible, then the aux updates), the gradients of
    every input under one random cotangent of the visible outputs."""
    jop, pop = jget_op(name), pget_op(name)
    jcall = jop.make_callable(jop.normalize_attrs(attrs), is_train)
    pcall = pop.make_callable(pop.normalize_attrs(attrs), is_train)
    n_vis = pop.num_outputs_for(pop.normalize_attrs(attrs))

    def jfn(*a):
        out = jcall(*a)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)
    jall = jfn(*[jnp.asarray(a) for a in ins])
    jouts, vjp = jax.vjp(lambda *a: jfn(*a)[:n_vis],
                         *[jnp.asarray(a) for a in ins])
    rng = np.random.RandomState(99)
    cots = [rng.randn(*np.shape(o)) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    pins = [torch.tensor(a, requires_grad=True) for a in ins]
    pall = pcall(*pins)
    pall = tuple(pall) if isinstance(pall, (tuple, list)) else (pall,)
    vis = [o for o in pall[:n_vis] if o.requires_grad]
    pgrads = torch.autograd.grad(
        vis, pins, [torch.from_numpy(c) for c, o in zip(cots, pall)
                    if o.requires_grad], allow_unused=True) if vis \
        else [None] * len(pins)
    return pall, jall, pgrads, jgrads


def _same(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_backward_f64_match_mxnet_tpu(case, f64):
    name, attrs, shapes = case
    ins = _arrays(shapes, seed=len(IDS))
    pall, jall, pgrads, jgrads = _both(name, attrs, ins)
    assert len(pall) == len(jall)
    for p, j in zip(pall, jall):
        _same(p, j)
    for p, j in zip(pgrads, jgrads):
        _same(np.zeros_like(np.asarray(j)) if p is None else p, j)


@pytest.mark.parametrize("is_train", [False, True])
def test_kl_sparse_reg_matches_mxnet_tpu(is_train, f64):
    """IdentityAttachKLSparseReg: the identity forward, the moving average
    updated in training only, the penalty added to the gradient from the
    updated average in both modes."""
    rng = np.random.RandomState(3)
    ins = [rng.rand(6, 2, 3) * 0.8 + 0.1, rng.rand(6) * 0.5 + 0.2]
    attrs = {"sparseness_target": 0.2, "penalty": 0.1, "momentum": 0.7}
    pall, jall, pgrads, jgrads = _both("IdentityAttachKLSparseReg", attrs,
                                       ins, is_train)
    assert len(pall) == len(jall) == 2
    for p, j in zip(pall, jall):
        _same(p, j)
    _same(pgrads[0], jgrads[0])
    np.testing.assert_array_equal(pall[0].detach().numpy(), ins[0])
    moved = not np.allclose(pall[1].detach().numpy(), ins[1])
    assert moved == is_train


def test_infer_shape_matches_mxnet_tpu():
    for name, attrs, shapes in CASES + [
            ("IdentityAttachKLSparseReg", {}, [(4, 2, 3), (6,)])]:
        shapes = [np.shape(s) if isinstance(s, np.ndarray) else s
                  for s in shapes]
        jop, pop = jget_op(name), pget_op(name)
        jin, jouts, jaux = jop.infer_shape(jop.normalize_attrs(attrs),
                                           shapes)
        pin, pouts, paux = pop.infer_shape(pop.normalize_attrs(attrs),
                                           shapes)
        assert [tuple(s) for s in pouts] == [tuple(s) for s in jouts], name
        assert [tuple(s) for s in pin] == [tuple(s) for s in jin], name
        assert (paux and [tuple(s) for s in paux]) == \
            (jaux and [tuple(s) for s in jaux]), name


def test_registry_holds_every_op_but_the_later_parts():
    """The port registers every op name of the JAX package (``LATER``,
    the names a later part would port, is empty since the custom-op
    bridge), and nothing the JAX package lacks: the two registries are
    equal, 234 names each."""
    jnames, pnames = set(JOPS.list_names()), set(POPS.list_names())
    assert not pnames - jnames
    assert sorted(jnames - pnames) == sorted(LATER)
    assert jnames == pnames and len(pnames) == 234


def test_kl_sparse_reg_trains_its_moving_average_in_a_graph():
    """In a bound graph the training forward writes the updated average
    into the aux array (as BatchNorm's moving statistics), the inference
    forward leaves it; the data gradient carries the penalty, as the JAX
    package's ``test_identity_attach_kl_sparse_reg``."""
    x = np.random.RandomState(0).rand(6, 5).astype(np.float32) * 0.8 + 0.1
    net = mt.sym.IdentityAttachKLSparseReg(
        mt.sym.Variable("data"), sparseness_target=0.2, penalty=0.1,
        momentum=0.0, name="kl")
    assert net.list_auxiliary_states() == ["kl_moving_avg"]
    ex = net.simple_bind(mt.cpu(), data=x.shape, grad_req="write")
    ex.arg_dict["data"][:] = x
    ex.forward(is_train=False)
    np.testing.assert_array_equal(ex.aux_dict["kl_moving_avg"].asnumpy(), 0)
    out = ex.forward(is_train=True)[0].asnumpy()
    np.testing.assert_allclose(out, x, rtol=1e-6)
    ex.backward([mt.nd.ones(x.shape, ctx=mt.cpu())])
    mavg = x.mean(axis=0)
    np.testing.assert_allclose(ex.aux_dict["kl_moving_avg"].asnumpy(), mavg,
                               rtol=1e-6)
    want = 1.0 + 0.1 * (-0.2 / mavg + 0.8 / (1 - mavg))
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                               np.broadcast_to(want, x.shape), rtol=1e-4)


def test_slice_assign_leaves_lhs_unwritten():
    base = mt.nd.zeros((4, 4), ctx=mt.cpu())
    res = mt.nd._slice_assign(base, mt.nd.ones((2, 2), ctx=mt.cpu()),
                              begin=(1, 1), end=(3, 3))
    assert res.asnumpy().sum() == 4 and base.asnumpy().sum() == 0
    res = mt.nd._crop_assign(base, mt.nd.ones((1, 4), ctx=mt.cpu()),
                             begin=(3, 0), end=(4, 4))
    assert res.asnumpy()[3].sum() == 4 and base.asnumpy().sum() == 0


# ------------------------------------------- twins of the JAX package's tests
def RS(seed):
    return np.random.RandomState(seed)


def test_topk_sort_argsort():
    x = RS(0).rand(3, 8).astype(np.float32)
    a = mt.nd.array(x, ctx=mt.cpu())
    out = mt.nd.topk(a, k=3, ret_typ="indices").asnumpy()
    np.testing.assert_array_equal(out, np.argsort(-x, axis=1,
                                                  kind="stable")[:, :3])
    np.testing.assert_allclose(mt.nd.sort(a).asnumpy(), np.sort(x, axis=-1),
                               rtol=1e-6)
    np.testing.assert_array_equal(mt.nd.argsort(a).asnumpy(),
                                  np.argsort(x, -1, kind="stable"))


def test_topk_sort():
    """(``test_ndarray.py``'s twin) values, sort along an axis, and the
    tuple that ret_typ='both' gives, with indices in the data's dtype."""
    x = RS(1).rand(5, 10).astype(np.float32)
    a = mt.nd.array(x, ctx=mt.cpu())
    v = mt.nd.topk(a, k=3, ret_typ="value")
    np.testing.assert_allclose(v.asnumpy(), np.sort(x, 1)[:, ::-1][:, :3],
                               rtol=1e-6)
    s = mt.nd.sort(a, axis=1)
    np.testing.assert_allclose(s.asnumpy(), np.sort(x, 1), rtol=1e-6)
    vals, idx = mt.nd.topk(a, k=2, ret_typ="both", is_ascend=True)
    assert idx.dtype == np.float32
    np.testing.assert_allclose(vals.asnumpy(), np.sort(x, 1)[:, :2])
    np.testing.assert_array_equal(idx.asnumpy(), np.argsort(x, 1)[:, :2])


def test_topk_ties_list_the_later_index_first_when_descending():
    """Descending order reverses a stable ascending sort, as the JAX
    package's: among equal values the later index comes first, in the
    eager frontend as in the JAX package's."""
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)
    got = mt.nd.topk(mt.nd.array(x, ctx=mt.cpu()), k=3).asnumpy()
    want = mx.nd.topk(mx.nd.array(x), k=3).asnumpy()
    np.testing.assert_array_equal(got, [[4, 2, 1]])
    np.testing.assert_array_equal(got, want)
    got = mt.nd.argsort(mt.nd.array(x, ctx=mt.cpu()),
                        is_ascend=False).asnumpy()
    np.testing.assert_array_equal(got, [[4, 2, 1, 3, 0]])


def test_take_onehot():
    w = RS(2).rand(10, 4).astype(np.float32)
    idx = np.array([1, 3, 7], dtype=np.float32)
    c = mt.cpu()
    out = mt.nd.take(mt.nd.array(w, ctx=c), mt.nd.array(idx, ctx=c))
    np.testing.assert_allclose(out.asnumpy(), w[[1, 3, 7]], rtol=1e-6)
    oh = mt.nd.one_hot(mt.nd.array(idx, ctx=c), depth=10)
    assert oh.shape == (3, 10)
    assert oh.asnumpy()[1, 3] == 1.0
    oh = mt.nd._onehot_encode(mt.nd.array(idx, ctx=c),
                              mt.nd.zeros((3, 10), ctx=c))
    np.testing.assert_array_equal(oh.asnumpy(), np.eye(10)[[1, 3, 7]])


def test_choose_fill_element_0index():
    c = mt.cpu()
    a = mt.nd.array(np.arange(12).reshape(3, 4).astype(np.float32), ctx=c)
    idx = mt.nd.array(np.array([1, 0, 3], np.float32), ctx=c)
    picked = mt.nd.choose_element_0index(a, idx).asnumpy()
    np.testing.assert_array_equal(picked, [1, 4, 11])
    filled = mt.nd.fill_element_0index(
        a, mt.nd.array([9.0, 9.0, 9.0], ctx=c), idx).asnumpy()
    assert filled[0, 1] == 9 and filled[1, 0] == 9 and filled[2, 3] == 9
    assert filled[0, 0] == 0 and filled[2, 2] == 10


def test_broadcast_fun_and_slice_assign():
    c = mt.cpu()
    out = mt.nd._broadcast(mt.nd.ones((1, 4), ctx=c), axis=0, size=3)
    assert out.shape == (3, 4)
    base = mt.nd.zeros((4, 4), ctx=c)
    res = mt.nd._slice_assign(base, mt.nd.ones((2, 2), ctx=c), begin=(1, 1),
                              end=(3, 3))
    v = res.asnumpy()
    assert v[1:3, 1:3].sum() == 4 and v.sum() == 4
    res2 = mt.nd._crop_assign_scalar(base, begin=(0, 0), end=(2, 2),
                                     scalar=5.0)
    assert res2.asnumpy()[:2, :2].sum() == 20


def test_v1_convolution_alias_loads_from_mxnet_tpu_json():
    """A graph the JAX package writes with ``Convolution_v1`` loads in the
    port and computes the same output."""
    net = mx.sym.Convolution_v1(mx.sym.Variable("data"), num_filter=2,
                                kernel=(3, 3), name="c")
    rng = RS(4)
    args = {"data": rng.rand(1, 1, 8, 8).astype(np.float32),
            "c_weight": rng.rand(2, 1, 3, 3).astype(np.float32),
            "c_bias": rng.rand(2).astype(np.float32)}
    want = net.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in args.items()}
                    ).forward()[0].asnumpy()
    pnet = mt.sym.load_json(net.tojson())
    got = pnet.bind(mt.cpu(), {k: mt.nd.array(v, ctx=mt.cpu())
                               for k, v in args.items()}
                    ).forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
