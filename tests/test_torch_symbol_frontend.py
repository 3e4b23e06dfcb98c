"""The Symbol frontend of mxnet_tpu_torch against mxnet_tpu's: the
arithmetic operators (``-``, ``*``, ``/``, ``**``, unary minus and the scalar
and reflected forms), variadic composition (``Concat(d, e)``,
``Concat([d, e])``, ``ElementWiseSum(d, e)``: the op's ``num_args`` filled in
from its inputs), ``d(e)`` refused as re-composition, and ``var`` with the
training attributes of ``Variable``.  Each graph is built in both packages
under a fresh NameManager and compared by names, attributes and, in
float64, by its values and gradients."""
import numpy as np
import pytest

import mxnet_tpu_torch as mt

TOL = 1e-12

EXPRS = {
    "mul": lambda d, e: d * e,
    "sub": lambda d, e: d - e,
    "div": lambda d, e: d / e,
    "pow": lambda d, e: d ** e,
    "neg": lambda d, e: -d + e,
    "sub_scalar": lambda d, e: d - 1 + e,
    "rsub_scalar": lambda d, e: 1 - d + e,
    "mul_scalar": lambda d, e: d * 2.5 + e,
    "rmul_scalar": lambda d, e: 2.5 * d + e,
    "div_scalar": lambda d, e: d / 4 + e,
    "rdiv_scalar": lambda d, e: 3 / d + e,
    "pow_scalar": lambda d, e: d ** 3 + e,
    "add_scalar": lambda d, e: (d + 1) * (2 + e),
    "lstm_state": lambda d, e: d * e + (1.0 - d) * (e - d),
}


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    jax.config.update("jax_enable_x64", True)
    yield mx
    jax.config.update("jax_enable_x64", False)


def _build(pkg, fn):
    with pkg.name.NameManager():
        return fn(pkg.sym.Variable("d"), pkg.sym.var("e"))


def _run(pkg, net):
    rs = np.random.RandomState(0)
    vals = {"d": rs.uniform(0.5, 2.0, (2, 3)), "e": rs.uniform(0.5, 2.0,
                                                               (2, 3))}
    ctx = pkg.cpu()
    names = net.list_arguments()
    grads = {n: pkg.nd.zeros((2, 3), ctx=ctx, dtype=np.float64)
             for n in names}
    ex = net.bind(ctx, {n: pkg.nd.array(vals[n], ctx=ctx, dtype=np.float64)
                        for n in names}, args_grad=grads)
    out = ex.forward(is_train=True)[0]
    head = rs.randn(*out.shape)
    ex.backward([pkg.nd.array(head, ctx=ctx, dtype=np.float64)])
    return out.asnumpy(), {n: g.asnumpy() for n, g in grads.items()}


def _same_graph(got, want):
    assert got.list_arguments() == want.list_arguments()
    assert got.list_outputs() == want.list_outputs()
    assert got.attr_dict() == want.attr_dict()


@pytest.mark.parametrize("expr", sorted(EXPRS))
def test_arithmetic_matches_mxnet_tpu(expr, jx):
    got, want = _build(mt, EXPRS[expr]), _build(jx, EXPRS[expr])
    _same_graph(got, want)
    (g_out, g_grad), (w_out, w_grad) = _run(mt, got), _run(jx, want)
    np.testing.assert_allclose(g_out, w_out, rtol=TOL, atol=TOL)
    for n in w_grad:
        np.testing.assert_allclose(g_grad[n], w_grad[n], rtol=TOL, atol=TOL,
                                   err_msg=n)


COMPOSE = {
    "concat_positional": lambda s, d, e: s.Concat(d, e, dim=1),
    "concat_list": lambda s, d, e: s.Concat([d, e], dim=1),
    "concat_three": lambda s, d, e: s.Concat(d, e, d * e, dim=0),
    "concat_named": lambda s, d, e: s.Concat(arg0=d, arg1=e, dim=1),
    "elementwise_sum": lambda s, d, e: s.ElementWiseSum(d, e, d),
    "add_n_list": lambda s, d, e: s.add_n(*[d, e], name="total"),
}


@pytest.mark.parametrize("form", sorted(COMPOSE))
def test_variadic_composition_matches_mxnet_tpu(form, jx):
    def fn(pkg):
        return lambda d, e: COMPOSE[form](pkg.sym, d, e)
    got, want = _build(mt, fn(mt)), _build(jx, fn(jx))
    _same_graph(got, want)
    (g_out, g_grad), (w_out, w_grad) = _run(mt, got), _run(jx, want)
    np.testing.assert_allclose(g_out, w_out, rtol=TOL, atol=TOL)
    for n in w_grad:
        np.testing.assert_allclose(g_grad[n], w_grad[n], rtol=TOL, atol=TOL)


def test_unfed_variadic_input_is_refused_as_in_mxnet_tpu(jx):
    for pkg in (mt, jx):
        d, e = pkg.sym.Variable("d"), pkg.sym.Variable("e")
        with pytest.raises(pkg.MXNetError, match="unexpected inputs"):
            pkg.sym.Concat(data=[d, e], dim=1)


def test_call_is_refused_as_recomposition():
    d, e = mt.sym.Variable("d"), mt.sym.Variable("e")
    with pytest.raises(mt.MXNetError, match="re-composition"):
        d(e)
    with pytest.raises(mt.MXNetError, match="re-composition"):
        (d * e)(data=e)


def test_var_and_variable_attributes_match_mxnet_tpu(jx):
    assert mt.sym.var is mt.sym.Variable
    kw = dict(shape=(3, 4), lr_mult=0.5, wd_mult=2.0, dtype="float16",
              init=mt.init.Xavier(factor_type="in", magnitude=2.34))
    got = mt.sym.var("w", **kw)
    want = jx.sym.var("w", **dict(kw, init=jx.init.Xavier(
        factor_type="in", magnitude=2.34)))
    assert got.attr_dict() == want.attr_dict()
    assert mt.sym.Variable("b", init="[\"zero\", {}]").attr_dict() == \
        {"b": {"__init__": "[\"zero\", {}]"}}
