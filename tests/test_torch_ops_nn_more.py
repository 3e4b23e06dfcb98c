"""The operator surface's ``nn`` ops in the port against mxnet_tpu:
LeakyReLU (leaky, elu, prelu, rrelu), Deconvolution, InstanceNorm,
L2Normalization, LRN, UpSampling, softmax and log_softmax.

Each case feeds the same numpy inputs from a seed, in float64 with JAX's
x64 on, to the JAX op (forward and ``jax.vjp``) and to the port's (forward
and ``torch.autograd.grad``), with one output cotangent; forward and every
gradient agree within 1e-9 relative (TOL).  The traps get cases of their
own: the kink of LeakyReLU at exactly 0, Deconvolution's ``adj`` at and
past the stride (where PyTorch's ``output_padding`` refuses) and its
``target_shape``, LRN channel-last, ``temperature=0``.  Then shape
inference, rrelu by its statistics, LeakyReLU's prelu gamma starting at
0.25, and twins of the JAX package's tests of these ops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _kink(shape, seed):
    """randn with a quarter of the entries exactly 0."""
    x = np.random.RandomState(seed).randn(*shape)
    x.flat[::4] = 0.0
    return x


def _deconv(attrs, data, weight, bias=False):
    shapes = [data, weight] + ([(weight[1] * attrs.get("num_group", 1),)]
                               if bias else [])
    return ("Deconvolution", dict(attrs, no_bias=not bias), shapes)


CASES = [
    # op, attrs, input shapes (or arrays)
    ("LeakyReLU", {"act_type": "leaky", "slope": 0.2}, [_kink((3, 4, 5), 1)]),
    ("LeakyReLU", {"act_type": "elu", "slope": 0.3}, [_kink((3, 4, 5), 2)]),
    ("LeakyReLU", {"act_type": "prelu"}, [_kink((2, 3, 4, 4), 3), (3,)]),
    ("LeakyReLU", {"act_type": "rrelu"}, [_kink((4, 6), 4)]),
    ("LeakyReLU", {}, [_kink((4, 6), 5)]),
    _deconv({"kernel": (4, 4), "num_filter": 8}, (2, 6, 1, 1), (6, 8, 4, 4)),
    _deconv({"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
             "num_filter": 3}, (2, 5, 4, 4), (5, 3, 4, 4)),
    _deconv({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "adj": (1, 1), "num_filter": 3}, (2, 4, 5, 5), (4, 3, 3, 3),
            bias=True),
    # adj at and past the stride: PyTorch's output_padding refuses these
    _deconv({"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "adj": (2, 3), "num_filter": 2}, (1, 3, 4, 5), (3, 2, 3, 3),
            bias=True),
    _deconv({"kernel": (3, 3), "pad": (0, 1), "adj": (1, 2),
             "num_filter": 2}, (1, 3, 4, 4), (3, 2, 3, 3)),
    _deconv({"kernel": (3, 3), "stride": (1, 1), "dilate": (2, 2),
             "num_filter": 2}, (1, 2, 4, 4), (2, 2, 3, 3)),
    _deconv({"kernel": (3, 3), "stride": (2, 2), "num_group": 2,
             "num_filter": 4}, (2, 6, 3, 3), (6, 2, 3, 3), bias=True),
    _deconv({"kernel": (4, 4), "stride": (2, 2), "target_shape": (8, 8),
             "num_filter": 3}, (1, 2, 4, 4), (2, 3, 4, 4)),
    # odd overshoot: pad rounds up, the remainder goes to adj
    _deconv({"kernel": (3, 3), "stride": (2, 2), "target_shape": (8, 8),
             "num_filter": 1}, (1, 2, 4, 4), (2, 1, 3, 3)),
    # stride 1, odd overshoot: adj 1 is not below the stride
    _deconv({"kernel": (4, 4), "target_shape": (6, 6), "num_filter": 2},
            (1, 2, 4, 4), (2, 2, 4, 4)),
    _deconv({"kernel": (3,), "stride": (3,), "pad": (1,), "num_filter": 2},
            (2, 3, 5), (3, 2, 3), bias=True),
    _deconv({"kernel": (2, 3, 2), "stride": (2, 1, 2), "num_filter": 2},
            (1, 3, 2, 3, 2), (3, 2, 2, 3, 2)),
    ("InstanceNorm", {}, [(2, 3, 5, 4), (3,), (3,)]),
    ("InstanceNorm", {"eps": 1e-5}, [(2, 3, 6), (3,), (3,)]),
    ("L2Normalization", {}, [(3, 4, 5)]),
    ("L2Normalization", {"mode": "channel"}, [(2, 3, 4, 5)]),
    ("L2Normalization", {"mode": "spatial"}, [(2, 3, 4, 5)]),
    ("LRN", {"nsize": 5}, [(2, 7, 3, 4)]),
    ("LRN", {"nsize": 3, "alpha": 1e-2, "beta": 0.6, "knorm": 1.5},
     [(2, 5, 4, 4)]),
    ("LRN", {"nsize": 5, "alpha": 1e-2, "layout": "NHWC"}, [(2, 3, 4, 7)]),
    ("UpSampling", {"scale": 2, "sample_type": "nearest", "num_args": 1},
     [(2, 3, 3, 4)]),
    ("UpSampling", {"scale": 3, "sample_type": "bilinear", "num_args": 1},
     [(1, 2, 3, 4)]),
    ("UpSampling", {"scale": 2, "sample_type": "nearest", "num_args": 2,
                    "multi_input_mode": "concat"}, [(1, 2, 4, 4),
                                                     (1, 3, 2, 2)]),
    ("UpSampling", {"scale": 2, "sample_type": "nearest", "num_args": 2,
                    "multi_input_mode": "sum"}, [(1, 2, 2, 3), (1, 2, 4, 6)]),
    ("UpSampling", {"scale": 2, "sample_type": "bilinear", "num_args": 2,
                    "multi_input_mode": "sum"}, [(1, 2, 3, 3), (1, 2, 2, 2)]),
    ("softmax", {}, [(3, 5)]),
    ("softmax", {"axis": 1, "temperature": 2.5}, [(2, 4, 3)]),
    ("softmax", {"axis": 0, "temperature": 0.0}, [(4, 3)]),
    ("log_softmax", {}, [(3, 5)]),
    ("log_softmax", {"axis": -2, "temperature": 0.5}, [(2, 4, 3)]),
    ("log_softmax", {"temperature": 0}, [(3, 6)]),
]
IDS = ["%d-%s" % (i, c[0]) for i, c in enumerate(CASES)]


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [s if isinstance(s, np.ndarray) else rng.randn(*s)
            for s in shapes]


def both(name, attrs, ins, is_train=False, cot_seed=99):
    """(port outputs, JAX outputs, port gradients, JAX gradients) of op
    ``name`` at float64 inputs ``ins``, the gradients of every input under
    one random cotangent of the visible outputs."""
    jop, pop = jget_op(name), pget_op(name)
    jcall = jop.make_callable(jop.normalize_attrs(attrs), is_train)
    pcall = pop.make_callable(pop.normalize_attrs(attrs), is_train)
    n_vis = pop.num_outputs_for(pop.normalize_attrs(attrs))

    def jfn(*a):
        out = jcall(jax.random.PRNGKey(0), *a) if jop.needs_rng \
            else jcall(*a)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return tuple(out[:n_vis])
    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in ins])
    rng = np.random.RandomState(cot_seed)
    cots = [rng.randn(*np.shape(o)) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    pins = [torch.tensor(a, requires_grad=True) for a in ins]
    pout = pcall(torch.Generator().manual_seed(0), *pins) if pop.needs_rng \
        else pcall(*pins)
    pout = tuple(pout if isinstance(pout, (tuple, list)) else (pout,))
    pout = pout[:n_vis]
    pgrads = torch.autograd.grad(
        pout, pins, [torch.from_numpy(c) for c in cots], allow_unused=True)
    return pout, jouts, pgrads, jgrads


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_backward_f64_match_mxnet_tpu(case, f64):
    name, attrs, shapes = case
    ins = _arrays(shapes, seed=len(IDS))
    pout, jout, pgrads, jgrads = both(name, attrs, ins)
    assert len(pout) == len(jout)
    for p, j in zip(pout, jout):
        assert p.dtype == torch.float64 and tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **TOL)
    for i, (p, j) in enumerate(zip(pgrads, jgrads)):
        want = np.asarray(j)
        got = np.zeros_like(want) if p is None else p.numpy()
        np.testing.assert_allclose(got, want, err_msg="input %d" % i, **TOL)


def test_leaky_relu_gradient_at_the_kink_is_the_slope():
    """At exactly 0 the gradient is the slope, not 1: both packages keep x
    only where x > 0."""
    x = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    for act, slope in (("leaky", 0.2), ("elu", 0.3), ("rrelu", None)):
        y = mt.ops.registry.imperative_invoke(
            "LeakyReLU", [x], {"act_type": act, "slope": slope or 0.25})[0][0]
        (g,) = torch.autograd.grad(y.sum(), x)
        want = (0.125 + 0.334) / 2 if act == "rrelu" else slope
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-12)


# graph shape inference runs in the logical NCHW layout
INFER = [(i, c) for i, c in zip(IDS, CASES) if "layout" not in c[1]]


@pytest.mark.parametrize("case", [c for _, c in INFER],
                         ids=[i for i, _ in INFER])
def test_infer_shape_matches_mxnet_tpu(case):
    name, attrs, shapes = case
    shapes = [np.shape(s) if isinstance(s, np.ndarray) else s
              for s in shapes]
    jop, pop = jget_op(name), pget_op(name)
    given = [shapes[0]] + [None] * (len(shapes) - 1) \
        if name != "UpSampling" else shapes
    jin, jouts, _ = jop.infer_shape(jop.normalize_attrs(attrs), given)
    pin, pouts, _ = pop.infer_shape(pop.normalize_attrs(attrs), given)
    assert [tuple(s) if s else s for s in pouts] == \
        [tuple(s) if s else s for s in jouts]
    assert [tuple(s) if s else s for s in pin] == \
        [tuple(s) if s else s for s in jin]


@pytest.mark.parametrize("bad", [{"target_shape": (8,)},
                                 {"target_shape": (100, 100)}])
def test_deconv_bad_target_shape_raises_like_mxnet_tpu(bad):
    """A target of the wrong rank or above the largest output fails at
    shape inference and at run time in both packages."""
    data = (1, 2, 4, 4)
    for sym, err in ((mx.sym, mx.MXNetError), (mt.sym, mt.MXNetError)):
        net = sym.Deconvolution(sym.Variable("data"), kernel=(3, 3),
                                stride=(2, 2), num_filter=2, name="dc", **bad)
        with pytest.raises(err):
            net.infer_shape(data=data)
    op = pget_op("Deconvolution")
    call = op.make_callable(op.normalize_attrs(dict(
        kernel=(3, 3), stride=(2, 2), num_filter=2, **bad)), False)
    with pytest.raises(mt.MXNetError):
        call(torch.zeros(data), torch.zeros(2, 2, 3, 3))


def test_rrelu_training_draws_slopes_in_bounds():
    """rrelu in training: every negative input is scaled by its own slope
    from [lower, upper), the slopes' mean near the midpoint (5 standard
    deviations of a uniform over 2^16 draws); positives pass; two draws
    differ; outside training the midpoint."""
    lo, hi = 0.1, 0.4
    x = -torch.ones(1 << 16, dtype=torch.float64)
    x[::2] = 2.0
    attrs = {"act_type": "rrelu", "lower_bound": lo, "upper_bound": hi}
    (y,), _ = mt.ops.registry.imperative_invoke("LeakyReLU", [x], attrs,
                                                is_train=True)
    s = -y[1::2]
    assert torch.equal(y[::2], x[::2])
    assert float(s.min()) >= lo and float(s.max()) < hi
    sd = (hi - lo) / 12 ** 0.5 / len(s) ** 0.5
    assert abs(float(s.mean()) - (lo + hi) / 2) < 5 * sd
    (y2,), _ = mt.ops.registry.imperative_invoke("LeakyReLU", [x], attrs,
                                                 is_train=True)
    assert not torch.equal(y, y2)
    (y3,), _ = mt.ops.registry.imperative_invoke("LeakyReLU", [x], attrs)
    np.testing.assert_allclose(-y3[1::2].numpy(), (lo + hi) / 2, rtol=1e-12)


def test_prelu_gamma_starts_at_a_quarter_as_in_mxnet_tpu():
    """The gamma variable that composition creates carries the op's
    ``__init__`` (Constant 0.25), so a Module initialises it to 0.25
    whatever the initializer, as in the JAX package."""
    for sym in (mx.sym, mt.sym):
        net = sym.LeakyReLU(sym.Variable("data"), act_type="prelu",
                            name="act")
        assert net.list_arguments() == ["data", "act_gamma"]
        assert net.attr_dict()["act_gamma"]["__init__"] == \
            '["Constant", {"value": 0.25}]'
    mod = mt.Module(mt.sym.LeakyReLU(mt.sym.Variable("data"),
                                     act_type="prelu", name="act"),
                    label_names=None, context=mt.cpu())
    mod.bind(data_shapes=[("data", (2, 5, 3, 3))])
    mod.init_params(mt.initializer.Normal(1.0))
    g = mod.get_params()[0]["act_gamma"].asnumpy()
    np.testing.assert_array_equal(g, np.full(5, 0.25, np.float32))
    # an explicit gamma input takes no __init__
    net = mt.sym.LeakyReLU(mt.sym.Variable("data"),
                           gamma=mt.sym.Variable("g"), act_type="prelu")
    assert "__init__" not in net.attr_dict().get("g", {})


def test_lrn_nhwc_equals_nchw():
    """LRN on channel-last data (the executor's pass) equals LRN on the
    same values channel-first, forward and gradient."""
    x = torch.randn(2, 9, 5, 6, dtype=torch.float64, requires_grad=True)
    op = pget_op("LRN")
    attrs = op.normalize_attrs({"nsize": 5, "alpha": 0.3})
    a = op.make_callable(attrs, False)(x)
    xl = x.detach().permute(0, 2, 3, 1).contiguous().requires_grad_()
    b = op.make_callable(dict(attrs, layout="NHWC"), False)(xl)
    np.testing.assert_allclose(b.permute(0, 3, 1, 2).detach().numpy(),
                               a.detach().numpy(), **TOL)
    g = torch.randn_like(a)
    (ga,) = torch.autograd.grad(a, x, g)
    (gb,) = torch.autograd.grad(b, xl, g.permute(0, 2, 3, 1))
    np.testing.assert_allclose(gb.permute(0, 3, 1, 2).numpy(), ga.numpy(),
                               **TOL)


# ------------------------------------------- twins of the JAX package's tests
def RS(seed):
    return np.random.RandomState(seed)


def _run(net, args, grad=False, out_grads=None):
    """Bind ``net`` on the CPU to ``args`` (numpy), forward, and backward
    with ``out_grads`` (ones by default) when ``grad``; returns (outputs,
    the gradients by name)."""
    nd = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in args.items()}
    gr = {k: mt.nd.zeros(v.shape, ctx=mt.cpu()) for k, v in args.items()} \
        if grad else None
    ex = net.bind(mt.cpu(), nd, args_grad=gr,
                  grad_req="write" if grad else "null")
    outs = [o.asnumpy() for o in ex.forward(is_train=grad)]
    if grad:
        ex.backward(out_grads or [mt.nd.ones(o.shape, ctx=mt.cpu())
                                  for o in outs])
        return outs, {k: v.asnumpy() for k, v in gr.items()}
    return outs, None


def _numeric_grad(net, args, name, eps=1e-3):
    """Central differences of sum(outputs) in ``args[name]`` (float64)."""
    base = {k: v.astype(np.float64) for k, v in args.items()}
    x = base[name]
    g = np.zeros_like(x)
    for i in range(x.size):
        for sgn in (1, -1):
            x.flat[i] += sgn * eps
            nd = {k: mt.nd.array(v, ctx=mt.cpu(), dtype=np.float64)
                  for k, v in base.items()}
            out = net.bind(mt.cpu(), nd, grad_req="null").forward()
            g.flat[i] += sgn * sum(float(o.asnumpy().sum()) for o in out)
            x.flat[i] -= sgn * eps
    return g / (2 * eps)


def _check_numeric(net, args, rtol, atol):
    """The autograd gradient of sum(outputs), in float32, against central
    differences in float64, for every argument."""
    _, grads = _run(net, args, grad=True)
    for name in args:
        np.testing.assert_allclose(grads[name], _numeric_grad(net, args,
                                                              name),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_deconvolution_shape_inverse():
    x = mt.nd.zeros((1, 3, 5, 5), ctx=mt.cpu())
    conv = mt.nd.Convolution(x, mt.nd.zeros((4, 3, 3, 3), ctx=mt.cpu()),
                             mt.nd.zeros((4,), ctx=mt.cpu()), kernel=(3, 3),
                             stride=(2, 2), pad=(1, 1), num_filter=4)
    deconv = mt.nd.Deconvolution(conv, mt.nd.zeros((4, 3, 3, 3),
                                                   ctx=mt.cpu()),
                                 kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                 num_filter=3, no_bias=True, adj=(0, 0))
    assert deconv.shape[2] in (5, 4)


def test_lrn_l2norm_instance_norm():
    x = RS(0).rand(2, 4, 3, 3).astype(np.float32)
    c = mt.cpu()
    out = mt.nd.LRN(mt.nd.array(x, ctx=c), nsize=3, alpha=1e-4, beta=0.75,
                    knorm=2.0).asnumpy()
    assert out.shape == x.shape
    out = mt.nd.L2Normalization(mt.nd.array(x, ctx=c),
                                mode="instance").asnumpy()
    flat = x.reshape(2, -1)
    np.testing.assert_allclose(
        out.reshape(2, -1),
        flat / np.sqrt((flat ** 2).sum(1, keepdims=True) + 1e-10), rtol=1e-4)
    out = mt.nd.InstanceNorm(mt.nd.array(x, ctx=c), mt.nd.ones((4,), ctx=c),
                             mt.nd.zeros((4,), ctx=c), eps=1e-5).asnumpy()
    m = x.mean(axis=(2, 3), keepdims=True)
    v = x.var(axis=(2, 3), keepdims=True)
    np.testing.assert_allclose(out, (x - m) / np.sqrt(v + 1e-5), rtol=1e-3,
                               atol=1e-4)


def test_upsampling_nearest():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)
    out = mt.nd.UpSampling(mt.nd.array(x, ctx=mt.cpu()), scale=2,
                           sample_type="nearest").asnumpy()
    np.testing.assert_array_equal(out[0, 0],
                                  np.kron(x[0, 0], np.ones((2, 2))))


def test_v1_op_aliases():
    data = mt.sym.Variable("data")
    c = mt.sym.Convolution_v1(data, num_filter=2, kernel=(3, 3), name="c")
    ex = c.simple_bind(mt.cpu(), data=(1, 1, 8, 8))
    assert ex.forward()[0].shape == (1, 2, 6, 6)
    p = mt.sym.Pooling_v1(data, kernel=(2, 2), stride=(2, 2))
    assert p.infer_shape(data=(1, 1, 8, 8))[1][0] == (1, 1, 4, 4)


def _bf16_sweep(net, tol, scale=1.0, **shapes):
    """The bfloat16 graph's outputs and data gradient against the float32
    graph's from the same inputs and output gradient (the JAX package's
    ``_sweep`` across dtypes), within ``tol`` of the float32 values'
    scale.  The output gradient is random: under ones a softmax's input
    gradient is 0 but for rounding."""
    arg_shapes, out_shapes, _ = net.infer_shape(**shapes)
    rng = RS(0)
    args = {n: rng.randn(*s).astype(np.float32) * scale
            for n, s in zip(net.list_arguments(), arg_shapes)}
    heads = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    res = {}
    for dt in ("float32", "bfloat16"):
        nd = {k: mt.nd.array(v, ctx=mt.cpu(), dtype=dt)
              for k, v in args.items()}
        gr = {k: mt.nd.zeros(v.shape, ctx=mt.cpu(), dtype=dt)
              for k, v in args.items()}
        ex = net.bind(mt.cpu(), nd, args_grad=gr)
        outs = ex.forward(is_train=True)
        assert str(outs[0].dtype) == dt
        ex.backward([mt.nd.array(h, ctx=mt.cpu(), dtype=dt)
                     for h in heads])
        res[dt] = ([o.asnumpy().astype(np.float32) for o in outs],
                   gr["data"].asnumpy().astype(np.float32))
    (o32, g32), (o16, g16) = res["float32"], res["bfloat16"]
    for a, b in zip(o16, o32):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    np.testing.assert_allclose(g16, g32, rtol=tol,
                               atol=tol * np.abs(g32).max())


def test_bf16_deconvolution():
    net = mt.sym.Deconvolution(mt.sym.Variable("data"), kernel=(3, 3),
                               num_filter=5, stride=(2, 2), name="deconv")
    _bf16_sweep(net, 5e-2, scale=0.1, data=(2, 3, 7, 7))


@pytest.mark.parametrize("act", ["leaky", "elu"])
def test_bf16_leaky_relu(act):
    net = mt.sym.LeakyReLU(mt.sym.Variable("data"), act_type=act)
    _bf16_sweep(net, 2e-2, data=(4, 10))


def test_bf16_softmax_family():
    data = mt.sym.Variable("data")
    _bf16_sweep(mt.sym.softmax(data, axis=-1), 2e-2, data=(4, 10))
    _bf16_sweep(mt.sym.log_softmax(data, axis=-1), 2e-2, data=(4, 10))


def test_bf16_norm_family():
    data = mt.sym.Variable("data")
    _bf16_sweep(mt.sym.LRN(data, nsize=3), 2e-2, data=(2, 6, 5, 5))
    _bf16_sweep(mt.sym.L2Normalization(data), 2e-2, data=(4, 10))
    _bf16_sweep(mt.sym.InstanceNorm(data, name="in"), 5e-2,
                data=(2, 3, 6, 6))


def test_softmax_axis_semantics():
    d = RS(0).rand(2, 3, 4).astype(np.float32)
    for axis in (0, 1, 2, -1):
        net = mt.sym.softmax(mt.sym.Variable("data"), axis=axis)
        out = _run(net, {"data": d})[0][0]
        e = np.exp(d - d.max(axis=axis, keepdims=True))
        np.testing.assert_allclose(out, e / e.sum(axis=axis, keepdims=True),
                                   rtol=1e-5, atol=1e-6)


def test_upsampling_backward():
    net = mt.sym.UpSampling(mt.sym.Variable("data"), scale=2,
                            sample_type="nearest", num_args=1)
    _check_numeric(net, {"data": RS(0).rand(1, 2, 3, 3).astype(np.float32)},
                   rtol=2e-2, atol=2e-3)


def test_leaky_relu_modes_grad():
    data = mt.sym.Variable("data")
    d = (RS(0).rand(4, 5).astype(np.float32) - 0.5) * 2
    for act in ("leaky", "elu"):
        net = mt.sym.LeakyReLU(data, act_type=act, slope=0.3)
        _check_numeric(net, {"data": d}, rtol=2e-2, atol=2e-3)
    net = mt.sym.LeakyReLU(data, gamma=mt.sym.Variable("gamma"),
                           act_type="prelu")
    _check_numeric(net, {"data": d, "gamma": np.full(5, 0.25, np.float32)},
                   rtol=2e-2, atol=2e-3)


def test_lrn_numeric_gradient():
    net = mt.sym.LRN(mt.sym.Variable("data"), nsize=3, alpha=1e-3, beta=0.75)
    _check_numeric(net, {"data": RS(0).rand(2, 5, 2, 2).astype(np.float32)},
                   rtol=2e-2, atol=2e-3)


def test_l2norm_modes():
    d = RS(0).rand(2, 3, 4).astype(np.float32) + 0.1
    for mode, axes in (("instance", (1, 2)), ("channel", (1,)),
                       ("spatial", (2,))):
        net = mt.sym.L2Normalization(mt.sym.Variable("data"), mode=mode)
        out = _run(net, {"data": d})[0][0]
        norm = np.sqrt((d * d).sum(axis=axes, keepdims=True) + 1e-10)
        np.testing.assert_allclose(out, d / norm, rtol=1e-5, atol=1e-6)


def test_deconv_target_shape():
    data = mt.sym.Variable("data")
    net = mt.sym.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                               num_filter=3, target_shape=(8, 8),
                               name="deconv")
    _, out_shapes, _ = net.infer_shape(data=(1, 2, 4, 4))
    assert tuple(out_shapes[0]) == (1, 3, 8, 8)
    ex = net.simple_bind(mt.cpu(), data=(1, 2, 4, 4))
    assert ex.forward()[0].shape == (1, 3, 8, 8)
    net2 = mt.sym.Deconvolution(data, kernel=(3, 3), stride=(2, 2),
                                num_filter=1, target_shape=(8, 8),
                                name="deconv")
    net3 = mt.sym.Deconvolution(data, kernel=(3, 3), stride=(2, 2),
                                num_filter=1, pad=(1, 1), adj=(1, 1),
                                name="deconv")
    args = {"data": RS(0).rand(1, 2, 4, 4).astype(np.float32),
            "deconv_weight": RS(1).rand(2, 1, 3, 3).astype(np.float32)}
    o2 = _run(net2, args)[0][0]
    o3 = _run(net3, args)[0][0]
    assert o2.shape == (1, 1, 8, 8)
    np.testing.assert_allclose(o2, o3, rtol=1e-6, atol=1e-7)


def test_instance_norm_numeric_gradient():
    net = mt.sym.square(mt.sym.InstanceNorm(
        mt.sym.Variable("data"), mt.sym.Variable("gamma"),
        mt.sym.Variable("beta"), name="in"))
    _check_numeric(net, {"data": RS(0).rand(2, 3, 6).astype(np.float32),
                         "gamma": np.ones(3, np.float32),
                         "beta": RS(1).rand(3).astype(np.float32)},
                   rtol=3e-2, atol=3e-3)


def test_deconv_dilate_and_target_shape_validation():
    net = mt.sym.Deconvolution(mt.sym.Variable("data"), kernel=(3, 3),
                               stride=(1, 1), dilate=(2, 2), num_filter=2,
                               name="dc")
    _, out_shapes, _ = net.infer_shape(data=(1, 2, 4, 4))
    assert tuple(out_shapes[0]) == (1, 2, 8, 8)
    _check_numeric(net, {"data": RS(0).rand(1, 2, 4, 4).astype(np.float32),
                         "dc_weight": RS(1).rand(2, 2, 3, 3).astype(
                             np.float32)}, rtol=2e-2, atol=2e-3)
