"""The custom-op bridge of the port (``operator.py``, the ``Custom`` op of
``ops/custom.py``) against mxnet_tpu's, on the CPU: the twin of
tests/python/unittest/test_custom_op.py (imperative, symbolic, in a
composed graph, shape inference), each value also against the JAX
package's; ``CustomOp.assign``'s four requests and its sources; one
instance shared by forward and backward; a two-input, two-output op's
gradients in float64 against the JAX package's graph of the same math;
the op under the executor's NHWC pass, handed channel-first tensors; and
the softmax head of MXNet's ``example/numpy-ops/custom_softmax.py``
(numpy forward, backward ``p - onehot``, ``need_top_grad=False``)
trained through ``Module.fit``, fused and general, against the JAX
package's fit and the port's fit of the same net with ``SoftmaxOutput``.

Both packages register their own props under the same names (``twin_*``,
apart from the JAX package's own test's ``sqr``): each user class calls
its own package's ``nd``."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
F64 = dict(rtol=1e-9, atol=1e-12)
# the fits' float32 floor rule (test_torch_module.py): each parameter within
# FLOOR_X times the distance of the JAX package's fit from its fit from
# parameters nudged by NUDGE, FLOOR_MIN at least
FLOOR_X = 4.0
FLOOR_MIN = 1e-6
NUDGE = 2.0 ** -20
# (shape, contiguous) of each input the port's ``sqr`` forward was handed
SEEN = []


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


@pytest.fixture
def f64():
    import jax
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _register(pkg, created=None):
    """Register, in ``pkg``, the twin test's ``sqr``, a two-input
    two-output ``addmul`` and the example's ``softmax`` head (as
    ``twin_sqr``, ``twin_addmul``, ``twin_softmax``); ``created``
    collects (op_type, ctx, shapes) of every ``create_operator``."""
    op = pkg.operator
    nd = pkg.nd
    log = created if created is not None else []

    class Sqr(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            if pkg is mt:
                SEEN.append((in_data[0].shape,
                             in_data[0].value.is_contiguous()))
            self.x = in_data[0]
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            # the input stashed by this instance's forward
            self.assign(in_grad[0], req[0], 2 * self.x * out_grad[0])

    @op.register("twin_sqr")
    class SqrProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            log.append(("twin_sqr", ctx, [tuple(s) for s in in_shapes]))
            return Sqr()

    class AddMul(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a + b)
            self.assign(out_data[1], req[1], a * b * self.scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data
            gs, gp = out_grad
            self.assign(in_grad[0], req[0], gs + gp * b * self.scale)
            self.assign(in_grad[1], req[1], gs + gp * a * self.scale)

    @op.register("twin_addmul")
    class AddMulProp(op.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["lhs", "rhs"]

        def list_outputs(self):
            return ["sum", "prod"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            inst = AddMul()
            inst.scale = self.scale
            return inst

    class Softmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = np.array(out_data[0].asnumpy())  # a writable copy
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], nd.array(y))

    @op.register("twin_softmax")
    class SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()
    return log


@pytest.fixture
def created(mx):
    log = []
    _register(mx)
    _register(mt, log)
    return log


# ------------------------------------------------- twin of test_custom_op.py
def test_custom_imperative(mx, created):
    x = np.array([1.0, 2.0, 3.0], np.float32)
    y = mt.nd.Custom(mt.nd.array(x, ctx=mt.cpu()), op_type="twin_sqr")
    want = mx.nd.Custom(mx.nd.array(x), op_type="twin_sqr").asnumpy()
    np.testing.assert_allclose(y.asnumpy(), [1, 4, 9], rtol=1e-6)
    np.testing.assert_array_equal(y.asnumpy(), want)
    assert created == [("twin_sqr", mt.cpu(), [(3,)])]


def test_custom_symbolic_forward_backward(mx, created):
    got = []
    for pkg in (mt, mx):
        y = pkg.sym.Custom(pkg.sym.Variable("data"), op_type="twin_sqr",
                           name="sqr0")
        ex = y.bind(pkg.cpu(), {"data": pkg.nd.array([1.0, 2.0, 3.0],
                                                      ctx=pkg.cpu())},
                    args_grad={"data": pkg.nd.zeros((3,), ctx=pkg.cpu())})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=pkg.nd.array([1.0, 1.0, 1.0], ctx=pkg.cpu()))
        got.append((out, ex.grad_dict["data"].asnumpy()))
    np.testing.assert_allclose(got[0][0], [1, 4, 9], rtol=1e-6)
    np.testing.assert_allclose(got[0][1], [2, 4, 6], rtol=1e-6)
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


def test_custom_in_composed_graph(mx, created):
    """Custom feeding a FullyConnected: the gradient chains through both
    (d/dx w . x^2 = 2 w x), equal to the JAX package's."""
    got = []
    for pkg in (mt, mx):
        sq = pkg.sym.Custom(pkg.sym.Variable("data"), op_type="twin_sqr")
        fc = pkg.sym.FullyConnected(sq, num_hidden=1, no_bias=True,
                                    name="fc")
        ex = fc.bind(pkg.cpu(), {
            "data": pkg.nd.array([[1.0, 2.0]], ctx=pkg.cpu()),
            "fc_weight": pkg.nd.array([[3.0, 4.0]], ctx=pkg.cpu())},
            args_grad={"data": pkg.nd.zeros((1, 2), ctx=pkg.cpu()),
                       "fc_weight": pkg.nd.zeros((1, 2), ctx=pkg.cpu())})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=pkg.nd.ones((1, 1), ctx=pkg.cpu()))
        got.append((out, ex.grad_dict["data"].asnumpy(),
                    ex.grad_dict["fc_weight"].asnumpy()))
    np.testing.assert_allclose(got[0][0], [[3 + 16]], rtol=1e-6)
    np.testing.assert_allclose(got[0][1], [[6.0, 16.0]], rtol=1e-6)
    np.testing.assert_allclose(got[0][2], [[1.0, 4.0]], rtol=1e-6)
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


def test_custom_shape_inference(mx, created):
    for pkg in (mt, mx):
        y = pkg.sym.Custom(pkg.sym.Variable("data"), op_type="twin_sqr")
        _, out_shapes, _ = y.infer_shape(data=(4, 5))
        assert out_shapes[0] == (4, 5)
        two = pkg.sym.Custom(pkg.sym.Variable("a"), pkg.sym.Variable("b"),
                             op_type="twin_addmul", name="am")
        assert two.list_outputs() == ["am_output0", "am_output1"]
        assert two.list_arguments() == ["a", "b"]
        args, outs, _ = two.infer_shape(a=(2, 3), b=(2, 3))
        assert args == [(2, 3), (2, 3)] and outs == [(2, 3), (2, 3)]
        # the prop's rule runs once every input is known
        assert two.infer_shape(a=(2, 3)) == (None, None, None)
        head = pkg.sym.Custom(pkg.sym.Variable("data"),
                              op_type="twin_softmax", name="sm")
        assert head.list_arguments() == ["data", "sm_label"]
        assert head.infer_shape(data=(5, 10), sm_label=(5,))[1] == [(5, 10)]


def test_registry_holds_custom():
    """``Custom`` is a registered op with the frontends of every op, and
    an unregistered op_type is refused by name."""
    assert "Custom" in mt.ops.registry.OPS.list_names()
    assert callable(mt.nd.Custom) and callable(mt.sym.Custom)
    with pytest.raises(mt.MXNetError, match="not registered"):
        mt.sym.Custom(mt.sym.Variable("data"), op_type="no_such_op_here")


# ------------------------------------------------------------------- assign
@pytest.mark.parametrize("req", ["write", "inplace", "add", "null"])
def test_assign_requests(req):
    """write and inplace overwrite, add accumulates, null leaves dst;
    the source may be an NDArray, a numpy array, a tensor or a scalar."""
    op = mt.operator.CustomOp()
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    src = np.full((2, 3), 10.0, np.float32)
    want = {"write": src, "inplace": src, "add": base + src,
            "null": base}[req]
    for given in (mt.nd.array(src, ctx=mt.cpu()), src,
                  torch.from_numpy(src), 10.0):
        dst = mt.nd.array(base, ctx=mt.cpu())
        before = dst.value
        op.assign(dst, req, given)
        np.testing.assert_array_equal(dst.asnumpy(), want)
        assert dst.value is before          # in place
    with pytest.raises(mt.MXNetError):
        op.assign(mt.nd.array(base, ctx=mt.cpu()), "bogus", src)


def test_assign_source_of_another_dtype_and_a_view():
    """A float64 source lands at dst's dtype; a view's write reaches its
    base."""
    op = mt.operator.CustomOp()
    base = mt.nd.zeros((4, 3), ctx=mt.cpu())
    op.assign(base[1:3], "write", np.ones((2, 3), np.float64))
    assert base.dtype == np.float32
    np.testing.assert_array_equal(base.asnumpy()[:, 0], [0, 1, 1, 0])


# ---------------------------------------------------------- instance cache
def test_instance_shared_by_forward_and_backward(created):
    """One create_operator a set of (attrs, shapes, dtypes): the training
    forward and the backward of a bind share it (Sqr's backward reads the
    input its forward stashed on self); another shape makes another, and
    registering the name again drops the cache."""
    x = np.array([[1.0, -2.0, 3.0]], np.float32)
    y = mt.sym.Custom(mt.sym.Variable("data"), op_type="twin_sqr")
    for _ in range(2):
        ex = y.bind(mt.cpu(), {"data": mt.nd.array(x, ctx=mt.cpu())},
                    args_grad={"data": mt.nd.zeros((1, 3), ctx=mt.cpu())})
        ex.forward(is_train=True)
        ex.backward(out_grads=mt.nd.ones((1, 3), ctx=mt.cpu()))
        np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), 2 * x)
    assert len(created) == 1
    mt.nd.Custom(mt.nd.zeros((2, 2), ctx=mt.cpu()), op_type="twin_sqr")
    assert [c[2] for c in created] == [[(1, 3)], [(2, 2)]]
    _register(mt, created)
    mt.nd.Custom(mt.nd.zeros((2, 2), ctx=mt.cpu()), op_type="twin_sqr")
    assert len(created) == 3


# ------------------------------------------------- gradients in float64
def test_two_output_op_grads_match_mxnet_tpu(mx, created, f64):
    """``addmul`` (scale 0.5) with a head gradient on each output, float64:
    the port's outputs and input gradients equal the analytic ones and
    the JAX package's graph of the same math in built-in ops (``a + b``,
    ``a * b * 0.5``) within 1e-9; the op's NDArrays keep float64 (the JAX
    package's own Custom computes in float32: its callback wraps each
    array with ``nd.array``)."""
    rng = RS(0)
    a, b = rng.randn(3, 4), rng.randn(3, 4)
    g0, g1 = rng.randn(3, 4), rng.randn(3, 4)
    got = []
    for pkg in (mt, mx):
        va, vb = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        am = pkg.sym.Custom(va, vb, op_type="twin_addmul", scale=0.5,
                            name="am") if pkg is mt else \
            pkg.sym.Group([va + vb, va * vb * 0.5])
        nd = pkg.nd
        ex = am.bind(pkg.cpu(), {
            "a": nd.array(a, ctx=pkg.cpu(), dtype=np.float64),
            "b": nd.array(b, ctx=pkg.cpu(), dtype=np.float64)},
            args_grad={"a": nd.zeros((3, 4), ctx=pkg.cpu(), dtype=np.float64),
                       "b": nd.zeros((3, 4), ctx=pkg.cpu(),
                                     dtype=np.float64)})
        outs = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward(out_grads=[nd.array(g, ctx=pkg.cpu(), dtype=np.float64)
                               for g in (g0, g1)])
        got.append(outs + [ex.grad_dict["a"].asnumpy(),
                           ex.grad_dict["b"].asnumpy()])
    assert got[0][0].dtype == np.float64
    np.testing.assert_allclose(got[0][0], a + b, **F64)
    np.testing.assert_allclose(got[0][1], a * b * 0.5, **F64)
    np.testing.assert_allclose(got[0][2], g0 + g1 * b * 0.5, **F64)
    np.testing.assert_allclose(got[0][3], g0 + g1 * a * 0.5, **F64)
    for p, j in zip(*got):
        np.testing.assert_allclose(p, j, **F64)


def _conv_custom_net(pkg, custom=True):
    """conv -> BatchNorm -> relu -> Custom(sqr) -> conv -> sum: the Custom
    between two convolutions of the NHWC pass (``square`` in its place
    without ``custom``)."""
    S = pkg.sym
    h = S.Convolution(S.Variable("data"), num_filter=4, kernel=(3, 3),
                      pad=(1, 1), no_bias=True, name="c1")
    h = S.BatchNorm(h, fix_gamma=False, name="bn1")
    h = S.Activation(h, act_type="relu")
    h = S.Custom(h, op_type="twin_sqr", name="sq") if custom else \
        S.square(h, name="sq")
    h = S.Convolution(h, num_filter=3, kernel=(1, 1), no_bias=True,
                      name="c2")
    return S.MakeLoss(S.sum(h))


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_custom_under_layout_pass(mx, created, f64, layout, monkeypatch):
    """In a conv block under MXNET_CONV_LAYOUT (the executor's NHWC pass
    by default) the Custom op is handed contiguous channel-first tensors
    of its inferred shape; the data and weight gradients equal, within
    1e-9 in float64, the JAX package's for the same graph with ``square``
    in place of the Custom op (its own Custom computes in float32)."""
    monkeypatch.setenv("MXNET_CONV_LAYOUT", layout)
    rng = RS(1)
    shapes = {"data": (2, 3, 5, 5)}
    vals = {"data": rng.randn(2, 3, 5, 5), "c1_weight": rng.randn(4, 3, 3, 3),
            "bn1_gamma": rng.rand(4) + 0.5, "bn1_beta": rng.randn(4),
            "c2_weight": rng.randn(3, 4, 1, 1)}
    del SEEN[:]
    got = []
    for pkg in (mt, mx):
        net = _conv_custom_net(pkg, custom=pkg is mt)
        names = net.list_arguments()
        ex = net.simple_bind(pkg.cpu(), grad_req="write",
                             type_dict={n: np.float64 for n in names},
                             **shapes)
        for n, v in vals.items():
            ex.arg_dict[n][:] = v
        ex.forward(is_train=True)
        ex.backward()
        got.append({n: ex.grad_dict[n].asnumpy() for n in names})
    assert SEEN == [((2, 4, 5, 5), True)]
    for n in got[1]:
        np.testing.assert_allclose(got[0][n], got[1][n], **F64)


# -------------------------------------------- the need_top_grad=False head
def _mlp(pkg, head):
    """custom_softmax.py's MLP (128, 64, 10 classes) with the Custom
    softmax head or SoftmaxOutput."""
    S = pkg.sym
    data = S.Variable("data")
    h = S.Activation(S.FullyConnected(data, name="fc1", num_hidden=128),
                     name="relu1", act_type="relu")
    h = S.Activation(S.FullyConnected(h, name="fc2", num_hidden=64),
                     name="relu2", act_type="relu")
    h = S.FullyConnected(h, name="fc3", num_hidden=10)
    if head == "custom":
        return S.Custom(h, S.Variable("softmax_label"), name="softmax",
                        op_type="twin_softmax")
    return S.SoftmaxOutput(h, name="softmax")


def _mlp_params(seed=1, nudge=0.0):
    rs = RS(seed)
    out = {}
    for n, s in (("fc1_weight", (128, 144)), ("fc1_bias", (128,)),
                 ("fc2_weight", (64, 128)), ("fc2_bias", (64,)),
                 ("fc3_weight", (10, 64)), ("fc3_bias", (10,))):
        v = rs.uniform(-1, 1, s) * np.sqrt(3.0 / (s[1] if len(s) > 1
                                                  else 64))
        out[n] = (v * (1 + nudge * rs.uniform(-1, 1, s))).astype(np.float32)
    return out


def _mlp_fit(pkg, head, fused, params):
    """Two epochs of SGD-momentum over 120 rows in batches of 30: the
    parameters after them as numpy, and whether the fused path ran."""
    rs = RS(0)
    x = rs.rand(120, 144).astype(np.float32)
    y = rs.randint(0, 10, 120).astype(np.float32)
    old = os.environ.get("MXNET_FUSED_FIT")
    os.environ["MXNET_FUSED_FIT"] = "1" if fused else "0"
    try:
        mod = pkg.Module(_mlp(pkg, head), context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=30), num_epoch=2,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "rescale_grad": 1.0 / 30},
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in params.items()}, aux_params={})
    finally:
        if old is None:
            os.environ.pop("MXNET_FUSED_FIT", None)
        else:
            os.environ["MXNET_FUSED_FIT"] = old
    args, _ = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            getattr(mod, "_fused_ts_cache", None) is not None)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("path", ["fused", "general"])
def test_custom_softmax_head_fit_matches_mxnet_tpu(mx, created, path):
    """The Custom head trains with no head gradient supplied: each
    parameter after the fit within the float32 floor rule of the JAX
    package's fit of the net with SoftmaxOutput (the head's gradient,
    p - onehot) and of the port's own SoftmaxOutput fit.  The JAX side
    fits SoftmaxOutput, not its Custom op: its callback calls back into
    JAX (``nd.zeros``, ``nd.array``) while the batch loop dispatches the
    next step, which can deadlock its CPU runtime."""
    fused = path == "fused"
    params = _mlp_params()
    got, took_fused = _mlp_fit(mt, "custom", fused, params)
    assert took_fused == fused
    want, _ = _mlp_fit(mx, "softmax_output", fused, params)
    nudged, _ = _mlp_fit(mx, "softmax_output", fused,
                         _mlp_params(nudge=NUDGE))
    plain, _ = _mlp_fit(mt, "softmax_output", fused, params)
    assert sorted(got) == sorted(want) == sorted(plain)
    for k in want:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, (k, floor)
        assert _rel(got[k], plain[k]) <= FLOOR_X * floor, (k, floor)
        assert _rel(got[k], params[k]) > 10 * FLOOR_X * floor, k   # trained


def test_custom_head_in_train_step(created):
    """A TrainStep over the Custom head (seeded with ones, which the head
    ignores) moves the parameters as the SoftmaxOutput net's does."""
    params = _mlp_params()
    rs = RS(2)
    batch = {"data": rs.rand(30, 144).astype(np.float32),
             "softmax_label": rs.randint(0, 10, 30).astype(np.float32)}
    got = []
    for head in ("custom", "softmax_output"):
        ts = mt.TrainStep(_mlp(mt, head), mt.optimizer.SGD(
            learning_rate=0.1, rescale_grad=1.0 / 30), ctx=mt.cpu())
        p, s, a = mt.convert.train_state_from_numpy(
            params, {n: () for n in params}, {}, ctx=mt.cpu())
        p, s, a, outs = ts(p, s, a, ts.shard_batch(batch))
        got.append(({n: v.numpy() for n, v in p.items()}, outs[0].numpy()))
    for n in params:
        np.testing.assert_allclose(got[0][0][n], got[1][0][n], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-5, atol=1e-7)
