"""SequentialModule, PythonModule and PythonLossModule of mxnet_tpu_torch
against mxnet_tpu's, then visualization and test_utils.

The fits: an MLP (144-16-4) split in two stages (take_labels,
auto_wiring) and the same MLP with a PythonLossModule head (grad_func
softmax - onehot, computed with numpy in both packages), two epochs of
SGD-momentum or Adam on the host from the same numpy parameters: each
parameter within FLOOR_X times the JAX package's float32 floor (its fit's
distance to its fit from parameters nudged by NUDGE).  print_summary's
text and plot_network's graph source are the JAX package's; the test_utils
checks pass and fail alike in both packages on the same symbols."""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
FLOOR_X = 4.0
FLOOR_MIN = 1e-6
NUDGE = 2.0 ** -20
OPTS = {"sgd": {"learning_rate": 0.05, "momentum": 0.9},
        "adam": {"learning_rate": 0.002}}


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.models  # noqa: F401
    import mxnet_tpu.test_utils  # noqa: F401
    import mxnet_tpu.visualization  # noqa: F401
    return mx


def _data(n=120, seed=0):
    rs = RS(seed)
    return (rs.randn(n, 144).astype(np.float32),
            rs.randint(0, 4, n).astype(np.float32))


def _params(seed=1, nudge=0.0):
    rs = RS(seed)
    out = {}
    for name, (fout, fin) in (("fc1", (16, 144)), ("fc2", (4, 16))):
        w = rs.uniform(-1, 1, (fout, fin)) * np.sqrt(3.0 / fin)
        out[name + "_weight"] = (w * (1 + nudge * rs.uniform(-1, 1, w.shape))
                                 ).astype(np.float32)
        out[name + "_bias"] = (rs.uniform(-0.1, 0.1, fout)
                               * (1 + nudge)).astype(np.float32)
    return out


def _softmax_grad(scores, labels):
    """softmax(scores) - onehot(labels), with numpy."""
    s = scores.asnumpy()
    lab = labels.asnumpy().astype(np.int64)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(p.shape[0]), lab] -= 1.0
    return p


def _chain(pkg, head, ctx=None):
    S = pkg.sym
    ctx = {"context": ctx or pkg.cpu()}
    h = S.Activation(S.FullyConnected(S.Variable("data"), num_hidden=16,
                                      name="fc1"), act_type="relu",
                     name="relu1")
    seq = pkg.module.SequentialModule()
    if head == "sequential":
        seq.add(pkg.module.Module(h, label_names=None, **ctx))
        top = S.SoftmaxOutput(S.FullyConnected(S.Variable("data"),
                                               num_hidden=4, name="fc2"),
                              name="softmax")
        seq.add(pkg.module.Module(top, **ctx), take_labels=True,
                auto_wiring=True)
    else:
        fc2 = S.FullyConnected(h, num_hidden=4, name="fc2")
        seq.add(pkg.module.Module(fc2, label_names=None, **ctx))
        seq.add(pkg.module.PythonLossModule(grad_func=_softmax_grad),
                take_labels=True, auto_wiring=True)
    return seq


def _fit(pkg, head, opt, args):
    x, y = _data()
    np.random.seed(3)
    it = pkg.io.NDArrayIter(x, y, batch_size=30, shuffle=True)
    mod = _chain(pkg, head)
    acc = pkg.metric.Accuracy()
    mod.fit(it, num_epoch=2, optimizer=opt, optimizer_params=dict(OPTS[opt]),
            eval_metric=acc,
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()}, aux_params={})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
        acc.get()[1]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("head", ["sequential", "python_loss"])
def test_chain_fit_matches_mxnet_tpu(mx, head, opt):
    args = _params()
    got, got_acc = _fit(mt, head, opt, args)
    want, want_acc = _fit(mx, head, opt, args)
    nudged, _ = _fit(mx, head, opt, _params(nudge=NUDGE))
    assert sorted(got) == sorted(want) == sorted(args)
    for k in want:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, \
            (k, _rel(got[k], want[k]), floor)
        assert _rel(got[k], args[k]) > 1e-4, k
    assert abs(got_acc - want_acc) <= 1.0 / 120 + 1e-12


def test_sequential_input_grads_match(mx):
    """One forward/backward of the two-stage chain bound with
    inputs_need_grad: outputs and the data gradient equal the JAX
    package's; the shapes and names thread through the stages."""
    x, y = _data(30)
    args = _params()
    res = []
    for pkg in (mt, mx):
        mod = _chain(pkg, "sequential")
        mod.bind(data_shapes=[("data", (30, 144))],
                 label_shapes=[("softmax_label", (30,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in args.items()},
                        aux_params={})
        assert mod.data_names == ["data"]
        assert mod.output_names == ["softmax_output"]
        assert [tuple(s[1]) for s in mod.output_shapes] == [(30, 4)]
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                                 label=[pkg.nd.array(y, ctx=pkg.cpu())])
        mod.forward(batch, is_train=True)
        mod.backward()
        res.append((mod.get_outputs()[0].asnumpy(),
                    mod.get_input_grads()[0].asnumpy()))
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_sequential_refusals():
    seq = mt.mod.SequentialModule()
    with pytest.raises(TypeError, match="unsupported option"):
        seq.add(mt.mod.PythonLossModule(), takes_labels=True)
    S = mt.sym
    for _ in range(2):
        seq.add(mt.mod.Module(S.FullyConnected(S.Variable("data"),
                                               num_hidden=4, name="fc"),
                              label_names=None, context=mt.cpu()),
                auto_wiring=True)
    seq.bind(data_shapes=[("data", (2, 4))])
    with pytest.raises(ValueError, match="both stage 0 and stage 1"):
        seq.init_params()


def test_python_loss_module_basics():
    """The scores pass through, the labels follow them to their context,
    grad_func's numpy result becomes an NDArray there; without grad_func
    the backward raises."""
    mod = mt.mod.PythonLossModule(grad_func=_softmax_grad)
    mod.bind(data_shapes=[("data", (3, 4))],
             label_shapes=[("softmax_label", (3,))])
    assert mod.output_shapes == [("pyloss_output", (3, 4))]
    mod.init_params()
    mod.init_optimizer()
    assert mod.get_params() == ({}, {})
    scores = mt.nd.array(RS(0).randn(3, 4), ctx=mt.cpu())
    labels = mt.nd.array([0.0, 3.0, 1.0], ctx=mt.cpu())
    mod.forward(mt.io.DataBatch(data=[scores], label=[labels]),
                is_train=True)
    assert mod.get_outputs()[0] is scores
    mod.backward()
    grad = mod.get_input_grads()[0]
    assert isinstance(grad, mt.nd.NDArray) and grad.context == mt.cpu()
    np.testing.assert_allclose(grad.asnumpy(),
                               _softmax_grad(scores, labels), rtol=1e-6)
    bare = mt.mod.PythonLossModule()
    bare.bind(data_shapes=[("data", (3, 4))],
              label_shapes=[("softmax_label", (3,))])
    bare.forward(mt.io.DataBatch(data=[scores], label=[labels]))
    with pytest.raises(NotImplementedError):
        bare.backward()


@pytest.mark.parametrize("net", ["resnet50", "lenet"])
def test_print_summary_text_matches(mx, capsys, net):
    syms = []
    for p in (mt, mx):
        # fresh name counters: the auto-named nodes (pooling0, ...) must
        # not depend on the symbols the process built before
        with p.name.NameManager():
            syms.append(p.models.resnet.get_symbol(1000, 50, "3,224,224")
                        if net == "resnet50"
                        else p.models.lenet.get_symbol(num_classes=10))
    shape = {"data": (1, 3, 224, 224) if net == "resnet50"
             else (1, 1, 28, 28)}
    totals, texts = [], []
    for pkg, sym in zip((mt, mx), syms):
        totals.append(pkg.viz.print_summary(sym, shape=shape))
        texts.append(capsys.readouterr().out)
    assert totals[0] == totals[1] > 0
    assert texts[0] == texts[1]
    assert "Total params: %d" % totals[0] in texts[0]


def test_plot_network_matches(mx, monkeypatch):
    pytest.importorskip("graphviz")
    net_mt = mt.models.lenet.get_symbol(num_classes=10)
    net_mx = mx.models.lenet.get_symbol(num_classes=10)
    shape = {"data": (1, 1, 28, 28)}
    for kw in ({}, {"shape": shape, "hide_weights": False}):
        got = mt.viz.plot_network(net_mt, title="lenet", **kw)
        want = mx.viz.plot_network(net_mx, title="lenet", **kw)
        assert got.source == want.source
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(ImportError, match="graphviz"):
        mt.viz.plot_network(net_mt)
    with pytest.raises(TypeError):
        mt.viz.print_summary("not a symbol")


def _block(S):
    return S.Activation(S.BatchNorm(S.Convolution(
        S.Variable("data"), num_filter=4, kernel=(3, 3), pad=(1, 1),
        name="conv"), fix_gamma=False, name="bn"), act_type="relu")


def test_test_utils_agree(mx):
    """The same checks on the same symbols pass in both packages; a wrong
    expectation fails in both; check_consistency draws the same arguments
    in both and the float32 run stays within its tolerance of float64."""
    x = RS(0).uniform(-1, 1, (3, 5)).astype(np.float32)
    w = RS(1).uniform(-1, 1, (2, 5)).astype(np.float32)
    b = np.zeros(2, np.float32)
    og = RS(2).uniform(-1, 1, (3, 2)).astype(np.float32)
    for pkg in (mt, mx):
        tu, S = pkg.test_utils, pkg.sym
        kw = {"ctx": pkg.cpu()}
        fc = S.FullyConnected(S.Variable("data"), num_hidden=2, name="fc")
        loc = {"data": x, "fc_weight": w, "fc_bias": b}
        tu.check_symbolic_forward(fc, loc, [x @ w.T], rtol=1e-5, **kw)
        tu.check_symbolic_backward(fc, loc, [og],
                                   {"data": og @ w, "fc_weight": og.T @ x},
                                   rtol=1e-5, **kw)
        with pytest.raises(AssertionError):
            tu.check_symbolic_forward(fc, loc, [x @ w.T + 1.0], **kw)
        tu.check_numeric_gradient(S.tanh(S.Variable("data")) * 2.0,
                                  {"data": x.astype(np.float64)},
                                  numeric_eps=1e-4, rtol=1e-2, **kw)
        with pytest.raises(AssertionError, match="not equal"):
            tu.assert_almost_equal(np.ones(3), np.zeros(3))
        assert tu.reldiff(np.ones(3), np.ones(3)) == 0
    f64 = {n: np.float64 for n in _block(mt.sym).list_arguments()}
    ctx_list = [{"ctx": None, "data": (2, 3, 6, 6), "type_dict": f64},
                {"ctx": None, "data": (2, 3, 6, 6)}]
    gts = []
    for pkg in (mt, mx):
        cl = [dict(c, ctx=pkg.cpu()) for c in ctx_list]
        gts.append(pkg.test_utils.check_consistency(_block(pkg.sym), cl))
    assert sorted(gts[0]) == sorted(gts[1])
    for k in gts[0]:
        if not k.startswith("__output__"):
            np.testing.assert_array_equal(gts[0][k], gts[1][k])
    np.testing.assert_allclose(gts[0]["__output__0"], gts[1]["__output__0"],
                               rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------- on the card
@pytest.mark.cuda
def test_check_consistency_cpu_gpu():
    """check_consistency over [cpu(0), gpu(0)] on a Convolution ->
    BatchNorm -> Activation block (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    shape = (4, 3, 12, 12)
    mt.test_utils.check_consistency(
        _block(mt.sym), [{"ctx": mt.cpu(0), "data": shape},
                         {"ctx": mt.gpu(0), "data": shape}])


@pytest.mark.cuda
def test_chain_on_the_card():
    """The two chains fit on gpu(0) within 1e-4 of the host's fit; the
    stages hand their gradients on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    os.environ.pop("MXNET_FUSED_FIT", None)
    for head in ("sequential", "python_loss"):
        x, y = _data()
        res = []
        for ctx in (mt.cpu(), mt.gpu(0)):
            mod = _chain(mt, head, ctx)
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=30), num_epoch=1,
                    optimizer_params=dict(OPTS["sgd"]),
                    arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in _params().items()},
                    aux_params={})
            res.append({k: v.asnumpy()
                        for k, v in mod.get_params()[0].items()})
        for k in res[0]:
            np.testing.assert_allclose(res[1][k], res[0][k], rtol=1e-4,
                                       atol=1e-6)
