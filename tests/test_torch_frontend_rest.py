"""The rest of the symbol frontend in the port against mxnet_tpu, on the
CPU: ``Symbol.attr`` / ``_set_attr`` / ``debug_str`` / ``grad`` / ``eval``,
``Executor.debug_str``, the backward half of shape inference (the
FullyConnected rule: a data shape deduced from the output and a shared
weight), ``name.Prefix``, ``Context.devtype2str`` / ``devstr2type`` /
``device_typeid`` / ``default_ctx`` and the top-level ``opt`` alias."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _both(mx):
    return (("port", mt), ("jax", mx))


def _net(pkg):
    with pkg.name.NameManager():
        data = pkg.sym.Variable("data", attr={"mood": "calm"})
        fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
        act = pkg.sym.Activation(fc, act_type="relu")
        return pkg.sym.SoftmaxOutput(act, name="softmax")


def test_attr_and_set_attr_match_mxnet_tpu(mx):
    """``attr`` reads a single output's node attribute (None for a group
    or an unset key); ``_set_attr`` writes it; ``attr_dict`` sees both."""
    got = {}
    for tag, pkg in _both(mx):
        net = _net(pkg)
        data = net.get_internals()["data"]
        fc = net.get_internals()["fc_output"]
        fc._set_attr(ctx_note="a", lr_note="2")
        group = pkg.sym.Group([data, fc])
        got[tag] = (data.attr("mood"), data.attr("nothing"),
                    fc.attr("ctx_note"), group.attr("mood"),
                    net.attr_dict()["fc"])
    assert got["port"] == got["jax"]
    assert got["port"][:4] == ("calm", None, "a", None)


def test_debug_str_matches_mxnet_tpu(mx):
    """One line a node in walk order; the executor's is its symbol's."""
    strs = {}
    for tag, pkg in _both(mx):
        net = _net(pkg)
        ex = net.simple_bind(pkg.cpu(), data=(2, 3))
        assert ex.debug_str() == net.debug_str()
        strs[tag] = net.debug_str()
    assert strs["port"] == strs["jax"]
    assert strs["port"].splitlines()[0] == "Variable data()"
    assert "FullyConnected fc(data, fc_weight, fc_bias)" in strs["port"]


def test_grad_is_refused(mx):
    for _, pkg in _both(mx):
        with pytest.raises(pkg.MXNetError, match="deprecated"):
            _net(pkg).grad(["data"])


def test_eval_matches_mxnet_tpu(mx):
    """``eval`` binds the given arrays and runs one inference forward."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.full((2, 3), 0.5, np.float32)
    got = []
    for _, pkg in _both(mx):
        x, y = pkg.sym.Variable("x"), pkg.sym.Variable("y")
        outs = (x * y + x).eval(ctx=pkg.cpu(),
                                x=pkg.nd.array(a, ctx=pkg.cpu()),
                                y=pkg.nd.array(b, ctx=pkg.cpu()))
        assert len(outs) == 1
        got.append(outs[0].asnumpy())
    np.testing.assert_array_equal(got[0], a * b + a)
    np.testing.assert_array_equal(got[0], got[1])


def _shared_fc(pkg, h_attr=None):
    """fc0(data) + fc1(h) with one weight: h's shape has no forward rule,
    only the FullyConnected backward rule deduces it."""
    S = pkg.sym
    w = S.Variable("w")
    data = S.Variable("data")
    h = S.Variable("h", attr=h_attr)
    fc0 = S.FullyConnected(data, weight=w, num_hidden=8, no_bias=True,
                           name="fc0")
    fc1 = S.FullyConnected(h, weight=w, num_hidden=8, no_bias=True,
                           name="fc1")
    return fc0 + fc1


@pytest.mark.parametrize("h_attr", [None, {"__shape__": "(0, 5)"}],
                         ids=["unknown", "batch-unknown"])
def test_fc_backward_shape_inference_matches_mxnet_tpu(mx, h_attr):
    """An input no forward rule reaches gets its shape from the output and
    the weight, (4, 5), in both packages; ``simple_bind`` then binds."""
    got = []
    for _, pkg in _both(mx):
        net = _shared_fc(pkg, h_attr)
        args, outs, _ = net.infer_shape(data=(4, 5))
        assert dict(zip(net.list_arguments(), args)) == {
            "w": (8, 5), "data": (4, 5), "h": (4, 5)}
        assert outs == [(4, 8)]
        net.simple_bind(pkg.cpu(), data=(4, 5))
        got.append((args, outs))
    assert got[0] == got[1]


def test_fc_backward_rule_itself():
    """The rule alone: a weight gives a 2-D data shape; a known data shape
    with batch 0 takes the output's batch; no output, nothing."""
    rule = mt.ops.registry.get_op("FullyConnected").infer_shape_backward
    assert rule({}, [(4, 8)], [None, (8, 5)]) == [(4, 5), None]
    assert rule({}, [(4, 8)], [(0, 2, 3), None]) == [(4, 2, 3), None]
    assert rule({}, [None], [None, (8, 5)]) == [None, None]


def test_name_prefix_matches_mxnet_tpu(mx):
    """``name.Prefix`` prepends its prefix to every generated name; a name
    given by the caller is prefixed too, as in the reference."""
    got = []
    for _, pkg in _both(mx):
        with pkg.name.Prefix("stage1_"):
            a = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                       num_hidden=3)
            b = pkg.sym.Activation(a, act_type="relu", name="act")
        got.append((b.list_arguments(), b.name, a.name))
    assert got[0] == got[1]
    assert got[0][1:] == ("stage1_act", "stage1_fullyconnected0")


def test_context_names_match_mxnet_tpu(mx):
    """The device type ids of the four contexts the port has (cpu_pinned,
    id 3, and tpu, id 4, the card, raise when resolved without a card), and
    ``default_ctx`` (the current context)."""
    for dt in ("cpu", "gpu", "cpu_pinned", "tpu"):
        pc, jc = mt.Context(dt, 1), mx.Context(dt, 1)
        assert pc.device_typeid == jc.device_typeid
        assert mt.Context.devstr2type[dt] == mx.Context.devstr2type[dt]
        assert mt.Context.devtype2str[pc.device_typeid] == dt == \
            mx.Context.devtype2str[jc.device_typeid]
    assert set(mt.Context.devstr2type) == {"cpu", "gpu", "cpu_pinned",
                                           "tpu"}
    assert mt.tpu(1) == mt.Context("tpu", 1) != mt.gpu(1)
    assert mt.tpu().device_typeid == mx.tpu().device_typeid == 4
    assert mt.cpu_pinned(0) == mt.Context("cpu_pinned", 0)
    assert mt.cpu_pinned().device_typeid == 3
    with mt.cpu(0):
        assert mt.gpu(1).default_ctx == mt.cpu(0)
    assert mt.cpu().default_ctx == mt.gpu(0)
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="needs a CUDA device"):
            mt.cpu_pinned().torch_device()
        with pytest.raises(mt.MXNetError, match="needs a CUDA device"):
            mt.tpu().torch_device()
    else:
        assert mt.tpu(0).torch_device() == mt.gpu(0).torch_device()
    with pytest.raises(mt.MXNetError):
        mt.Context("npu", 0)


def test_top_level_aliases(mx):
    """``mt.opt`` is the optimizer module, as ``mx.opt``; ``operator`` and
    ``name`` are importable from the top level."""
    assert mt.opt is mt.optimizer and mx.opt is mx.optimizer
    assert mt.opt.SGD is mt.optimizer.SGD
    assert mt.operator.CustomOp and mt.name.Prefix
