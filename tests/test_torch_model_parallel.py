"""``group2ctx`` model parallelism in mxnet_tpu_torch against mxnet_tpu's, on
the CPU.

- Twins of tests/python/unittest/test_model_parallel.py: a chain split over
  two groups, outputs and gradients of the placed bind against the unplaced
  one and against the JAX package's placed bind; a placed graph trained 30
  SGD steps, losses and parameters against the JAX package's.
- The ``lstm_unroll`` of examples/model_parallel_lstm.py (the JAX package's
  graph) and its twin in ``bench/model_parallel_lstm.py``, at 2 layers,
  width 16, ``seq_len`` 5 and 20 words, under {layer0: cpu(0), layer1:
  cpu(1)}: outputs and every gradient against the JAX package and the
  port's unplaced bind; three steps of the example's SGD loop against the
  JAX package's.
- ``simple_bind`` and ``Symbol.bind`` with ``group2ctx`` (each argument
  and gradient on its group's context, aux states on the bind context),
  ``shared_exec``, a JAX-written JSON with ``ctx_group`` attributes and a
  ``_CrossDeviceCopy`` node, the top-level names.
- ``cpu(0)`` and ``cpu(1)`` are one torch device: ``cross_device_copies``
  stays 0.  The placed walk itself (moves, autograd across them, peepholes
  kept inside one device, the head gradients, the aux write-back) runs on
  the host with ``cpu(1)`` resolved to ``torch.device("cpu", 1)``, which
  torch treats as another device in comparisons but computes on the host.
- On the card (``cuda`` marker): the twin's two-device plan on
  [gpu(0), cpu()], its copies against the count its group boundaries imply.

Tolerances, float32 as the JAX test's: outputs rtol 1e-5, gradients rtol
1e-4 (atol 1e-6); the same walk with and without placement, bit for bit.
Parameters come from a numpy seed and reach both packages through a
``.params`` file.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor as exm
from mxnet_tpu_torch.bench import model_parallel_lstm as mpl
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
OUT_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LSTM = dict(num_layers=2, seq_len=5, num_hidden=16, num_embed=16,
            vocab_size=20, batch=4)
INPUTS = ("data", "softmax_label")
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "model_parallel_lstm.py")


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _example(mx):
    spec = importlib.util.spec_from_file_location("mp_lstm_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(pkg, arrays, tmp_path):
    """The numpy ``arrays`` through a ``.params`` file written by the port
    and read by ``pkg``, as {name: NDArray}."""
    fname = str(tmp_path / "state.params")
    if not os.path.exists(fname):
        mt.nd.save(fname, {k: mt.nd.array(v, ctx=mt.cpu())
                           for k, v in arrays.items()})
    return pkg.nd.load(fname, ctx=mt.cpu()) if pkg is mt else \
        pkg.nd.load(fname)


def _chain(pkg):
    with pkg.AttrScope(ctx_group="dev1"):
        data = pkg.sym.Variable("data")
        fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act1 = pkg.sym.Activation(fc1, act_type="tanh")
    with pkg.AttrScope(ctx_group="dev2"):
        fc2 = pkg.sym.FullyConnected(act1, num_hidden=8, name="fc2")
        out = pkg.sym.Activation(fc2, act_type="tanh")
    return out


def _chain_arrays(seed=0):
    net = _chain(mt)
    shapes, _, _ = net.infer_shape(data=(4, 10))
    rs = RS(seed)
    return {n: rs.uniform(-1, 1, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)}


def _run_chain(pkg, arrays, group2ctx):
    net = _chain(pkg)
    args = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in arrays.items()}
    grads = {k: pkg.nd.zeros(v.shape, pkg.cpu()) for k, v in arrays.items()}
    ex = net.bind(pkg.cpu(), args, args_grad=grads, group2ctx=group2ctx)
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([pkg.nd.ones((4, 8), pkg.cpu())])
    return out, {k: v.asnumpy() for k, v in grads.items()}


def _close_all(got, want, what):
    out, grads = got
    np.testing.assert_allclose(out, want[0], rtol=OUT_RTOL,
                               err_msg=what + " output")
    for k in want[1]:
        np.testing.assert_allclose(grads[k], want[1][k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=what + " " + k)


def test_chain_two_devices(mx):
    """(twin: test_model_parallel.py test_chain_two_devices)"""
    arrays = _chain_arrays()
    before = exm.cross_device_copies
    plain = _run_chain(mt, arrays, None)
    placed = _run_chain(mt, arrays, {"dev1": mt.cpu(0), "dev2": mt.cpu(1)})
    jax_placed = _run_chain(mx, arrays, {"dev1": mx.cpu(0),
                                         "dev2": mx.cpu(1)})
    # one walk either way: bit for bit
    np.testing.assert_array_equal(placed[0], plain[0])
    for k in plain[1]:
        np.testing.assert_array_equal(placed[1][k], plain[1][k])
    _close_all(placed, jax_placed, "port vs JAX placed")
    # cpu(0) and cpu(1) are one torch device: nothing moved
    assert exm.cross_device_copies == before


def _softmax_net(pkg):
    with pkg.AttrScope(ctx_group="dev1"):
        data = pkg.sym.Variable("data")
        fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act = pkg.sym.Activation(fc1, act_type="relu")
    with pkg.AttrScope(ctx_group="dev2"):
        fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
        return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def test_group2ctx_training(mx, tmp_path):
    """(twin: test_group2ctx_training) 30 SGD steps of a placed graph:
    the loss falls below 0.7 of its first value, and the losses and final
    parameters match the JAX package's run within 1e-4 relative."""
    rs = RS(0)
    x = rs.randn(40, 10).astype(np.float32)
    centers = rs.randn(4, 10).astype(np.float32) * 2
    y = rs.randint(0, 4, 40).astype(np.float32)
    x = x + centers[y.astype(int)]
    net = _softmax_net(mt)
    shapes, _, _ = net.infer_shape(data=(20, 10), softmax_label=(20,))
    params = {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    runs = {}
    for name, pkg in (("port", mt), ("jax", mx)):
        loaded = _load(pkg, params, tmp_path)
        args = {"data": pkg.nd.array(x[:20], ctx=pkg.cpu()),
                "softmax_label": pkg.nd.array(y[:20], ctx=pkg.cpu())}
        grads = {}
        for n, v in loaded.items():
            args[n] = v
            grads[n] = pkg.nd.zeros(v.shape, pkg.cpu())
        ex = _softmax_net(pkg).bind(
            pkg.cpu(), args, args_grad=grads,
            group2ctx={"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)})
        losses = []
        for _ in range(30):
            out = ex.forward(is_train=True)[0].asnumpy()
            p = np.clip(out[np.arange(20), y[:20].astype(int)], 1e-9, 1)
            losses.append(-np.log(p).mean())
            ex.backward()
            for n, g in grads.items():
                args[n][:] = args[n].asnumpy() - 0.5 / 20 * g.asnumpy()
        assert losses[-1] < losses[0] * 0.7, (name, losses)
        runs[name] = (np.array(losses),
                      {n: args[n].asnumpy() for n in params})
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], rtol=1e-4)
    for n in params:
        np.testing.assert_allclose(runs["port"][1][n], runs["jax"][1][n],
                                   rtol=1e-4, atol=1e-6, err_msg=n)


# ------------------------------------------------------- the LSTM example
def _lstm_sym(pkg, example=None):
    """The JAX example's graph (``example``: the module) or the port's twin
    with the example's default groups."""
    c = LSTM
    fn = example.lstm_unroll if example is not None else \
        (lambda *a: mpl.lstm_unroll(mt, *a))
    return fn(c["num_layers"], c["seq_len"], c["vocab_size"],
              c["num_hidden"], c["num_embed"], c["vocab_size"],
              lambda i: "layer%d" % i)


def _lstm_params(seed=1):
    net = _lstm_sym(mt)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(LSTM["batch"], LSTM["seq_len"]),
        softmax_label=(LSTM["batch"], LSTM["seq_len"]))[0]))
    rs = RS(seed)
    return {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in sorted(shapes.items()) if n not in INPUTS}


def _lstm_bind(pkg, net, params, group2ctx):
    """The port: ``simple_bind`` (each array on its group's context).  The
    JAX package: ``bind`` over arrays all on cpu(0), as its own test binds
    (its ``simple_bind`` with groups on two devices cannot run a step:
    ``test_jax_simple_bind_two_devices_caveat``)."""
    shapes = {"data": (LSTM["batch"], LSTM["seq_len"]),
              "softmax_label": (LSTM["batch"], LSTM["seq_len"])}
    if pkg is mt:
        ex = net.simple_bind(pkg.cpu(), grad_req="write",
                             group2ctx=group2ctx, **shapes)
    else:
        arg_shapes, _, _ = net.infer_shape(**shapes)
        names = net.list_arguments()
        args = {n: pkg.nd.zeros(s, pkg.cpu())
                for n, s in zip(names, arg_shapes)}
        grads = {n: pkg.nd.zeros(s, pkg.cpu())
                 for n, s in zip(names, arg_shapes) if n not in INPUTS}
        ex = net.bind(pkg.cpu(), args, args_grad=grads, group2ctx=group2ctx)
    ex.copy_params_from(params)
    return ex


def _lstm_batch(seed):
    return mpl.synthetic_batch(RS(seed), LSTM["batch"], LSTM["seq_len"],
                               LSTM["vocab_size"], "uniform")


def _lstm_pass(ex, x, y):
    ex.arg_dict["data"][:] = x
    ex.arg_dict["softmax_label"][:] = y
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    return out, {n: g.asnumpy() for n, g in ex.grad_dict.items()
                 if n not in INPUTS}


def test_lstm_unroll_twin(mx, tmp_path):
    """The example's graph in the JAX package and the twin in the port,
    the same names, under {layer0: cpu(0), layer1: cpu(1)}: the output and
    every gradient against the JAX package's placed run and, bit for bit,
    against the port's unplaced bind."""
    example = _example(mx)
    jnet, pnet = _lstm_sym(mx, example), _lstm_sym(mt)
    assert jnet.list_arguments() == pnet.list_arguments()
    params = _lstm_params()
    x, y = _lstm_batch(0)
    j = _lstm_pass(_lstm_bind(mx, jnet, _load(mx, params, tmp_path),
                              {"layer0": mx.cpu(0), "layer1": mx.cpu(1)}),
                   x, y)
    before = exm.cross_device_copies
    ex = _lstm_bind(mt, pnet, _load(mt, params, tmp_path),
                    {"layer0": mt.cpu(0), "layer1": mt.cpu(1)})
    assert ex.arg_dict["lstm_l1_i2h_weight"].context == mt.cpu(1)
    p = _lstm_pass(ex, x, y)
    u = _lstm_pass(_lstm_bind(mt, pnet, _load(mt, params, tmp_path), None),
                   x, y)
    assert exm.cross_device_copies == before
    _close_all(p, j, "port vs JAX")
    np.testing.assert_array_equal(p[0], u[0])
    for n in u[1]:
        np.testing.assert_array_equal(p[1][n], u[1][n])


def test_lstm_example_loop_three_steps(mx, tmp_path):
    """Three steps of the example's loop (SGD lr 0.2, rescale 1 / (batch x
    seq_len), ``Updater`` by argument index) in both packages from one
    state: every parameter within 1e-5 of its largest entry."""
    example = _example(mx)
    params = _lstm_params(seed=2)
    c = LSTM
    got = {}
    for name, pkg, net in (("jax", mx, _lstm_sym(mx, example)),
                           ("port", mt, _lstm_sym(mt))):
        ex = _lstm_bind(pkg, net, _load(pkg, params, tmp_path),
                        {"layer0": pkg.cpu(0), "layer1": pkg.cpu(1)})
        opt = pkg.optimizer.SGD(learning_rate=0.2,
                                rescale_grad=1.0 / (c["batch"]
                                                    * c["seq_len"]))
        updater = pkg.optimizer.get_updater(opt)
        for step in range(3):
            x, y = _lstm_batch(10 + step)
            ex.arg_dict["data"][:] = x
            ex.arg_dict["softmax_label"][:] = y
            ex.forward(is_train=True)
            ex.backward()
            for i, n in enumerate(net.list_arguments()):
                if n not in INPUTS:
                    updater(i, ex.grad_dict[n], ex.arg_dict[n])
        got[name] = {n: ex.arg_dict[n].asnumpy() for n in params}
    for n in params:
        scale = np.abs(got["jax"][n]).max()
        assert np.abs(got["port"][n] - got["jax"][n]).max() <= 1e-5 * scale, n


def test_jax_simple_bind_two_devices_caveat(mx):
    """A fault of the JAX package (ROADMAP, reference caveats): its
    ``simple_bind(group2ctx=...)`` allocates each group's arrays on that
    group's device, and its jitted walk then refuses arguments committed to
    two devices, so the example's own bind fails at the first training
    step on two devices; the port's runs it."""
    example = _example(mx)
    net = _lstm_sym(mx, example)
    ex = net.simple_bind(mx.cpu(), grad_req="write",
                         group2ctx={"layer0": mx.cpu(0), "layer1": mx.cpu(1)},
                         data=(LSTM["batch"], LSTM["seq_len"]),
                         softmax_label=(LSTM["batch"], LSTM["seq_len"]))
    with pytest.raises(ValueError, match="incompatible devices"):
        ex.forward(is_train=True)
    ex = _lstm_bind(mt, _lstm_sym(mt), _lstm_params(), {
        "layer0": mt.cpu(0), "layer1": mt.cpu(1)})
    assert np.isfinite(ex.forward(is_train=True)[0].asnumpy()).all()


def test_bench_plan_and_toy_run():
    """The reference's placement formula, and the bench's loop at toy
    widths on the host: the perplexity falls on the Zipf corpus."""
    d = [mt.gpu(0), mt.cpu()]
    plan = mpl.placement(d, 8)
    assert plan["embed"] == d[0] and plan["decode"] == d[1]
    assert [plan["layer%d" % i] for i in range(8)] == [d[0]] * 4 + [d[1]] * 4
    assert set(mpl.placement([mt.cpu()], 3).values()) == {mt.cpu()}
    assert mpl.parse_devices(mt, "gpu0,cpu") == d
    rec = mpl.run([mt.cpu()], num_batches=8, warmup=2, window=4,
                  num_layers=2, num_hidden=16, num_embed=16, seq_len=5,
                  vocab_size=20, batch_size=8)
    ppl = rec["perplexity_per_window"]
    assert ppl[-1] < ppl[0] and rec["cross_device_copies_per_batch"] == 0


# ------------------------------------------------------- binding surface
def test_top_level_names():
    assert mt.AttrScope is mt.attribute.AttrScope
    assert mt.Group is mt.symbol.Group
    assert mt.Executor is exm.Executor
    assert mt.kv is mt.kvstore
    assert mt.ops.registry.get_op("_CrossDeviceCopy").hidden


def test_simple_bind_places_arrays():
    """Each argument and its gradient on its variable's group context (the
    bind context where the map has no entry), aux states on the bind
    context; outputs reported on the bind context (one torch device)."""
    with mt.AttrScope(ctx_group="a"):
        data = mt.sym.Variable("data")
        fc = mt.sym.FullyConnected(data, num_hidden=6, name="fc")
    with mt.AttrScope(ctx_group="b"):
        bn = mt.sym.BatchNorm(fc, name="bn")
    out = mt.sym.FullyConnected(bn, num_hidden=3, name="head")
    ex = out.simple_bind(mt.cpu(0), group2ctx={"a": mt.cpu(1),
                                               "b": mt.cpu(2)},
                         data=(4, 5))
    want = {"data": 1, "fc_weight": 1, "fc_bias": 1, "bn_gamma": 2,
            "bn_beta": 2, "head_weight": 0, "head_bias": 0}
    for n, i in want.items():
        assert ex.arg_dict[n].context == mt.cpu(i), n
        assert ex.grad_dict[n].context == mt.cpu(i), n
    for n in ex.aux_dict:
        assert ex.aux_dict[n].context == mt.cpu(0), n
    ex.forward(is_train=True)
    assert ex.outputs[0].context == mt.cpu(0)
    assert ex.outputs[0].shape == (4, 3)
    # reshape keeps the plan and the shared parameters
    ex2 = ex.reshape(data=(2, 5))
    assert ex2._group2ctx == ex._group2ctx
    assert ex2.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"]
    with pytest.raises(mt.MXNetError, match="Context"):
        out.simple_bind(mt.cpu(), group2ctx={"a": "cpu"}, data=(4, 5))


def test_bind_group2ctx_and_shared_exec():
    """``Symbol.bind`` takes ``group2ctx`` and ``shared_exec`` and hands
    them to the Executor; ``simple_bind(shared_exec=)`` still shares what
    it shared before (same name and shape)."""
    arrays = _chain_arrays(seed=3)
    net = _chain(mt)
    args = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in arrays.items()}
    g2c = {"dev1": mt.cpu(0), "dev2": mt.cpu(1)}
    ex = net.bind(mt.cpu(), args, group2ctx=g2c)
    ex2 = net.bind(mt.cpu(), args, group2ctx=g2c, shared_exec=ex)
    assert ex._group2ctx == g2c and ex2._group2ctx == g2c
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(),
                                  ex2.forward()[0].asnumpy())
    ex3 = net.simple_bind(mt.cpu(), group2ctx=g2c, shared_exec=ex,
                          data=(4, 10))
    assert ex3.arg_dict["fc2_weight"] is ex.arg_dict["fc2_weight"]
    ex4 = net.simple_bind(mt.cpu(), group2ctx=g2c, shared_exec=ex,
                          data=(2, 10))
    assert ex4.arg_dict["data"] is not ex.arg_dict["data"]
    assert ex4.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]


def test_jax_json_with_cross_device_copy(mx, tmp_path):
    """A JSON the JAX package writes, with ``ctx_group`` attributes and a
    ``_CrossDeviceCopy`` node, loads in the port, binds with group2ctx and
    runs: the output and gradients equal the JAX package's."""
    with mx.AttrScope(ctx_group="dev1"):
        data = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    copy = mx.sym._CrossDeviceCopy(fc1)
    with mx.AttrScope(ctx_group="dev2"):
        out = mx.sym.Activation(mx.sym.FullyConnected(
            copy, num_hidden=8, name="fc2"), act_type="tanh")
    net = mt.sym.load_json(out.tojson())
    attrs = net.attr_dict()
    assert attrs["fc1"]["ctx_group"] == "dev1"
    assert attrs["fc2"]["ctx_group"] == "dev2"
    shapes, _, _ = net.infer_shape(data=(4, 10))
    rs = RS(4)
    arrays = {n: rs.uniform(-1, 1, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)}
    runs = {}
    for name, pkg, sym in (("port", mt, net), ("jax", mx, out)):
        args = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in arrays.items()}
        grads = {k: pkg.nd.zeros(v.shape, pkg.cpu())
                 for k, v in arrays.items()}
        ex = sym.bind(pkg.cpu(), args, args_grad=grads,
                      group2ctx={"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)})
        o = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([pkg.nd.ones((4, 8), pkg.cpu())])
        runs[name] = (o, {k: v.asnumpy() for k, v in grads.items()})
    _close_all(runs["port"], runs["jax"], "JSON")


# ------------------------------------------- the placed walk on the host
@pytest.fixture
def split_host(monkeypatch):
    """``cpu(i)`` for i >= 1 resolves to ``torch.device("cpu", i)``: a
    device that compares unequal to the host's ``cpu`` while its tensors
    live on the host, so the placed walk runs here."""
    real = mt.Context.torch_device

    def torch_device(self):
        if self.device_type == "cpu" and self.device_id >= 1:
            return torch.device("cpu", self.device_id)
        return real(self)
    monkeypatch.setattr(mt.Context, "torch_device", torch_device)


# ops whose output carries no gradient whatever their inputs: a fill that
# reads its input's shape only, and the gradient stop
NO_GRAD_OPS = ("_state_init", "BlockGrad")


def implied_copies(net, device_of, grads, home=None):
    """(forward, backward) copies a training step's walk implies, read off
    the graph: an op runs on ``device_of(group)`` (None: its first input's
    device); a value it consumes from another device is copied there once a
    walk, and back in the backward when the value needs a gradient (it
    descends from an argument named in ``grads``, not through
    ``NO_GRAD_OPS``).  ``home``: where every tensor lies whatever its op's
    device (``split_host``), so that each input of an op placed elsewhere
    counts."""
    from mxnet_tpu_torch.symbol import _topo
    dev, grad = {}, {}
    fwd, bwd = set(), set()
    for n in _topo([x for x, _ in net._outputs]):
        grp = n.attr.get("ctx_group") or n.attr.get("__ctx_group__")
        if n.is_var:
            dev[id(n)] = device_of(grp) or device_of(None)
            grad[id(n)] = n.name in grads
            continue
        d = device_of(grp) or dev[id(n.inputs[0][0])]
        dev[id(n)] = d
        grad[id(n)] = n.op.name not in NO_GRAD_OPS and any(
            grad[id(c)] for c, _ in n.inputs)
        for c, i in n.inputs:
            src = home if home is not None else dev[id(c)]
            if src != d:
                fwd.add((id(c), i, d))
                if grad[id(c)]:
                    bwd.add((id(c), i, d))
    return len(fwd), len(bwd)


def _crossings(net, group2ctx, grads):
    """``implied_copies`` under ``split_host``: a group's device from
    ``group2ctx``, everything else and every tensor on the host."""
    home = torch.device("cpu")
    return implied_copies(
        net, lambda g: group2ctx[g].torch_device() if g in group2ctx
        else (home if g is None else None), grads, home)


def test_placed_walk_on_the_host(split_host):
    """The chain and the LSTM twin with a group on ``cpu(1)`` walk placed:
    the copies those the graph implies (forward, then backward), cpu(1)'s
    output array reported on cpu(1), the output and every gradient those
    of the unplaced bind: the chain's bit for bit, the LSTM's within the
    float32 tolerances (a moved value is a new contiguous tensor, and a
    matrix product over it may sum in another order than over the view it
    was)."""
    arrays = _chain_arrays(seed=5)
    g2c = {"dev1": mt.cpu(0), "dev2": mt.cpu(1)}
    plain = _run_chain(mt, arrays, None)
    before = exm.cross_device_copies
    placed = _run_chain(mt, arrays, g2c)
    fwd, bwd = _crossings(_chain(mt), g2c, arrays)
    assert exm.cross_device_copies - before == fwd + bwd, (fwd, bwd)
    np.testing.assert_array_equal(placed[0], plain[0])
    for k in plain[1]:
        np.testing.assert_array_equal(placed[1][k], plain[1][k])
    params = _lstm_params(seed=6)
    x, y = _lstm_batch(1)
    net = _lstm_sym(mt)
    g2c = {"layer0": mt.cpu(0), "layer1": mt.cpu(1)}
    u = _lstm_pass(_lstm_bind(mt, net, params, None), x, y)
    ex = _lstm_bind(mt, net, params, g2c)
    assert ex._place is not None and ex.outputs[0].context == mt.cpu(1)
    before = exm.cross_device_copies
    p = _lstm_pass(ex, x, y)
    fwd, bwd = _crossings(net, g2c, ex.grad_dict)
    assert exm.cross_device_copies - before == fwd + bwd
    _close_all(p, u, "placed vs unplaced")


def test_placed_walk_keeps_peepholes_in_one_device(split_host):
    """A BatchNorm on cpu(0) whose ReLU sits on cpu(1) runs unfused, the
    pair inside one group fused; outputs, gradients and moving statistics
    (written back to the bind context's aux arrays) equal the unplaced
    run's."""
    def net():
        with mt.AttrScope(ctx_group="a"):
            data = mt.sym.Variable("data")
            c = mt.sym.Convolution(data, num_filter=4, kernel=(3, 3),
                                   pad=(1, 1), no_bias=True, name="c1")
            b = mt.sym.BatchNorm(c, fix_gamma=False, name="bn1")
            r = mt.sym.Activation(b, act_type="relu")
            b2 = mt.sym.BatchNorm(r, fix_gamma=False, name="bn2")
        with mt.AttrScope(ctx_group="b"):
            r2 = mt.sym.Activation(b2, act_type="relu")
            f = mt.sym.FullyConnected(r2, num_hidden=3, name="fc")
        return mt.sym.SoftmaxOutput(f, name="softmax")
    rs = RS(7)
    shapes = dict(zip(net().list_arguments(), net().infer_shape(
        data=(2, 3, 6, 6), softmax_label=(2,))[0]))
    vals = {n: rs.uniform(-1, 1, s).astype(np.float32)
            for n, s in shapes.items() if n != "softmax_label"}
    vals["softmax_label"] = np.array([0, 2], np.float32)
    g2c = {"a": mt.cpu(0), "b": mt.cpu(1)}
    results = []
    for group2ctx in (None, g2c):
        ex = net().simple_bind(mt.cpu(), group2ctx=group2ctx,
                                   data=(2, 3, 6, 6), softmax_label=(2,))
        if group2ctx is not None:
            bn1, bn2 = (n for n in ex._low.order
                        if n.name in ("bn1", "bn2"))
            assert ("relu", id(bn2)) in ex._unfusable
            assert ("relu", id(bn1)) not in ex._unfusable
        ex.copy_params_from({n: v for n, v in vals.items()
                             if n in ex.arg_dict})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        results.append((out, {n: g.asnumpy()
                              for n, g in ex.grad_dict.items()},
                        {n: a.asnumpy() for n, a in ex.aux_dict.items()},
                        {n: a.context for n, a in ex.aux_dict.items()}))
    (o0, g0, a0, _), (o1, g1, a1, c1) = results
    np.testing.assert_allclose(o1, o0, rtol=1e-6, atol=1e-7)
    for n in g0:
        np.testing.assert_allclose(g1[n], g0[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    for n in a0:
        np.testing.assert_allclose(a1[n], a0[n], rtol=1e-6, err_msg=n)
        assert c1[n] == mt.cpu(0)


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_two_device_plan_on_the_card():
    """The twin's two-device plan (the reference's formula, ngpu = 2) over
    [gpu(0), cpu()] at toy width: a training step's copies equal those the
    group boundaries imply, and its output and gradients match the
    unplaced bind on the host within the float32 tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = dict(num_layers=4, seq_len=5, num_hidden=16, num_embed=16,
             vocab_size=20)
    devs = [mt.gpu(0), mt.cpu()]
    net = mpl.model(mt, **c)
    plan = mpl.placement(devs, c["num_layers"])
    state = mpl.init_state(mt, net, 4, c["seq_len"])
    x, y = mpl.synthetic_batch(RS(0), 4, c["seq_len"], c["vocab_size"])
    host = mpl.Trainer(mt, net, mt.cpu(), None, state, 4, c["seq_len"])
    card = mpl.Trainer(mt, net, devs[0], plan, state, 4, c["seq_len"])
    want = _lstm_pass(host.ex, x, y)
    _lstm_pass(card.ex, x, y)               # warm
    before = exm.cross_device_copies
    got = _lstm_pass(card.ex, x, y)
    fwd, bwd = implied_copies(
        net, lambda g: plan[g].torch_device() if g in plan else
        (devs[0].torch_device() if g is None else None), card.ex.grad_dict)
    assert exm.cross_device_copies - before == fwd + bwd
    # the layer boundary at every step, then the label (the example's
    # grad_req "write" gives it a gradient too), each way
    assert (fwd, bwd) == (c["seq_len"] + 1, c["seq_len"] + 1)
    _close_all(got, want, "two-device plan vs host")
