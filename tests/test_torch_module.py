"""The Module layer of mxnet_tpu_torch against mxnet_tpu's, on the CPU.

- ``Module.fit`` of the MLP (1x12x12) and, from test_torch_module_lenet.py,
  LeNet (1x28x28), 4 classes, 120 rows in shuffled batches of 30
  (``np.random.seed`` before each iterator, so both packages draw one
  order), 2 epochs, SGD-momentum and Adam, on
  the fused path and on the general path (``MXNET_FUSED_FIT=0``), from the
  same numpy parameters fed to both packages: every parameter and the
  last epoch's training accuracy against the JAX package's.  Both Modules
  train in float32 (their iterators and bound arrays are float32), so each
  parameter is held to FLOOR_X times its own float32 floor: the distance
  between the JAX package's fit and the JAX package's fit from parameters
  nudged by NUDGE relative (or to FLOOR_X x FLOOR_MIN where that floor is
  smaller).  Adam makes the floor large where a gradient entry is near 0
  (the step is its sign): LeNet's conv2_weight moves by 4e-3 of its
  largest entry under a 2^-20 nudge.
- Twins of tests/python/unittest/test_module.py that need no unported
  module: save/load with optimizer states, reshape, Module against the
  Executor, input gradients; each also against the JAX package's values.
- Checkpoints: a port checkpoint loads in ``mxnet_tpu.Module.load`` and
  predicts the same, and the reverse.
- The refusals, each naming its slice (the numerics slice, the pipeline,
  ZeRO and live-resize parts of the distributed slice); the dist store,
  the sharded step checkpoint, the telemetry knobs and the Monitor at
  work; and ``Module()`` on ``gpu(0)``.
- On the card (``cuda`` marker): LeNet fit on ``gpu(0)`` with the device
  prefetch on and off, bitwise equal, every staged batch consumed in
  order.
"""
import json
import os

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
SHAPES = {"lenet": (1, 28, 28), "mlp": (1, 12, 12)}


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.models  # noqa: F401
    return mx


def _data(model, n=120, seed=0):
    rs = RS(seed)
    return (rs.randn(n, *SHAPES[model]).astype(np.float32),
            rs.randint(0, 4, n).astype(np.float32))


def _params(model, seed=1, nudge=0.0):
    """Numpy parameters for both packages: uniform in +-sqrt(3 / fan-in),
    each times 1 + u * ``nudge``."""
    net = getattr(mt.models, "get_" + model)(num_classes=4)
    shapes = {"data": (30,) + SHAPES[model], "softmax_label": (30,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = RS(seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        v = rs.uniform(-1, 1, s) * np.sqrt(3.0 / max(1, np.prod(s[1:])))
        args[n] = (v * (1 + nudge * rs.uniform(-1, 1, s))).astype(np.float32)
    return args


def _fit(pkg, model, opt, fused, args, epochs=2, **fit_kw):
    """(Module, {name: numpy parameter}, final training accuracy)."""
    old = os.environ.get("MXNET_FUSED_FIT")
    os.environ["MXNET_FUSED_FIT"] = "1" if fused else "0"
    try:
        x, y = _data(model)
        np.random.seed(3)
        it = pkg.io.NDArrayIter(x, y, batch_size=30, shuffle=True)
        mod = pkg.Module(getattr(pkg.models, "get_" + model)(num_classes=4),
                         context=pkg.cpu())
        acc = pkg.metric.Accuracy()
        mod.fit(it, num_epoch=epochs, optimizer=opt,
                optimizer_params=dict(OPTS[opt]), eval_metric=acc,
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in args.items()}, aux_params={},
                **fit_kw)
    finally:
        if old is None:
            os.environ.pop("MXNET_FUSED_FIT", None)
        else:
            os.environ["MXNET_FUSED_FIT"] = old
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}, acc.get()[1]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def fit_matches_mxnet_tpu(mx, model, opt, path):
    """The port's fit of ``model`` against the JAX package's (see the
    module docstring); the LeNet cases run from test_torch_module_lenet.py
    (a file of their own, for the test workers' balance)."""
    fused = path == "fused"
    args = _params(model)
    mod, got, got_acc = _fit(mt, model, opt, fused, args)
    assert (mod._fused_ts_cache is not None) == fused
    _, want, want_acc = _fit(mx, model, opt, fused, args)
    _, nudged, _ = _fit(mx, model, opt, fused, _params(model, nudge=NUDGE))
    assert sorted(got) == sorted(want)
    for k in want:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, \
            (k, _rel(got[k], want[k]), floor)
    # one row may flip its argmax where the floor does
    assert abs(got_acc - want_acc) <= 1.0 / 120 + 1e-12


@pytest.mark.parametrize("path", ["fused", "general"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fit_matches_mxnet_tpu(mx, opt, path):
    fit_matches_mxnet_tpu(mx, "mlp", opt, path)


def test_fit_with_f32_policy_matches_mxnet_tpu(mx):
    """The fused fit under ``Policy("float32", loss_scale=8)`` against the
    JAX package's plain float32 fit, with the floor check above: a
    power-of-two scale is documented to train as the plain fit (the JAX
    package's own fit under that policy fails its bitwise twin,
    test_amp.py::test_explicit_fit_policy_kwarg, in every run of its suite,
    so the port is held to the contract, not to that run)."""
    args = _params("mlp")
    pol = mt.amp.Policy("float32", loss_scale=8.0)
    mod, got, got_acc = _fit(mt, "mlp", "sgd", True, args, policy=pol)
    assert mod._fused_ts_cache[1].policy is pol
    _, want, want_acc = _fit(mx, "mlp", "sgd", True, args)
    _, nudged, _ = _fit(mx, "mlp", "sgd", True, _params("mlp", nudge=NUDGE))
    for k in want:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, k
    assert abs(got_acc - want_acc) <= 1.0 / 120 + 1e-12


def _fc_net(S, hidden=16):
    return S.FullyConnected(S.Variable("data"), num_hidden=hidden, name="fc")


def test_save_load(mx, tmp_path):
    """(twin: test_save_load, one device) momentum states saved and loaded
    with the checkpoint; the JAX package loads the port's parameters."""
    prefix = str(tmp_path / "test")
    w = RS(0).randn(16, 10).astype(np.float32)
    mod = mt.Module(_fc_net(mt.sym), ("data",), None, context=mt.cpu())
    mod.bind(data_shapes=[("data", (10, 10))], for_training=True)
    mod.init_params(arg_params={"fc_weight": w,
                                "fc_bias": np.ones(16, np.float32)},
                    aux_params={})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    batch = mt.io.DataBatch(data=[mt.nd.array(RS(1).randn(10, 10),
                                              ctx=mt.cpu())])
    mod.forward(batch, is_train=True)
    mod.backward([mt.nd.ones((10, 16), ctx=mt.cpu())])
    mod.update()
    mod.save_checkpoint(prefix, 0, save_optimizer_states=True)

    mod2 = mt.Module.load(prefix, 0, load_optimizer_states=True,
                          data_names=("data",), label_names=None,
                          context=mt.cpu())
    mod2.bind(data_shapes=[("data", (10, 10))])
    mod2.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    assert mod._symbol.tojson() == mod2._symbol.tojson()
    a1, a2 = mod.get_params()[0], mod2.get_params()[0]
    assert set(a1) == set(a2)
    for k in a1:
        np.testing.assert_array_equal(a1[k].asnumpy(), a2[k].asnumpy())
    for idx, st in mod._updater.states.items():
        np.testing.assert_array_equal(st.asnumpy(),
                                      mod2._updater.states[idx].asnumpy())
    assert mod2._loaded_opt_states
    mx_mod = mx.Module.load(prefix, 0, data_names=("data",),
                            label_names=None)
    for k, v in mx_mod._arg_params.items():
        np.testing.assert_array_equal(v.asnumpy(), a1[k].asnumpy())


def test_module_reshape(mx):
    """(twin: test_module_reshape) bind at batch 7, one update with lr 1
    and all-ones head gradients, reshape to 14 and another update: the
    outputs' shapes and the bias after each update equal the JAX
    package's."""
    w = RS(0).randn(20, 20).astype(np.float32) * 0.1
    biases = []
    for pkg, kw in ((mt, {"ctx": mt.cpu()}), (mx, {})):
        mod = pkg.Module(_fc_net(pkg.sym, 20), ("data",), None,
                         context=pkg.cpu())
        mod.bind(data_shapes=[("data", (7, 20))])
        mod.init_params(arg_params={"fc_weight": w,
                                    "fc_bias": np.zeros(20, np.float32)},
                        aux_params={})
        mod.init_optimizer(optimizer_params={"learning_rate": 1})
        seen = []
        for dshape in ((7, 20), (14, 20)):
            if dshape[0] == 14:
                mod.reshape(data_shapes=[("data", dshape)])
            mod.forward(pkg.io.DataBatch(data=[pkg.nd.ones(dshape, **kw)],
                                         label=None), is_train=True)
            mod.backward([pkg.nd.ones(dshape, **kw)])
            mod.update()
            assert mod.get_outputs()[0].shape == dshape
            seen.append(mod.get_params()[0]["fc_bias"].asnumpy().copy())
        biases.append(seen)
    for got, want in zip(*biases):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(biases[0][0] != 0) and np.all(biases[0][1] != biases[0][0])


def _softmax_net(S):
    net = S.FullyConnected(S.Variable("data"), num_hidden=8, name="fc1")
    net = S.Activation(net, act_type="tanh")
    net = S.FullyConnected(net, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(net, name="softmax")


def test_module_vs_executor_parity(mx):
    """(twin) Module forward/backward equals a bound Executor's on the same
    parameters, outputs and gradients, and the JAX package's Module."""
    x = RS(0).rand(6, 10).astype(np.float32)
    y = RS(1).randint(0, 4, 6).astype(np.float32)
    net = _softmax_net(mt.sym)
    mod = mt.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (6, 10))],
             label_shapes=[("softmax_label", (6,))])
    mod.init_params(initializer=mt.initializer.Uniform(0.1))
    arg_params, _ = mod.get_params()
    batch = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                            label=[mt.nd.array(y, ctx=mt.cpu())])
    mod.forward(batch, is_train=True)
    mod.backward()
    mod_out = mod.get_outputs()[0].asnumpy()

    args = {"data": mt.nd.array(x, ctx=mt.cpu()),
            "softmax_label": mt.nd.array(y, ctx=mt.cpu())}
    args.update({k: v.copyto(mt.cpu()) for k, v in arg_params.items()})
    grads = {k: mt.nd.zeros(v.shape, ctx=mt.cpu())
             for k, v in arg_params.items()}
    ex = net.bind(mt.cpu(), args, args_grad=grads)
    ex_out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    np.testing.assert_allclose(mod_out, ex_out, rtol=1e-5)
    mod_grads = mod._exec_group.execs[0].grad_dict
    for k in grads:
        np.testing.assert_allclose(mod_grads[k].asnumpy(),
                                   grads[k].asnumpy(), rtol=1e-5, atol=1e-7)

    jm = mx.Module(_softmax_net(mx.sym), context=mx.cpu())
    jm.bind(data_shapes=[("data", (6, 10))],
            label_shapes=[("softmax_label", (6,))])
    jm.init_params(arg_params={k: v.asnumpy() for k, v in arg_params.items()},
                   aux_params={})
    jm.forward(mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)]),
               is_train=True)
    np.testing.assert_allclose(mod_out, jm.get_outputs()[0].asnumpy(),
                               rtol=1e-5, atol=1e-7)


def test_module_input_grads(mx):
    """(twin) inputs_need_grad exposes d(loss)/d(data), equal to the JAX
    package's on the same parameters."""
    x = RS(0).rand(5, 6).astype(np.float32)
    y = RS(1).randint(0, 4, 5).astype(np.float32)
    w = RS(2).randn(4, 6).astype(np.float32)
    got = []
    for pkg, kw in ((mt, {"ctx": mt.cpu()}), (mx, {})):
        net = pkg.sym.SoftmaxOutput(
            pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                   name="fc"), name="softmax")
        mod = pkg.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (5, 6))],
                 label_shapes=[("softmax_label", (5,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params={"fc_weight": w,
                                    "fc_bias": np.zeros(4, np.float32)},
                        aux_params={})
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x, **kw)],
                                     label=[pkg.nd.array(y, **kw)]),
                    is_train=True)
        mod.backward()
        got.append(mod.get_input_grads()[0].asnumpy())
    assert got[0].shape == (5, 6) and np.abs(got[0]).sum() > 0
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-7)


def _predicted(pkg, mod, x, y):
    """The outputs over 4 batches of 30, each copied to the host as it
    comes (the JAX package's ``predict`` merges views of its bound output
    after the last forward, so every batch reads as the last one)."""
    it = pkg.io.NDArrayIter(x, y, batch_size=30)
    mod.bind(it.provide_data, it.provide_label, for_training=False,
             force_rebind=True)
    got = np.concatenate([outs[0].asnumpy() for outs, _, _
                          in mod.iter_predict(it)])
    if pkg is mt:
        np.testing.assert_array_equal(mod.predict(it).asnumpy(), got)
    return got


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_interop(mx, tmp_path, direction):
    """A checkpoint saved by either package (after a fit) loads in the
    other's ``Module.load`` and predicts the same (within 1e-5: two
    float32 forwards)."""
    prefix = str(tmp_path / "ck")
    src, dst = (mt, mx) if direction == "port_to_jax" else (mx, mt)
    mod, _, _ = _fit(src, "mlp", "sgd", True, _params("mlp"), epochs=1)
    mod.save_checkpoint(prefix, 1)
    x, y = _data("mlp")
    want = _predicted(src, mod, x, y)
    got = _predicted(dst, dst.Module.load(prefix, 1, context=dst.cpu()), x, y)
    assert want.shape == (120, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_module_states(mx):
    """(after test_module_states, whose RNN cells are not ported) a state
    input set by value and from the previous outputs changes the outputs
    as in the JAX package; a module with states stays off the fused
    path."""
    w = RS(0).randn(3, 4).astype(np.float32)
    x = RS(1).randn(5, 4).astype(np.float32)
    got = []
    for pkg, kw in ((mt, {"ctx": mt.cpu()}), (mx, {})):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                     name="fc") + pkg.sym.Variable("state")
        mod = pkg.Module(net, label_names=None, state_names=["state"],
                         context=pkg.cpu())
        mod.bind(data_shapes=[("data", (5, 4))], for_training=False)
        mod.init_params(arg_params={"fc_weight": w,
                                    "fc_bias": np.zeros(3, np.float32)},
                        aux_params={})
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x, **kw)], label=[])
        mod.set_states(value=1)
        mod.forward(batch)
        out = mod.get_outputs(merge_multi_context=False)
        first = mod.get_outputs()[0].asnumpy()
        mod.set_states(states=out)
        mod.forward(batch)
        got.append((first, mod.get_outputs()[0].asnumpy(),
                    mod.get_states()[0].asnumpy()))
    for g, w_ in zip(*got):
        np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-6)
    assert not np.allclose(got[0][0], got[0][1])
    net = mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3)
        + mt.sym.Variable("state"), name="softmax")
    mod = mt.Module(net, state_names=["state"], context=mt.cpu())
    mod.bind(data_shapes=[("data", (5, 4))],
             label_shapes=[("softmax_label", (5,))])
    mod.init_params()
    mod.init_optimizer()
    assert mod._start_fused_fit() is None


def test_callbacks_in_fit(mx, tmp_path, caplog):
    """The batch-end callbacks (Speedometer, ProgressBar, log_train_metric)
    log during a fit; the epoch-end checkpoint callbacks write the JAX
    package's files, which its load_checkpoint reads back equal."""
    import logging
    caplog.set_level(logging.INFO)
    x, y = _data("mlp")
    it = mt.io.NDArrayIter(x, y, batch_size=30)
    mod = mt.Module(mt.models.get_mlp(num_classes=4), context=mt.cpu())
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.1},
            batch_end_callback=[mt.callback.Speedometer(10, 1),
                                mt.callback.ProgressBar(3),
                                mt.callback.log_train_metric(1)],
            epoch_end_callback=[mt.callback.do_checkpoint(a),
                                mt.callback.module_checkpoint(mod, b, 2)],
            eval_data=mt.io.NDArrayIter(x[:60], y[:60], batch_size=30),
            eval_end_callback=mt.callback.log_train_metric(1))
    assert "samples/s" in caplog.text and "|####" in caplog.text
    assert caplog.text.count("Validation-accuracy") == 2
    assert "train accuracy" in caplog.text
    assert not os.path.exists(b + "-0001.params")
    arg, _ = mod.get_params()
    for prefix in (a, b):
        _, args, _ = mx.model.load_checkpoint(prefix, 2)
        for k, v in arg.items():
            np.testing.assert_array_equal(args[k].asnumpy(), v.asnumpy())


def test_predict_drops_pad_rows():
    """predict over 110 rows in batches of 30: the last batch's 10 pad rows
    are dropped, and the rows equal those of batches of 10 (no pad)."""
    x, y = _data("mlp", n=110)
    mod = mt.Module(mt.models.get_mlp(num_classes=4), context=mt.cpu())
    got = []
    for bs in (30, 10):
        it = mt.io.NDArrayIter(x, y, batch_size=bs)
        mod.bind(it.provide_data, it.provide_label, for_training=False,
                 force_rebind=True)
        if bs == 30:
            mod.init_params(arg_params=_params("mlp"), aux_params={})
        got.append(mod.predict(it).asnumpy())
        assert mod.score(it, "acc", num_batch=2)[0][0] == "accuracy"
    assert got[0].shape == (110, 4)
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------- refusals
def _small():
    x, y = _data("mlp", n=30)
    return (mt.io.NDArrayIter(x, y, batch_size=30),
            mt.Module(mt.models.get_mlp(num_classes=4), context=mt.cpu()))


@pytest.mark.parametrize("knob,value,slice_", [
    ("MXNET_CHECK_NUMERICS", "raise", "numerics"),
    ("MXNET_SENTINEL", "step:3sigma", "numerics"),
    ("MXNET_WATCHDOG_SEC", "30", "numerics"),
    ("MXNET_DIAG_DIR", "/tmp", "numerics"),
    ("MXNET_MONITOR", "every:1", "numerics"),
    ("MXNET_PP", "2", "distributed"),
    ("MXNET_ZERO", "1", "distributed")])
def test_fit_refuses_unported_knobs(monkeypatch, knob, value, slice_):
    """Each knob the JAX package's fit reads for an unported layer raises,
    naming the slice; "0" leaves it off and fit trains.  The distributed
    slice's MXNET_ZERO and MXNET_PP train, composed too and with MXNET_AMP
    (tests/test_torch_zero*.py, test_torch_pipeline*.py): in a world of one
    process the composition meets only the pipeline's need of a rank a
    stage, never a refusal of an unported part."""
    it, mod = _small()
    monkeypatch.setenv(knob, value)
    partner = {"MXNET_ZERO": ("MXNET_PP", "2"),
               "MXNET_PP": ("MXNET_AMP", "1")}.get(knob)
    if partner:
        monkeypatch.setenv(*partner)
        with pytest.raises(mt.MXNetError, match="needs a world divisible "
                           "by the stage count") as exc:
            mod.fit(it, num_epoch=1)
        assert "not ported" not in str(exc.value)
    else:
        with pytest.raises(mt.MXNetError, match="%s slice" % slice_):
            mod.fit(it, num_epoch=1)
    monkeypatch.setenv(knob, "0")
    if partner:
        monkeypatch.delenv(partner[0])
    mod.fit(it, num_epoch=1)


@pytest.mark.parametrize("knob,fused", [("MXNET_TELEMETRY", False),
                                        ("MXNET_TELEMETRY_FUSED", True)])
def test_fit_telemetry_knobs_work(monkeypatch, tmp_path, knob, fused):
    """The telemetry knobs, refused before the observability slice, record
    the fit: ``MXNET_TELEMETRY`` (started here as at import) takes the
    general path and splits the step; with ``MXNET_TELEMETRY_FUSED=1`` the
    fused path stays, one ``fused_step`` span a batch."""
    tel = mt.telemetry
    fname = str(tmp_path / "t.jsonl")
    monkeypatch.setenv("MXNET_TELEMETRY", fname)
    monkeypatch.delenv("MXTPU_PROCESS_ID", raising=False)
    if knob == "MXNET_TELEMETRY_FUSED":
        monkeypatch.setenv(knob, "1")
    it, mod = _small()
    assert tel._autostart()
    try:
        mod.fit(it, num_epoch=1)
    finally:
        tel.stop()
    with open(fname) as f:
        names = {json.loads(line).get("name") for line in f}
    tel.reset()
    assert (mod._fused_ts_cache is not None) == fused
    assert {"data_wait", "metric", "step", "epoch"} <= names
    assert ("fused_step" in names) == fused
    assert ("forward" in names and "backward" in names) == (not fused)


def test_refusals_name_their_slice(tmp_path, caplog):
    import logging
    it, mod = _small()
    rows = []

    class Capture(mt.Monitor):
        def toc_print(self):
            rows.extend(self.toc())
    # the Monitor works (the observability slice): fit(monitor=) on the
    # fused path, install_monitor on the general path
    mod.fit(it, num_epoch=1, monitor=Capture(1))
    assert rows and mod._fused_ts_cache is not None
    assert {n for _, n, _ in rows} == set(mod._param_names)
    mod.install_monitor(Capture(1))
    assert mod._exec_group.execs[0]._monitor_cb is not None
    # several contexts and KVStore objects train (the parallel slice); a
    # kvstore that is neither a KVStore, a string nor None is a TypeError,
    # as in the JAX package
    # the dist stores train (the distributed slice's first part): rank 0
    # of 1 here, on the general path with the update on the store
    _, mod = _small()
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, kvstore="dist_sync")
    assert "general (executor) path — dist kvstore" in caplog.text
    assert mod._kvstore.type == "dist_sync" and mod._update_on_kvstore
    assert mod._fused_ts_cache is None
    _, mod = _small()
    with pytest.raises(TypeError, match="kvstore"):
        mod.fit(it, num_epoch=1, kvstore=object())
    ck = mt.checkpoint.Checkpointer(str(tmp_path / "ck"), async_=False)
    assert callable(mt.callback.do_step_checkpoint(mod, ck, 10))
    _, mod = _small()
    mod.bind(it.provide_data, it.provide_label, force_rebind=True)
    mod.init_params()
    mod.init_optimizer()
    ff = mod._start_fused_fit()
    # the sharded checkpoint of the live state works; the live resize
    # stays refused, naming its part of the distributed slice
    assert ff.save_checkpoint(ck).endswith("ck-step00000000.ckpt")
    for hook, args, slice_ in (
            ("export_state", (), "distributed"),
            ("apply_resize", (None, None, None, None), "distributed")):
        with pytest.raises(mt.MXNetError,
                           match="live-resize part of the %s slice"
                           % slice_):
            getattr(ff, hook)(*args)
    # the Monitor bridge works: an armed tic samples the step's parameter
    # norms, feed turns them into rows
    mon = mt.Monitor(1)
    mon.tic()
    ff.monitor_tic(mon)
    ff.step(next(iter(it)))
    ff.monitor_feed(mon)
    fed = mon.toc()
    assert [n for _, n, _ in fed] == sorted(ff._params)
    ff.monitor_feed(None)
    ff.sync_back()
    it.reset()
    # a resume from a directory that is no checkpoint: the fused fit
    # cannot start, and fit takes the general path with the reason, as in
    # the JAX package
    mod._ckpt_resume = str(tmp_path / "none")
    with caplog.at_level(logging.INFO):
        assert mod._start_fused_fit() is None
    assert "not a complete sharded checkpoint" in caplog.text
    assert mod._ckpt_resume is None
    ff = mt.model.FeedForward(mt.models.get_mlp(num_classes=4),
                              ctx=mt.cpu(), num_epoch=1, numpy_batch_size=10)
    x, y = _data("mlp", n=30)
    ff.fit(x, y, monitor=mt.Monitor(1))
    ff.fit(x, y)
    assert ff.predict(x).shape == (30, 4)


def test_module_runs_on_the_card_by_default():
    """``Module()`` binds ``gpu(0)``; without a card it raises."""
    net = mt.models.get_mlp(num_classes=4)
    if torch.cuda.is_available():
        assert mt.Module(net)._context == [mt.gpu(0)]
    else:
        with pytest.raises(mt.MXNetError, match="CUDA"):
            mt.Module(net)


# ----------------------------------------------------------- on the card
@pytest.mark.cuda
def test_lenet_fit_on_the_card_prefetch_ordering():
    """LeNet fit on gpu(0): the staged batches reach the steps in the
    iterator's order with their contents (each step's labels, read back,
    are the batch's), and the fit with the device prefetch on equals the
    fit with it off bit for bit (cuDNN deterministic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    args = _params("lenet")
    x, y = _data("lenet")
    runs = []
    for depth in ("1", "0"):
        os.environ["MXNET_DEVICE_PREFETCH"] = depth
        try:
            seen = []
            it = mt.io.NDArrayIter(x, y, batch_size=30)
            mod = mt.Module(mt.models.get_lenet(num_classes=4))
            mod.fit(it, num_epoch=2, optimizer="sgd",
                    optimizer_params=dict(OPTS["sgd"]),
                    arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in args.items()}, aux_params={},
                    batch_end_callback=lambda p: seen.append(
                        p.locals["dev_labels"][0].asnumpy()))
        finally:
            os.environ.pop("MXNET_DEVICE_PREFETCH", None)
        assert mod._fused_ts_cache is not None
        np.testing.assert_array_equal(np.concatenate(seen),
                                      np.concatenate([y, y]))
        runs.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
