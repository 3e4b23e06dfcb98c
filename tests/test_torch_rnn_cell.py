"""The ``rnn`` toolkit of mxnet_tpu_torch against mxnet_tpu's, on the CPU:
port twins of tests/python/unittest/test_rnn.py, each graph also run
through both packages in float64 on the same parameters (hidden 8,
lengths up to 6, vocabulary 20) and held within 1e-9 relative.

- The cells (RNNCell tanh and relu, LSTMCell, GRUCell), stacks,
  bidirectional cells, ``FusedRNNCell`` and its ``unfuse()``, and the
  modifier cells: parameter names, inferred shapes, outputs and gradients.
- Fused equals unfused: the ``FusedRNNCell`` graph and its unfused stack
  with the weights moved by ``unpack_weights`` / ``pack_weights`` (CPU
  NDArrays, the JAX package's layout).
- The initializers the cells attach: ``LSTMBias`` (forget gate's quarter)
  and ``FusedRNN`` (unpack, init, pack).
- ``BucketSentenceIter`` and ``encode_sentences``: buckets, padding,
  next-token labels and, under the same ``random`` / ``np.random`` seeds,
  the JAX package's batch order.
"""
import random

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-9
NH, NI, BATCH, T = 8, 5, 3, 4


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    jax.config.update("jax_enable_x64", True)
    yield mx
    jax.config.update("jax_enable_x64", False)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inputs(pkg, length=T):
    return [pkg.sym.Variable("rnn_t%d_data" % i) for i in range(length)]


def _cell(pkg, kind, prefix="rnn_"):
    if kind in ("rnn_tanh", "rnn_relu"):
        return pkg.rnn.RNNCell(NH, activation=kind[4:], prefix=prefix)
    if kind == "lstm":
        return pkg.rnn.LSTMCell(NH, prefix=prefix, forget_bias=1.0)
    return pkg.rnn.GRUCell(NH, prefix=prefix)


# --------------------------------------------------- twins of test_rnn.py
@pytest.mark.parametrize("kind", ["rnn_tanh", "lstm", "gru"])
def test_cell_params_and_shapes(kind):
    cell = _cell(mt, kind)
    outputs, _ = cell.unroll(3, _inputs(mt, 3))
    outputs = mt.sym.Group(outputs)
    assert sorted(cell.params._params.keys()) == \
        ["rnn_h2h_bias", "rnn_h2h_weight", "rnn_i2h_bias", "rnn_i2h_weight"]
    _, outs, _ = outputs.infer_shape(rnn_t0_data=(10, 50),
                                     rnn_t1_data=(10, 50),
                                     rnn_t2_data=(10, 50))
    assert outs == [(10, NH)] * 3


def test_lstm_forget_bias():
    forget_bias = 2.0
    stack = mt.rnn.SequentialRNNCell()
    stack.add(mt.rnn.LSTMCell(100, forget_bias=forget_bias, prefix="l0_"))
    stack.add(mt.rnn.LSTMCell(100, forget_bias=forget_bias, prefix="l1_"))
    sym, _ = stack.unroll(1, mt.sym.Variable("data"), merge_outputs=True)
    mod = mt.Module(sym, label_names=None, context=mt.cpu(0))
    mod.bind(data_shapes=[("data", (32, 1, 200))], label_shapes=None)
    mod.init_params()
    expected = np.hstack([np.zeros(100), forget_bias * np.ones(100),
                          np.zeros(200)])
    for name in ("l0_i2h_bias", "l1_i2h_bias"):
        np.testing.assert_allclose(mod.get_params()[0][name].asnumpy(),
                                   expected)


def test_stack_and_bidirectional_shapes():
    cell = mt.rnn.SequentialRNNCell()
    for i in range(5):
        cell.add(mt.rnn.LSTMCell(100, prefix="rnn_stack%d_" % i))
    outputs, _ = cell.unroll(3, _inputs(mt, 3))
    keys = sorted(cell.params._params.keys())
    for i in range(5):
        for part in ["h2h_weight", "h2h_bias", "i2h_weight", "i2h_bias"]:
            assert "rnn_stack%d_%s" % (i, part) in keys
    shapes = dict(rnn_t0_data=(10, 50), rnn_t1_data=(10, 50),
                  rnn_t2_data=(10, 50))
    assert mt.sym.Group(outputs).infer_shape(**shapes)[1] == \
        [(10, 100)] * 3
    bi = mt.rnn.BidirectionalCell(mt.rnn.LSTMCell(100, prefix="rnn_l0_"),
                                  mt.rnn.LSTMCell(100, prefix="rnn_r0_"),
                                  output_prefix="rnn_bi_")
    outputs, _ = bi.unroll(3, _inputs(mt, 3))
    assert mt.sym.Group(outputs).infer_shape(**shapes)[1] == \
        [(10, 200)] * 3
    fused = mt.rnn.FusedRNNCell(100, num_layers=3, mode="lstm",
                                prefix="test_", bidirectional=True,
                                dropout=0.5)
    outputs, _ = fused.unfuse().unroll(3, _inputs(mt, 3))
    assert mt.sym.Group(outputs).infer_shape(**shapes)[1] == \
        [(10, 200)] * 3


@pytest.mark.parametrize("wrap", ["zoneout", "residual", "dropout"])
def test_modifier_cell_shapes(wrap):
    base = mt.rnn.RNNCell(10, prefix="rnn_")
    cell = {"zoneout": lambda: mt.rnn.ZoneoutCell(
                base, zoneout_outputs=0.3, zoneout_states=0.3),
            "residual": lambda: mt.rnn.ResidualCell(base),
            "dropout": lambda: mt.rnn.DropoutCell(0.5)}[wrap]()
    inputs = [mt.sym.Variable("t%d_data" % i) for i in range(3)]
    outputs, _ = cell.unroll(3, inputs)
    _, outs, _ = mt.sym.Group(outputs).infer_shape(
        t0_data=(4, 10), t1_data=(4, 10), t2_data=(4, 10))
    assert outs == [(4, 10)] * 3
    # a training forward runs (zoneout and dropout draw their masks)
    args, _, _ = mt.sym.Group(outputs).infer_shape(
        t0_data=(4, 10), t1_data=(4, 10), t2_data=(4, 10))
    ex = mt.sym.Group(outputs).bind(mt.cpu(), {
        n: mt.nd.array(np.ones(s), ctx=mt.cpu()) for n, s in
        zip(mt.sym.Group(outputs).list_arguments(), args)})
    assert all(np.isfinite(o.asnumpy()).all()
               for o in ex.forward(is_train=True))


# --------------------------------------------- graphs held to mxnet_tpu
def _graph(pkg, kind):
    """(symbol, data input names) of one configuration in ``pkg``."""
    if kind in ("rnn_tanh", "rnn_relu", "lstm", "gru"):
        outs, states = _cell(pkg, kind).unroll(T, _inputs(pkg))
        return pkg.sym.Group(outs + states)
    if kind == "stack":
        cell = pkg.rnn.SequentialRNNCell()
        cell.add(pkg.rnn.LSTMCell(NH, prefix="l0_"))
        cell.add(pkg.rnn.GRUCell(NH, prefix="l1_"))
        outs, states = cell.unroll(T, pkg.sym.Variable("data"),
                                   merge_outputs=True)
        return pkg.sym.Group([outs] + states)
    if kind == "bidirectional":
        cell = pkg.rnn.BidirectionalCell(
            pkg.rnn.LSTMCell(NH, prefix="l0_"),
            pkg.rnn.GRUCell(NH, prefix="r0_"), output_prefix="bi_")
        outs, _ = cell.unroll(T, _inputs(pkg))
        return pkg.sym.Group(outs)
    if kind == "residual":
        cell = pkg.rnn.ResidualCell(pkg.rnn.GRUCell(NI, prefix="g_"))
        outs, _ = cell.unroll(T, _inputs(pkg))
        return pkg.sym.Group(outs)
    mode, bi = kind.split("-")[1], kind.endswith("bi")
    cell = pkg.rnn.FusedRNNCell(NH, num_layers=2, mode=mode,
                                bidirectional=bi, get_next_state=True,
                                prefix="f_")
    # float64 begin states: the JAX package's scan carries its states at
    # their own dtype, so float32 states cannot meet float64 steps there
    outs, states = cell.unroll(T, pkg.sym.Variable("data"),
                               begin_state=cell.begin_state(dtype="float64"),
                               merge_outputs=True)
    return pkg.sym.Group([outs] + states)


KINDS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "stack", "bidirectional",
         "residual", "fused-lstm", "fused-gru-bi", "fused-rnn_tanh-bi"]


def _shapes(net):
    return {n: ((BATCH, T, NI) if n == "data" else (BATCH, NI))
            for n in net.list_arguments() if n.endswith("data")}


def _run(pkg, net, args, heads):
    ctx = pkg.cpu()
    grads = {n: pkg.nd.zeros(v.shape, ctx=ctx, dtype=np.float64)
             for n, v in args.items()}
    ex = net.bind(ctx, args, args_grad=grads)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([pkg.nd.array(h, ctx=ctx, dtype=np.float64) for h in heads])
    return outs, {n: g.asnumpy() for n, g in grads.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_graph_matches_mxnet_tpu(kind, jx, tmp_path):
    """Outputs, final states and every input's gradient in float64, the
    inputs and parameters saved by the JAX package as ``.params`` and
    loaded by both."""
    nets = {}
    for key, pkg in (("port", mt), ("jax", jx)):
        with pkg.name.NameManager():     # the same automatic names
            nets[key] = _graph(pkg, kind)
    assert nets["port"].list_arguments() == nets["jax"].list_arguments()
    assert nets["port"].list_outputs() == nets["jax"].list_outputs()
    arg_shapes, out_shapes, _ = nets["port"].infer_shape(
        **_shapes(nets["port"]))
    assert (arg_shapes, out_shapes) == nets["jax"].infer_shape(
        **_shapes(nets["jax"]))[:2]
    rs = np.random.RandomState(0)
    vals = {n: rs.randn(*s) * 0.5
            for n, s in zip(nets["port"].list_arguments(), arg_shapes)}
    heads = [rs.randn(*s) for s in out_shapes]
    fname = str(tmp_path / "graph.params")
    jx.nd.save(fname, {n: jx.nd.array(v, ctx=jx.cpu(), dtype=np.float64)
                       for n, v in vals.items()})
    got, got_g = _run(mt, nets["port"], mt.nd.load(fname, ctx=mt.cpu()),
                      heads)
    want, want_g = _run(jx, nets["jax"], jx.nd.load(fname), heads)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) < TOL, ("output", i, _rel(g, w))
    for n in want_g:
        assert _rel(got_g[n], want_g[n]) < TOL, (n, _rel(got_g[n],
                                                         want_g[n]))


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True)])
def test_fused_equals_unfused(mode, bi, jx):
    """The fused graph and its unfused stack on weights moved by
    ``unpack_weights``; ``pack_weights`` gives the flat vector back; both
    as CPU NDArrays and as the JAX package's ``unpack_weights`` gives
    them."""
    layers = 2
    fused = mt.rnn.FusedRNNCell(NH, num_layers=layers, mode=mode,
                                bidirectional=bi, prefix="f_")
    fused._input_size_hint = NI
    fsym, _ = fused.unroll(T, mt.sym.Variable("data"), layout="NTC",
                           merge_outputs=True)
    usym, _ = fused.unfuse().unroll(T, mt.sym.Variable("data"),
                                    layout="NTC", merge_outputs=True)
    rs = np.random.RandomState(2)
    x = rs.randn(BATCH, T, NI)
    shapes = dict(zip(fsym.list_arguments(),
                      fsym.infer_shape(data=x.shape)[0]))
    # float32 values: unpack_weights returns float32 arrays, as the JAX
    # package's does
    pvec = (rs.randn(*shapes["f_parameters"]) * 0.3).astype(
        np.float32).astype(np.float64)
    fout = fsym.bind(mt.cpu(), {
        "data": mt.nd.array(x, ctx=mt.cpu(), dtype=np.float64),
        "f_parameters": mt.nd.array(pvec, ctx=mt.cpu(), dtype=np.float64)
    }).forward()[0].asnumpy()
    unpacked = fused.unpack_weights(
        {"f_parameters": mt.nd.array(pvec, ctx=mt.cpu(), dtype=np.float64)})
    # nd.array makes float32 of float64 numpy, as the JAX package's does
    assert all(v.context == mt.cpu() and v.dtype == np.float32
               for v in unpacked.values())
    unpacked = {k: mt.nd.array(v.asnumpy(), ctx=mt.cpu(), dtype=np.float64)
                for k, v in fused.unpack_weights({"f_parameters": mt.nd.array(
                    pvec, ctx=mt.cpu(), dtype=np.float64)}).items()}
    jfused = jx.rnn.FusedRNNCell(NH, num_layers=layers, mode=mode,
                                 bidirectional=bi, prefix="f_")
    jfused._input_size_hint = NI
    want = jfused.unpack_weights({"f_parameters": jx.nd.array(
        pvec, ctx=jx.cpu(), dtype=np.float64)})
    assert sorted(unpacked) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(unpacked[k].asnumpy(),
                                      want[k].asnumpy(), err_msg=k)
    if isinstance(usym, list):
        # a bidirectional cell returns its steps as a list
        usym = mt.sym.Concat(*[mt.sym.expand_dims(o, axis=1) for o in usym],
                             dim=1)
    uargs = dict(unpacked, data=mt.nd.array(x, ctx=mt.cpu(),
                                            dtype=np.float64))
    uout = usym.bind(mt.cpu(), uargs).forward()[0].asnumpy()
    assert fout.shape == uout.shape == (BATCH, T, NH * (2 if bi else 1))
    assert _rel(uout, fout) < TOL
    packed = fused.pack_weights(unpacked)["f_parameters"]
    assert packed.context == mt.cpu()
    np.testing.assert_array_equal(packed.asnumpy(), pvec)
    # the per-gate split of a cell and its inverse
    cell = fused.unfuse()._cells[0]
    if bi:
        cell = cell._cells[0]
    gates = cell.unpack_weights(unpacked)
    back = cell.pack_weights(gates)
    for k in unpacked:
        np.testing.assert_array_equal(back[k].asnumpy(),
                                      unpacked[k].asnumpy(), err_msg=k)


def test_fused_rnn_initializer():
    """``FusedRNN`` through ``Module.init_params``: every bias 0 but the
    LSTM forget gate's quarter, every weight from the inner initializer;
    the weights unpacked are Xavier-sized."""
    cell = mt.rnn.FusedRNNCell(NH, num_layers=2, mode="lstm", prefix="f_",
                               forget_bias=1.5)
    sym, _ = cell.unroll(T, mt.sym.Variable("data"), merge_outputs=True)
    mod = mt.Module(sym, label_names=None, context=mt.cpu())
    mod.bind([("data", (BATCH, T, NI))], None)
    mt.random.seed(0)
    mod.init_params()
    flat = mod.get_params()[0]["f_parameters"]
    cell._input_size_hint = NI
    parts = cell.unpack_weights({"f_parameters": flat})
    for name, v in parts.items():
        v = v.asnumpy()
        if name.endswith("_bias"):
            want = np.zeros(4 * NH)
            want[NH:2 * NH] = 1.5
            np.testing.assert_array_equal(v, want, err_msg=name)
        else:
            bound = np.sqrt(2.34 / v.shape[1])
            assert np.abs(v).max() <= bound and v.std() > bound / 4, name
    spec = mt.initializer.LSTMBias(forget_bias=0.5)
    arr = mt.nd.zeros((4 * NH,), ctx=mt.cpu())
    spec(mt.initializer.InitDesc("x_i2h_bias"), arr)
    assert arr.asnumpy()[NH:2 * NH].tolist() == [0.5] * NH
    assert not arr.asnumpy()[:NH].any() and not arr.asnumpy()[2 * NH:].any()


# ------------------------------------------------------------- the iterator
def test_bucket_sentence_iter_twin():
    sentences = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [1, 2], [3, 4, 5, 6]]
    it = mt.rnn.BucketSentenceIter(sentences, batch_size=1, buckets=[3, 5],
                                   invalid_label=0)
    seen = 0
    for batch in it:
        assert batch.data[0].shape[1] in (3, 5)
        assert batch.data[0].context == mt.cpu()
        assert batch.bucket_key == batch.data[0].shape[1]
        assert batch.provide_data[0].shape == batch.data[0].shape
        seen += 1
    assert seen == len(sentences)


def _walk(pkg, sentences, layout):
    random.seed(5)
    np.random.seed(5)
    it = pkg.rnn.BucketSentenceIter(sentences, batch_size=4,
                                    buckets=[3, 6], invalid_label=0,
                                    layout=layout)
    out = []
    for _ in range(2):
        for b in it:
            out.append((b.bucket_key, b.data[0].asnumpy(),
                        b.label[0].asnumpy(), tuple(b.provide_data[0].shape),
                        tuple(b.provide_label[0].shape)))
        it.reset()
    return it, out


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_mxnet_tpu(layout, jx):
    """Same seeds, same batches in the same order, over two epochs; the
    labels are the data shifted left by one and closed with the padding
    id."""
    rs = np.random.RandomState(0)
    sentences = [list(rs.randint(1, 20, rs.randint(1, 7)))
                 for _ in range(40)]
    it, got = _walk(mt, sentences, layout)
    _, want = _walk(jx, sentences, layout)
    assert it.default_bucket_key == 6
    assert it.provide_data[0].shape == ((4, 6) if layout == "NT" else (6, 4))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3:] == w[3:]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        data = g[1] if layout == "NT" else g[1].T
        label = g[2] if layout == "NT" else g[2].T
        np.testing.assert_array_equal(label[:, :-1], data[:, 1:])
        assert not label[:, -1].any()


def test_encode_sentences_matches_mxnet_tpu(jx):
    sents = [["a", "b", "c"], ["b", "\n", "d"], ["e"]]
    got = mt.rnn.encode_sentences(sents, invalid_label=1, start_label=0)
    want = jx.rnn.encode_sentences(sents, invalid_label=1, start_label=0)
    assert got == want
    with pytest.raises(mt.MXNetError):
        mt.rnn.encode_sentences([["z"]], vocab=got[1])
