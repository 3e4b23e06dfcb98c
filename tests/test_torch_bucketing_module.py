"""BucketingModule and shared binding in mxnet_tpu_torch against mxnet_tpu,
on the CPU.

- ``BucketingModule.fit`` of a one-layer LSTM language model (vocabulary
  20, hidden 8, buckets 3 and 6, batch 4, 2 epochs of SGD-momentum, the
  example's ``Perplexity(0)``), with the ``LSTMCell`` stack and with a
  ``FusedRNNCell``, from the same numpy parameters and under the same
  ``random`` / ``np.random`` seeds as the JAX package's fit: every
  parameter within FLOOR_X times its own float32 floor (the distance
  between the JAX package's fit and its fit from parameters nudged by
  NUDGE relative, FLOOR_MIN at least), the rule of the Module fit tests,
  and the training perplexity beside it.
- The buckets share storage: one parameter, gradient and aux tensor for
  every bucket (``data_ptr`` equality), each bucket bound once, one
  optimizer and ``Updater``; ``get_params`` / ``set_params`` and a
  checkpoint of the default bucket scoring the same.
- ``Module.bind(shared_module=...)`` and ``borrow_optimizer``; the
  refusals; ``BucketingModule()`` on ``gpu(0)``.
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt

V, H, E, BATCH = 20, 8, 8, 4
BUCKETS = [3, 6]
FLOOR_X = 4.0
FLOOR_MIN = 1e-6
NUDGE = 2.0 ** -20
SGD = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-5}


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _sentences(n=48, seed=0):
    """A Markov chain over V - 1 words (0 is the padding id), lengths 2-6,
    so both buckets fill."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        w = rs.randint(1, V)
        sent = [w]
        for _ in range(rs.randint(1, 6)):
            w = (w * 3 + 1) % (V - 1) + 1 if rs.rand() < 0.9 \
                else rs.randint(1, V)
            sent.append(w)
        out.append(sent)
    return out


def _sym_gen(pkg, cell):
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data=data, input_dim=V, output_dim=E,
                                  name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, H))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=V, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        return (pkg.sym.SoftmaxOutput(data=pred, label=label, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _cell(pkg, kind):
    if kind == "fused":
        return pkg.rnn.FusedRNNCell(H, num_layers=1, mode="lstm",
                                    prefix="lstm_")
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(H, prefix="lstm_l0_"))
    return stack


def _module(pkg, kind):
    random.seed(3)
    np.random.seed(3)
    it = pkg.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=list(BUCKETS),
                                    invalid_label=0)
    mod = pkg.module.BucketingModule(_sym_gen(pkg, _cell(pkg, kind)),
                                     default_bucket_key=it.default_bucket_key,
                                     context=pkg.cpu())
    return it, mod


def _params(kind, seed=1, nudge=0.0):
    """Numpy parameters of the default bucket's graph for both packages."""
    net = _sym_gen(mt, _cell(mt, kind))(max(BUCKETS))[0]
    shapes = {"data": (BATCH, max(BUCKETS)),
              "softmax_label": (BATCH, max(BUCKETS))}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    out = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        v = rs.uniform(-1, 1, s) * np.sqrt(3.0 / max(1, np.prod(s[1:])))
        out[n] = (v * (1 + nudge * rs.uniform(-1, 1, s))).astype(np.float32)
    return out


def _fit(pkg, kind, args, epochs=2):
    it, mod = _module(pkg, kind)
    metric = pkg.metric.Perplexity(0)
    mod.fit(it, num_epoch=epochs, eval_metric=metric, optimizer="sgd",
            optimizer_params=dict(SGD),
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()}, aux_params={})
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}, metric.get()[1]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("kind", ["lstm", "fused"])
def test_bucketing_fit_matches_mxnet_tpu(kind, mx):
    args = _params(kind)
    mod, got, got_ppl = _fit(mt, kind, args)
    _, want, want_ppl = _fit(mx, kind, args)
    _, nudged, _ = _fit(mx, kind, _params(kind, nudge=NUDGE))
    assert sorted(mod._buckets) == BUCKETS
    assert sorted(got) == sorted(want)
    for k in want:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, \
            (k, _rel(got[k], want[k]), floor)
        # training moved every parameter
        assert _rel(got[k], args[k]) > 1e-4, k
    assert abs(got_ppl - want_ppl) <= 1e-4 * want_ppl


def _storage(mod):
    """{bucket: ({arg: data_ptr}, {grad: data_ptr})} of each bucket's
    executor."""
    out = {}
    for key, m in mod._buckets.items():
        ex = m._exec_group.execs[0]
        out[key] = ({n: a.value.data_ptr() for n, a in ex.arg_dict.items()},
                    {n: a.value.data_ptr() for n, a in ex.grad_dict.items()})
    return out


def test_buckets_share_storage_and_optimizer():
    """Every bucket binds once onto the default bucket's tensors, and
    switching buckets copies no parameter: the pointers stay as they were
    bound through a whole fit."""
    it, mod = _module(mt, "lstm")
    binds = []
    orig = mt.module.Module.bind

    def counting_bind(self, *a, **k):
        binds.append(k.get("shared_module") is not None)
        return orig(self, *a, **k)
    mt.module.Module.bind = counting_bind
    try:
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(SGD),
                eval_metric=mt.metric.Perplexity(0))
        before = _storage(mod)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(SGD),
                eval_metric=mt.metric.Perplexity(0))
    finally:
        mt.module.Module.bind = orig
    assert binds == [False, True]          # the default, then bucket 3
    assert _storage(mod) == before
    params = mod._buckets[6]._param_names
    (a3, g3), (a6, g6) = before[3], before[6]
    for n in params:
        assert a3[n] == a6[n] and g3[n] == g6[n], n
    assert a3["data"] != a6["data"]
    m3, m6 = mod._buckets[3], mod._buckets[6]
    assert m3._updater is m6._updater and m3._optimizer is m6._optimizer
    assert m3._arg_params is m6._arg_params


class _Batches(object):
    """One walk of an iterator, kept: ``BucketSentenceIter.reset``
    reshuffles its rows in place, so two walks never read the same
    batches."""

    def __init__(self, it):
        self.batches = list(it)

    def __iter__(self):
        return iter(self.batches)

    def reset(self):
        pass


def _score(mod, batches):
    return mod.score(batches, mt.metric.Perplexity(0))


def test_bucketing_params_and_checkpoint(tmp_path):
    """``get_params`` reads the trained tensors; ``set_params`` and a
    checkpoint of the default bucket loaded by ``Module.load`` score the
    same on a fresh BucketingModule."""
    it, mod = _module(mt, "fused")
    mod.fit(it, num_epoch=2, optimizer="sgd", optimizer_params=dict(SGD),
            eval_metric=mt.metric.Perplexity(0))
    batches = _Batches(it)
    score = _score(mod, batches)
    arg, aux = mod.get_params()
    w = mod._buckets[3]._exec_group.execs[0].arg_dict["pred_weight"]
    np.testing.assert_array_equal(arg["pred_weight"].asnumpy(), w.asnumpy())
    prefix = str(tmp_path / "lm")
    default = mod._buckets[it.default_bucket_key]
    mt.model.save_checkpoint(prefix, 2, default.symbol, arg, aux)
    loaded = mt.Module.load(prefix, 2, context=mt.cpu())
    assert loaded.symbol.tojson() == default.symbol.tojson()
    _, fresh = _module(mt, "fused")
    fresh.bind(it.provide_data, it.provide_label, for_training=False)
    fresh.set_params(loaded._arg_params, loaded._aux_params)
    assert _score(fresh, batches) == score
    with pytest.raises(mt.MXNetError, match="observability slice"):
        fresh.install_monitor(object())


def test_module_bind_shared_module_and_borrow_optimizer():
    """A Module bound with ``shared_module`` takes the other's tensors and
    host dicts (no copy), and its optimizer once it has one."""
    net = mt.models.get_mlp(num_classes=4)
    a = mt.Module(net, context=mt.cpu())
    a.bind([("data", (8, 1, 12, 12))], [("softmax_label", (8,))])
    a.init_params()
    a.init_optimizer(optimizer_params={"learning_rate": 0.1})
    b = mt.Module(net, context=mt.cpu())
    b.bind([("data", (4, 1, 12, 12))], [("softmax_label", (4,))],
           shared_module=a)
    assert b.params_initialized and b.optimizer_initialized
    assert b._arg_params is a._arg_params and b._updater is a._updater
    ea, eb = a._exec_group.execs[0], b._exec_group.execs[0]
    for n in a._param_names:
        assert ea.arg_dict[n] is eb.arg_dict[n]
        assert ea.grad_dict[n] is eb.grad_dict[n]
    assert ea.arg_dict["data"].shape != eb.arg_dict["data"].shape
    # simple_bind shares only what matches in name and shape
    other = net.simple_bind(mt.cpu(), data=(2, 1, 12, 12))
    ex = net.simple_bind(mt.cpu(), shared_exec=other, data=(2, 1, 12, 12))
    assert all(ex.arg_dict[n] is other.arg_dict[n] for n in ex.arg_dict)
    ex = net.simple_bind(mt.cpu(), shared_exec=other, data=(3, 1, 12, 12))
    assert ex.arg_dict["data"] is not other.arg_dict["data"]
    assert ex.arg_dict["fc1_weight"] is other.arg_dict["fc1_weight"]


def test_bucketing_module_runs_on_the_card_by_default():
    gen = _sym_gen(mt, _cell(mt, "lstm"))
    if torch.cuda.is_available():
        assert mt.mod.BucketingModule(gen, 6)._context == mt.gpu(0)
    else:
        with pytest.raises(mt.MXNetError, match="CUDA"):
            mt.mod.BucketingModule(gen, 6)


@pytest.mark.parametrize("cell", ["fused", "lstm"])
def test_lstm_bucketing_bench_at_toy_size(cell):
    """``bench/lstm_bucketing.py``'s fit on the host at toy widths: every
    bucket bound, the record's counts (its rates are the card's only)."""
    from mxnet_tpu_torch.bench import lstm_bucketing as lb
    corpus = lb.synthetic_corpus(words=20, batches_per_bucket=2, batch=4,
                                 buckets=(3, 6))
    lengths = [len(s) for s in corpus]
    assert min(lengths) >= 2 and max(lengths) <= 6
    assert sum(n <= 3 for n in lengths) >= 8
    assert sum(n > 3 for n in lengths) >= 8
    rec, mod, _, _ = lb.run(cell, epochs=1, batches_per_bucket=2,
                            ctx=mt.cpu(), num_hidden=8, num_embed=8,
                            words=20, batch=4, buckets=(3, 6))
    assert rec["buckets_bound"] == [3, 6] == sorted(mod._buckets)
    assert rec["cudnn_calls"] == 0 and rec["batches"] >= 4
    assert rec["tokens"] > 0 and len(rec["train_perplexity"]) == 1
    assert "device_busy_share" not in rec       # measured on a card only
