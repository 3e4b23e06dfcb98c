"""mxnet_tpu_torch serving: twins of the core tests/python/unittest/
test_serving.py cases (ladder, coalescing, padded rows never leak, results
equal a direct Predictor, multi-model hosting), on the CPU, plus the served
rows against mxnet_tpu's Predictor."""
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import name as jname
from mxnet_tpu.models import mlp as jmlp
from mxnet_tpu.predictor import Predictor as JPredictor
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState


def _mlp(num_classes=4, dim=16, seed=0):
    """A small deterministic MLP (mxnet_tpu's builder, loaded from JSON):
    (port symbol, CPU params blob, numpy params)."""
    with jname.NameManager():
        jsym = jmlp.get_symbol(num_classes=num_classes)
    sym = mt.sym.load_json(jsym.tojson())
    rng = RS(seed)
    shapes, _, _ = sym.infer_shape(data=(1, dim))
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return sym, mt.convert.params_from_numpy(params, {}, ctx=mt.cpu()), \
        params


def _model(max_batch=8, max_wait_ms=200, **kwargs):
    sym, blob, _ = _mlp()
    return serving.ServedModel(sym, blob, {"data": (16,)}, name="t",
                               max_batch=max_batch, max_wait_ms=max_wait_ms,
                               dev_type="cpu", **kwargs), sym, blob


def _predictor(sym, blob, n):
    return mt.Predictor(sym, blob, {"data": (n, 16)}, dev_type="cpu")


# ------------------------------------------------------------------- ladder
def test_bucket_ladder():
    assert serving.bucket_ladder(8) == [1, 2, 4, 8]
    assert serving.bucket_ladder(6) == [1, 2, 4, 6]
    assert serving.bucket_ladder(1) == [1]
    assert serving.bucket_ladder(2) == [1, 2]
    with pytest.raises(MXNetError):
        serving.bucket_ladder(0)


def test_custom_buckets_and_bucket_for():
    model, _, _ = _model(buckets=[6, 2, 2])
    try:
        assert model.buckets == [2, 6]
        assert model.max_batch == 6
        assert model._bucket_for(1) == 2
        assert model._bucket_for(3) == 6
        assert model._bucket_for(6) == 6
    finally:
        model.close()
    with pytest.raises(MXNetError, match="bucket sizes"):
        _model(buckets=[0, 8])
    with pytest.raises(MXNetError, match="integers"):
        _model(buckets=[2.5, 8])


# --------------------------------------------------------------- validation
def test_served_model_rejects_unknown_input_types():
    sym, blob, _ = _mlp()
    with pytest.raises(MXNetError, match="input_types"):
        serving.ServedModel(sym, blob, {"data": (16,)}, dev_type="cpu",
                            input_types={"dta": np.int32})


def test_invalid_env_defaults_ignored_when_overridden(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_MAX_BATCH", "0")
    monkeypatch.setenv("MXNET_SERVE_WAIT_MS", "-5")
    model, _, _ = _model(max_batch=4, max_wait_ms=1)   # overrides both
    model.close()
    with pytest.raises(MXNetError, match="MXNET_SERVE_WAIT_MS"):
        _model(max_batch=4, max_wait_ms=None)
    monkeypatch.setenv("MXNET_SERVE_WAIT_MS", "7")
    with pytest.raises(MXNetError, match="MXNET_SERVE_MAX_BATCH"):
        _model(max_batch=None, max_wait_ms=1)
    model, _, _ = _model(max_batch=None, max_wait_ms=None, buckets=[2])
    assert model._wait_s == pytest.approx(7e-3)
    model.close()


def test_submit_validation():
    model, _, _ = _model()
    try:
        with pytest.raises(MXNetError, match="missing input"):
            model.submit({})
        with pytest.raises(MXNetError, match="per-sample"):
            model.submit({"data": np.zeros((2, 16), np.float32)})
        with pytest.raises(MXNetError, match="unknown request inputs"):
            model.submit({"data": np.zeros(16, np.float32), "bogus": 1})
    finally:
        model.close()
    with pytest.raises(MXNetError, match="closed"):
        model.submit({"data": np.zeros(16, np.float32)})
    model.close()   # idempotent


# ------------------------------------------------- batching & padding contract
def test_coalesced_batch_matches_padding_free_forward():
    """5 in-flight requests coalesce into ONE bucket-8 forward whose rows
    equal a padding-free Predictor forward of the same 5 samples: the 3
    padded rows never leak.  PyTorch's CPU GEMM blocks an 8-row and a 5-row
    product differently, so rows agree to the last ulps, not bitwise
    (padding that leaked would show at the 1e-1 scale)."""
    model, sym, blob = _model(max_wait_ms=300)
    x = RS(1).randn(5, 16).astype(np.float32)
    try:
        futs = [model.submit({"data": x[i]}) for i in range(5)]
        outs = [f.result(60) for f in futs]
        st = model.stats()
        assert st["batches"] == 1 and st["requests"] == 5
        assert st["batches_by_bucket"] == {8: 1}
        assert st["padded_slots"] == 3
        assert st["occupancy"] == pytest.approx(5 / 8)
        ref = _predictor(sym, blob, 5)
        ref.forward(data=x)
        want = ref.get_output(0)
        for i in range(5):
            np.testing.assert_allclose(outs[i][0], want[i], rtol=1e-6,
                                       atol=1e-7)
    finally:
        model.close()


def test_single_request_matches_unbatched_predictor_bitwise():
    """A lone request rides the bucket-1 binding, the program an unbatched
    Predictor runs, so the bytes agree."""
    model, sym, blob = _model(max_wait_ms=1)
    x = RS(2).randn(16).astype(np.float32)
    try:
        out = model.predict({"data": x}, timeout=60)
        st = model.stats()
        assert st["batches_by_bucket"] == {1: 1}
        assert st["padded_slots"] == 0
        p1 = _predictor(sym, blob, 1)
        p1.forward(data=x[None])
        np.testing.assert_array_equal(out[0], p1.get_output(0)[0])
    finally:
        model.close()


def test_co_traffic_content_never_leaks():
    """The same request served twice with different companions (same
    bucket) returns bit-identical rows."""
    model, _, _ = _model(max_wait_ms=300)
    rng = RS(3)
    probe = rng.randn(16).astype(np.float32)
    try:
        rounds = []
        for _ in range(2):
            mates = rng.randn(2, 16).astype(np.float32)
            futs = [model.submit({"data": probe})] + \
                   [model.submit({"data": mates[i]}) for i in range(2)]
            rounds.append(futs[0].result(60))
            for f in futs[1:]:
                f.result(60)
        assert model.stats()["batches_by_bucket"] == {4: 2}
        np.testing.assert_array_equal(rounds[0][0], rounds[1][0])
    finally:
        model.close()


def test_deadline_serves_lone_request():
    model, _, _ = _model(max_wait_ms=50)
    try:
        t0 = time.perf_counter()
        model.predict({"data": np.zeros(16, np.float32)}, timeout=60)
        assert time.perf_counter() - t0 < 30
        assert model.stats()["batches"] == 1
    finally:
        model.close()


def test_submit_copies_caller_buffer():
    model, sym, blob = _model(max_wait_ms=300)
    rng = RS(8)
    a, b = rng.randn(2, 16).astype(np.float32)
    buf = np.array(a)
    try:
        f1 = model.submit({"data": buf})
        buf[:] = b                         # mutate before the batch runs
        f2 = model.submit({"data": buf})
        r1, r2 = f1.result(60), f2.result(60)
        ref = _predictor(sym, blob, 2)
        ref.forward(data=np.stack([a, b]))
        want = ref.get_output(0)
        np.testing.assert_array_equal(r1[0], want[0])   # still sample a
        np.testing.assert_array_equal(r2[0], want[1])
    finally:
        model.close()


def test_bucket_ladder_shares_one_weight_set():
    model, _, _ = _model()
    try:
        model.warm()
        w1 = model._predictors[1]._executor.arg_dict["fc1_weight"]
        for b in model.buckets[1:]:
            assert model._predictors[b]._executor.arg_dict["fc1_weight"] \
                is w1
    finally:
        model.close()


def test_warm_compiles_whole_ladder():
    model, _, _ = _model()
    try:
        assert model._predictors == {}
        model.warm()
        assert sorted(model._predictors) == model.buckets
        out = model.predict({"data": np.ones(16, np.float32)}, timeout=60)
        assert out[0].shape == (4,)
    finally:
        model.close()


def test_forward_error_scatters_to_every_future():
    model, _, _ = _model(max_wait_ms=200)
    try:
        def boom(bucket):
            raise RuntimeError("bucket exploded")
        model._predictor = boom
        futs = [model.submit({"data": np.zeros(16, np.float32)})
                for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="bucket exploded"):
                f.result(60)
        assert model.stats()["errors"] == 3
        del model._predictor
        out = model.predict({"data": np.zeros(16, np.float32)}, timeout=60)
        assert out[0].shape == (4,)                 # batcher survived
    finally:
        model.close()


# -------------------------------------------------------------- multi-model
def test_server_multi_model_hosting():
    srv = serving.Server()
    sym, blob, _ = _mlp()
    sym2, blob2, _ = _mlp(num_classes=7, seed=5)
    try:
        srv.register("a", symbol=sym, param_blob=blob,
                     input_shapes={"data": (16,)}, max_wait_ms=1,
                     dev_type="cpu")
        srv.register("b", symbol=sym2, param_blob=blob2,
                     input_shapes={"data": (16,)}, max_wait_ms=1,
                     dev_type="cpu")
        x = RS(4).randn(16).astype(np.float32)
        assert srv.predict("a", {"data": x})[0].shape == (4,)
        assert srv.predict("b", {"data": x})[0].shape == (7,)
        stats = srv.models()
        assert sorted(stats) == ["a", "b"]
        assert stats["a"]["requests"] == 1 and stats["b"]["requests"] == 1
        with pytest.raises(MXNetError, match="no model"):
            srv.predict("c", {"data": x})
        srv.unregister("a")
        assert sorted(srv.models()) == ["b"]
        srv.unregister("a")   # absent: no-op
        with pytest.raises(MXNetError, match="ServedModel"):
            srv.register("bad", model=object())
        pre = serving.ServedModel(sym, blob, {"data": (16,)}, max_wait_ms=1,
                                  dev_type="cpu")
        assert srv.register("prod", model=pre) is pre
        assert pre.name == "prod"
        with pytest.raises(MXNetError, match="no build kwargs"):
            srv.register("prod2", model=pre, max_batch=4)
    finally:
        srv.close()
    assert srv.models() == {}


def test_register_checkpoint_rows_equal_mxnet_tpu(tmp_path):
    """A checkpoint pair written by mxnet_tpu, served by the port, answers
    what mxnet_tpu's Predictor answers."""
    sym, _, params = _mlp()
    prefix = str(tmp_path / "served")
    sym.save(prefix + "-symbol.json")
    mx.nd.save(prefix + "-0002.params",
               {"arg:" + k: mx.nd.array(v) for k, v in params.items()})
    x = RS(9).randn(3, 16).astype(np.float32)
    jp = JPredictor.from_checkpoint(prefix, 2, {"data": (3, 16)})
    jp.forward(data=x)
    want = jp.get_output(0)
    srv = serving.Server()
    try:
        srv.register_checkpoint("mlp", prefix, 2, {"data": (16,)},
                                max_wait_ms=300, dev_type="cpu")
        futs = [srv.submit("mlp", {"data": x[i]}) for i in range(3)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(60)[0], want[i], rtol=1e-5,
                                       atol=1e-6)
    finally:
        srv.close()
