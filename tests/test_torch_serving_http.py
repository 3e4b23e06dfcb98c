"""The HTTP front end of the port's serving layer on the CPU (twins of
tests/python/unittest/test_serving.py's ``test_http_front_end`` and
``test_http_concurrent_clients_coalesce``), held to the JAX package's front
end serving the same checkpoint: the same routes and status codes (400 a
request fault, 500 a fault of the forward, 504 a timeout, 404 an unknown
route or model), and the same rows within float32 rounding.
``MXNET_SERVE_PORT`` starts the port's endpoint at import.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.serving  # noqa: F401
    return mx


def _mlp(seed=0):
    """The MLP (16 in, 4 classes) with seed-``seed`` numpy weights."""
    sym = mt.models.get_mlp(num_classes=4)
    rng = RS(seed)
    shapes, _, _ = sym.infer_shape(data=(1, 16))
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return sym, params


def _port_params(params):
    return {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}


def _post(url, doc):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req).read())


def _code(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code, json.loads(e.value.read())


def test_http_front_end(mx):
    sym, params = _mlp()
    srv = serving.Server()
    srv.register("mlp", symbol=sym, param_blob=_port_params(params),
                 input_shapes={"data": (16,)}, max_wait_ms=1,
                 dev_type="cpu")
    port = serving.start_server(port=0, registry=srv)
    base = "http://127.0.0.1:%d" % port
    jsrv = mx.serving.Server()
    jsrv.register("mlp", symbol=sym.tojson(),
                  param_blob={k: mx.nd.array(v) for k, v in params.items()},
                  input_shapes={"data": (16,)}, max_wait_ms=1)
    jport = mx.serving.start_server(port=0, registry=jsrv)
    jbase = "http://127.0.0.1:%d" % jport
    try:
        assert serving.server_port() == port
        assert serving.start_server(port=0, registry=srv) == port
        for b in (base, jbase):
            health = json.loads(urllib.request.urlopen(b + "/healthz").read())
            assert health == {"ok": True, "models": ["mlp"]}
        models = json.loads(urllib.request.urlopen(base + "/models").read())
        jmodels = json.loads(urllib.request.urlopen(jbase + "/").read())
        assert models["models"]["mlp"]["inputs"] == {"data": [16]} == \
            jmodels["models"]["mlp"]["inputs"]

        x = RS(5).randn(16).astype(np.float32)
        doc = _post(base + "/predict/mlp", {"inputs": {"data": x.tolist()}})
        want = srv.predict("mlp", {"data": x})[0]
        np.testing.assert_array_equal(
            np.asarray(doc["outputs"][0], np.float32), want)
        jdoc = _post(jbase + "/predict/mlp",
                     {"inputs": {"data": x.tolist()}})
        assert doc["model"] == jdoc["model"] == "mlp"
        np.testing.assert_allclose(np.asarray(doc["outputs"][0]),
                                   np.asarray(jdoc["outputs"][0]),
                                   rtol=1e-5, atol=1e-7)
        doc2 = _post(base + "/predict/mlp",
                     {"data": x.tolist(), "timeout_s": 30})
        assert doc2["outputs"] == doc["outputs"]

        bad = [
            lambda b: _post(b + "/predict/nope", {"data": x.tolist()}),
            lambda b: _post(b + "/predict/mlp", {"inputs": {"data": [0.0]}}),
            lambda b: urllib.request.urlopen(b + "/nope"),
            lambda b: _post(b + "/nope", {"data": x.tolist()}),
            lambda b: _post(b + "/predict/mlp", ["not", "an", "object"]),
            lambda b: _post(b + "/predict/mlp",
                            {"inputs": {"data": x.tolist()},
                             "timeout_s": None}),
            lambda b: _post(b + "/predict/mlp",
                            {"inputs": {"data": {"a": 1}}}),
            lambda b: _post(b + "/predict/mlp", {"inputs": [1, 2]}),
        ]
        codes = [_code(lambda: f(base))[0] for f in bad]
        assert codes == [404, 400, 404, 404, 400, 400, 400, 400]
        assert codes == [_code(lambda: f(jbase))[0] for f in bad]

        # non-finite outputs stay RFC 8259 JSON, as strings
        nan = {k: np.full(v.shape, np.nan, np.float32)
               for k, v in params.items()}
        srv.register("nan", symbol=sym, param_blob=_port_params(nan),
                     input_shapes={"data": (16,)}, max_wait_ms=1,
                     dev_type="cpu")
        doc3 = _post(base + "/predict/nan", {"inputs": {"data": x.tolist()}})
        assert doc3["outputs"][0][0] == "nan"

        # a fault of the forward, MXNetError too, answers 500 JSON
        model = srv.model("mlp")
        for exc in (RuntimeError("forward exploded"),
                    MXNetError("bind exploded")):
            model._predictor = (lambda err: lambda b: (_ for _ in ())
                                .throw(err))(exc)
            code, body = _code(lambda: _post(
                base + "/predict/mlp", {"inputs": {"data": x.tolist()}}))
            assert code == 500 and str(exc) in body["error"]
        # a forward slower than the request's timeout_s answers 504
        slow = threading.Event()

        def stall(b):
            slow.wait(10)
            raise RuntimeError("released")
        model._predictor = stall
        code, body = _code(lambda: _post(
            base + "/predict/mlp",
            {"inputs": {"data": x.tolist()}, "timeout_s": 0.2}))
        slow.set()
        assert code == 504 and "timed out" in body["error"]
        del model._predictor
    finally:
        serving.stop_server()
        srv.close()
        mx.serving.stop_server()
        jsrv.close()
    assert serving.server_port() is None
    serving.stop_server()   # idempotent


def test_http_concurrent_clients_coalesce(mx):
    """Eight concurrent posts ride the server's request threads into the
    batcher: at least one forward serves more than one request, and every
    client gets its row, the row the JAX package's Predictor gives for
    the whole batch (float32 rounding)."""
    sym, params = _mlp()
    srv = serving.Server()
    model = srv.register("mlp", symbol=sym, param_blob=_port_params(params),
                         input_shapes={"data": (16,)}, max_batch=8,
                         max_wait_ms=100, dev_type="cpu")
    model.warm()
    port = serving.start_server(port=0, registry=srv)
    base = "http://127.0.0.1:%d" % port
    x = RS(6).randn(8, 16).astype(np.float32)
    results = [None] * 8
    try:
        def client(i):
            doc = _post(base + "/predict/mlp",
                        {"inputs": {"data": x[i].tolist()}})
            results[i] = np.asarray(doc["outputs"][0], np.float32)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        st = model.stats()
        assert st["requests"] == 8
        assert st["batches"] < 8            # something coalesced
        ref = mt.Predictor(sym, _port_params(params), {"data": (8, 16)},
                           dev_type="cpu")
        ref.forward(data=x)
        jref = mx.predictor.Predictor(
            sym.tojson(), {k: mx.nd.array(v) for k, v in params.items()},
            {"data": (8, 16)})
        jref.forward(data=x)
        for i in range(8):
            np.testing.assert_allclose(results[i], ref.get_output(0)[i],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(results[i], jref.get_output(0)[i],
                                       rtol=1e-5, atol=1e-7)
    finally:
        serving.stop_server()
        srv.close()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


AUTOSTART = r"""
import json, sys, urllib.request
import numpy as np
import mxnet_tpu_torch as mt
port = mt.serving.server_port()
sym = mt.models.get_mlp(num_classes=4)
shapes, _, _ = sym.infer_shape(data=(1, 16))
params = {n: mt.nd.array(np.full(s, 0.01, np.float32), ctx=mt.cpu())
          for n, s in zip(sym.list_arguments(), shapes)
          if n not in ("data", "softmax_label")}
mt.serving.default_server().register(
    "mlp", symbol=sym, param_blob=params, input_shapes={"data": (16,)},
    max_wait_ms=1, dev_type="cpu")
base = "http://127.0.0.1:%d" % port
health = json.loads(urllib.request.urlopen(base + "/healthz").read())
req = urllib.request.Request(base + "/predict/mlp", data=json.dumps(
    {"data": [1.0] * 16}).encode())
out = json.loads(urllib.request.urlopen(req).read())["outputs"][0]
print(json.dumps({"port": port, "health": health, "row": out}))
mt.serving.stop_server()
mt.serving.default_server().close()
"""


def test_serve_port_env_autostarts():
    """``MXNET_SERVE_PORT=<host>:<port>`` starts the endpoint at import on
    that port, serving :func:`default_server`; a malformed value warns and
    starts nothing; unset starts nothing."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT,
               MXNET_SERVE_PORT="127.0.0.1:%d" % port)
    res = subprocess.run([sys.executable, "-c", AUTOSTART], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    assert doc["port"] == port
    assert doc["health"] == {"ok": True, "models": ["mlp"]}
    assert len(doc["row"]) == 4 and abs(sum(doc["row"]) - 1) < 1e-5
    code = ("import warnings, mxnet_tpu_torch as mt; "
            "print(mt.serving.server_port())")
    for value, warn in (("not-a-port", True), ("0", False), (None, False)):
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("MXNET_SERVE_PORT", None)
        if value is not None:
            env["MXNET_SERVE_PORT"] = value
        res = subprocess.run([sys.executable, "-W", "always", "-c", code],
                             env=env, capture_output=True, text=True,
                             timeout=300, cwd=ROOT)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip().splitlines()[-1] == "None"
        assert ("serving endpoint disabled" in res.stderr) == warn


def test_default_server_is_one_registry(monkeypatch):
    monkeypatch.delenv("MXNET_SERVE_PORT", raising=False)
    assert serving.default_server() is serving.default_server()
    assert serving.start_server() is None       # MXNET_SERVE_PORT unset
    assert serving.server_port() is None
    t0 = time.perf_counter()
    serving.stop_server()
    assert time.perf_counter() - t0 < 1.0
