"""The distributed slice's runtime in mxnet_tpu_torch against mxnet_tpu, on
the CPU: two ranks over gloo, started by the port's launcher.

- The twin of tests/python/dist/dist_sync_kvstore.py (``bench/
  dist_sync_kvstore.py``, one launch): exact values on a 2x2 and a
  1200x1200 key, the no-updater replace semantics, one collective a push,
  ``allreduce_arrays`` over three dtypes in one call, the store's
  ``kv_set`` / ``kv_get`` and barriers (one from a thread),
  ``health_check`` and ``num_dead_node``.
- The twin of tests/python/dist/dist_mlp.py (``bench/dist_mlp.py``, one
  launch): the ranks' replicas bitwise equal, above 0.9 accuracy, and the
  final parameters and the store's momenta within 1e-5 of their largest
  entry of the JAX package's in-process ``Module`` fit over two contexts
  with the ``device`` store, from the same ``.params`` and the same data
  halves (context k takes rank k's rows of each batch: the same sums, and
  both take 1/50 as rescale_grad).  The same launch saves a checkpoint
  through an asynchronous ``Checkpointer``: the two ranks write its shards
  round-robin (rank 1 the second group), and its shard files are byte
  equal, and its manifest equal but for the world and the writers' ranks,
  to a one-rank save of the same state.
- The six ``dist*`` types in one process: rank 0 of 1, the JAX package's
  push/pull results, ``Module.fit(kvstore="dist_sync")`` against the JAX
  package's (general path, the update on the store).
- The launcher: a rank's failure kills the world; ``--max-restarts`` with
  ``MXTPU_RESTART_COUNT``; ``ssh`` and ``--elastic`` refused; a peer that
  never comes is an error after ``init_process_group``'s timeout.

Each launch runs under ``launch()``: a timeout that kills the process
groups it started.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as pmodels
from mxnet_tpu_torch import launch as plaunch
from mxnet_tpu_torch.parallel import dist
from test_torch_threads import child_env
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_TYPES = ("dist_sync", "dist_async", "dist_sync_device",
              "dist_async_device", "dist", "dist_tpu")
TOL = 1e-5
SCALE_MIN = 1e-4
MLP_EPOCHS = 8


def launch(args, timeout=120, env=None):
    """Run a command in a session of its own with the repo importable and
    no MXTPU_* variables of ours; on timeout kill its process group.
    Returns (rc, stdout, stderr)."""
    full = {k: v for k, v in child_env().items()
            if not k.startswith("MXTPU_")}
    full["PYTHONPATH"] = ROOT
    full.update(env or {})
    p = subprocess.Popen(args, cwd=ROOT, env=full, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail("timed out after %d s: %s\n%s" % (timeout, out, err))
    return p.returncode, out, err


def launch_n(n, module, *args, timeout=120, env=None):
    return launch([sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
                   str(n), sys.executable, "-m", module] + list(args),
                  timeout=timeout, env=env)


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


# ------------------------------------------------------------- kvstore twin
@pytest.fixture(scope="module")
def kvstore_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("kvstore")
    rc, so, se = launch_n(2, "mxnet_tpu_torch.bench.dist_sync_kvstore",
                          "--out", str(out))
    rows = [json.loads(open(os.path.join(out, "rank%d.json" % r)).read())
            for r in range(2) if os.path.exists(
                os.path.join(out, "rank%d.json" % r))]
    return rc, rows, so + se


def test_dist_sync_kvstore_twin_exact(kvstore_run):
    rc, rows, log = kvstore_run
    assert rc == 0, log
    assert [r["rank"] for r in rows] == [0, 1]
    for r in rows:
        assert r["world"] == 2 and r["route"] == "gloo"
        for name in ("small_key", "big_key", "replace", "world",
                     "on_context"):
            assert r["checks"][name], (name, r)


def test_dist_sync_kvstore_twin_collectives(kvstore_run):
    """One collective a push, and one a dtype in one allreduce_arrays
    call; the inputs are not changed."""
    rc, rows, log = kvstore_run
    assert rc == 0, log
    for r in rows:
        for name in ("one_collective_a_push", "multi_dtype", "inputs_kept"):
            assert r["checks"][name], (name, r)
        # 7 pushes (6 with the updater, 1 without) and one call over
        # three dtypes
        assert r["allreduce_calls"] == 10


def test_dist_sync_kvstore_twin_service(kvstore_run):
    """The store's key-value calls and barriers, the health probe."""
    rc, rows, log = kvstore_run
    assert rc == 0, log
    for r in rows:
        for name in ("peer_world", "kv", "thread_barrier", "health",
                     "num_dead_node"):
            assert r["checks"][name], (name, r)


# ----------------------------------------------------------------- MLP twin
def _mlp_params(seed=3):
    net = mt.models.get_mlp(num_classes=4)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(25, 32), softmax_label=(25,))[0]))
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in shapes.items() if n not in ("data",
                                                    "softmax_label")}


@pytest.fixture(scope="module")
def mlp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mlp")
    params = _mlp_params()
    pfile = str(out / "init.params")
    mt.nd.save(pfile, {"arg:%s" % k: mt.nd.array(v, ctx=mt.cpu())
                       for k, v in params.items()})
    rc, so, se = launch_n(2, "mxnet_tpu_torch.bench.dist_mlp", "--epochs",
                          str(MLP_EPOCHS), "--params", pfile, "--out",
                          str(out), "--ckpt")
    return rc, out, params, so + se


def _rank_params(out, r):
    raw = mt.nd.load(os.path.join(out, "rank%d.params" % r), ctx=mt.cpu())
    return {k[4:]: v.asnumpy() for k, v in raw.items()}


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), SCALE_MIN)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def test_dist_mlp_twin_replicas_bitwise(mlp_run):
    rc, out, _, log = mlp_run
    assert rc == 0, log
    rows = [json.loads(open(os.path.join(out, "rank%d.json" % r)).read())
            for r in range(2)]
    for r in rows:
        assert r["ok"] and r["checks"]["lockstep"], r
        assert r["accuracy"] > 0.9 and r["route"] == "gloo"
        # one collective a key a batch: 6 keys, 8 batches an epoch
        assert r["collective_calls"] == 6 * 8 * MLP_EPOCHS, r
    with open(os.path.join(out, "rank0.params"), "rb") as f0, \
            open(os.path.join(out, "rank1.params"), "rb") as f1:
        assert f0.read() == f1.read()


def test_dist_mlp_twin_matches_jax_two_contexts(mlp_run, mx):
    rc, out, params, log = mlp_run
    assert rc == 0, log
    from mxnet_tpu_torch.bench import dist_mlp
    x, y = dist_mlp.blobs()
    b = 25
    # context k of each JAX batch of 50 holds rank k's batch
    order = np.concatenate([np.r_[i * b:(i + 1) * b,
                                  200 + i * b:200 + (i + 1) * b]
                            for i in range(200 // b)])
    it = mx.io.NDArrayIter(x[order], y[order], batch_size=2 * b)
    from mxnet_tpu import models as jmodels
    mod = mx.Module(jmodels.get_mlp(num_classes=4),
                    context=[mx.cpu(0), mx.cpu(1)])
    mod.fit(it, num_epoch=MLP_EPOCHS, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v) for k, v in params.items()},
            aux_params={})
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    got = _rank_params(out, 0)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


def _shards(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".params")}


def test_two_rank_checkpoint_round_robin(mlp_run, tmp_path):
    """The two ranks' save: each wrote its groups (sorted groups, group i
    by rank i % 2); shard files byte-equal to a one-rank save of the same
    state, the manifest equal but for the world and the writers."""
    rc, out, _, log = mlp_run
    assert rc == 0, log
    from mxnet_tpu_torch.bench import dist_mlp
    path = os.path.join(out, "ck-step00000001.ckpt")
    man = mt.checkpoint.verify_checkpoint(path)
    assert man["topology"]["world"] == 2
    assert {f: m["rank"] for f, m in man["shards"].items()} == \
        {"stage0.params": 0, "stage0-opt.params": 1}
    one = dist_mlp.checkpoint_save(str(tmp_path))
    assert _shards(one) == _shards(path)
    man1 = json.load(open(os.path.join(one, "manifest.json")))
    assert man1["topology"]["world"] == 1
    for m in (man, man1):
        m["topology"]["world"] = None
        for meta in m["shards"].values():
            meta["rank"] = None
    assert man == man1


# --------------------------------------------------------- one process
@pytest.mark.parametrize("kv_type", DIST_TYPES)
def test_dist_types_one_process(mx, kv_type):
    """Rank 0 of 1 in both packages; a push through the store's Test
    updater and a replace without one give the JAX package's values."""
    res = []
    for pkg in (mt, mx):
        kv = pkg.kv.create(kv_type)
        assert (kv.type, kv.rank, kv.num_workers) == (kv_type, 0, 1)
        kv.init(3, pkg.nd.ones((2, 3), ctx=pkg.cpu()))
        kv.set_optimizer(pkg.optimizer.create("test", rescale_grad=2.0))
        kv.push(3, [pkg.nd.ones((2, 3), ctx=pkg.cpu()) * 3])
        a = pkg.nd.zeros((2, 3), ctx=pkg.cpu())
        kv.pull(3, out=a)
        kv2 = pkg.kvstore.KVStore(kv_type)
        kv2.init("w", pkg.nd.ones((4,), ctx=pkg.cpu()))
        kv2.push("w", pkg.nd.ones((4,), ctx=pkg.cpu()) * 5)
        c = pkg.nd.zeros((4,), ctx=pkg.cpu())
        kv2.pull("w", out=c)
        kv.barrier()
        assert kv.num_dead_node(0, 1) == 0
        res.append((a.asnumpy(), c.asnumpy()))
    for g, w in zip(res[0], res[1]):
        np.testing.assert_array_equal(g, w)
    assert (res[0][0] == 7).all() and (res[0][1] == 5).all()


def test_module_fit_dist_sync_one_process(mx):
    """``Module.fit(kvstore="dist_sync")`` on one context trains on the
    general path with the update on the store, as the JAX package's does:
    the same parameters within 1e-5."""
    x, y = np.random.RandomState(0).randn(60, 32).astype(np.float32), \
        np.random.RandomState(1).randint(0, 4, 60).astype(np.float32)
    params = {k: v for k, v in _mlp_params(5).items()}
    from mxnet_tpu import models as jmodels
    out = []
    for pkg, models in ((mt, pmodels), (mx, jmodels)):
        it = pkg.io.NDArrayIter(x, y, batch_size=20)
        mod = pkg.Module(models.get_mlp(num_classes=4),
                         context=pkg.cpu())
        mod.fit(it, num_epoch=2, kvstore="dist_sync",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in params.items()}, aux_params={})
        assert mod._update_on_kvstore and mod._kvstore.type == "dist_sync"
        assert mod._optimizer.rescale_grad == 1.0 / 20
        out.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    assert mt.Module(mt.models.get_mlp(num_classes=4),
                     context=mt.cpu())._start_fused_fit is not None
    for k in out[1]:
        _close(out[0][k], out[1][k], k)


def test_allreduce_world_one_returns_inputs():
    t = mt.nd.ones((3,), ctx=mt.cpu())
    assert dist.allreduce(t) is t
    vals = {"a": t}
    assert dist.allreduce_tree(vals) == vals
    xs = [t.value]
    assert dist.allreduce_arrays(xs)[0] is xs[0]
    assert dist.peer_world() == (1, 0) and dist.route() == "gloo"
    assert dist.membership_barrier("x") is True
    dist.coordination_barrier("y")
    dist.barrier()
    with pytest.raises(mt.MXNetError, match="world of 1"):
        dist.kv_set("k", "v")


def test_route_rule():
    """NCCL when each rank of a host has its own card, gloo over CUDA
    tensors when ranks share one, gloo without a card."""
    assert dist._pick_route(1, 1) == "nccl"
    assert dist._pick_route(4, 4) == "nccl"
    assert dist._pick_route(2, 1) == "gloo-cuda"
    assert dist._pick_route(2, 0) == "gloo"


# ----------------------------------------------------------------- launcher
def test_launcher_kills_the_world_on_a_failure():
    """Rank 1 exits 3 at once; rank 0 would sleep for a minute: the
    launcher returns 3 within seconds, rank 0's process group killed."""
    code = ("import os, sys, time\n"
            "r = int(os.environ['MXTPU_PROCESS_ID'])\n"
            "sys.exit(3) if r == 1 else time.sleep(60)\n")
    rc, out, err = launch([sys.executable, "-m", "mxnet_tpu_torch.launch",
                           "-n", "2", sys.executable, "-c", code],
                          timeout=50)
    assert rc == 3, (out, err)


def test_launcher_restarts_with_the_count(tmp_path):
    """``--max-restarts 1``: the first world fails, the respawn sees
    MXTPU_RESTART_COUNT=1 (``elastic.is_recovery``) and succeeds."""
    marker = str(tmp_path / "seen")
    code = ("import os, sys\n"
            "from mxnet_tpu_torch.parallel import elastic\n"
            "c = os.environ['MXTPU_RESTART_COUNT']\n"
            "r = os.environ['MXTPU_PROCESS_ID']\n"
            "open(%r + r + '-' + c, 'w').write(str(elastic.is_recovery()))\n"
            "sys.exit(5 if c == '0' and r == '0' else 0)\n" % marker)
    rc, out, err = launch([sys.executable, "-m", "mxnet_tpu_torch.launch",
                           "-n", "2", "--max-restarts", "1",
                           "--respawn-delay", "0", sys.executable, "-c",
                           code], timeout=100)
    assert rc == 0, (out, err)
    assert "restart 1/1" in err
    assert open(marker + "0-0").read() == "False"
    assert open(marker + "0-1").read() == "True"
    assert open(marker + "1-1").read() == "True"


def test_launcher_refusals():
    for extra, what in ((["--launcher", "ssh"], "multi-host part"),
                        (["--elastic", "1:2"], "live-resize part")):
        with pytest.raises(mt.MXNetError, match=what):
            plaunch.main(["-n", "2"] + extra + ["true"])


def test_init_timeout_when_a_peer_never_comes():
    """Rank 0 of a world of 2 whose peer never starts: an MXNetError
    after the timeout, not a hang."""
    code = ("import time\n"
            "from mxnet_tpu_torch.base import MXNetError\n"
            "from mxnet_tpu_torch.parallel import dist\n"
            "t0 = time.time()\n"
            "try:\n"
            "    dist.init_process_group(timeout=2)\n"
            "except MXNetError as e:\n"
            "    print('ERR', round(time.time() - t0), e)\n")
    port = plaunch._free_port()
    rc, out, err = launch([sys.executable, "-c", code], timeout=60,
                          env={"MXTPU_COORDINATOR": "localhost:%d" % port,
                               "MXTPU_NUM_PROCESSES": "2",
                               "MXTPU_PROCESS_ID": "0"})
    assert rc == 0 and out.startswith("ERR"), (out, err)
    assert "cannot meet its peers" in out
