"""The ring-attention part of the distributed slice in mxnet_tpu_torch
against mxnet_tpu, on the CPU.

One gloo world of four ranks runs ``bench/tp_sp_ladder.py`` (one launch,
beside the JAX package's runs): ``ring_attention`` over an ``sp`` axis of 4
and, on a ``dp2 x sp2`` mesh, of 2, on the JAX package's ring-test inputs:
the output and dq/dk/dv of ``sum(out ** 2)``, causal and not, within rtol
2e-4 / atol 2e-5 of the JAX package's ``attention_reference`` (float32),
and float64 inputs against its ring under x64 (the softmax state float32
in both).  Then the transformer LM under ``set_sequence_mesh`` at sp=4:
its forward and 3 SGD steps against the JAX package's mesh-less ones, at
the same tolerance.  The ring's sends and gathers are
``predicted_ring``'s.  Beside it two ranks run ``bench/train_lm.py
--sequence-parallel 2`` at toy width (its perplexity falls, as one
process's does) and one process runs it without; two ranks run the ring
with every transfer staged through host buffers (the shared card's
route).  In process: the attention op's ladder takes the ring when a
sequence mesh is set, a one-rank ring is the reference, and the mesh
refusals.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench import tp_sp_ladder as ladder
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh
from mxnet_tpu_torch.parallel import ring as pring
from test_torch_threads import child_env
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5
RINGS = ("sp4", "dp2xsp2")
LM = dict(vocab_size=16, seq_len=32, num_layers=1, num_hidden=16,
          num_heads=2)
LM_BATCH, LM_STEPS, LM_SEED = 2, 3, ladder.SEED
# bench/train_lm.py at toy width
TRAIN_LM = ["--cpu", "--vocab", "32", "--seq-len", "32", "--batch-size",
            "4", "--num-layers", "1", "--num-hidden", "32", "--num-heads",
            "2", "--steps", "20", "--chunk", "4", "--lr", "0.01"]


def start(args):
    env = {k: v for k, v in child_env().items()
           if not k.startswith("MXTPU_")}
    env.update(PYTHONPATH=ROOT)
    return subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def finish(p, timeout=300):
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        pytest.fail("timed out after %d s: %s" % (timeout, out[-4000:]))
    return p.returncode, out


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _jax_ring_refs():
    """{tag: {out, dq, dk, dv}} of the JAX package's attention_reference
    (float32) on the ladder's inputs, and of its ring at sp=2 under x64 on
    the float64 inputs."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel.mesh import make_mesh
    from mxnet_tpu.parallel.ring import (attention_reference,
                                         ring_attention, sequence_sharding)
    out = {}
    for causal in (False, True):
        q, k, v = (x.numpy() for x in ladder.ring_inputs(
            torch, causal, torch.float32))

        def loss(a, b, c):
            return (attention_reference(a, b, c, causal=causal) ** 2).sum()
        o = attention_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
        g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q),
                                               jnp.asarray(k), jnp.asarray(v))
        out[("full", "causal")[causal]] = dict(
            out=np.asarray(o), dq=np.asarray(g[0]), dk=np.asarray(g[1]),
            dv=np.asarray(g[2]))
    jax.config.update("jax_enable_x64", True)
    try:
        m = make_mesh({"sp": 2}, devices=jax.devices()[:2])
        sh = sequence_sharding(m)
        q, k, v = (jax.device_put(x.numpy(), sh) for x in ladder.ring_inputs(
            torch, True, torch.float64))

        def rloss(a, b, c):
            return (ring_attention(a, b, c, m, causal=True) ** 2).sum()
        o = ring_attention(q, k, v, m, causal=True)
        g = jax.grad(rloss, argnums=(0, 1, 2))(q, k, v)
        out["causal64"] = dict(out=np.asarray(o), dq=np.asarray(g[0]),
                               dk=np.asarray(g[1]), dv=np.asarray(g[2]))
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


def _lm_batch():
    """The ladder's LM batch (``lm_phase``: RandomState(seed + 1))."""
    rng = np.random.RandomState(LM_SEED + 1)
    x = rng.randint(0, LM["vocab_size"], (LM_BATCH, LM["seq_len"]))
    y = rng.randint(0, LM["vocab_size"], (LM_BATCH, LM["seq_len"]))
    return {"data": x.astype(np.float32), "softmax_label": y.astype(
        np.float32)}


def _jax_lm(mx, path):
    """The JAX package's mesh-less LM: its initial parameters (saved to
    ``path``), its forward and its parameters after 3 SGD steps."""
    import jax
    from mxnet_tpu import name as jname
    from mxnet_tpu.models import transformer
    from mxnet_tpu.train import EvalStep, TrainStep
    with jname.NameManager():
        net = transformer.get_symbol(**LM)
    B, T = LM_BATCH, LM["seq_len"]
    ts = TrainStep(net, mx.optimizer.SGD(learning_rate=ladder.LM_LR))
    p, s, a = ts.init({"data": (B, T)}, {"softmax_label": (B, T)}, seed=4)
    init = {k: np.asarray(jax.device_get(v)) for k, v in p.items()}
    mt.nd.save(path, {"arg:" + k: mt.nd.array(v, ctx=mt.cpu())
                      for k, v in init.items()})
    batch = _lm_batch()
    fwd = np.asarray(EvalStep(net)(p, a, batch)[0])
    bd = ts.shard_batch(batch)
    for _ in range(LM_STEPS):
        p, s, a, _ = ts(p, s, a, bd)
    return fwd, {k: np.asarray(jax.device_get(v)) for k, v in p.items()}


def _lm_json(log):
    return [json.loads(line) for line in log.splitlines()
            if line.startswith("{") and '"perplexity"' in line]


@pytest.fixture(scope="module")
def world(mx, tmp_path_factory):
    out = tmp_path_factory.mktemp("ring_ladder")
    lm_params = str(out / "lm.params")
    fwd, trained = _jax_lm(mx, lm_params)
    procs = {
        "ladder": start(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "4",
             sys.executable, "-m", "mxnet_tpu_torch.bench.tp_sp_ladder",
             "--ctx", "cpu", "--out", str(out), "--ring", ",".join(RINGS),
             "--lm", "sp4", "--lm-params", lm_params, "--lm-vocab",
             str(LM["vocab_size"]), "--lm-seq-len", str(LM["seq_len"]),
             "--lm-layers", str(LM["num_layers"]), "--lm-hidden",
             str(LM["num_hidden"]), "--lm-heads", str(LM["num_heads"]),
             "--lm-batch", str(LM_BATCH), "--lm-steps", str(LM_STEPS),
             "--single", "--save-arrays"]),
        "train_lm": start(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
             sys.executable, "-m", "mxnet_tpu_torch.bench.train_lm",
             "--sequence-parallel", "2"] + TRAIN_LM),
        "train_lm_one": start(
            [sys.executable, "-m", "mxnet_tpu_torch.bench.train_lm"]
            + TRAIN_LM)}
    refs = _jax_ring_refs()
    res = {k: finish(p) for k, p in procs.items()}
    rows, arrays = [], []
    for r in range(4):
        path = os.path.join(str(out), "rank%d.json" % r)
        if os.path.exists(path):
            with open(path) as f:
                rows.append(json.load(f))
            raw = mt.nd.load(os.path.join(str(out), "rank%d.params" % r),
                             ctx=mt.cpu())
            arrays.append({k: v.asnumpy() for k, v in raw.items()})
    return {"res": res, "rows": rows, "arrays": arrays, "refs": refs,
            "lm_forward": fwd, "lm_trained": trained}


def _ladder(world):
    rc, log = world["res"]["ladder"]
    assert rc == 0 and len(world["rows"]) == 4, log[-4000:]
    return world["rows"], world["arrays"]


@pytest.mark.parametrize("spec", RINGS)
@pytest.mark.parametrize("kind", ["full", "causal"])
def test_ring_matches_reference(world, spec, kind):
    """Output and dq/dk/dv on every rank against the JAX package's
    attention_reference (float32, rtol 2e-4, atol 2e-5)."""
    _, arrays = _ladder(world)
    want = world["refs"][kind]
    for arr in arrays:
        for name, w in want.items():
            np.testing.assert_allclose(
                arr["ring-%s-%s-float32/%s" % (spec, kind, name)], w,
                rtol=RTOL, atol=ATOL, err_msg="%s %s %s" % (spec, kind, name))


@pytest.mark.parametrize("spec", RINGS)
def test_ring_float64_matches_jax_ring(world, spec):
    """Float64 inputs: the scores and the softmax state float32, as the
    JAX package's ring under x64 (against which the float64 reference
    differs at ~2e-7): its output and gradients, in float64."""
    _, arrays = _ladder(world)
    want = world["refs"]["causal64"]
    for arr in arrays:
        for name, w in want.items():
            got = arr["ring-%s-causal-float64/%s" % (spec, name)]
            assert got.dtype == np.float64 == w.dtype
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL,
                                       err_msg=spec + name)


def test_ring_messages_are_predicted(world):
    """Each call's sends, receives and gathers, calls and bytes, are
    ``predicted_ring``'s."""
    rows, _ = _ladder(world)
    for r in rows:
        assert len(r["ring"]) == len(RINGS) * 3
        for c in r["ring"]:
            assert c["collectives"] == {k: v[0] for k, v in
                                        c["predicted"].items()}, c
            assert c["collective_bytes"] == {k: v[1] for k, v in
                                             c["predicted"].items()}, c


def test_ring_saves_only_its_blocks(world):
    """A ring call keeps for its backward this rank's Q/K/V blocks and its
    float32 output block and softmax state, never the full inputs: the
    bytes it saves are ``predicted_ring_saved``'s, a quarter (sp=4) or a
    half (sp=2) of the Q/K/V it was given."""
    rows, _ = _ladder(world)
    full = 3 * int(np.prod(ladder.RING_SHAPE))
    for r in rows:
        for c in r["ring"]:
            assert c["saved_bytes"] == c["predicted_saved_bytes"], c
            elem = 8 if c["case"].endswith("float64") else 4
            assert c["saved_bytes"] < full * elem, c


def test_lm_under_a_sequence_mesh_matches_jax(world):
    """The LM's forward and its parameters after 3 SGD steps at sp=4
    against the JAX package's mesh-less ones (rtol 2e-4, atol 2e-5); the
    same run without the sequence mesh agrees; the ring's messages a step
    are predicted."""
    rows, arrays = _ladder(world)
    lm0 = rows[0]["lm"]
    assert lm0["forward_max_abs"] <= ATOL
    assert lm0["forward_scale"] > 0
    assert lm0["max_abs_vs_single"] <= ATOL, lm0
    assert lm0["worst_over_floor"][0] <= 1.0, lm0
    for r, arr in zip(rows, arrays):
        lm = r["lm"]
        assert lm["sp"] == 4
        # the step averages the sequence replicas' gradients
        assert lm["sp_bitwise_equal"] is True
        assert lm["predicted"]["sp_all_reduce"][0] == 1
        assert lm["collectives_per_step"] == {
            k: v[0] for k, v in lm["predicted"].items()}
        assert lm["collective_bytes_per_step"] == {
            k: v[1] for k, v in lm["predicted"].items()}
        np.testing.assert_allclose(arr["lm/out"], world["lm_forward"],
                                   rtol=RTOL, atol=ATOL)
        for n, w in world["lm_trained"].items():
            np.testing.assert_allclose(arr["lm/arg:" + n], w, rtol=RTOL,
                                       atol=ATOL, err_msg=n)


def test_train_lm_sequence_parallel(world):
    """``bench/train_lm.py --sequence-parallel 2`` through the launcher:
    both ranks report the same perplexities, which fall, as one process's
    do, the same trained parameters (their digests), and the ring's
    messages and the gradients' mean a step."""
    rc, log = world["res"]["train_lm"]
    assert rc == 0, log[-4000:]
    recs = _lm_json(log)
    assert sorted(r["rank"] for r in recs) == [0, 1]
    assert recs[0]["perplexity"] == recs[1]["perplexity"]
    assert recs[0]["params_sha256"] == recs[1]["params_sha256"]
    ppl = recs[0]["perplexity"]
    assert ppl[-1] < ppl[0]
    rc1, log1 = world["res"]["train_lm_one"]
    assert rc1 == 0, log1[-4000:]
    one = _lm_json(log1)[0]
    assert one["sequence_parallel"] == 0 and one["collectives_per_step"] \
        == {}
    np.testing.assert_allclose(ppl, one["perplexity"], rtol=1e-3)
    net = mt.models.transformer.get_symbol(
        vocab_size=32, seq_len=32, num_layers=1, num_hidden=32, num_heads=2)
    params, _, _ = mt.TrainStep(net, mt.optimizer.Adam(), ctx=mt.cpu()).init(
        {"data": (4, 32)}, {"softmax_label": (4, 32)})
    want = ladder.predicted_ring(1, 2, (4, 2, 32, 16), 4,
                                 sum(4 * v.numel() for v in params.values()))
    assert recs[0]["collectives_per_step"] == {k: v[0]
                                               for k, v in want.items()}


# a step under a sequence mesh whose replicas' gradients differ (each rank
# feeds its own data, as a card's kernels may round differently in two
# processes): the step takes their mean, so the ranks stay bitwise equal
SP_MEAN = """
import sys
import numpy as np
import torch
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import dist, mesh as pmesh
torch.set_num_threads(1)
dist.init_process_group()
r, n = dist.rank(), dist.num_workers()
net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
    mt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
batch = {"data": x + 0.1 * r,
         "softmax_label": np.array([0, 1, 2, 1], np.float32)}


def step():
    ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=0.5),
                      ctx=mt.cpu())
    p, s, a = ts.init({"data": (4, 5)}, {"softmax_label": (4,)}, seed=0)
    dist.reset_collectives()
    p, s, a, _ = ts(p, s, a, ts.shard_batch(batch))
    return torch.cat([p[k].reshape(-1) for k in sorted(p)]), \
        dict(dist.collective_calls)


def gathered(v):
    return dist.all_gather_rows(v, None, n)


own, calls0 = step()
pmesh.set_sequence_mesh(pmesh.make_mesh({"sp": -1}))
try:
    mean, calls = step()
finally:
    pmesh.set_sequence_mesh(None)
alone, both = gathered(own), gathered(mean)
# one write a line: the ranks share the launcher's pipe
sys.stdout.write("SPMEAN %d %d %d %r %s %s\\n" % (
    r, not torch.equal(alone[0], alone[1]),
    all(torch.equal(both[0], b) for b in both),
    float((mean - alone.mean(0)).abs().max()), calls0.get("sp_all_reduce"),
    calls.get("sp_all_reduce")))
sys.stdout.flush()
dist.barrier()
dist.shutdown_process_group()
"""


def test_sequence_replicas_take_the_mean(tmp_path):
    """Under a sequence mesh a TrainStep averages its gradients over the
    axis's ranks (one ``sp_all_reduce`` a step): ranks whose gradients
    differ end bitwise equal, at the mean of their own SGD updates; without
    the mesh they differ and take no such collective."""
    script = tmp_path / "sp_mean.py"
    script.write_text(SP_MEAN)
    rc, log = finish(start([sys.executable, "-m", "mxnet_tpu_torch.launch",
                            "-n", "2", sys.executable, str(script)]))
    assert rc == 0, log[-4000:]
    rows = [line.split() for line in log.splitlines()
            if line.startswith("SPMEAN")]
    assert sorted(int(r[1]) for r in rows) == [0, 1]
    for r in rows:
        assert r[2:4] == ["1", "1"], r
        # SGD's update is linear in the gradient
        assert float(r[4]) <= 1e-6, r
        assert r[5:] == ["None", "1"], r


# the ring through the staging a shared card takes: every transfer crosses a
# host buffer (plain host memory here, pinned on the card)
STAGED = """
import sys
import torch
from mxnet_tpu_torch.bench import tp_sp_ladder as ladder
from mxnet_tpu_torch.parallel import dist, mesh as pmesh
from mxnet_tpu_torch.parallel.ring import attention_reference, ring_attention
torch.set_num_threads(1)
dist.p2p_route = lambda t: "host-staged"
dist._staging = lambda t: torch.empty(t.shape, dtype=t.dtype)
dist.init_process_group()
mesh = pmesh.make_mesh({"sp": -1})
worst = 0.0
for causal in (False, True):
    q, k, v = (x.requires_grad_() for x in ladder.ring_inputs(
        torch, causal, torch.float32))
    out = ring_attention(q, k, v, mesh, causal=causal)
    (out ** 2).sum().backward()
    q2, k2, v2 = (x.detach().double().requires_grad_() for x in (q, k, v))
    ref = attention_reference(q2, k2, v2, causal=causal)
    (ref ** 2).sum().backward()
    for a, b in ((out, ref), (q.grad, q2.grad), (k.grad, k2.grad),
                 (v.grad, v2.grad)):
        worst = max(worst, float((a.double() - b).abs().max()))
# one write a line: the ranks share the launcher's pipe
sys.stdout.write("STAGED %d %d %r\\n" % (dist.rank(),
                                         dist.p2p_staged_copies[0], worst))
sys.stdout.flush()
dist.barrier()
dist.shutdown_process_group()
"""


def test_ring_through_host_staging(tmp_path):
    """The ring with every transfer crossing a host buffer (the route of
    ranks that share a card, where gloo sends host memory only): each
    receive copies its buffer into the block (the staging copies counted),
    and the output and gradients are the reference's."""
    script = tmp_path / "staged.py"
    script.write_text(STAGED)
    rc, log = finish(start([sys.executable, "-m", "mxnet_tpu_torch.launch",
                            "-n", "2", sys.executable, str(script)]))
    assert rc == 0, log[-4000:]
    rows = [line.split() for line in log.splitlines()
            if line.startswith("STAGED")]
    assert sorted(int(r[1]) for r in rows) == [0, 1]
    for r in rows:
        # each call: 2 sends and 2 receives forward, 4 and 4 backward
        assert int(r[2]) == 2 * 12 and float(r[3]) <= ATOL, r


# ------------------------------------------------------------ in process
def test_attention_op_takes_the_ring():
    """With a sequence mesh set, dot_product_attention runs ring_attention
    (whatever ``impl``), here over a one-rank axis, equal to the reference
    in value and gradient; cleared, the ladder is as before."""
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 8, 4)).requires_grad_()
               for _ in range(3))
    op = mt.ops.registry.get_op("dot_product_attention")
    dist.ensure_group()
    try:
        pmesh.set_sequence_mesh(pmesh.make_mesh({"sp": -1}))
        calls = pring._calls[0]
        out = op.fn(q, k, v, causal=True, impl="xla")
        assert pring._calls[0] == calls + 1
        (out ** 2).sum().backward()
        got = [x.grad.clone() for x in (q, k, v)]
    finally:
        pmesh.set_sequence_mesh(None)
        dist.shutdown_process_group()
    q2, k2, v2 = (x.detach().requires_grad_() for x in (q, k, v))
    calls = pring._calls[0]
    ref = op.fn(q2, k2, v2, causal=True, impl="xla")
    assert pring._calls[0] == calls
    (ref ** 2).sum().backward()
    # float32 scores and softmax state on float64 inputs
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for g, x in zip(got, (q2, k2, v2)):
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_ring_refusals():
    dist.ensure_group()
    try:
        mesh = pmesh.make_mesh({"sp": -1})
        with pytest.raises(mt.MXNetError, match="has no 'tp' axis"):
            pring.ring_attention(torch.zeros(1, 1, 4, 2),
                                 torch.zeros(1, 1, 4, 2),
                                 torch.zeros(1, 1, 4, 2), mesh, axis="tp")
        with pytest.raises(mt.MXNetError, match=r"\(B, H, T, D\)"):
            pring.ring_attention(torch.zeros(4, 2), torch.zeros(4, 2),
                                 torch.zeros(4, 2), mesh)
        sh = pring.sequence_sharding(mesh)
        assert (sh.size, sh.index, sh.ranks) == (1, 0, [0])
        assert sh.block(8) == slice(0, 8)
    finally:
        dist.shutdown_process_group()


@pytest.mark.cuda
def test_ring_on_the_card(tmp_path):
    """Two ranks sharing the card (K/V through pinned host buffers over
    gloo): the ring's output and gradients within the float32 tolerance of
    the float64 reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = start([sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
               sys.executable, "-m", "mxnet_tpu_torch.bench.tp_sp_ladder",
               "--ctx", "gpu", "--out", str(tmp_path), "--ring", "sp2",
               "--save-arrays"])
    rc, log = finish(p)
    assert rc == 0, log[-4000:]
    raw = mt.nd.load(os.path.join(str(tmp_path), "rank0.params"),
                     ctx=mt.cpu())
    for causal in (False, True):
        q, k, v = (x.double().requires_grad_() for x in ladder.ring_inputs(
            torch, causal, torch.float32))
        ref = pring.attention_reference(q, k, v, causal=causal)
        (ref ** 2).sum().backward()
        tag = "ring-sp2-%s-float32/" % ("causal" if causal else "full")
        for name, want in (("out", ref), ("dq", q.grad), ("dk", k.grad),
                           ("dv", v.grad)):
            np.testing.assert_allclose(raw[tag + name].asnumpy(),
                                       want.detach().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=tag + name)
