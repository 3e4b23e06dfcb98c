"""Mixed-precision training of mxnet_tpu_torch (``amp.Policy``, the pure
cast ``dtype=``, ``remat``) against mxnet_tpu, on the CPU at small sizes.

- Policy resolution (``MXNET_AMP`` / ``MXNET_LOSS_SCALE``), its forms and
  errors, ``key``/``describe``/``init_state`` against the JAX package's.
- The loss-scale automaton: driven through one finite/overflow sequence in
  both packages; through TrainStep against a numpy replica (the twins of
  tests/python/unittest/test_amp.py); a static scale; run_steps carrying
  the state; the host API (``scale_state_host``, ``load_scale_state``,
  ``amp_stats``).
- Exactness: a power-of-two scale with float32 compute trains bitwise as
  the unscaled step; an overflow step leaves every weight, momentum and
  moving statistic bitwise as it was.
- A float64 ``Policy("float32", loss_scale=2**k)`` step sequence with one
  injected overflow on a small ResNet against the JAX package's, within
  1e-9, with the scale state.
- bfloat16: a policy step and a pure-cast step on an MLP and on the small
  ResNet (unfused and through the NormConv peephole) against the JAX
  package's, each leaf within BF16_X times the distance between the JAX
  package's bfloat16 and float32 steps from the same state; EvalStep.
- ``head_grad_scale`` at every loss head: exactly S times the unscaled
  gradient, and the JAX package's.
- ``remat=True`` / ``"dots"``: float64 equal to the plain step and to the
  JAX package's remat step; with Dropout in the graph, equal to the plain
  step only because the generator is replayed.
- float16 under MXNET_NORM_CONV=1 runs unfused; C7: a bfloat16 NDArray's
  ``dtype`` and ``asnumpy`` with and without ml_dtypes.
- On the card (``cuda`` marker, skipped without one): the bfloat16 policy
  step against the float64 step on the CPU; float16 under MXNET_NORM_CONV=1
  launches no NormConv kernel.
"""
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import random as prandom
from mxnet_tpu_torch.amp import Policy, resolve_policy
from mxnet_tpu_torch.executor import _Lowered
from mxnet_tpu_torch.ops import norm_conv as pnc
from test_torch_resnet_train import _resnet, _state
from test_torch_threads import torch_threads_per_worker  # noqa: F401

F64_TOL = 1e-9
# a bfloat16 step of the port against the JAX package's bfloat16 step, per
# leaf (max |d| / max |w| and ||d|| / ||w||), within this factor of the
# distance between the JAX package's bfloat16 and float32 steps from the
# same state (or of BF16_MIN where that is smaller).  Both round every
# activation to bfloat16, but XLA's CPU fusions round elsewhere than
# PyTorch's eager ops, and at batch 4 a ReLU gate or a BatchNorm variance
# that rounds another way moves whole channels: the measured ratio is
# 0.9-1.4 on ResNet-8 and at most 1.7 on ResNet-18.
BF16_X = 4.0
BF16_MIN = 1e-3
SGD = dict(learning_rate=0.1, momentum=0.9, rescale_grad=0.25)
# the small ResNet: ResNet-8 (CIFAR-style, basic blocks) at 3x28x28
RES = dict(classes=10, layers=8, image=28, batch=4)


@pytest.fixture
def jx():
    """(jax, mxnet_tpu) with 64-bit mode on."""
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    jax.config.update("jax_enable_x64", True)
    yield jax, mx
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def jx32():
    """(jax, mxnet_tpu) in JAX's default 32-bit mode."""
    return pytest.importorskip("jax"), pytest.importorskip("mxnet_tpu")


def _mlp(S, dropout=0.0):
    x = S.FullyConnected(S.Variable("data"), num_hidden=16, name="fc1")
    x = S.Activation(x, act_type="relu")
    if dropout:
        x = S.Dropout(x, p=dropout)
    x = S.FullyConnected(x, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(x, name="softmax")


def _make(policy=None, momentum=0.9, seed=1, **kw):
    ts = mt.TrainStep(_mlp(mt.sym), mt.optimizer.SGD(
        learning_rate=0.1, momentum=momentum), policy=policy, ctx=mt.cpu(),
        **kw)
    p, s, a = ts.init({"data": (8, 10)}, {"softmax_label": (8,)}, seed=seed)
    return ts, p, s, a


def _data(seed=0, inf_at=None):
    rng = np.random.RandomState(seed)
    x = rng.rand(8, 10).astype(np.float32)
    if inf_at is not None:
        x[inf_at] = np.inf
    return {"data": x,
            "softmax_label": rng.randint(0, 4, 8).astype(np.float32)}


def _scale(ts):
    return ts.scale_state_host()


# ------------------------------------------------------------- resolution
def test_resolve_policy_env(monkeypatch):
    monkeypatch.delenv("MXNET_AMP", raising=False)
    monkeypatch.delenv("MXNET_LOSS_SCALE", raising=False)
    assert resolve_policy() is None
    fallback = Policy("bfloat16")
    assert resolve_policy(default=fallback) is fallback
    monkeypatch.setenv("MXNET_AMP", "0")
    assert resolve_policy(default=fallback) is None
    monkeypatch.setenv("MXNET_AMP", "1")
    p = resolve_policy()
    assert p.compute_dtype == "bfloat16" and p.dynamic
    assert p.loss_scale == 2.0 ** 15
    monkeypatch.setenv("MXNET_AMP", "float16")
    assert resolve_policy().compute_dtype == "float16"
    monkeypatch.setenv("MXNET_AMP", "int8")
    with pytest.raises(mt.MXNetError, match="MXNET_AMP"):
        resolve_policy()
    monkeypatch.setenv("MXNET_AMP", "1")
    monkeypatch.setenv("MXNET_LOSS_SCALE", "128")
    p = resolve_policy()
    assert not p.dynamic and p.loss_scale == 128.0
    monkeypatch.setenv("MXNET_LOSS_SCALE", "dynamic:256")
    p = resolve_policy()
    assert p.dynamic and p.loss_scale == 256.0
    for bad in ("lots", "-2", "dynamic:x"):
        monkeypatch.setenv("MXNET_LOSS_SCALE", bad)
        with pytest.raises(mt.MXNetError, match="MXNET_LOSS_SCALE"):
            resolve_policy()


def test_policy_explicit_forms():
    assert resolve_policy(True).compute_dtype == "bfloat16"
    assert resolve_policy("float16").compute_dtype == "float16"
    p = Policy("bf16")
    assert resolve_policy(p) is p and p.compute_dtype == "bfloat16"
    for alias, name in (("fp16", "float16"), ("half", "float16"),
                        ("fp32", "float32"), ("f32", "float32")):
        assert Policy(alias).compute_dtype == name
    for bad in (dict(compute_dtype="int8"), dict(loss_scale=0.0),
                dict(growth_interval=0)):
        with pytest.raises(mt.MXNetError, match="Policy"):
            Policy(**bad)
    with pytest.raises(mt.MXNetError, match="policy must be"):
        resolve_policy(3)
    for cls, kw in ((mt.TrainStep, dict(optimizer=mt.optimizer.SGD(),
                                        ctx=mt.cpu())), (mt.EvalStep, {})):
        with pytest.raises(mt.MXNetError, match="not both"):
            cls(_mlp(mt.sym), dtype="bfloat16", policy=Policy(), **kw)


def test_policy_key_describe_state_match_mxnet_tpu(jx32):
    _, mx = jx32
    from mxnet_tpu.amp import Policy as JPolicy
    for kw in ({}, dict(compute_dtype="float16", loss_scale=128.0,
                        dynamic=False),
               dict(compute_dtype="float32", growth_interval=3,
                    max_scale=64.0, min_scale=0.5)):
        p, j = Policy(**kw), JPolicy(**kw)
        assert p.key() == j.key() and p.describe() == j.describe()
        got = p.init_state("cpu")
        want = j.init_state()
        assert [got[k].dtype for k in ("scale", "good", "overflow")] == \
            [torch.float32, torch.int32, torch.int32]
        for k in want:
            assert got[k].device.type == "cpu"
            assert got[k].item() == want[k].item(), k


def test_scale_automaton_matches_mxnet_tpu(jx32):
    """One finite/overflow sequence through both packages' next_state,
    dynamic and static, with clamping at both ends: scale, good and
    overflow equal at every step."""
    jax, _ = jx32
    from mxnet_tpu.amp import Policy as JPolicy
    seq = [True, True, True, False, True, False, False, False, True, True,
           True, True, True, True, True]
    for kw in (dict(loss_scale=4.0, growth_interval=2, max_scale=16.0,
                    min_scale=1.0),
               dict(loss_scale=3.0, growth_interval=1, growth_factor=3.0,
                    backoff_factor=0.25, max_scale=50.0, min_scale=0.1),
               dict(loss_scale=8.0, dynamic=False)):
        p, j = Policy("float32", **kw), JPolicy("float32", **kw)
        ps = p.init_state("cpu")
        js = {k: jax.numpy.asarray(v) for k, v in j.init_state().items()}
        for i, finite in enumerate(seq):
            ps = p.next_state(ps, torch.tensor(finite))
            js = j.next_state(js, jax.numpy.asarray(finite))
            for k in ("scale", "good", "overflow"):
                assert ps[k].dtype == (torch.float32 if k == "scale"
                                       else torch.int32)
                assert ps[k].item() == np.asarray(js[k]).item(), (kw, i, k)


# ------------------------------------------------- loss-scale correctness
def test_pow2_scale_is_exact():
    """float32 compute and a power-of-two scale: scaling and unscaling are
    exact, so the policy step trains bitwise as the unscaled step."""
    ts0, p0, s0, a0 = _make()
    ts1, p1, s1, a1 = _make(Policy("float32", loss_scale=8.0,
                                   growth_interval=10 ** 6))
    b0, b1 = ts0.shard_batch(_data()), ts1.shard_batch(_data())
    for _ in range(3):
        p0, s0, a0, o0 = ts0(p0, s0, a0, b0)
        p1, s1, a1, o1 = ts1(p1, s1, a1, b1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert all(torch.equal(x, y) for x, y in zip(s0[k], s1[k])), k
    assert torch.equal(o0[0], o1[0])


def test_overflow_skips_update_and_halves_scale():
    ts, p, s, a = _make(Policy("float32", loss_scale=16.0,
                               growth_interval=50))
    bad = ts.shard_batch(_data(inf_at=(0, 0)))
    before = {k: v.clone() for k, v in p.items()}
    mom = {k: tuple(x.clone() for x in st) for k, st in s.items()}
    p, s, a, outs = ts(p, s, a, bad)
    for k in before:   # weights and optimizer state untouched
        assert torch.equal(before[k], p[k]), k
        assert all(torch.equal(x, y) for x, y in zip(mom[k], s[k])), k
    assert _scale(ts) == {"scale": 8.0, "good": 0, "overflow": 1}
    assert ts.num_update == 1          # the step count still advances
    assert outs[0].dtype == torch.float32


def test_scale_automaton_matches_numpy_replication():
    pol = Policy("float32", loss_scale=4.0, growth_interval=2,
                 growth_factor=2.0, backoff_factor=0.5, min_scale=1.0,
                 max_scale=64.0)
    ts, p, s, a = _make(pol)
    good_bd = ts.shard_batch(_data())
    bad_bd = ts.shard_batch(_data(inf_at=(0, 0)))
    scale, good, overflow = pol.loss_scale, 0, 0
    for finite in [True, True, True, False, True, False, False, False,
                   True, True, True, True, True, True, True, True, True,
                   True, True, True]:
        p, s, a, _ = ts(p, s, a, good_bd if finite else bad_bd)
        if finite:
            good += 1
            if good >= pol.growth_interval:
                scale = min(scale * pol.growth_factor, pol.max_scale)
                good = 0
        else:
            scale = max(scale * pol.backoff_factor, pol.min_scale)
            good = 0
            overflow += 1
        assert _scale(ts) == {"scale": scale, "good": good,
                              "overflow": overflow}, finite
    assert scale == pol.max_scale


def test_static_scale_never_moves():
    ts, p, s, a = _make(Policy("float32", loss_scale=32.0, dynamic=False))
    p, s, a, _ = ts(p, s, a, ts.shard_batch(_data(inf_at=(1, 2))))
    p, s, a, _ = ts(p, s, a, ts.shard_batch(_data()))
    assert _scale(ts) == {"scale": 32.0, "good": 0, "overflow": 1}


@pytest.mark.parametrize("stacked", [False, True])
def test_run_steps_carries_scale(stacked):
    """run_steps(..., 3) advances the scale state per inner step exactly as
    4 sequential calls do (one overflow slice among the stacked ones)."""
    def mk():
        return _make(Policy("float32", loss_scale=4.0, growth_interval=2))
    if stacked:
        parts = [_data(seed=i, inf_at=(0, 0) if i == 1 else None)
                 for i in range(4)]
        batch = {k: np.stack([d[k] for d in parts]) for k in parts[0]}
    else:
        batch = _data()
    ts1, p1, s1, a1 = mk()
    b1 = ts1.shard_batch(batch)
    p1, s1, a1, o1 = ts1.run_steps(p1, s1, a1, b1, 3, stacked=stacked)
    ts2, p2, s2, a2 = mk()
    b2 = ts2.shard_batch(batch)
    for i in range(4):
        bi = {k: v[i] for k, v in b2.items()} if stacked else b2
        p2, s2, a2, o2 = ts2(p2, s2, a2, bi)
    assert _scale(ts1) == _scale(ts2) == (
        {"scale": 4.0, "good": 0, "overflow": 1} if stacked
        else {"scale": 16.0, "good": 0, "overflow": 0})
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    assert torch.equal(o1[0], o2[0])


def test_bf16_policy_master_weights_and_outputs():
    """Under a bfloat16 policy the masters and the optimizer state stay
    float32 and the outputs come back float32; the pure cast gives the
    same update and its outputs in bfloat16."""
    results = []
    for kw in (dict(policy=Policy("bfloat16")), dict(dtype="bfloat16")):
        ts, p, s, a = _make(**kw)
        p, s, a, outs = ts(p, s, a, ts.shard_batch(_data()))
        assert p["fc1_weight"].dtype == torch.float32
        assert s["fc1_weight"][0].dtype == torch.float32
        assert torch.isfinite(outs[0]).all()
        results.append((p, outs[0]))
    assert results[0][1].dtype == torch.float32
    assert results[1][1].dtype == torch.bfloat16
    # a power-of-two scale is exact in bfloat16 too
    for k in results[0][0]:
        assert torch.equal(results[0][0][k], results[1][0][k]), k
    assert torch.equal(results[0][1], results[1][1].float())


def test_scale_state_host_api():
    ts, p, s, a = _make(Policy("float32", loss_scale=4.0,
                               growth_interval=100))
    assert ts.amp_stats() is None                  # before the first step
    assert _scale(ts) == {"scale": 4.0, "good": 0, "overflow": 0}
    p, s, a, _ = ts(p, s, a, ts.shard_batch(_data(inf_at=(0, 0))))
    assert ts.amp_stats() == (2.0, 1)
    assert ts.amp_stats() == (2.0, 0)              # a delta since the last
    ts.load_scale_state({"scale": 64.0, "overflow": 5})
    assert _scale(ts) == {"scale": 64.0, "good": 0, "overflow": 5}
    p, s, a, _ = ts(p, s, a, ts.shard_batch(_data(inf_at=(0, 0))))
    assert ts.amp_stats() == (32.0, 1)
    assert ts.policy.compute_dtype == "float32" and ts._has_scale
    plain = _make()[0]
    plain.load_scale_state({"scale": 2.0})         # no policy: a no-op
    assert plain.scale_state_host() is None and plain.amp_stats() is None
    assert plain.policy is None and not plain._has_scale


# ------------------------------------------------ parity with mxnet_tpu
def _res_state(dtype=np.float64, seed=0):
    state = _state(_resnet("torch", RES["classes"], RES["layers"],
                           RES["image"]), RES["batch"], RES["image"],
                   RES["classes"], seed=seed)
    params, opt_state, aux, batch = state
    return ({n: v.astype(dtype) for n, v in params.items()},
            {n: tuple(x.astype(dtype) for x in st)
             for n, st in opt_state.items()},
            {n: v.astype(dtype) for n, v in aux.items()},
            {k: v.astype(dtype) for k, v in batch.items()})


def _jax_run(jax, mx, jsym, state, batches, opt, **kw):
    from mxnet_tpu.train import TrainStep as JTrainStep
    params, opt_state, aux, _ = state
    jts = JTrainStep(jsym, opt, **kw)
    asj = jax.numpy.asarray
    jp = {n: asj(v) for n, v in params.items()}
    js = {n: tuple(asj(x) for x in st) for n, st in opt_state.items()}
    ja = {n: asj(v) for n, v in aux.items()}
    for b in batches:
        jp, js, ja, jouts = jts(jp, js, ja, jts.shard_batch(b))
    return jts, ({n: np.asarray(v) for n, v in jp.items()},
                 {n: tuple(np.asarray(x) for x in st)
                  for n, st in js.items()},
                 {n: np.asarray(v) for n, v in ja.items()},
                 np.asarray(jouts[0]))


def _port_run(sym_json, state, batches, opt, **kw):
    params, opt_state, aux, _ = state
    ts = mt.TrainStep(mt.sym.load_json(sym_json), opt, ctx=mt.cpu(), **kw)
    pp, ps, pa = mt.convert.train_state_from_numpy(params, opt_state, aux,
                                                   ctx=mt.cpu())
    for b in batches:
        pp, ps, pa, outs = ts(pp, ps, pa, ts.shard_batch(b))
    return ts, ({n: v.numpy() for n, v in pp.items()},
                {n: tuple(x.numpy() for x in st) for n, st in ps.items()},
                {n: v.numpy() for n, v in pa.items()},
                (outs[0].float() if outs[0].dtype == torch.bfloat16
                 else outs[0]).numpy())


def _close(got, want, what, tol=F64_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def test_f32_policy_overflow_sequence_matches_mxnet_tpu(jx):
    """A float64 ResNet-8 under Policy("float32", loss_scale=2**10,
    growth_interval=2): 4 SGD-momentum steps, the second on a batch holding
    an inf.  Parameters, momenta, moving statistics, outputs and the scale
    state equal the JAX package's within 1e-9; the overflow step kept the
    state of the step before it bitwise."""
    jax, mx = jx
    from mxnet_tpu.amp import Policy as JPolicy
    jsym = _resnet("jax", RES["classes"], RES["layers"], RES["image"])
    state = _res_state()
    batch = state[3]
    bad = dict(batch, data=batch["data"].copy())
    bad["data"][1, 2, 3, 4] = np.inf
    batches = [batch, bad, batch, batch]
    pol = dict(compute_dtype="float32", loss_scale=2.0 ** 10,
               growth_interval=2)
    jts, want = _jax_run(jax, mx, jsym, state, batches,
                         mx.optimizer.SGD(**SGD), policy=JPolicy(**pol))
    pts, got = _port_run(jsym.tojson(), state, batches,
                         mt.optimizer.SGD(**SGD), policy=Policy(**pol))
    assert got[0]["conv0_weight"].dtype == np.float64
    for k, what in ((0, "param"), (2, "aux")):
        assert sorted(got[k]) == sorted(want[k])
        for n in want[k]:
            _close(got[k][n], want[k][n], "%s %s" % (what, n))
    for n in want[1]:
        _close(got[1][n][0], want[1][n][0], "momentum " + n)
    _close(got[3], want[3], "outputs")
    assert got[3].dtype == np.float32        # the outputs cross as float32
    assert pts.scale_state_host() == jts.scale_state_host() == {
        "scale": 2.0 ** 10, "good": 0, "overflow": 1}
    # the overflow step kept the first step's state bitwise
    _, one = _port_run(jsym.tojson(), state, batches[:1],
                       mt.optimizer.SGD(**SGD), policy=Policy(**pol))
    _, two = _port_run(jsym.tojson(), state, batches[:2],
                       mt.optimizer.SGD(**SGD), policy=Policy(**pol))
    for k in (0, 2):
        for n in one[k]:
            assert np.array_equal(one[k][n], two[k][n]), n
    for n in one[1]:
        assert np.array_equal(one[1][n][0], two[1][n][0]), n


def _leaves(res):
    """{name: float64 array}: every first momentum (the gradient, with wd
    0), every moving statistic and the outputs of a one-step run."""
    out = {"momentum " + n: st[0] for n, st in res[1].items()}
    out.update({"aux " + n: v for n, v in res[2].items()})
    out["outputs"] = res[3]
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def _dist(got, want):
    d = got - want
    return (np.abs(d).max() / max(np.abs(want).max(), 1e-30),
            np.linalg.norm(d) / max(np.linalg.norm(want), 1e-30))


def _bf16_within(got, jbf16, jf32):
    """Every leaf of ``got`` within BF16_X times the JAX bf16-vs-f32
    distance of the JAX bf16 step."""
    got, jb, jf = _leaves(got), _leaves(jbf16), _leaves(jf32)
    assert sorted(got) == sorted(jb)
    worst = 0.0
    for n in jb:
        assert np.isfinite(got[n]).all(), n
        d = _dist(got[n], jb[n])
        base = _dist(jb[n], jf[n])
        for x, b in zip(d, base):
            ratio = x / max(b, BF16_MIN)
            worst = max(worst, ratio)
            assert ratio <= BF16_X, (n, d, base)
    return worst


@pytest.mark.parametrize("norm_conv", ["0", "1"])
def test_bf16_resnet_steps_within_mxnet_tpu_bf16_distance(norm_conv, jx32,
                                                          monkeypatch):
    """ResNet-8 (3x28x28, batch 4) from one float32 state, one
    SGD-momentum step under Policy("bfloat16") and one pure-cast
    dtype="bfloat16" step, unfused and through the NormConv peephole
    (whose plain version runs here in bfloat16): every gradient, moving
    statistic and output within BF16_X of the JAX bf16-vs-f32 distance."""
    jax, mx = jx32
    monkeypatch.setenv("MXNET_NORM_CONV", norm_conv)
    jsym = _resnet("jax", RES["classes"], RES["layers"], RES["image"])
    state = _res_state(np.float32)
    batches = [state[3]]
    opt = dict(SGD)
    _, jf = _jax_run(jax, mx, jsym, state, batches, mx.optimizer.SGD(**opt))
    calls = []
    real = pnc.norm_conv

    def counted(x, *a, **k):
        calls.append(x.dtype)
        return real(x, *a, **k)
    monkeypatch.setattr(pnc, "norm_conv", counted)
    for kw in (dict(policy="bfloat16"), dict(dtype="bfloat16")):
        _, jb = _jax_run(jax, mx, jsym, state, batches,
                         mx.optimizer.SGD(**opt), **kw)
        del calls[:]
        _, got = _port_run(jsym.tojson(), state, batches,
                           mt.optimizer.SGD(**opt), **kw)
        assert got[0]["conv0_weight"].dtype == np.float32
        assert (len(calls) > 0) == (norm_conv == "1")
        assert all(dt == torch.bfloat16 for dt in calls)
        _bf16_within(got, jb, jf)


def test_bf16_mlp_steps_within_mxnet_tpu_bf16_distance(jx32):
    """The MLP of test_amp.py, 3 steps under Policy("bfloat16") and under
    dtype="bfloat16": every parameter within BF16_X of the JAX
    bf16-vs-f32 distance."""
    jax, mx = jx32
    jsym = _mlp(mx.sym)
    rng = np.random.RandomState(4)
    arg_shapes, _, _ = jsym.infer_shape(data=(8, 10))
    params = {n: (rng.randn(*s) * 0.5).astype(np.float32)
              for n, s in zip(jsym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    state = (params, {n: (np.zeros_like(v),) for n, v in params.items()},
             {}, None)
    batches = [_data(seed=i) for i in range(3)]

    def opt(pkg):
        return pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9)
    _, jf = _jax_run(jax, mx, jsym, state, batches, opt(mx))
    for kw in (dict(policy="bfloat16"), dict(dtype="bfloat16")):
        _, jb = _jax_run(jax, mx, jsym, state, batches, opt(mx), **kw)
        _, got = _port_run(jsym.tojson(), state, batches, opt(mt), **kw)
        for n in jb[0]:
            d = _dist(np.float64(got[0][n]), np.float64(jb[0][n]))
            base = _dist(np.float64(jb[0][n]), np.float64(jf[0][n]))
            assert max(x / max(b, BF16_MIN) for x, b in zip(d, base)) \
                <= BF16_X, (kw, n, d, base)


def test_eval_step_policy_and_dtype_match_mxnet_tpu(jx32):
    """EvalStep on the ResNet-8: a float32 policy casts nothing (equal to
    the plain EvalStep bitwise); bfloat16 by policy and by dtype gives
    outputs in bfloat16 within BF16_X of the JAX bf16-vs-f32 distance."""
    jax, mx = jx32
    from mxnet_tpu.train import EvalStep as JEvalStep
    jsym = _resnet("jax", RES["classes"], RES["layers"], RES["image"])
    params, _, aux, batch = _res_state(np.float32)
    asj = jax.numpy.asarray

    def jeval(**kw):
        return np.asarray(JEvalStep(jsym, **kw)(
            {n: asj(v) for n, v in params.items()},
            {n: asj(v) for n, v in aux.items()},
            {k: asj(v) for k, v in batch.items()})[0]).astype(np.float64)
    pp, _, pa = mt.convert.train_state_from_numpy(params, {}, aux,
                                                  ctx=mt.cpu())
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    psym = mt.sym.load_json(jsym.tojson())
    plain = mt.EvalStep(psym)(pp, pa, pb)[0]
    f32 = mt.EvalStep(psym, policy=Policy("float32"))(pp, pa, pb)[0]
    assert torch.equal(plain, f32)
    jf = jeval()
    _close(plain.double().numpy(), jf, "float32 eval", tol=1e-5)
    for kw in (dict(policy="bfloat16"), dict(dtype="bfloat16")):
        got = mt.EvalStep(psym, **kw)(pp, pa, pb)[0]
        assert got.dtype == torch.bfloat16
        jb = jeval(**kw)
        d, base = _dist(got.double().numpy(), jb), _dist(jb, jf)
        assert all(x <= BF16_X * max(b, BF16_MIN)
                   for x, b in zip(d, base)), (kw, d, base)


# ------------------------------------------------------- head_grad_scale
HEADS = ["SoftmaxOutput", "LinearRegressionOutput",
         "LogisticRegressionOutput", "MAERegressionOutput", "MakeLoss",
         "SVMOutput"]


def _head_net(S, head):
    x = S.FullyConnected(S.Variable("data"), num_hidden=5, name="fc1")
    x = S.Activation(x, act_type="tanh")
    x = S.FullyConnected(x, num_hidden=4, name="fc2")
    if head == "MakeLoss":
        return S.MakeLoss(S.square(x), grad_scale=0.5, name="loss")
    return getattr(S, head)(x, S.Variable("label"), name="loss")


@pytest.mark.parametrize("head", HEADS)
def test_head_grad_scale_at_every_loss_head(head, jx):
    """_Lowered.run(head_grad_scale=S) in float64: every parameter's
    gradient is exactly S times the unscaled one (S a power of two), and
    equals the JAX package's scaled gradient within 1e-9."""
    jax, mx = jx
    jsym = _head_net(mx.sym, head)
    rng = np.random.RandomState(7)
    arg_shapes, _, _ = jsym.infer_shape(data=(6, 3))
    vals = {n: rng.randn(*s) * 0.7 for n, s in zip(jsym.list_arguments(),
                                                   arg_shapes)}
    if "label" in vals:
        vals["label"] = (rng.randint(0, 4, vals["label"].shape)
                         .astype(np.float64) if head in ("SoftmaxOutput",
                                                         "SVMOutput")
                         else rng.rand(*vals["label"].shape))
    inputs = ("data", "label")
    pnames = [n for n in vals if n not in inputs]
    low = _Lowered(mt.sym.load_json(jsym.tojson()))
    s = 2.0 ** 7

    def port(scale):
        leaves = {n: torch.tensor(v, requires_grad=n in pnames)
                  for n, v in vals.items()}
        outs, _ = low.run(leaves, {}, True, no_grad_inputs=inputs,
                          head_grad_scale=None if scale is None
                          else torch.tensor(np.float32(scale)))
        grads = torch.autograd.grad(
            outs, [leaves[n] for n in pnames],
            [torch.ones_like(o) for o in outs])
        return {n: g.numpy() for n, g in zip(pnames, grads)}
    plain, scaled = port(None), port(s)
    for n in pnames:
        assert np.abs(plain[n]).max() > 0, n
        assert np.array_equal(scaled[n], s * plain[n]), n

    from mxnet_tpu.executor import _Lowered as JLowered
    jlow = JLowered(jsym)
    asj = jax.numpy.asarray
    ins = {k: asj(v) for k, v in vals.items() if k in inputs}

    def f(p):
        outs, _ = jlow.run(dict(ins, **p), {}, jax.random.PRNGKey(0), True,
                           no_grad_inputs=inputs,
                           head_grad_scale=jax.numpy.float32(s))
        return tuple(outs)
    outs, vjp = jax.vjp(f, {n: asj(vals[n]) for n in pnames})
    jg = vjp(tuple(jax.numpy.ones_like(o) for o in outs))[0]
    for n in pnames:
        _close(scaled[n], np.asarray(jg[n]), n)


# --------------------------------------------------------------- remat
def _remat_net(pkg, dropout):
    S = pkg.sym
    d = S.Variable("data")
    x = S.Convolution(d, num_filter=4, kernel=(3, 3), pad=(1, 1),
                      no_bias=True, name="conv1")
    x = S.BatchNorm(x, fix_gamma=False, name="bn1")
    x = S.Activation(x, act_type="relu")
    if dropout:
        x = S.Dropout(x, p=0.4)
    x = S.Flatten(x)
    x = S.FullyConnected(x, num_hidden=6, name="fc1")
    x = S.Activation(x, act_type="tanh")
    x = S.FullyConnected(x, num_hidden=3, name="fc2")
    return S.SoftmaxOutput(x, name="softmax")


def _remat_state(sym, seed=5):
    rng = np.random.RandomState(seed)
    shapes = {"data": (4, 2, 5, 5), "softmax_label": (4,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    params = {n: rng.randn(*s) * 0.5 for n, s in zip(sym.list_arguments(),
                                                     arg_shapes)
              if n not in shapes}
    aux = {n: rng.rand(*s) + 0.5 for n, s in zip(
        sym.list_auxiliary_states(), aux_shapes)}
    batch = {"data": rng.randn(*shapes["data"]),
             "softmax_label": rng.randint(0, 3, 4).astype(np.float64)}
    return (params, {n: (np.zeros_like(v),) for n, v in params.items()},
            aux, batch)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_plain_step_and_mxnet_tpu(remat, jx):
    """Conv -> BatchNorm -> relu -> two FullyConnected layers, float64, 3
    SGD-momentum steps: remat equals the plain step bitwise, and the JAX
    package's remat step within 1e-9."""
    jax, mx = jx
    jsym = _remat_net(mx, False)
    state = _remat_state(jsym)
    batches = [state[3]] * 3
    _, want = _jax_run(jax, mx, jsym, state, batches,
                       mx.optimizer.SGD(**SGD), remat=remat)
    _, plain = _port_run(jsym.tojson(), state, batches,
                         mt.optimizer.SGD(**SGD))
    ts, got = _port_run(jsym.tojson(), state, batches,
                        mt.optimizer.SGD(**SGD), remat=remat)
    assert ts.remat == remat
    for k in (0, 2):
        for n in want[k]:
            assert np.array_equal(got[k][n], plain[k][n]), n
            _close(got[k][n], want[k][n], n)
    _close(got[3], want[3], "outputs")


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_with_dropout_replays_the_generator(remat, monkeypatch):
    """With Dropout in the graph the recompute draws its mask from the
    step device's generator: replayed, remat equals the plain step bitwise
    over 3 steps; without the replay the recompute draws another mask and
    the gradients differ."""
    state = _remat_state(_remat_net(mt, True))
    sym_json = _remat_net(mt, True).tojson()
    batches = [state[3]] * 3

    def run(**kw):
        prandom.seed(11)
        return _port_run(sym_json, state, batches,
                         mt.optimizer.SGD(**SGD), **kw)[1]
    plain, got = run(), run(remat=remat)
    for n in plain[0]:
        assert np.array_equal(got[0][n], plain[0][n]), n
    import contextlib
    monkeypatch.setattr(prandom, "replaying",
                        lambda gen, state: contextlib.nullcontext())
    broken = run(remat=remat)
    assert any(not np.allclose(broken[0][n], plain[0][n], rtol=1e-6,
                               atol=1e-9) for n in plain[0])


def test_remat_refuses_unknown_mode():
    with pytest.raises(mt.MXNetError, match="remat"):
        _make(remat="everything")


@pytest.mark.parametrize("kw,item", [
    ({"param_shardings": {"x": ("pp", None)}}, "the distributed slice"),
    ({"param_shardings": {"x": ("tp", None)}}, "the distributed slice"),
    ({"zero": 1, "param_shardings": {"x": ("tp",)}},
     "the distributed slice")])
def test_only_the_parallel_arguments_refuse(kw, item):
    """The mesh and ZeRO arguments train (tests/test_torch_zero*.py); a
    pipeline or tensor-parallel axis still refuses, naming its part."""
    part = "pipeline" if "pp" in str(kw) else "tensor-parallel"
    with pytest.raises(mt.MXNetError,
                       match="arrives with the %s part of %s" % (part, item)):
        mt.TrainStep(_mlp(mt.sym), mt.optimizer.SGD(), ctx=mt.cpu(), **kw)


# ------------------------------------------- float16 and the NormConv gate
def test_float16_runs_unfused_under_norm_conv(monkeypatch):
    """MXNET_NORM_CONV=1 with Policy("float16"): the peephole's dtype gate
    sends the BatchNorms and convolutions to the unfused ops (0 NormConv
    calls), while the bfloat16 policy takes NormConv at every fusable
    convolution."""
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    calls = []
    real = pnc.norm_conv

    def counted(x, *a, **k):
        calls.append(x.dtype)
        return real(x, *a, **k)
    monkeypatch.setattr(pnc, "norm_conv", counted)
    sym = _resnet("torch", RES["classes"], RES["layers"], RES["image"])
    state = _res_state(np.float32)
    counts = {}
    for dt in ("float16", "bfloat16"):
        del calls[:]
        pnc.launches = 0
        _, res = _port_run(sym.tojson(), state, [state[3]],
                           mt.optimizer.SGD(**SGD), policy=Policy(dt))
        assert all(np.isfinite(v).all() for v in res[0].values())
        counts[dt] = len(calls)
        assert pnc.launches == 0           # plain versions on the CPU
    assert counts["float16"] == 0 and counts["bfloat16"] > 0


# ------------------------------------------------------------------ C7
def test_bf16_ndarray_dtype_and_asnumpy_with_ml_dtypes():
    """With ml_dtypes importing (as the JAX package needs): the dtype is
    ml_dtypes' bfloat16 and asnumpy keeps the raw bfloat16 values."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    vals = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32).astype(
        ml_dtypes.bfloat16)
    a = mt.nd.array(vals, ctx=mt.cpu(), dtype=vals.dtype)
    assert a.value.dtype == torch.bfloat16
    assert a.dtype == np.dtype(ml_dtypes.bfloat16)
    got = a.asnumpy()
    assert got.dtype == np.dtype(ml_dtypes.bfloat16)
    assert np.array_equal(got.view(np.int16), vals.view(np.int16))
    assert a[1:3].asnumpy().dtype == got.dtype


def test_bf16_ndarray_dtype_and_asnumpy_without_ml_dtypes(monkeypatch):
    """Where ml_dtypes does not import: the dtype is torch.bfloat16 and
    asnumpy widens to float32."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    a = mt.nd.array(np.array([1.0, -2.5, 3.140625], np.float32),
                    ctx=mt.cpu(), dtype="bfloat16")
    assert a.dtype == torch.bfloat16
    got = a.asnumpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, np.array([1.0, -2.5, 3.140625], np.float32))
    assert mt.nd.array(np.arange(3.0), ctx=mt.cpu()).dtype == np.float32


# ----------------------------------------------------------------- card
@pytest.mark.cuda
def test_bf16_policy_step_on_card_matches_float64_cpu_step():
    """ResNet-8 (3x28x28, batch 4), one SGD-momentum step under
    Policy("bfloat16") on the card, unfused and fused: every gradient and
    moving statistic within BF16_X times the distance of the same bfloat16
    step on the CPU from the float64 CPU step (or BF16_MIN), and finite;
    fused, every NormConv launch in bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mp = pytest.MonkeyPatch()
    sym = _resnet("torch", RES["classes"], RES["layers"], RES["image"])
    state = _res_state(np.float64)
    opt = dict(SGD)
    try:
        for norm_conv in ("0", "1"):
            mp.setenv("MXNET_NORM_CONV", norm_conv)
            want = _port_run(sym.tojson(), state, [state[3]],
                             mt.optimizer.SGD(**opt))[1]
            s32 = tuple({n: (tuple(np.float32(x) for x in v)
                             if isinstance(v, tuple) else np.float32(v))
                         for n, v in d.items()} for d in state[:3]) + (
                {k: np.float32(v) for k, v in state[3].items()},)
            cpu = _port_run(sym.tojson(), s32, [s32[3]],
                            mt.optimizer.SGD(**opt), policy="bfloat16")[1]
            ts = mt.TrainStep(sym, mt.optimizer.SGD(**opt),
                              policy="bfloat16", ctx=mt.gpu(0))
            p, s, a = mt.convert.train_state_from_numpy(*s32[:3],
                                                        ctx=mt.gpu(0))
            pnc.launches = pnc.bf16_launches = 0
            p, s, a, outs = ts(p, s, a, ts.shard_batch(s32[3]))
            torch.cuda.synchronize()
            assert pnc.launches == pnc.bf16_launches
            assert (pnc.launches > 0) == (norm_conv == "1")
            card = ({n: v.cpu().numpy() for n, v in p.items()},
                    {n: tuple(x.cpu().numpy() for x in st)
                     for n, st in s.items()},
                    {n: v.cpu().numpy() for n, v in a.items()},
                    outs[0].float().cpu().numpy())
            got, ref, base = _leaves(card), _leaves(want), _leaves(cpu)
            for n in ref:
                assert np.isfinite(got[n]).all(), n
                d, b = _dist(got[n], ref[n]), _dist(base[n], ref[n])
                assert all(x <= BF16_X * max(y, BF16_MIN)
                           for x, y in zip(d, b)), (norm_conv, n, d, b)
    finally:
        mp.undo()


@pytest.mark.cuda
def test_float16_policy_on_card_launches_no_norm_conv(monkeypatch):
    """MXNET_NORM_CONV=1 under Policy("float16") on the card: the kernel
    takes float32 and bfloat16 only, so the step runs the unfused ops and
    launches NormConv 0 times; the masters stay finite float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    sym = _resnet("torch", RES["classes"], RES["layers"], RES["image"])
    state = _res_state(np.float32)
    ts = mt.TrainStep(sym, mt.optimizer.SGD(**SGD), policy="float16",
                      ctx=mt.gpu(0))
    p, s, a = mt.convert.train_state_from_numpy(*state[:3], ctx=mt.gpu(0))
    pnc.launches = 0
    p, s, a, outs = ts(p, s, a, ts.shard_batch(state[3]))
    torch.cuda.synchronize()
    assert pnc.launches == 0
    assert outs[0].dtype == torch.float32
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in p.values())
