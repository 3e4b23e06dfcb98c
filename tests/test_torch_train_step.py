"""Training the transformer LM through mxnet_tpu_torch against mxnet_tpu, in
float64 on one state carried across as numpy: a 2-layer, hidden-64, 4-head,
T=128, vocab-97 LM (as tests/test_torch_transformer.py).  The port's
gradients with attn_impl='flash' (the autograd Function over the plain
versions) and 'xla' against the JAX 'xla' graph's; the parameters after 4
Adam and 4 SGD-momentum TrainStep steps; run_steps against sequential
steps, stacked and not; EvalStep; and the refusals of what is not ported
(mesh, param_shardings and zero; the AMP arguments are tested in
tests/test_torch_amp.py)."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import name as jname
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.train import EvalStep as JEvalStep
from mxnet_tpu.train import TrainStep as JTrainStep
from mxnet_tpu_torch import name as pname
from mxnet_tpu_torch.models import transformer as ptransformer
from test_torch_threads import torch_threads_per_worker  # noqa: F401

CFG = dict(vocab_size=97, seq_len=128, num_layers=2, num_hidden=64,
           num_heads=4)
BATCH = 2
SHAPES = {"data": (BATCH, CFG["seq_len"]),
          "softmax_label": (BATCH, CFG["seq_len"])}
REL = 1e-9


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _jsym(**kw):
    with jname.NameManager():
        return jtransformer.get_symbol(**dict(CFG, **kw))


def _psym(**kw):
    with pname.NameManager():
        return ptransformer.get_symbol(**dict(CFG, **kw))


def _weights(sym, seed=0):
    """N(0, 0.02) weights and biases, LayerNorm gamma near 1, float64."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    out = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in SHAPES:
            continue
        v = rng.randn(*s) * 0.02
        if n.endswith("_gamma"):
            v = 1.0 + rng.randn(*s) * 0.1
        out[n] = v
    return out


def _batch(seed, n=None):
    """Tokens and next-token labels, float64 (MXNet's label type)."""
    rng = np.random.RandomState(seed)
    shape = (BATCH, CFG["seq_len"] + 1) if n is None \
        else (n, BATCH, CFG["seq_len"] + 1)
    toks = rng.randint(0, CFG["vocab_size"], shape).astype(np.float64)
    return {"data": toks[..., :-1].copy(),
            "softmax_label": toks[..., 1:].copy()}


def _close(got, want, what):
    """Every entry within REL of the largest magnitude of that tensor."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= REL * scale, \
        "%s: max |d| %.3g > %g x %.3g" % (what, err, REL, scale)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_lm_gradients_match_mxnet_tpu(impl, f64):
    """Executor forward(is_train=True) + backward(): every parameter's
    gradient equals the JAX 'xla' graph's."""
    jsym = _jsym(attn_impl="xla")
    args = _weights(jsym, seed=1)
    args.update(_batch(seed=2))
    jex = jsym.bind(mx.cpu(), {n: mx.nd.array(v, dtype=np.float64)
                               for n, v in args.items()},
                    args_grad={n: mx.nd.zeros(v.shape, dtype=np.float64)
                               for n, v in args.items() if n not in SHAPES})
    jex.forward(is_train=True)
    jex.backward()
    cpu = mt.cpu()
    pex = _psym(attn_impl=impl).bind(
        cpu, {n: mt.nd.array(v, ctx=cpu, dtype=np.float64)
              for n, v in args.items()},
        args_grad={n: mt.nd.zeros(v.shape, ctx=cpu, dtype=np.float64)
                   for n, v in args.items() if n not in SHAPES})
    pex.forward(is_train=True)
    pex.backward()
    assert sorted(pex.grad_dict) == sorted(jex.grad_dict)
    assert len(pex.grad_dict) == 2 + 12 * CFG["num_layers"] + 4
    for n, g in jex.grad_dict.items():
        _close(pex.grad_dict[n].asnumpy(), g.asnumpy(), n)
    _close(pex.outputs[0].asnumpy(), jex.outputs[0].asnumpy(), "probs")


def _both_steps(optimizer, impl, f64_steps=4):
    """The same float64 state and batch through f64_steps TrainStep calls
    of each package; returns (port params, JAX params as numpy)."""
    jopt, popt = optimizer
    jsym = _jsym(attn_impl="xla")
    params = _weights(jsym, seed=3)
    batch = _batch(seed=4)
    jts = JTrainStep(jsym, jopt)
    jstate = jts.fopt.init_state(params)
    jp = {n: jax.numpy.asarray(v) for n, v in params.items()}
    js = {n: tuple(jax.numpy.asarray(s) for s in st)
          for n, st in jstate.items()}
    ja, jb = {}, jts.shard_batch(batch)
    pts = mt.TrainStep(_psym(attn_impl=impl), popt, ctx=mt.cpu())
    pp, ps, pa = mt.convert.train_state_from_numpy(
        params, {n: tuple(np.asarray(s) for s in st)
                 for n, st in jstate.items()}, {}, ctx=mt.cpu())
    pb = pts.shard_batch(batch)
    for _ in range(f64_steps):
        jp, js, ja, jouts = jts(jp, js, ja, jb)
        pp, ps, pa, pouts = pts(pp, ps, pa, pb)
    _close(pouts[0].numpy(), np.asarray(jouts[0]), "last outputs")
    return pp, {n: np.asarray(v) for n, v in jp.items()}


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_adam_steps_match_mxnet_tpu(impl, f64):
    """4 Adam steps (float32-rounded lr and bias correction, as the JAX
    step computes them) from one state: every parameter within 1e-9."""
    pp, jp = _both_steps((mx.optimizer.Adam(learning_rate=1e-3),
                          mt.optimizer.Adam(learning_rate=1e-3)), impl)
    assert pp["layer0_qkv_weight"].dtype == torch.float64
    for n, v in jp.items():
        _close(pp[n].numpy(), v, n)


def test_sgd_momentum_steps_match_mxnet_tpu(f64):
    """4 SGD-momentum steps with weight decay (applied to *_weight and
    *_gamma only) and rescale_grad: every parameter within 1e-9."""
    kw = dict(learning_rate=0.05, momentum=0.9, wd=1e-3, rescale_grad=0.25)
    pp, jp = _both_steps((mx.optimizer.SGD(**kw), mt.optimizer.SGD(**kw)),
                         "flash")
    for n, v in jp.items():
        _close(pp[n].numpy(), v, n)


RULES = [
    ("ccSGD", dict(learning_rate=0.05, momentum=0.9, clip_gradient=0.5)),
    ("SGD", dict(learning_rate=0.05, wd=1e-2)),
    ("NAG", dict(learning_rate=0.05, momentum=0.9, wd=1e-2)),
    ("NAG", dict(learning_rate=0.05, clip_gradient=0.1)),
    ("RMSProp", dict(learning_rate=0.01, wd=1e-2, clip_weights=0.3)),
    ("RMSProp", dict(learning_rate=0.01, centered=True)),
    ("AdaGrad", dict(learning_rate=0.1, wd=1e-2, rescale_grad=0.5)),
    ("AdaDelta", dict(rho=0.8, wd=1e-2, clip_gradient=0.2)),
    ("Adam", dict(learning_rate=0.01, lr_scheduler="factor")),
]


@pytest.mark.parametrize("rule", RULES, ids=["%d-%s" % (i, r[0])
                                             for i, r in enumerate(RULES)])
def test_rules_match_mxnet_tpu(rule, f64):
    """Every ported rule of _FunctionalOptimizer, 3 steps of a small MLP
    (a schedule sampled per call for Adam), against the JAX TrainStep."""
    name, kw = rule

    def make(pkg):
        args = dict(kw)
        if args.get("lr_scheduler") == "factor":
            args["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(
                step=1, factor=0.5)
        return pkg.optimizer.create(name.lower(), **args)

    def mlp(S):
        x = S.FullyConnected(S.Variable("data"), num_hidden=6, name="fc1")
        x = S.Activation(x, act_type="tanh")
        x = S.FullyConnected(x, num_hidden=4, name="fc2")
        return S.SoftmaxOutput(x, S.Variable("softmax_label"),
                               name="softmax")
    jsym = mlp(mx.sym)
    rng = np.random.RandomState(12)
    arg_shapes, _, _ = jsym.infer_shape(data=(5, 3))
    params = {n: rng.randn(*s) * 0.5 for n, s in zip(jsym.list_arguments(),
                                                     arg_shapes)
              if n not in ("data", "softmax_label")}
    batch = {"data": rng.randn(5, 3),
             "softmax_label": rng.randint(0, 4, 5).astype(np.float64)}
    jts = JTrainStep(jsym, make(mx))
    jstate = jts.fopt.init_state(params)
    jp = {n: jax.numpy.asarray(v) for n, v in params.items()}
    js = {n: tuple(jax.numpy.asarray(s) for s in st)
          for n, st in jstate.items()}
    pts = mt.TrainStep(mt.sym.load_json(jsym.tojson()), make(mt),
                       ctx=mt.cpu())
    pp, ps, _ = mt.convert.train_state_from_numpy(params, jstate, {},
                                                  ctx=mt.cpu())
    assert [len(st) for st in ps.values()] == \
        [len(st) for st in pts.fopt.init_state(pp).values()]
    jb, pb = jts.shard_batch(batch), pts.shard_batch(batch)
    ja, pa = {}, {}
    for _ in range(3):
        jp, js, ja, _ = jts(jp, js, ja, jb)
        pp, ps, pa, _ = pts(pp, ps, pa, pb)
    for n, v in jp.items():
        _close(pp[n].numpy(), np.asarray(v), n)


@pytest.mark.parametrize("stacked", [False, True])
def test_run_steps_equals_sequential(stacked):
    """run_steps(..., 3) is 4 steps: the lr sampled once, the step count
    advancing per step, one batch or one slice per step; its result equals
    4 sequential calls (float32, plain versions on the CPU)."""
    net = _psym(attn_impl="flash")
    opt = dict(learning_rate=0.01,
               lr_scheduler=mt.lr_scheduler.FactorScheduler(step=100))
    batch = _batch(seed=5, n=4 if stacked else None)
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    results = []
    for fused in (True, False):
        ts = mt.TrainStep(net, mt.optimizer.Adam(**opt), ctx=mt.cpu())
        p, s, a = ts.init({"data": SHAPES["data"]},
                          {"softmax_label": SHAPES["softmax_label"]}, seed=6)
        b = ts.shard_batch(batch)
        if fused:
            p, s, a, outs = ts.run_steps(p, s, a, b, 3, stacked=stacked)
        else:
            for i in range(4):
                bi = {k: v[i] for k, v in b.items()} if stacked else b
                p, s, a, outs = ts(p, s, a, bi)
        assert ts.num_update == 4
        results.append((p, s, outs))
    (p1, s1, o1), (p2, s2, o2) = results
    for n in p1:
        assert torch.equal(p1[n], p2[n]), n
        assert all(torch.equal(x, y) for x, y in zip(s1[n], s2[n])), n
    assert torch.equal(o1[0], o2[0])
    with pytest.raises(mt.MXNetError, match="leading axis"):
        ts.run_steps(p1, s1, {}, ts.shard_batch(_batch(seed=7, n=2)), 3,
                     stacked=True)


def test_trainstep_lowers_the_loss_and_updates_in_place():
    """The default init (Xavier, seed) and Adam lower the loss on a fixed
    batch; params, state and aux come back as the same dicts and tensors,
    updated in place."""
    ts = mt.TrainStep(_psym(attn_impl="flash"),
                      mt.optimizer.create("adam", learning_rate=3e-3),
                      ctx=mt.cpu())
    p, s, a = ts.init({"data": SHAPES["data"]},
                      {"softmax_label": SHAPES["softmax_label"]})
    b = ts.shard_batch({k: v.astype(np.float32)
                        for k, v in _batch(seed=8).items()})
    lab = b["softmax_label"].reshape(-1).long()

    def loss(outs):
        probs = outs[0]
        return -torch.log(probs[torch.arange(len(lab)), lab]).mean().item()
    w = p["layer0_qkv_weight"]
    p2, s2, a2, outs = ts(p, s, a, b)
    first = loss(outs)
    assert p2 is p and s2 is s and a2 is a and p2["layer0_qkv_weight"] is w
    assert not outs[0].requires_grad
    p, s, a, outs = ts.run_steps(p, s, a, b, 4)
    assert loss(outs) < first and ts.num_update == 6


def test_eval_step_matches_mxnet_tpu(f64):
    jsym = _jsym()
    params = _weights(jsym, seed=9)
    batch = _batch(seed=10)
    want = JEvalStep(jsym)({n: jax.numpy.asarray(v)
                            for n, v in params.items()}, {},
                           {k: jax.numpy.asarray(v)
                            for k, v in batch.items()})
    pp, _, _ = mt.convert.train_state_from_numpy(params, {}, {},
                                                 ctx=mt.cpu())
    got = mt.EvalStep(_psym())(pp, {}, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert len(got) == len(want) == 1 and not got[0].requires_grad
    _close(got[0].numpy(), np.asarray(want[0]), "eval outputs")


@pytest.mark.parametrize("kw,item", [
    ({"param_shardings": {"x": ("pp", None)}}, "the distributed slice"),
    ({"param_shardings": {"x": ("tp", None)}}, "the distributed slice"),
    ({"zero": 1, "param_shardings": {"x": ("tp",)}},
     "the distributed slice")])
def test_trainstep_refuses_what_is_not_ported(kw, item):
    """A pipeline or tensor-parallel axis refuses, naming its part; the
    mesh and ZeRO arguments train (tests/test_torch_zero*.py)."""
    part = "pipeline" if "pp" in str(kw) else "tensor-parallel"
    with pytest.raises(mt.MXNetError,
                       match="arrives with the %s part of %s" % (part, item)):
        mt.TrainStep(_psym(), mt.optimizer.SGD(), ctx=mt.cpu(), **kw)


def test_unported_rules_and_ops_refuse():
    """An optimizer TrainStep has no rule for raises MXNetError; BatchNorm
    trains (its moving statistics move), unfused and through the NormConv
    peephole under is_train, which takes the same step."""
    class SGLD(mt.optimizer.Optimizer):
        pass
    with pytest.raises(mt.MXNetError, match="optimizer.Updater"):
        mt.TrainStep(_psym(), SGLD(), ctx=mt.cpu())
    S = mt.sym
    bn = S.BatchNorm(S.Variable("data"), fix_gamma=False, name="bn")
    net = S.Convolution(S.Activation(bn, act_type="relu"), num_filter=4,
                        kernel=(3, 3), pad=(1, 1), no_bias=True, name="conv")
    net = S.SoftmaxOutput(S.Flatten(net), S.Variable("softmax_label"))
    ts = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
    p, s, a = ts.init({"data": (2, 3, 6, 6)}, {"softmax_label": (2,)})
    b = ts.shard_batch({"data": np.arange(216, dtype=np.float32)
                        .reshape(2, 3, 6, 6) % 7,
                        "softmax_label": np.zeros(2, np.float32)})
    start = [{n: v.clone() for n, v in d.items()} for d in (p, a)]
    ts(p, s, a, b)
    assert all(torch.isfinite(v).all() for v in p.values())
    assert not torch.equal(a["bn_moving_var"], start[1]["bn_moving_var"])
    import os
    prev = os.environ.get("MXNET_NORM_CONV")
    os.environ["MXNET_NORM_CONV"] = "1"
    try:
        ts2 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
        p2, s2, a2 = start[0], ts2.fopt.init_state(start[0]), start[1]
        ts2(p2, s2, a2, b)
    finally:
        if prev is None:
            del os.environ["MXNET_NORM_CONV"]
        else:
            os.environ["MXNET_NORM_CONV"] = prev
    for n in p:
        torch.testing.assert_close(p2[n], p[n], rtol=1e-5, atol=1e-6)
    for n in a:
        torch.testing.assert_close(a2[n], a[n], rtol=1e-5, atol=1e-6)


def test_initializers_and_scheduler():
    """The name rules (bias 0, gamma 1, moving_var 1, an ``__init__``
    attribute wins), Xavier's scale, the seeded generator and the factor
    schedule's boundaries."""
    init = mt.initializer
    cpu = mt.cpu()
    arr = mt.nd.zeros((64, 32), ctx=cpu)
    init.Xavier(magnitude=2.0)(init.InitDesc("fc_weight"), arr)
    bound = np.sqrt(2.0 / 48.0)
    v = arr.asnumpy()
    assert np.abs(v).max() <= bound and np.abs(v).max() > 0.9 * bound
    mt.random.seed(5)
    a = mt.random.normal(0, 1, (4,))
    mt.random.seed(5)
    assert torch.equal(a, mt.random.normal(0, 1, (4,)))
    for name, want in (("fc_bias", 0.0), ("ln_gamma", 1.0),
                       ("ln_beta", 0.0), ("bn_moving_var", 1.0)):
        arr = mt.nd.zeros((3,), ctx=cpu) if want else \
            mt.nd.array(np.ones(3), ctx=cpu)
        init.Uniform()(init.InitDesc(name), arr)
        assert (arr.asnumpy() == want).all(), name
    arr = mt.nd.zeros((3,), ctx=cpu)
    init.Uniform()(init.InitDesc("x_weight", {"__init__": init.Constant(
        0.5).dumps()}), arr)
    assert (arr.asnumpy() == 0.5).all()
    sched = mt.lr_scheduler.FactorScheduler(step=10, factor=0.5)
    sched.base_lr = 1.0
    assert [sched(n) for n in (1, 10, 11, 21)] == [1.0, 1.0, 0.5, 0.25]
    multi = mt.lr_scheduler.MultiFactorScheduler([5, 8], factor=0.1)
    multi.base_lr = 1.0
    assert [multi(n) for n in (5, 6, 9)] == [1.0, 0.1, pytest.approx(0.01)]
