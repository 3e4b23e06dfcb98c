"""ResNet training through mxnet_tpu_torch against mxnet_tpu, on the CPU at
small sizes, in float64 (the JAX package with MXNET_NORM_CONV=0, its
default, as its own tests run it).

- BatchNorm's training backward: the port's ``BatchNormTrain`` (through the
  ``BatchNorm`` op) and ``BatchNormReLUTrain`` against ``jax.grad`` of the
  JAX package's ``_batch_norm`` and ``_bn_relu_train_core``, with the
  cotangents of the mean and var outputs, NCHW and NHWC, ``fix_gamma`` on
  and off, and for the fused op inputs whose pre-activation is exactly 0;
  ``torch.autograd.gradcheck`` of both Functions.
- One SGD-momentum ``TrainStep`` step of ResNet-50 (3x32x32, batch 4) from
  one state: every parameter, optimizer state and moving statistic.
- The symbolic path: ``simple_bind`` -> ``forward(is_train=True)`` ->
  ``backward()`` against the JAX package's and against ``TrainStep``;
  ``copy_params_from`` and ``reshape``.
- Dropout: the identity outside training; in training the kept share and
  the 1 / keep scale by statistics (torch's Philox and JAX's threefry give
  other streams).
- ``bench/resnet50_train.py`` at toy size.
- On the card (``cuda`` marker, skipped without one): the float32 step
  against the float64 step on the CPU.

JAX is imported by the tests that compare with it, not by the module, so
that the ``cuda`` test also runs where only the port is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_resnet_train.py``.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import name as pname
from mxnet_tpu_torch.bench import resnet50_train
from mxnet_tpu_torch.models import resnet as presnet
from mxnet_tpu_torch.ops import nn as pnn

BN_TOL = 1e-10
STEP_TOL = 1e-9
F32_ROUNDING = 2.0 ** -23
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4, rescale_grad=0.25)
# the f32 step on the card against the f64 step on the CPU: each leaf
# within this factor of its own float32 floor measured beside it (the
# largest over the state and FLOOR_SAMPLES - 1 nudges of it by up to
# FLOOR_NUDGE relative, about a float32 convolution's accumulated
# rounding), or of FLOOR_MIN
FLOOR_FACTOR = 4.0
FLOOR_SAMPLES = 4
FLOOR_NUDGE = 2.0 ** -18
FLOOR_MIN = 1e-6


@pytest.fixture
def jx():
    """(jax, mxnet_tpu) with 64-bit mode on, and MXNET_NORM_CONV=0."""
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    jax.config.update("jax_enable_x64", True)
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_NORM_CONV", "0")
    yield jax, mx
    mp.undo()
    jax.config.update("jax_enable_x64", False)


def _close(got, want, what, tol=STEP_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ------------------------------------------------------ BatchNorm's backward
def _bn_inputs(layout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 3, 5, 5)
    if layout == "NHWC":
        x = np.moveaxis(x, 1, -1).copy()
    return (x, rng.rand(3) + 0.5, rng.randn(3), rng.randn(3) * 0.1,
            rng.rand(3) + 0.5)


def _t(v):
    return torch.tensor(v, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_bn_train_vjp_matches_mxnet_tpu(layout, fix_gamma, jx):
    """The BatchNorm op in training: out, mean, var, the moving statistics
    and the gradients of x, gamma and beta (with the mean/var cotangents)
    equal the JAX package's within BN_TOL."""
    jax, _ = jx
    from mxnet_tpu.ops import nn as jnn
    jnp = jax.numpy
    x, g, b, mm, mv = _bn_inputs(layout)
    kw = dict(is_train=True, fix_gamma=fix_gamma, output_mean_var=True,
              momentum=0.9, layout=layout if layout == "NHWC" else None)

    def jloss(x, g, b):
        out, mean, var, nmm, nmv = jnn._batch_norm(
            x, g, b, jnp.asarray(mm), jnp.asarray(mv), **kw)
        return jnp.sum(out * jnp.cos(out)) + jnp.sum(mean * var * var), \
            (out, mean, var, nmm, nmv)
    (_, jouts), want = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(x, g, b)
    tx, tg, tb = _t(x), _t(g), _t(b)
    pouts = pnn._batch_norm(tx, tg, tb, torch.tensor(mm), torch.tensor(mv),
                            **kw)
    out, mean, var = pouts[:3]
    loss = (out * torch.cos(out)).sum() + (mean * var * var).sum()
    got = torch.autograd.grad(loss, [tx, tg, tb], allow_unused=True)
    assert not pouts[3].requires_grad and not pouts[4].requires_grad
    for i, (p, j) in enumerate(zip(pouts, jouts)):
        _close(p.detach(), j, "output %d" % i, BN_TOL)
    for name, p, j in zip(("x", "gamma", "beta"), got, want):
        if name == "gamma" and fix_gamma:
            assert p is None and not np.asarray(j).any()
            continue
        _close(p, j, "d" + name, BN_TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_bn_relu_train_vjp_matches_mxnet_tpu(layout, jx):
    """BatchNormReLUTrain against ``_bn_relu_train_core``, with the mean/var
    cotangents, on inputs where the pre-activation is exactly 0 at some
    elements (channels 0 and 1 have mean 0 and beta 0, and hold zeros): the
    gate is ``pre > 0`` in both, so those elements take no gradient."""
    jax, _ = jx
    from mxnet_tpu.ops import nn as jnn
    jnp = jax.numpy
    rng = np.random.RandomState(1)
    # channels 0-1: symmetric multiples of 1/8 (mean exactly 0) with zeros
    half = rng.randint(-16, 17, (2, 2, 4, 4)) / 8.0
    half[0, :, 0, :2] = 0.0
    x = rng.randn(4, 3, 4, 4)
    x[:2, :2], x[2:, :2] = half, -half
    g, b = rng.rand(3) + 0.5, np.array([0.0, 0.0, 0.3])
    w = rng.randn(*x.shape)
    caxis = 1
    if layout == "NHWC":
        x, w, caxis = np.moveaxis(x, 1, -1).copy(), \
            np.moveaxis(w, 1, -1).copy(), 3

    def jloss(x, g, b):
        out, mean, var = jnn._bn_relu_train_core(x, g, b, 1e-3, caxis)
        return jnp.sum(out * w) + jnp.sum(mean * var * var), out
    (_, jout), want = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(x, g, b)
    tx, tg, tb = _t(x), _t(g), _t(b)
    out, mean, var = pnn.BatchNormReLUTrain.apply(tx, tg, tb, 1e-3, caxis)
    assert mean[0].item() == mean[1].item() == 0.0
    assert int((x == 0).sum()) >= 8 and int((jout == 0).sum()) > 8
    loss = (out * torch.from_numpy(w)).sum() + (mean * var * var).sum()
    got = torch.autograd.grad(loss, [tx, tg, tb])
    _close(out.detach(), jout, "out", BN_TOL)
    for name, p, j in zip(("x", "gamma", "beta"), got, want):
        _close(p, j, "d" + name, BN_TOL)


@pytest.mark.parametrize("fn", [pnn.BatchNormTrain, pnn.BatchNormReLUTrain],
                         ids=["bn", "bn_relu"])
@pytest.mark.parametrize("caxis", [1, 3])
def test_bn_functions_gradcheck(fn, caxis):
    """Finite differences of out, mean and var through both Functions."""
    gen = torch.Generator().manual_seed(2)
    shape = [3, 2, 3, 3]
    shape[caxis] = 2
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * 2 + 0.5
    g = torch.rand(2, generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn(2, generator=gen, dtype=torch.float64)
    args = tuple(t.requires_grad_(True) for t in (x, g, b))
    assert torch.autograd.gradcheck(
        lambda x, g, b: fn.apply(x, g, b, 1e-3, caxis), args)


# ------------------------------------------------------ one ResNet-50 step
def _resnet(pkg_name, classes, layers, image):
    if pkg_name == "torch":
        with pname.NameManager():
            return presnet.get_symbol(classes, layers,
                                      "3,%d,%d" % (image, image))
    from mxnet_tpu import name as jname
    from mxnet_tpu.models import resnet as jresnet
    with jname.NameManager():
        return jresnet.get_symbol(classes, layers, "3,%d,%d" % (image, image))


def _state(sym, batch, image, classes, seed=0):
    """Parameters (the default Xavier init of the port's TrainStep), a
    zero momentum, moving statistics and a batch, as float64 numpy."""
    ts = mt.TrainStep(sym, mt.optimizer.SGD(**SGD), ctx=mt.cpu())
    p, s, a = ts.init({"data": (batch, 3, image, image)},
                      {"softmax_label": (batch,)}, seed=seed)
    rng = np.random.RandomState(seed)
    aux = {n: v.double().numpy() + rng.uniform(-0.1, 0.1, v.shape)
           for n, v in a.items()}
    data = {"data": rng.uniform(-1, 1, (batch, 3, image, image)),
            "softmax_label": rng.randint(0, classes, (batch,)).astype(
                np.float64)}
    return ({n: v.double().numpy() for n, v in p.items()},
            {n: tuple(x.double().numpy() for x in st) for n, st in s.items()},
            aux, data)


def test_resnet50_train_step_matches_mxnet_tpu(jx):
    """ResNet-50 (3x32x32, 10 classes, batch 4), one TrainStep step with
    SGD-momentum, weight decay and rescale_grad from one float64 state:
    every parameter, momentum and moving statistic, and the outputs, of
    the port's TrainStep equal the JAX package's within 1e-9."""
    jax, mx = jx
    from mxnet_tpu.train import TrainStep as JTrainStep
    jsym = _resnet("jax", 10, 50, 32)
    params, state, aux, batch = _state(_resnet("torch", 10, 50, 32), 4, 32,
                                       10)
    jts = JTrainStep(jsym, mx.optimizer.SGD(**SGD))
    asj = jax.numpy.asarray
    jp, js, ja, jouts = jts({n: asj(v) for n, v in params.items()},
                            {n: tuple(asj(x) for x in st)
                             for n, st in state.items()},
                            {n: asj(v) for n, v in aux.items()},
                            jts.shard_batch(batch))
    pts = mt.TrainStep(mt.sym.load_json(jsym.tojson()),
                       mt.optimizer.SGD(**SGD), ctx=mt.cpu())
    pp, ps, pa = mt.convert.train_state_from_numpy(params, state, aux,
                                                   ctx=mt.cpu())
    pp, ps, pa, pouts = pts(pp, ps, pa, pts.shard_batch(batch))
    assert pp["conv0_weight"].dtype == torch.float64
    assert sorted(pp) == sorted(jp) and sorted(pa) == sorted(ja)
    for n in jp:
        _close(pp[n], jp[n], n)
        _close(ps[n][0], js[n][0], n + " momentum")
        assert not np.array_equal(pp[n].numpy(), params[n]), n
    for n in ja:
        _close(pa[n], ja[n], n)
        assert not np.array_equal(pa[n].numpy(), aux[n]), n
    _close(pouts[0], jouts[0], "outputs")
    # fix_gamma: bn_data's gamma has no gradient, and moves by wd alone
    lr = float(np.float32(SGD["learning_rate"]))     # the step's f32 lr
    _close(pp["bn_data_gamma"], params["bn_data_gamma"]
           * (1.0 - lr * SGD["wd"]), "bn_data_gamma")


# -------------------------------------------------------- the symbolic path
def _simple_bind(pkg, sym, params, aux, batch):
    """simple_bind at float64 with gradients of the parameters only,
    copy_params_from, one forward(is_train=True) and backward()."""
    names = sym.list_arguments()
    ex = sym.simple_bind(pkg.cpu(), type_dict={n: np.float64 for n in names},
                         grad_req={n: "null" if n in batch else "write"
                                   for n in names},
                         **{k: v.shape for k, v in batch.items()})
    ex.copy_params_from({n: pkg.nd.array(v, ctx=pkg.cpu(), dtype=np.float64)
                         for n, v in params.items()}, aux)
    ex.forward(is_train=True, **{k: pkg.nd.array(v, ctx=pkg.cpu(),
                                                 dtype=np.float64)
                                 for k, v in batch.items()})
    ex.backward()
    return ex


def test_simple_bind_training_matches_mxnet_tpu_and_trainstep(jx):
    """ResNet-18 (3x32x32, batch 4): simple_bind -> forward(is_train=True)
    -> backward() gives the JAX package's gradients and moving statistics
    within 1e-9, and the Updater over those gradients gives TrainStep's
    step (parameters, momenta and moving statistics)."""
    jax, mx = jx
    jsym = _resnet("jax", 10, 18, 32)
    psym = mt.sym.load_json(jsym.tojson())
    params, state, aux, batch = _state(psym, 4, 32, 10, seed=3)
    jex = _simple_bind(mx, jsym, params, aux, batch)
    pex = _simple_bind(mt, psym, params, aux, batch)
    assert sorted(pex.grad_dict) == sorted(jex.grad_dict) == sorted(params)
    assert [a.shape for a in pex.arg_arrays] == \
        [a.shape for a in jex.arg_arrays]
    assert [g is None for g in pex.grad_arrays] == \
        [g is None for g in jex.grad_arrays]
    for n, g in jex.grad_dict.items():
        _close(pex.grad_dict[n].asnumpy(), g.asnumpy(), "grad " + n)
    # simple_bind infers float32 moving statistics in both packages, so
    # they agree to one float32 rounding of the same float64 statistics
    assert pex.aux_names == jex.aux_names
    for p, j, n in zip(pex.aux_arrays, jex.aux_arrays, pex.aux_names):
        assert p.dtype == j.dtype == np.float32
        _close(p.asnumpy(), j.asnumpy(), n, F32_ROUNDING)
    _close(pex.outputs[0].asnumpy(), jex.outputs[0].asnumpy(), "outputs")

    opt = dict(SGD, learning_rate=0.5, momentum=0.5)   # float32-exact
    names = sorted(params)
    upd = mt.optimizer.get_updater(mt.optimizer.SGD(
        param_idx2name=dict(enumerate(names)), **opt))
    for i, n in enumerate(names):
        upd(i, pex.grad_dict[n], pex.arg_dict[n])
    ts = mt.TrainStep(psym, mt.optimizer.SGD(**opt), ctx=mt.cpu())
    pp, ps, pa = mt.convert.train_state_from_numpy(params, state, aux,
                                                   ctx=mt.cpu())
    pp, ps, pa, _ = ts(pp, ps, pa, ts.shard_batch(batch))
    for i, n in enumerate(names):
        _close(pex.arg_dict[n].asnumpy(), pp[n], n)
        _close(upd.states[i].asnumpy(), ps[n][0], n + " momentum")
    for n in pa:
        _close(pex.aux_dict[n].asnumpy(), pa[n], n, F32_ROUNDING)


def test_copy_params_from_and_reshape_match_mxnet_tpu(jx):
    """copy_params_from: NDArray and numpy sources at the bound dtype, an
    unknown name refused unless allow_extra_params.  reshape to batch 2:
    parameters and their gradients shared, data and label new, and the
    forward equal to the JAX package's reshaped executor's."""
    jax, mx = jx
    jsym = _resnet("jax", 10, 18, 32)
    psym = mt.sym.load_json(jsym.tojson())
    params, _, aux, batch = _state(psym, 4, 32, 10, seed=4)
    small = {k: v[:2] for k, v in batch.items()}
    outs = []
    for pkg, sym in ((mx, jsym), (mt, psym)):
        ex = sym.simple_bind(pkg.cpu(), data=(4, 3, 32, 32),
                             softmax_label=(4,))
        with pytest.raises(pkg.MXNetError, match="unknown"):
            ex.copy_params_from({"nope": np.zeros(2)})
        ex.copy_params_from(dict(params, nope=np.zeros(2)),
                            {n: pkg.nd.array(v, ctx=pkg.cpu())
                             for n, v in aux.items()},
                            allow_extra_params=True)
        w = ex.arg_dict["fc1_weight"]
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w.asnumpy(),
                                      params["fc1_weight"].astype(np.float32))
        ex2 = ex.reshape(data=(2, 3, 32, 32), softmax_label=(2,))
        assert ex2.arg_dict["fc1_weight"] is w
        assert ex2.grad_dict["fc1_weight"] is ex.grad_dict["fc1_weight"]
        assert ex2.aux_dict["bn1_moving_var"] is ex.aux_dict["bn1_moving_var"]
        assert ex2.arg_dict["data"].shape == (2, 3, 32, 32)
        assert ex.arg_dict["data"].shape == (4, 3, 32, 32)
        ex2.forward(is_train=False, **{k: pkg.nd.array(v, ctx=pkg.cpu())
                                       for k, v in small.items()})
        outs.append(ex2.outputs[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_simple_bind_refuses_group2ctx():
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2)
    with pytest.raises(mt.MXNetError, match="parallel slice"):
        net.simple_bind(mt.cpu(), group2ctx={"a": mt.cpu()}, data=(2, 3))


def test_simple_bind_refuses_shared_exec():
    """``shared_exec`` is not taken as an input shape: it names the
    executor whose arrays of the same name and shape the new one binds
    onto (the buckets of a BucketingModule), and the others are new."""
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2)
    other = net.simple_bind(mt.cpu(), data=(2, 3))
    for bind in (net.simple_bind, lambda *a, **k: mt.executor.Executor
                 .simple_bind(net, *a, **k)):
        ex = bind(mt.cpu(), shared_exec=other, data=(4, 3))
        assert "shared_exec" not in ex.arg_dict
        for n in net.list_arguments()[1:]:      # the weight and the bias
            assert ex.arg_dict[n] is other.arg_dict[n]
            assert ex.grad_dict[n] is other.grad_dict[n]
        assert ex.arg_dict["data"].shape == (4, 3)
        assert ex.arg_dict["data"] is not other.arg_dict["data"]


# ------------------------------------------------------------------ Dropout
def test_dropout_inference_is_identity_like_mxnet_tpu(jx):
    """Outside training Dropout returns its input, imperatively and in a
    graph loaded from the JAX package's JSON."""
    _, mx = jx
    x = np.random.RandomState(5).randn(6, 8).astype(np.float32)
    want = mx.nd.Dropout(mx.nd.array(x), p=0.4).asnumpy()
    got = mt.nd.Dropout(mt.nd.array(x, ctx=mt.cpu()), p=0.4).asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)
    jnet = mx.sym.Dropout(mx.sym.Variable("data"), p=0.4, name="drop")
    pnet = mt.sym.load_json(jnet.tojson())
    ex = pnet.bind(mt.cpu(), {"data": mt.nd.array(x, ctx=mt.cpu())})
    np.testing.assert_array_equal(ex.forward(is_train=False)[0].asnumpy(), x)


@pytest.mark.parametrize("p", [0.3, 0.5])
def test_dropout_training_statistics(p):
    """In training each element is kept with probability 1 - p (the kept
    share within 5 standard deviations over 2^18 draws) and scaled by
    1 / (1 - p); the gradient is the same mask and scale; two draws from
    the generator differ; the graph walk draws from the bound device's
    generator."""
    n = 1 << 18
    keep = 1.0 - p
    x = torch.ones(n, dtype=torch.float32, requires_grad=True)
    (y,), _ = mt.ops.registry.imperative_invoke("Dropout", [x], {"p": p},
                                                is_train=True)
    kept = y != 0
    share = kept.double().mean().item()
    assert abs(share - keep) < 5 * (keep * p / n) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / keep))
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(gx, y.detach())
    (y2,), _ = mt.ops.registry.imperative_invoke("Dropout", [x.detach()],
                                                 {"p": p}, is_train=True)
    assert not torch.equal(y2 != 0, kept)
    net = mt.sym.Dropout(mt.sym.Variable("data"), p=p)
    ex = net.bind(mt.cpu(), {"data": mt.nd.ones((n,), ctx=mt.cpu())})
    mt.random.seed(11)
    a = ex.forward(is_train=True)[0].asnumpy()
    mt.random.seed(11)
    b = ex.forward(is_train=True)[0].asnumpy()
    np.testing.assert_array_equal(a, b)
    assert abs((a != 0).mean() - keep) < 5 * (keep * p / n) ** 0.5
    np.testing.assert_allclose(a[a != 0], 1.0 / keep, rtol=1e-7)


# -------------------------------------------------------- the bench script
def _bench_at_toy_size(monkeypatch, argv):
    """``resnet50_train.main(argv)`` with ``bench_resnet50_train`` cut to
    toy size (ResNet-18, 32x32, batch 2, chunk 1, 1 round, on the CPU):
    returns (what main passed on, the one JSON record printed)."""
    full = resnet50_train.bench_resnet50_train
    seen = {}

    def at_toy_size(ctx=None, policy=None, dtype=None):
        seen.update(ctx=ctx, policy=policy, dtype=dtype)
        seen["img_per_sec"] = full(batch=2, image=32, chunk=1, rounds=1,
                                   num_layers=18, num_classes=10,
                                   ctx=mt.cpu(), policy=policy, dtype=dtype)
        return seen["img_per_sec"]
    monkeypatch.setattr(resnet50_train, "bench_resnet50_train", at_toy_size)
    return seen, argv


def _bench_record(capsys, seen):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert seen["ctx"] == mt.gpu(0)
    assert rec == resnet50_train.record(seen["img_per_sec"], rec["config"])
    assert rec["unit"] == "img/s" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 181.53, 3)
    return rec


def test_bench_script_runs_at_toy_size(capsys, monkeypatch):
    """``resnet50_train.main`` with no arguments, at toy size: bench.py's
    default, the bfloat16 policy with dynamic loss scaling, under
    bench.py's metric name; MXNET_AMP=0 gives the pure bfloat16 cast under
    the same name."""
    monkeypatch.delenv("MXNET_AMP", raising=False)
    monkeypatch.delenv("MXNET_LOSS_SCALE", raising=False)
    seen, argv = _bench_at_toy_size(monkeypatch, [])
    assert resnet50_train.main(argv) == 0
    rec = _bench_record(capsys, seen)
    assert rec["metric"] == "resnet50_train_img_per_sec_b32"
    assert seen["policy"].compute_dtype == "bfloat16" and \
        seen["policy"].dynamic and seen["dtype"] is None
    assert rec["config"] == dict(batch=32, image=224, chunk=40, rounds=10,
                                 num_layers=50, num_classes=1000,
                                 dtype="bfloat16",
                                 amp="bfloat16/dyn-scale-32768",
                                 device="gpu(0)")
    monkeypatch.setenv("MXNET_AMP", "0")
    assert resnet50_train.main(argv) == 0
    rec = _bench_record(capsys, seen)
    assert rec["metric"] == "resnet50_train_img_per_sec_b32"
    assert seen["policy"] is None and seen["dtype"] == "bfloat16"
    assert rec["config"]["amp"] is None


def test_bench_script_float32_at_toy_size(capsys, monkeypatch):
    """``--dtype float32`` at toy size: the float32 run under its own
    metric, with no policy even where MXNET_AMP asks for one."""
    monkeypatch.setenv("MXNET_AMP", "1")
    seen, argv = _bench_at_toy_size(monkeypatch, ["--dtype", "float32"])
    assert resnet50_train.main(argv) == 0
    rec = _bench_record(capsys, seen)
    assert rec["metric"] == "resnet50_train_img_per_sec_b32_f32"
    assert seen["policy"] is None and seen["dtype"] is None
    assert rec["config"] == dict(batch=32, image=224, chunk=40, rounds=10,
                                 num_layers=50, num_classes=1000,
                                 dtype="float32", amp=None, device="gpu(0)")


# ----------------------------------------------------------------- the card
def _port_step(sym, state, ctx, dtype):
    """One step of the port's TrainStep with SGD-momentum and no weight
    decay from ``state`` at ``dtype`` on ``ctx``: ({name: first momentum,
    which is -lr * rescale_grad * the gradient}, {name: moving statistic})
    as float64 CPU tensors."""
    params, opt_state, aux, batch = state
    ts = mt.TrainStep(sym, mt.optimizer.SGD(**dict(SGD, wd=0.0)), ctx=ctx)
    pp, ps, pa = mt.convert.train_state_from_numpy(
        {n: v.astype(dtype) for n, v in params.items()},
        {n: tuple(x.astype(dtype) for x in st)
         for n, st in opt_state.items()},
        {n: v.astype(dtype) for n, v in aux.items()}, ctx=ctx)
    pp, ps, pa, _ = ts(pp, ps, pa, ts.shard_batch(
        {k: v.astype(dtype) for k, v in batch.items()}))
    return ({n: st[0].double().cpu() for n, st in ps.items()},
            {n: v.double().cpu() for n, v in pa.items()})


def _nudged(state, seed):
    """``state`` with each float value times 1 + u * FLOOR_NUDGE, u uniform
    in [-1, 1]."""
    rng = np.random.default_rng(seed)

    def nudge(v):
        return v * (1 + FLOOR_NUDGE * rng.uniform(-1, 1, np.shape(v)))
    params, opt_state, aux, batch = state
    return ({n: nudge(v) for n, v in params.items()},
            {n: tuple(nudge(x) for x in st) for n, st in opt_state.items()},
            {n: nudge(v) for n, v in aux.items()},
            {"data": nudge(batch["data"]),
             "softmax_label": batch["softmax_label"]})


def _dists(got, want):
    """{leaf: (max |d| / max |w|, ||d|| / ||w||)} over the gradients and
    the moving statistics."""
    out = {}
    for kind, g, w in zip(("grad", "aux"), got, want):
        for n, ref in w.items():
            assert torch.isfinite(g[n]).all(), n
            d = g[n] - ref
            out[kind, n] = (
                (d.abs().max() / ref.abs().max().clamp_min(1e-300)).item(),
                (d.norm() / ref.norm().clamp_min(1e-300)).item())
    return out


@pytest.mark.cuda
def test_float32_step_on_card_matches_float64_cpu_step():
    """ResNet-50 (3x32x32, batch 4): one float32 step on the card, TF32
    off, against the same step in float64 on the CPU: every gradient and
    moving statistic, by max |d| / max |g| and ||d|| / ||g||, within
    FLOOR_FACTOR times its own float32 floor (the float32 step on the CPU
    against float64, the largest over the state and its nudges) or
    FLOOR_MIN.  At 32x32, stage 4's BatchNorms normalise 4
    values a channel, so some floors are large (~0.1 and ~0.04 on the
    CPU); a fault in the card path moves a leaf by far more than 4x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sym = _resnet("torch", 10, 50, 32)
    state = _state(sym, 4, 32, 10)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = _port_step(sym, state, mt.gpu(0), np.float32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    want = _port_step(sym, state, mt.cpu(), np.float64)
    samples = [_dists(_port_step(
        sym, _nudged(state, 100 + i) if i else state, mt.cpu(),
        np.float32), want) for i in range(FLOOR_SAMPLES)]
    over = []
    for leaf, got in _dists(card, want).items():
        floor = [max(s[leaf][m] for s in samples) for m in (0, 1)]
        if any(g > FLOOR_FACTOR * max(f, FLOOR_MIN)
               for g, f in zip(got, floor)):
            over.append((leaf, got, floor))
    assert not over, over
