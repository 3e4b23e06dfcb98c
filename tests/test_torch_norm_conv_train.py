"""mxnet_tpu_torch NormConv in training, on the CPU: the ``NormConv`` autograd
Function against mxnet_tpu's ``_nc_core`` (its Pallas kernel in interpret
mode under ``jax.grad``, float32) and against ``norm_conv_ref`` under
``jax.grad`` (float64), ``gradcheck``, the gate at a tie against
``_nc_core_bwd``; ``_apply``'s ReLU at a tie against ``jax.grad``; and
ResNet training through the fused graph (``MXNET_NORM_CONV=1``): one
float64 ``TrainStep`` step against the JAX package's fused step and the
port's unfused one, the symbolic path, and a training forward after an
inference forward on one executor.  The card's half (the kernel with its
statistics at training shapes, the float32 step) is in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import _Lowered
from mxnet_tpu_torch.ops import norm_conv as pnc
from test_torch_resnet_train import SGD, _resnet, _state
from test_torch_threads import torch_threads_per_worker  # noqa: F401

GEOMS = [
    # H, K, S, P, Cin, Cout, relu, prologue, stats (test_norm_conv.GEOMS)
    (8, 3, 1, 1, 16, 32, True, True, True),
    (8, 3, 2, 1, 16, 32, True, True, False),
    (8, 1, 1, 0, 16, 32, False, False, True),
    (9, 1, 2, 0, 16, 24, True, True, True),
    (7, 3, 2, 1, 16, 16, True, True, True),
    # 3x3 with pad 0, odd H, stride 1 and 2 (Inception-v3's conv_1, conv_4
    # and its stride-2 reductions)
    (9, 3, 1, 0, 32, 32, True, True, True),
    (11, 3, 2, 0, 16, 24, True, True, True),
]
IDS = ["h%dk%ds%dp%d-r%dp%ds%d" % (g[:4] + tuple(map(int, g[6:])))
       for g in GEOMS]
# test_norm_conv.py's tolerance of the interpret-mode kernel's gradients
# against the XLA composition's, float32
F32_RTOL, F32_ATOL = 3e-4, 3e-3
F64_TOL = 1e-9
# simple_bind infers float32 moving statistics in both packages: one
# float32 rounding of the same float64 statistics (test_torch_resnet_train)
F32_ROUNDING = 2.0 ** -23


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, mxnet_tpu's pallas_conv)."""
    return (pytest.importorskip("jax"), pytest.importorskip("jax.numpy"),
            pytest.importorskip("mxnet_tpu.ops.pallas_conv"))


class _X64(object):
    """JAX's 64-bit mode for the body of a ``with``."""

    def __init__(self, jax):
        self.jax = jax

    def __enter__(self):
        self.jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        self.jax.config.update("jax_enable_x64", False)


def _close(got, want, what, rtol=F64_TOL, atol=F64_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------- the Function alone
def _inputs(geom, dtype):
    h, k, s, p, cin, cout = geom[:6]
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, h, cin).astype(dtype)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(dtype)
    sc = (rng.rand(cin) + 0.5).astype(dtype)
    sh = rng.randn(cin).astype(dtype)
    return x, w, sc, sh


def _loss(y, ysum, ysq):
    """test_norm_conv.py's loss: sum y^2 + 1.7 sum(sum y) + 0.3 sum(sum
    y^2), so each statistic's cotangent reaches the backward."""
    out = (y * y).sum()
    if ysum is not None:
        out = out + (ysum * 1.7).sum() + (ysq * 0.3).sum()
    return out


def _port_grads(geom, arrays):
    """Gradients of _loss through the Function, w given and returned HWIO
    (the Function takes the logical (O, I, k, k) weight)."""
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    x, w, sc, sh = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = pnc.NormConv.apply(x, w.permute(3, 2, 0, 1), sc, sh, k, s, p,
                             relu, prologue, stats)
    y, ysum, ysq = out if stats else (out, None, None)
    before = pnc.launches
    grads = torch.autograd.grad(_loss(y, ysum, ysq), [x, w, sc, sh],
                                allow_unused=True)
    assert pnc.launches == before            # the backward is no kernel
    return [np.zeros(a.shape, a.dtype) if g is None else g.numpy()
            for g, a in zip(grads, arrays)]


def _jax_grads(jx, geom, arrays, use_pallas):
    jax, jnp, jnc = jx
    h, k, s, p, cin, cout, relu, prologue, stats = geom

    def loss(x, w, sc, sh):
        y, su, sq = jnc.norm_conv(x, w, sc, sh, kernel=k, stride=s, pad=p,
                                  relu=relu, prologue=prologue, stats=stats,
                                  use_pallas=use_pallas,
                                  interpret=use_pallas)
        return _loss(y, su, sq)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in arrays])]


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_function_grads_vs_pallas_interpret_f32(geom, jx):
    """float32: the Function's gradients of x, w, scale and shift equal
    ``jax.grad`` through ``_nc_core`` (the Pallas kernel in interpret mode
    and its custom VJP) within test_norm_conv.py's tolerance."""
    arrays = _inputs(geom, np.float32)
    want = _jax_grads(jx, geom, arrays, True)
    got = _port_grads(geom, arrays)
    for name, g, j in zip(("x", "w", "scale", "shift"), got, want):
        assert g.dtype == np.float32
        _close(g, j, "d" + name, F32_RTOL, F32_ATOL)


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_function_grads_vs_reference_f64(geom, jx):
    """float64, away from ties: the Function's gradients equal ``jax.grad``
    of mxnet_tpu's XLA composition ``norm_conv_ref`` within 1e-9."""
    arrays = _inputs(geom, np.float64)
    with _X64(jx[0]):
        want = _jax_grads(jx, geom, arrays, False)
    got = _port_grads(geom, arrays)
    for name, g, j in zip(("x", "w", "scale", "shift"), got, want):
        assert g.dtype == np.float64
        _close(g, j, "d" + name)


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_function_gradcheck(geom):
    """Finite differences of y and both statistics through the Function in
    float64 (small channel counts)."""
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, min(h, 6), min(h, 6), 3, generator=gen,
                    dtype=torch.float64)
    w = torch.randn(4, 3, k, k, generator=gen, dtype=torch.float64) * 0.3
    sc = torch.rand(3, generator=gen, dtype=torch.float64) + 0.5
    sh = torch.randn(3, generator=gen, dtype=torch.float64) * 0.5
    args = tuple(t.requires_grad_(True) for t in (x, w, sc, sh))
    assert torch.autograd.gradcheck(
        lambda *a: pnc.NormConv.apply(*a, k, s, p, relu, prologue, stats),
        args)


def _tie_inputs(seed=2):
    """x in multiples of 1/8, scale 0.5 and shift -0.25: pre = x/2 - 1/4 is
    exactly 0 wherever x = 0.5."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-8, 9, (2, 5, 5, 3)) / 8.0
    x[:, 1:3, 1:3, :] = 0.5
    return x, np.full(3, 0.5), np.full(3, -0.25)


def test_function_gate_at_tie_matches_nc_core_bwd(jx):
    """Where the prologue's output is exactly 0, the Function's backward
    gates the gradient to 0 (``xh > 0``), as ``_nc_core_bwd`` does: every
    gradient, with the statistics' cotangents, equals it within 1e-9.
    (``_nc_core_bwd`` folds the cotangents in float32 even in float64; the
    Function in at least float32.  Every value here is a small multiple of
    1/8, so y and the fold are exact in both.)"""
    jax, jnp, jnc = jx
    x, sc, sh = _tie_inputs()
    rng = np.random.RandomState(3)
    w = rng.randint(-4, 5, (3, 3, 3, 4)) / 8.0             # HWIO
    tx, tw, tsc, tsh = [torch.from_numpy(a).requires_grad_(True)
                        for a in (x, w, sc, sh)]
    y, ysum, ysq = pnc.NormConv.apply(tx, tw.permute(3, 2, 0, 1), tsc, tsh,
                                      3, 1, 1, True, True, True)
    dy = rng.randint(-8, 9, y.shape) / 8.0
    dsum, dsq = rng.randint(-8, 9, 4) / 8.0, rng.randint(-8, 9, 4) / 8.0
    got = torch.autograd.grad(
        [y, ysum, ysq], [tx, tw, tsc, tsh],
        [torch.from_numpy(v) for v in (dy, dsum, dsq)])
    with _X64(jax):
        want = jnc._nc_core_bwd(
            (3, 1, 1, True, True, True, False),
            tuple(jnp.asarray(v) for v in (x, w, sc, sh,
                                           y.detach().numpy())),
            tuple(jnp.asarray(v) for v in (dy, dsum, dsq)))
        want = [np.asarray(v) for v in want]
    ties = x == 0.5
    assert ties.sum() >= 24
    assert (got[0].numpy()[ties] == 0).all()
    for name, g, j in zip(("x", "w", "scale", "shift"), got, want):
        _close(g.numpy(), j, "d" + name)


def test_apply_relu_tie_matches_jax(jx):
    """``_apply``'s ReLU is ``jnp.maximum(out, 0)``: at pre exactly 0 the
    gradient is 0.5, as ``jax.grad`` of the JAX package's ``_apply`` gives
    (``torch.relu`` would give 0)."""
    jax, jnp, jnc = jx
    x, sc, sh = _tie_inputs()
    wts = np.random.RandomState(4).randn(*x.shape)
    tx, tsc, tsh = [torch.from_numpy(a).requires_grad_(True)
                    for a in (x, sc, sh)]
    out = pnc._apply(tx, tsc, tsh, True)
    got = torch.autograd.grad((out * torch.from_numpy(wts)).sum(),
                              [tx, tsc, tsh])
    with _X64(jax):
        want = jax.grad(lambda a, b, c: jnp.sum(jnc._apply(a, b, c, True)
                                                * wts), argnums=(0, 1, 2))(
            *[jnp.asarray(v) for v in (x, sc, sh)])
        want = [np.asarray(v) for v in want]
    ties = x == 0.5
    np.testing.assert_array_equal(got[0].numpy()[ties], 0.25 * wts[ties])
    for name, g, j in zip(("x", "scale", "shift"), got, want):
        _close(g.numpy(), j, "d" + name)


# ---------------------------------------------------- the graph in training
@pytest.fixture(scope="module")
def jax_fused_step():
    """The JAX package's float64 ResNet-50 step (3x32x32, 10 classes, batch
    4) with MXNET_NORM_CONV=1, once for the module: (its JSON, the state,
    (params, momenta, aux, outputs) as numpy)."""
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    from mxnet_tpu.train import TrainStep as JTrainStep
    jsym = _resnet("jax", 10, 50, 32)
    state = _state(_resnet("torch", 10, 50, 32), 4, 32, 10)
    params, opt_state, aux, batch = state
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_NORM_CONV", "1")
    try:
        with _X64(jax):
            jts = JTrainStep(jsym, mx.optimizer.SGD(**SGD))
            asj = jax.numpy.asarray
            jp, js, ja, jouts = jts(
                {n: asj(v) for n, v in params.items()},
                {n: tuple(asj(x) for x in st)
                 for n, st in opt_state.items()},
                {n: asj(v) for n, v in aux.items()}, jts.shard_batch(batch))
            got = ({n: np.asarray(v) for n, v in jp.items()},
                   {n: np.asarray(st[0]) for n, st in js.items()},
                   {n: np.asarray(v) for n, v in ja.items()},
                   np.asarray(jouts[0]))
    finally:
        mp.undo()
    return jsym.tojson(), state, got


def _count_norm_conv(monkeypatch):
    """Record the ``stats`` flag of every NormConv forward."""
    calls = []
    real = pnc.norm_conv

    def counted(*a, **k):
        calls.append(bool(a[9] if len(a) > 9 else k.get("stats", False)))
        return real(*a, **k)
    monkeypatch.setattr(pnc, "norm_conv", counted)
    return calls


def _port_step(sym_json, state, norm_conv, monkeypatch):
    monkeypatch.setenv("MXNET_NORM_CONV", norm_conv)
    params, opt_state, aux, batch = state
    ts = mt.TrainStep(mt.sym.load_json(sym_json), mt.optimizer.SGD(**SGD),
                      ctx=mt.cpu())
    pp, ps, pa = mt.convert.train_state_from_numpy(params, opt_state, aux,
                                                   ctx=mt.cpu())
    pp, ps, pa, outs = ts(pp, ps, pa, ts.shard_batch(batch))
    return pp, {n: st[0] for n, st in ps.items()}, pa, outs[0]


def test_resnet50_fused_train_step_matches_mxnet_tpu(jax_fused_step,
                                                     monkeypatch):
    """ResNet-50 (3x32x32, batch 4), one float64 SGD-momentum step with
    MXNET_NORM_CONV=1: every parameter, momentum, moving statistic and
    output equals the JAX package's fused step and the port's unfused step
    within 1e-9.  The step runs 53 NormConv forwards (16 units x 3, 4
    shortcuts and the 3x3 stem conv0, whose bn_data NormConv takes from
    the stem peephole), 33 of them with the statistics that feed a
    BatchNorm (each unit's bn2 and bn3, and bn0 after conv0)."""
    sym_json, state, (jp, jm, ja, jout) = jax_fused_step
    calls = _count_norm_conv(monkeypatch)
    fused = _port_step(sym_json, state, "1", monkeypatch)
    assert len(calls) == 53 and sum(calls) == 33
    del calls[:]
    plain = _port_step(sym_json, state, "0", monkeypatch)
    assert not calls
    for want, what in ((jax_fused_step[2], "mxnet_tpu"),
                       (tuple(_np(v) for v in plain), "unfused")):
        wp, wm, wa, wout = want
        assert sorted(fused[0]) == sorted(wp) and sorted(fused[2]) == \
            sorted(wa)
        for n in wp:
            _close(fused[0][n], wp[n], "%s vs %s" % (n, what))
            _close(fused[1][n], wm[n], "%s momentum vs %s" % (n, what))
        for n in wa:
            _close(fused[2][n], wa[n], "%s vs %s" % (n, what))
        _close(fused[3], wout, "outputs vs %s" % what)
    for n, v in state[2].items():              # every statistic moved
        assert not np.array_equal(fused[2][n].numpy(), v), n


def _np(v):
    if isinstance(v, dict):
        return {n: t.numpy() for n, t in v.items()}
    return v.numpy()


def _simple_bind(pkg, sym, params, aux, batch, is_train=True):
    """simple_bind at float64 with gradients of the parameters only,
    copy_params_from, then forward(is_train) (and backward() in
    training)."""
    names = sym.list_arguments()
    ex = sym.simple_bind(pkg.cpu(), type_dict={n: np.float64 for n in names},
                         grad_req={n: "null" if n in batch else "write"
                                   for n in names},
                         **{k: v.shape for k, v in batch.items()})
    ex.copy_params_from({n: pkg.nd.array(v, ctx=pkg.cpu(), dtype=np.float64)
                         for n, v in params.items()}, aux)
    ex.forward(is_train=is_train, **{k: pkg.nd.array(v, ctx=pkg.cpu(),
                                                     dtype=np.float64)
                                     for k, v in batch.items()})
    if is_train:
        ex.backward()
    return ex


def test_simple_bind_fused_training_matches_mxnet_tpu(monkeypatch):
    """ResNet-18 (3x32x32, batch 4) with MXNET_NORM_CONV=1 through
    simple_bind -> forward(is_train=True) -> backward(): every gradient,
    moving statistic and output equals the JAX package's fused executor's
    and the port's unfused executor's within 1e-9 (the moving statistics,
    float32 in both, within one float32 rounding)."""
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    jsym = _resnet("jax", 10, 18, 32)
    psym = mt.sym.load_json(jsym.tojson())
    params, _, aux, batch = _state(psym, 4, 32, 10, seed=3)
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    with _X64(jax):
        jex = _simple_bind(mx, jsym, params, aux, batch)
        want = ({n: g.asnumpy() for n, g in jex.grad_dict.items()},
                [a.asnumpy() for a in jex.aux_arrays],
                jex.outputs[0].asnumpy())
    pex = _simple_bind(mt, psym, params, aux, batch)
    monkeypatch.setenv("MXNET_NORM_CONV", "0")
    plain = _simple_bind(mt, psym, params, aux, batch)
    assert sorted(pex.grad_dict) == sorted(want[0]) == sorted(params)
    for n, g in want[0].items():
        _close(pex.grad_dict[n].asnumpy(), g, "grad %s vs mxnet_tpu" % n)
        _close(pex.grad_dict[n].asnumpy(), plain.grad_dict[n].asnumpy(),
               "grad %s vs unfused" % n)
    for p, q, j, n in zip(pex.aux_arrays, plain.aux_arrays, want[1],
                          pex.aux_names):
        assert p.dtype == np.float32
        _close(p.asnumpy(), j, n, F32_ROUNDING, F32_ROUNDING)
        _close(p.asnumpy(), q.asnumpy(), n, F32_ROUNDING, F32_ROUNDING)
    _close(pex.outputs[0].asnumpy(), want[2], "outputs")


def test_training_after_inference_forward_keeps_weight_grads(monkeypatch):
    """One executor with MXNET_NORM_CONV=1: an inference forward (which
    caches each weight's HWIO copy for the kernel), then forward(is_train=
    True) + backward(): every weight's gradient equals the unfused
    executor's within 1e-9 (a training forward that read the inference
    copy would lose the weights' gradients)."""
    psym = _resnet("torch", 10, 18, 32)
    params, _, aux, batch = _state(psym, 4, 32, 10, seed=5)
    monkeypatch.setenv("MXNET_NORM_CONV", "0")
    plain = _simple_bind(mt, psym, params, aux, batch)
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    pex = _simple_bind(mt, psym, params, aux, batch, is_train=False)
    w = pex.arg_dict["stage1_unit1_conv2_weight"].value
    assert getattr(w, "_nc_hwio", None) is not None
    pex.forward(is_train=True)
    pex.backward()
    for n, g in plain.grad_dict.items():
        assert np.abs(g.asnumpy()).max() > 0 or n.endswith("_gamma"), n
        _close(pex.grad_dict[n].asnumpy(), g.asnumpy(), "grad " + n)


def test_resnet50_224_fused_graph_counts():
    """ResNet-50 at 3x224x224: the NormConv peephole fuses 52 convolutions
    (16 units x 3 and 4 shortcuts), 32 of which emit the statistics of a
    BatchNorm (each unit's bn2 and bn3); the 7x7 stem conv0 is not one of
    them and takes the stem peephole instead."""
    low = _Lowered(_resnet("torch", 1000, 50, 224))
    assert len(low.nc_conv) == 52
    assert sorted(len(v) for v in low.nc_stats_for.values()) == [1] * 32
    names = sorted(b.name for b_id in low.nc_stats_src
                   for b in [low.nc_bn[b_id]["bn"]])
    assert len(names) == 32 and all(n.endswith(("_bn2", "_bn3"))
                                    for n in names)
    (stem,) = low.stem_fuse.values()
    assert stem["conv"].name == "conv0" and stem["var"] == "data"
    assert id(stem["conv"]) not in low.nc_conv


def test_bench_script_fused_metric_at_toy_size(capsys, monkeypatch):
    """``resnet50_train.main`` under MXNET_NORM_CONV=1 at toy size (ResNet-18,
    32x32, batch 2, chunk 1, 1 round, on the CPU): every step runs the
    fused graph's NormConv forwards, with statistics where a BatchNorm reads
    them, and the record carries the fused metric's own name (float32 with
    ``--dtype float32``, bench.py's bfloat16 policy by default), with the
    unfused run's config."""
    import json
    from mxnet_tpu_torch.bench import resnet50_train
    full = resnet50_train.bench_resnet50_train
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    calls = _count_norm_conv(monkeypatch)
    seen = {}

    def at_toy_size(ctx=None, policy=None, dtype=None):
        seen["img_per_sec"] = full(batch=2, image=32, chunk=1, rounds=1,
                                   num_layers=18, num_classes=10,
                                   ctx=mt.cpu(), policy=policy, dtype=dtype)
        return seen["img_per_sec"]
    monkeypatch.setattr(resnet50_train, "bench_resnet50_train", at_toy_size)
    assert resnet50_train.main(["--dtype", "float32"]) == 0
    low = _Lowered(_resnet("torch", 10, 18, 32))
    steps = 2 * (1 + 1)              # a warm and a timed run_steps(1)
    assert len(calls) == steps * len(low.nc_conv)
    assert sum(calls) == steps * len(low.nc_stats_for) > 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "resnet50_train_img_per_sec_b32_f32_normconv"
    assert rec == resnet50_train.record(seen["img_per_sec"], rec["config"],
                                        fused=True)
    assert rec["config"]["num_layers"] == 50 and rec["value"] > 0
    # the default, bench.py's bfloat16 policy, under its fused name
    del calls[:]
    assert resnet50_train.main([]) == 0
    assert len(calls) == steps * len(low.nc_conv)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "resnet50_train_img_per_sec_b32_normconv"
    assert rec["config"]["amp"] == "bfloat16/dyn-scale-32768"


# ----------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_function_on_card_matches_cpu(geom):
    """float32 on the card (the kernel's forward with its statistics,
    cuDNN's backward, TF32 off) against the Function in float64 on the
    CPU: y, both statistics and every gradient within test_norm_conv.py's
    float32 tolerance; one launch, in the forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    arrays = _inputs(geom, np.float64)

    def run(dev, dtype):
        x, w, sc, sh = [torch.from_numpy(a).to(dev, dtype)
                        .requires_grad_(True) for a in arrays]
        out = pnc.NormConv.apply(x, w.permute(3, 2, 0, 1), sc, sh, k, s, p,
                                 relu, prologue, stats)
        y, ysum, ysq = out if stats else (out, None, None)
        grads = torch.autograd.grad(_loss(y, ysum, ysq), [x, w, sc, sh],
                                    allow_unused=True)
        return [None if v is None else v.detach().double().cpu()
                for v in (y, ysum, ysq) + grads]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = pnc.launches
        got = run(torch.device("cuda", 0), torch.float32)
        assert pnc.launches == before + 1
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = run(torch.device("cpu"), torch.float64)
    for name, g, w in zip(("y", "sum", "sumsq", "dx", "dw", "dscale",
                           "dshift"), got, want):
        if w is None:
            assert g is None, name
            continue
        _close(g, w, name, F32_RTOL, F32_ATOL)


@pytest.mark.cuda
def test_fused_float32_step_on_card_matches_float64_cpu_step():
    """ResNet-50 (3x32x32, batch 4) with MXNET_NORM_CONV=1: one float32
    step on the card (53 kernel launches, 33 with statistics; TF32 off)
    against the fused float64 step on the CPU, every gradient and moving
    statistic within test_torch_resnet_train's FLOOR_FACTOR times its own
    float32 floor, sampled on the fused graph on the CPU (the state and
    three nudges of it by up to 2^-18), or of 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    floor_factor, samples, nudge, floor_min = 4.0, 4, 2.0 ** -18, 1e-6
    sym = _resnet("torch", 10, 50, 32)
    state = _state(sym, 4, 32, 10)
    prev_env = os.environ.get("MXNET_NORM_CONV")
    prev = torch.backends.cudnn.allow_tf32
    os.environ["MXNET_NORM_CONV"] = "1"
    torch.backends.cudnn.allow_tf32 = False

    def step(st, ctx, dtype):
        params, opt_state, aux, batch = st
        ts = mt.TrainStep(sym, mt.optimizer.SGD(**dict(SGD, wd=0.0)),
                          ctx=ctx)
        pp, ps, pa = mt.convert.train_state_from_numpy(
            {n: v.astype(dtype) for n, v in params.items()},
            {n: tuple(x.astype(dtype) for x in v)
             for n, v in opt_state.items()},
            {n: v.astype(dtype) for n, v in aux.items()}, ctx=ctx)
        ts(pp, ps, pa, ts.shard_batch({n: v.astype(dtype)
                                       for n, v in batch.items()}))
        return {**{("grad", n): v[0].double().cpu() for n, v in ps.items()},
                **{("aux", n): v.double().cpu() for n, v in pa.items()}}

    def nudged(i):
        rng = np.random.default_rng(100 + i)
        params, opt_state, aux, batch = state
        f = (lambda v: v * (1 + nudge * rng.uniform(-1, 1, np.shape(v))))
        return ({n: f(v) for n, v in params.items()},
                {n: tuple(f(x) for x in v) for n, v in opt_state.items()},
                {n: f(v) for n, v in aux.items()},
                dict(batch, data=f(batch["data"])))

    def dist(a, b):
        d = a - b
        return ((d.abs().max() / b.abs().max().clamp_min(1e-300)).item(),
                (d.norm() / b.norm().clamp_min(1e-300)).item())
    try:
        before = (pnc.launches, pnc.stats_launches)
        card = step(state, mt.gpu(0), np.float32)
        assert (pnc.launches - before[0],
                pnc.stats_launches - before[1]) == (53, 33)
        want = step(state, mt.cpu(), np.float64)
        floors = [step(nudged(i) if i else state, mt.cpu(), np.float32)
                  for i in range(samples)]
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        if prev_env is None:
            del os.environ["MXNET_NORM_CONV"]
        else:
            os.environ["MXNET_NORM_CONV"] = prev_env
    over = []
    for leaf, ref in want.items():
        assert torch.isfinite(card[leaf]).all(), leaf
        got = dist(card[leaf], ref)
        floor = [max(dist(f[leaf], ref)[m] for f in floors) for m in (0, 1)]
        if any(g > floor_factor * max(f, floor_min)
               for g, f in zip(got, floor)):
            over.append((leaf, got, floor))
    assert not over, over
