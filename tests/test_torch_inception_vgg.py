"""The model symbols ``models/inception_v3.py`` and ``models/vgg.py`` and
the training twin ``bench/train_imagenet.py`` in the port against
mxnet_tpu, on the CPU.

- At full width, symbol level only (no computation): Inception-v3 (1000
  classes, 3x299x299, 23,834,568 parameters) and VGG-16 (224x224, with and
  without BatchNorm): the same arguments, aux states, shapes and JSON; and
  the NormConv peephole's reading of Inception-v3's graph: 15 of its 94
  convolutions in 9 geometries, 5 of them with the statistics epilogue.
- One float64 SGD-momentum ``TrainStep`` of narrow Inception blocks (a
  3x3 pad-0 stem, then 7A, 7B, 7C, 7D and 7E at widths of 4-12, 21x21
  input, 10 classes, batch 2) from one state carried across as numpy,
  with ``MXNET_NORM_CONV`` 0 and 1 in both packages: every parameter,
  momentum, moving statistic and output within 1e-9; with the knob on the
  port runs NormConv (its plain version, on the CPU) at each convolution
  the graph reading names, pad 0 at stride 1 and 2 among them.
- One float64 step of VGG-11 at 32x32 (10 classes, batch 2), Dropout masks
  injected into both packages, within 1e-9.
- ``train_imagenet``'s networks, its refusal of ``--data-train`` (the
  image slice) and a toy run of each path."""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench import train_imagenet as ti
from mxnet_tpu_torch.executor import _Lowered
from mxnet_tpu_torch.ops import norm_conv as pnc
from test_torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-9
SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4, rescale_grad=0.5)


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.models  # noqa: F401
    return mx


class _X64(object):
    """JAX's 64-bit mode for the body of a ``with``."""

    def __enter__(self):
        import jax
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax
        jax.config.update("jax_enable_x64", False)


def _sym(pkg, family, **kw):
    with pkg.name.NameManager():
        return getattr(pkg.models, family).get_symbol(**kw)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= REL * scale, \
        "%s: max |d| %.3g > %g x %.3g" % (what, err, REL, scale)


# ------------------------------------------------------------- full width
@pytest.mark.parametrize("family,kw,shape,n_params", [
    ("inception_v3", {}, (32, 3, 299, 299), 23834568),
    ("vgg", {}, (32, 3, 224, 224), 138357544),
    ("vgg", {"batch_norm": True, "num_layers": 11}, (32, 3, 224, 224),
     132868840)], ids=["inception-v3", "vgg16", "vgg11-bn"])
def test_full_width_graph_matches_mxnet_tpu(mx, family, kw, shape,
                                            n_params):
    j = _sym(mx, family, num_classes=1000, **kw)
    p = _sym(mt, family, num_classes=1000, **kw)
    assert p.tojson() == j.tojson()
    assert p.list_arguments() == j.list_arguments()
    assert p.list_auxiliary_states() == j.list_auxiliary_states()
    assert p.list_outputs() == j.list_outputs()
    shapes = {"data": shape, "softmax_label": (shape[0],)}
    ja, jo, jx = j.infer_shape(**shapes)
    pa, po, px = p.infer_shape(**shapes)
    assert [tuple(s) for s in pa] == [tuple(s) for s in ja]
    assert [tuple(s) for s in px] == [tuple(s) for s in jx]
    assert [tuple(s) for s in po] == [tuple(s) for s in jo] == \
        [(shape[0], 1000)]
    n = sum(int(np.prod(s)) for name, s in zip(p.list_arguments(), pa)
            if name not in shapes)
    assert n == n_params
    assert mt.models.get_inception_v3 is mt.models.inception_v3.get_symbol
    assert mt.models.get_vgg is mt.models.vgg.get_symbol


def test_vgg_refuses_unknown_depth(mx):
    for pkg in (mt, mx):
        with pytest.raises(pkg.MXNetError, match="num_layers 12"):
            pkg.models.vgg.get_symbol(num_layers=12)


def nc_geometries(net, data_shape):
    """({(H, Cin, Cout, k, s, p): count} of the convolutions the NormConv
    peephole fuses, {the same: count with the statistics epilogue})."""
    low = _Lowered(net)
    internals = net.get_internals()
    _, shapes, _ = internals.infer_shape(data=data_shape)
    shape_of = {(id(n), i): s for (n, i), s in zip(internals._outputs,
                                                  shapes)}
    geoms, stats = {}, {}
    for node in low.order:
        if id(node) not in low.nc_conv:
            continue
        src, si = node.inputs[0]
        _, cin, h, _ = shape_of[(id(src), si)]
        g = low._nc_conv_attrs(node)
        key = (h, cin, int(node.params["num_filter"]), g["k"], g["s"],
               g["p"])
        geoms[key] = geoms.get(key, 0) + 1
        if id(node) in low.nc_stats_for:
            stats[key] = stats.get(key, 0) + 1
    return geoms, stats


def test_inception_v3_norm_conv_geometries():
    """The table chip_smoke.py's imagenet phase holds the kernel to: 15
    fused convolutions a forward in 9 geometries, 5 with statistics (the
    ones whose BatchNorm feeds another fused convolution)."""
    net = _sym(mt, "inception_v3", num_classes=1000)
    geoms, stats = nc_geometries(net, (32, 3, 299, 299))
    assert geoms == {(149, 32, 32, 3, 1, 0): 1, (147, 32, 64, 3, 1, 1): 1,
                     (73, 80, 192, 3, 1, 0): 1, (35, 64, 96, 3, 1, 1): 4,
                     (35, 96, 96, 3, 1, 1): 3, (35, 96, 96, 3, 2, 0): 1,
                     (17, 192, 320, 3, 2, 0): 1, (17, 192, 192, 3, 2, 0): 1,
                     (8, 448, 384, 3, 1, 1): 2}
    assert stats == {(149, 32, 32, 3, 1, 0): 1, (35, 64, 96, 3, 1, 1): 4}
    n_conv = sum(1 for n in net._nodes()
                 if not n.is_var and n.op.name == "Convolution")
    assert n_conv == 94


# ---------------------------------------------------- narrow blocks, f64
BLOCK_SHAPES = {"data": (2, 3, 21, 21), "softmax_label": (2,)}


def _blocks(pkg):
    """A 3x3 pad-0 stem and Inception7A-E at narrow widths (the JAX
    package's and the port's own block functions)."""
    iv3 = pkg.models.inception_v3
    S = pkg.sym
    with pkg.name.NameManager():
        x = S.Variable("data")
        x = iv3.Conv(x, 6, kernel=(3, 3), name="conv")          # 19
        x = iv3.Conv(x, 8, kernel=(3, 3), name="conv_1")        # 17
        x = iv3.Inception7A(x, 4, 4, 6, 6, 4, 6, "avg", 4, "mixed")
        x = iv3.Inception7B(x, 8, 4, 6, 6, "max", "mixed_3")    # 8
        x = iv3.Inception7C(x, 4, 4, 4, 6, 4, 4, 4, 4, 6, "avg", 6,
                            "mixed_4")
        x = iv3.Inception7D(x, 4, 6, 4, 4, 4, 6, "max", "mixed_8")  # 3
        x = iv3.Inception7E(x, 4, 6, 4, 4, 6, 6, 4, 4, "avg", 4, "mixed_9")
        x = S.Pooling(x, kernel=(3, 3), stride=(1, 1), pool_type="avg",
                      name="global_pool")
        x = S.FullyConnected(S.Flatten(x), num_hidden=10, name="fc1")
        return S.SoftmaxOutput(x, name="softmax")


def _block_state(net, seed=0):
    """He-scaled float64 weights, gamma/beta near 1/0, moving statistics,
    a zero momentum and a batch, from ``seed``."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = net.infer_shape(**BLOCK_SHAPES)
    params = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in BLOCK_SHAPES:
            continue
        if n.endswith("_gamma"):
            params[n] = 1 + 0.1 * rng.randn(*s)
        elif n.endswith("_beta") or n.endswith("_bias"):
            params[n] = 0.1 * rng.randn(*s)
        else:
            params[n] = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
    aux = {n: (rng.rand(*s) + 0.5 if n.endswith("_var")
               else 0.1 * rng.randn(*s))
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    mom = {n: (np.zeros_like(v),) for n, v in params.items()}
    batch = {"data": rng.randn(*BLOCK_SHAPES["data"]),
             "softmax_label": rng.randint(0, 10, 2).astype(np.float64)}
    return params, mom, aux, batch


@pytest.fixture(scope="module")
def jax_block_steps(mx):
    """The JAX package's float64 step of ``_blocks`` with MXNET_NORM_CONV 0
    and 1: {knob: (params, momenta, aux, outputs) as numpy}."""
    import jax.numpy as jnp
    from mxnet_tpu.train import TrainStep as JTrainStep
    state = _block_state(_blocks(mt))
    params, mom, aux, batch = state
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for knob in ("0", "1"):
            mp.setenv("MXNET_NORM_CONV", knob)
            with _X64():
                ts = JTrainStep(_blocks(mx), mx.optimizer.SGD(**SGD))
                jp, js, ja, outs = ts(
                    {n: jnp.asarray(v) for n, v in params.items()},
                    {n: tuple(jnp.asarray(x) for x in st)
                     for n, st in mom.items()},
                    {n: jnp.asarray(v) for n, v in aux.items()},
                    ts.shard_batch(batch))
                out[knob] = ({n: np.asarray(v) for n, v in jp.items()},
                             {n: np.asarray(st[0]) for n, st in js.items()},
                             {n: np.asarray(v) for n, v in ja.items()},
                             np.asarray(outs[0]))
    finally:
        mp.undo()
    return state, out


def _count_norm_conv(monkeypatch):
    """(pad, stride, stats) of every NormConv forward."""
    calls = []
    real = pnc.norm_conv

    def counted(*a, **k):
        calls.append((a[6], a[5], bool(a[9] if len(a) > 9
                                        else k.get("stats", False))))
        return real(*a, **k)
    monkeypatch.setattr(pnc, "norm_conv", counted)
    return calls


@pytest.mark.parametrize("knob", ["0", "1"])
def test_inception_blocks_step_matches_mxnet_tpu(jax_block_steps, knob,
                                                 monkeypatch):
    (params, mom, aux, batch), want = jax_block_steps
    net = _blocks(mt)
    geoms, stats = nc_geometries(net, BLOCK_SHAPES["data"])
    calls = _count_norm_conv(monkeypatch)
    monkeypatch.setenv("MXNET_NORM_CONV", knob)
    ts = mt.TrainStep(net, mt.optimizer.SGD(**SGD), ctx=mt.cpu())
    p, s, a = mt.convert.train_state_from_numpy(params, mom, aux,
                                                ctx=mt.cpu())
    p, s, a, outs = ts(p, s, a, ts.shard_batch(batch))
    if knob == "1":
        assert len(calls) == sum(geoms.values()) >= 10
        assert sum(c[2] for c in calls) == sum(stats.values()) >= 1
        assert {(c[0], c[1]) for c in calls} >= {(0, 1), (0, 2), (1, 1)}
    else:
        assert not calls
    wp, wm, wa, wout = want[knob]
    assert sorted(p) == sorted(wp) and sorted(a) == sorted(wa)
    for n in wp:
        _close(p[n].numpy(), wp[n], n)
        _close(s[n][0].numpy(), wm[n], n + " momentum")
    for n in wa:
        _close(a[n].numpy(), wa[n], n)
        assert not np.array_equal(a[n].numpy(), aux[n]), n
    _close(outs[0].numpy(), wout, "outputs")


# ------------------------------------------------------------ VGG-11, f64
def test_vgg11_step_matches_mxnet_tpu(mx, monkeypatch):
    """One float64 step of VGG-11 at 32x32 (the 5 pools reach 1x1 before
    the 4096-wide layers), Dropout masks injected in graph order: every
    parameter and the output within 1e-9."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import get_op as jget_op
    from mxnet_tpu.train import TrainStep as JTrainStep
    from mxnet_tpu_torch.ops import nn as pnn
    shapes = {"data": (2, 3, 32, 32), "softmax_label": (2,)}
    psym = _sym(mt, "vgg", num_classes=10, num_layers=11)
    rng = np.random.RandomState(5)
    arg_shapes, _, _ = psym.infer_shape(**shapes)
    params = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                  if len(s) > 1 else 0.05 * rng.randn(*s))
              for n, s in zip(psym.list_arguments(), arg_shapes)
              if n not in shapes}
    batch = {"data": rng.randn(*shapes["data"]),
             "softmax_label": rng.randint(0, 10, 2).astype(np.float64)}
    masks = [rng.rand(2, 4096) < 0.5 for _ in range(2)]
    turns = {"jax": 0, "port": 0}

    def nxt(side):
        m = masks[turns[side] % 2]
        turns[side] += 1
        return m

    def jax_dropout(data, rng=None, is_train=False, p=0.5):
        if not is_train or p <= 0.0:
            return data
        return jnp.where(jnp.asarray(nxt("jax")), data / (1 - p),
                         0.0).astype(data.dtype)
    monkeypatch.setattr(jget_op("Dropout"), "fn", jax_dropout)
    monkeypatch.setattr(pnn, "dropout_mask",
                        lambda shape, keep, rng, device:
                        torch.from_numpy(nxt("port")).to(device))
    ts = mt.TrainStep(psym, mt.optimizer.SGD(**SGD), ctx=mt.cpu())
    p, s, a = mt.convert.train_state_from_numpy(
        params, {n: (np.zeros_like(v),) for n, v in params.items()}, {},
        ctx=mt.cpu())
    p, _, _, outs = ts(p, s, a, ts.shard_batch(batch))
    with _X64():
        jts = JTrainStep(_sym(mx, "vgg", num_classes=10, num_layers=11),
                         mx.optimizer.SGD(**SGD))
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        js = {n: tuple(jnp.asarray(x) for x in st)
              for n, st in jts.fopt.init_state(params).items()}
        jp, _, _, jouts = jts(jp, js, {}, jts.shard_batch(batch))
        jp = {n: np.asarray(v) for n, v in jp.items()}
        jout = np.asarray(jouts[0])
    assert turns == {"jax": 2, "port": 2}
    for n in jp:
        _close(p[n].numpy(), jp[n], n)
        assert not np.array_equal(p[n].numpy(), params[n]), n
    _close(outs[0].numpy(), jout, "outputs")


# ---------------------------------------------------------- train_imagenet
def test_train_imagenet_networks(mx):
    """Each network name builds the JAX example's graph."""
    import argparse
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    try:
        import train_imagenet as jti
    finally:
        sys.path.pop(0)
    for name in ("resnet50", "resnet18", "alexnet", "inception-v3", "vgg",
                 "vgg13"):
        args = ti.parser().parse_args(["--network", name])
        ns = argparse.Namespace(network=name, num_classes=1000,
                                image_shape="3,224,224")
        with mt.name.NameManager():
            got = ti.get_symbol(args)
        with mx.name.NameManager():
            want = jti.get_symbol(ns)
        assert got.tojson() == want.tojson(), name
    with pytest.raises(ValueError):
        ti.get_symbol(ti.parser().parse_args(["--network", "lenet"]))


def test_train_imagenet_refuses_data_train(tmp_path, capsys):
    """--data-train, once refused, trains from a RecordIO pack: VGG-11 at
    3x32x32 on the host over 8 pass-through records, one finite loss a
    batch and the fit loop's data_wait in the JSON line."""
    rio = mt.recordio
    prefix = str(tmp_path / "train")
    w = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rs = np.random.RandomState(0)
    for i in range(8):
        w.write_idx(i, rio.pack_raw_img(
            rio.IRHeader(0, float(i % 10), i, 0),
            rs.randint(0, 256, (64, 70, 3)).astype(np.uint8)))
    w.close()
    assert ti.main(["--cpu", "--network", "vgg11", "--num-classes", "10",
                    "--image-shape", "3,32,32", "--batch-size", "4",
                    "--data-train", prefix + ".rec",
                    "--data-train-idx", prefix + ".idx"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["batches"] == 2 and np.isfinite(rec["batch_loss"]).all()
    assert rec["data_wait_ms"] >= 0.0


@pytest.mark.parametrize("path", ["benchmark", "fit"])
def test_train_imagenet_toy_runs(path, capsys):
    """VGG-11 at 3x32x32, batch 4, on the CPU: the benchmark prints img/s
    and ms a step; the fit's per-batch loss is finite, one a batch."""
    argv = ["--cpu", "--network", "vgg11", "--num-classes", "10",
            "--image-shape", "3,32,32", "--batch-size", "4"]
    argv += (["--benchmark", "1", "--benchmark-iters", "1"]
             if path == "benchmark" else ["--num-examples", "8"])
    assert ti.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["network"] == "vgg11" and rec["device"] == "cpu(0)"
    if path == "benchmark":
        assert rec["img_per_s"] > 0 and rec["ms_per_step"] > 0
    else:
        assert len(rec["batch_loss"]) == 2
        assert all(np.isfinite(rec["batch_loss"]))
