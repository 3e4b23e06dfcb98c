"""AlexNet (``models/alexnet.py``) in the port against mxnet_tpu: the graph
(arguments and shapes at 224x224, 1000 classes), and one SGD-momentum
``TrainStep`` at a small input (3x67x67, 10 classes, batch 2: the feature
map reaches 1x1 before the two 4096-wide layers) in float64 from one state
carried across as numpy, under ``MXNET_CONV_LAYOUT`` NHWC and NCHW.

Dropout draws from each package's own generator (torch's Philox and JAX's
threefry give other streams), so both steps take the same two masks: the
JAX op's function is replaced by one that applies them, the port's
``ops.nn.dropout_mask`` seam returns them, in graph order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import name as jname
from mxnet_tpu.models import alexnet as jalexnet
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.train import TrainStep as JTrainStep
from mxnet_tpu_torch import name as pname
from mxnet_tpu_torch.models import alexnet as palexnet
from mxnet_tpu_torch.ops import nn as pnn
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from test_torch_threads import torch_threads_per_worker  # noqa: F401

CLASSES = 10
BATCH = 2
IMAGE = (3, 67, 67)
SHAPES = {"data": (BATCH,) + IMAGE, "softmax_label": (BATCH,)}
REL = 1e-9
SGD = dict(learning_rate=0.01, momentum=0.9, wd=5e-4, rescale_grad=0.5)


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _jsym(classes=CLASSES):
    with jname.NameManager():
        return jalexnet.get_symbol(num_classes=classes)


def _psym(classes=CLASSES):
    with pname.NameManager():
        return palexnet.get_symbol(num_classes=classes)


def _state(sym, seed=0):
    """He-scaled float64 weights, small biases, a batch and two Dropout
    masks (keep 1/2), from ``seed``."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    params = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in SHAPES:
            continue
        fan_in = int(np.prod(s[1:])) if len(s) > 1 else 1
        params[n] = rng.randn(*s) * (np.sqrt(2.0 / fan_in) if len(s) > 1
                                     else 0.05)
    batch = {"data": rng.randn(*SHAPES["data"]),
             "softmax_label": rng.randint(0, CLASSES, BATCH).astype(
                 np.float64)}
    masks = [rng.rand(BATCH, 4096) < 0.5 for _ in range(2)]
    return params, batch, masks


def _inject(monkeypatch, masks):
    """Both packages' Dropout takes ``masks`` in turn (graph order)."""
    turns = {"jax": 0, "port": 0}

    def nxt(side):
        m = masks[turns[side] % len(masks)]
        turns[side] += 1
        return m

    def jax_dropout(data, rng=None, is_train=False, p=0.5):
        if not is_train or p <= 0.0:
            return data
        keep = 1.0 - p
        return jnp.where(jnp.asarray(nxt("jax")), data / keep,
                         0.0).astype(data.dtype)

    def port_mask(shape, keep, rng, device):
        m = torch.from_numpy(nxt("port")).to(device)
        assert tuple(m.shape) == tuple(shape) and keep == 0.5
        return m
    monkeypatch.setattr(jget_op("Dropout"), "fn", jax_dropout)
    monkeypatch.setattr(pnn, "dropout_mask", port_mask)
    return turns


def _close(got, want, what):
    """Every entry within REL of the largest magnitude of that tensor."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= REL * scale, \
        "%s: max |d| %.3g > %g x %.3g" % (what, err, REL, scale)


def _port_step(params, batch):
    """One port TrainStep from ``params`` (float64): (params after it,
    outputs)."""
    ts = mt.TrainStep(_psym(), mt.optimizer.SGD(**SGD), ctx=mt.cpu())
    p, s, a = mt.convert.train_state_from_numpy(
        params, {n: (np.zeros_like(v),) for n, v in params.items()}, {},
        ctx=mt.cpu())
    p, s, a, outs = ts(p, s, a, ts.shard_batch(batch))
    return {n: v.numpy() for n, v in p.items()}, outs[0].numpy()


def _jax_step(params, batch):
    ts = JTrainStep(_jsym(), mx.optimizer.SGD(**SGD))
    state = ts.fopt.init_state(params)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = {n: tuple(jnp.asarray(x) for x in st) for n, st in state.items()}
    jp, js, _, outs = ts(jp, js, {}, ts.shard_batch(batch))
    return {n: np.asarray(v) for n, v in jp.items()}, np.asarray(outs[0])


def test_alexnet_graph_matches_mxnet_tpu():
    """The same arguments, shapes and outputs at 224x224 and 1000 classes
    (50,844,008 parameters: conv1 has no padding, so the last map is
    5x5), no computation."""
    shapes = {"data": (32, 3, 224, 224), "softmax_label": (32,)}
    j, p = _jsym(1000), _psym(1000)
    assert p.list_arguments() == j.list_arguments()
    assert p.list_outputs() == j.list_outputs()
    ja, jo, _ = j.infer_shape(**shapes)
    pa, po, _ = p.infer_shape(**shapes)
    assert [tuple(s) for s in pa] == [tuple(s) for s in ja]
    assert [tuple(s) for s in po] == [tuple(s) for s in jo] == [(32, 1000)]
    n = sum(int(np.prod(s)) for name, s in zip(p.list_arguments(), pa)
            if name not in shapes)
    assert n == 50844008
    assert mt.models.get_alexnet is palexnet.get_symbol


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_alexnet_step_matches_mxnet_tpu(layout, monkeypatch, f64):
    """One float64 step of each package from one state, Dropout masks
    injected: every parameter after it and the softmax output within 1e-9
    of the largest entry; each Dropout drew once a step."""
    monkeypatch.setenv("MXNET_CONV_LAYOUT", layout)
    params, batch, masks = _state(_jsym())
    turns = _inject(monkeypatch, masks)
    got, got_out = _port_step(params, batch)
    want, want_out = _jax_step(params, batch)
    assert turns["port"] == 2 and turns["jax"] > 0 and turns["jax"] % 2 == 0
    assert sorted(got) == sorted(want)
    _close(got_out, want_out, "softmax")
    for n, v in want.items():
        _close(got[n], v, n)
        assert not np.array_equal(got[n], params[n]), n


def test_alexnet_step_same_under_both_layouts(monkeypatch):
    """The port's step channel-last (LRN windows over the minor axis) and
    channel-first: equal to float64 rounding; both LRNs take the layout
    of the pass."""
    params, batch, masks = _state(_psym(), seed=1)
    lrn = pget_op("LRN")
    fn, seen = lrn.fn, []

    def spy(*a, **kw):
        seen.append(kw.get("layout"))
        return fn(*a, **kw)
    monkeypatch.setattr(lrn, "fn", spy)
    out = {}
    for layout in ("NHWC", "NCHW"):
        monkeypatch.setenv("MXNET_CONV_LAYOUT", layout)
        _inject(monkeypatch, masks)
        out[layout] = _port_step(params, batch)
    assert seen == ["NHWC", "NHWC", None, None]
    (a, ao), (b, bo) = out["NHWC"], out["NCHW"]
    _close(ao, bo, "softmax")
    for n in a:
        _close(a[n], b[n], n)
