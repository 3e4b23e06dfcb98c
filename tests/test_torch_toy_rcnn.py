"""The toy Faster R-CNN (``bench/toy_rcnn.py``, the twin of
``examples/rcnn/train_toy_rcnn.py``) in the port against mxnet_tpu's, on
the CPU.

- The graph: the same arguments, outputs and shapes as the example's
  ``build_symbol``.
- One executor step in float64 (``type_dict`` over every argument; the
  JAX package with x64 on) from one ``.params`` file in both packages, at
  batch 2: both outputs and every gradient within STEP_TOL of the largest
  entry, and the ROIs of the ``proposal`` node the same rows (batch
  indices and zero rows equal, corners within STEP_TOL).
- The twin's ``Module.fit`` on the host, 2 epochs of the example's data:
  the fused path, the objectness loss lower in the second epoch, no NMS
  launch (the host's NMS is the plain loop).  The 12-epoch accuracy bound
  is checked on the card by ``chip_smoke.py``.
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench import toy_rcnn
from test_torch_threads import torch_threads_per_worker  # noqa: F401

STEP_TOL = 1e-9
BATCH = 2
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "rcnn",
                       "train_toy_rcnn.py")
NAMES = ("data", "im_info", "rpn_heat", "softmax_label")


@pytest.fixture
def example():
    """The JAX package's example as a module (x64 on for the test)."""
    import jax
    spec = importlib.util.spec_from_file_location("train_toy_rcnn", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_enable_x64", True)
    yield mod
    jax.config.update("jax_enable_x64", False)


def _inputs(b):
    x, y, heat = toy_rcnn.make_data(b)
    im_info = np.tile(np.array([[64, 64, 1.0]]), (b, 1))
    return {"data": x, "im_info": im_info, "rpn_heat": heat,
            "softmax_label": y}


def _params(net, seed=2):
    """Xavier-scaled uniform weights (magnitude 2), small biases."""
    shapes = {k: v.shape for k, v in _inputs(BATCH).items()}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    out = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if len(s) > 1:
            hw = np.prod(s[2:]) if len(s) > 2 else 1
            scale = np.sqrt(2.0 / ((s[0] + s[1]) * hw / 2.0))
        else:
            scale = 0.05
        out[n] = rs.uniform(-1, 1, s) * scale
    return out


def _step(pkg, net, params_file):
    """(outputs, {name: gradient}, ROIs) of one float64 executor step."""
    ins = _inputs(BATCH)
    t64 = {n: np.float64 for n in net.list_arguments()}
    ex = net.simple_bind(pkg.cpu(), grad_req="write", type_dict=t64,
                         **{k: v.shape for k, v in ins.items()})
    loaded = pkg.nd.load(params_file, **({"ctx": mt.cpu()} if pkg is mt
                                         else {}))
    params = {k[4:]: v for k, v in loaded.items()}
    ex.copy_params_from(params, {})
    for k, v in ins.items():
        ex.arg_dict[k][:] = v.astype(np.float64)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward()
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
             if n not in NAMES}
    rois_sym = net.get_internals()["proposal_output"]
    rex = rois_sym.simple_bind(pkg.cpu(), grad_req="null", type_dict={
        n: np.float64 for n in rois_sym.list_arguments()},
        **{k: v.shape for k, v in ins.items()
           if k in rois_sym.list_arguments()})
    rex.copy_params_from({k: v for k, v in params.items()
                          if k in rois_sym.list_arguments()}, {})
    for k, v in ins.items():
        if k in rex.arg_dict:
            rex.arg_dict[k][:] = v.astype(np.float64)
    return outs, grads, rex.forward()[0].asnumpy()


def _close(got, want, what):
    scale = max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape and \
        np.abs(got - want).max() <= STEP_TOL * scale, \
        (what, np.abs(got - want).max() / scale)


def test_graph_matches_the_example(example):
    j, p = example.build_symbol(8), toy_rcnn.build_symbol(8)
    shapes = {k: (8,) + v.shape[1:] for k, v in _inputs(1).items()}
    assert p.list_arguments() == j.list_arguments()
    assert p.list_outputs() == j.list_outputs()
    ja, jo, _ = j.infer_shape(**shapes)
    pa, po, _ = p.infer_shape(**shapes)
    assert [tuple(s) for s in pa] == [tuple(s) for s in ja]
    assert [tuple(s) for s in po] == [tuple(s) for s in jo]
    assert toy_rcnn.BATCH == 8 and toy_rcnn.EPOCHS == 12 \
        and toy_rcnn.IMAGES == 192


def test_train_step_matches_mxnet_tpu_float64(example, tmp_path):
    """One float64 step of each package from one .params file: outputs
    and gradients within STEP_TOL, the ROIs the same rows."""
    jnet, pnet = example.build_symbol(BATCH), toy_rcnn.build_symbol(BATCH)
    params = _params(pnet)
    f = str(tmp_path / "toy_rcnn.params")
    mt.nd.save(f, {"arg:" + k: mt.nd.array(v, ctx=mt.cpu(),
                                            dtype=np.float64)
                   for k, v in params.items()})
    got = _step(mt, pnet, f)
    want = _step(example.mx, jnet, f)
    assert got[0][0].dtype == np.float64
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, "output %d" % i)
    assert sorted(got[1]) == sorted(want[1])
    for n in want[1]:
        _close(got[1][n], want[1][n], "grad " + n)
        # the box deltas reach only Proposal, whose ROIs are BlockGrad's
        assert np.abs(want[1][n]).max() > 0 or n.startswith("rpn_bbox"), n
    rois, want_rois = got[2], want[2]
    assert rois.shape == (BATCH * 8, 5)
    np.testing.assert_array_equal(rois[:, 0], want_rois[:, 0])
    np.testing.assert_array_equal(rois[:, 1:].any(1), want_rois[:, 1:].any(1))
    _close(rois, want_rois, "rois")


def test_fit_on_the_host_moves_the_loss():
    """The twin's fit for 2 epochs: the fused path, the objectness loss
    lower in epoch 2, the score's accuracy a fraction, no NMS launch."""
    rec, mod = toy_rcnn.run(epochs=2, ctx=mt.cpu())
    assert rec["fused_path"]
    assert len(rec["rpn_loss"]) == 2 and len(rec["train_accuracy"]) == 2
    assert rec["rpn_loss"][1] < rec["rpn_loss"][0], rec["rpn_loss"]
    assert 0.0 <= rec["accuracy"] <= 1.0
    assert rec["nms_launches_fit"] == rec["nms_launches_score"] == 0
    assert rec["host_ms_per_batch"] > 0 and rec["value"] > 0
    arg, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in arg.values())
