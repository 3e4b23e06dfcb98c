"""The port's DCGAN (``mxnet_tpu_torch/bench/dcgan.py``, the twin of
``examples/gan/dcgan.py``) against the JAX package's example, on the CPU at
a small size (batch 8, code 16; the example's widths, ngf = ndf = 32).

- A twin of ``tests/python/train/test_dcgan.py``: the losses finite and
  moving, the samples moved by training, the discriminator's weights by
  ``update()``.
- One GAN iteration of each package from the same parameters (the JAX
  example's ``Normal(0.02)`` replaced by an initializer that loads them):
  every parameter and moving statistic of both networks, float32, within
  FLOOR_X times its float32 floor of the JAX iteration's (the distance of
  the JAX iteration from parameters nudged by 2^-20, as
  ``tests/test_torch_module.py`` holds Module.fit).  Both Modules bind
  float32 (the example's ``mx.nd.array`` inputs), so this is the
  float32 rule; the port's float64 iteration (``dtype="float64"``), the
  reference of the card's check, sits inside the same band.
- The fold: D's gradient arrays at ``update()`` hold the fake half's
  gradient plus the real half's, in float64."""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench import dcgan
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, CODE = 8, 16
FLOOR_X = 4.0
FLOOR_MIN = 1e-6
NUDGE = 2.0 ** -20


@pytest.fixture(scope="module")
def example():
    """The JAX package's example, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        "mxnet_tpu_dcgan_example", os.path.join(ROOT, "examples", "gan",
                                                "dcgan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(seed=0, nudge=0.0):
    """Both networks' parameters as the example initialises them (weights
    N(0, 0.02), gamma 1, beta 0, moving mean 0, variance 1) but drawn from
    ``seed``, each weight times 1 + nudge * U[-1, 1]."""
    rng = np.random.RandomState(seed)
    out = {}
    for net, shapes in ((dcgan.make_generator(code_dim=CODE),
                         {"code": (BATCH, CODE, 1, 1)}),
                        (dcgan.make_discriminator(),
                         {"data": (BATCH, 1, 32, 32),
                          "dloss_label": (BATCH, 1)})):
        arg, _, aux = net.infer_shape(**shapes)
        for n, s in zip(net.list_arguments(), arg):
            if n in shapes:
                continue
            if n.endswith("_weight"):
                v = rng.randn(*s) * 0.02
                v *= 1 + nudge * rng.uniform(-1, 1, s)
            else:
                v = np.ones(s) if n.endswith("_gamma") else np.zeros(s)
            out[n] = v.astype(np.float32)
        for n, s in zip(net.list_auxiliary_states(), aux):
            out[n] = (np.ones(s) if n.endswith("_var")
                      else np.zeros(s)).astype(np.float32)
    return out


def _leaves(mods):
    out = {}
    for m in mods:
        arg, aux = m.get_params()
        out.update({n: v.asnumpy().astype(np.float64)
                    for n, v in list(arg.items()) + list(aux.items())})
    return out


def _jax_iteration(example, monkeypatch, params):
    """One iteration of the JAX example from ``params``."""
    class Given(mx.initializer.Initializer):
        def __call__(self, desc, arr):
            arr[:] = params[str(desc)]
    monkeypatch.setattr(mx.initializer, "Normal", lambda sigma: Given())
    g, d, hist = example.train(epochs=1, batch=BATCH, steps_per_epoch=1,
                               code_dim=CODE, seed=0)
    return _leaves((g, d)), hist


def _port_iteration(params, dtype="float32"):
    g, d, hist = dcgan.train(epochs=1, batch=BATCH, steps_per_epoch=1,
                             code_dim=CODE, seed=0, ctx=mt.cpu(),
                             params=params, dtype=dtype)
    if dtype == "float32":
        return _leaves((g, d)), hist
    # get_params copies to the float32 host arrays: read the executors
    out = {}
    for m in (g, d):
        ex = m._exec_group.execs[0]
        for n, v in list(ex.arg_dict.items()) + list(ex.aux_dict.items()):
            if n in params:
                assert v.dtype == np.dtype(dtype), n
                out[n] = v.asnumpy()
    return out, hist


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_dcgan_trains_and_samples_move():
    """(twin of the JAX package's test_dcgan_trains_and_samples_move)"""
    cpu = mt.cpu()
    mod_g, mod_d, hist = dcgan.train(epochs=1, batch=8, steps_per_epoch=8,
                                     code_dim=16, seed=0, ctx=cpu)
    d = np.asarray(hist["d_loss"])
    assert np.isfinite(d).all()
    assert np.std(d) > 1e-4, d
    before = dcgan.sample(mod_g, 4, code_dim=16, seed=7)
    mod_g2, mod_d_init, _ = dcgan.train(epochs=0, batch=8,
                                        steps_per_epoch=0, code_dim=16,
                                        seed=0, ctx=cpu)
    untrained = dcgan.sample(mod_g2, 4, code_dim=16, seed=7)
    assert before.shape == untrained.shape == (4, 1, 32, 32)
    assert np.abs(before - untrained).max() > 1e-3
    w_trained = mod_d.get_params()[0]["d_c0_weight"].asnumpy()
    w_init = mod_d_init.get_params()[0]["d_c0_weight"].asnumpy()
    assert np.isfinite(w_trained).all()
    assert np.abs(w_trained - w_init).max() > 1e-5


def test_one_iteration_matches_the_jax_example(example, monkeypatch):
    params = _params()
    want, want_hist = _jax_iteration(example, monkeypatch, params)
    nudged, _ = _jax_iteration(example, monkeypatch, _params(nudge=NUDGE))
    got, got_hist = _port_iteration(params)
    f64, _ = _port_iteration(params, "float64")
    assert sorted(got) == sorted(want) == sorted(params)
    for k in want:
        floor = max(_rel(nudged[k], want[k]), FLOOR_MIN)
        assert _rel(got[k], want[k]) <= FLOOR_X * floor, \
            (k, _rel(got[k], want[k]), floor)
        assert _rel(f64[k], want[k]) <= FLOOR_X * floor, \
            (k, _rel(f64[k], want[k]), floor)
        if not k.endswith(("_gamma", "_beta")):
            assert not np.array_equal(got[k], params[k]), k
    for key in ("d_loss", "g_loss"):
        np.testing.assert_allclose(got_hist[key], want_hist[key], rtol=1e-4)


def test_discriminator_gradients_fold_fake_and_real():
    """The fold ``g += stash`` leaves D's gradient arrays holding the fake
    half's gradient plus the real half's: against each half's gradient
    from a bind of its own, in float64."""
    cpu = mt.cpu()
    params = _params(seed=3)
    g, d, _ = dcgan.train(epochs=0, batch=BATCH, steps_per_epoch=0,
                          code_dim=CODE, seed=0, ctx=cpu, params=params,
                          dtype="float64")
    rng = np.random.RandomState(5)
    code = rng.randn(BATCH, CODE, 1, 1).astype(np.float32)
    real = next(dcgan.blob_batches(BATCH, 1, seed=9))
    seen = {}
    update = d.update

    def spy():
        seen.update({n: a[0].asnumpy().copy() for n, a in zip(
            d._exec_group.param_names, d._exec_group.grad_arrays)})
        update()
    d.update = spy
    label = mt.nd.zeros((BATCH, 1), ctx=cpu, dtype="float64")
    dcgan.iterate(g, d, label, code, real)

    # the same sum by hand: each half's gradient from a fresh float64 bind
    def bind(net, grad_req, **inputs):
        ex = net.bind(cpu, {n: mt.nd.array(inputs[n] if n in inputs
                                           else params[n], ctx=cpu,
                                           dtype=np.float64)
                            for n in net.list_arguments()},
                      args_grad={n: mt.nd.zeros(params[n].shape, ctx=cpu,
                                                dtype=np.float64)
                                 for n in net.list_arguments()
                                 if n not in inputs}
                      if grad_req == "write" else None, grad_req=grad_req,
                      aux_states={n: mt.nd.array(params[n], ctx=cpu,
                                                 dtype=np.float64)
                                  for n in net.list_auxiliary_states()})
        return ex
    net = dcgan.make_discriminator()
    total = {}
    fake = bind(dcgan.make_generator(code_dim=CODE), "null",
                code=code).forward(is_train=True)[0].asnumpy()
    for x, lab in ((fake, 0.0), (real, 1.0)):
        ex = bind(net, "write", data=x, dloss_label=np.full((BATCH, 1), lab))
        ex.forward(is_train=True)
        ex.backward()
        for n in seen:
            total[n] = total.get(n, 0) + ex.grad_dict[n].asnumpy()
    assert sorted(seen) == sorted(total)
    for n in seen:
        np.testing.assert_allclose(seen[n], total[n], rtol=1e-9,
                                   atol=1e-12 * np.abs(total[n]).max())
