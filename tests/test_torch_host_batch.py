"""A host batch through mxnet_tpu_torch's TrainStep and EvalStep, against
mxnet_tpu's, on the CPU.

The JAX package's ``TrainStep.__call__``, ``TrainStep.run_steps`` and
``EvalStep.__call__`` take a dict of numpy arrays (jit moves them to the
device).  The port's do too: each places a host batch as ``shard_batch``
does.  The same numpy batch and parameters go through both packages: a
small FullyConnected net with a SoftmaxOutput head, SGD-momentum, one
``__call__`` step, ``run_steps`` on one batch and on a stacked batch, and
``EvalStep``; outputs and parameters agree within TOL (both in float32:
rounding of the products only).
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-3)


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.train  # noqa: F401
    return mx


def _net(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    act = pkg.sym.Activation(data=fc1, act_type="tanh", name="act")
    fc2 = pkg.sym.FullyConnected(data=act, num_hidden=5, name="fc2")
    return pkg.sym.SoftmaxOutput(data=fc2, name="softmax")


def _numpy_state(seed=0):
    rs = np.random.RandomState(seed)
    params = {"fc1_weight": rs.randn(16, 12) * 0.3, "fc1_bias": rs.randn(16),
              "fc2_weight": rs.randn(5, 16) * 0.3, "fc2_bias": rs.randn(5)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    batch = {"data": rs.randn(8, 12).astype(np.float32),
             "softmax_label": rs.randint(0, 5, 8).astype(np.float32)}
    return params, batch


def _steps(pkg, params, batch, stacked):
    """(one __call__ step's outputs and parameters, run_steps(2)'s, the
    EvalStep's outputs), every batch handed over as numpy arrays."""
    train = pkg if pkg is mt else pkg.train
    ts = train.TrainStep(_net(pkg), pkg.optimizer.SGD(**SGD),
                         **({"ctx": mt.cpu()} if pkg is mt else {}))
    if pkg is mt:
        def state():
            return mt.convert.train_state_from_numpy(
                params, {k: (np.zeros_like(v),) for k, v in params.items()},
                {}, ctx=mt.cpu())
    else:
        import jax.numpy as jnp

        def state():
            return ({k: jnp.asarray(v) for k, v in params.items()},
                    {k: (jnp.zeros_like(jnp.asarray(v)),)
                     for k, v in params.items()}, {})

    def host(p):
        return {k: np.array(v) for k, v in p.items()}
    p, s, a = state()
    p, s, a, outs = ts(p, s, a, batch)
    one = (np.array(outs[0]), host(p))
    p, s, a = state()
    if stacked:
        big = {k: np.stack([v, v[::-1].copy(), v]) for k, v in batch.items()}
        p, s, a, outs = ts.run_steps(p, s, a, big, 2, stacked=True)
    else:
        p, s, a, outs = ts.run_steps(p, s, a, batch, 2)
    many = (np.array(outs[0]), host(p))
    ev = train.EvalStep(_net(pkg))
    evo = ev(p, a, batch)
    return one, many, np.array(evo[0])


@pytest.mark.parametrize("stacked", [False, True])
def test_host_batch_matches_mxnet_tpu(mx, stacked):
    params, batch = _numpy_state()
    got = _steps(mt, params, batch, stacked)
    want = _steps(mx, params, batch, stacked)
    for (go, gp), (wo, wp) in zip(got[:2], want[:2]):
        np.testing.assert_allclose(go, wo, rtol=TOL, atol=TOL)
        assert sorted(gp) == sorted(wp)
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    np.testing.assert_allclose(got[2], want[2], rtol=TOL, atol=TOL)


def test_host_batch_of_ndarrays_and_placed_tensors_agree():
    """A dict of NDArrays, of numpy arrays and of placed tensors give the
    same step."""
    params, batch = _numpy_state(1)
    results = []
    for kind in ("numpy", "ndarray", "placed"):
        ts = mt.TrainStep(_net(mt), mt.optimizer.SGD(**SGD), ctx=mt.cpu())
        p, s, a = mt.convert.train_state_from_numpy(
            params, {k: (np.zeros_like(v),) for k, v in params.items()},
            {}, ctx=mt.cpu())
        b = {"numpy": batch,
             "ndarray": {k: mt.nd.array(v, ctx=mt.cpu())
                         for k, v in batch.items()},
             "placed": ts.shard_batch(batch)}[kind]
        p, s, a, outs = ts(p, s, a, b)
        results.append((outs[0].numpy(), {k: v.numpy()
                                          for k, v in p.items()}))
    for other in results[1:]:
        np.testing.assert_array_equal(other[0], results[0][0])
        for k in params:
            np.testing.assert_array_equal(other[1][k], results[0][1][k])
