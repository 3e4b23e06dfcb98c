"""Per-op forward parity, mxnet_tpu_torch vs mxnet_tpu, in float64 (1e-9),
for every op of the serving slice, and their shape inference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from test_torch_threads import torch_threads_per_worker  # noqa: F401

BN_IN = [(2, 3, 4, 5), (3,), (3,), (3,), (3,)]
BN_IN_NHWC = [(2, 4, 5, 3), (3,), (3,), (3,), (3,)]

CASES = [
    # op, attrs, input shapes
    ("FullyConnected", {"num_hidden": 5}, [(3, 4, 2, 2), (5, 16), (5,)]),
    ("FullyConnected", {"num_hidden": 5, "no_bias": True}, [(3, 16), (5, 16)]),
    ("Activation", {"act_type": "relu"}, [(3, 7)]),
    ("Activation", {"act_type": "sigmoid"}, [(3, 7)]),
    ("Activation", {"act_type": "tanh"}, [(3, 7)]),
    ("Activation", {"act_type": "softrelu"}, [(3, 7)]),
    ("Convolution", {"kernel": (3, 3), "num_filter": 4, "stride": (2, 2),
                     "pad": (1, 1), "no_bias": True}, [(2, 3, 9, 9),
                                                       (4, 3, 3, 3)]),
    ("Convolution", {"kernel": (1, 1), "num_filter": 4}, [(2, 3, 5, 6),
                                                          (4, 3, 1, 1),
                                                          (4,)]),
    ("Convolution", {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1),
                     "layout": "NHWC", "no_bias": True}, [(2, 6, 6, 3),
                                                          (4, 3, 3, 3)]),
    ("Convolution", {"kernel": (3, 3), "num_filter": 4, "num_group": 2,
                     "dilate": (2, 2), "no_bias": True}, [(2, 4, 9, 9),
                                                          (4, 2, 3, 3)]),
    ("Convolution", {"kernel": (7, 7), "num_filter": 4, "stride": (2, 2),
                     "pad": (3, 3), "no_bias": True}, [(2, 3, 16, 16),
                                                       (4, 3, 7, 7)]),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pool_type": "max"}, [(2, 3, 9, 9)]),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pool_type": "max", "layout": "NHWC"}, [(2, 8, 8, 3)]),
    ("Pooling", {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max",
                 "pooling_convention": "full"}, [(2, 3, 7, 7)]),
    ("Pooling", {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
     [(2, 3, 5, 6)]),
    ("Pooling", {"kernel": (7, 7), "global_pool": True, "pool_type": "avg",
                 "layout": "NHWC"}, [(2, 5, 6, 3)]),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pool_type": "avg", "pooling_convention": "full"},
     [(2, 3, 8, 8)]),
    ("Pooling", {"kernel": (2, 2), "stride": (1, 1), "pool_type": "sum"},
     [(2, 3, 4, 4)]),
    ("BatchNorm", {"fix_gamma": True, "eps": 2e-5}, BN_IN),
    ("BatchNorm", {"fix_gamma": False, "eps": 2e-5}, BN_IN),
    ("BatchNorm", {"fix_gamma": False, "layout": "NHWC"}, BN_IN_NHWC),
    ("BatchNorm", {"fix_gamma": False, "output_mean_var": True}, BN_IN),
    ("_BatchNormReLU", {"fix_gamma": False, "eps": 2e-5}, BN_IN),
    ("_BatchNormReLU", {"fix_gamma": False, "layout": "NHWC"}, BN_IN_NHWC),
    ("SoftmaxOutput", {}, [(3, 5), (3,)]),
    ("SoftmaxOutput", {}, [(3, 2, 2), (3,)]),
    ("SoftmaxOutput", {"multi_output": True}, [(2, 4, 3), (2, 3)]),
    ("SoftmaxOutput", {"preserve_shape": True}, [(2, 3, 4), (2, 3)]),
    ("Flatten", {}, [(2, 3, 4)]),
    ("Reshape", {"shape": (0, -1)}, [(2, 3, 4)]),
    ("Reshape", {"shape": (-3, -2)}, [(2, 3, 4)]),
    ("_plus", {}, [(2, 3, 4), (2, 3, 4)]),
]
IDS = ["%d-%s" % (i, c[0]) for i, c in enumerate(CASES)]


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _inputs(op, shapes, seed):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*s) for s in shapes]
    if op in ("BatchNorm", "_BatchNormReLU"):
        out[4] = rng.rand(*shapes[4]) + 0.5      # moving_var > 0
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_f64_matches_mxnet_tpu(case, f64):
    name, attrs, shapes = case
    ins = _inputs(name, shapes, seed=len(IDS))
    jop, pop = jget_op(name), pget_op(name)
    jout = jop.make_callable(jop.normalize_attrs(attrs), False)(
        *[jnp.asarray(a) for a in ins])
    pout = pop.make_callable(pop.normalize_attrs(attrs), False)(
        *[torch.from_numpy(a) for a in ins])
    jout = jout if isinstance(jout, (tuple, list)) else (jout,)
    pout = pout if isinstance(pout, (tuple, list)) else (pout,)
    assert len(pout) == len(jout)
    for p, j in zip(pout, jout):
        j = np.asarray(j)
        assert p.dtype == torch.float64 and tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-9, atol=1e-9)


# graph shape inference runs in the logical NCHW layout
INFER = [(i, c) for i, c in zip(IDS, CASES) if "layout" not in c[1]]


@pytest.mark.parametrize("case", [c for _, c in INFER],
                         ids=[i for i, _ in INFER])
def test_infer_shape_matches_mxnet_tpu(case):
    name, attrs, shapes = case
    jop, pop = jget_op(name), pget_op(name)
    # data only: parameter shapes are deduced from it
    given = [shapes[0]] + [None] * (len(shapes) - 1)
    jin, jouts, _ = jop.infer_shape(jop.normalize_attrs(attrs), given)
    pin, pouts, _ = pop.infer_shape(pop.normalize_attrs(attrs), given)
    assert [tuple(s) if s else s for s in pouts] == \
        [tuple(s) if s else s for s in jouts]
    assert pin == jin


def test_training_mode_raises(f64):
    """BatchNorm's training mode no longer raises: it normalises with the
    batch statistics and returns the updated moving statistics, equal to
    mxnet_tpu's training mode in float64."""
    ins = _inputs("BatchNorm", BN_IN, 0)
    jop, pop = jget_op("BatchNorm"), pget_op("BatchNorm")
    jout = jop.make_callable(jop.normalize_attrs({}), True)(
        *[jnp.asarray(a) for a in ins])
    pout = pop.make_callable(pop.normalize_attrs({}), True)(
        *[torch.from_numpy(a) for a in ins])
    assert len(pout) == len(jout) == 3
    for p, j in zip(pout, jout):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-9,
                                   atol=1e-9)
    assert not np.allclose(pout[1].numpy(), ins[3])     # moving_mean moved
