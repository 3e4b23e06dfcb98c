"""Gradients at kinks: each op of mxnet_tpu_torch against mxnet_tpu's, in
float64, at points on its kink and off it.  The same numpy input and a
cotangent of ones go through ``jax.vjp`` of the JAX package's op and
``torch.autograd.grad`` of the port's: relu and Activation(relu) give 0.5 at
0, abs 1 at 0, clip 0.5 at a bound, and hypot 0.5 to each side at (0, 0)."""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch  # noqa: F401  (registers the port's ops)
from mxnet_tpu_torch.ops import registry as preg
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-12
# off-kink points beside the kink's, as float64
X = np.array([0.0, -0.0, 1.5, -2.0, 0.25, 3.0, -0.75])

# (op, attrs, inputs): every row's inputs hold its kink
CASES = [
    ("Activation", {"act_type": "relu"}, [X]),
    ("relu", {}, [X]),
    ("abs", {}, [X]),
    ("clip", {"a_min": -0.75, "a_max": 1.5}, [X]),
    ("_hypot", {}, [np.array([0.0, 0.0, 3.0, -0.0, 1.5, -2.0]),
                    np.array([0.0, 2.0, 0.0, 0.0, -0.5, -2.0])]),
    ("_hypot_scalar", {"scalar": 0.0}, [X]),
]


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _call(reg, name, attrs):
    op = reg.get_op(name)
    return op.make_callable(op.normalize_attrs(attrs), False)


@pytest.mark.parametrize("name,attrs,inputs", CASES,
                         ids=[c[0] for c in CASES])
def test_gradient_at_kink_matches_mxnet_tpu(name, attrs, inputs, f64):
    jfn = _call(jreg, name, attrs)
    jout, vjp = jax.vjp(lambda *a: jfn(*a), *[jax.numpy.asarray(v)
                                             for v in inputs])
    want = vjp(jax.numpy.ones_like(jout))
    leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for v in inputs]
    pout = _call(preg, name, attrs)(*leaves)
    got = torch.autograd.grad(pout, leaves, torch.ones_like(pout))
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=TOL)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL, err_msg="input %d" % i)


@pytest.mark.cuda
@pytest.mark.parametrize("name,attrs,inputs", CASES,
                         ids=[c[0] for c in CASES])
def test_gradient_at_kink_on_card_matches_cpu(name, attrs, inputs):
    """The same values and gradients on the card (relu and clip compare
    with 0-dim host tensors there) as on the CPU, in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn = _call(preg, name, attrs)
    res = []
    for dev in ("cpu", "cuda"):
        leaves = [torch.tensor(v, dtype=torch.float64, device=dev,
                               requires_grad=True) for v in inputs]
        out = fn(*leaves)
        assert out.device.type == dev
        res.append([t.detach().cpu() for t in (out,) + torch.autograd.grad(
            out, leaves, torch.ones_like(out))])
    for c, g in zip(*res):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=0, atol=TOL)
