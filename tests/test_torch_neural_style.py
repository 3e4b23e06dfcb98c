"""``bench/neural_style.py``, the port's twin of
``examples/neural_style/neural_style.py``, against the JAX example on the
CPU: with the JAX example's feature weights passed in, the loss of each of
20 Adam steps on the input pixels within LOSS_RTOL of the example's (both
train in float32, the port's sums in another order: the histories agree to
about 1e-6 relative), and the loss falling; the executor binds a gradient
for ``data`` alone."""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench import neural_style as pns
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
STEPS = 20


@pytest.fixture(scope="module")
def example():
    """(the JAX example module, its feature weights as numpy)."""
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    sys.path.insert(0, os.path.join(ROOT, "examples", "neural_style"))
    try:
        import neural_style as ref
    finally:
        sys.path.pop(0)
    mx.random.seed(0)
    content, _ = ref._images(0)
    fex = ref.feature_net().simple_bind(mx.cpu(), grad_req="null",
                                        data=content.shape)
    init = mx.initializer.Xavier(magnitude=2.0)
    for name, arr in fex.arg_dict.items():
        if name != "data":
            init(mx.initializer.InitDesc(name), arr)
    return ref, {n: a.asnumpy() for n, a in fex.arg_dict.items()
                 if n != "data"}


def test_loss_history_matches_the_jax_example(example):
    ref, weights = example
    _, want = ref.transfer(steps=STEPS)
    img, got = pns.transfer(steps=STEPS, ctx=mt.cpu(), weights=weights)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < 0.5 * got[0]
    assert img.shape == (1, 3, pns.SIZE, pns.SIZE) and np.isfinite(img).all()


def test_graphs_and_own_weights(example):
    """The same loss graph as the example's; the port's own Xavier draw
    has the example's shapes; only ``data`` gets a gradient."""
    ref, weights = example
    assert pns.style_loss_net().list_arguments() == \
        ref.style_loss_net().list_arguments()
    own = pns.feature_weights(0)
    assert {n: v.shape for n, v in own.items()} == \
        {n: v.shape for n, v in weights.items()}
    net = pns.style_loss_net()
    reqs = {n: "write" if n == "data" else "null"
            for n in net.list_arguments()}
    shape = (1, 3, pns.SIZE, pns.SIZE)
    ex = net.simple_bind(mt.cpu(), grad_req=reqs, data=shape,
                         target_content=(1, 24, 12, 12),
                         **{"target_gram%d" % i: (c, c)
                            for i, c in enumerate(pns.CHANNELS)})
    assert sorted(ex.grad_dict) == ["data"]


def test_main_toy_run(capsys):
    assert pns.main(["--cpu", "--steps", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"steps": 3' in out
