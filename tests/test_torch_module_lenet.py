"""Module.fit of LeNet (1x28x28) in mxnet_tpu_torch against mxnet_tpu's,
SGD-momentum and Adam, fused and general path: the cases of
test_torch_module.py's fit check for LeNet (its docstring states the data,
the parameters and the float32 floor each parameter is held to)."""
import pytest

from test_torch_module import fit_matches_mxnet_tpu, mx  # noqa: F401


@pytest.mark.parametrize("path", ["fused", "general"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_lenet_fit_matches_mxnet_tpu(mx, opt, path):  # noqa: F811
    fit_matches_mxnet_tpu(mx, "lenet", opt, path)
