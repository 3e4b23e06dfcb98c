"""Module.fit of LeNet (1x28x28) in mxnet_tpu_torch against mxnet_tpu's,
SGD-momentum and Adam, fused and general path: the cases of
test_torch_module.py's fit check for LeNet (its docstring states the data,
the parameters and the float32 floor each parameter is held to).

This file keeps torch's default intra-op threads (it does not import
test_torch_threads' cap): the floor holds the port's fit as computed with
one thread a core, and with one to four threads oneDNN sums the
convolutions in another order, enough to move conv1_weight by 3.4e-5 of
its largest entry after the fit, past 4x the floor."""
import pytest

from test_torch_module import fit_matches_mxnet_tpu, mx  # noqa: F401


@pytest.mark.parametrize("path", ["fused", "general"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_lenet_fit_matches_mxnet_tpu(mx, opt, path):  # noqa: F811
    fit_matches_mxnet_tpu(mx, "lenet", opt, path)
