"""mxnet_tpu_torch NormConv: the CUDA source ``csrc/norm_conv.cu`` run on the
CPU through ``bench/host_emu.h`` (one std::thread per CUDA thread, blocks in
order; the emulated card has 4 SMs) against the plain version
``norm_conv_ref``, at the small shapes of ``host_emu.NC_CASES``: both sides
of the split-K choice and forced uneven slices, 16-byte and element-wise
loads, ragged M and Cout, stride 2 with pad 1, the statistics, the prologue
and the ReLU off, float32 and bfloat16.
"""
import os

import pytest
import torch
import torch.nn.functional as F

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.bench import host_emu
from mxnet_tpu_torch.ops import norm_conv as pnc
from mxnet_tpu_torch.ops.kernel_build import CSRC

# max |y_kernel - y_plain| over max |y_plain|, as chip_smoke.py's Y_TOL:
# float32 sums in another order; bfloat16 rounds y once from float32 sums
Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# float32 statistics against the float32 sums of the plain conv, relative
# to the largest |sum| (chip_smoke.py's STATS_TOL)
STATS_TOL = 1e-4


@pytest.fixture(scope="module")
def host_nc(tmp_path_factory):
    """``csrc/norm_conv.cu`` compiled for the CPU through
    ``bench/host_emu.h``."""
    return host_emu.host_library(os.path.join(CSRC, "norm_conv.cu"),
                                 str(tmp_path_factory.mktemp("host_emu")))


def _stats_ref(x, w, sc, sh, k, s, p, relu, prologue):
    """float32 per-Cout sums of y and y^2, from the prologue output in x's
    dtype convolved in float32: the kernel's statistics are taken from its
    float32 sums before the downcast, in bfloat16 too."""
    xh = pnc._apply(x, sc, sh, relu) if prologue else x
    y = F.conv2d(xh.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), stride=s, padding=p)
    return y.sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("case", host_emu.NC_CASES, ids=[
    "%dx%d-c%d-%d-k%ds%dp%d-%s-r%dp%ds%d-t%d-S%d" % (
        c[0], c[1], c[2], c[3], c[4], c[5], c[6], str(c[7]).split(".")[1],
        c[8], c[9], c[10], c[11], c[12]) for c in host_emu.NC_CASES])
def test_nc_kernel_on_host_emulation(case, host_nc):
    """The emulated kernel against the plain version, y bitwise equal over
    two launches, and the split-K tile counters back at 0 after each."""
    n, h, cin, cout, k, s, p, dtype, relu, pro, stats, tile, splits = case
    x, w, sc, sh = host_emu.nc_inputs(n, h, cin, cout, k, dtype,
                                      torch.Generator().manual_seed(3))
    y, ysum, ysq, plan = host_emu.nc_on_host(host_nc, x, w, sc, sh, k, s, p,
                                             relu, pro, stats, tile, splits)
    y2, _, _, _ = host_emu.nc_on_host(host_nc, x, w, sc, sh, k, s, p, relu,
                                      pro, stats, tile, splits)
    want, _, _ = pnc.norm_conv_ref(x, w, sc, sh, k, s, p, relu, pro, False)
    assert y.dtype == dtype and y.shape == want.shape
    assert torch.isfinite(y).all()
    assert _rel(y, want) <= Y_TOL[dtype]
    assert torch.equal(y, y2)
    if stats:
        ws, wq = _stats_ref(x, w, sc.to(dtype), sh.to(dtype), k, s, p, relu,
                            pro)
        assert _rel(ysum, ws) <= STATS_TOL and _rel(ysq, wq) <= STATS_TOL
    else:
        assert ysum is None and ysq is None
    if splits:
        assert plan[0] == tile and plan[3] == splits
    if plan[3] > 1:
        cnt = pnc._counters[(torch.device("cpu"), None)]
        assert int(cnt.abs().sum()) == 0


def test_nc_emulation_covers_both_sides(host_nc):
    """The cases that take nc_plan's choice reach both tiles and both sides
    of the split-K choice; x and w are read both in 16-byte pieces and
    element by element."""
    plans, vecs = set(), set()
    for case in host_emu.NC_CASES:
        n, h, cin, cout, k, s, p, dtype = case[:8]
        x, w, sc, sh = host_emu.nc_inputs(n, h, cin, cout, k, dtype,
                                          torch.Generator().manual_seed(0))
        got = pnc.plan(host_nc, x.shape, w.shape, s, p, case[11], case[12])
        if case[11] < 0:
            plans.add((got[0], got[3] > 1))
        vecs.add(pnc.vec_flags(x, w, sc.to(dtype), sh.to(dtype)))
    assert plans == {(0, False), (0, True), (1, False)}
    assert {(1, 1), (0, 1), (0, 0)} <= vecs


def test_nc_plan_refuses_forced_choices(host_nc):
    """A tile past the two, or more slices than reduction steps, is refused
    rather than launched; one step a slice is the most."""
    with pytest.raises(MXNetError):
        pnc.plan(host_nc, (1, 4, 4, 16), (3, 3, 16, 8), 1, 1, 2, 1)
    with pytest.raises(MXNetError):
        pnc.plan(host_nc, (1, 4, 4, 16), (3, 3, 16, 8), 1, 1, 0, 10)
    assert pnc.plan(host_nc, (1, 4, 4, 16), (3, 3, 16, 8), 1, 1, 0, 9)[3] \
        == 9
