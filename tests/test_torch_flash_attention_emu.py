"""mxnet_tpu_torch flash-attention forward: the CUDA source
``csrc/flash_attention.cu`` run on the CPU through ``bench/host_emu.h`` (one
std::thread per CUDA thread, blocks in order, warp shuffles through a
per-warp barrier; the emulated card has 4 SMs) against the plain version
``flash_attention_ref``, at the small shapes of ``host_emu.FWD_CASES``:
every D bucket and both sides of the tile choice by grid size, causal and
full, a given scale, rows read in 16-byte pieces and element by element,
float32 and bfloat16.
"""
import os

import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.bench import host_emu
from mxnet_tpu_torch.ops import flash_attention as pfa
from mxnet_tpu_torch.ops.kernel_build import CSRC
from test_torch_threads import torch_threads_per_worker  # noqa: F401

# max |o_kernel - o_plain| over max |o_plain|, as chip_smoke.py's O_TOL:
# float32 sums in another order; bfloat16 rounds o once from float32 sums
O_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# max |lse_kernel - lse_plain| over max(1, max |lse_plain|) (LSE_TOL)
LSE_TOL = 1e-4


@pytest.fixture(scope="module")
def host_fwd(tmp_path_factory):
    """``csrc/flash_attention.cu`` compiled for the CPU through
    ``bench/host_emu.h``."""
    return host_emu.host_library(os.path.join(CSRC, "flash_attention.cu"),
                                 str(tmp_path_factory.mktemp("host_emu")))


@pytest.mark.parametrize("case", host_emu.FWD_CASES, ids=[
    "%s-%s-%s-%s-scale%s" % (c[0], "causal" if c[1] else "full",
                             str(c[2]).split(".")[1], c[3], c[4])
    for c in host_emu.FWD_CASES])
def test_fwd_kernel_on_host_emulation(case, host_fwd):
    """The emulated kernel against the plain version; o and lse bitwise
    equal over two launches."""
    shape, causal, dtype, layout, scale = case
    q, k, v, _ = host_emu.inputs(shape, dtype, layout,
                                 torch.Generator().manual_seed(7))
    o, lse, plan = host_emu.fwd_on_host(host_fwd, q, k, v, causal, scale)
    o2, lse2, _ = host_emu.fwd_on_host(host_fwd, q, k, v, causal, scale)
    want, wlse = pfa.flash_attention_ref(q, k, v, causal, scale)
    assert o.dtype == dtype and o.shape == want.shape
    assert lse.dtype == torch.float32 and lse.shape == wlse.shape
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    err = (o.float() - want.float()).abs().max()
    assert err <= O_TOL[dtype] * want.float().abs().max()
    assert (lse - wlse).abs().max() <= LSE_TOL * max(1.0,
                                                     wlse.abs().max().item())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert plan[4] >= shape[3]          # the tile's D bucket holds D


def test_fwd_emulation_covers_every_tile_and_load_path(host_fwd):
    """FWD_CASES reach all six tiles (both sides of the grid choice in each
    D bucket) and both the 16-byte and the element-wise loads, in both
    dtypes."""
    tiles, paths = set(), set()
    for shape, causal, dtype, layout, _ in host_emu.FWD_CASES:
        q, k, v, _ = host_emu.inputs(shape, dtype, layout,
                                     torch.Generator().manual_seed(0))
        tiles.add(pfa.fwd_plan(shape, host_fwd)[0])
        paths.add((pfa.aligned16(q, k, v), dtype))
    assert tiles == {0, 1, 2, 3, 4, 5}
    assert paths == {(v, d) for v in (True, False)
                     for d in (torch.float32, torch.bfloat16)}


def test_fwd_plan_by_d_and_grid(host_fwd):
    """The plan: the D bucket picks the tile, and a grid of fewer 64-query
    blocks than SMs (4 here) the bucket's small-grid tile; each tile's
    shared memory (and the 1 KB the card reserves a block) fits its blocks
    an SM."""
    want = {(1, 1, 128, 64): (1, 128, 32, 64, 64, 2, 2),
            (2, 1, 128, 64): (0, 128, 64, 32, 64, 3, 2),
            (1, 1, 128, 72): (3, 128, 32, 64, 128, 1, 2),
            (1, 1, 256, 128): (2, 128, 64, 32, 128, 2, 2),
            (1, 1, 128, 256): (5, 256, 32, 64, 256, 1, 1),
            (8, 8, 1024, 256): (4, 256, 32, 32, 256, 2, 1)}
    for shape, plan in want.items():
        assert pfa.fwd_plan(shape, host_fwd) == plan
        _, nth, bq, bk, dmax, blocks, bufs = plan
        smem = 4 * ((bq + 2 * bufs * bk) * (dmax + 4) + bk * (bq + 4)
                    + 2 * bq)
        assert (smem + 1024) * blocks <= 228 * 1024


@pytest.mark.parametrize("shape", [(1, 1, 128, 12), (1, 1, 128, 264),
                                   (1, 1, 96, 64), (0, 1, 128, 64)])
def test_fwd_plan_and_launch_refuse_bad_shapes(shape, host_fwd):
    """D not a multiple of 8 or over 256, T not a multiple of 64, or an
    empty batch: the plan raises and the launcher refuses."""
    with pytest.raises(MXNetError):
        pfa.fwd_plan(shape, host_fwd)
    q = torch.zeros(max(shape[0], 1), *shape[1:])
    with pytest.raises(MXNetError):
        host_emu.fwd_on_host(host_fwd, q[:shape[0]], q[:shape[0]],
                             q[:shape[0]])
