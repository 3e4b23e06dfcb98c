"""mxnet_tpu_torch MultiBoxDetection's NMS: the CUDA source
``csrc/multibox_nms.cu`` run on the CPU through ``bench/host_emu.h`` (one
std::thread per CUDA thread, blocks in order) against the plain version
``greedy_nms_ref``, at the cases of ``host_emu.NMS_CASES``: several
images, 300 rows (two rounds of the 256-thread block, not a multiple of
it), every box of a class suppressed, ``force_suppress``, IoUs exactly at
the threshold, float32 and float64.  The ids must match exactly.

On the card (``cuda`` marker): the kernel through ``contrib.greedy_nms``
against ``greedy_nms_ref`` on the same CUDA tensors, one launch a call,
and the wrapper's refusals.
"""
import os

import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.bench import host_emu
from mxnet_tpu_torch.ops import contrib
from mxnet_tpu_torch.ops.kernel_build import CSRC

IDS = ["%dx%d-c%d-%s-t%.3f-f%d-%s" % (c[0], c[1], c[2], c[3], c[4], c[5],
                                      str(c[6]).split(".")[1])
       for c in host_emu.NMS_CASES]


@pytest.fixture(scope="module")
def host_nms(tmp_path_factory):
    """``csrc/multibox_nms.cu`` compiled for the CPU through
    ``bench/host_emu.h``."""
    return host_emu.host_library(os.path.join(CSRC, "multibox_nms.cu"),
                                 str(tmp_path_factory.mktemp("host_emu")))


@pytest.mark.parametrize("case", host_emu.NMS_CASES, ids=IDS)
def test_nms_kernel_on_host_emulation(case, host_nms):
    """The emulated kernel's ids equal greedy_nms_ref's, and the case
    exercises what it names."""
    boxes, ids = host_emu.nms_inputs(case, torch.Generator().manual_seed(7))
    got = host_emu.nms_on_host(host_nms, boxes, ids, case[4], case[5])
    want = contrib.greedy_nms_ref(boxes, ids, case[4], case[5])
    assert torch.equal(got, want)
    alive = ids >= 0
    if case[3] == "same":     # one box: one row a class survives (any class
        # under force_suppress) in each image
        per = 1 if case[5] else case[2]
        assert ((want >= 0).sum(1) <= per).all()
    elif case[1] >= 64:       # the larger cases suppress some rows
        assert ((want >= 0) & alive).sum() < alive.sum()
    if case[3] == "tie":      # some pair sits exactly at the threshold
        iou = contrib._iou_matrix(boxes, boxes)
        assert (iou == torch.tensor(case[4], dtype=boxes.dtype)).any()


def test_nms_plain_version_mirrors_the_loop():
    """greedy_nms_ref against a per-row Python loop of _greedy_nms's rule
    on one image."""
    boxes, ids = host_emu.nms_inputs(host_emu.NMS_CASES[0],
                                     torch.Generator().manual_seed(1))
    got = contrib.greedy_nms_ref(boxes, ids, 0.5)
    b, n = ids.shape
    want = ids.clone()
    iou = contrib._iou_matrix(boxes, boxes)
    for k in range(b):
        for i in range(n):
            if want[k, i] < 0:
                continue
            for j in range(i + 1, n):
                if want[k, j] >= 0 and want[k, j] == want[k, i] \
                        and iou[k, i, j] >= 0.5:
                    want[k, j] = -1
    assert torch.equal(got, want)


def test_nms_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    boxes, ids = host_emu.nms_inputs(host_emu.NMS_CASES[6],
                                     torch.Generator().manual_seed(2))
    before = contrib.nms_launches
    got = contrib.greedy_nms(boxes, ids, 0.5)
    assert torch.equal(got, contrib.greedy_nms_ref(boxes, ids, 0.5))
    assert contrib.nms_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", host_emu.NMS_CASES, ids=IDS)
def test_nms_kernel_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    boxes, ids = host_emu.nms_inputs(case, torch.Generator().manual_seed(7))
    boxes, ids = boxes.cuda(), ids.cuda()
    before = contrib.nms_launches
    got = contrib.greedy_nms(boxes, ids, case[4], case[5])
    assert contrib.nms_launches == before + 1
    want = contrib.greedy_nms_ref(boxes, ids, case[4], case[5])
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms_wrapper_refusals_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    boxes, ids = host_emu.nms_inputs(host_emu.NMS_CASES[0],
                                     torch.Generator().manual_seed(7))
    with pytest.raises(MXNetError):
        contrib.greedy_nms(boxes.cuda().half(), ids.cuda().half(), 0.5)
    with pytest.raises(MXNetError):
        contrib.greedy_nms(boxes.cuda(), ids.cuda().double(), 0.5)
