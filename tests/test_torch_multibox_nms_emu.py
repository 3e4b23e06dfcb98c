"""mxnet_tpu_torch MultiBoxDetection's NMS: the two kernels of the CUDA
source ``csrc/multibox_nms.cu`` (the suppression mask, then the scan) run
on the CPU through ``bench/host_emu.h`` (one std::thread per CUDA thread,
blocks in order) against the plain version ``greedy_nms_ref``, at the
cases of ``host_emu.NMS_CASES``: several images, 1 to 2,200 rows (row
counts inside a 64-row word, the SSD's 21 words, more words than a scan
cut down to 64 threads has threads for and stages), rows in several
bands, every box of a
class suppressed, ``force_suppress``, IoUs exactly at the threshold, a
workspace
filled with all-ones bits, float32 and float64.  The ids must match
exactly.  Also: the emulated warp intrinsics the scan uses against their
definitions, and the band plan.

On the card (``cuda`` marker): the kernels through ``contrib.greedy_nms``
against ``greedy_nms_ref`` on the same CUDA tensors, two launches a band,
and the wrapper's refusals.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.bench import host_emu
from mxnet_tpu_torch.ops import contrib
from mxnet_tpu_torch.ops.kernel_build import CudaLibrary

IDS = [host_emu.nms_case_id(c) for c in host_emu.NMS_CASES]


@pytest.fixture(scope="module")
def host_nms(tmp_path_factory):
    """{small_scan: ``csrc/multibox_nms.cu`` compiled for the CPU through
    ``bench/host_emu.h``}, each built at its first case."""
    out = str(tmp_path_factory.mktemp("host_emu"))
    libs = {}

    def get(small_scan):
        if small_scan not in libs:
            libs[small_scan] = host_emu.nms_library(out, small_scan)
        return libs[small_scan]
    return get


@pytest.mark.parametrize("case", host_emu.NMS_CASES, ids=IDS)
def test_nms_kernel_on_host_emulation(case, host_nms):
    """The emulated kernel's ids equal greedy_nms_ref's, and the case
    exercises what it names."""
    opts = dict(case[7])
    small = opts.pop("small_scan", False)
    boxes, ids = host_emu.nms_inputs(case, torch.Generator().manual_seed(7))
    got = host_emu.nms_on_host(host_nms(small), boxes, ids, case[4],
                               case[5], **opts)
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
    words = -(-case[1] // 64)
    if "band_rows" in opts:
        assert words * 64 > opts["band_rows"]
    if small:   # a scan thread folds several words: two word slots; some
        # words past the staged ones
        assert words - 2 > (host_emu.SMALL_SCAN_THREADS - 32) // 16
        assert words > host_emu.SMALL_SCAN_STAGE + 2


def test_nms_band_plan(monkeypatch):
    """One band at the SSD's shapes; at SSD300's anchor count and batch 32
    the mask is banded within NMS_WORKSPACE_BYTES; every band a multiple
    of 64 rows that covers the rows once; a smaller workspace bands
    smaller cases, and the band is at least 64 rows."""
    assert contrib.nms_plan(8, 1344) == (21, 1344, 1)
    words, rows, bands = contrib.nms_plan(32, 8732)
    assert words == 137 and rows % 64 == 0 and bands == 2
    assert 32 * rows * words * 8 <= contrib.NMS_WORKSPACE_BYTES
    assert (bands - 1) * rows < 8732 <= bands * rows
    assert contrib.nms_plan(1, 1) == (1, 64, 1)
    monkeypatch.setattr(contrib, "NMS_WORKSPACE_BYTES",
                        host_emu.nms_band_bytes(2, 300, 128))
    assert contrib.nms_plan(2, 300) == (5, 128, 3)
    monkeypatch.setattr(contrib, "NMS_WORKSPACE_BYTES", 8)
    assert contrib.nms_plan(2, 300) == (5, 64, 5)


WARP_OPS = r"""#include <cuda_runtime.h>
template <int K>
__global__ void warp_ops(const unsigned* in, unsigned* out) {
  const unsigned t = threadIdx.x, lane = t & 31u;
  const unsigned v = in[t];
  unsigned* o = out + 6 * t;
  o[0] = __shfl_sync(0xffffffffu, v, (int)((lane * 7u + 3u) & 31u));
  const unsigned long long w = (unsigned long long)v << 32 | (v ^ 0x5a5a5a5au);
  const unsigned long long s = __shfl_sync(0xffffffffu, w, (int)(31u - lane));
  o[1] = (unsigned)s;
  o[2] = (unsigned)(s >> 32);
  o[3] = __ballot_sync(0xffffffffu, (int)(v & 1u));
  o[4] = __reduce_or_sync(0xffffffffu, v & (1u << (v % 32u)));
  o[5] = (unsigned)__ffsll((long long)(v & 0xfffu) << 40);
}
extern "C" int warp_ops_launch(const void* in, void* out, int threads,
                               void* stream) {
  warp_ops<0><<<1, threads, 0, (cudaStream_t)stream>>>((const unsigned*)in,
                                                     (unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def test_emulated_warp_intrinsics(tmp_path):
    """__shfl_sync (32- and 64-bit), __ballot_sync, __reduce_or_sync and
    __ffsll of bench/host_emu.h against their definitions, on two
    warps."""
    cu = tmp_path / "warp_ops.cu"
    cu.write_text(WARP_OPS)
    lib = host_emu.host_library(str(cu), str(tmp_path))
    threads = 64
    v = np.random.RandomState(3).randint(0, 2 ** 32, threads,
                                         dtype=np.uint64).astype(np.uint32)
    v[5] = 0                                # ffs of 0 is 0
    inp = torch.from_numpy(v.view(np.int32).copy())
    out = torch.zeros(6 * threads, dtype=torch.int32)
    assert lib.warp_ops_launch(inp.data_ptr(), out.data_ptr(), threads,
                               None) == 0
    got = out.numpy().view(np.uint32).reshape(threads, 6).astype(np.uint64)
    for t in range(threads):
        base, lane = t & ~31, t & 31
        warp = v[base:base + 32].astype(np.uint64)
        w = (warp << np.uint64(32)) | (warp ^ np.uint64(0x5a5a5a5a))
        assert got[t, 0] == warp[(lane * 7 + 3) & 31]
        assert got[t, 1] == w[31 - lane] & np.uint64(0xffffffff)
        assert got[t, 2] == w[31 - lane] >> np.uint64(32)
        assert got[t, 3] == sum(int(x & 1) << i for i, x in enumerate(warp))
        assert got[t, 4] == np.bitwise_or.reduce(
            [int(x) & (1 << (int(x) % 32)) for x in warp])
        x = (int(v[t]) & 0xfff) << 40
        assert got[t, 5] == ((x & -x).bit_length() if x else 0)


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
def test_nms_kernel_on_card(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    boxes, ids = host_emu.nms_inputs(case, torch.Generator().manual_seed(7))
    boxes, ids = boxes.cuda(), ids.cuda()
    before = contrib.nms_launches
    got = contrib.greedy_nms(boxes, ids, case[4], case[5])
    assert contrib.nms_launches \
        == before + 2 * contrib.nms_plan(case[0], case[1])[2]
    want = contrib.greedy_nms_ref(boxes, ids, case[4], case[5])
    assert torch.equal(got, want)
    opts = dict(case[7])
    if opts:    # the case's bands, workspace fill and cut-down scan
        lib = contrib._kernel.get()
        if opts.pop("small_scan", False):
            lib = CudaLibrary("multibox_nms_small", contrib._bind,
                              text=host_emu.nms_small_source(),
                              flags=["--fmad=false"]).get()
        if "band_rows" in opts:
            monkeypatch.setattr(contrib, "NMS_WORKSPACE_BYTES",
                                host_emu.nms_band_bytes(case[0], case[1],
                                                        opts["band_rows"]))
        words, rows, _ = contrib.nms_plan(case[0], case[1])
        ws = None if "fill" not in opts else torch.full(
            (case[0] * (rows + 1) * words,), opts["fill"], dtype=torch.int64,
            device="cuda")
        out = ids.clone()
        contrib.nms_launch(lib, boxes, out, case[4], case[5],
                           torch.cuda.current_stream().cuda_stream, ws,
                           contrib._kernel.check)
        assert torch.equal(out, want)


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
