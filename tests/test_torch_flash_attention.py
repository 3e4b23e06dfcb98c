"""mxnet_tpu_torch flash attention: the plain version (what the wrapper runs
for a CPU tensor) against mxnet_tpu's Pallas kernel in interpret mode, for
both outputs; the shape guard against mxnet_tpu's; the rung
dot_product_attention takes; and the CUDA kernel against the plain version
on the card (skipped without one).

JAX is imported by the tests that compare with it, not by the module, so
that the ``cuda`` tests also run where only the port is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import attention as pattn
from mxnet_tpu_torch.ops import flash_attention as pfa
from test_torch_threads import torch_threads_per_worker  # noqa: F401

# the JAX suite's tolerance (test_pallas.py)
RTOL, ATOL = 2e-4, 2e-5

CASES = [
    # (B, H, T, D), causal, scale, JAX block_q, block_k
    ((2, 2, 256, 64), True, None, 128, 128),
    ((2, 2, 256, 64), False, None, 128, 128),
    ((1, 2, 384, 64), True, None, 128, 128),     # three 128-blocks
    ((1, 2, 384, 64), False, 0.3, 128, 128),
    ((1, 2, 256, 64), True, None, 64, 32),       # block aspect 64/32
    ((1, 2, 256, 72), True, None, 128, 128),     # D not a power of two
    ((1, 1, 256, 72), False, None, 64, 32),
]


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, mxnet_tpu's pallas_kernels)."""
    return (pytest.importorskip("jax.numpy"),
            pytest.importorskip("mxnet_tpu.ops.pallas_kernels"))


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("case", CASES,
                         ids=["%s-%s-%s-%d/%d" % (c[0], "causal" if c[1]
                                                  else "full", c[2], c[3],
                                                  c[4]) for c in CASES])
def test_plain_vs_pallas_interpret(case, jx):
    jnp, jpk = jx
    shape, causal, scale, bq, bk = case
    arrays = _qkv(shape, seed=shape[2] + shape[3])
    oj, lj = jpk._flash_fwd_impl(*[jnp.asarray(a) for a in arrays], causal,
                                 scale, bq, bk, True)
    before = pfa.launches
    op, lp = pfa.flash_attention_fwd(*[torch.from_numpy(a) for a in arrays],
                                     causal=causal, scale=scale)
    assert pfa.launches == before            # a CPU tensor never launches
    assert op.dtype == torch.float32 and tuple(op.shape) == oj.shape
    assert lp.dtype == torch.float32 and tuple(lp.shape) == lj.shape
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    o_only = pfa.flash_attention(*[torch.from_numpy(a) for a in arrays],
                                 causal=causal, scale=scale)
    assert torch.equal(o_only, op)


GUARD = [
    (2, 2, 1024, 64), (2, 2, 100, 64), (2, 2, 1024, 300), (2, 1024, 64),
    (1, 12, 1024, 64), (1, 1, 128, 8), (1, 1, 64, 64), (1, 1, 384, 72),
    (1, 1, 256, 12), (1, 1, 512, 256), (1, 1, 512, 264), (4, 4, 0, 64),
    (1, 1, 2048, 128), (1, 1, 8192, 128),
]


@pytest.mark.parametrize("shape", GUARD)
def test_guard_matches_mxnet_tpu(shape, jx):
    jpk = jx[1]
    assert pfa.flash_available(shape) == jpk.flash_available(shape)


def test_guard_differences(jx):
    """The one intended difference is the TPU's VMEM clause: one head's K+V
    over 8 MB.  Beyond the JAX clauses the port admits float32 and bfloat16
    only, and cross-attention shapes are refused by both."""
    jpk = jx[1]
    big = (1, 1, 16384, 128)
    assert pfa.flash_available(big) and not jpk.flash_available(big)
    assert pfa.flash_available(big, dtype=torch.bfloat16)
    assert not pfa.flash_available(big, dtype=torch.float64)
    assert not pfa.flash_available(big, dtype=torch.float16)
    q, kv = (2, 2, 256, 64), (2, 2, 512, 64)
    assert not pfa.flash_available(q, kv, kv)
    assert not jpk.flash_available(q, kv, kv)


LM = (4, 12, 1024, 64)
RUNGS = [
    # impl, shape, dtype, is_cuda, flash?
    ("flash", (1, 1, 16, 8), torch.float64, False, True),
    ("flash", LM, torch.float32, True, True),
    ("xla", LM, torch.float32, True, False),
    ("xla", LM, torch.float32, False, False),
    ("auto", LM, torch.float32, True, True),
    ("auto", LM, torch.bfloat16, True, True),
    ("auto", LM, torch.float32, False, False),
    ("auto", (4, 12, 384, 64), torch.float32, True, False),    # T < 512
    ("auto", (4, 12, 512, 64), torch.float32, True, True),
    ("auto", (4, 12, 640, 64), torch.float32, True, True),
    ("auto", (4, 12, 576, 64), torch.float32, True, False),    # T % 128
    ("auto", (4, 12, 1024, 300), torch.float32, True, False),  # D > 256
    ("auto", LM, torch.float64, True, False),
    ("auto", LM, torch.float16, True, False),
]


@pytest.mark.parametrize("rung", RUNGS)
def test_use_flash_rungs(rung):
    impl, shape, dtype, is_cuda, want = rung
    assert pattn._use_flash(impl, shape, shape, shape, dtype,
                            is_cuda) is want


def test_use_flash_cross_attention_and_bad_impl():
    kv = (4, 12, 2048, 64)
    assert not pattn._use_flash("auto", LM, kv, kv, torch.float32, True)
    with pytest.raises(MXNetError, match="impl"):
        pattn._use_flash("pallas", LM, LM, LM, torch.float32, True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


ON_CARD = [
    # shape, causal, scale, dtype
    ((2, 3, 256, 64), True, None, torch.float32),
    ((2, 3, 256, 64), False, 0.3, torch.float32),
    ((1, 2, 384, 72), True, None, torch.float32),
    ((1, 2, 128, 256), True, None, torch.float32),
    ((1, 2, 256, 8), False, None, torch.float32),
    ((2, 3, 256, 64), True, None, torch.bfloat16),
    ((1, 2, 128, 256), False, None, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ON_CARD)
def test_kernel_vs_plain_on_card(case):
    dev = _card()
    shape, causal, scale, dtype = case
    q, k, v = [torch.from_numpy(a).to(dev, dtype) for a in _qkv(shape, 0)]
    before = pfa.launches
    ok, lk = pfa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    assert pfa.launches == before + 1
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 reference
    try:
        op, lp = pfa.flash_attention_ref(q, k, v, causal, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    assert ok.dtype == dtype and lk.dtype == torch.float32
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(ok, op, **tol)
    torch.testing.assert_close(lk, lp, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_reads_strided_views_on_card():
    """q, k and v as the LM makes them: slices of one transposed QKV
    projection, non-contiguous, read through their strides."""
    dev = _card()
    b, t, h, d = 2, 256, 3, 64
    qkv = torch.randn(b, t, 3, h, d, device=dev).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert not q.is_contiguous()
    ok, lk = pfa.flash_attention_fwd(q, k, v, causal=True)
    op, lp = pfa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                     v.contiguous(), True)
    torch.testing.assert_close(ok, op, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lk, lp, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_refuses_what_the_guard_rejects_on_card():
    """Under impl='flash' a CUDA tensor the kernel does not take raises;
    nothing falls back to the plain version."""
    dev = _card()
    q = torch.randn(1, 2, 256, 64, device=dev, dtype=torch.float64)
    with pytest.raises(MXNetError, match="flash_available"):
        pfa.flash_attention_fwd(q, q, q)
    q = torch.randn(1, 2, 200, 64, device=dev)
    op = pattn._dot_product_attention
    with pytest.raises(MXNetError, match="flash_available"):
        op(q, q, q, causal=True, impl="flash")
    before = pfa.launches
    out = op(q, q, q, causal=True, impl="auto")      # T < 512: reference
    assert pfa.launches == before and out.shape == q.shape
