"""mxnet_tpu_torch's flash attention backward: the plain version (what the
wrapper runs for a CPU tensor) against mxnet_tpu's Pallas backward in
interpret mode (``_flash_bwd``) and its blocked XLA oracle
(``_flash_bwd_xla``); the ``FlashAttention`` autograd Function against
``jax.grad`` of the interpret-mode ``flash_attention``; and on the card the
dQ and dK/dV kernels against the plain version (skipped without one).

JAX is imported by the tests that compare with it, not by the module, so
that the ``cuda`` tests also run where only the port is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_backward.py``.
"""
import os
import types

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.bench import host_emu
from mxnet_tpu_torch.ops import attention as pattn
from mxnet_tpu_torch.ops import flash_attention as pfa
from mxnet_tpu_torch.ops import norm_conv as pnc
from mxnet_tpu_torch.ops.kernel_build import CSRC, c_argtypes

# float32 on both sides, sums taken in other orders (the JAX suite's
# forward tolerance, test_pallas.py)
RTOL, ATOL = 2e-4, 2e-5

# (T, causal, JAX block_q, block_k): the JAX suite's block aspect ratios,
# one and several blocks
CASES = [(t, causal, bq, bk) for t in (128, 384) for causal in (True, False)
         for bq, bk in ((64, 64), (64, 32), (32, 64))]
SHAPE = (1, 2, None, 32)


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, mxnet_tpu's pallas_kernels)."""
    return (pytest.importorskip("jax"), pytest.importorskip("jax.numpy"),
            pytest.importorskip("mxnet_tpu.ops.pallas_kernels"))


def _arrays(t, seed, n=4):
    rng = np.random.RandomState(seed)
    shape = SHAPE[:2] + (t,) + SHAPE[3:]
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=["T%d-%s-%d/%d" % (
    c[0], "causal" if c[1] else "full", c[2], c[3]) for c in CASES])
def test_plain_bwd_vs_pallas_interpret(case, jx):
    """The same residuals (o, lse from the interpret-mode forward) and the
    same dO into JAX's two Pallas backward kernels and the port's plain
    backward."""
    _, jnp, jpk = jx
    t, causal, bq, bk = case
    q, k, v, g = _arrays(t, seed=t + bq + 3 * bk + causal)
    out, res = jpk._flash_fwd(*[jnp.asarray(a) for a in (q, k, v)], causal,
                              None, bq, bk, True)
    want = jpk._flash_bwd(causal, None, bq, bk, True, res, jnp.asarray(g))
    o, lse = (np.asarray(x) for x in res[3:])
    before = (pfa.bwd_dq_launches, pfa.bwd_dkv_launches)
    got = pfa.flash_attention_bwd(*_t(q, k, v, o, lse, g), causal=causal)
    assert (pfa.bwd_dq_launches, pfa.bwd_dkv_launches) == before
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("t", [128, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_bwd_vs_blocked_xla(t, causal, jx):
    """Against the JAX package's blocked XLA backward, its oracle."""
    _, jnp, jpk = jx
    q, k, v, g = _arrays(t, seed=7 * t + causal)
    out, res = jpk._flash_fwd(*[jnp.asarray(a) for a in (q, k, v)], causal,
                              0.3, 64, 64, True)
    want = jpk._flash_bwd_xla(causal, 0.3, 64, 64, True, res,
                              jnp.asarray(g))
    o, lse = (np.asarray(x) for x in res[3:])
    got = pfa.flash_attention_bwd_ref(*_t(q, k, v, o, lse, g), causal, 0.3)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("causal,bq,bk", [(True, 64, 64), (False, 64, 32),
                                          (True, 32, 64)])
def test_function_grads_vs_jax_grad(causal, bq, bk, jx):
    """Gradients through ``flash_attention`` (the autograd Function) equal
    ``jax.grad`` of the interpret-mode Pallas ``flash_attention`` for one
    loss, sum(o * cos(q))."""
    jax, jnp, jpk = jx
    q, k, v = _arrays(128, seed=11 + bq + causal, n=3)

    def lf(q, k, v):
        return (jpk.flash_attention(q, k, v, causal, None, bq, bk, True)
                * jnp.cos(q)).sum()
    want = jax.grad(lf, argnums=(0, 1, 2))(*[jnp.asarray(a)
                                             for a in (q, k, v)])
    qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
    loss = (pfa.flash_attention(qt, kt, vt, causal=causal)
            * torch.cos(qt)).sum()
    loss.backward()
    for a, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_function_needs_input_grad_and_float64():
    """Only the inputs that ask for a gradient get one; float64 (the
    parity tests' dtype) runs the plain versions in float64, equal to
    autograd through the plain forward."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, 16)) for _ in range(3))
    q.requires_grad_(True)
    o = pfa.flash_attention(q, k, v, causal=True, scale=0.2)
    (dq,) = torch.autograd.grad(o.square().sum(), (q,))
    assert k.grad is None and v.grad is None and dq.dtype == torch.float64
    q2 = q.detach().clone().requires_grad_(True)
    o2, _ = pfa.flash_attention_ref(q2, k, v, True, 0.2)
    (want,) = torch.autograd.grad(o2.square().sum(), (q2,))
    torch.testing.assert_close(dq, want, rtol=1e-10, atol=1e-12)


def test_dot_product_attention_differentiates_both_rungs():
    """``dot_product_attention`` gives one gradient through the Function
    (impl='flash') and through ``attention_reference`` (impl='xla')."""
    rng = np.random.RandomState(4)
    base = [torch.from_numpy(rng.randn(2, 2, 128, 8)) for _ in range(3)]
    grads = []
    for impl in ("flash", "xla"):
        ins = [x.clone().requires_grad_(True) for x in base]
        out = pattn._dot_product_attention(*ins, causal=True, impl=impl)
        grads.append(torch.autograd.grad((out * out.cos()).sum(), ins))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-11)


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
    # the dK/dV kernel's D buckets (<= 64, <= 128, <= 256), each below and
    # at its top
    ((1, 2, 256, 32), True, None, torch.float32),
    ((1, 2, 256, 128), True, None, torch.float32),
    ((1, 2, 256, 128), False, None, torch.bfloat16),
    ((1, 2, 256, 136), True, None, torch.float32),
    ((1, 2, 384, 72), False, None, torch.bfloat16),
    # the dQ kernel's tilings: D = 16 (fewer 4-column pieces than the 16
    # thread columns), D = 96 (inside the D <= 128 bucket), and causal
    # T = 128 (two 64-query tiles, the diagonal inside each; at D = 256,
    # above, 32-query tiles against 64-key tiles)
    ((1, 2, 256, 16), True, None, torch.float32),
    ((1, 2, 256, 16), False, None, torch.bfloat16),
    ((1, 2, 256, 96), True, None, torch.float32),
    ((1, 2, 256, 96), False, 0.3, torch.bfloat16),
    ((2, 3, 128, 64), True, None, torch.float32),
    ((2, 3, 128, 64), True, None, torch.bfloat16),
    ((1, 2, 128, 128), True, None, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ON_CARD)
def test_kernels_vs_plain_on_card(case):
    dev = _card()
    shape, causal, scale, dtype = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                  for _ in range(4))
    o, lse = pfa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    before = (pfa.bwd_dq_launches, pfa.bwd_dkv_launches)
    got = pfa.flash_attention_bwd(q, k, v, o, lse, g, causal, scale)
    again = pfa.flash_attention_bwd(q, k, v, o, lse, g, causal, scale)
    assert (pfa.bwd_dq_launches, pfa.bwd_dkv_launches) == \
        (before[0] + 2, before[1] + 2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 reference
    try:
        want = pfa.flash_attention_bwd_ref(q, k, v, o, lse, g, causal, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, b)   # no atomics
        torch.testing.assert_close(a, w, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_kernels_on_card_unaligned_rows(d, dtype):
    """q, k, v and dO as views whose row stride (D + 2 elements) is not a
    multiple of 16 bytes: the dQ and the dK/dV kernels read them element by
    element (``aligned16`` is false) and still equal the plain version."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn(4, 2, 3, 256, d + 2, device=dev,
                       generator=gen).to(dtype)
    q, k, v, g = (base[i, ..., :d] for i in range(4))
    assert not pfa.aligned16(q, k, v, g)
    o, lse = pfa.flash_attention_fwd(q, k, v, causal=True)
    got = pfa.flash_attention_bwd(q, k, v, o, lse, g, True)
    again = pfa.flash_attention_bwd(q, k, v, o, lse, g, True)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = pfa.flash_attention_bwd_ref(q, k, v, o, lse, g, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, b)
        torch.testing.assert_close(a, w, **tol)


def test_aligned16_reads_base_and_strides():
    """The backward kernels' 16-byte flag: true for contiguous and LM-strided
    tensors, false when the base or a row stride breaks 16 bytes."""
    x = torch.zeros(2, 3, 128, 64)
    qkv = torch.zeros(2, 128, 3, 3, 64).permute(2, 0, 3, 1, 4)
    assert pfa.aligned16(x) and pfa.aligned16(qkv[1], qkv[2])
    assert pfa.aligned16(x.to(torch.bfloat16))
    assert not pfa.aligned16(torch.zeros(2, 3, 128, 66)[..., :64])
    assert not pfa.aligned16(torch.zeros(2, 3, 128, 65)[..., 1:])
    assert not pfa.aligned16(torch.zeros(2, 3, 128, 68,
                                         dtype=torch.bfloat16)[..., :64])


@pytest.fixture(scope="module")
def host_bwd(tmp_path_factory):
    """``csrc/flash_attention_bwd.cu`` compiled for the CPU through
    ``bench/host_emu.h``."""
    return host_emu.host_library(os.path.join(CSRC, "flash_attention_bwd.cu"),
                                 str(tmp_path_factory.mktemp("host_emu")))


@pytest.mark.parametrize("case", host_emu.CASES, ids=[
    "%s-%s-%s-%s" % (c[0], "causal" if c[1] else "full",
                     str(c[2]).split(".")[1], c[3]) for c in host_emu.CASES])
def test_bwd_kernels_on_host_emulation(case, host_bwd):
    """The CUDA source of the dQ and dK/dV kernels, run on the CPU (one
    thread per CUDA thread, ``bench/host_emu.py``), against the plain
    backward: every D bucket of both tilings and both sides of the dQ
    kernel's choice by grid size (the emulated card has 4 SMs), causal and
    full, float32 and bfloat16, rows read in 16-byte pieces and element by
    element."""
    shape, causal, dtype, layout = case
    q, k, v, g = host_emu.inputs(shape, dtype, layout,
                                 torch.Generator().manual_seed(5))
    o, lse = pfa.flash_attention_ref(q, k, v, causal)
    got = host_emu.bwd_on_host(host_bwd, q, k, v, o, lse, g, causal)
    want = pfa.flash_attention_bwd_ref(q, k, v, o, lse, g, causal)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, w, **tol)


LAUNCHERS = [(pfa._bind, "flash_attention", "flash_fwd_launch"),
             (pfa._bind, "flash_attention", "flash_fwd_plan"),
             (pfa._bind_bwd, "flash_attention_bwd", "flash_bwd_dq_launch"),
             (pfa._bind_bwd, "flash_attention_bwd", "flash_bwd_dkv_launch"),
             (pnc._bind, "norm_conv", "nc_launch"),
             (pnc._bind, "norm_conv", "nc_plan")]


@pytest.mark.parametrize("bind,stem,name", LAUNCHERS,
                         ids=[c[2] for c in LAUNCHERS])
def test_ctypes_binding_matches_the_launcher(bind, stem, name):
    """The argtypes that a wrapper's bind function sets equal, in number and
    type, the parameters of the ``extern "C"`` launcher in its source: with
    a parameter too many or too few ctypes passes garbage silently (the dQ
    launcher's alignment flag, added after the dK/dV one's, is such a
    parameter)."""
    with open(os.path.join(CSRC, stem + ".cu")) as f:
        want = c_argtypes(f.read(), name)
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                   for _, _, n in LAUNCHERS})
    bind(lib)
    got = getattr(lib, name).argtypes
    assert len(got) == len(want)
    assert [t.__name__ for t in got] == [t.__name__ for t in want]


@pytest.mark.cuda
def test_function_on_card_strided_and_counted():
    """q, k, v as the LM makes them (slices of one transposed projection)
    and a loss through the LM's output transpose: the Function launches the
    forward once and each backward kernel once, and its gradients equal
    autograd through the plain forward."""
    dev = _card()
    b, t, h, d = 2, 256, 3, 64
    base = torch.randn(b, t, 3, h, d, device=dev)
    grads = []
    for flash in (True, False):
        x = base.clone().requires_grad_(True)
        qkv = x.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        counts = (pfa.launches, pfa.bwd_dq_launches, pfa.bwd_dkv_launches)
        o = pfa.flash_attention(q, k, v, causal=True) if flash else \
            pfa.flash_attention_ref(q, k, v, True)[0]
        y = o.transpose(1, 2).reshape(b * t, h * d)
        (gx,) = torch.autograd.grad((y * y.cos()).sum(), (x,))
        grads.append(gx)
        delta = (pfa.launches - counts[0], pfa.bwd_dq_launches - counts[1],
                 pfa.bwd_dkv_launches - counts[2])
        assert delta == ((1, 1, 1) if flash else (0, 0, 0))
    torch.testing.assert_close(grads[0], grads[1], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_bwd_refuses_what_the_guard_rejects_on_card():
    """A CUDA tensor the kernels do not take raises; nothing falls back to
    the plain version."""
    dev = _card()
    q = torch.randn(1, 2, 200, 64, device=dev)
    lse = torch.zeros(1, 2, 200, 1, device=dev)
    with pytest.raises(MXNetError, match="flash_available"):
        pfa.flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.randn(1, 2, 256, 64, device=dev, dtype=torch.float64)
    lse = torch.zeros(1, 2, 256, 1, device=dev, dtype=torch.float64)
    with pytest.raises(MXNetError, match="flash_available"):
        pfa.flash_attention_bwd(q, q, q, q, lse, q)
