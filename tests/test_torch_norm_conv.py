"""mxnet_tpu_torch NormConv: the plain version (what the wrapper runs for a
CPU tensor) against mxnet_tpu's Pallas kernel in interpret mode over the
geometries of test_norm_conv.py, the shape guard, and the CUDA kernel
against the plain version on the card (skipped without one).

JAX is imported by the tests that compare with it, not by the module, so
that the ``cuda`` tests also run where only the port is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_norm_conv.py``.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import norm_conv as pnc
from test_torch_threads import torch_threads_per_worker  # noqa: F401

GEOMS = [
    # H, K, S, P, Cin, Cout, relu, prologue, stats (test_norm_conv.GEOMS)
    (8, 3, 1, 1, 16, 32, True, True, True),
    (8, 3, 2, 1, 16, 32, True, True, False),
    (8, 1, 1, 0, 16, 32, False, False, True),
    (9, 1, 2, 0, 16, 24, True, True, True),
    (7, 3, 2, 1, 16, 16, True, True, True),
    # 3x3 with pad 0, odd H, stride 1 and 2 (Inception-v3's conv_1, conv_4
    # and its stride-2 reductions)
    (9, 3, 1, 0, 32, 32, True, True, True),
    (11, 3, 2, 0, 16, 24, True, True, True),
]


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, mxnet_tpu's pallas_conv)."""
    return (pytest.importorskip("jax"), pytest.importorskip("jax.numpy"),
            pytest.importorskip("mxnet_tpu.ops.pallas_conv"))


def _inputs(geom, dtype=np.float32):
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, h, cin).astype(dtype)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(dtype)
    sc = (rng.rand(cin) + 0.5).astype(dtype)
    sh = rng.randn(cin).astype(dtype)
    return x, w, sc, sh


def _port(geom, arrays):
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    return pnc.norm_conv(*[torch.from_numpy(a) for a in arrays], kernel=k,
                         stride=s, pad=p, relu=relu, prologue=prologue,
                         stats=stats)


@pytest.mark.parametrize("geom", GEOMS)
def test_plain_vs_pallas_interpret(geom, jx):
    _, jnp, jnc = jx
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    arrays = _inputs(geom)
    yj, sj, qj = jnc.norm_conv(*[jnp.asarray(a) for a in arrays], kernel=k,
                               stride=s, pad=p, relu=relu, prologue=prologue,
                               stats=stats, use_pallas=True, interpret=True)
    before = pnc.launches
    yp, sp, qp = _port(geom, arrays)
    assert pnc.launches == before            # a CPU tensor never launches
    assert yp.dtype == torch.float32 and tuple(yp.shape) == yj.shape
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=2e-5,
                               atol=2e-5)
    if stats:
        np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(qp.numpy(), np.asarray(qj), rtol=2e-4,
                                   atol=2e-4)
    else:
        assert sp is None and qp is None


@pytest.mark.parametrize("geom", GEOMS)
def test_plain_vs_reference_f64(geom, jx):
    """In float64 the plain version equals mxnet_tpu's XLA composition."""
    jax, jnp, jnc = jx
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    arrays = _inputs(geom, np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        yj, sj, qj = jnc.norm_conv(*[jnp.asarray(a) for a in arrays],
                                   kernel=k, stride=s, pad=p, relu=relu,
                                   prologue=prologue, stats=stats,
                                   use_pallas=False)
        yj, sj, qj = (None if v is None else np.asarray(v)
                      for v in (yj, sj, qj))
    finally:
        jax.config.update("jax_enable_x64", False)
    yp, sp, qp = _port(geom, arrays)
    assert yp.dtype == torch.float64
    np.testing.assert_allclose(yp.numpy(), yj, rtol=1e-9, atol=1e-9)
    if stats:
        np.testing.assert_allclose(sp.numpy(), sj, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(qp.numpy(), qj, rtol=1e-9, atol=1e-9)


def test_prologue_pads_after_apply():
    """An out-of-bounds tap contributes 0, not relu(shift): with x = 0 and
    shift = 1 every in-bounds tap is 1, so a corner output of a 3x3 pad-1
    all-ones conv sums 4 taps, not 9."""
    x = torch.zeros(1, 4, 4, 2)
    w = torch.ones(3, 3, 2, 1)
    y, _, _ = pnc.norm_conv(x, w, torch.ones(2), torch.ones(2), 3, 1, 1)
    assert y[0, 0, 0, 0].item() == 8.0       # 4 taps x 2 channels
    assert y[0, 1, 1, 0].item() == 18.0      # 9 taps x 2 channels


def test_available_guard():
    # every ResNet-50 geometry, however large: tiles do not grow with H, W
    assert pnc.norm_conv_available((8, 56, 56, 64), (3, 3, 64, 64),
                                   (1, 1), (1, 1))
    assert pnc.norm_conv_available((8, 56, 56, 256), (1, 1, 256, 512),
                                   (2, 2), (0, 0))
    assert pnc.norm_conv_available((1, 224, 224, 512), (3, 3, 512, 512),
                                   (1, 1), (1, 1))
    assert pnc.norm_conv_available((8, 7, 7, 2048), (1, 1, 2048, 512),
                                   (1, 1), (0, 0), dtype=torch.bfloat16)
    # the peephole admits pad 1 on a 1x1 kernel and any channel count
    assert pnc.norm_conv_available((2, 8, 8, 3), (1, 1, 3, 5), (1, 1),
                                   (1, 1))
    # stem, 5x5, stride 3, uneven pad, channel mismatch, float64 -> not
    # the kernel
    assert not pnc.norm_conv_available((8, 224, 224, 3), (7, 7, 3, 64),
                                       (2, 2), (3, 3))
    assert not pnc.norm_conv_available((8, 28, 28, 64), (5, 5, 64, 64),
                                       (1, 1), (2, 2))
    assert not pnc.norm_conv_available((8, 28, 28, 64), (3, 3, 64, 64),
                                       (3, 3), (1, 1))
    assert not pnc.norm_conv_available((8, 28, 28, 64), (3, 3, 64, 64),
                                       (1, 1), (1, 0))
    assert not pnc.norm_conv_available((8, 28, 28, 32), (3, 3, 64, 64),
                                       (1, 1), (1, 1))
    assert not pnc.norm_conv_available((8, 28, 28, 64), (3, 3, 64, 64),
                                       (1, 1), (1, 1), dtype=torch.float64)


@pytest.mark.parametrize("attrs,fused", [
    (dict(kernel=(3, 3), pad=(1, 1)), True),
    (dict(kernel=(1, 1), stride=(2, 2)), True),
    (dict(kernel=(1, 1), pad=(1, 1)), True),
    (dict(kernel=(5, 5), pad=(2, 2)), False),
    (dict(kernel=(3, 3), stride=(3, 3)), False),
    (dict(kernel=(3, 3), pad=(1, 1), num_group=2), False),
    (dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2)), False),
    (dict(kernel=(3, 3), pad=(1, 1), no_bias=False), False),
])
def test_peephole_uses_the_kernel_rule(attrs, fused):
    """The executor fuses a convolution exactly when the kernel's geometry
    rule admits it and the graph has no grouping, dilation or bias."""
    from mxnet_tpu_torch import symbol as psym
    from mxnet_tpu_torch.executor import _Lowered
    kw = dict(dict(num_filter=4, no_bias=True), **attrs)
    bn = psym.BatchNorm(data=psym.Variable("data"), name="bn")
    conv = psym.Convolution(data=bn, name="conv", **kw)
    low = _Lowered(conv)
    node = conv._outputs[0][0]
    assert (low._nc_conv_attrs(node) is not None) == fused
    assert (id(node) in low.nc_conv) == fused


@pytest.mark.cuda
@pytest.mark.parametrize("geom", GEOMS)
def test_kernel_vs_plain_on_card(geom):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, k, s, p, cin, cout, relu, prologue, stats = geom
    dev = torch.device("cuda", 0)
    arrays = [torch.from_numpy(a).to(dev) for a in _inputs(geom)]
    kw = dict(kernel=k, stride=s, pad=p, relu=relu, prologue=prologue,
              stats=stats)
    before = pnc.launches
    yk, sk, qk = pnc.norm_conv(*arrays, **kw)
    assert pnc.launches == before + 1
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # full float32 reference
    try:
        yp, sp, qp = pnc.norm_conv_ref(*arrays, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    torch.testing.assert_close(yk, yp, rtol=2e-5, atol=2e-5)
    if stats:
        torch.testing.assert_close(sk, sp, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(qk, qp, rtol=2e-4, atol=2e-4)
    with pytest.raises(MXNetError):          # float64 is not the kernel's
        pnc.norm_conv(*[a.double() for a in arrays], **kw)
