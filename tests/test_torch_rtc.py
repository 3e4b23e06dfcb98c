"""mxnet_tpu_torch.rtc: the generated kernel signature and launcher for each
dtype, the argument and launch checks that raise before any card is
touched, the build cache key, the plain versions of the user kernels of
rtc_kernels.py against the JAX package's Rtc running the same computation as
a Pallas body in interpret mode, and (``cuda``-marked, skipped without a
card) the four user kernels pushed on the card against their plain versions.

JAX is imported by the tests that compare with it, not by the module, so
that the ``cuda`` tests also run where only the port is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_rtc.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, rtc
from mxnet_tpu_torch import rtc_kernels as rk
from mxnet_tpu_torch.ops.kernel_build import BUILD_DIR, CudaLibrary
from test_torch_threads import torch_threads_per_worker  # noqa: F401

DTYPES = [(torch.float32, "float"), (torch.float64, "double"),
          (torch.float16, "__half"), (torch.bfloat16, "__nv_bfloat16"),
          (torch.int32, "int"), (torch.int64, "long long"),
          (torch.uint8, "unsigned char")]
BODY = "  out[0] = x[0];"


def _cpu(a, dtype=np.float32):
    return mt.nd.array(np.asarray(a, dtype), ctx=mt.cpu(), dtype=dtype)


@pytest.mark.parametrize("dtype,ctype", DTYPES)
def test_generated_signature_and_launcher(dtype, ctype):
    src = mt.rtc.Rtc("k", ["x", "y"], ["out"], BODY).source(
        [dtype, torch.float32], [dtype])
    assert 'extern "C" __global__ void k(const %s* x, const float* y, ' \
        '%s* out) {\n%s\n}' % (ctype, ctype, BODY) in src
    assert 'extern "C" int k_launch(const void* a0, const void* a1, ' \
        'void* a2, unsigned int gx, unsigned int gy, unsigned int gz, ' \
        'unsigned int bx, unsigned int by, unsigned int bz, ' \
        'void* stream) {' in src
    assert "k<<<dim3(gx, gy, gz), dim3(bx, by, bz), 0, " \
        "(cudaStream_t)stream>>>((const %s*)a0, (const float*)a1, " \
        "(%s*)a2);" % (ctype, ctype) in src
    assert "return (int)cudaGetLastError();" in src
    assert 'extern "C" const char* kernel_error_string(int code)' in src
    assert "__restrict__" not in src
    for head, t in (("cuda_fp16.h", "__half"),
                    ("cuda_bf16.h", "__nv_bfloat16")):
        assert ("#include <%s>" % head in src) == (ctype == t)


def test_unsupported_dtype_raises():
    with pytest.raises(MXNetError, match="no C type"):
        mt.rtc.Rtc("k", ["x"], ["out"], BODY).source([torch.int8],
                                                     [torch.int8])


@pytest.mark.parametrize("names", [
    ("1k", ["x"], ["y"]), ("k-1", ["x"], ["y"]), ("k", ["x y"], ["y"]),
    ("k", ["x"], [""]), ("k", ["x"], ["x"]), ("k", ["k"], ["y"])])
def test_names_must_be_distinct_c_identifiers(names):
    name, ins, outs = names
    with pytest.raises(MXNetError):
        mt.rtc.Rtc(name, ins, outs, BODY)


def test_callable_kernel_and_interpret_raise():
    def body(x_ref, out_ref):
        out_ref[...] = x_ref[...]
    with pytest.raises(MXNetError, match="takes CUDA C source"):
        mt.rtc.Rtc("k", ["x"], ["out"], body)
    with pytest.raises(MXNetError, match="no interpreter"):
        mt.rtc.Rtc("k", ["x"], ["out"], BODY, interpret=True)
    mt.rtc.Rtc("k", ["x"], ["out"], BODY, interpret=False)
    with pytest.raises(MXNetError, match="at most three"):
        mt.rtc.Rtc("k", ["x"], ["out"], BODY, grid=(1, 1, 1, 1))


def test_counts_checked():
    r = mt.rtc.Rtc("k", ["x", "y"], ["out"], BODY)
    x = _cpu(np.ones(4))
    with pytest.raises(MXNetError, match="expects 2 inputs, got 1"):
        r.push([x], [x])
    with pytest.raises(MXNetError, match="expects 1 outputs, got 2"):
        r.push([x, x], [x, x])


def test_push_on_cpu_raises():
    r, launch = rk.make_axpb(8)
    x, y, out = _cpu(np.ones(8)), _cpu(np.ones(8)), _cpu(np.zeros(8))
    before = rtc.launches
    with pytest.raises(MXNetError, match="run on the card"):
        r.push([x, y], [out], **launch)
    assert rtc.launches == before
    np.testing.assert_array_equal(out.asnumpy(), np.zeros(8))


@pytest.mark.parametrize("launch,what", [
    ({"block_dim_x": 2048}, "block dimension x"),
    ({"block_dim_x": 32, "block_dim_y": 32, "block_dim_z": 2}, "threads"),
    ({"block_dim_z": 65}, "block dimension z"),
    ({"grid_dim_y": 65536}, "grid dimension y"),
    ({"grid_dim_x": 0}, "grid dimension x")])
def test_launch_out_of_range_raises(launch, what):
    r, _ = rk.make_exp5_shared()
    x = _cpu(np.ones(10))
    with pytest.raises(MXNetError, match=what):
        r.push([x], [x], **launch)


def test_geometry_defaults():
    r = mt.rtc.Rtc("k", ["x"], ["out"], BODY, grid=(4, 2))
    assert r._geometry((None, None, None), (None, None, None)) == \
        ((4, 2, 1), (1, 1, 1))
    assert r._geometry((8, None, 3), (32, 4, None)) == ((8, 2, 3),
                                                        (32, 4, 1))


def test_non_contiguous_raises():
    r, launch = rk.make_transpose_tiled(4, 6)
    x = mt.nd.NDArray(torch.ones(6, 4).t(), ctx=mt.cpu())
    out = _cpu(np.zeros((6, 4)))
    with pytest.raises(MXNetError, match="x is not contiguous"):
        r.push([x], [out], **launch)


def test_cache_key_follows_source_and_dtypes():
    f32 = [torch.float32]

    def path(body, dt):
        r = mt.rtc.Rtc("k", ["x"], ["out"], body)
        return CudaLibrary("rtc_k", None, text=r.source(dt, dt)).so_path()
    a = path(BODY, f32)
    assert a == path(BODY, f32)
    assert a.startswith(BUILD_DIR) and a.endswith(".so")
    assert a != path(BODY + " ", f32)
    assert a != path(BODY, [torch.float64])
    assert rk.make_axpb(8)[0].source(f32 * 2, f32) != \
        rk.make_axpb(9)[0].source(f32 * 2, f32)


@pytest.mark.parametrize("n,sms,grid", [
    (163087441, 132, 132 * 302), (8, 132, 132),
    (4096 * 132 * 3, 132, 132 * 3), (4096 * 132 * 3 + 5, 132, 132 * 4),
    (1001, 4, 4), (16 * 256 * 9 - 1, 4, 12)])
def test_axpb_launch_keywords(n, sms, grid, monkeypatch):
    """The grid is a multiple of the card's SM count (``sm_count``, set
    here): one tile of AXPB_UNROLL x BLOCK float4 a block (163,087,441
    floats: 39,817 tiles), rounded up to whole SMs; the size is in the
    source."""
    monkeypatch.setattr(rk, "sm_count", lambda: sms)
    r, launch = rk.make_axpb(n)
    assert launch == {"grid_dim_x": grid, "block_dim_x": rk.BLOCK}
    assert launch["grid_dim_x"] % sms == 0
    assert "const long long n = %dLL;" % n in r.kernel


@pytest.mark.parametrize("n,offsets", [
    (1001, (0, 0, 0)), (1001, (1, 1, 1)), (4096 + 3, (0, 0, 0)),
    (16 * 256 * 4 * 2 + 2, (0, 0, 0)), (16 * 256 * 4 * 2 + 2, (3, 3, 3)),
    (3, (0, 0, 0)), (7, (1, 1, 1)), (2, (2, 2, 2)), (1001, (0, 1, 0)),
    (16 * 256 * 4 * 3 + 1, (1, 0, 2))])
def test_axpb_body_on_host_emulation(n, offsets, tmp_path, monkeypatch):
    """The axpb source push compiles, run on the CPU through
    bench/host_emu.h at a 4-SM grid: bitwise x * 2 + y and nothing written
    outside out, with the float4 path and its head and n % 4 tail (x, y and
    out at one offset within 16 bytes: aligned, or 1 to 3 elements off) or
    one element at a time (x, y and out at different offsets)."""
    from mxnet_tpu_torch.bench import host_emu
    monkeypatch.setattr(rk, "sm_count", lambda: 4)
    r, launch = rk.make_axpb(n)
    cu = tmp_path / "axpb.cu"
    cu.write_text(r.source([torch.float32] * 2, [torch.float32]))
    lib = host_emu.host_library(str(cu), str(tmp_path))
    gen = torch.Generator().manual_seed(n)
    x, y = (torch.randn(n + 8, generator=gen)[k:k + n]
            for k in offsets[:2])
    base = torch.full((n + 8,), float("nan"))
    out = base[offsets[2]:offsets[2] + n]
    assert base.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 4 * offsets[0]
    assert lib.axpb_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                           launch["grid_dim_x"], 1, 1, launch["block_dim_x"],
                           1, 1, None) == 0
    assert torch.equal(out, rk.axpb_plain(x, y))
    assert torch.isnan(base[:offsets[2]]).all()
    assert torch.isnan(base[offsets[2] + n:]).all()


# ------------------------------------------ plain versions vs the JAX Rtc
def _jax_rtc(name, ins, outs, body, arrays, out_shapes):
    """Run ``body`` through mxnet_tpu's Rtc in interpret mode; numpy
    outputs."""
    pytest.importorskip("jax")
    import mxnet_tpu as mx
    r = mx.rtc.Rtc(name, ins, outs, body, interpret=True)
    nds = [mx.nd.array(a) for a in arrays]
    res = [mx.nd.zeros(s) for s in out_shapes]
    r.push(nds, res)
    return [o.asnumpy() for o in res]


def _rand(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def test_axpb_plain_vs_jax_rtc():
    def kern(x_ref, y_ref, out_ref):
        out_ref[...] = x_ref[...] * 2.0 + y_ref[...]
    x, y = _rand(0, 16, 128), _rand(1, 16, 128)
    (want,) = _jax_rtc("axpb", ["x", "y"], ["out"], kern, [x, y],
                       [x.shape])
    got = rk.axpb_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)


def test_exp5_plain_vs_jax_rtc():
    def kern(x_ref, y_ref):
        import jax.numpy as jnp
        y_ref[...] = jnp.exp(x_ref[...] * 5.0)
    x = _rand(2, 10)
    (want,) = _jax_rtc("exp5_shared", ["x"], ["y"], kern, [x], [x.shape])
    got = rk.exp5_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_transpose_plain_vs_jax_rtc():
    def kern(x_ref, xt_ref):
        xt_ref[...] = x_ref[...].T
    x = _rand(3, 40, 72)
    (want,) = _jax_rtc("transpose_tiled", ["x"], ["xt"], kern, [x],
                       [(72, 40)])
    got = rk.transpose_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


SGD = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=0.5,
           clip_gradient=0.3)


def test_sgd_mom_plain_vs_jax_rtc():
    def kern(w_ref, g_ref, m_ref, wo_ref, mo_ref):
        import jax.numpy as jnp
        g = jnp.clip(g_ref[...] * SGD["rescale_grad"], -SGD["clip_gradient"],
                     SGD["clip_gradient"])
        g = g + SGD["wd"] * w_ref[...]
        mom = SGD["momentum"] * m_ref[...] - SGD["lr"] * g
        mo_ref[...] = mom
        wo_ref[...] = w_ref[...] + mom
    w, g, m = _rand(4, 8, 128), _rand(5, 8, 128), _rand(6, 8, 128) * 0.1
    want_w, want_m = _jax_rtc("sgd_mom", ["w", "g", "m"], ["w_out", "m_out"],
                              kern, [w, g, m], [w.shape, w.shape])
    got_w, got_m = rk.sgd_mom_plain(_cpu(w), _cpu(g), _cpu(m), **SGD)
    np.testing.assert_allclose(got_w.asnumpy(), want_w, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got_m.asnumpy(), want_m, rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return mt.gpu(0)


def _on(ctx, a):
    return mt.nd.array(a, ctx=ctx)


@pytest.mark.cuda
def test_axpb_on_card():
    ctx = _card()
    x, y = _rand(0, 100003), _rand(1, 100003)
    r, launch = rk.make_axpb(x.size)
    xs, ys, out = _on(ctx, x), _on(ctx, y), mt.nd.zeros(x.shape, ctx=ctx)
    before = rtc.launches
    r.push([xs, ys], [out], **launch)
    torch.cuda.synchronize()
    assert rtc.launches == before + 1
    assert torch.equal(out.value, rk.axpb_plain(xs.value, ys.value))
    builds = rtc.builds
    r.push([xs, ys], [out], **launch)
    assert rtc.builds == builds


@pytest.mark.cuda
def test_exp5_shared_on_card():
    ctx = _card()
    r, launch = rk.make_exp5_shared()
    x, y = _on(ctx, _rand(2, 10)), mt.nd.zeros((10,), ctx=ctx)
    r.push([x], [y], **launch)
    want = rk.exp5_plain(x.value)
    assert ((y.value - want).abs() / want.abs()).max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(40, 72), (257, 96), (1000, 33)])
def test_transpose_tiled_on_card(h, w):
    ctx = _card()
    r, launch = rk.make_transpose_tiled(h, w)
    x, xt = _on(ctx, _rand(3, h, w)), mt.nd.zeros((w, h), ctx=ctx)
    r.push([x], [xt], **launch)
    assert torch.equal(xt.value, rk.transpose_plain(x.value))


@pytest.mark.cuda
def test_sgd_mom_in_place_through_views_on_card():
    """w and m are inputs and outputs; the parameters are views of one
    buffer and see the step."""
    ctx = _card()
    n = 6 * 1000
    w, g, m = (_on(ctx, _rand(s, n)) for s in (4, 5, 6))
    part = w[1000:3000].reshape((40, 50))
    want_w, want_m = rk.sgd_mom_plain(w, g, m, **SGD)
    r, launch = rk.make_sgd_mom(n, **SGD)
    r.push([w, g, m], [w, m], **launch)
    scale = want_w.value.abs().max().item()
    assert (w.value - want_w.value).abs().max().item() <= 1e-6 * scale
    assert (m.value - want_m.value).abs().max().item() <= 1e-6 * scale
    assert torch.equal(part.value.reshape(-1), w.value[1000:3000])


@pytest.mark.cuda
def test_output_view_writes_through_on_card():
    ctx = _card()
    base = mt.nd.zeros((4, 8), ctx=ctx)
    x, y = _on(ctx, _rand(7, 8)), _on(ctx, _rand(8, 8))
    r, launch = rk.make_axpb(8)
    r.push([x, y], [base[2]], **launch)
    assert torch.equal(base.value[2], rk.axpb_plain(x.value, y.value))
    assert base.value[[0, 1, 3]].abs().max().item() == 0.0


@pytest.mark.cuda
def test_compile_error_raises_with_log_on_card():
    ctx = _card()
    x = mt.nd.zeros((1,), ctx=ctx)
    bad = mt.rtc.Rtc("broken", ["x"], ["y"], "  y[0] = x[0] +;")
    with pytest.raises(MXNetError, match="nvcc failed"):
        bad.push([x], [x], block_dim_x=1)
