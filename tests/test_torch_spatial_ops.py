"""The spatial ops in the port (``ops/spatial.py``) against mxnet_tpu:
Crop, GridGenerator, BilinearSampler, SpatialTransformer, ROIPooling and
Correlation.

The parity cases feed the same float64 numpy inputs from a seed (JAX's x64
on) through ``_both`` of ``test_torch_ordering_misc.py``: the JAX op's
forward and ``jax.vjp`` beside the port's forward and
``torch.autograd.grad``, under one random cotangent; every output and
gradient within 1e-9 relative.  ROIPooling gets ties (a grid of halves, a
map of zeros), bins that overlap at their floor/ceil edges, empty bins
(ROIs past the map), batch indices and a scale, and its chunked form
against its one-chunk form; BilinearSampler samples outside the border and
at integer coordinates; Correlation runs ``is_multiply=False``,
``stride2 > 1``, padding and a 3x3 kernel.  Then shape inference and the
twins of ``tests/python/unittest/test_spatial_ops.py``."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import spatial
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from test_torch_ordering_misc import _both
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-12)
C = mt.cpu()


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _halves(shape, seed):
    """randn on a grid of halves: many ties."""
    return np.round(np.random.RandomState(seed).randn(*shape) * 2) / 2


def _rois(rows):
    return np.asarray(rows, np.float64)


def _grid(n, h, w, lo, hi, seed):
    return np.random.RandomState(seed).uniform(lo, hi, (n, 2, h, w))


def _pixel_grid(n, ih, iw, oh, ow):
    """Normalised coordinates that land on whole pixels (weights 0 or 1)."""
    xs = np.arange(ow) % iw * 2.0 / (iw - 1) - 1.0
    ys = np.arange(oh) % ih * 2.0 / (ih - 1) - 1.0
    gx, gy = np.meshgrid(xs, ys)
    return np.broadcast_to(np.stack([gx, gy]), (n, 2, oh, ow)).copy()


CASES = [
    # op, attrs, inputs (arrays, or shapes drawn from randn)
    ("Crop", {"h_w": (3, 4), "offset": (1, 2)}, [(2, 3, 6, 7)]),
    ("Crop", {"h_w": (4, 3), "center_crop": True}, [(2, 3, 7, 6)]),
    ("Crop", {"num_args": 2, "offset": (2, 1)}, [(2, 3, 6, 7), (2, 5, 3, 4)]),
    ("GridGenerator", {"transform_type": "affine", "target_shape": (4, 5)},
     [(3, 6)]),
    ("GridGenerator", {"transform_type": "warp"}, [(2, 2, 4, 5)]),
    # past the border on every side, and inside
    ("BilinearSampler", {}, [(2, 3, 5, 6), _grid(2, 5, 4, -1.6, 1.6, 2)]),
    ("BilinearSampler", {}, [(1, 2, 4, 5), _pixel_grid(1, 4, 5, 3, 7)]),
    ("SpatialTransformer", {"target_shape": (4, 4)},
     [(2, 3, 5, 6), np.random.RandomState(3).randn(2, 6) * 0.6]),
    # ties everywhere; 5 rows into 3 bins overlap at the floor/ceil edges
    ("ROIPooling", {"pooled_size": (3, 3), "spatial_scale": 1.0},
     [_halves((1, 2, 7, 8), 4), _rois([[0, 0, 0, 4, 6], [0, 1, 2, 7, 6]])]),
    # batch indices, a scale (corners round half to even), ROIs past the
    # map (empty bins) and a one-pixel ROI
    ("ROIPooling", {"pooled_size": (2, 3), "spatial_scale": 0.5},
     [_halves((3, 2, 6, 7), 5),
      _rois([[2, 1, 3, 9, 11], [0, -8, -8, 40, 40], [1, 20, 20, 60, 60],
             [1, 5, 5, 5, 5], [0, 3, 1, 13, 9]])]),
    ("ROIPooling", {"pooled_size": (4, 4), "spatial_scale": 0.25},
     [(2, 3, 8, 9), _rois([[1, 0, 0, 31, 35], [0, 4, 8, 20, 12]])]),
    ("Correlation", {"max_displacement": 2, "stride2": 2, "pad_size": 2},
     [(2, 3, 6, 7), (2, 3, 6, 7)]),
    ("Correlation", {"max_displacement": 1, "kernel_size": 3, "pad_size": 2,
                     "is_multiply": False}, [(2, 3, 6, 7), (2, 3, 6, 7)]),
    ("Correlation", {"max_displacement": 2, "stride1": 2, "pad_size": 1},
     [(1, 4, 7, 8), (1, 4, 7, 8)]),
]
IDS = ["%d-%s" % (i, c[0]) for i, c in enumerate(CASES)]


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [s if isinstance(s, np.ndarray) else rng.randn(*s)
            for s in shapes]


def _check(pall, jall, pgrads, jgrads):
    assert len(pall) == len(jall)
    for p, j in zip(pall, jall):
        j = np.asarray(j)
        assert p.dtype == torch.float64 and tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.detach().numpy(), j, **TOL)
    for i, (p, j) in enumerate(zip(pgrads, jgrads)):
        want = np.asarray(j)
        got = np.zeros_like(want) if p is None else p.numpy()
        np.testing.assert_allclose(got, want, err_msg="input %d" % i, **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_backward_f64_match_mxnet_tpu(case, f64):
    name, attrs, shapes = case
    _check(*_both(name, attrs, _arrays(shapes, seed=len(IDS))))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_infer_shape_matches_mxnet_tpu(case):
    name, attrs, shapes = case
    shapes = [np.shape(s) if isinstance(s, np.ndarray) else s
              for s in shapes]
    jop, pop = jget_op(name), pget_op(name)
    jin, jouts, _ = jop.infer_shape(jop.normalize_attrs(attrs), shapes)
    pin, pouts, _ = pop.infer_shape(pop.normalize_attrs(attrs), shapes)
    assert [tuple(s) for s in pouts] == [tuple(s) for s in jouts]
    assert [tuple(s) for s in pin] == [tuple(s) for s in jin]


def test_roi_pooling_splits_a_tied_bin_equally(f64):
    """A 3x3 bin of zeros gives 1/9 of its gradient to each position, as
    the JAX package's max (MXNet's kernel gives it all to one argmax)."""
    data = np.zeros((1, 1, 6, 6))
    rois = _rois([[0, 0, 0, 5, 5]])
    attrs = {"pooled_size": (2, 2), "spatial_scale": 1.0}
    pall, jall, pgrads, jgrads = _both("ROIPooling", attrs, [data, rois])
    _check(pall, jall, pgrads, jgrads)
    x = torch.zeros((1, 1, 6, 6), dtype=torch.float64, requires_grad=True)
    y = spatial.ROIPool.apply(x, torch.tensor(rois), 2, 2, 1.0)
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(g.numpy(), np.full((1, 1, 6, 6), 1 / 9.0),
                               rtol=1e-15)


def test_roi_pooling_overlapping_bins_sum_their_shares():
    """Rows 0-4 into 2 bins: [0, 3) and [2, 5) share row 2, whose
    position collects both bins' gradients when it is each bin's max."""
    data = np.zeros((1, 1, 5, 1))
    data[0, 0, 2, 0] = 1.0
    x = torch.tensor(data, requires_grad=True)
    y = spatial.ROIPool.apply(x, torch.tensor(_rois([[0, 0, 0, 0, 4]])),
                              2, 1, 1.0)
    np.testing.assert_array_equal(y.detach().numpy().ravel(), [1.0, 1.0])
    (g,) = torch.autograd.grad(y, x, torch.tensor([[[[3.0], [5.0]]]],
                                                  dtype=torch.float64))
    np.testing.assert_array_equal(g.numpy().ravel(), [0, 0, 8.0, 0, 0])


def test_roi_pooling_in_chunks_equals_one_chunk(monkeypatch):
    """ROIs taken a few at a time (ROI_CHUNK_BYTES of one ROI's features)
    give the values and gradients of one chunk exactly."""
    rs = np.random.RandomState(6)
    data = _halves((2, 3, 9, 10), 7)
    rois = np.concatenate([rs.randint(0, 2, (11, 1)),
                           rs.uniform(-4, 44, (11, 4))], 1)
    g = torch.tensor(rs.randn(11, 3, 3, 2))

    def run():
        x = torch.tensor(data, requires_grad=True)
        y = spatial.ROIPool.apply(x, torch.tensor(rois), 3, 2, 0.25)
        return y.detach(), torch.autograd.grad(y, x, g)[0]
    one = run()
    monkeypatch.setattr(spatial, "ROI_CHUNK_BYTES", 3 * 9 * 10 * 8 * 2)
    assert len(spatial._chunks(torch.tensor(data), 11)) == 6
    many = run()
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])


def test_roi_pooling_rois_take_no_gradient():
    x = torch.randn(1, 2, 5, 5, dtype=torch.float64, requires_grad=True)
    r = torch.tensor(_rois([[0, 1, 1, 3, 4]]), requires_grad=True)
    y = mt.ops.registry.imperative_invoke(
        "ROIPooling", [x, r], {"pooled_size": (2, 2)})[0][0]
    gx, gr = torch.autograd.grad(y.sum(), [x, r], allow_unused=True)
    assert gr is None and gx.abs().sum() > 0


def test_spatial_transformer_refuses_like_mxnet_tpu():
    attrs = {"target_shape": (2, 2), "sampler_type": "nearest"}
    ins = [np.zeros((1, 1, 3, 3)), np.zeros((1, 6))]
    with pytest.raises(MXNetError):
        mt.ops.registry.imperative_invoke(
            "SpatialTransformer", [torch.tensor(a) for a in ins], attrs)
    with pytest.raises(mx.base.MXNetError):
        mx.nd.SpatialTransformer(*[mx.nd.array(a) for a in ins], **attrs)


# ------------------------------------------ twins of the JAX package's tests
def test_crop_offset():
    x = mt.nd.array(np.arange(2 * 3 * 6 * 8, dtype=np.float32)
                    .reshape(2, 3, 6, 8), ctx=C)
    out = mt.nd.Crop(x, h_w=(4, 5), offset=(1, 2), num_args=1)
    np.testing.assert_array_equal(out.asnumpy(),
                                  x.asnumpy()[:, :, 1:5, 2:7])


def test_crop_center():
    x = mt.nd.array(np.arange(1 * 1 * 8 * 8, dtype=np.float32)
                    .reshape(1, 1, 8, 8), ctx=C)
    out = mt.nd.Crop(x, h_w=(4, 4), center_crop=True, num_args=1)
    np.testing.assert_array_equal(out.asnumpy(), x.asnumpy()[:, :, 2:6, 2:6])


def test_crop_like_symbol():
    data = mt.sym.Variable("data")
    like = mt.sym.Variable("like")
    c = mt.sym.Crop(data, like, num_args=2)
    arg_shapes, out_shapes, _ = c.infer_shape(data=(1, 2, 8, 8),
                                              like=(1, 2, 5, 6))
    assert out_shapes[0] == (1, 2, 5, 6)
    ex = c.bind(C, {"data": mt.nd.ones((1, 2, 8, 8), ctx=C),
                    "like": mt.nd.zeros((1, 2, 5, 6), ctx=C)},
                args_grad={"data": mt.nd.zeros((1, 2, 8, 8), ctx=C),
                           "like": mt.nd.zeros((1, 2, 5, 6), ctx=C)})
    ex.forward(is_train=True)
    ex.backward(out_grads=mt.nd.ones((1, 2, 5, 6), ctx=C))
    # crop_like gets zero gradient
    np.testing.assert_array_equal(ex.grad_dict["like"].asnumpy(),
                                  np.zeros((1, 2, 5, 6), np.float32))
    g = ex.grad_dict["data"].asnumpy()
    assert g[:, :, :5, :6].sum() == 2 * 5 * 6
    assert g.sum() == 2 * 5 * 6


def test_grid_generator_affine_identity():
    theta = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    grid = mt.nd.GridGenerator(mt.nd.array(theta, ctx=C),
                               transform_type="affine",
                               target_shape=(3, 4)).asnumpy()
    assert grid.shape == (2, 2, 3, 4)
    np.testing.assert_allclose(grid[0, 0, 0], np.linspace(-1, 1, 4),
                               atol=1e-6)
    np.testing.assert_allclose(grid[0, 1, :, 0], np.linspace(-1, 1, 3),
                               atol=1e-6)


def test_grid_generator_warp_zero_flow():
    flow = np.zeros((1, 2, 3, 5), np.float32)
    grid = mt.nd.GridGenerator(mt.nd.array(flow, ctx=C),
                               transform_type="warp").asnumpy()
    np.testing.assert_allclose(grid[0, 0, 0], np.linspace(-1, 1, 5),
                               atol=1e-6)
    np.testing.assert_allclose(grid[0, 1, :, 0], np.linspace(-1, 1, 3),
                               atol=1e-6)


def test_bilinear_sampler_identity():
    data = np.random.RandomState(0).rand(2, 3, 5, 7).astype(np.float32)
    xs = np.linspace(-1, 1, 7, dtype=np.float32)
    ys = np.linspace(-1, 1, 5, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    grid = np.stack([gx, gy])[None].repeat(2, axis=0)
    out = mt.nd.BilinearSampler(mt.nd.array(data, ctx=C),
                                mt.nd.array(grid, ctx=C))
    np.testing.assert_allclose(out.asnumpy(), data, rtol=1e-5, atol=1e-5)


def test_bilinear_sampler_outside_is_zero():
    data = np.ones((1, 1, 4, 4), np.float32)
    grid = np.full((1, 2, 2, 2), 5.0, np.float32)  # far outside
    out = mt.nd.BilinearSampler(mt.nd.array(data, ctx=C),
                                mt.nd.array(grid, ctx=C))
    np.testing.assert_array_equal(out.asnumpy(), np.zeros((1, 1, 2, 2)))


def test_bilinear_sampler_grad():
    """Finite differences in float64 (the twin of check_numeric_gradient)
    on both inputs, away from the integer coordinates where floor
    jumps."""
    d = torch.tensor(np.random.RandomState(1).rand(1, 2, 5, 5),
                     requires_grad=True)
    g = torch.tensor(np.random.RandomState(2).uniform(-0.8, 0.8,
                                                      (1, 2, 4, 4)),
                     requires_grad=True)
    op = pget_op("BilinearSampler")
    assert torch.autograd.gradcheck(
        op.make_callable(op.normalize_attrs({}), False), (d, g), eps=1e-6,
        atol=1e-6)


def test_spatial_transformer_identity():
    data = np.random.RandomState(0).rand(2, 1, 6, 6).astype(np.float32)
    loc = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    out = mt.nd.SpatialTransformer(mt.nd.array(data, ctx=C),
                                   mt.nd.array(loc, ctx=C),
                                   target_shape=(6, 6),
                                   transform_type="affine",
                                   sampler_type="bilinear")
    np.testing.assert_allclose(out.asnumpy(), data, rtol=1e-5, atol=1e-5)


def test_roi_pooling_basic():
    data = np.arange(36, dtype=np.float32).reshape(1, 1, 6, 6)
    rois = np.array([[0, 0, 0, 5, 5]], np.float32)  # whole map
    out = mt.nd.ROIPooling(mt.nd.array(data, ctx=C), mt.nd.array(rois, ctx=C),
                           pooled_size=(2, 2), spatial_scale=1.0).asnumpy()
    np.testing.assert_array_equal(
        out[0, 0], np.array([[14, 17], [32, 35]], np.float32))


def test_roi_pooling_batch_index_and_scale():
    rs = np.random.RandomState(3)
    data = rs.rand(2, 2, 8, 8).astype(np.float32)
    rois = np.array([[1, 0, 0, 14, 14]], np.float32)  # second image, x0.5
    out = mt.nd.ROIPooling(mt.nd.array(data, ctx=C), mt.nd.array(rois, ctx=C),
                           pooled_size=(1, 1), spatial_scale=0.5).asnumpy()
    np.testing.assert_allclose(out[0, :, 0, 0], data[1].max(axis=(1, 2)),
                               rtol=1e-6)


def test_correlation_self_is_mean_square():
    rs = np.random.RandomState(0)
    d = rs.rand(1, 3, 5, 5).astype(np.float32)
    a = mt.nd.array(d, ctx=C)
    out = mt.nd.Correlation(a, a, kernel_size=1, max_displacement=0,
                            stride1=1, stride2=1, pad_size=0,
                            is_multiply=True).asnumpy()
    assert out.shape == (1, 1, 5, 5)
    np.testing.assert_allclose(out[0, 0], (d[0] ** 2).mean(axis=0),
                               rtol=1e-5)


def test_correlation_shape():
    d = mt.nd.zeros((2, 4, 10, 10), ctx=C)
    out = mt.nd.Correlation(d, d, kernel_size=1, max_displacement=2,
                            stride1=1, stride2=1, pad_size=2)
    assert out.shape == (2, 25, 10, 10)
