"""The port's Load, Mixed, Orthogonal, MSRAPrelu and Bilinear initializers
against mxnet_tpu's, on the CPU.  Bilinear and Load are deterministic and
held exactly; Mixed by which initializer each name reaches; MSRAPrelu and
Orthogonal draw from the port's own generator (torch's, not the JAX
package's streams), so they are held by the statistics of a draw and, with
the same draw injected into both packages, to the reference's algorithm
exactly."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import initializer as pinit
from test_torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _arr(pkg, shape, fill=0.0):
    return pkg.nd.array(np.full(shape, fill, np.float32), ctx=pkg.cpu())


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 5, 5), (4, 2, 3, 6)])
def test_bilinear_matches_mxnet_tpu(mx, shape):
    """The bilinear upsampling filter, by ``Bilinear`` and by the
    ``upsampling`` name rule of any initializer, equal to the JAX
    package's."""
    for name, make in (("deconv_weight", "Bilinear"),
                       ("upsampling0_weight", "Xavier")):
        p, j = _arr(mt, shape), _arr(mx, shape)
        getattr(pinit, make)()(pinit.InitDesc(name), p)
        getattr(mx.initializer, make)()(mx.initializer.InitDesc(name), j)
        np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())
    assert p.asnumpy().max() <= 1.0 and p.asnumpy().min() >= 0.0


def test_load_matches_mxnet_tpu(mx, tmp_path):
    """From a dict (``arg:``/``aux:`` prefixes dropped) and from a
    ``.params`` file the JAX package wrote; a name it lacks goes to the
    default initializer, or raises without one; a shape mismatch raises."""
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    mean = rng.randn(4).astype(np.float32)
    fname = str(tmp_path / "saved.params")
    mx.nd.save(fname, {"arg:fc_weight": mx.nd.array(w),
                       "aux:bn_moving_mean": mx.nd.array(mean)})
    for source in ({"arg:fc_weight": mt.nd.array(w, ctx=mt.cpu()),
                    "aux:bn_moving_mean": mean}, fname):
        load = pinit.Load(source, default_init=pinit.Constant(7.0))
        jload = mx.initializer.Load(fname if isinstance(source, str)
                                    else {"arg:fc_weight": mx.nd.array(w),
                                          "aux:bn_moving_mean":
                                          mx.nd.array(mean)},
                                    default_init=mx.initializer.Constant(7.0))
        for name, shape in (("fc_weight", (4, 3)), ("bn_moving_mean", (4,)),
                            ("fc2_weight", (2, 2))):
            p, j = _arr(mt, shape), _arr(mx, shape)
            load(pinit.InitDesc(name), p)
            jload(mx.initializer.InitDesc(name), j)
            np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())
        np.testing.assert_array_equal(p.asnumpy(), np.full((2, 2), 7.0))
        with pytest.raises(mt.MXNetError, match="Shape mismatch"):
            load("fc_weight", _arr(mt, (3, 4)))
    with pytest.raises(mt.MXNetError, match="no default initializer"):
        pinit.Load({"a": w})("b_weight", _arr(mt, (4, 3)))


def test_mixed_routes_by_pattern(mx):
    """The first pattern matching the start of the name picks the
    initializer, in both packages; no match raises ValueError."""
    def run(pkg):
        I = pkg.initializer
        mixed = I.Mixed(["fc.*bias", "fc", ".*_gamma"],
                        [I.Constant(3.0), I.One(), I.Zero()])
        out = {}
        for name, shape in (("fc1_bias", (4,)), ("fc1_weight", (2, 4)),
                            ("bn_gamma", (4,))):
            arr = _arr(pkg, shape, fill=-1.0)
            mixed(I.InitDesc(name), arr)
            out[name] = arr.asnumpy()
        with pytest.raises(ValueError, match="did not match"):
            mixed(I.InitDesc("conv_weight"), _arr(pkg, (2,)))
        return out
    got, want = run(mt), run(mx)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    # fc1_bias: the pattern's Constant reaches _init_bias, which zeroes it
    # (the name rule of an Initializer), as in the JAX package
    np.testing.assert_array_equal(got["fc1_weight"], np.ones((2, 4)))
    np.testing.assert_array_equal(got["bn_gamma"], np.ones(4))
    with pytest.raises(mt.MXNetError):
        pinit.Mixed(["a"], [])


def test_msra_prelu_statistics():
    """A draw from the port's generator: mean 0 and standard deviation
    sqrt(2 / (1 + slope^2) / factor) (the average fan, 3x3 kernels) within
    the sampling error of 294,912 entries; ``dumps`` names its kwargs as the
    JAX package's does."""
    mt.random.seed(0)
    shape = (256, 128, 3, 3)
    arr = _arr(mt, shape)
    init = pinit.MSRAPrelu(slope=0.5)
    init(pinit.InitDesc("conv_weight"), arr)
    v = arr.asnumpy().astype(np.float64)
    factor = (128 * 9 + 256 * 9) / 2.0
    want_std = np.sqrt(2.0 / 1.25 / factor)
    assert abs(v.mean()) < 5 * want_std / np.sqrt(v.size)
    assert abs(v.std() / want_std - 1) < 0.01
    assert init.dumps() == '["msraprelu", {"factor_type": "avg", ' \
        '"slope": 0.5}]'


def test_msra_prelu_on_an_injected_draw_matches_mxnet_tpu(mx, monkeypatch):
    """With one standard normal draw handed to both packages' samplers,
    the weights are equal (float32)."""
    z = np.random.RandomState(3).randn(6, 4, 3, 3)

    def port_normal(loc, scale, shape, dtype=torch.float32):
        return torch.from_numpy(loc + scale * z).to(dtype)

    def jax_normal(loc=0, scale=1, shape=None, **kw):
        return mx.nd.array((loc + scale * z).astype(np.float32))
    monkeypatch.setattr(pinit._random, "normal", port_normal)
    monkeypatch.setattr(mx.initializer.nd, "normal", jax_normal)
    for ft in ("avg", "in", "out"):
        p, j = _arr(mt, z.shape), _arr(mx, z.shape)
        pinit.MSRAPrelu(ft)(pinit.InitDesc("c_weight"), p)
        mx.initializer.MSRAPrelu(ft)(mx.initializer.InitDesc("c_weight"), j)
        np.testing.assert_allclose(p.asnumpy(), j.asnumpy(), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("shape", [(8, 20), (20, 8), (6, 2, 3, 3)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_statistics(shape, rand_type):
    """The weight, flattened to (out, rest), has orthonormal rows (or
    columns, whichever are fewer) times ``scale``."""
    mt.random.seed(1)
    arr = _arr(mt, shape)
    pinit.Orthogonal(scale=1.5, rand_type=rand_type)(
        pinit.InitDesc("fc_weight"), arr)
    w = arr.asnumpy().astype(np.float64).reshape(shape[0], -1)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram, 2.25 * np.eye(min(w.shape)),
                               atol=1e-5)


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_on_an_injected_draw_matches_mxnet_tpu(mx, monkeypatch,
                                                          rand_type):
    """With one float64 draw handed to both packages (the port's sampler,
    numpy's in the JAX package), the SVD gives equal weights; the port
    asks its sampler for float64 in the reference's range."""
    asked = []
    draws = {}

    def draw(kind, shape):
        rs = np.random.RandomState(len(draws))
        key = (kind, tuple(shape))
        if key not in draws:
            draws[key] = rs.uniform(-1, 1, shape) if kind == "uniform" \
                else rs.randn(*shape)
        return draws[key]

    def port_uniform(low, high, shape, dtype=torch.float32):
        asked.append((low, high, dtype))
        return torch.from_numpy(draw("uniform", shape))

    def port_normal(loc, scale, shape, dtype=torch.float32):
        asked.append((loc, scale, dtype))
        return torch.from_numpy(draw("normal", shape))
    monkeypatch.setattr(pinit._random, "uniform", port_uniform)
    monkeypatch.setattr(pinit._random, "normal", port_normal)
    monkeypatch.setattr(
        mx.initializer.np.random, "uniform",
        lambda low, high, shape: draw("uniform", shape))
    monkeypatch.setattr(
        mx.initializer.np.random, "normal",
        lambda loc, scale, shape: draw("normal", shape))
    for shape in ((8, 20), (20, 8), (6, 2, 3, 3)):
        p, j = _arr(mt, shape), _arr(mx, shape)
        pinit.Orthogonal(rand_type=rand_type)(pinit.InitDesc("fc_weight"), p)
        mx.initializer.Orthogonal(rand_type=rand_type)(
            mx.initializer.InitDesc("fc_weight"), j)
        np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())
    want = (-1.0, 1.0) if rand_type == "uniform" else (0.0, 1.0)
    assert asked == [want + (torch.float64,)] * 3


def test_registry_and_variable_init_attr(mx):
    """The new classes dispatch from a variable's ``__init__`` attribute
    (the JSON ``dumps`` writes), as the JAX package's do."""
    for cls in ("Orthogonal", "MSRAPrelu", "Bilinear"):
        assert cls.lower() in pinit._REGISTRY
    desc = pinit.InitDesc("deconv_weight",
                          attrs={"__init__": pinit.Bilinear().dumps()})
    p = _arr(mt, (1, 1, 4, 4))
    pinit.Uniform()(desc, p)
    j = _arr(mx, (1, 1, 4, 4))
    mx.initializer.Uniform()(mx.initializer.InitDesc(
        "deconv_weight", attrs={"__init__": mx.initializer.Bilinear()
                                .dumps()}), j)
    np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())
