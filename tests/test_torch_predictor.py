"""mxnet_tpu_torch executor and Predictor against mxnet_tpu: ResNet-50
forward in float64 with the NormConv peephole on and off, ResNet-20 float32
against mxnet_tpu's Pallas kernel (interpret mode), checkpoint loading, and
the card as the default device."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import name as jname
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.predictor import Predictor as JPredictor
from mxnet_tpu_torch import executor as pexec
from test_torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _resnet(classes, layers, image):
    with jname.NameManager():
        return jresnet.get_symbol(classes, layers, "3,%d,%d" % (image, image))


def _weights(sym, dshape, dtype, seed=0):
    """Random arguments and aux states; moving variances positive."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=dshape)
    args = {n: (rng.randn(*s) * 0.1).astype(dtype)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: ((rng.rand(*s) + 0.5) if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(dtype)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _count_norm_conv(monkeypatch):
    calls = []
    real = pexec.norm_conv

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(pexec, "norm_conv", counted)
    return calls


@pytest.mark.parametrize("norm_conv,layout", [("0", "NHWC"), ("1", "NHWC"),
                                              ("1", "NCHW")])
def test_resnet50_bind_forward_f64(norm_conv, layout, f64, monkeypatch):
    """ResNet-50, 3x32x32, 10 classes, batch 2: the port's bind/forward,
    in inference and in training, equals mxnet_tpu's to 1e-9, with the
    NormConv peephole on and off (and
    off again under the NCHW layout, which the peephole needs)."""
    monkeypatch.setenv("MXNET_NORM_CONV", norm_conv)
    monkeypatch.setenv("MXNET_CONV_LAYOUT", layout)
    calls = _count_norm_conv(monkeypatch)
    jsym = _resnet(10, 50, 32)
    dshape = (2, 3, 32, 32)
    args, aux = _weights(jsym, dshape, np.float64)
    data = np.random.RandomState(1).uniform(-1, 1, dshape)
    label = np.zeros(2)
    jex = jsym.bind(mx.cpu(), dict(
        {k: mx.nd.array(v, dtype=np.float64) for k, v in args.items()},
        data=mx.nd.array(data, dtype=np.float64),
        softmax_label=mx.nd.array(label, dtype=np.float64)),
        aux_states={k: mx.nd.array(v, dtype=np.float64)
                    for k, v in aux.items()}, grad_req="null")
    want = jex.forward(is_train=False)[0].asnumpy()

    psym = mt.sym.load_json(jsym.tojson())
    cpu = mt.cpu()
    pex = psym.bind(cpu, dict(
        {k: mt.nd.array(v, ctx=cpu, dtype=np.float64)
         for k, v in args.items()},
        data=mt.nd.array(data, ctx=cpu, dtype=np.float64),
        softmax_label=mt.nd.array(label, ctx=cpu, dtype=np.float64)),
        aux_states={k: mt.nd.array(v, ctx=cpu, dtype=np.float64)
                    for k, v in aux.items()})
    got = pex.forward(is_train=False)[0].asnumpy()
    assert got.dtype == np.float64 and got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    # on: every fusable conv ran as NormConv: 16 units x 3 + 4 shortcuts,
    # plus the 3x3 stem conv0 of the 32x32 variant (bn_data is its prologue)
    fused = norm_conv == "1" and layout == "NHWC"
    assert len(calls) == (53 if fused else 0)
    # training, fused or not: the training forward (batch statistics, from
    # the NormConv epilogue where fused, moving statistics updated) equals
    # mxnet_tpu's under the same MXNET_NORM_CONV
    want = jex.forward(is_train=True)[0].asnumpy()
    got = pex.forward(is_train=True)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    for n, v in jex.aux_dict.items():
        np.testing.assert_allclose(pex.aux_dict[n].asnumpy(), v.asnumpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=n)


def _bind_both(jsym, shapes, seed):
    """Bind one graph in both packages (float64) on the same random
    arguments; returns (jax executor, port executor)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = jsym.infer_shape(**shapes)
    args = {n: rng.randn(*s) for n, s in zip(jsym.list_arguments(),
                                             arg_shapes)}
    aux = {n: (rng.rand(*s) + 0.5) if n.endswith("_var") else rng.randn(*s)
           for n, s in zip(jsym.list_auxiliary_states(), aux_shapes)}
    jex = jsym.bind(mx.cpu(), {k: mx.nd.array(v, dtype=np.float64)
                               for k, v in args.items()},
                    aux_states={k: mx.nd.array(v, dtype=np.float64)
                                for k, v in aux.items()}, grad_req="null")
    cpu = mt.cpu()
    pex = mt.sym.load_json(jsym.tojson()).bind(
        cpu, {k: mt.nd.array(v, ctx=cpu, dtype=np.float64)
              for k, v in args.items()},
        aux_states={k: mt.nd.array(v, ctx=cpu, dtype=np.float64)
                    for k, v in aux.items()})
    return jex, pex


def test_norm_conv_peephole_shared_bn_f64(f64, monkeypatch):
    """A BatchNorm+ReLU feeding two convs and a pooling: the convs take it
    as their prologue, the pooling gets the materialised apply, and a plain
    BatchNorm feeding one conv is fused without a ReLU."""
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    calls = _count_norm_conv(monkeypatch)
    S = mx.sym
    data = S.Variable("data")
    bn = S.BatchNorm(data=data, fix_gamma=False, name="bn")
    act = S.Activation(data=bn, act_type="relu", name="act")
    c1 = S.Convolution(data=act, num_filter=4, kernel=(3, 3), pad=(1, 1),
                       no_bias=True, name="c1")
    c2 = S.Convolution(data=act, num_filter=4, kernel=(1, 1), stride=(2, 2),
                       no_bias=True, name="c2")
    pool = S.Pooling(data=act, kernel=(2, 2), stride=(2, 2), pool_type="max",
                     name="pool")
    bn2 = S.BatchNorm(data=c1, fix_gamma=True, name="bn2")
    c3 = S.Convolution(data=bn2, num_filter=3, kernel=(1, 1), pad=(1, 1),
                       no_bias=True, name="c3")
    jsym = S.Group([c3, c2, pool])
    jex, pex = _bind_both(jsym, {"data": (2, 3, 6, 6)}, seed=6)
    want = [o.asnumpy() for o in jex.forward(is_train=False)]
    got = [o.asnumpy() for o in pex.forward(is_train=False)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
    assert len(calls) == 3


def test_norm_conv_weights_made_once_and_refreshed(f64, monkeypatch):
    """The fused path reorders each conv weight to HWIO once, not on every
    forward, and a rebound or in-place-written weight is reordered again:
    after either, the fused forward still equals the unfused one."""
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    seen = []
    real = pexec.norm_conv

    def spy(x, w, *a, **k):
        seen.append(w)
        return real(x, w, *a, **k)
    monkeypatch.setattr(pexec, "norm_conv", spy)
    S = mx.sym
    bn = S.BatchNorm(data=S.Variable("data"), fix_gamma=False, name="bn")
    act = S.Activation(data=bn, act_type="relu", name="act")
    c1 = S.Convolution(data=act, num_filter=4, kernel=(3, 3), pad=(1, 1),
                       no_bias=True, name="c1")
    c2 = S.Convolution(data=act, num_filter=4, kernel=(1, 1), stride=(2, 2),
                       no_bias=True, name="c2")
    _, pex = _bind_both(S.Group([c1, c2]), {"data": (2, 3, 6, 6)}, seed=7)
    pex.forward()
    first = list(seen)
    pex.forward()
    assert len(seen) == 4 and all(a is b for a, b in zip(first, seen[2:]))

    rng = np.random.RandomState(8)
    pex.arg_dict["c1_weight"][:] = rng.randn(4, 3, 3, 3)      # rebinds
    pex.arg_dict["c2_weight"].value.mul_(-2.0)                # in place
    del seen[:]
    got = [o.asnumpy() for o in pex.forward()]
    assert not any(a is b for a, b in zip(first, seen))
    monkeypatch.setenv("MXNET_NORM_CONV", "0")
    want = [o.asnumpy() for o in pex.forward()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


def test_resnet20_predictor_vs_pallas_interpret(monkeypatch):
    """ResNet-20 16x16 float32 through Predictor: the port (plain NormConv
    on the CPU) against mxnet_tpu with the Pallas kernel in interpret mode,
    both loading one .params blob written by mxnet_tpu."""
    monkeypatch.setenv("MXNET_NORM_CONV", "1")
    monkeypatch.setenv("MXNET_PALLAS_CONV", "interpret")
    calls = _count_norm_conv(monkeypatch)
    jsym = _resnet(10, 20, 16)
    dshape = (2, 3, 16, 16)
    args, aux = _weights(jsym, dshape, np.float32, seed=2)
    blob = mx.nd.serialize_arrays(dict(
        [("arg:" + k, v) for k, v in args.items()]
        + [("aux:" + k, v) for k, v in aux.items()]))
    data = np.random.RandomState(3).uniform(-1, 1, dshape).astype(np.float32)
    jp = JPredictor(jsym.tojson(), blob, {"data": dshape})
    jp.forward(data=data)
    want = jp.get_output(0).astype(np.float64)
    pp = mt.Predictor(jsym.tojson(), blob, {"data": dshape}, dev_type="cpu")
    pp.forward(data=data)
    got = pp.get_output(0).astype(np.float64)
    assert got.shape == want.shape == (2, 10)
    assert np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6) < 2e-4
    assert len(calls) == 22   # 9 units x 2 convs + 3 shortcuts + 3x3 stem


def test_predictor_api_and_checkpoint(tmp_path):
    """A save_checkpoint pair written by mxnet_tpu serves in the port: set
    input, forward, output shapes, internal outputs."""
    jsym = _resnet(10, 20, 16)
    dshape = (3, 3, 16, 16)
    args, aux = _weights(jsym, dshape, np.float32, seed=4)
    prefix = str(tmp_path / "r20")
    jsym.save(prefix + "-symbol.json")
    mx.nd.save(prefix + "-0003.params", dict(
        [("arg:" + k, mx.nd.array(v)) for k, v in args.items()]
        + [("aux:" + k, mx.nd.array(v)) for k, v in aux.items()]))
    data = np.random.RandomState(5).uniform(-1, 1, dshape)
    jp = JPredictor.from_checkpoint(prefix, 3, {"data": dshape},
                                    output_names=["fc1", "softmax"])
    jp.forward(data=data)
    pp = mt.Predictor.from_checkpoint(prefix, 3, {"data": dshape},
                                      dev_type="cpu",
                                      output_names=["fc1", "softmax"])
    assert pp.num_outputs == 2
    pp.set_input("data", data)
    pp.forward()
    assert pp.get_output_shape(0) == (3, 10)
    for i in range(2):
        np.testing.assert_allclose(pp.get_output(i), jp.get_output(i),
                                   rtol=1e-4, atol=1e-5)
    with pytest.raises(mt.MXNetError, match="unknown input"):
        pp.set_input("bogus", data)
    with pytest.raises(mt.MXNetError, match="not found"):
        mt.Predictor.from_checkpoint(prefix, 3, {"data": dshape},
                                     dev_type="cpu", output_names=["nope"])


def test_default_device_is_the_card():
    """Predictor and ServedModel bind on gpu(0) unless asked for the CPU;
    without a CUDA device they raise instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    jsym = _resnet(10, 20, 16)
    args, aux = _weights(jsym, (1, 3, 16, 16), np.float32)
    blob = mt.convert.params_from_numpy(args, aux, ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.Predictor(jsym.tojson(), blob, {"data": (1, 3, 16, 16)})
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.serving.ServedModel(jsym.tojson(), blob, {"data": (3, 16, 16)})
