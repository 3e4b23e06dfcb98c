"""The transformer LM through mxnet_tpu_torch's Predictor against mxnet_tpu's,
on one ``.params`` blob: a 2-layer, hidden-64, 4-head, T=128, vocab-97 LM in
float64 (1e-9), the port loading its own JSON and the JAX package's JSON of
the same graph (attention's ``scale='None'``), internal outputs, and the
attention rung each implementation takes."""
import jax
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import name as jname
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.predictor import Predictor as JPredictor
from mxnet_tpu_torch import name as pname
from mxnet_tpu_torch.models import transformer as ptransformer
from mxnet_tpu_torch.ops import attention as pattn
from test_torch_threads import torch_threads_per_worker  # noqa: F401

CFG = dict(vocab_size=97, seq_len=128, num_layers=2, num_hidden=64,
           num_heads=4)
BATCH = 2
SHAPES = {"data": (BATCH, CFG["seq_len"]),
          "softmax_label": (BATCH, CFG["seq_len"])}
F64 = {"data": np.float64, "softmax_label": np.float64}


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _jsym(**kw):
    with jname.NameManager():
        return jtransformer.get_symbol(**dict(CFG, **kw))


def _psym(**kw):
    with pname.NameManager():
        return ptransformer.get_symbol(**dict(CFG, **kw))


def _weights(sym, dtype, seed=0):
    """N(0, 0.02) weights and biases, LayerNorm gamma near 1."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    out = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in SHAPES:
            continue
        v = rng.randn(*s) * 0.02
        if n.endswith("_gamma"):
            v = 1.0 + rng.randn(*s) * 0.1
        out[n] = v.astype(dtype)
    return out


def _blob(args):
    return mx.nd.serialize_arrays({"arg:" + k: v for k, v in args.items()})


def _tokens(seed=1):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], SHAPES["data"]).astype(np.float64)


def test_lm_predictor_f64_matches_mxnet_tpu(f64):
    jsym = _jsym()
    blob = _blob(_weights(jsym, np.float64))
    tokens = _tokens()
    jp = JPredictor(jsym, blob, SHAPES, input_types=F64)
    jp.forward(data=tokens)
    want = jp.get_output(0)
    pp = mt.Predictor(_psym().tojson(), blob, SHAPES, dev_type="cpu",
                      input_types=F64)
    pp.forward(data=tokens)
    got = pp.get_output(0)
    assert got.dtype == np.float64
    assert got.shape == want.shape == (BATCH * CFG["seq_len"],
                                       CFG["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-12)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_lm_attn_impl_f64(impl, f64):
    """Forcing either rung in the graph gives the same probabilities as the
    JAX package's reference rung: on a CPU tensor 'flash' is the kernel's
    plain version."""
    jsym = _jsym(attn_impl="xla")
    blob = _blob(_weights(jsym, np.float64, seed=2))
    tokens = _tokens(seed=3)
    jp = JPredictor(jsym, blob, SHAPES, input_types=F64)
    jp.forward(data=tokens)
    pp = mt.Predictor(_psym(attn_impl=impl), blob, SHAPES, dev_type="cpu",
                      input_types=F64)
    pp.forward(data=tokens)
    np.testing.assert_allclose(pp.get_output(0), jp.get_output(0),
                               rtol=1e-9, atol=1e-12)


def test_lm_loads_both_json(f64):
    """The port's own JSON and the JAX package's JSON of the same graph load
    into the port's Predictor and give one result, equal to the graph built
    as a Symbol.  Both carry scale='None' on every attention node."""
    jjson = _jsym().tojson()
    pjson = _psym().tojson()
    assert '"scale": "None"' in jjson and '"scale": "None"' in pjson
    blob = _blob(_weights(_jsym(), np.float64, seed=4))
    tokens = _tokens(seed=5)
    outs = []
    for sym in (pjson, jjson, _psym()):
        pp = mt.Predictor(sym, blob, SHAPES, dev_type="cpu", input_types=F64)
        pp.forward(data=tokens)
        outs.append(pp.get_output(0))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_lm_internal_outputs(f64):
    """output_names reaches LM internals: an attention output (B, H, T, D)
    and the logits, both equal to mxnet_tpu's."""
    jsym = _jsym()
    blob = _blob(_weights(jsym, np.float64, seed=6))
    tokens = _tokens(seed=7)
    names = ["layer1_attn", "lm_head"]
    jp = JPredictor(jsym, blob, SHAPES, input_types=F64, output_names=names)
    jp.forward(data=tokens)
    pp = mt.Predictor(_psym().tojson(), blob, SHAPES, dev_type="cpu",
                      input_types=F64, output_names=names)
    pp.forward(data=tokens)
    assert pp.num_outputs == 2
    assert pp.get_output_shape(0) == (BATCH, CFG["num_heads"],
                                      CFG["seq_len"],
                                      CFG["num_hidden"] // CFG["num_heads"])
    for i in range(2):
        np.testing.assert_allclose(pp.get_output(i), jp.get_output(i),
                                   rtol=1e-9, atol=1e-12)


def test_lm_cpu_auto_never_takes_the_kernel(monkeypatch):
    """On the CPU 'auto' runs the reference rung, as the JAX package does
    off the TPU; the kernel's launch counter does not move."""
    calls = []
    real = pattn.attention_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(pattn, "attention_reference", counted)
    from mxnet_tpu_torch.ops import flash_attention as pfa
    before = pfa.launches
    sym = _psym()
    args = _weights(sym, np.float32, seed=8)
    blob = mt.convert.params_from_numpy(args, {}, ctx=mt.cpu())
    pp = mt.Predictor(sym, blob, SHAPES, dev_type="cpu")
    pp.forward(data=_tokens(seed=9))
    out = pp.get_output(0)
    assert np.isfinite(out).all()
    assert len(calls) == CFG["num_layers"] and pfa.launches == before
