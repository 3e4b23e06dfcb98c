"""Per-op forward parity, mxnet_tpu_torch vs mxnet_tpu, in float64 (1e-9),
for the ops the transformer LM adds: Embedding (with its truncation, wrap
and NaN semantics), position_ids, LayerNorm, transpose, slice_axis,
softmax_mask and dot_product_attention under each ``impl``; and their shape
inference.

mxnet_tpu's ``impl='flash'`` needs its Pallas kernel, which runs on the CPU
only in interpret mode and in float32; the port's 'flash' rung (its plain
version on a CPU tensor) is held here to the JAX reference rung in float64,
and to the Pallas kernel in interpret mode in test_torch_flash_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ATT = [(2, 3, 16, 8)] * 3

CASES = [
    # op, attrs, input shapes, JAX attrs where they differ
    ("Embedding", {"input_dim": 11, "output_dim": 5}, [(3, 7), (11, 5)], None),
    ("Embedding", {"input_dim": 11, "output_dim": 5}, [(2, 3, 4), (11, 5)],
     None),
    ("position_ids", {"seq_len": 7}, [(3, 7)], None),
    ("position_ids", {}, [(2, 9)], None),
    ("LayerNorm", {}, [(2, 3, 5), (5,), (5,)], None),
    ("LayerNorm", {"axis": 1, "eps": 1e-3}, [(3, 4, 4), (4,), (4,)], None),
    ("LayerNorm", {"axis": 1}, [(6, 4), (4,), (4,)], None),
    ("transpose", {"axes": (2, 0, 3, 1, 4)}, [(2, 3, 3, 4, 5)], None),
    ("transpose", {}, [(2, 3, 4)], None),
    ("slice_axis", {"axis": 0, "begin": 1, "end": 2}, [(3, 2, 4)], None),
    ("slice_axis", {"axis": -1, "begin": -3, "end": None}, [(3, 2, 5)],
     None),
    ("slice_axis", {"axis": 1, "begin": 1, "end": -1}, [(3, 5, 2)], None),
    ("softmax_mask", {}, [(2, 3, 6), (2, 3, 6)], None),
    ("dot_product_attention", {"causal": True, "impl": "xla"}, ATT, None),
    ("dot_product_attention", {"causal": False, "impl": "xla",
                               "scale": 0.3}, ATT, None),
    ("dot_product_attention", {"causal": True}, ATT, None),
    ("dot_product_attention", {"causal": True, "impl": "flash"}, ATT,
     {"causal": True, "impl": "xla"}),
    ("dot_product_attention", {"causal": False, "impl": "flash",
                               "scale": 0.3}, ATT,
     {"causal": False, "impl": "xla", "scale": 0.3}),
]
IDS = ["%d-%s" % (i, c[0]) for i, c in enumerate(CASES)]


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _inputs(op, shapes, seed):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*s) for s in shapes]
    if op == "Embedding":
        n = shapes[1][0]
        # fractional tokens truncate; [-n, 0) wraps; < -n and >= n are NaN
        idx = rng.uniform(-n - 3, n + 3, shapes[0])
        idx.flat[:6] = [2.7, -1.5, n, -n, -n - 1, n - 0.5]
        out[0] = idx
    if op == "softmax_mask":
        out[1] = (rng.rand(*shapes[1]) > 0.3).astype(np.float64)
        out[1][..., 0] = 1.0
    return out


def _run(get_op, conv, name, attrs, ins):
    op = get_op(name)
    out = op.make_callable(op.normalize_attrs(attrs), False)(
        *[conv(a) for a in ins])
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_f64_matches_mxnet_tpu(case, f64):
    name, attrs, shapes, jattrs = case
    ins = _inputs(name, shapes, seed=len(IDS))
    jout = _run(jget_op, jnp.asarray, name, jattrs or attrs, ins)
    pout = _run(pget_op, torch.from_numpy, name, attrs, ins)
    assert len(pout) == len(jout)
    for p, j in zip(pout, jout):
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape and p.numpy().dtype == j.dtype
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-9, atol=1e-9)


def test_embedding_nan_and_wrap_rows(f64):
    """The Embedding case above has NaN rows exactly where mxnet_tpu's
    gather has them, and wraps -1.5 -> row n-1."""
    ins = _inputs("Embedding", CASES[0][2], seed=len(IDS))
    (p,) = _run(pget_op, torch.from_numpy, "Embedding", CASES[0][1], ins)
    (j,) = _run(jget_op, jnp.asarray, "Embedding", CASES[0][1], ins)
    pnan = np.isnan(p.numpy()).all(axis=-1)
    assert (pnan == np.isnan(np.asarray(j)).all(axis=-1)).all()
    assert pnan.flat[2] and pnan.flat[4] and not pnan.flat[3]
    np.testing.assert_array_equal(p.numpy()[0, 1], ins[1][-1])
    np.testing.assert_array_equal(p.numpy()[0, 0], ins[1][2])


INFER = [c for c in CASES if c[0] != "softmax_mask"]


@pytest.mark.parametrize("case", INFER,
                         ids=["%d-%s" % (i, c[0]) for i, c in
                              enumerate(INFER)])
def test_infer_shape_matches_mxnet_tpu(case):
    name, attrs, shapes, _ = case
    jop, pop = jget_op(name), pget_op(name)
    # data only where parameter shapes are deduced from it
    given = list(shapes) if name in ("dot_product_attention", "transpose",
                                     "slice_axis") \
        else [shapes[0]] + [None] * (len(shapes) - 1)
    jin, jouts, _ = jop.infer_shape(jop.normalize_attrs(attrs), given)
    pin, pouts, _ = pop.infer_shape(pop.normalize_attrs(attrs), given)
    assert [tuple(s) if s else s for s in pouts] == \
        [tuple(s) if s else s for s in jouts]
    assert [tuple(s) if s else s for s in pin] == \
        [tuple(s) if s else s for s in jin]


@pytest.mark.parametrize("raw,want", [("None", None), ("", None), (None, None),
                                      ("0.125", 0.125), (0.5, 0.5)])
def test_parse_float_reads_none(raw, want):
    """A float attribute written as 'None' by tojson reads back as None."""
    from mxnet_tpu_torch.ops.registry import parse_float
    assert parse_float(raw) == want
    op = pget_op("dot_product_attention")
    assert op.normalize_attrs({"scale": raw})["scale"] == want
