"""mxnet_tpu_torch NDArray and the .params format: blobs round-trip byte
for byte between the port and mxnet_tpu, both ways; params_from_numpy."""
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState


def _arrays(seed=0):
    rng = RS(seed)
    return {
        "arg:w32": rng.randn(3, 4).astype(np.float32),
        "arg:w64": rng.randn(2, 3, 2).astype(np.float64),
        "arg:h16": rng.randn(5).astype(np.float16),
        "aux:bf16": rng.randn(2, 2).astype(ml_dtypes.bfloat16),
        "aux:i32": rng.randint(-9, 9, (4,)).astype(np.int32),
        "aux:i64": rng.randint(-9, 9, (2, 2)).astype(np.int64),
        "aux:i8": rng.randint(-9, 9, (3,)).astype(np.int8),
        "aux:u8": rng.randint(0, 255, (3,)).astype(np.uint8),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


def test_serialize_byte_identical_both_ways():
    arrs = _arrays()
    jax_blob = mx.nd.serialize_arrays(arrs)
    assert mt.nd.serialize_arrays(arrs) == jax_blob
    # port tensors (what the port holds) serialize to the same bytes
    back = mt.nd.deserialize_arrays(jax_blob)
    assert list(back) == list(arrs)
    as_nd = {k: mt.nd.NDArray(v, ctx=mt.cpu()) for k, v in back.items()}
    assert mt.nd.serialize_arrays(as_nd) == jax_blob
    # and mxnet_tpu reads the port's bytes back unchanged
    again = mx.nd.deserialize_arrays(mt.nd.serialize_arrays(as_nd))
    for k, v in arrs.items():
        assert again[k].dtype == v.dtype and again[k].shape == v.shape
        np.testing.assert_array_equal(again[k].astype(np.float64),
                                      v.astype(np.float64))
    assert back["aux:bf16"].dtype == torch.bfloat16


def test_params_files_cross_load(tmp_path):
    rng = RS(1)
    src = {"arg:a": rng.randn(3, 2).astype(np.float32),
           "aux:b": rng.randint(-5, 5, (4,)).astype(np.int32)}
    jfile = str(tmp_path / "jax.params")
    mx.nd.save(jfile, {k: mx.nd.array(v, dtype=v.dtype)
                       for k, v in src.items()})
    loaded = mt.nd.load(jfile, ctx=mt.cpu())
    for k, v in src.items():
        assert loaded[k].dtype == v.dtype
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)
    pfile = str(tmp_path / "port.params")
    mt.nd.save(pfile, loaded)
    with open(jfile, "rb") as a, open(pfile, "rb") as b:
        assert a.read() == b.read()
    jl = mx.nd.load(pfile)
    for k, v in src.items():
        np.testing.assert_array_equal(jl[k].asnumpy(), v)
    # unnamed entries load as a list, as in mxnet_tpu
    mt.nd.save(pfile, [loaded["arg:a"], loaded["arg:a"]])
    lst = mt.nd.load(pfile, ctx=mt.cpu())
    assert isinstance(lst, list) and len(lst) == 2
    assert len(mx.nd.load(pfile)) == 2


def test_ndarray_basics():
    ctx = mt.cpu()
    z = mt.nd.zeros((2, 3), ctx=ctx)
    assert z.shape == (2, 3) and z.dtype == np.float32 and z.context == ctx
    # float64/int64 sources default to float32/int32, as in mxnet_tpu
    a = mt.nd.array(np.arange(6.0).reshape(2, 3), ctx=ctx)
    assert a.dtype == np.float32
    assert mt.nd.array(np.arange(3), ctx=ctx).dtype == np.int32
    assert mt.nd.array(np.arange(3.0), ctx=ctx, dtype=np.float64).dtype \
        == np.float64
    z[:] = np.ones((2, 3))
    np.testing.assert_array_equal(z.asnumpy(), np.ones((2, 3)))
    z[:] = 4.0                                   # broadcast fill
    np.testing.assert_array_equal(z.asnumpy(), np.full((2, 3), 4.0))
    z[1] = np.zeros(3)
    np.testing.assert_array_equal(z.asnumpy()[1], np.zeros(3))
    a.copyto(z)
    np.testing.assert_array_equal(z.asnumpy(), a.asnumpy())
    c = a.copyto(mt.cpu())
    assert c is not a and c.value.data_ptr() != a.value.data_ptr()
    assert a.as_in_context(ctx) is a
    ro = mt.nd.NDArray(torch.zeros(2), writable=False)
    with pytest.raises(mt.MXNetError):
        ro[:] = 1.0


def test_params_from_numpy_keeps_dtype():
    rng = RS(2)
    blob = mt.convert.params_from_numpy(
        {"w": rng.randn(2, 2), "b": rng.randn(2).astype(np.float32)},
        {"m": rng.randn(2)}, ctx=mt.cpu())
    assert sorted(blob) == ["arg:b", "arg:w", "aux:m"]
    assert blob["arg:w"].dtype == np.float64
    assert blob["arg:b"].dtype == np.float32
    assert all(v.context == mt.cpu() for v in blob.values())


def test_default_context_is_the_card():
    assert mt.current_context() == mt.gpu(0)
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.nd.zeros((2,))
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.convert.params_from_numpy({"w": np.zeros(2)}, {})


def test_asnumpy_is_a_copy_on_the_host():
    """C9: ``asnumpy()`` of a CPU array handed back a numpy view of the
    array's storage, so a later in-place write (``x[:] = v``, an
    executor's next output, an optimizer step) changed the numpy array a
    caller already held; the JAX package's arrays never change under it.
    Both dtype paths copy now."""
    a = mt.nd.array(np.arange(4.0), ctx=mt.cpu())
    held = a.asnumpy()
    a[:] = 7.0
    np.testing.assert_array_equal(held, np.arange(4.0))
    b = mt.nd.array(np.arange(4.0), ctx=mt.cpu(), dtype="bfloat16")
    held = b.asnumpy()
    b[:] = 7.0
    np.testing.assert_array_equal(np.asarray(held, np.float32),
                                  np.arange(4.0, dtype=np.float32))
