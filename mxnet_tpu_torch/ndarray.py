"""NDArray over ``torch.Tensor`` (counterpart: mxnet_tpu/ndarray.py).

An NDArray owns one tensor on its context's device.  ``x[:] = v`` and
``copyto`` rebind or fill that tensor; there are no views yet (the serving
path never takes one).

The ``.params`` framing (``_write_entry`` / ``_read_entries``) is the same
byte format as the JAX package's: a file written by either package loads in
the other, byte for byte.  bfloat16 entries travel as their raw 16-bit
patterns, so no numpy bfloat16 type is needed.
"""
from __future__ import annotations

import io as _io
import os
import struct

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context

__all__ = ["NDArray", "array", "zeros", "load", "save", "serialize_arrays",
           "deserialize_arrays", "torch_dtype"]

_NP2TORCH = {np.dtype("float32"): torch.float32,
             np.dtype("float64"): torch.float64,
             np.dtype("float16"): torch.float16,
             np.dtype("uint8"): torch.uint8,
             np.dtype("int32"): torch.int32,
             np.dtype("int8"): torch.int8,
             np.dtype("int64"): torch.int64}
_TORCH2NP = {v: k for k, v in _NP2TORCH.items()}

# .params dtype codes (parity: mxnet_tpu/ndarray.py _DTYPE_CODE/_BF16_CODE)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
               torch.bfloat16: 100}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}
_MAGIC = 0xF993FAC9


def torch_dtype(dtype):
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    dt = np.dtype(dtype)
    if dt.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        return torch.bfloat16
    try:
        return _NP2TORCH[dt]
    except KeyError:
        raise MXNetError("unsupported dtype %s" % dt)


class NDArray(object):
    """An array on one device (parity: mx.nd.NDArray)."""

    __slots__ = ("_data", "_ctx", "writable", "__weakref__")

    def __init__(self, data, ctx=None, writable=True):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %s"
                             % type(data).__name__)
        self._data = data
        self._ctx = ctx
        self.writable = writable

    @property
    def value(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    def _set_value(self, t):
        """Rebind the contents; the array stays on its own device."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        if t.device != self._data.device:
            t = t.to(self._data.device)
        self._data = t

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        """numpy dtype of the contents (``torch.bfloat16`` for bfloat16)."""
        return _TORCH2NP.get(self._data.dtype, self._data.dtype)

    @property
    def context(self):
        if self._ctx is not None:
            return self._ctx
        dev = self._data.device
        return Context("gpu", dev.index or 0) if dev.type == "cuda" \
            else Context("cpu", 0)

    def asnumpy(self):
        """Blocking copy to host numpy (bfloat16 comes back as float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def copyto(self, other):
        """Copy into another NDArray or onto a Context."""
        if isinstance(other, NDArray):
            other._set_value(self._data.to(other._data.dtype).clone())
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True),
                           ctx=other)
        raise MXNetError("copyto does not support type %s" % type(other))

    def as_in_context(self, context):
        if context == self.context:
            return self
        return self.copyto(context)

    def __setitem__(self, key, value):
        if not self.writable:
            raise MXNetError("NDArray is not writable")
        if isinstance(value, NDArray):
            value = value.value
        if not isinstance(value, torch.Tensor):
            value = _host_tensor(np.asarray(value), self._data.dtype)
        value = value.to(self._data.device, self._data.dtype)
        if isinstance(key, slice) and key == slice(None):
            if tuple(value.shape) == self.shape:
                self._set_value(value.clone())
            else:
                self._set_value(value.expand(self.shape).clone())
            return
        new = self._data.clone()
        new[key] = value
        self._set_value(new)

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self.context)


def _host_tensor(npv, dtype):
    """A CPU tensor of ``dtype`` from a numpy array."""
    dtype = torch_dtype(dtype)
    if npv.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(npv, order="C").view(np.int16))
        return t.view(torch.bfloat16).to(dtype)
    if dtype == torch.bfloat16:
        return torch.from_numpy(
            np.array(npv, dtype=np.float32, order="C")).to(dtype)
    return torch.from_numpy(
        np.array(npv, dtype=_TORCH2NP[dtype], copy=True, order="C"))


def zeros(shape, ctx=None, dtype=np.float32):
    """(parity: mx.nd.zeros)"""
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=ctx.torch_device()), ctx=ctx)


def array(source_array, ctx=None, dtype=None):
    """Create an NDArray from an array-like (parity: mx.nd.array: float64
    and int64 sources become float32 and int32 unless ``dtype`` says)."""
    ctx = ctx or current_context()
    if isinstance(source_array, NDArray):
        source_array = source_array.value
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return NDArray(t.to(ctx.torch_device(), copy=True), ctx=ctx)
    arr = np.asarray(source_array)
    if dtype is None:
        dtype = {np.dtype(np.float64): np.float32,
                 np.dtype(np.int64): np.int32}.get(arr.dtype, arr.dtype)
    return NDArray(_host_tensor(arr, dtype).to(ctx.torch_device()), ctx=ctx)


# ------------------------------------------------------------- serialization
def _entry_bytes(arr):
    """(dtype code, shape, raw C-order bytes) of an NDArray, tensor or
    numpy array."""
    if isinstance(arr, NDArray):
        arr = arr.value
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        code = _DTYPE_CODE.get(t.dtype)
        if code is None:
            raise MXNetError("cannot serialize dtype %s" % t.dtype)
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return code, tuple(t.shape), raw.numpy().tobytes()
    npv = np.asarray(arr)
    return _DTYPE_CODE[torch_dtype(npv.dtype)], npv.shape, npv.tobytes()


def _write_entry(f, name, arr):
    """One named entry in the ``.params`` framing (parity:
    mxnet_tpu/ndarray.py ``_write_entry``)."""
    code, shape, raw = _entry_bytes(arr)
    nb = name.encode("utf-8")
    f.write(struct.pack("<I", len(nb)))
    f.write(nb)
    f.write(struct.pack("<I", code))
    f.write(struct.pack("<I", len(shape)))
    f.write(struct.pack("<%dq" % len(shape), *shape))
    f.write(raw)


def _read_entries(f, where):
    """Yield ``(name, CPU tensor)`` per entry (parity: mxnet_tpu/ndarray.py
    ``_read_entries``)."""
    magic, _ = struct.unpack("<QQ", f.read(16))
    if magic != _MAGIC:
        raise MXNetError("invalid NDArray file format: %s" % (where,))
    n = struct.unpack("<Q", f.read(8))[0]
    for _ in range(n):
        ln = struct.unpack("<I", f.read(4))[0]
        name = f.read(ln).decode("utf-8")
        code = struct.unpack("<I", f.read(4))[0]
        ndim = struct.unpack("<I", f.read(4))[0]
        shape = struct.unpack("<%dq" % ndim, f.read(8 * ndim)) \
            if ndim else ()
        if code not in _CODE_DTYPE:
            raise MXNetError("unknown dtype code %d in %s" % (code, where))
        dt = _CODE_DTYPE[code]
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * dt.itemsize
        buf = f.read(nbytes)
        if len(buf) < nbytes:
            raise MXNetError("truncated NDArray file: %s" % (where,))
        if dt == torch.bfloat16:
            t = torch.from_numpy(np.frombuffer(buf, np.int16).copy()) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.frombuffer(buf, _TORCH2NP[dt]).copy())
        yield name, t.reshape(shape)


def _serialize(items):
    f = _io.BytesIO()
    f.write(struct.pack("<QQ", _MAGIC, 0))
    f.write(struct.pack("<Q", len(items)))
    for name, arr in items:
        _write_entry(f, name, arr)
    return f.getvalue()


def serialize_arrays(data):
    """``{name: array}`` (NDArray, tensor or numpy) to ``.params`` bytes."""
    return _serialize(list(data.items()))


def deserialize_arrays(blob):
    """``.params`` bytes to ``{name: CPU tensor}``."""
    return dict(_read_entries(_io.BytesIO(blob), "<bytes>"))


def save(fname, data):
    """Save a dict or list of NDArrays as a ``.params`` file, through a
    temporary file and a rename so a reader never sees half a file."""
    if isinstance(data, dict):
        items = list(data.items())
    else:
        arrays = list(data)
        if not all(isinstance(a, NDArray) for a in arrays):
            raise MXNetError("save only supports NDArray contents")
        items = [("", a) for a in arrays]
    tmp = "%s.tmp-%d" % (fname, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(_serialize(items))
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(fname, ctx=None):
    """Load a ``.params`` file onto ``ctx`` (default: the current context).
    Returns ``{name: NDArray}``, or a list when the entries are unnamed."""
    ctx = ctx or current_context()
    with open(fname, "rb") as f:
        entries = list(_read_entries(f, fname))
    arrays = [NDArray(t.to(ctx.torch_device()), ctx=ctx) for _, t in entries]
    names = [n for n, _ in entries]
    if any(names):
        return dict(zip(names, arrays))
    return arrays
