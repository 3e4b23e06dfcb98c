"""NDArray over ``torch.Tensor`` (counterpart: mxnet_tpu/ndarray.py).

An NDArray holds one tensor on its context's device.  Every imperative op
runs eagerly through ``ops.registry.imperative_invoke``, and ``mx.nd.<op>``
exists for every registered op.  Writes are in place: ``x[:] = v``,
``x[key] = v``, ``+=`` and the optimizers' updates copy into the tensor's
storage (``_set_value``), so a *view* (``x[1:3]``, ``x[2]``,
``x.reshape(...)``, a torch view of the same storage, as the reference's
Slice/At/Reshape are views of one chunk) sees every write to its base, and a
write through it lands in the base.  An op never hands back a tensor that
shares memory with its inputs: such an output is copied.

The ``.params`` framing (``_write_entry`` / ``_read_entries``) is the same
byte format as the JAX package's: a file written by either package loads in
the other, byte for byte.  bfloat16 entries travel as their raw 16-bit
patterns, so no numpy bfloat16 type is needed.  A bfloat16 array's
``dtype`` and ``asnumpy()`` use ml_dtypes' numpy bfloat16, as the JAX
package's do, when ml_dtypes imports; without it ``dtype`` is
``torch.bfloat16`` and ``asnumpy()`` widens to float32.
"""
from __future__ import annotations

import io as _io
import struct

import numpy as np
import torch

from .base import (MXNetError, _TORCH2NP, atomic_write, np_bfloat16,
                   numpy_dtype, torch_dtype)
from .context import Context, current_context
from . import engine as _engine
from . import ops as _ops  # noqa: F401  (every op, before the frontends)
from .ops import registry as _reg

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "load", "save", "imdecode", "onehot_encode",
           "waitall",
           "maximum", "minimum", "serialize_arrays", "deserialize_arrays",
           "save_raw_bytes", "load_from_raw_bytes", "load_arrays",
           "validate_file", "torch_dtype"]

# the builtins the op frontends below shadow (slice, sum, max, ...)
_pyslice = slice

# .params dtype codes (parity: mxnet_tpu/ndarray.py _DTYPE_CODE/_BF16_CODE)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
               torch.bfloat16: 100}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}
_MAGIC = 0xF993FAC9


def _shares_memory(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


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
        """The underlying ``torch.Tensor`` (a view's is a torch view of its
        base's storage)."""
        return self._data

    def _set_value(self, t):
        """Write ``t`` into this array, in place when the shapes agree (at
        this array's dtype when it is a view); a whole array of another
        shape or dtype is rebound to ``t`` on its own device.  A view
        cannot change shape."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        cur = self._data
        if tuple(t.shape) == tuple(cur.shape) and (
                t.dtype == cur.dtype or cur._base is not None):
            if t is not cur:
                if t.device == cur.device and _shares_memory(t, cur):
                    t = t.clone()
                cur.copy_(t)
            return
        if cur._base is not None:
            raise MXNetError("cannot write an array of shape %s into a view "
                             "of shape %s" % (tuple(t.shape),
                                              tuple(cur.shape)))
        if t.device != cur.device:
            t = t.to(cur.device)
        if cur.device.type == "cpu" and cur.is_pinned():
            t = Context("cpu_pinned").place(t)
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
        """numpy dtype of the contents: bfloat16 is ml_dtypes' bfloat16,
        or ``torch.bfloat16`` when ml_dtypes does not import."""
        return numpy_dtype(self._data.dtype)

    @property
    def context(self):
        if self._ctx is not None:
            return self._ctx
        dev = self._data.device
        return Context("gpu", dev.index or 0) if dev.type == "cuda" \
            else Context("cpu", 0)

    @property
    def T(self):
        return _invoke("transpose", [self], {})

    # ------------------------------------------------------------ conversions
    def asnumpy(self):
        """Blocking copy to host numpy.  bfloat16 comes back as ml_dtypes'
        bfloat16, built from the raw 16-bit patterns, or as float32 when
        ml_dtypes does not import (numpy has no bfloat16 of its own).  A
        copy on the CPU too: the array's later in-place writes never reach
        the numpy array."""
        t = self._data.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            bf16 = np_bfloat16()
            if bf16 is None:
                return t.float().numpy()
            return t.view(torch.int16).numpy().view(bf16)
        return t.numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("the current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        return _invoke("Cast", [self], {"dtype": dtype})

    def copy(self):
        return _invoke("_copy", [self], {})

    def copyto(self, other):
        """Copy into another NDArray (at its dtype) or onto a Context."""
        if isinstance(other, NDArray):
            if self.shape == other.shape:
                other._set_value(self._data)
            else:
                other._set_value(self._data.to(other._data.dtype).clone())
            return other
        if isinstance(other, Context):
            return NDArray(other.place(self._data, copy=True), ctx=other)
        raise MXNetError("copyto does not support type %s" % type(other))

    def as_in_context(self, context):
        if context == self.context:
            return self
        return self.copyto(context)

    def wait_to_read(self):
        """Block until the array's pending work on its card is done."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    # ------------------------------------------------------------------ views
    def _view(self, t):
        return NDArray(t, ctx=self._ctx, writable=self.writable)

    def reshape(self, shape):
        """Memory-sharing reshape view (parity: MXNDArrayReshape), with
        MXNet's special codes 0, -1, -2, -3, -4."""
        from .ops.matrix import infer_reshape
        return self._view(self._data.view(
            infer_reshape(self.shape, tuple(shape))))

    def _slice(self, start, stop):
        start = 0 if start is None else int(start)
        stop = self.shape[0] if stop is None else int(stop)
        return self._view(self._data[start:stop])

    def _at(self, idx):
        return self._view(self._data[int(idx)])

    def __getitem__(self, key):
        if isinstance(key, int):
            if key >= self.shape[0]:
                raise IndexError("index out of range")
            return self._at(key)
        if isinstance(key, _pyslice):
            if key.step is not None and key.step != 1:
                raise MXNetError("slice step is not supported")
            return self._slice(key.start, key.stop)
        raise MXNetError("NDArray only supports int/slice indexing for reads")

    def __setitem__(self, key, value):
        """``x[:] = v`` fills the whole array (v broadcast); ``x[key] = v``
        writes the part ``key`` selects.  In place either way."""
        if not self.writable:
            raise MXNetError("NDArray is not writable")
        cur = self._data
        if isinstance(value, NDArray):
            value = value.value
        if isinstance(value, torch.Tensor):
            value = value.to(cur.device, cur.dtype)
            if _shares_memory(value, cur):
                value = value.clone()
        elif isinstance(value, np.ndarray):
            value = _host_tensor(value, cur.dtype).to(cur.device)
        else:
            value = torch.as_tensor(value, dtype=cur.dtype, device=cur.device)
        if isinstance(key, _pyslice) and key.start is None \
                and key.stop is None:
            cur.copy_(value)
        else:
            cur[key] = value

    # ------------------------------------------------------------- arithmetic
    def __add__(self, other):
        return _binary("_plus", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __iadd__(self, other):
        self._set_value(self.__add__(other).value)
        return self

    def __sub__(self, other):
        return _binary("_minus", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _scalar("_rminus_scalar", self, other)

    def __isub__(self, other):
        self._set_value(self.__sub__(other).value)
        return self

    def __mul__(self, other):
        return _binary("_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __imul__(self, other):
        self._set_value(self.__mul__(other).value)
        return self

    def __truediv__(self, other):
        return _binary("_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _scalar("_rdiv_scalar", self, other)

    def __itruediv__(self, other):
        self._set_value(self.__truediv__(other).value)
        return self

    def __pow__(self, other):
        return _binary("_power", "_power_scalar", self, other)

    def __rpow__(self, other):
        return _scalar("_rpower_scalar", self, other)

    def __neg__(self):
        return _invoke("negative", [self], {})

    def __eq__(self, other):
        return _binary("_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        return _binary("_not_equal", "_not_equal_scalar", self, other)

    def __gt__(self, other):
        return _binary("_greater", "_greater_scalar", self, other)

    def __ge__(self, other):
        return _binary("_greater_equal", "_greater_equal_scalar", self, other)

    def __lt__(self, other):
        return _binary("_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _binary("_lesser_equal", "_lesser_equal_scalar", self, other)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise MXNetError("The truth value of an NDArray is ambiguous; "
                         "use asscalar()")

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self.context)

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def __reduce__(self):
        # pickling copies a view out; the optimizer states travel this way
        ctx = self.context
        return (_rebuild_ndarray, (self.asnumpy(), str(self._data.dtype),
                                   ctx.device_type, ctx.device_id))


def _rebuild_ndarray(npv, dtype, device_type, device_id):
    return array(npv, ctx=Context(device_type, device_id),
                 dtype=getattr(torch, dtype.split(".")[-1]))


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


# ---------------------------------------------------------- invoke helpers
def _own(t, inputs):
    """``t`` as a contiguous tensor of its own: copied when it shares
    memory with an input (a view op's output)."""
    if any(_shares_memory(t, i) for i in inputs if i.device == t.device):
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous()


def _invoke(op_name, nds, attrs, ctx=None, out=None):
    """Run one op on NDArrays (parity: mxnet_tpu/ndarray.py ``_invoke``):
    the visible outputs come back as new NDArrays, or are written into
    ``out``; the aux updates are written back into the trailing aux
    inputs.  An op with inputs runs on their device; ``ctx`` places an op
    without any."""
    ctx = nds[0].context if nds else (ctx or current_context())
    arrays = [a.value for a in nds]
    outs, op = _reg.imperative_invoke(
        op_name, arrays, attrs, device=None if nds else ctx.torch_device())
    n_vis = op.num_outputs_for(op.normalize_attrs(attrs or {}))
    vis = [_own(v, arrays) for v in outs[:n_vis]]
    if ctx.device_type == "cpu_pinned":
        vis = [ctx.place(v) for v in vis]
    if op.num_aux:
        for aux_nd, new_val in zip(nds[-op.num_aux:],
                                   outs[n_vis:n_vis + op.num_aux]):
            aux_nd._set_value(new_val)
    if out is not None:
        outs_nd = out if isinstance(out, (list, tuple)) else [out]
        for o, v in zip(outs_nd, vis):
            o._set_value(v)
        _engine.maybe_wait(outs_nd)
        return out
    # NaiveEngine: the copies above (a view op's output, the aux writes)
    # are done too before the op returns
    _engine.maybe_wait(vis)
    wrapped = [NDArray(v, ctx=ctx) for v in vis]
    return wrapped[0] if len(wrapped) == 1 else tuple(wrapped)


def _binary(op, scalar_op, lhs, rhs):
    if isinstance(rhs, NDArray):
        if lhs.shape == rhs.shape:
            return _invoke(op, [lhs, rhs], {})
        return _invoke(_bcast_name(op), [lhs, rhs], {})
    return _scalar(scalar_op, lhs, rhs)


def _bcast_name(op):
    return {"_plus": "broadcast_add", "_minus": "broadcast_sub",
            "_mul": "broadcast_mul", "_div": "broadcast_div",
            "_power": "broadcast_power", "_equal": "broadcast_equal",
            "_not_equal": "broadcast_not_equal",
            "_greater": "broadcast_greater",
            "_greater_equal": "broadcast_greater_equal",
            "_lesser": "broadcast_lesser",
            "_lesser_equal": "broadcast_lesser_equal",
            "_maximum": "broadcast_maximum",
            "_minimum": "broadcast_minimum"}[op]


def _scalar(scalar_op, data, scalar):
    return _invoke(scalar_op, [data], {"scalar": float(scalar)})


# ------------------------------------------------------------- constructors
def _creation(op, shape, ctx, dtype, **extra):
    if isinstance(shape, int):
        shape = (shape,)
    return _invoke(op, [], dict(shape=tuple(shape),
                                dtype=_reg.parse_dtype(dtype), **extra),
                   ctx=ctx)


def empty(shape, ctx=None, dtype=np.float32):
    """(parity: mx.nd.empty; zero-filled, as the JAX package's)"""
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=np.float32):
    """(parity: mx.nd.zeros)"""
    return _creation("_zeros", shape, ctx, dtype)


def ones(shape, ctx=None, dtype=np.float32):
    return _creation("_ones", shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=np.float32):
    return _creation("_full", shape, ctx, dtype, value=float(val))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=np.float32):
    """(parity: mx.nd.arange, with MXNet's ``repeat``)"""
    return _invoke("_arange", [], {
        "start": float(start), "stop": None if stop is None else float(stop),
        "step": float(step), "repeat": int(repeat),
        "dtype": _reg.parse_dtype(dtype)}, ctx=ctx)


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
        return NDArray(ctx.place(t, copy=True), ctx=ctx)
    arr = np.asarray(source_array)
    if dtype is None:
        dtype = {np.dtype(np.float64): np.float32,
                 np.dtype(np.int64): np.int32}.get(arr.dtype, arr.dtype)
    return NDArray(ctx.place(_host_tensor(arr, dtype)), ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """Join arrays along ``axis`` on the first array's device."""
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    ctx = arrays[0].context
    dev = arrays[0].value.device
    return NDArray(torch.cat([a.value.to(dev) for a in arrays], dim=axis),
                   ctx=ctx)


def onehot_encode(indices, out):
    """(parity: mx.nd.onehot_encode)"""
    return _invoke("one_hot", [indices], {"depth": out.shape[1]}, out=out)


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None, ctx=None):
    """Decode an image bytes string with OpenCV to a (1, C, H, W) float32
    NDArray, RGB, optionally clipped to ``clip_rect`` (x0, y0, x1, y1) and
    less ``mean`` (parity: mx.nd.imdecode)."""
    import cv2
    flag = cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE
    img = cv2.imdecode(np.frombuffer(str_img, dtype=np.uint8), flag)
    if channels == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    else:
        img = img[:, :, None]
    if any(clip_rect):
        x0, y0, x1, y1 = clip_rect
        img = img[y0:y1, x0:x1]
    arr = np.transpose(img, (2, 0, 1))[None].astype(np.float32)
    if mean is not None:
        arr = arr - mean.asnumpy()
    res = array(arr, ctx=ctx)
    if out is not None:
        out._set_value(res.value)
        return out
    return res


def waitall():
    """Block until the pending work of every card in use is done (parity:
    MXNDArrayWaitAll), through the engine's wait."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        from . import engine as _engine
        _engine._wait([torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())])


def maximum(lhs, rhs):
    """Elementwise max of two arrays or an array and a scalar (parity:
    reference python/mxnet/ndarray.py maximum)."""
    if isinstance(lhs, NDArray):
        return _binary("_maximum", "_maximum_scalar", lhs, rhs)
    if isinstance(rhs, NDArray):
        return _binary("_maximum", "_maximum_scalar", rhs, lhs)
    return np.maximum(lhs, rhs)


def minimum(lhs, rhs):
    """Elementwise min of two arrays or an array and a scalar."""
    if isinstance(lhs, NDArray):
        return _binary("_minimum", "_minimum_scalar", lhs, rhs)
    if isinstance(rhs, NDArray):
        return _binary("_minimum", "_minimum_scalar", rhs, lhs)
    return np.minimum(lhs, rhs)


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
        yield name, _tensor_from_bytes(buf, dt, shape)


def _tensor_from_bytes(buf, dt, shape, offset=0):
    """A CPU tensor of torch dtype ``dt`` and ``shape`` read from ``buf``
    at ``offset`` (copied: the tensor owns its memory)."""
    count = int(np.prod(shape)) if shape else 1
    if dt == torch.bfloat16:
        t = torch.from_numpy(np.frombuffer(buf, np.int16, count,
                                           offset).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(buf, _TORCH2NP[dt], count,
                                           offset).copy())
    return t.reshape(shape)


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


def load_arrays(fname):
    """A ``.params`` file as ``{name: CPU tensor}``, nothing placed on a
    device (parity: mxnet_tpu/ndarray.py ``load_arrays``, the host loader
    of the checkpoint restore)."""
    with open(fname, "rb") as f:
        return dict(_read_entries(f, fname))


def validate_file(fname):
    """True when ``fname`` is a structurally complete ``.params`` file: the
    magic, and every entry's framing and payload inside the file, walked
    with seeks (no array data is read).  A truncated or foreign file gives
    False (parity: mxnet_tpu/ndarray.py ``validate_file``;
    ``parallel.elastic.latest_checkpoint`` skips such candidates)."""
    try:
        with open(fname, "rb") as f:
            f.seek(0, 2)
            total = f.tell()
            f.seek(0)
            head = f.read(24)
            if len(head) < 24:
                return False
            magic, _, n = struct.unpack("<QQQ", head)
            if magic != _MAGIC:
                return False
            for _ in range(n):
                b = f.read(4)
                if len(b) < 4:
                    return False
                ln = struct.unpack("<I", b)[0]
                b = f.read(ln + 8)
                if len(b) < ln + 8:
                    return False
                code, ndim = struct.unpack("<II", b[ln:])
                b = f.read(8 * ndim)
                if len(b) < 8 * ndim or code not in _CODE_DTYPE:
                    return False
                shape = struct.unpack("<%dq" % ndim, b) if ndim else ()
                count = int(np.prod(shape)) if shape else 1
                end = f.tell() + count * _CODE_DTYPE[code].itemsize
                if end > total:
                    return False
                f.seek(end)
            return f.tell() <= total
    except OSError:
        return False


def save_raw_bytes(arr):
    """One NDArray as self-contained bytes (parity:
    mxnet_tpu/ndarray.py ``save_raw_bytes``, MXNDArraySaveRawBytes): the
    magic, the dtype code, ndim, the shape and the raw C-order data, the
    JAX package's layout byte for byte."""
    code, shape, raw = _entry_bytes(arr)
    return (struct.pack("<QII", _MAGIC, code, len(shape))
            + struct.pack("<%dq" % len(shape), *shape) + raw)


def load_from_raw_bytes(buf, ctx=None):
    """Inverse of :func:`save_raw_bytes`, onto ``ctx`` (default: the
    current context)."""
    buf = bytes(buf)
    if len(buf) < 16:
        raise MXNetError("invalid NDArray raw bytes: %d bytes" % len(buf))
    magic, code, ndim = struct.unpack_from("<QII", buf, 0)
    if magic != _MAGIC or code not in _CODE_DTYPE:
        raise MXNetError("invalid NDArray raw bytes")
    shape = struct.unpack_from("<%dq" % ndim, buf, 16)
    dt = _CODE_DTYPE[code]
    count = int(np.prod(shape)) if shape else 1
    if len(buf) < 16 + 8 * ndim + count * dt.itemsize:
        raise MXNetError("truncated NDArray raw bytes")
    ctx = ctx or current_context()
    return NDArray(ctx.place(_tensor_from_bytes(buf, dt, shape,
                                                16 + 8 * ndim)), ctx=ctx)


def save(fname, data):
    """Save a dict or list of NDArrays as a ``.params`` file, through
    ``base.atomic_write`` so a reader never sees half a file."""
    if isinstance(data, dict):
        items = list(data.items())
    else:
        arrays = list(data)
        if not all(isinstance(a, NDArray) for a in arrays):
            raise MXNetError("save only supports NDArray contents")
        items = [("", a) for a in arrays]
    with atomic_write(fname) as f:
        f.write(_serialize(items))


def load(fname, ctx=None):
    """Load a ``.params`` file onto ``ctx`` (default: the current context).
    Returns ``{name: NDArray}``, or a list when the entries are unnamed."""
    ctx = ctx or current_context()
    with open(fname, "rb") as f:
        entries = list(_read_entries(f, fname))
    arrays = [NDArray(ctx.place(t), ctx=ctx) for _, t in entries]
    names = [n for n, _ in entries]
    if any(names):
        return dict(zip(names, arrays))
    return arrays


# ------------------------------------------------- autogenerated op frontends
def _make_ndarray_function(op):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        nds = []
        for a in args:
            if isinstance(a, (list, tuple)):
                nds.extend(a)
            else:
                nds.append(a)
        # non-NDArray inputs go where the first NDArray lives
        place = next((a.context for a in nds if isinstance(a, NDArray)),
                     ctx)
        nds = [a if isinstance(a, NDArray) else array(a, ctx=place)
               for a in nds]
        if op.key_var_num_args and op.key_var_num_args not in kwargs:
            kwargs[op.key_var_num_args] = len(nds)
        return _invoke(op.name, nds, kwargs, ctx, out=out)

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def _init_ndarray_module(target):
    """Expose every registered op as a function (parity:
    _init_ndarray_module); the hand-written helpers (zeros, ones, ...) are
    never shadowed."""
    seen = {}
    for name in _reg.list_ops():
        if name in target:
            continue
        op = _reg.get_op(name)
        fn = seen.get(id(op))
        if fn is None:
            fn = _make_ndarray_function(op)
            seen[id(op)] = fn
        target[name] = fn


# mx.nd.relu, mx.nd.dot, mx.nd.sgd_mom_update, ...
_init_ndarray_module(globals())
