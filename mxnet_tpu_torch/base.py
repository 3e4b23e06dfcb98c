"""Base utilities of the PyTorch/CUDA port (counterpart: mxnet_tpu/base.py).

The error type, the env reader, the name registry the op library and the
symbol graph are built on, and the numpy <-> torch dtype tables.  Kept as the
port's own copy: the port never imports the JAX package.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

__all__ = ["MXNetError", "string_types", "get_env", "smart_open",
           "Registry", "atomic_write", "torch_dtype", "numpy_dtype",
           "np_bfloat16"]

string_types = (str,)


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (parity: mxnet_tpu.base.MXNetError)."""


def get_env(name, default=None, typ=None):
    """Read a runtime env var (parity: mxnet_tpu.base.get_env)."""
    val = os.environ.get(name)
    if val is None:
        return default
    if typ is not None:
        return typ(val)
    return val


def smart_open(uri, mode="rb"):
    """Open a local path, or a remote URI through fsspec (parity:
    mxnet_tpu.base.smart_open: RecordIO files may live on s3:// or
    hdfs://)."""
    if "://" in str(uri):
        try:
            import fsspec
        except ImportError:
            raise MXNetError("remote URI %r needs fsspec" % (uri,))
        return fsspec.open(uri, mode).open()
    return open(uri, mode)


class Registry(object):
    """Name -> entry registry (the operator table)."""

    def __init__(self, kind):
        self.kind = kind
        self._entries = {}
        self._lock = threading.Lock()

    def register(self, name, entry, override=False):
        with self._lock:
            if name in self._entries and not override:
                raise MXNetError("%s '%s' already registered" % (self.kind, name))
            self._entries[name] = entry
        return entry

    def get(self, name):
        try:
            return self._entries[name]
        except KeyError:
            raise MXNetError("unknown %s: %s" % (self.kind, name))

    def find(self, name):
        """The entry of ``name``, or None."""
        return self._entries.get(name)

    def list_names(self):
        return sorted(self._entries)


class atomic_write(object):
    """Crash-consistent local file write (parity: mxnet_tpu.base
    .atomic_write): the bytes go to a temporary file in the same directory,
    which is flushed, fsynced and renamed over the target, and the
    directory is fsynced.  A process killed mid-write leaves the previous
    file whole; on error the temporary file is removed and the target left
    as it was.  A context manager yielding the open file."""

    def __init__(self, fname, mode="wb"):
        self.fname = str(fname)
        self.tmp = "%s.tmp-%d" % (self.fname, os.getpid())
        self.mode = mode
        self._f = None

    def __enter__(self):
        self._f = open(self.tmp, self.mode)
        return self._f

    def __exit__(self, exc_type, exc, tb):
        try:
            try:
                if exc_type is None:
                    self._f.flush()
                    os.fsync(self._f.fileno())
            finally:
                # closed whatever happens: a failed fsync must not leak
                # the descriptor
                self._f.close()
            if exc_type is None:
                os.replace(self.tmp, self.fname)
                # the rename lives in the directory: without its fsync a
                # power cut can drop the new entry
                d = os.path.dirname(self.fname) or "."
                try:
                    fd = os.open(d, os.O_RDONLY)
                    try:
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                except OSError:
                    pass   # a platform without directory fsync
        finally:
            if os.path.exists(self.tmp):
                try:
                    os.remove(self.tmp)
                except OSError:
                    pass
        return False


_NP2TORCH = {np.dtype("float32"): torch.float32,
             np.dtype("float64"): torch.float64,
             np.dtype("float16"): torch.float16,
             np.dtype("uint8"): torch.uint8,
             np.dtype("int32"): torch.int32,
             np.dtype("int8"): torch.int8,
             np.dtype("int64"): torch.int64}
_TORCH2NP = {v: k for k, v in _NP2TORCH.items()}


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


def np_bfloat16():
    """ml_dtypes' numpy bfloat16 (the JAX package's bfloat16 type), or
    None when ml_dtypes does not import.  Imported at each call, so that
    an environment without it takes the fallback."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype.  ``torch.bfloat16`` becomes
    ml_dtypes' bfloat16 when ml_dtypes imports, as in the JAX package;
    without it, it stays ``torch.bfloat16`` (numpy has no bfloat16)."""
    if dtype == torch.bfloat16:
        bf16 = np_bfloat16()
        return dtype if bf16 is None else bf16
    return _TORCH2NP.get(dtype, dtype)
