"""Base utilities of the PyTorch/CUDA port (counterpart: mxnet_tpu/base.py).

The error type, the env reader and the name registry the op library and the
symbol graph are built on.  Kept as the port's own copy: the port never
imports the JAX package.
"""
from __future__ import annotations

import os
import threading

__all__ = ["MXNetError", "string_types", "get_env", "Registry"]

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

    def list_names(self):
        return sorted(self._entries)
