"""Device context (counterpart: mxnet_tpu/context.py).

A Context names a ``torch.device``: ``gpu(i)`` is ``cuda:i``, ``cpu()`` is
the host, and ``cpu_pinned()`` is the host with page-locked memory (an
NDArray there holds a pinned tensor, which the card copies to and from
without a staging buffer).  The default context is ``gpu(0)``: the port runs
on the card unless the caller asks for the CPU.  Resolving a gpu or
cpu_pinned context on a machine without a CUDA device raises
:class:`MXNetError` (pinning needs the CUDA driver); nothing ever falls back
to the CPU or to pageable memory.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context"]

# the device type ids of the JAX package (``tpu`` 4 has no context here)
_DEVTYPE2ID = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
_ID2DEVTYPE = {v: k for k, v in _DEVTYPE2ID.items()}
_DEVICE_TYPES = tuple(_DEVTYPE2ID)


class Context(object):
    """A device context: ``Context('gpu', 0)`` or ``gpu(0)``."""

    _default_ctx = threading.local()
    devtype2str = _ID2DEVTYPE
    devstr2type = _DEVTYPE2ID

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in _DEVICE_TYPES:
            raise MXNetError("unknown device type %s (the port has cpu, "
                             "gpu and cpu_pinned)" % device_type)
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_typeid(self):
        """The device type's id (cpu 1, gpu 2, cpu_pinned 3)."""
        return _DEVTYPE2ID[self.device_type]

    @property
    def default_ctx(self):
        """The active default context (parity: Context.default_ctx)."""
        return current_context()

    def torch_device(self):
        """The ``torch.device`` of this context (the host for cpu_pinned);
        raises for a gpu context when no such CUDA device exists, and for
        cpu_pinned when there is no CUDA device at all."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError("%r needs a CUDA device and this machine has "
                             "none; pass cpu() to run on the host" % self)
        if self.device_type == "cpu_pinned":
            return torch.device("cpu")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%r: only %d CUDA device(s)"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def place(self, t, copy=False):
        """``t`` on this context: moved to its device (a copy of its own
        with ``copy``), and page-locked for cpu_pinned."""
        dev = self.torch_device()
        if self.device_type != "cpu_pinned":
            return t.to(dev, copy=copy)
        if t.device.type == "cpu" and t.is_pinned() and not copy:
            return t
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    """The host context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def cpu_pinned(device_id=0):
    """Page-locked host memory (needs a CUDA device)."""
    return Context("cpu_pinned", device_id)


def current_context():
    """The active default context: ``gpu(0)`` unless a ``with ctx:`` block
    says otherwise."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)
