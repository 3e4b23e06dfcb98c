"""Miscellaneous operators (counterpart: mxnet_tpu/ops/misc.py).

Only ``_CrossDeviceCopy`` so far; the rest of the JAX package's module
arrives with the rest of the operator surface.
"""
from __future__ import annotations

from .registry import register


@register("_CrossDeviceCopy", hidden=True)
def _cross_device_copy(data):
    """Placement boundary marker (parity: the JAX package's op of the same
    name): the identity.  The executor's ctx_group walk moves tensors
    between devices (``executor.to_device``), so a graph that names the
    node, a JSON written by the JAX package say, loads and runs."""
    return data
