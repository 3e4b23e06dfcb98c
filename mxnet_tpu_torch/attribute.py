"""Attribute scoping (parity: reference python/mxnet/attribute.py AttrScope).

Used for ``ctx_group`` model-parallel placement and lr_mult/wd_mult annotation:
``with mx.AttrScope(ctx_group='dev1'): ...``
"""
from __future__ import annotations

import threading

from .base import MXNetError, string_types

__all__ = ["AttrScope"]


class AttrScope(object):
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, string_types):
                raise MXNetError("Attributes need to be a string")
        self._attr = kwargs

    def get(self, attr):
        """Merge scope attrs into user-provided attrs (user wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = getattr(AttrScope._current, "value", None)
        attr = dict(self._old_scope._attr) if self._old_scope else {}
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        cur = getattr(AttrScope._current, "value", None)
        if cur is None:
            cur = AttrScope()
            AttrScope._current.value = cur
        return cur
