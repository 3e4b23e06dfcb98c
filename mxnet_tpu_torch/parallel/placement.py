"""Parameter-placement plans: ZeRO levels 0-3 behind one object
(counterpart: mxnet_tpu/parallel/placement.py).

=====  ======================  =============================  =================
level  parameters              gradients                      optimizer state
=====  ======================  =============================  =================
0      replicated              full tree, all-reduced         replicated
1      replicated              full tree, all-reduced; the    row ``r`` of the
       .                       update reads row ``r`` of its  flat ``(dp,
       .                       flat view                      chunk)`` view
2      replicated              ONE flat ``(dp, chunk)``       row ``r``
       .                       bucket, reduce-scattered: row
       .                       ``r`` is the only residency;
       .                       one all-gather of the updated
       .                       rows
3      row ``r``; gathered     the bucket, as level 2; the    row ``r``
       just in time for the    updated rows stay where they
       step, freed after it    are (no gather)
=====  ======================  =============================  =================

Rank ``r`` of the mesh's ``dp`` axis holds row ``r``.  The flat ``(dp,
chunk)`` layout (zero-padded, row ``i`` owned by dp index ``i``) is the
wire contract with the checkpoint, byte for byte the JAX package's:
``chunk_rows``, ``flat_shards``, ``from_flat`` and ``flat_np`` are its only
implementation.  Every optimizer rule of ``train._FunctionalOptimizer`` is
elementwise in (w, g, state), so it commutes with the view and each level
trains to the replicated step's result.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError

__all__ = ["PlacementPlan", "normalize_zero", "chunk_rows", "flat_shards",
           "from_flat", "flat_np"]


# ------------------------------------------------------- flat (dp, chunk)
def chunk_rows(size, dp):
    """Row width of the flat (dp, chunk) view of ``size`` elements."""
    return -(-int(size) // int(dp))


def flat_shards(x, dp):
    """Logical tensor -> flat (dp, chunk) view, zero-padded; row ``i``
    belongs to dp index ``i``.  An already flat (dp, chunk) tensor comes
    back unchanged."""
    import torch
    size = x.numel()
    chunk = chunk_rows(size, dp)
    flat = x.reshape(-1)
    pad = dp * chunk - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(dp, chunk)


def from_flat(xf, shape):
    """Flat (dp, chunk) view (or its rows concatenated) -> the logical
    tensor of ``shape``."""
    return xf.reshape(-1)[:_size_of(shape)].reshape(tuple(shape))


def flat_np(v, dp):
    """Host flat (dp, chunk) view: the save and restore wire contract of
    ZeRO optimizer state and level-3 parameters (the checkpoint writer cuts
    its rows, ``load_sharded`` unpads by ``flat[:size]``)."""
    v = _np.asarray(v)
    chunk = chunk_rows(v.size, dp)
    out = _np.zeros((dp, chunk), v.dtype)
    out.reshape(-1)[:v.size] = v.reshape(-1)
    return out


def normalize_zero(zero):
    """ZeRO level of the ``zero=`` argument: ``False``/``True`` mean off /
    level 1, integers pass through; a level outside 0..3 raises."""
    if isinstance(zero, bool):
        return 1 if zero else 0
    level = int(zero)
    if not 0 <= level <= 3:
        raise MXNetError(
            "zero=%r: ZeRO level must be 0 (off), 1 (optimizer-state "
            "sharding), 2 (+gradient sharding) or 3 (+parameter sharding)"
            % (zero,))
    return level


def _size_of(shape):
    size = 1
    for d in shape:
        size *= int(d)
    return size


def _itemsize(v):
    import torch
    if isinstance(v.dtype, torch.dtype):
        return v.dtype.itemsize
    return _np.dtype(v.dtype).itemsize


def _nbytes(v):
    """Bytes of a tensor or array from its shape and dtype (no read)."""
    return _size_of(v.shape) * _itemsize(v)


class PlacementPlan(object):
    """One step's placement: the ZeRO level, the dp width and this rank's
    row, the logical shapes (``note_host``), the gradient bucket's layout
    and the byte ledger."""

    def __init__(self, zero=0, dp=1, who="TrainStep", row=0):
        self.zero = normalize_zero(zero)
        self.dp = int(dp) if self.zero else 1
        self.row = int(row) if self.zero else 0
        self._who = who
        self._shapes = {}

    @property
    def shard_state(self):
        """Optimizer state lives as rows of the flat view (level >= 1)."""
        return self.zero >= 1

    @property
    def bucket_grads(self):
        """The reduce-scattered bucket is the gradient residency (level
        >= 2)."""
        return self.zero >= 2

    @property
    def shard_params(self):
        """Parameters live as rows, gathered just in time (level 3)."""
        return self.zero >= 3

    def chunk_rows(self, size):
        return chunk_rows(size, self.dp)

    def flat_shards(self, x):
        return flat_shards(x, self.dp)

    def from_flat(self, xf, shape):
        return from_flat(xf, shape)

    def row_of(self, x):
        """This rank's row of a logical tensor's flat view."""
        return flat_shards(x, self.dp)[self.row]

    # --------------------------------------------------------- shape registry
    def note_host(self, host_arrays):
        """Record the logical shapes at placement (level-3 rows no longer
        carry them)."""
        for n, v in host_arrays.items():
            self._shapes[n] = tuple(int(d) for d in v.shape)

    def shape_of(self, name):
        if name not in self._shapes:
            raise MXNetError(
                "%s: logical shape of %s unknown: call init() or "
                "place_checkpoint() before stepping (ZeRO-3 buffers are "
                "flat rows; the plan records logical shapes at placement)"
                % (self._who, name))
        return self._shapes[name]

    def unflatten_host(self, name, arr):
        """A host flat (dp, chunk) array -> the logical array."""
        shape = self.shape_of(name)
        arr = _np.asarray(arr)
        return arr.reshape(-1)[:_size_of(shape)].reshape(shape)

    # ------------------------------------------------------------ the bucket
    def bucket_layout(self, names):
        """``[(name, chunk)]``: the flat bucket is the per-parameter (dp,
        chunk) views concatenated along the chunk axis, so row ``d`` holds
        dp index ``d``'s shard of every parameter, contiguously."""
        return [(n, self.chunk_rows(_size_of(self.shape_of(n))))
                for n in names]

    def fold_bucket(self, grads, layout):
        """The gradient tree folded into ONE flat (dp, C) bucket (C the
        layout's total chunk), whose reduce-scatter hands row ``r`` to
        rank ``r``."""
        import torch
        return torch.cat([self.flat_shards(grads[n]) for n, _ in layout],
                         dim=1)

    # -------------------------------------------------------- byte accounting
    def per_device_bytes(self, params, opt_state=None):
        """Per-device ``{param, grad, opt}`` bytes from shape metadata only
        (the ``zero_param_bytes`` / ``zero_grad_bytes`` gauges), over the
        JAX package's global shapes: logical parameters, or (dp, chunk)
        flat arrays at level 3 and for the optimizer state at level >= 1.
        Gradients: one bucket row at level >= 2, the full tree below."""
        param = grad = opt = 0
        for n, v in params.items():
            b = _nbytes(v)
            param += b // self.dp if self.shard_params else b
            if self.bucket_grads:
                size = _size_of(self.shape_of(n) if self.shard_params
                                else v.shape)
                grad += self.chunk_rows(size) * _itemsize(v)
            else:
                grad += b
        if opt_state:
            for st in opt_state.values():
                for leaf in st:
                    b = _nbytes(leaf)
                    opt += b // self.dp if self.shard_state else b
        return {"param": int(param), "grad": int(grad), "opt": int(opt)}
