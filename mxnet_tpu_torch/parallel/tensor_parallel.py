"""Tensor parallelism over a mesh's ``tp`` axis.

No module of the JAX package does this: a ``TrainStep(mesh=,
param_shardings=)`` there hands XLA a ``PartitionSpec`` a parameter and
GSPMD inserts the collectives.  Here the step keeps this rank's slice of
each parameter whose spec names ``tp`` (``param_shardings`` after
``train._check_shardings``: ``{name: sharded dimension}``), and a
``TensorParallel`` plan, built once with the step, sends each consumer of
such a parameter through one of three routes (the collectives are
``parallel.dist``'s, over this rank's ``tp`` group, counted as
``tp_all_gather`` / ``tp_all_reduce``):

- **column** (a ``FullyConnected`` whose weight is split on dimension 0,
  its bias on dimension 0 or replicated; the weight read by that op
  alone): the local ``x W_r^T + b_r`` is all-gathered along the output
  features.  In the backward the cotangent is cut to this rank's columns,
  dW_r and db_r are local, and dx is all-reduced over ``tp``
  (``copy_to_group``): one all-gather forward, one all-reduce backward;
- **row** (a ``FullyConnected`` whose weight is split on dimension 1): x
  (flattened as the op flattens it) is cut to this rank's input features,
  the partial products are all-reduced over ``tp`` and the bias is added
  once; in the backward dx is all-gathered over ``tp``;
- **gather** (every other consumer: a convolution's weight, an embedding,
  a spec on another dimension, a weight read twice): the parameter is
  all-gathered over ``tp`` where the walk reads its variable, and its
  gradient is cut back to the shard.

Each route computes the function the one-device step computes; every rank
of a ``tp`` slice runs the same rows (``shard_batch`` takes them by the
``dp`` coordinate) and gets the same loss, so a gathered value's gradient
is the slice of the replicated gradient.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["TensorParallel", "shard_dims", "check_divisible"]


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_dims(who, specs, axis="tp"):
    """``{name: dimension}`` of the specs that split a dimension over
    ``axis`` (a spec naming it twice raises)."""
    out = {}
    for name, spec in specs.items():
        dims = [d for d, entry in enumerate(spec or ())
                if axis in _axes(entry)]
        if len(dims) > 1:
            raise MXNetError("%s: param_shardings[%r] = %r names %r on more "
                             "than one dimension" % (who, name, spec, axis))
        if dims:
            out[name] = dims[0]
    return out


def check_divisible(who, name, spec, shape, dim, size):
    """The JAX package's refusal of a shape that does not split evenly."""
    if dim >= len(shape):
        raise MXNetError("%s: param_shardings[%r] = %r has more dimensions "
                         "than the parameter's shape %r"
                         % (who, name, spec, tuple(shape)))
    if shape[dim] % size:
        raise MXNetError(
            "%s: param_shardings[%r]: One of device_put args was given the "
            "sharding of %r, which implies that the global size of its "
            "dimension %d should be divisible by %d, but it is equal to %d "
            "(full shape: %r)" % (who, name, spec, dim, size, shape[dim],
                                  tuple(shape)))


class TensorParallel(object):
    """The routes of one graph's consumers of ``tp``-split parameters
    (see the module's docstring).  ``dims`` is ``{name: dimension}``;
    ``size``, ``index`` and ``group`` are this rank's ``tp`` slice."""

    def __init__(self, low, dims, size, index, group):
        self.dims = dict(dims)
        self.size, self.index, self.group = int(size), int(index), group
        readers = {}
        for node in low.order:
            if node.is_var:
                continue
            for c, _ in node.inputs:
                if c.is_var:
                    readers.setdefault(c.name, []).append(node)
        # {id(FullyConnected node): (route, bias split with the weight)}
        self.routes = {}
        kept = set()
        for node in low.order:
            if node.is_var or node.op.name != "FullyConnected":
                continue
            names = [c.name if c.is_var else None for c, _ in node.inputs]
            w = names[1] if len(names) > 1 else None
            b = names[2] if len(names) > 2 else None
            if w not in self.dims or len(readers[w]) != 1:
                continue
            split_bias = (b in self.dims and self.dims[b] == 0
                          and len(readers[b]) == 1)
            if self.dims[w] == 0:
                self.routes[id(node)] = ("column", split_bias)
                kept.add(w)
                if split_bias:
                    kept.add(b)
            elif self.dims[w] == 1:
                self.routes[id(node)] = ("row", False)
                kept.add(w)
        # the variables whose readers take the whole value
        self.gathered = frozenset(n for n in self.dims if n not in kept)

    def route_names(self, low):
        """``{FullyConnected name: route}`` and the gathered variables, for
        reports."""
        by_id = {id(n): n.name for n in low.order}
        return ({by_id[k]: v[0] for k, v in self.routes.items()},
                sorted(self.gathered))

    def gather(self, name, v):
        """A split variable read whole: gathered over ``tp``."""
        from . import dist as _dist
        return _dist.gather_along(v, self.dims[name], self.group, self.size,
                                  self.index)

    def whole(self, name, v):
        """A split tensor (a parameter or an optimizer state) gathered
        outside autograd."""
        from . import dist as _dist
        return _dist.gather_cat(v.detach().contiguous(), self.dims[name],
                                self.group, self.size, "tp_all_gather")

    def fc(self, node_id, data, weight, bias=None):
        """The routed ``FullyConnected``: x·Wᵀ + b over the split weight,
        at the promoted dtype of the three, as the op."""
        from ..ops.elemwise import promoted
        from . import dist as _dist
        route, split_bias = self.routes[node_id]
        x = data.reshape(data.shape[0], -1)
        g, n, r = self.group, self.size, self.index
        if route == "column":
            x = _dist.copy_to_group(x, g)
            y = F.linear(*promoted(x, weight, bias if split_bias else None))
            y = _dist.gather_along(y, 1, g, n, r)
            if bias is not None and not split_bias:
                y, bias = promoted(y, bias)
                y = y + bias
            return y
        x = _dist.scatter_along(x, 1, g, n, r)
        y = _dist.reduce_from_group(F.linear(*promoted(x, weight)), g)
        if bias is not None:
            y, bias = promoted(y, bias)
            y = y + bias
        return y
