"""Miscellaneous operators (counterpart: mxnet_tpu/ops/misc.py): the
reference's NDArray-function registry (choose/fill_element_0index,
``_broadcast``, ``_onehot_encode``), IdentityAttachKLSparseReg, the
functional slice assignments and ``_CrossDeviceCopy``.  The v1 aliases sit
on their ops' registrations (``Convolution_v1``, ``Pooling_v1`` in nn.py).

Out-of-range indices follow the JAX package's rules, not PyTorch's (which
raise): ``choose_element_0index`` reads a fill value (NaN for floats),
``fill_element_0index`` drops the write, ``_onehot_encode`` gives a zero
row; the first two wrap an index in [-n, 0), the third does not.
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import register, parse_float, parse_int, parse_tuple


def _row_indices(rhs, n):
    """One index a row (truncated toward zero, as ``astype(int32)``),
    [-n, 0) wrapped to [0, n)."""
    idx = rhs.to(torch.int64).reshape(-1)
    return torch.where(idx < 0, idx + n, idx)


def _fill_value(dtype):
    """What ``take_along_axis`` reads out of range: NaN, or the least
    integer."""
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).min


@register("choose_element_0index", arg_names=("lhs", "rhs"),
          infer_shape=lambda attrs, ins: (
              list(ins), [None if ins[0] is None else (ins[0][0],)], None))
def _choose_element_0index(lhs, rhs):
    """out[i] = lhs[i, rhs[i]]"""
    n = lhs.shape[1]
    idx = _row_indices(rhs, n)
    valid = (idx >= 0) & (idx < n)
    picked = torch.gather(lhs, 1, idx.clamp(0, n - 1)[:, None])[:, 0]
    return torch.where(valid, picked, torch.full_like(picked,
                                                      _fill_value(lhs.dtype)))


@register("fill_element_0index", arg_names=("lhs", "mhs", "rhs"),
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _fill_element_0index(lhs, mhs, rhs):
    """out = lhs with out[i, rhs[i]] = mhs[i]"""
    n = lhs.shape[1]
    idx = _row_indices(rhs, n)
    hit = torch.arange(n, device=lhs.device)[None, :] == idx[:, None]
    return torch.where(hit, mhs.reshape(-1, 1).to(lhs.dtype), lhs)


@register("_broadcast", attr_types={"axis": parse_int, "size": parse_int},
          defaults={"axis": 0, "size": 1})
def _broadcast_fun(data, axis=0, size=1):
    """A size-1 axis broadcast to ``size``."""
    shape = list(data.shape)
    shape[axis] = int(size)
    return data.expand(tuple(shape))


@register("_onehot_encode", arg_names=("lhs", "rhs"),
          infer_shape=lambda attrs, ins: (list(ins), [ins[1]], None))
def _onehot_encode_op(lhs, rhs):
    """One-hot rows of ``lhs`` into the shape and dtype of ``rhs``."""
    idx = lhs.to(torch.int64)
    return (idx[..., None] == torch.arange(rhs.shape[1], device=lhs.device)
            ).to(rhs.dtype)


# -------------------------------------------------- IdentityAttachKLSparseReg
class KLSparseIdentity(torch.autograd.Function):
    """The identity, whose backward adds the gradient of the KL sparseness
    penalty, penalty * (-target / m + (1 - target) / (1 - m)), to each
    sample's flattened features; m is the updated moving average of the
    mean activations (parity: the JAX package's ``_kl_sparse_fn``)."""

    @staticmethod
    def forward(ctx, data, new_mavg, sparseness_target, penalty):
        ctx.save_for_backward(new_mavg)
        ctx.coef = (sparseness_target, penalty)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        (m,) = ctx.saved_tensors
        target, penalty = ctx.coef
        pen = penalty * (-target / m + (1.0 - target) / (1.0 - m))
        g2 = g.reshape(g.shape[0], -1) + pen[None, :]
        return g2.reshape(g.shape), None, None, None


def _kl_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], [None]
    feat = int(_np.prod(data[1:])) if len(data) > 1 else 1
    return [data, (feat,)], [data], [(feat,)]


@register("IdentityAttachKLSparseReg", arg_names=("data", "moving_avg"),
          aux_names=("moving_avg",),
          attr_types={"sparseness_target": parse_float,
                      "penalty": parse_float, "momentum": parse_float},
          defaults={"sparseness_target": 0.1, "penalty": 0.001,
                    "momentum": 0.9},
          infer_shape=_kl_infer, train_aware=True)
def _identity_attach_kl_sparse_reg(data, moving_avg, is_train=False,
                                   sparseness_target=0.1, penalty=0.001,
                                   momentum=0.9):
    """Identity forward; the sparseness penalty joins the gradient
    (``KLSparseIdentity``).  Returns (out, moving_avg): the moving average
    of the mean activations updated in training, unchanged otherwise;
    the backward reads the updated one in both."""
    flat = data.detach().reshape(data.shape[0], -1)
    new_mavg = momentum * moving_avg + (1 - momentum) * flat.mean(dim=0)
    out = KLSparseIdentity.apply(data, new_mavg, float(sparseness_target),
                                 float(penalty))
    return out, (new_mavg if is_train else moving_avg)


# ------------------------------------------------------- slice assignments
def _slice_ranges(begin, end, shape):
    out = []
    for d in range(len(shape)):
        b = begin[d] if d < len(begin) else 0
        e = end[d] if d < len(end) and end[d] is not None else shape[d]
        out.append(slice(b, e))
    return tuple(out)


@register("_slice_assign", aliases=("_crop_assign",),
          arg_names=("lhs", "rhs"),
          attr_types={"begin": parse_tuple, "end": parse_tuple},
          defaults={"begin": (), "end": ()},
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _slice_assign(lhs, rhs, begin=(), end=()):
    """lhs with the box [begin, end) set to rhs, in a new tensor: lhs is
    not written."""
    out = lhs.clone()
    out[_slice_ranges(begin or (), end or (), lhs.shape)] = rhs.to(lhs.dtype)
    return out


@register("_crop_assign_scalar", arg_names=("data",),
          attr_types={"begin": parse_tuple, "end": parse_tuple,
                      "scalar": parse_float},
          defaults={"begin": (), "end": (), "scalar": 0.0},
          infer_shape=lambda attrs, ins: (list(ins), [ins[0]], None))
def _crop_assign_scalar(data, begin=(), end=(), scalar=0.0):
    """data with the box [begin, end) set to ``scalar``, in a new tensor."""
    out = data.clone()
    out[_slice_ranges(begin or (), end or (), data.shape)] = scalar
    return out


@register("_CrossDeviceCopy", hidden=True)
def _cross_device_copy(data):
    """Placement boundary marker (parity: the JAX package's op of the same
    name): the identity.  The executor's ctx_group walk moves tensors
    between devices (``executor.to_device``), so a graph that names the
    node, a JSON written by the JAX package say, loads and runs."""
    return data
