"""Shape-manipulation and linear-algebra ops (counterpart:
mxnet_tpu/ops/matrix.py): Reshape, Flatten, transpose, expand_dims,
SwapAxis, slice, slice_axis, dot, batch_dot, repeat, tile, reverse, Concat,
SliceChannel, stack and Pad.

The shape ops return views where torch can (transpose, slice_axis, ...); the
op that needs contiguous memory makes it (the attention wrapper passes
strides), and the ``mx.nd`` frontends copy any output that shares memory
with an input.  dot and batch_dot are matmuls in the inputs' precision.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import promoted
from .registry import register, parse_bool, parse_int, parse_str, parse_tuple


def infer_reshape(shape, target):
    """MXNet reshape semantics incl. special codes 0, -1, -2, -3, -4
    (parity: mxnet_tpu/ops/matrix.py infer_reshape)."""
    src = list(shape)
    out = []
    src_idx = 0
    i = 0
    target = list(target)
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_idx])
            src_idx += 1
        elif t == -1:
            out.append(-1)
            src_idx += 1
        elif t == -2:
            out.extend(src[src_idx:])
            src_idx = len(src)
        elif t == -3:
            out.append(src[src_idx] * src[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src[src_idx]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src_idx += 1
            i += 2
        else:
            out.append(t)
            src_idx += 1
        i += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = int(_np.prod(shape)) if shape else 1
        out[out.index(-1)] = total // known
    return tuple(out)


def _reshape_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None], None
    tgt = parse_tuple(attrs.get("shape", ())) or ()
    if not tgt and attrs.get("target_shape") is not None:
        tgt = parse_tuple(attrs["target_shape"])
    return in_shapes, [infer_reshape(s, tgt)], None


@register("Reshape", aliases=("reshape",),
          attr_types={"shape": parse_tuple, "target_shape": parse_tuple,
                      "keep_highest": parse_bool, "reverse": parse_bool},
          defaults={"shape": (), "reverse": False},
          infer_shape=_reshape_infer)
def _reshape(data, shape=(), target_shape=None, keep_highest=False,
             reverse=False):
    tgt = tuple(shape) if shape else tuple(target_shape or ())
    return data.reshape(infer_reshape(tuple(data.shape), tgt))


@register("Flatten", aliases=("flatten",),
          infer_shape=lambda attrs, ins: (
              ins, [None if ins[0] is None else
                    (ins[0][0], int(_np.prod(ins[0][1:])))], None))
def _flatten(data):
    return data.reshape(data.shape[0], -1)


@register("transpose", attr_types={"axes": parse_tuple}, defaults={"axes": ()})
def _transpose(data, axes=()):
    """Permute the axes; no axes reverses them (numpy's rule)."""
    return data.permute(tuple(axes) if axes
                        else tuple(range(data.dim() - 1, -1, -1)))


@register("slice_axis",
          attr_types={"axis": parse_int, "begin": parse_int, "end": parse_int},
          defaults={"axis": 0, "begin": 0, "end": None})
def _slice_axis(data, axis=0, begin=0, end=None):
    """data[begin:end] along ``axis``; negative bounds count from the end and
    ``end=None`` runs to it."""
    n = data.shape[axis]
    if end is None:
        end = n
    if begin < 0:
        begin += n
    if end < 0:
        end += n
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("expand_dims", attr_types={"axis": parse_int}, defaults={"axis": 0})
def _expand_dims(data, axis=0):
    return data.unsqueeze(axis)


@register("SwapAxis", aliases=("swapaxes",),
          attr_types={"dim1": parse_int, "dim2": parse_int},
          defaults={"dim1": 0, "dim2": 0})
def _swapaxes(data, dim1=0, dim2=0):
    """(parity: src/operator/swapaxis.cc)"""
    return data.transpose(dim1, dim2)


@register("slice", aliases=("crop",),
          attr_types={"begin": parse_tuple, "end": parse_tuple},
          defaults={"begin": (), "end": ()})
def _slice(data, begin=(), end=()):
    """data[begin[i]:end[i]] on the leading axes; None runs to the end."""
    return data[tuple(slice(b, e) for b, e in zip(begin, end))]


def _rev(x):
    """All axes reversed (numpy's ``.T``)."""
    return x.permute(tuple(range(x.dim() - 1, -1, -1)))


def _dot_infer(attrs, in_shapes):
    a, b = in_shapes
    ta = attrs.get("transpose_a", False)
    tb = attrs.get("transpose_b", False)
    if a is None or b is None:
        return in_shapes, [None], None
    ash = tuple(reversed(a)) if ta else a
    bsh = tuple(reversed(b)) if tb else b
    if len(a) == 1 and len(b) == 1:
        return in_shapes, [()], None
    return in_shapes, [(ash[0], bsh[1])], None


@register("dot", arg_names=("lhs", "rhs"),
          attr_types={"transpose_a": parse_bool, "transpose_b": parse_bool},
          defaults={"transpose_a": False, "transpose_b": False},
          infer_shape=_dot_infer)
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """numpy's dot (parity: matrix_op.cc dot): the last axis of lhs against
    the first of a 1-D rhs, else its second-to-last; ``transpose_*``
    reverses every axis first; mixed float dtypes promote."""
    a, b = promoted(_rev(lhs) if transpose_a else lhs,
                    _rev(rhs) if transpose_b else rhs)
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1],
                                       [0 if b.dim() == 1 else b.dim() - 2]))


@register("batch_dot", arg_names=("lhs", "rhs"),
          attr_types={"transpose_a": parse_bool, "transpose_b": parse_bool},
          defaults={"transpose_a": False, "transpose_b": False})
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a, b = promoted(lhs.transpose(-1, -2) if transpose_a else lhs,
                    rhs.transpose(-1, -2) if transpose_b else rhs)
    return torch.matmul(a, b)


@register("repeat", attr_types={"repeats": parse_int, "axis": parse_int},
          defaults={"repeats": 1, "axis": None})
def _repeat(data, repeats=1, axis=None):
    """numpy's repeat: every element ``repeats`` times along ``axis``, the
    flattened array when None."""
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("tile", attr_types={"reps": parse_tuple}, defaults={"reps": ()})
def _tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("reverse", aliases=("flip",), attr_types={"axis": parse_tuple},
          defaults={"axis": ()})
def _reverse(data, axis=()):
    ax = axis if isinstance(axis, (tuple, list)) else (axis,)
    return torch.flip(data, tuple(ax))


def _num_args_names(attrs):
    return ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))]


def _concat_infer(attrs, in_shapes):
    dim = int(attrs.get("dim", 1))
    known = next((s for s in in_shapes if s is not None), None)
    if known is None:
        return in_shapes, [None], None
    ins = [s if s is not None else known for s in in_shapes]
    out = list(known)
    out[dim] = sum(s[dim] for s in ins)
    return ins, [tuple(out)], None


@register("Concat", aliases=("concat",), arg_names=_num_args_names,
          key_var_num_args="num_args",
          attr_types={"num_args": parse_int, "dim": parse_int,
                      "layout": parse_str},
          defaults={"dim": 1}, infer_shape=_concat_infer)
def _concat(*args, num_args=None, dim=1, layout=None):
    """(parity: src/operator/concat.cc); a channel-last ``layout`` joins
    along the last axis."""
    if layout == "NHWC":
        dim = -1
    return torch.cat(args, dim=dim)


@register("SliceChannel", aliases=("split",),
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)),
          attr_types={"num_outputs": parse_int, "axis": parse_int,
                      "squeeze_axis": parse_bool},
          defaults={"num_outputs": 1, "axis": 1, "squeeze_axis": False})
def _slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """Equal parts along ``axis`` (parity: src/operator/slice_channel.cc)."""
    if data.shape[axis] % num_outputs:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts"
                         % (axis, data.shape[axis], num_outputs))
    outs = torch.split(data, data.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs)


@register("stack", arg_names=_num_args_names, key_var_num_args="num_args",
          attr_types={"num_args": parse_int, "axis": parse_int},
          defaults={"axis": 0})
def _stack(*args, num_args=None, axis=0):
    return torch.stack(args, dim=axis)


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@register("Pad", aliases=("pad",),
          attr_types={"pad_width": parse_tuple, "mode": str,
                      "constant_value": float},
          defaults={"mode": "constant", "pad_width": (),
                    "constant_value": 0.0})
def _pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """(parity: src/operator/pad.cc; modes constant/edge/reflect).
    ``pad_width`` holds (before, after) for every axis."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        tail = [v for p in reversed(pw) for v in p]
        return F.pad(data, tail, mode="constant", value=constant_value)
    spatial = data.dim() - 2
    if mode not in _PAD_MODES or not 1 <= spatial <= 3 or \
            any(p != (0, 0) for p in pw[:2]):
        raise MXNetError("Pad: mode %s pads the last one to three axes of a "
                         "3-5-D array, not its first two" % mode)
    tail = [v for p in reversed(pw[2:]) for v in p]
    return F.pad(data, tail, mode=_PAD_MODES[mode])
