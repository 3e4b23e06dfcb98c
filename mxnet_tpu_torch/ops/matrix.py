"""Shape operators (counterpart: mxnet_tpu/ops/matrix.py): Reshape, Flatten,
transpose and slice_axis.  transpose and slice_axis return views; the op that
needs contiguous memory makes it (the attention wrapper passes strides)."""
from __future__ import annotations

import numpy as _np

from .registry import register, parse_bool, parse_int, parse_tuple


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
