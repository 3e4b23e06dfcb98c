"""Loss heads, forward only (counterpart: mxnet_tpu/ops/loss.py).

At inference SoftmaxOutput is a softmax; its label input is bound (as zeros
by the predictor) and ignored.  Its fixed-gradient backward arrives with the
training slice.
"""
from __future__ import annotations

import torch

from .registry import register, parse_bool, parse_float, parse_str


def _softmax_out_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], None
    if attrs.get("multi_output", False):
        label = (data[0],) + tuple(data[2:])
    elif attrs.get("preserve_shape", False):
        label = tuple(data[:-1])
    else:
        label = (data[0],)
    return [data, label], [data], None


@register("SoftmaxOutput", aliases=("Softmax",), arg_names=("data", "label"),
          attr_types={"grad_scale": parse_float, "ignore_label": parse_float,
                      "multi_output": parse_bool, "use_ignore": parse_bool,
                      "preserve_shape": parse_bool, "normalization": parse_str,
                      "out_grad": parse_bool, "smooth_alpha": parse_float},
          defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                    "multi_output": False, "use_ignore": False,
                    "preserve_shape": False, "normalization": "null"},
          infer_shape=_softmax_out_infer)
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax over the class axis (parity: softmax_output-inl.h forward)."""
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)
