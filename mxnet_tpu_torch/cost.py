"""Roofline peaks, MFU arithmetic and a graph's model FLOPs (counterpart:
mxnet_tpu/cost.py).

An efficiency claim needs a denominator: the card's peak FLOP rate and
memory bandwidth.  This module resolves that pair, in order of precedence:

1. ``MXNET_PEAK_FLOPS`` / ``MXNET_PEAK_BW`` — explicit peaks (FLOP/s and
   bytes/s; SI suffixes K/M/G/T/P accepted, e.g. ``989T`` and ``3350G``).
   Either alone is honoured; MFU needs only FLOPS.
2. With a card, the device table below, keyed on a lowercase substring of
   ``torch.cuda.get_device_name()``.

With neither, every consumer returns None: no gauges, no verdicts.
Nothing here touches the card at import; the device probe runs when a
caller (the fused fit) asks.

The numerator is the model's FLOPs, counted from the symbol graph and its
inferred shapes (``graph_flops``), where the JAX package reads XLA's cost
analysis of the compiled step.  Counting from the graph gives the same
number whichever route runs an op (a hand-written kernel, its plain
version or a library call): ``MXNET_NORM_CONV`` does not move it.

Definitions (as in the JAX package):

- MFU            = (model FLOPs / step seconds) / peak FLOP/s
- intensity      = program FLOPs / bytes accessed       [FLOP/byte]
- ridge point    = peak FLOP/s / peak bytes/s           [FLOP/byte]
- a program is compute-bound when intensity >= ridge, else memory-bound
"""
from __future__ import annotations

import numpy as _np

from .base import get_env

__all__ = ["resolve_peaks", "enabled", "mfu", "ridge", "verdict",
           "graph_flops", "DEVICE_PEAKS"]

# a card's dense peak FLOP/s and device-memory bandwidth in bytes/s, keyed
# by a lowercase substring of torch.cuda.get_device_name().  H100 SXM:
# 989 TFLOP/s dense bf16 on the tensor cores and 80 GB at 3.35 TB/s
# (NVIDIA's H100 data sheet and Hopper architecture white paper).  The bf16
# peak stays the denominator for a float32 step too, as the JAX package's
# table keeps the MXU's bf16 peak: a float32 step's MFU reads low and
# never above 1.
DEVICE_PEAKS = (
    ("h100", 989e12, 3.35e12),
)

_SUFFIX = {"k": 1e3, "m": 1e6, "g": 1e9, "t": 1e12, "p": 1e15}

_cache = None             # (peak_flops|None, peak_bw|None) once resolved


def _parse_rate(raw):
    """``'989e12'`` / ``'989T'`` / ``'3350G'`` -> float, None on junk."""
    if raw is None:
        return None
    raw = str(raw).strip()
    if not raw:
        return None
    mult = 1.0
    if raw[-1].lower() in _SUFFIX:
        mult = _SUFFIX[raw[-1].lower()]
        raw = raw[:-1]
    try:
        val = float(raw) * mult
    except ValueError:
        return None
    return val if val > 0 else None


def _device_peaks():
    """(peak_flops, peak_bw) of card 0 from the table; (None, None)
    without a card or for a card the table lacks."""
    import torch
    if not torch.cuda.is_available():
        return (None, None)
    kind = torch.cuda.get_device_name(0).lower()
    for key, flops, bw in DEVICE_PEAKS:
        if key in kind:
            return (flops, bw)
    return (None, None)


def resolve_peaks(refresh=False):
    """The active ``(peak_flops, peak_bw)`` pair, each possibly None.
    Env vars win; the device table fills whichever the env left unset.
    Cached after the first call (``refresh=True`` re-reads)."""
    global _cache
    if _cache is not None and not refresh:
        return _cache
    flops = _parse_rate(get_env("MXNET_PEAK_FLOPS"))
    bw = _parse_rate(get_env("MXNET_PEAK_BW"))
    if flops is None or bw is None:
        dflops, dbw = _device_peaks()
        flops = flops if flops is not None else dflops
        bw = bw if bw is not None else dbw
    _cache = (flops, bw)
    return _cache


def enabled():
    """True when a peak FLOP rate is known (MFU is computable)."""
    return resolve_peaks()[0] is not None


def mfu(flops, seconds):
    """Model-FLOP utilization of one step, or None when peaks are unset
    or the inputs don't define a rate."""
    peak = resolve_peaks()[0]
    if peak is None or not flops or not seconds or seconds <= 0:
        return None
    return (float(flops) / float(seconds)) / peak


def ridge():
    """The machine ridge point in FLOP/byte, or None without both
    peaks."""
    flops, bw = resolve_peaks()
    if flops is None or bw is None or bw <= 0:
        return None
    return flops / bw


def verdict(intensity):
    """'compute-bound' | 'memory-bound' for a program's arithmetic
    intensity, or None when the ridge point is unknown."""
    r = ridge()
    if r is None or intensity is None:
        return None
    return "compute-bound" if float(intensity) >= r else "memory-bound"


# ------------------------------------------------------------- model FLOPs
def _tup(v, n, default):
    v = tuple(int(x) for x in v) if v else ()
    return v + (default,) * (n - len(v))


def _conv_taps(size, k, s, p, d):
    """In-bounds taps along one axis: a padded tap multiplies a zero
    (the rule of ``chip_smoke.conv_work``, with dilation)."""
    out = (size + 2 * p - (d * (k - 1) + 1)) // s + 1
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * s - p + t * d < size)


def _conv_macs(attrs, data):
    kernel = tuple(int(x) for x in attrs["kernel"])
    nd = len(kernel)
    stride = _tup(attrs.get("stride"), nd, 1)
    pad = _tup(attrs.get("pad"), nd, 0)
    dilate = _tup(attrs.get("dilate"), nd, 1)
    layout = attrs.get("layout") or "NCHW"
    if layout.endswith("C") and layout != "NC":
        n, spatial, cin = data[0], data[1:-1], data[-1]
    else:
        n, cin, spatial = data[0], data[1], data[2:]
    taps = 1
    for size, k, s, p, d in zip(spatial, kernel, stride, pad, dilate):
        taps *= _conv_taps(size, k, s, p, d)
    groups = int(attrs.get("num_group") or 1)
    return n * taps * (cin // groups) * int(attrs["num_filter"])


_COUNTED = ("Convolution", "FullyConnected", "dot", "batch_dot",
            "dot_product_attention", "RNN")


def _node_macs(op, attrs, ins):
    """Multiply-adds of one node's forward from its input shapes (an op of
    ``_COUNTED``)."""
    if op == "Convolution":
        return _conv_macs(attrs, ins[0])
    if op == "FullyConnected":
        d = ins[0]
        return d[0] * int(_np.prod(d[1:])) * int(attrs["num_hidden"])
    if op in ("dot", "batch_dot"):
        a, b = ins[0], ins[1]
        if op == "dot" and attrs.get("transpose_a"):
            a = tuple(reversed(a))
        if op == "dot" and attrs.get("transpose_b"):
            b = tuple(reversed(b))
        if op == "batch_dot":
            if attrs.get("transpose_a"):
                a = a[:-2] + (a[-1], a[-2])
            if attrs.get("transpose_b"):
                b = b[:-2] + (b[-1], b[-2])
            return int(_np.prod(a)) * b[-1]
        if len(b) == 1:
            return int(_np.prod(a))
        return int(_np.prod(a)) * int(_np.prod(b)) // b[-2]
    if op == "dot_product_attention":
        # q·k and p·v over every unmasked (q, k) pair (the rule of
        # chip_smoke.flash_work, which counts their 4·D operations)
        b, h, t, d = ins[0]
        tk = ins[1][2]
        pairs = t * (t + 1) // 2 if attrs.get("causal") and t == tk \
            else t * tk
        return 2 * b * h * d * pairs
    # RNN: every layer and direction, T steps of the gates' products
    t, n, i = ins[0]
    hid = int(attrs["state_size"])
    gates = {"lstm": 4, "gru": 3}.get(attrs.get("mode", "lstm"), 1)
    ndir = 2 if attrs.get("bidirectional") else 1
    macs = 0
    for layer in range(int(attrs.get("num_layers", 1))):
        width = i if layer == 0 else hid * ndir
        macs += ndir * t * n * gates * hid * (width + hid)
    return macs


def graph_flops(symbol, input_shapes, training=True):
    """Model FLOPs of one forward (``training=False``) or one training step
    of ``symbol`` at ``input_shapes`` ({input name: shape}): 2 FLOPs a
    multiply-add of every Convolution, FullyConnected, dot, batch_dot,
    dot_product_attention (q·kᵀ and p·v, the causal half when causal) and
    RNN forward; a training step counts each three times (the forward, the
    data gradient and the weight gradient).  None when the shapes do not
    infer."""
    from .symbol import _run_shape_inference
    known = {k: tuple(int(x) for x in v) for k, v in input_shapes.items()}
    _, shapes = _run_shape_inference(symbol, known)
    macs = 0
    for node in symbol._nodes():
        if node.is_var or node.op.name not in _COUNTED:
            continue
        ins = [shapes.get((id(c), i)) for c, i in node.inputs]
        if any(s is None for s in ins[:2]):
            return None
        macs += _node_macs(node.op.name,
                           node.op.normalize_attrs(node.params), ins)
    return 2 * macs * (3 if training else 1)
