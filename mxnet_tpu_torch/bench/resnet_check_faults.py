#!/usr/bin/env python3
"""How tight chip_smoke.py's ResNet-50 training check is, on one card.

    python3 mxnet_tpu_torch/bench/resnet_check_faults.py

Builds the check of chip_smoke.py's resnet50_train phase (ResNet-50 at
224x224, 1000 classes, batch RESNET_CHECK_BATCH, one SGD-momentum step
from the seed-0 state) and its references on the CPU, for each graph: the
float64 step and the float32 steps that give each leaf its floor.  Then it
runs the float32 step on the card as it is, and once with each planted
float32-only fault.  On the unfused graph (MXNET_NORM_CONV=0):

- ``bn_stats_bf16``: BatchNorm's batch mean and var rounded to bfloat16;
- ``bn_dx_bf16``: BatchNorm's dx rounded to bfloat16;
- ``bn_dgamma_dbeta_bf16``: BatchNorm's dgamma and dbeta rounded to
  bfloat16;
- ``cudnn_tf32``: cuDNN's convolutions in TF32.

On the fused graph (MXNET_NORM_CONV=1), in the ``NormConv`` Function:

- ``nc_fold_no_dsq``: the backward's fold of the statistics' cotangents
  without its 2 y d(sum y^2) term;
- ``nc_stats_bf16_y``: the statistics taken from y rounded to bfloat16;
- ``nc_gate_ge0``: the prologue ReLU's backward gated with ``xh >= 0``.

Each fault acts only on float32 tensors on the card, so the references are
untouched.

Then the check of chip_smoke.py's resnet50_train_amp phases, clean and with
each planted bfloat16 fault, which acts only on tensors on the card: one
step under ``Policy("bfloat16")``, each gradient, moving statistic and
parameter update within RESNET_FLOOR_X times its bfloat16 floor (sampled
by bfloat16-policy steps on the CPU), and the step's Functions in bfloat16
(BatchNorm, BatchNorm+ReLU, NormConv with statistics) within RESNET_FLOOR_X
times their CPU bfloat16 floors (``amp_function_rows``):

- ``bn_stats_in_bf16`` (unfused): BatchNorm's batch mean and var computed
  in bfloat16 arithmetic from the bfloat16 activations, where the port
  accumulates them in float32;
- ``master_update_bf16`` (both graphs): each parameter rounded to bfloat16
  after the rule, as if the master weights were bfloat16;
- ``nc_fold_no_dsq_bf16`` (fused): the NormConv backward's fold without its
  2 y d(sum y^2) term, on bfloat16 y.

For each run it prints the worst leaf as a multiple of its floor (by
largest entry and in norm) and whether the check fails it.  Exits with 1
if a clean step fails its check or a fault passes it.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.ops import nn as pnn  # noqa: E402
from mxnet_tpu_torch.ops import norm_conv as pnc  # noqa: E402


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _on_card_f32(x):
    return x.is_cuda and x.dtype == torch.float32


@contextlib.contextmanager
def _patched(name, fn, module=pnn):
    old = getattr(module, name)
    setattr(module, name, fn(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _stats_bf16(fwd):
    def planted(x, g, b, eps, caxis):
        out, mean, var, inv = fwd(x, g, b, eps, caxis)
        if _on_card_f32(x):
            mean, var = _bf16(mean), _bf16(var)
            inv = torch.rsqrt(var + eps)
            _, cshape = pnn._bn_axes(x.dim(), caxis)
            scale = g * inv
            out = x * scale.reshape(cshape) \
                + (b - mean * scale).reshape(cshape)
        return out, mean, var, inv
    return planted


def _bwd_bf16(which):
    def wrap(bwd):
        def planted(caxis, x, g, mean, inv, dy, dmean, dvar):
            dx, dg, db = bwd(caxis, x, g, mean, inv, dy, dmean, dvar)
            if _on_card_f32(x):
                if which == "dx":
                    dx = _bf16(dx)
                else:
                    dg, db = _bf16(dg), _bf16(db)
            return dx, dg, db
        return planted
    return wrap


def _fold_no_dsq(fold):
    def planted(dy, dsum, dsq, y):
        return fold(dy, dsum, None if _on_card_f32(y) else dsq, y)
    return planted


def _stats_from_bf16_y(norm_conv):
    def planted(x, w, scale, shift, kernel, stride, pad, relu=True,
                prologue=True, stats=False):
        y, ysum, ysq = norm_conv(x, w, scale, shift, kernel, stride, pad,
                                 relu, prologue, stats)
        if stats and _on_card_f32(y):
            y16 = _bf16(y)
            ysum, ysq = y16.sum(dim=(0, 1, 2)), \
                y16.square().sum(dim=(0, 1, 2))
        return y, ysum, ysq
    return planted


def _gate_ge0(gate):
    def planted(xh, dxh):
        if _on_card_f32(xh):
            return torch.where(xh >= 0, dxh, 0.0)
        return gate(xh, dxh)
    return planted


def _bn_stats_in_bf16(fwd):
    def planted(x, g, b, eps, caxis):
        if not (x.is_cuda and x.dtype == torch.bfloat16):
            return fwd(x, g, b, eps, caxis)
        axes, cshape = pnn._bn_axes(x.dim(), caxis)
        mean = x.mean(dim=axes)
        var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        mean, var, inv = mean.float(), var.float(), inv.float()
        scale = g.float() * inv
        out = x * scale.reshape(cshape).to(x.dtype) \
            + (b.float() - mean * scale).reshape(cshape).to(x.dtype)
        return out, mean, var, inv
    return planted


def _master_update_bf16(update):
    def planted(self, name, w, g, state, hyper, t):
        nw, new_state = update(self, name, w, g, state, hyper, t)
        if _on_card_f32(nw):
            nw = _bf16(nw)
        return nw, new_state
    return planted


def _fold_no_dsq_bf16(fold):
    def planted(dy, dsum, dsq, y):
        on = y.is_cuda and y.dtype == torch.bfloat16
        return fold(dy, dsum, None if on else dsq, y)
    return planted


@contextlib.contextmanager
def _tf32():
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


# {MXNET_NORM_CONV: (fault name, context that plants it)}
FAULTS = {
    "0": (("clean", contextlib.nullcontext),
          ("bn_stats_bf16", lambda: _patched("_bn_train_fwd", _stats_bf16)),
          ("bn_dx_bf16",
           lambda: _patched("_bn_bwd_shared", _bwd_bf16("dx"))),
          ("bn_dgamma_dbeta_bf16",
           lambda: _patched("_bn_bwd_shared", _bwd_bf16("dgdb"))),
          ("cudnn_tf32", _tf32)),
    "1": (("clean", contextlib.nullcontext),
          ("nc_fold_no_dsq",
           lambda: _patched("_fold", _fold_no_dsq, pnc)),
          ("nc_stats_bf16_y",
           lambda: _patched("norm_conv", _stats_from_bf16_y, pnc)),
          ("nc_gate_ge0", lambda: _patched("_gate", _gate_ge0, pnc))),
}
# the bfloat16 faults of the AMP check, by MXNET_NORM_CONV
AMP_FAULTS = {
    "0": (("clean", contextlib.nullcontext),
          ("bn_stats_in_bf16",
           lambda: _patched("_bn_train_fwd", _bn_stats_in_bf16)),
          ("master_update_bf16",
           lambda: _patched("update", _master_update_bf16,
                            mt.train._FunctionalOptimizer))),
    "1": (("clean", contextlib.nullcontext),
          ("nc_fold_no_dsq_bf16",
           lambda: _patched("_fold", _fold_no_dsq_bf16, pnc)),
          ("master_update_bf16",
           lambda: _patched("update", _master_update_bf16,
                            mt.train._FunctionalOptimizer))),
}


def _report(tag, name, rows, floor_name):
    """Print the worst leaf of a run as a multiple of its floor and
    whether the check fails; returns True when it fails."""
    over = [r for r in rows if max(r[4], r[5]) > cs.RESNET_FLOOR_X]
    for col, what in ((4, "max"), (5, "norm")):
        r = max(rows, key=lambda r: r[col])
        print("%s fault=%s worst_by=%s %s=%s floor_x max=%r norm=%r "
              "max_rel=%r norm_rel=%r %s max_rel=%r norm_rel=%r"
              % ((tag, name, what, r[6], r[7]) + r[4:6] + r[:2]
                 + (floor_name,) + r[2:4]))
    print("%s fault=%s leaves_over_tol=%d of %d (tol %g x max(floor, %g)) "
          "check=%s" % (tag, name, len(over), len(rows), cs.RESNET_FLOOR_X,
                        cs.RESNET_FLOOR_MIN, "fails" if over else "passes"))
    return bool(over)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = mt.models.resnet.get_symbol(cs.CLASSES, 50,
                                      "3,%d,%d" % (cs.IMAGE, cs.IMAGE))
    b = cs.RESNET_CHECK_BATCH
    state = cs.resnet50_state(mt, net, b)
    bad = []
    for norm_conv in sorted(FAULTS):
        os.environ["MXNET_NORM_CONV"] = norm_conv
        want, floors = cs.resnet50_reference(mt, net, state, b)
        tag = "MXNET_NORM_CONV=%s float32" % norm_conv
        for name, planted in FAULTS[norm_conv]:
            with planted():
                got = cs.resnet50_step(mt, net, state, mt.gpu(0),
                                       np.float32, b)[0]
            rows = cs.resnet50_leaf_rows(torch, got, want, floors)
            if _report(tag, name, rows, "f32_floor") != (name != "clean"):
                bad.append((norm_conv, "float32", name))
        floors = cs.resnet50_amp_reference(mt, net, state, b, tag)
        tag = "MXNET_NORM_CONV=%s bf16_policy" % norm_conv
        for name, planted in AMP_FAULTS[norm_conv]:
            with planted():
                got = cs.resnet50_step(mt, net, state, mt.gpu(0),
                                       np.float32, b, cs.amp_policy(mt))[0]
                fn_rows = cs.amp_function_rows(torch, mt)
            rows = cs.resnet50_leaf_rows(torch, got, want, floors,
                                         cs.AMP_KINDS) + fn_rows
            if _report(tag, name, rows, "bf16_floor") != (name != "clean"):
                bad.append((norm_conv, "bf16_policy", name))
    print(_card())
    if bad:
        print("unexpected: %s" % bad)
    return 1 if bad else 0


def _card():
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip() or "nvidia-smi failed: %s" % smi.stderr


if __name__ == "__main__":
    sys.exit(main())
