"""Optimizer update rules (counterpart: mxnet_tpu/ops/optimizer_ops.py):
sgd_update, sgd_mom_update, adam_update, rmsprop_update, rmspropalex_update.

Plain elementwise tensor functions that return the new weight and state, as
the JAX package's do (XLA fused them; here PyTorch runs them eagerly).  The
caller writes the results back: ``train.TrainStep`` copies them into its
parameter and state tensors in place.
"""
from __future__ import annotations

import torch

from .registry import register, parse_float

_COMMON_T = {"lr": parse_float, "wd": parse_float, "rescale_grad": parse_float,
             "clip_gradient": parse_float}
_COMMON_D = {"wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0}


def _prep(grad, weight, wd, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight


@register("sgd_update", arg_names=("weight", "grad"),
          attr_types=_COMMON_T, defaults=_COMMON_D)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    g = _prep(grad, weight, wd, rescale_grad, clip_gradient)
    return weight - lr * g


@register("sgd_mom_update", arg_names=("weight", "grad", "mom"), num_outputs=2,
          attr_types=dict(_COMMON_T, momentum=parse_float),
          defaults=dict(_COMMON_D, momentum=0.0))
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new_weight, new_mom)."""
    g = _prep(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("adam_update", arg_names=("weight", "grad", "mean", "var"),
          num_outputs=3,
          attr_types=dict(_COMMON_T, beta1=parse_float, beta2=parse_float,
                          epsilon=parse_float),
          defaults=dict(_COMMON_D, beta1=0.9, beta2=0.999, epsilon=1e-8))
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new_weight, new_mean, new_var); lr arrives bias-corrected
    from the caller (parity: optimizer_op-inl.h AdamUpdate)."""
    g = _prep(grad, weight, wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("rmsprop_update", arg_names=("weight", "grad", "n"), num_outputs=2,
          attr_types=dict(_COMMON_T, gamma1=parse_float, epsilon=parse_float,
                          clip_weights=parse_float),
          defaults=dict(_COMMON_D, gamma1=0.95, epsilon=1e-8, clip_weights=-1.0))
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    g = _prep(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights >= 0:
        new_w = new_w.clamp(-clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", arg_names=("weight", "grad", "n", "g", "delta"),
          num_outputs=4,
          attr_types=dict(_COMMON_T, gamma1=parse_float, gamma2=parse_float,
                          epsilon=parse_float, clip_weights=parse_float),
          defaults=dict(_COMMON_D, gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                        clip_weights=-1.0))
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' RMSProp variant (parity: optimizer_op-inl.h RMSPropAlex)."""
    gr = _prep(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = (1 - gamma1) * torch.square(gr) + gamma1 * n
    new_g = (1 - gamma1) * gr + gamma1 * g
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights >= 0:
        new_w = new_w.clamp(-clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta
