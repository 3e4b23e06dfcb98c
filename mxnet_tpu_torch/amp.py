"""Mixed-precision training policy (counterpart: mxnet_tpu/amp.py).

``TrainStep(policy=...)`` (train.py) trains with:

* **compute dtype**: the graph (activations, convolution and matmul inputs)
  runs in ``bfloat16`` (or ``float16``); labels keep their dtype (class ids
  round in half precision);
* **master weights**: parameters and optimizer state stay ``float32``;
  each step casts a compute-dtype *copy* of the weights into the forward,
  and the update applies float32 gradients to the float32 masters;
* **dynamic loss scaling**: the loss heads' gradients are scaled by ``S``
  (the executor's scale-backward identity; the heads ignore the cotangent
  that reaches them, so the seeds of ``torch.autograd.grad`` cannot carry
  it), and the gradients are unscaled by ``1/S`` before the optimizer (whose
  own ``rescale_grad`` still applies: each factor is applied once).  A
  non-finite scaled gradient is detected on the device and the whole update
  is skipped by a tensor select (weights, optimizer state and the moving
  statistics unchanged) while ``S`` halves; after ``growth_interval``
  consecutive good steps ``S`` doubles.  The scale, good-step and overflow
  counters are tensors on the step's device, so the step never waits on
  the host.

``resolve_policy`` reads ``MXNET_AMP`` / ``MXNET_LOSS_SCALE`` when a
TrainStep is constructed.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError, get_env

__all__ = ["Policy", "resolve_policy"]

# bfloat16 shares float32's exponent range, so scaling exists mainly to
# keep tiny gradients out of the flush-to-zero band; float16's 5-bit
# exponent is why the classic 2**15 default exists at all.
_DEFAULT_SCALE = 2.0 ** 15
_DEFAULT_GROWTH_INTERVAL = 2000
_MAX_SCALE = 2.0 ** 24
_MIN_SCALE = 2.0 ** -14

_COMPUTE_DTYPES = ("bfloat16", "float16", "float32")
_DTYPE_ALIASES = {"bf16": "bfloat16", "fp16": "float16", "half": "float16",
                  "fp32": "float32", "f32": "float32"}


class Policy(object):
    """Precision policy for the train and eval steps.

    Parameters
    ----------
    compute_dtype : 'bfloat16' (default) | 'float16' | 'float32'
        dtype the graph computes in.  'float32' keeps float32 numerics
        while still running the loss-scale machinery.
    loss_scale : float, optional
        initial loss scale ``S`` (default 2**15).  Scaling and unscaling by
        a power of two are exact.
    dynamic : bool
        True (default): halve on overflow, double after ``growth_interval``
        consecutive finite steps.  False: ``S`` is static (overflow steps
        are still skipped and counted).
    """

    def __init__(self, compute_dtype="bfloat16", loss_scale=None,
                 dynamic=True, growth_interval=_DEFAULT_GROWTH_INTERVAL,
                 growth_factor=2.0, backoff_factor=0.5,
                 max_scale=_MAX_SCALE, min_scale=_MIN_SCALE):
        compute_dtype = _DTYPE_ALIASES.get(str(compute_dtype),
                                           str(compute_dtype))
        if compute_dtype not in _COMPUTE_DTYPES:
            raise MXNetError("Policy: compute_dtype must be one of %s, got "
                             "%r" % (_COMPUTE_DTYPES, compute_dtype))
        self.compute_dtype = compute_dtype
        self.loss_scale = float(_DEFAULT_SCALE if loss_scale is None
                                else loss_scale)
        if not (self.loss_scale > 0):
            raise MXNetError("Policy: loss_scale must be > 0, got %r"
                             % loss_scale)
        self.dynamic = bool(dynamic)
        self.growth_interval = int(growth_interval)
        if self.dynamic and self.growth_interval < 1:
            raise MXNetError("Policy: growth_interval must be >= 1")
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.max_scale = float(max_scale)
        self.min_scale = float(min_scale)

    def key(self):
        """Hashable identity of the policy (for caches of built steps)."""
        return (self.compute_dtype, self.loss_scale, self.dynamic,
                self.growth_interval, self.growth_factor,
                self.backoff_factor, self.max_scale, self.min_scale)

    def describe(self):
        """Short form for logs and bench records."""
        return "%s/%s-scale-%g" % (self.compute_dtype,
                                   "dyn" if self.dynamic else "static",
                                   self.loss_scale)

    # ------------------------------------------------------- device state
    def init_state(self, device="cpu"):
        """Initial loss-scale state as tensors on ``device``: the current
        scale (float32), the consecutive-good-step counter and the
        cumulative overflow (skipped-update) count (int32)."""
        return {"scale": torch.tensor(_np.float32(self.loss_scale),
                                      device=device),
                "good": torch.tensor(0, dtype=torch.int32, device=device),
                "overflow": torch.tensor(0, dtype=torch.int32,
                                         device=device)}

    def next_state(self, state, finite):
        """The loss-scale state after a step whose on-device verdict is
        ``finite`` (a bool tensor): tensor math only, never a host read."""
        scale, good = state["scale"], state["good"]
        overflow = state["overflow"] + torch.where(finite, 0, 1).to(
            state["overflow"].dtype)
        if not self.dynamic:
            return {"scale": scale, "good": good, "overflow": overflow}
        good2 = good + 1
        grow = good2 >= self.growth_interval
        grown = torch.clamp(scale * self.growth_factor, max=self.max_scale)
        new_scale = torch.where(
            finite,
            torch.where(grow, grown, scale),
            torch.clamp(scale * self.backoff_factor, min=self.min_scale))
        new_good = torch.where(finite, torch.where(grow, 0, good2), 0)
        return {"scale": new_scale.to(scale.dtype),
                "good": new_good.to(good.dtype),
                "overflow": overflow}


def resolve_policy(policy=None, default=None):
    """The policy of a step, resolved when the step is built.

    An explicit ``policy`` wins (``True`` means the default bf16 policy; a
    dtype string builds one).  Otherwise ``MXNET_AMP`` selects: unset ->
    ``default`` (None for the library; the ResNet bench passes its own bf16
    default), ``0`` -> None, ``1``/``bfloat16`` -> bf16, ``float16`` ->
    fp16.  ``MXNET_LOSS_SCALE`` tunes the scaling: ``dynamic`` (default),
    ``dynamic:<init>``, or a bare float for a static scale."""
    if policy is not None:
        if isinstance(policy, Policy):
            return policy
        if policy is True:
            return Policy()
        if isinstance(policy, str):
            return Policy(compute_dtype=policy)
        raise MXNetError("policy must be a Policy, True, or a dtype "
                         "string; got %r" % (policy,))
    amp = get_env("MXNET_AMP")
    if amp is None:
        return default          # unset: the caller's default stands
    if amp in ("0", "", "false", "False"):
        return None             # explicit off overrides any default
    if amp in ("1", "true", "True", "bfloat16", "bf16"):
        dtype = "bfloat16"
    elif amp in ("float16", "fp16", "half"):
        dtype = "float16"
    else:
        raise MXNetError("MXNET_AMP=%r: expected 0/1/bfloat16/float16"
                         % amp)
    spec = get_env("MXNET_LOSS_SCALE", "dynamic")
    dynamic, scale = True, None
    if spec.startswith("dynamic"):
        _, sep, init = spec.partition(":")
        if sep:
            scale = _parse_scale(init)
    else:
        dynamic, scale = False, _parse_scale(spec)
    return Policy(compute_dtype=dtype, loss_scale=scale, dynamic=dynamic)


def _parse_scale(text):
    try:
        val = float(text)
    except ValueError:
        raise MXNetError("MXNET_LOSS_SCALE=%r: expected dynamic, "
                         "dynamic:<scale>, or a float" % text)
    if not val > 0:
        raise MXNetError("MXNET_LOSS_SCALE must be > 0, got %r" % text)
    return val
