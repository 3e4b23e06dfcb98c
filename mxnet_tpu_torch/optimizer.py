"""Optimizers (counterpart: mxnet_tpu/optimizer.py): the Optimizer base with
its per-argument lr/wd multipliers, ``rescale_grad`` and ``clip_gradient``,
``register``/``create``, and SGD, ccSGD, NAG, Adam, RMSProp, AdaGrad and
AdaDelta.

An optimizer here holds its settings; ``TrainStep`` applies its rule
(``train._FunctionalOptimizer``, over ``ops/optimizer_ops.py``).  The
imperative ``create_state``/``update`` on NDArrays, the ``Updater`` closure
that calls them, and SGLD, DCASGD and Test arrive with the Module slice.
"""
from __future__ import annotations

from .base import MXNetError, Registry, string_types

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Adam", "RMSProp", "AdaGrad",
           "AdaDelta", "create", "register"]

_OPTIMIZERS = Registry("optimizer")


def register(klass):
    """Register an optimizer class by lowercase name."""
    _OPTIMIZERS.register(klass.__name__.lower(), klass, override=True)
    return klass


class Optimizer(object):
    """Base optimizer (parity: optimizer.py Optimizer).  ``rescale_grad``
    (conventionally 1/batch_size) is applied inside each rule, once."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param "
                             "indexes to names")
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def _symbol_mult(self, key):
        out = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and key in attr[name]:
                    out[name] = float(attr[name][key])
        return out

    def set_lr_mult(self, args_lr_mult):
        """Per-argument lr multipliers; also reads ``__lr_mult__`` symbol
        attributes."""
        self.lr_mult = self._symbol_mult("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-argument wd multipliers; names other than *_weight and
        *_gamma default to 0, and ``__wd_mult__`` symbol attributes
        apply."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._symbol_mult("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)


@register
class SGD(Optimizer):
    """SGD with optional momentum (parity: SGD)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum


@register
class ccSGD(SGD):
    """Alias of SGD (the reference's C++ SGD; the same rule)."""


@register
class NAG(SGD):
    """Nesterov accelerated SGD (parity: NAG)."""


@register
class Adam(Optimizer):
    """Adam with a bias-corrected lr (parity: Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon


@register
class AdaGrad(Optimizer):
    """AdaGrad (parity: AdaGrad)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps


@register
class RMSProp(Optimizer):
    """RMSProp, Tieleman (centered=False) or Graves (centered=True)
    (parity: RMSProp)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights


@register
class AdaDelta(Optimizer):
    """AdaDelta (parity: AdaDelta)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon


def create(name, rescale_grad=1.0, **kwargs):
    """Create an optimizer by registered name (parity: opt.create)."""
    if isinstance(name, Optimizer):
        return name
    if isinstance(name, string_types):
        try:
            klass = _OPTIMIZERS.get(name.lower())
        except MXNetError:
            raise MXNetError("unknown optimizer %s" % name)
        return klass(rescale_grad=rescale_grad, **kwargs)
    raise MXNetError("invalid optimizer spec %r" % (name,))
