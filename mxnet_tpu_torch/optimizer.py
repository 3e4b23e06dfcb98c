"""Optimizers (counterpart: mxnet_tpu/optimizer.py): the Optimizer base with
its per-argument lr/wd multipliers, ``rescale_grad`` and ``clip_gradient``;
SGD, ccSGD, NAG, SGLD, DCASGD, Adam, AdaGrad, RMSProp, AdaDelta and Test,
each with the imperative ``create_state`` / ``update`` on NDArrays; the
``Updater`` closure with per-index states; ``register``, ``create`` and
``get_updater``; ``opt_stats_enabled``.

``update`` writes the new weight and states into the NDArrays it was given,
in place, so a view of a weight sees the step.  SGD, Adam and RMSProp run
the registered update ops (``mx.nd.sgd_mom_update``, ...); NAG, AdaGrad and
AdaDelta run the tensor rules below, which ``train._FunctionalOptimizer``
(TrainStep's fused path) shares.  Under ``MXNET_OPT_STATS=1`` while
telemetry records, the ``Updater`` records each parameter's
``grad_norm``, ``weight_norm`` and ``update_ratio`` scalars, as in the JAX
package.
"""
from __future__ import annotations

import math
import pickle

import torch

from .base import MXNetError, Registry, get_env, string_types
from . import ndarray as nd
from . import telemetry as _tel
from .ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "ccSGD", "DCASGD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Test", "Updater", "create",
           "get_updater", "register", "opt_stats_enabled"]


def opt_stats_enabled():
    """True when ``MXNET_OPT_STATS=1`` opts the ``Updater`` into optimizer
    introspection: per-parameter ``grad_norm`` / ``weight_norm`` /
    ``update_ratio`` scalars around each update, while telemetry records,
    sampled by ``MXNET_SCALARS_EVERY``.  Read live, not cached."""
    return get_env("MXNET_OPT_STATS") in ("1", "true", "True")

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
        self._index_update_count = {}
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

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_scale(self, args_lrscale):  # deprecated in the reference too
        raise DeprecationWarning("Use set_lr_mult instead.")

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

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        """The lr of ``index``: the schedule at ``num_update`` (sampled
        before this update counts) times the argument's multiplier."""
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip_kwargs(self):
        return {"rescale_grad": self.rescale_grad,
                "clip_gradient": -1.0 if self.clip_gradient is None
                else self.clip_gradient}

    def _rescaled(self, grad):
        """grad * rescale_grad, clipped to +-clip_gradient (an NDArray)."""
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient,
                           a_max=self.clip_gradient)
        return grad

    # kvstore-server transport (parity: Optimizer.dumps/loads)
    def dumps(self):
        return pickle.dumps(self)

    @staticmethod
    def loads(buf):
        return pickle.loads(buf)


# ----------------------------------------------------- tensor rules, shared
# with train._FunctionalOptimizer; ``grad`` arrives rescaled and clipped
def nag_rule(w, grad, mom, lr, wd, momentum):
    """Nesterov step: (new w, new momentum or None)."""
    if mom is None:
        return w - lr * (grad + wd * w), None
    mom = mom * momentum
    grad = grad + wd * w
    mom = mom + grad
    grad = grad + momentum * mom
    return w - lr * grad, mom


def adagrad_rule(w, grad, history, lr, wd, eps):
    """AdaGrad step: (new w, new history)."""
    history = history + grad * grad
    return w - lr * (grad / torch.sqrt(history + eps) + wd * w), history


def adadelta_rule(w, grad, acc_g, acc_delta, wd, rho, eps):
    """AdaDelta step: (new w, new acc_g, new acc_delta)."""
    acc_g = rho * acc_g + (1.0 - rho) * grad * grad
    delta = torch.sqrt(acc_delta + eps) / torch.sqrt(acc_g + eps) * grad
    acc_delta = rho * acc_delta + (1.0 - rho) * delta * delta
    return w - delta - wd * w, acc_g, acc_delta


def _zeros_like(weight):
    return nd.zeros(weight.shape, weight.context, dtype=weight.dtype)


@register
class SGD(Optimizer):
    """SGD with optional momentum through the sgd(_mom)_update ops (parity:
    SGD)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        if not isinstance(weight, NDArray) or not isinstance(grad, NDArray):
            raise MXNetError("SGD.update takes NDArrays")
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kwargs = dict(lr=lr, wd=wd, **self._clip_kwargs())
        if state is not None:
            new_w, new_m = nd.sgd_mom_update(weight, grad, state,
                                             momentum=self.momentum, **kwargs)
            weight._set_value(new_w.value)
            state._set_value(new_m.value)
        else:
            weight._set_value(nd.sgd_update(weight, grad, **kwargs).value)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (parity: NAG)."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad)
        if state is None and self.momentum != 0.0:
            raise MXNetError("NAG with momentum needs its state")
        new_w, new_m = nag_rule(weight.value, grad.value,
                                None if state is None else state.value,
                                lr, wd, self.momentum)
        if state is not None:
            state._set_value(new_m)
        weight._set_value(new_w)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (parity: SGLD): a half SGD
    step plus N(0, lr) noise, drawn on the weight's device."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad)
        noise = nd.normal(loc=0.0, scale=math.sqrt(lr), shape=weight.shape,
                          ctx=weight.context)
        weight += -lr / 2 * (grad + wd * weight) + noise


@register
class ccSGD(SGD):
    """Alias of SGD (the reference's C++ SGD; the same rule)."""


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (parity: DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._rescaled(grad)
        mon, previous_weight = state
        step = -lr * (grad + wd * weight + self.lamda * grad * grad
                      * (weight - previous_weight))
        if mon is not None:
            mon *= self.momentum
            mon += step
        else:
            mon = step
        previous_weight._set_value(weight.value)
        weight += mon


@register
class Adam(Optimizer):
    """Adam through the adam_update op with a bias-corrected lr (parity:
    Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        new_w, new_mean, new_var = nd.adam_update(
            weight, grad, mean, var, lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            **self._clip_kwargs())
        weight._set_value(new_w.value)
        mean._set_value(new_mean.value)
        var._set_value(new_var.value)


@register
class AdaGrad(Optimizer):
    """AdaGrad (parity: AdaGrad)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        new_w, history = adagrad_rule(weight.value, self._rescaled(grad).value,
                                      state.value, lr, wd,
                                      self.float_stable_eps)
        state._set_value(history)
        weight._set_value(new_w)


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

    def create_state(self, index, weight):
        k = 3 if self.centered else 1
        return tuple(nd.zeros(weight.shape, weight.context)
                     for _ in range(k))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kwargs = dict(lr=lr, wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                      clip_weights=-1.0 if self.clip_weights is None
                      else self.clip_weights, **self._clip_kwargs())
        if self.centered:
            new = nd.rmspropalex_update(weight, grad, *state,
                                        gamma2=self.gamma2, **kwargs)
        else:
            new = nd.rmsprop_update(weight, grad, state[0], **kwargs)
        for arr, v in zip((weight,) + tuple(state), new):
            arr._set_value(v.value)


@register
class AdaDelta(Optimizer):
    """AdaDelta (parity: AdaDelta)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, weight.context),
                nd.zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        acc_g, acc_delta = state
        new_w, new_g, new_d = adadelta_rule(
            weight.value, self._rescaled(grad).value, acc_g.value,
            acc_delta.value, wd, self.rho, self.epsilon)
        acc_g._set_value(new_g)
        acc_delta._set_value(new_d)
        weight._set_value(new_w)


@register
class Test(Optimizer):
    """Trivial optimizer for tests (parity: Test)."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state._set_value(weight.value)


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


class Updater(object):
    """Applies an optimizer with a state per index (parity: Updater):
    ``updater(index, grad, weight)`` updates ``weight`` in place."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        if _tel._enabled and opt_stats_enabled():
            # the update writes in place: keep the weight before it
            w0 = weight.value.detach().clone()
            self.optimizer.update(index, weight, grad, self.states[index])
            self._record_stats(index, w0, weight, grad)
        else:
            self.optimizer.update(index, weight, grad, self.states[index])

    def _record_stats(self, index, w0, weight, grad):
        """``MXNET_OPT_STATS``: the gradient's norm, the weight's norm
        before the update and the update-to-weight ratio ``‖w₁−w₀‖/‖w₀‖``,
        reduced on the weight's device in float32 and read as one stacked
        3-scalar transfer a parameter; ``scalar_due`` gates the whole
        computation.  The gradient is the one handed to the optimizer
        (before rescale_grad and clipping).  Step axis: the 0-based update
        index within this run (``num_update - 1 - begin_num_update``), the
        fit's global batch step (parity: Updater._record_stats)."""
        opt = self.optimizer
        step = opt.num_update - 1 - opt.begin_num_update
        if not _tel.scalar_due(step):
            return
        f32 = torch.float32
        g = grad.value.to(f32)
        w0 = w0.to(f32)
        w1 = weight.value.to(f32)
        norms = torch.sqrt(torch.stack([g.square().sum(), w0.square().sum(),
                                        (w1 - w0).square().sum()]))
        gn, wn, up = norms.cpu().tolist()
        name = opt.idx2name.get(index, str(index))
        _tel.scalar("grad_norm", step, gn, param=name)
        _tel.scalar("weight_norm", step, wn, param=name)
        _tel.scalar("update_ratio", step,
                    up / wn if wn else (0.0 if up == 0 else float("inf")),
                    param=name)

    def set_states(self, states):
        self.states = pickle.loads(states)

    def get_states(self):
        return pickle.dumps(self.states)


def get_updater(optimizer):
    """(parity: get_updater)"""
    return Updater(optimizer)
