"""The training step on one device (counterpart: mxnet_tpu/train.py:
``_host_init``, ``_FunctionalOptimizer``, ``TrainStep`` with ``mesh=None``,
and ``EvalStep``).

The JAX package compiles forward, ``jax.vjp`` and the optimizer rule into
one donated XLA program.  Here one step is the executor's walk recorded by
autograd (``_Lowered.run`` with ``is_train``), ``torch.autograd.grad`` from
the outputs seeded with ones (the loss heads ignore the seed), and the
optimizer rule of ``_FunctionalOptimizer``.  JAX's donation becomes an
in-place update: the rule's results are copied into the parameter, state
and aux tensors the caller passed, under ``torch.no_grad()``, and the same
dicts come back.  ``run_steps`` is a Python loop over the same step
(capturing it as a CUDA graph is later work).

The step's scalars follow JAX's float32 arithmetic: ``hyper`` rounds the lr
to float32, and Adam's bias correction is computed in float32 from a
float32 step count, so a float64 run still matches the JAX package's to
1e-9.  Not ported here: ``mesh``, ``param_shardings`` and ``zero`` (ROADMAP
A10), ``policy``, ``dtype`` and ``remat`` (A5), and the monitor, telemetry
and sanitize hooks (A11); SGLD, DCASGD and Test run through the imperative
``optimizer.Updater``, not here.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import Context, cpu, current_context
from . import ndarray as nd
from . import random as _random
from .executor import _Lowered
from .ops.registry import get_op
from .optimizer import adadelta_rule, adagrad_rule, nag_rule

__all__ = ["TrainStep", "EvalStep"]

# TrainStep/EvalStep arguments not ported yet -> the ROADMAP item that
# brings them
_NOT_PORTED = (("mesh", "A10"), ("param_shardings", "A10"), ("zero", "A10"),
               ("policy", "A5"), ("dtype", "A5"), ("remat", "A5"))


def _refuse(who, **given):
    for name, item in _NOT_PORTED:
        if given.get(name, None):
            raise MXNetError("%s(%s=...) is not ported yet (ROADMAP %s): "
                             "the port trains on one device in the "
                             "parameters' dtype" % (who, name, item))


def _host_init(symbol, low, param_names, aux_names, data_shapes,
               label_shapes, initializer, seed, who):
    """Initialise parameters and aux states on the host (parity:
    train._host_init): ``initializer`` (default Xavier(magnitude=2)) over
    the parameters after ``random.seed(seed)``; moving variances 1, other
    aux states 0.  Returns ({name: CPU tensor}, {name: CPU tensor})."""
    from . import initializer as init_mod
    if initializer is None:
        initializer = init_mod.Xavier(magnitude=2.0)
    shapes = dict(data_shapes)
    if label_shapes:
        shapes.update(label_shapes)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    if arg_shapes is None:
        raise MXNetError("%s.init: shape inference incomplete" % who)
    name2shape = dict(zip(low.arg_names, arg_shapes))
    _random.seed(seed)
    attrs = symbol.attr_dict()
    host = cpu()
    params = {}
    for n in param_names:
        arr = nd.zeros(name2shape[n], ctx=host)
        initializer(init_mod.InitDesc(n, attrs.get(n)), arr)
        params[n] = arr.value
    aux = {n: (torch.ones if ("moving_var" in n or "_var" in n)
               else torch.zeros)(tuple(shape), dtype=torch.float32)
           for n, shape in zip(aux_names, aux_shapes)}
    return params, aux


class _FunctionalOptimizer(object):
    """An Optimizer's rule as a function: (w, g, state, hyper, t) -> (new
    w, new state tuple).  ``hyper`` holds the scalars sampled on the host
    per call (the lr schedule); ``t`` is the 1-based update count."""

    KINDS = ("sgd", "ccsgd", "nag", "adam", "rmsprop", "adagrad", "adadelta")

    def __init__(self, optimizer, param_names):
        self.opt = optimizer
        self.names = list(param_names)
        # static per-parameter multipliers; the reference decays only
        # *_weight and *_gamma by default
        self.lr_mult = {}
        self.wd_mult = {}
        for n in self.names:
            self.lr_mult[n] = optimizer.lr_mult.get(n, 1.0)
            default_wm = 1.0 if n.endswith(("_weight", "_gamma")) else 0.0
            self.wd_mult[n] = optimizer.wd_mult.get(n, default_wm)
        self.kind = type(optimizer).__name__.lower()
        if self.kind not in self.KINDS:
            raise MXNetError("TrainStep supports %s; got %s (SGLD, DCASGD "
                             "and Test run through optimizer.Updater; their "
                             "fused rules are ROADMAP A5)"
                             % ("/".join(self.KINDS), self.kind))

    def init_state(self, params):
        """Zero state tensors beside each parameter (same dtype and
        device)."""
        n_state = {"adam": 2, "adagrad": 1, "adadelta": 2}
        state = {}
        for n, w in params.items():
            if self.kind in ("sgd", "ccsgd", "nag"):
                k = 1 if self.opt.momentum else 0
            elif self.kind == "rmsprop":
                k = 3 if getattr(self.opt, "centered", False) else 1
            else:
                k = n_state[self.kind]
            state[n] = tuple(torch.zeros_like(w) for _ in range(k))
        return state

    def hyper(self, num_update):
        """The host scalars of one call: the lr (the schedule sampled at
        ``num_update``), rounded to float32 as the JAX package's traced
        scalar is."""
        o = self.opt
        lr = o.lr
        if getattr(o, "lr_scheduler", None) is not None:
            lr = o.lr_scheduler(num_update)
        return {"lr": _np.float32(lr)}

    def _clipped(self, g):
        o = self.opt
        grad = g * o.rescale_grad
        if o.clip_gradient is not None:
            grad = grad.clamp(-o.clip_gradient, o.clip_gradient)
        return grad

    def update(self, name, w, g, state, hyper, t):
        """One step of the rule on tensors; returns (new w, new state)."""
        o = self.opt
        lr = _np.float32(hyper["lr"]) * _np.float32(self.lr_mult[name])
        if self.kind == "adam":
            tf = _np.float32(t)
            coef1 = _np.float32(1.0) - _np.float32(o.beta1) ** tf
            coef2 = _np.float32(1.0) - _np.float32(o.beta2) ** tf
            lr = lr * _np.sqrt(coef2) / coef1
        lr = float(lr)           # the float32 value, exactly
        wd = o.wd * self.wd_mult[name]
        clip = -1.0 if o.clip_gradient is None else o.clip_gradient
        common = dict(lr=lr, wd=wd, rescale_grad=o.rescale_grad,
                      clip_gradient=clip)
        if self.kind in ("sgd", "ccsgd"):
            if state:
                nw, nm = get_op("sgd_mom_update").fn(
                    w, g, state[0], momentum=o.momentum, **common)
                return nw, (nm,)
            return get_op("sgd_update").fn(w, g, **common), ()
        if self.kind == "nag":
            nw, nm = nag_rule(w, self._clipped(g), state[0] if state else None,
                              lr, wd, o.momentum)
            return nw, (() if nm is None else (nm,))
        if self.kind == "adam":
            nw, nm, nv = get_op("adam_update").fn(
                w, g, state[0], state[1], beta1=o.beta1, beta2=o.beta2,
                epsilon=o.epsilon, **common)
            return nw, (nm, nv)
        if self.kind == "rmsprop":
            cw = getattr(o, "clip_weights", None)
            cw = -1.0 if cw is None else cw
            if getattr(o, "centered", False):
                nw, nn, ng, ndl = get_op("rmspropalex_update").fn(
                    w, g, state[0], state[1], state[2], gamma1=o.gamma1,
                    gamma2=o.gamma2, epsilon=o.epsilon, clip_weights=cw,
                    **common)
                return nw, (nn, ng, ndl)
            nw, nn = get_op("rmsprop_update").fn(
                w, g, state[0], gamma1=o.gamma1, epsilon=o.epsilon,
                clip_weights=cw, **common)
            return nw, (nn,)
        if self.kind == "adagrad":
            nw, hist = adagrad_rule(w, self._clipped(g), state[0], lr, wd,
                                    o.float_stable_eps)
            return nw, (hist,)
        nw, acc_g, acc_d = adadelta_rule(w, self._clipped(g), state[0],
                                         state[1], wd, o.rho, o.epsilon)
        return nw, (acc_g, acc_d)


def _to_device(batch, dev):
    out = {}
    for k, v in batch.items():
        if isinstance(v, nd.NDArray):
            v = v.value
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(_np.array(v, copy=True))
        out[k] = v.to(dev)
    return out


class TrainStep(object):
    """Symbol + Optimizer -> one training step on one device (parity:
    mxnet_tpu.train.TrainStep with ``mesh=None``).

    symbol : the loss-topped Symbol (e.g. a SoftmaxOutput head)
    optimizer : an ``optimizer.Optimizer``
    data_names / label_names : the input variables (not trained)
    ctx : the device the step runs on (default: the current context,
        ``gpu(0)`` unless a ``with cpu():`` block says otherwise)

    ``init`` returns (params, opt_state, aux) dicts of tensors on that
    device; ``__call__`` and ``run_steps`` update them in place (JAX's
    donation) and return them with the step's outputs.
    """

    def __init__(self, symbol, optimizer, data_names=("data",),
                 label_names=("softmax_label",), mesh=None,
                 param_shardings=None, remat=False, dtype=None, zero=False,
                 policy=None, ctx=None):
        _refuse("TrainStep", mesh=mesh, param_shardings=param_shardings,
                remat=remat, dtype=dtype, zero=zero, policy=policy)
        self.symbol = symbol
        self.ctx = Context(ctx) if ctx is not None else current_context()
        self._low = _Lowered(symbol)
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        self._inputs = frozenset(self.data_names) | frozenset(
            self.label_names)
        self.param_names = [n for n in self._low.arg_names
                            if n not in self._inputs]
        self.aux_names = list(self._low.aux_names)
        self.fopt = _FunctionalOptimizer(optimizer, self.param_names)
        self.optimizer = optimizer
        self.num_update = 0

    def init(self, data_shapes, label_shapes=None, initializer=None, seed=0):
        """Infer shapes, initialise the parameters and aux states with
        ``initializer`` on the host, build the optimizer state, and move
        everything to the step's device in one hop.  Returns (params,
        opt_state, aux)."""
        params, aux = _host_init(self.symbol, self._low, self.param_names,
                                 self.aux_names, data_shapes, label_shapes,
                                 initializer, seed, "TrainStep")
        dev = self.ctx.torch_device()
        params = {n: v.to(dev) for n, v in params.items()}
        opt_state = self.fopt.init_state(params)
        aux = {n: v.to(dev) for n, v in aux.items()}
        return params, opt_state, aux

    def shard_batch(self, batch):
        """Place a host batch dict (numpy arrays, tensors or NDArrays) on
        the step's device, each at its own dtype (one device: nothing is
        sharded)."""
        return _to_device(batch, self.ctx.torch_device())

    def _step(self, params, opt_state, aux, batch, hyper, t):
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self.param_names}
        vals = dict(batch)
        vals.update(leaves)
        outs, aux_upd = self._low.run(vals, aux, True,
                                      no_grad_inputs=self._inputs,
                                      device=self.ctx)
        seeds = [torch.ones((), dtype=o.dtype, device=o.device)
                 .expand(o.shape) for o in outs]
        grads = torch.autograd.grad(outs, [leaves[n] for n in
                                           self.param_names],
                                    seeds, allow_unused=True)
        del leaves
        with torch.no_grad():
            for n, g in zip(self.param_names, grads):
                w = params[n]
                g = torch.zeros_like(w) if g is None else g.to(w.dtype)
                new_w, new_state = self.fopt.update(n, w, g, opt_state[n],
                                                    hyper, t)
                w.copy_(new_w)
                for s, v in zip(opt_state[n], new_state):
                    s.copy_(v)
            for k, v in aux_upd.items():
                if k in aux:
                    aux[k].copy_(v)
        return params, opt_state, aux, tuple(o.detach() for o in outs)

    def __call__(self, params, opt_state, aux, batch, rng=None):
        """One step.  Returns (params, opt_state, aux, outputs); the first
        three are the dicts passed in, updated in place.  ``rng`` is
        accepted for the JAX signature: no op of the ported paths draws
        random numbers."""
        hyper = self.fopt.hyper(self.num_update)
        self.num_update += 1
        return self._step(params, opt_state, aux, batch, hyper,
                          self.num_update)

    def run_steps(self, params, opt_state, aux, batch, num_steps, rng=None,
                  stacked=False):
        """Run ``num_steps + 1`` steps (parity: TrainStep.run_steps).

        - ``stacked=False``: ``batch`` is one minibatch applied to every
          step (full-batch training or benchmarking).
        - ``stacked=True``: every leaf of ``batch`` has a leading
          ``num_steps + 1`` axis and step i consumes slice i.

        The lr schedule is sampled once per call; the step count (Adam's
        bias correction) advances per step, so the result equals
        sequential stepping.  Returns (params, opt_state, aux,
        last_outputs)."""
        if stacked:
            for k, v in batch.items():
                if v.shape[0] != num_steps + 1:
                    raise MXNetError(
                        "run_steps(stacked=True): %s has leading axis %d, "
                        "need num_steps + 1 = %d (one minibatch per step)"
                        % (k, v.shape[0], num_steps + 1))
        hyper = self.fopt.hyper(self.num_update)
        t0 = self.num_update
        self.num_update += num_steps + 1
        res = None
        for i in range(num_steps + 1):
            b = {k: v[i] for k, v in batch.items()} if stacked else batch
            res = self._step(params, opt_state, aux, b, hyper, t0 + i + 1)
        return res


class EvalStep(object):
    """Forward-only step (parity: mxnet_tpu.train.EvalStep with
    ``mesh=None``): ``step(params, aux, batch)`` returns the outputs as a
    tuple, computed without autograd."""

    def __init__(self, symbol, mesh=None, dtype=None,
                 label_names=("softmax_label",), policy=None):
        _refuse("EvalStep", mesh=mesh, dtype=dtype, policy=policy)
        self._low = _Lowered(symbol)
        self.label_names = tuple(label_names)

    def __call__(self, params, aux, batch, rng=None):
        vals = dict(batch)
        vals.update(params)
        outs, _ = self._low.run(vals, aux, False)
        return tuple(outs)
