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
1e-9.

Mixed precision (``policy=``, ``amp.Policy``) and the pure cast
(``dtype=``) follow the JAX package: float32 data inputs and a copy of every
parameter enter the forward in the compute dtype, labels and the moving
statistics uncast; the gradients reach the float32 masters through autograd
of the cast.  Under a policy the loss scale rides the loss heads
(``_Lowered.run(head_grad_scale=...)``), the overflow verdict is computed on
the device, and an overflow step's update is a tensor select that keeps
every weight, optimizer state and moving statistic as it was: no host read
in the step.  ``remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``), replaying the explicit generator the Dropout
and sampling ops draw from.

Observability, as in the JAX package: each step is the profiler range
``train_step[n]`` and, while telemetry records, the span ``train_step``,
the AMP ``loss_scale`` gauge and ``amp_overflow_steps`` counter;
``step_flops`` counts the model FLOPs of a step from the graph
(``cost.graph_flops``); the Monitor bridge (``_mon_force``) samples the
parameters' squared norms on the card before a step.

Checkpoints: ``checkpoint_topology`` (one stage, no data parallelism, ZeRO
level 0), ``place_checkpoint``, ``export_host`` and the loss-scale hooks
serve ``checkpoint.py``'s sharded format, whose optimizer-state tuples are
the JAX ``_FunctionalOptimizer.init_state``'s, in its order.

Not ported here: ``mesh``, ``param_shardings`` and ``zero`` (the mesh and
ZeRO part of the distributed slice); the ``MXNET_MONITOR`` statistics,
their cadence, history ring and provenance replay (the numerics slice);
the sanitizer's hooks; SGLD, DCASGD and Test run through the imperative
``optimizer.Updater``, not here.
"""
from __future__ import annotations

import functools
import math

import numpy as _np
import torch
import torch.utils.checkpoint as _ckpt

from .base import MXNetError, torch_dtype
from .context import Context, cpu, current_context
from . import amp as _amp
from . import engine as _engine
from . import ndarray as nd
from . import profiler as _profiler
from . import random as _random
from . import telemetry as _tel
from .executor import _Lowered, head_grads
from .ops.registry import get_op
from .optimizer import adadelta_rule, adagrad_rule, nag_rule

__all__ = ["TrainStep", "EvalStep"]

# TrainStep/EvalStep arguments not ported yet -> the slice of the port that
# brings them
_NOT_PORTED = (("mesh", "the distributed slice, in its mesh part"),
               ("param_shardings",
                "the distributed slice, in its mesh part"),
               ("zero", "the distributed slice, in its ZeRO part"))

# remat="dots": the matrix products without batch dimensions whose outputs
# the recompute keeps (JAX's dots_with_no_batch_dims_saveable saves neither
# convolutions nor batched products)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _refuse(who, **given):
    for name, item in _NOT_PORTED:
        if given.get(name, None):
            raise MXNetError("%s(%s=...) is not ported yet (it arrives "
                             "with %s): the port trains on one device"
                             % (who, name, item))


def _compute_dtype(who, dtype, policy):
    """(resolved policy or None, compute dtype or None): ``dtype=`` is the
    pure cast, ``policy=`` the cast with loss scaling; a float32 policy
    casts nothing."""
    if policy is None:
        return None, (None if dtype is None else torch_dtype(dtype))
    if dtype is not None:
        raise MXNetError("%s: pass either dtype= (pure cast) or policy= "
                         "(cast + loss scaling), not both" % who)
    policy = _amp.resolve_policy(policy)
    if policy.compute_dtype == "float32":
        return policy, None
    return policy, torch_dtype(policy.compute_dtype)


def _cast_inputs(vals, dtype, keep):
    """Float32 inputs not named in ``keep`` (the labels: bfloat16 rounds
    class ids, 997 becomes 996) cast to ``dtype``."""
    return {k: (v.to(dtype) if k not in keep and v.dtype == torch.float32
                else v) for k, v in vals.items()}


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


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
                             "fused rules arrive with the Module slice)"
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
    """A batch dict (numpy arrays, tensors or NDArrays) as tensors on
    ``dev``, each at its own dtype."""
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
    remat : False; True recomputes the forward in the backward
        (``torch.utils.checkpoint``); "dots" keeps the outputs of the matrix
        products without batch dimensions and recomputes the rest
    dtype : the pure cast: float32 data inputs and a copy of every
        parameter in this dtype (labels and moving statistics uncast), the
        outputs in it too; no loss scaling
    policy : an ``amp.Policy`` (or True, or a dtype string): the cast of
        its compute dtype, float32 master weights, and the loss scale, whose
        state (``scale``, ``good``, ``overflow``) lives on the step's device
        and moves by ``Policy.next_state`` after every step; the outputs
        come back in float32.  Resolve the env levers with
        ``amp.resolve_policy()`` when building the step.
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
                zero=zero)
        if remat not in (False, None, True, "dots"):
            raise MXNetError("TrainStep: remat must be False, True or "
                             "'dots', got %r" % (remat,))
        self.policy, self._dtype = _compute_dtype("TrainStep", dtype, policy)
        self._has_scale = self.policy is not None
        self._scale_state = None
        self._overflow_seen = 0
        self.remat = remat or False
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
        # the AMP loss-scale gauge and overflow counter, emitted by the step
        # while telemetry records (the fit loop turns this off: it emits
        # them itself, with the train_loss_scale curve)
        self._amp_emit = True
        self._flops = {}              # input shapes -> step_flops()
        self._last_shapes = None      # the input shapes of the last step
        self._mon_force = False       # the Monitor bridge's force-sample
        self._last_mon_entry = None   # the last sampled step's norms

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

    # ------------------------------------------------------------ loss scale
    def _scale_state_dev(self):
        """The loss-scale state on the step's device (placed at first
        use)."""
        if self._scale_state is None:
            self._scale_state = self.policy.init_state(
                self.ctx.torch_device())
        return self._scale_state

    def scale_state_host(self):
        """The loss-scale state as host scalars (checkpoint export), or
        None without a policy.  Reads three scalars from the device: call
        it at checkpoint time only."""
        if not self._has_scale:
            return None
        return {k: float(v) if k == "scale" else int(v)
                for k, v in self._scale_state_dev().items()}

    def load_scale_state(self, host):
        """Restore the loss-scale state from checkpointed host scalars,
        merged over ``Policy.init_state`` (a no-op without a policy: a
        float32 restore of an AMP checkpoint drops the scale)."""
        if not self._has_scale or host is None:
            return
        dev = self.ctx.torch_device()
        base = self.policy.init_state(dev)
        self._scale_state = {
            k: torch.tensor(host[k], dtype=v.dtype, device=dev)
            if k in host else v for k, v in base.items()}
        self._overflow_seen = int(host.get("overflow", 0))

    # ----------------------------------------------------------- checkpoint
    def checkpoint_topology(self):
        """The shard ownership of this step for ``checkpoint.snapshot``:
        one stage owns every parameter and aux state, no data parallelism,
        ZeRO level 0 (parity: TrainStep.checkpoint_topology without a
        mesh)."""
        return {"pp": 1, "dp": 1, "zero": 0, "microbatches": None,
                "stage_of": {n: 0 for n in self.param_names
                             + self.aux_names}}

    def place_checkpoint(self, host_params, host_state, host_aux,
                         device=None):
        """Restored host tensors (or numpy arrays) in their logical shapes,
        placed on ``device`` (default: the step's): new (params,
        opt_state, aux) dicts in this step's name order."""
        dev = torch.device(device) if device is not None \
            else self.ctx.torch_device()

        def put(v):
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                _np.asarray(v))
            return t.detach().to(dev, copy=True)
        params = {n: put(host_params[n]) for n in self.param_names}
        state = {n: tuple(put(s) for s in host_state[n])
                 for n in self.param_names}
        aux = {n: put(host_aux[n]) for n in self.aux_names}
        return params, state, aux

    def export_host(self, params, opt_state, aux):
        """The live state as a checkpoint save and load of it would give,
        without the disk: ``(manifest, params, opt_state, aux)`` in logical
        host tensors."""
        from . import checkpoint as _ckpt
        return _ckpt.reassemble(_ckpt.snapshot(self, params, opt_state,
                                               aux))

    def amp_stats(self):
        """``(scale, overflow_delta)``: the current scale and the overflow
        (skipped-update) count since the previous call, or None without a
        policy or before the first step.  Reads two scalars from the
        device: call it from diagnostics, never in the hot loop."""
        if not self._has_scale or self._scale_state is None:
            return None
        total = int(self._scale_state["overflow"])
        delta = total - self._overflow_seen
        self._overflow_seen = total
        return float(self._scale_state["scale"]), delta

    # ------------------------------------------------------------------ step
    def _forward(self, leaves, aux, batch, scale):
        """The walk under autograd: inputs and a copy of every parameter
        cast to the compute dtype (labels and aux uncast), the loss scale
        at the heads; recomputed in the backward under ``remat``."""
        dtype = self._dtype

        def fwd():
            vals = dict(batch)
            params = leaves
            if dtype is not None:
                vals = _cast_inputs(vals, dtype, self.label_names)
                params = {k: v.to(dtype) for k, v in leaves.items()}
            vals.update(params)
            return self._low.run(vals, aux, True,
                                 no_grad_inputs=self._inputs,
                                 device=self.ctx, head_grad_scale=scale)
        if not self.remat:
            return fwd()
        # Dropout and the samplers draw from the step device's explicit
        # generator, which checkpoint's preserve_rng_state does not cover:
        # the recompute replays it from the state the forward started at
        gen = _random.generator(self.ctx.torch_device())
        start = gen.get_state()
        calls = []

        def replayed():
            if not calls:
                calls.append(1)
                return fwd()
            with _random.replaying(gen, start):
                return fwd()
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return _ckpt.checkpoint(replayed, use_reentrant=False, **kw)

    def _step(self, params, opt_state, aux, batch, hyper, t):
        lsc = self._scale_state_dev() if self._has_scale else None
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self.param_names}
        outs, aux_upd = self._forward(leaves, aux, batch,
                                      None if lsc is None else lsc["scale"])
        seeds = [torch.ones((), dtype=o.dtype, device=o.device)
                 .expand(o.shape) for o in outs]
        grads = head_grads(outs, seeds,
                           [leaves[n] for n in self.param_names])
        del leaves
        grads = [torch.zeros_like(params[n]) if g is None
                 else g.to(params[n].dtype)
                 for n, g in zip(self.param_names, grads)]
        # the range names the optimizer rule's kernels in a profile
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.update"):
            if lsc is None:
                self._update(params, opt_state, aux, aux_upd, grads, hyper,
                             t, None)
                return params, opt_state, aux, tuple(o.detach()
                                                     for o in outs)
            # overflow is judged on the scaled float32 gradients, on the
            # device; the update is unscaled by 1/S once and kept only
            # where the verdict is finite (a select, not a host branch)
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads]).all()
            inv = 1.0 / lsc["scale"]
            grads = [g * inv.to(g.dtype) for g in grads]
            self._update(params, opt_state, aux, aux_upd, grads, hyper, t,
                         finite)
            self._scale_state = self.policy.next_state(lsc, finite)
        # the loss surface crosses back in float32
        return params, opt_state, aux, tuple(o.detach().to(torch.float32)
                                             for o in outs)

    def _update(self, params, opt_state, aux, aux_upd, grads, hyper, t,
                finite):
        """The rule's results copied into the caller's tensors; with a
        ``finite`` verdict, each copy keeps the old value where it is
        false."""
        def put(dst, new):
            new = new.to(dst.dtype)
            dst.copy_(new if finite is None
                      else torch.where(finite, new, dst))
        for n, g in zip(self.param_names, grads):
            w = params[n]
            new_w, new_state = self.fopt.update(n, w, g, opt_state[n],
                                                hyper, t)
            put(w, new_w)
            for st, v in zip(opt_state[n], new_state):
                put(st, v)
        for k, v in aux_upd.items():
            if k in aux:
                put(aux[k], v)

    # ------------------------------------------------------- observability
    def step_flops(self):
        """Model FLOPs of one step at the last step's input shapes (the fit
        loop's MFU numerator), counted from the graph by
        ``cost.graph_flops`` once a shape and kept; None before the first
        step."""
        key = self._last_shapes
        if key is None:
            return None
        if key not in self._flops:
            from . import cost as _cost
            self._flops[key] = _cost.graph_flops(self.symbol, dict(key))
        return self._flops[key]

    def _param_sq(self, params):
        """The squared norm of every parameter as one stacked tensor on the
        step's device, reduced there (float32 at least, float64 kept) —
        the Monitor bridge's sample, read after the step."""
        sq = [params[n].detach().to(torch.promote_types(
            params[n].dtype, torch.float32)).square().sum().to(torch.float64)
            for n in self.param_names]
        return torch.stack(sq) if sq else None

    def _publish_monitor(self, sq, upd_idx):
        """Read the sampled step's squared norms to the host (the one
        planned read) and keep them as the last entry: ``{"update":
        index, "param_norms": {name: norm}}``.  The JAX package's
        ``MXNET_MONITOR`` statistics (gradient norms, update ratios, the
        history ring) arrive with the numerics slice."""
        host = sq.cpu().tolist() if sq is not None else []
        norms = {n: math.sqrt(v) if math.isfinite(v) and v >= 0
                 else float("nan") for n, v in zip(self.param_names, host)}
        self._last_mon_entry = {"update": int(upd_idx),
                                "param_norms": norms}

    def __call__(self, params, opt_state, aux, batch, rng=None):
        """One step.  Returns (params, opt_state, aux, outputs); the first
        three are the dicts passed in, updated in place.  ``batch`` may lie
        on the host (``shard_batch`` places it, as the JAX package's jit
        does).  ``rng`` is accepted for the JAX signature: an op that draws
        random numbers (Dropout, the samplers) draws from the generator of
        the step's device (``random.generator``).

        The step is the profiler range ``train_step[n]`` and, while
        telemetry records, the span ``train_step``; either waits for the
        card at the step's end, as NaiveEngine does."""
        batch = self.shard_batch(batch)
        self._last_shapes = tuple(sorted(
            (k, tuple(v.shape)) for k, v in batch.items()))
        upd_idx = self.num_update
        hyper = self.fopt.hyper(self.num_update)
        self.num_update += 1
        sq = None
        if self._mon_force:
            self._mon_force = False
            sq = self._param_sq(params)
        with _profiler.Scope("train_step[%d]" % self.num_update, "symbolic"):
            if _tel._enabled:
                with _tel.span("train_step", cat="executor", mirror=False,
                               num_update=self.num_update):
                    res = self._step(params, opt_state, aux, batch, hyper,
                                     self.num_update)
                    _engine.settle(res[3])
            else:
                res = self._step(params, opt_state, aux, batch, hyper,
                                 self.num_update)
                _engine.settle(res[3])
        if self._has_scale and _tel._enabled and self._amp_emit \
                and _tel.scalar_due(self.num_update):
            # a telemetry read of two scalars: the scale gauge and the
            # overflow counter
            scale, overflow = self.amp_stats()
            _tel.gauge("loss_scale", scale)
            if overflow:
                _tel.counter("amp_overflow_steps", overflow)
        if sq is not None:
            self._publish_monitor(sq, upd_idx)
        return res

    def run_steps(self, params, opt_state, aux, batch, num_steps, rng=None,
                  stacked=False):
        """Run ``num_steps + 1`` steps (parity: TrainStep.run_steps).

        - ``stacked=False``: ``batch`` is one minibatch applied to every
          step (full-batch training or benchmarking).
        - ``stacked=True``: every leaf of ``batch`` has a leading
          ``num_steps + 1`` axis and step i consumes slice i.

        The lr schedule is sampled once per call; the step count (Adam's
        bias correction) advances per step, and the loss-scale state is
        carried from step to step, so the result equals sequential
        stepping.  Returns (params, opt_state, aux, last_outputs)."""
        batch = self.shard_batch(batch)
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
        self._last_shapes = tuple(sorted(
            (k, tuple(v.shape[1:] if stacked else v.shape))
            for k, v in batch.items()))
        res = None
        for i in range(num_steps + 1):
            b = {k: v[i] for k, v in batch.items()} if stacked else batch
            # each step its profiler range, as through __call__
            with _profiler.Scope("train_step[%d]" % (t0 + i + 1),
                                 "symbolic"):
                res = self._step(params, opt_state, aux, b, hyper,
                                 t0 + i + 1)
                _engine.settle(res[3])
        return res


class EvalStep(object):
    """Forward-only step (parity: mxnet_tpu.train.EvalStep with
    ``mesh=None``): ``step(params, aux, batch)`` returns the outputs as a
    tuple, computed without autograd.  ``dtype=`` casts the float32 inputs
    (labels excepted) and the parameters to that dtype; ``policy=``
    contributes only its compute dtype (no backward, so no loss scale).
    The outputs stay in the compute dtype.  A host batch (numpy arrays,
    NDArrays) moves to the parameters' device, as the JAX package's jit
    moves it."""

    def __init__(self, symbol, mesh=None, dtype=None,
                 label_names=("softmax_label",), policy=None):
        _refuse("EvalStep", mesh=mesh)
        _, self._dtype = _compute_dtype("EvalStep", dtype, policy)
        self._low = _Lowered(symbol)
        self.label_names = tuple(label_names)

    def __call__(self, params, aux, batch, rng=None):
        dev = next(iter(params.values())).device if params \
            else current_context().torch_device()
        vals = _to_device(batch, dev)
        if self._dtype is not None:
            vals = _cast_inputs(vals, self._dtype, self.label_names)
            params = {k: v.to(self._dtype) for k, v in params.items()}
        vals.update(params)
        outs, _ = self._low.run(vals, aux, False)
        return tuple(outs)
