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

Data parallelism (``mesh=``, a ``parallel.mesh.make_mesh`` DeviceMesh with
a ``dp`` axis, and ``zero=0..3``): the JAX step is one GSPMD program over
the global batch; here every rank of the mesh's ``dp`` axis runs the step
on its rows of the same global batch (``shard_batch``: rank ``r`` takes
rows ``[r B/dp, (r+1) B/dp)``) and the ranks meet in collectives, counted
by kind in ``parallel.dist.collective_calls`` / ``collective_bytes``:

- BatchNorm statistics and the "batch"/"valid" loss normalizations are
  taken over the global batch (``ops.nn.global_batch_stats``), so every
  level matches the JAX package's one program;
- levels 0-1: the gradients are all-reduced, one bucket a dtype;
- levels 2-3: the gradient tree is folded into one flat ``(dp, chunk)``
  bucket (``parallel.placement``) and reduce-scattered: row ``r`` is the
  only gradient residency;
- levels 1-3: the optimizer state is row ``r`` of each leaf's flat view;
  levels 1-2 all-gather the updated rows once (one collective a step);
- level 3: the parameters are row ``r``; ``gather_params`` all-gathers
  them just in time for the forward (the ``zero.gather`` span), and the
  gathered tensors are freed after the backward;
- AMP: the loss-scale state is replicated (each rank moves its copy by
  the same verdict); at levels 2-3 the overflow verdict on the bucket row
  is agreed by one sum across the ranks, so every rank skips together.

The outputs a step returns are this rank's rows.  ``param_shardings``
naming only ``dp`` (or no axis) is accepted and leaves the parameter
replicated; a ``tp`` axis of size > 1 is the tensor-parallel part of the
distributed slice and raises, as do ``pp`` and ``sp`` axes.

Checkpoints: ``checkpoint_topology`` (one stage, the ZeRO level and dp
width, the logical shapes at level 3), ``place_checkpoint`` (re-chunked to
this mesh's dp, whatever topology saved them), ``export_host`` and the
loss-scale hooks serve ``checkpoint.py``'s sharded format, whose
optimizer-state tuples are the JAX ``_FunctionalOptimizer.init_state``'s,
in its order.

Not ported here: the ``MXNET_MONITOR`` statistics, their cadence, history
ring and provenance replay (the numerics slice); the sanitizer's hooks;
SGLD, DCASGD and Test run through the imperative ``optimizer.Updater``, not
here.
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
from .ops.nn import global_batch_stats
from .ops.registry import get_op
from .optimizer import adadelta_rule, adagrad_rule, nag_rule
from .parallel import dist as _dist
from .parallel import mesh as _mesh
from .parallel.placement import PlacementPlan, normalize_zero

__all__ = ["TrainStep", "EvalStep"]

# mesh axes the port does not run yet, of size > 1 -> the part of the
# distributed slice that brings them
_AXIS_PARTS = {"tp": "tensor-parallel", "pp": "pipeline",
               "sp": "ring-attention"}

# remat="dots": the matrix products without batch dimensions whose outputs
# the recompute keeps (JAX's dots_with_no_batch_dims_saveable saves neither
# convolutions nor batched products)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _refuse_axis(who, axis, size=None):
    sized = "" if size is None else " of size %d" % size
    part = _AXIS_PARTS.get(axis)
    if part is None:
        raise MXNetError("%s: mesh axis %r%s: the port shards over 'dp' "
                         "only" % (who, axis, sized))
    raise MXNetError("%s: a %r axis%s is not ported yet: it arrives with "
                     "the %s part of the distributed slice"
                     % (who, axis, sized, part))


def _check_mesh(who, mesh):
    """The mesh is a DeviceMesh whose axes other than ``dp`` have size 1."""
    if mesh is None:
        return
    if not _mesh._is_mesh(mesh):
        raise MXNetError("%s(mesh=...) takes a parallel.mesh.make_mesh "
                         "mesh (a torch DeviceMesh), got %r"
                         % (who, type(mesh).__name__))
    for axis in _mesh.axis_names(mesh):
        size = _mesh.axis_size(mesh, axis)
        if axis != "dp" and size > 1:
            _refuse_axis(who, axis, size)


def _check_shardings(who, mesh, shardings):
    """Each spec names only ``dp`` or no axis (the parameter stays
    replicated); another axis of size > 1, or one the mesh lacks,
    raises."""
    for name, spec in shardings.items():
        axes = []
        for entry in (spec or ()):
            axes.extend(entry if isinstance(entry, (tuple, list))
                        else [entry])
        for axis in axes:
            if axis is None or axis == "dp":
                continue
            if mesh is None or axis not in _mesh.axis_names(mesh):
                if axis in _AXIS_PARTS:
                    _refuse_axis(who, axis)
                raise MXNetError("%s: param_shardings[%r] names axis %r, "
                                 "which the mesh has not" % (who, name,
                                                             axis))
            size = _mesh.axis_size(mesh, axis)
            if size > 1:
                _refuse_axis(who, axis, size)


class _RankBatch(dict):
    """A batch already cut to this rank's rows by ``shard_batch``."""


def _batch_rows(who, batch, axis, dp, row):
    """Rank ``row``'s rows of every input of a global batch, along
    ``axis`` (the batch must divide by ``dp``)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, nd.NDArray):
            v = v.value
        if not isinstance(v, torch.Tensor):
            v = _np.asarray(v)
        b = v.shape[axis]
        if b % dp:
            raise MXNetError("%s: the batch of %d rows of %r is not "
                             "divisible by the mesh's dp width %d"
                             % (who, b, k, dp))
        per = b // dp
        idx = [slice(None)] * len(v.shape)
        idx[axis] = slice(row * per, (row + 1) * per)
        out[k] = v[tuple(idx)]
    return out


class _Meta(object):
    """Shape and dtype of an array of the JAX package's global layout (a
    flat (dp, chunk) array of which this rank holds one row)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


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
    """Symbol + Optimizer -> one training step on one device, or on each
    rank of a data-parallel mesh (parity: mxnet_tpu.train.TrainStep).

    symbol : the loss-topped Symbol (e.g. a SoftmaxOutput head)
    optimizer : an ``optimizer.Optimizer``
    data_names / label_names : the input variables (not trained)
    mesh : None, or a ``parallel.mesh.make_mesh`` mesh with a ``dp`` axis:
        each rank steps on its rows of the global batch (see the module's
        docstring)
    param_shardings : {param name: spec}; a spec names only ``dp`` or no
        axis (the parameter stays replicated)
    zero : the ZeRO level 0-3 (True is 1), which needs a ``dp`` mesh
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
    device (rows of the flat view where the ZeRO level shards them);
    ``__call__`` and ``run_steps`` update them in place (JAX's donation)
    and return them with the step's outputs.
    """

    def __init__(self, symbol, optimizer, data_names=("data",),
                 label_names=("softmax_label",), mesh=None,
                 param_shardings=None, remat=False, dtype=None, zero=False,
                 policy=None, ctx=None):
        if remat not in (False, None, True, "dots"):
            raise MXNetError("TrainStep: remat must be False, True or "
                             "'dots', got %r" % (remat,))
        _check_mesh("TrainStep", mesh)
        self.param_shardings = dict(param_shardings or {})
        _check_shardings("TrainStep", mesh, self.param_shardings)
        self.zero = normalize_zero(zero)
        self.policy, self._dtype = _compute_dtype("TrainStep", dtype, policy)
        self._has_scale = self.policy is not None
        self._scale_state = None
        self._overflow_seen = 0
        self.remat = remat or False
        self.symbol = symbol
        self.mesh = mesh
        self.ctx = Context(ctx) if ctx is not None else current_context()
        self._low = _Lowered(symbol)
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        self._inputs = frozenset(self.data_names) | frozenset(
            self.label_names)
        self.param_names = [n for n in self._low.arg_names
                            if n not in self._inputs]
        self.aux_names = list(self._low.aux_names)
        if self.zero:
            if mesh is None or "dp" not in _mesh.axis_names(mesh):
                raise MXNetError("TrainStep(zero=%d) needs a mesh with a "
                                 "'dp' axis" % self.zero)
            if any(n in self.param_shardings for n in self.param_names):
                raise MXNetError(
                    "TrainStep(zero=%d) shards the optimizer over dp; "
                    "combining it with param_shardings is not supported"
                    % self.zero)
        # the data-parallel width, this rank's row and the group of the
        # mesh's dp axis (a mesh without one replicates the step)
        if mesh is not None and "dp" in _mesh.axis_names(mesh):
            self._dp = _mesh.axis_size(mesh, "dp")
            self._row = _mesh.axis_rank(mesh, "dp")
            self._group = _mesh.axis_group(mesh, "dp")
        else:
            self._dp, self._row, self._group = 1, 0, None
        # BatchNorm's statistics over the global batch
        self._sync = (self._group, self._dp) if self._dp > 1 else None
        self.plan = PlacementPlan(zero=self.zero, dp=self._dp,
                                  who="TrainStep", row=self._row)
        self._zb_cache = None         # zero_bytes of the gauges, per step
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

    def _placed(self, params, state, aux, dev):
        """Logical host (params, state, aux) placed on ``dev`` by the plan:
        level-3 parameters and level >= 1 optimizer state as this rank's
        rows of their flat views; ``state=None`` builds fresh state."""
        plan = self.plan

        def host(v):
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                _np.asarray(v))
            return t.detach()

        def put(v):
            return host(v).to(dev, copy=True)

        def row(v):
            return plan.row_of(host(v)).to(dev, copy=True)
        placed = {n: (row if plan.shard_params else put)(params[n])
                  for n in self.param_names}
        if state is None:
            state = self.fopt.init_state(
                {n: row(params[n]) if plan.shard_state else placed[n]
                 for n in self.param_names})
        else:
            state = {n: tuple((row if plan.shard_state else put)(s)
                              for s in state[n])
                     for n in self.param_names}
        return placed, state, {n: put(aux[n]) for n in self.aux_names}

    def init(self, data_shapes, label_shapes=None, initializer=None, seed=0):
        """Infer shapes, initialise the parameters and aux states with
        ``initializer`` on the host, build the optimizer state, and move
        everything to the step's device in one hop (each rank of a mesh
        draws the same values from ``seed`` and keeps what the plan gives
        it).  Returns (params, opt_state, aux)."""
        params, aux = _host_init(self.symbol, self._low, self.param_names,
                                 self.aux_names, data_shapes, label_shapes,
                                 initializer, seed, "TrainStep")
        self.plan.note_host(params)
        return self._placed(params, None, aux, self.ctx.torch_device())

    def shard_batch(self, batch):
        """Place a host batch dict (numpy arrays, tensors or NDArrays) on
        the step's device, each at its own dtype.  On a ``dp`` mesh of
        width dp, rank r keeps rows ``[r B/dp, (r+1) B/dp)`` of every input
        (the global batch B must divide by dp)."""
        if isinstance(batch, _RankBatch):
            return batch
        if self._dp == 1:
            return _to_device(batch, self.ctx.torch_device())
        return _RankBatch(_to_device(
            _batch_rows("TrainStep", batch, 0, self._dp, self._row),
            self.ctx.torch_device()))

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
        """The shard ownership of this step for ``checkpoint.snapshot``: one
        stage owns every parameter and aux state; the ZeRO level, its dp
        width and, at level 3, the logical shapes (parity:
        TrainStep.checkpoint_topology)."""
        topo = {"pp": 1, "dp": self.plan.dp, "zero": self.zero,
                "row": self.plan.row, "microbatches": None,
                "stage_of": {n: 0 for n in self.param_names
                             + self.aux_names}}
        if self.plan.shard_params:
            topo["param_shapes"] = {n: list(self.plan.shape_of(n))
                                    for n in self.param_names}
        return topo

    def place_checkpoint(self, host_params, host_state, host_aux,
                         device=None):
        """Restored host tensors (or numpy arrays) in their logical shapes,
        placed on ``device`` (default: the step's) by this step's plan,
        re-chunked to its dp whatever topology saved them: new (params,
        opt_state, aux) dicts in this step's name order."""
        dev = torch.device(device) if device is not None \
            else self.ctx.torch_device()
        self.plan.note_host({n: host_params[n] for n in self.param_names})
        return self._placed(host_params, host_state, host_aux, dev)

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
        at the heads; recomputed in the backward under ``remat``.  The
        global-batch statistics are set inside the walk: a recompute runs
        on whatever thread drives the backward (autograd's device thread
        for CUDA tensors), which does not see the caller's setting."""
        dtype = self._dtype

        def fwd():
            vals = dict(batch)
            params = leaves
            if dtype is not None:
                vals = _cast_inputs(vals, dtype, self.label_names)
                params = {k: v.to(dtype) for k, v in leaves.items()}
            vals.update(params)
            with global_batch_stats(self._sync):
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
        full = self._gather(params) if self.plan.shard_params else params
        leaves = {n: full[n].detach().requires_grad_(True)
                  for n in self.param_names}
        del full
        outs, aux_upd = self._forward(
            leaves, aux, batch, None if lsc is None else lsc["scale"])
        seeds = [torch.ones((), dtype=o.dtype, device=o.device)
                 .expand(o.shape) for o in outs]
        grads = head_grads(outs, seeds, [leaves[n] for n in self.param_names])
        grads = {n: torch.zeros_like(leaves[n]) if g is None
                 else g.to(params[n].dtype)
                 for n, g in zip(self.param_names, grads)}
        # the graph goes with the outputs' history, and at level 3 the
        # gathered parameters with the leaves
        outs = [o.detach() for o in outs]
        del leaves
        # the range names the optimizer rule's kernels in a profile
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.update"):
            grads = self._reduce(grads)
            finite = None
            if lsc is not None:
                # overflow is judged on the scaled float32 gradients, on the
                # device (agreed by the ranks when each holds a row); the
                # update is unscaled by 1/S once and kept only where the
                # verdict is finite (a select, not a host branch)
                finite = self._finite(grads)
                inv = 1.0 / lsc["scale"]
                grads = {n: g * inv.to(g.dtype) for n, g in grads.items()}
            self._update(params, opt_state, aux, aux_upd, grads, hyper, t,
                         finite)
            if lsc is not None:
                self._scale_state = self.policy.next_state(lsc, finite)
                # the loss surface crosses back in float32
                outs = [o.to(torch.float32) for o in outs]
        return params, opt_state, aux, tuple(outs)

    def _reduce(self, grads):
        """The gradients across the dp ranks: all-reduced, one bucket a
        dtype (levels 0-1), or folded into the flat bucket whose
        reduce-scatter leaves this rank's row (levels 2-3: ``{"": row}``).
        Unchanged at dp 1 but for the fold."""
        plan = self.plan
        if plan.bucket_grads:
            layout = plan.bucket_layout(self.param_names)
            bucket = plan.fold_bucket(grads, layout)
            if self._dp == 1:
                return {"": bucket[0]}
            return {"": _dist.reduce_scatter_rows(bucket, self._group)}
        if self._dp == 1:
            return grads
        by_dtype = {}
        for n in self.param_names:
            by_dtype.setdefault(grads[n].dtype, []).append(n)
        out = {}
        for names in by_dtype.values():
            flat = _dist.all_reduce_(torch.cat(
                [grads[n].reshape(-1) for n in names]), self._group)
            off = 0
            for n in names:
                k = grads[n].numel()
                out[n] = flat[off:off + k].view(grads[n].shape)
                off += k
        return out

    def _finite(self, grads):
        """The overflow verdict on the reduced gradients, a 0-d bool on
        the device: a bucket row's verdict is agreed across the ranks."""
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        if self.plan.bucket_grads and self._dp > 1:
            finite = _dist.all_finite(finite, self._group)
        return finite

    def _update(self, params, opt_state, aux, aux_upd, grads, hyper, t,
                finite):
        """The rule's results copied into the caller's tensors; with a
        ``finite`` verdict, each copy keeps the old value where it is
        false.  Levels >= 1 step this rank's rows; levels 1-2 then gather
        the updated rows into the replicated parameters."""
        def put(dst, new):
            new = new.to(dst.dtype)
            dst.copy_(new if finite is None
                      else torch.where(finite, new, dst))
        plan = self.plan
        if not plan.shard_state:
            for n in self.param_names:
                w = params[n]
                new_w, new_state = self.fopt.update(n, w, grads[n],
                                                    opt_state[n], hyper, t)
                put(w, new_w)
                for st, v in zip(opt_state[n], new_state):
                    put(st, v)
        else:
            layout = plan.bucket_layout(self.param_names)
            bucket = grads.get("")
            rows, off = [], 0
            for n, c in layout:
                w = params[n] if plan.shard_params else plan.row_of(
                    params[n])
                g = bucket[off:off + c] if bucket is not None \
                    else plan.row_of(grads[n])
                off += c
                new_w, new_state = self.fopt.update(n, w, g, opt_state[n],
                                                    hyper, t)
                for st, v in zip(opt_state[n], new_state):
                    put(st, v)
                if plan.shard_params:
                    put(params[n], new_w)
                else:
                    rows.append(new_w.to(params[n].dtype))
            if rows:
                # one all-gather of every updated row
                row = torch.cat(rows)
                full = _dist.all_gather_rows(row, self._group, self._dp) \
                    if self._dp > 1 else row.unsqueeze(0)
                off = 0
                for n, c in layout:
                    put(params[n], plan.from_flat(full[:, off:off + c],
                                                  plan.shape_of(n)))
                    off += c
        for k, v in aux_upd.items():
            if k in aux:
                put(aux[k], v)

    # ----------------------------------------------------------------- ZeRO
    def _gather(self, params):
        """Level-3 rows -> logical parameters: one all-gather of every
        row."""
        plan = self.plan
        row = torch.cat([params[n].reshape(-1) for n in self.param_names])
        full = _dist.all_gather_rows(row, self._group, self._dp) \
            if self._dp > 1 else row.unsqueeze(0)
        out, off = {}, 0
        for n in self.param_names:
            c = params[n].numel()
            out[n] = plan.from_flat(full[:, off:off + c], plan.shape_of(n))
            off += c
        return out

    def gather_params(self, params):
        """Logical, replicated parameters from the level-3 rows (the
        ``zero.gather`` span while telemetry records).  The identity below
        level 3: callers that need full weights (the fit's sync-back, an
        eval hand-off) call it unconditionally."""
        if not self.plan.shard_params:
            return params
        if not _tel._enabled:
            return self._gather(params)
        with _tel.span("zero.gather", cat="distributed", level=self.zero,
                       tensors=len(params)):
            out = self._gather(params)
            _engine.settle(list(out.values()))
        return out

    def gather_state(self, opt_state):
        """Logical optimizer state from the rows of levels >= 1 (one
        all-gather a dtype's rows); the identity below level 1."""
        plan = self.plan
        if not plan.shard_state:
            return opt_state
        leaves = [(n, i) for n in self.param_names
                  for i in range(len(opt_state[n]))]
        out = {n: [None] * len(opt_state[n]) for n in self.param_names}
        if leaves:
            row = torch.cat([opt_state[n][i].reshape(-1) for n, i in leaves])
            full = _dist.all_gather_rows(row, self._group, self._dp) \
                if self._dp > 1 else row.unsqueeze(0)
            off = 0
            for n, i in leaves:
                c = opt_state[n][i].numel()
                out[n][i] = plan.from_flat(full[:, off:off + c],
                                           plan.shape_of(n))
                off += c
        return {n: tuple(v) for n, v in out.items()}

    def unflatten_host(self, name, arr):
        """A host flat (dp, chunk) array -> the logical array."""
        return self.plan.unflatten_host(name, arr)

    def zero_bytes(self, params, opt_state=None):
        """Per-device {param, grad, opt} bytes of this step's placement
        plan, from shape metadata (readable with telemetry off; the
        ``zero_param_bytes`` / ``zero_grad_bytes`` gauges)."""
        plan = self.plan
        ps = {n: _Meta((plan.dp, v.numel()), v.dtype) if plan.shard_params
              else v for n, v in params.items()}
        st = None
        if opt_state:
            st = {n: tuple(_Meta((plan.dp, x.numel()), x.dtype)
                           if plan.shard_state else x for x in leaves)
                  for n, leaves in opt_state.items()}
        return plan.per_device_bytes(ps, st)

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
        if not sq:
            return None
        sq = torch.stack(sq)
        if self.plan.shard_params and self._dp > 1:
            # level-3 rows: the norms of the whole parameters
            _dist.all_reduce_(sq, self._group, "monitor")
        return sq

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
        does; on a mesh ``batch`` is the global batch, of which the step
        takes this rank's rows, and the outputs are those rows).  ``rng``
        is accepted for the JAX signature: an op that draws random numbers
        (Dropout, the samplers) draws from the generator of the step's
        device (``random.generator``).

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
        if _tel._enabled and self.zero:
            # the plan's per-device bytes: shape metadata, the same every
            # step
            if self._zb_cache is None:
                self._zb_cache = self.zero_bytes(res[0], res[1])
            _tel.gauge("zero_param_bytes", self._zb_cache["param"],
                       level=self.zero)
            _tel.gauge("zero_grad_bytes", self._zb_cache["grad"],
                       level=self.zero)
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
        if stacked and self._dp > 1 and not isinstance(batch, _RankBatch):
            # the batch axis of a stacked leaf is axis 1
            batch = _RankBatch(_to_device(
                _batch_rows("TrainStep", batch, 1, self._dp, self._row),
                self.ctx.torch_device()))
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
    """Forward-only step (parity: mxnet_tpu.train.EvalStep):
    ``step(params, aux, batch)`` returns the outputs as a tuple, computed
    without autograd.  ``dtype=`` casts the float32 inputs (labels
    excepted) and the parameters to that dtype; ``policy=`` contributes
    only its compute dtype (no backward, so no loss scale).  The outputs
    stay in the compute dtype.  A host batch (numpy arrays, NDArrays)
    moves to the parameters' device, as the JAX package's jit moves it.

    ``mesh=`` (a ``dp`` mesh): each rank runs the forward on its rows of
    the global batch, and the outputs are gathered along the batch axis,
    so every rank returns the whole batch's outputs.  The parameters are
    the logical ones (``TrainStep.gather_params`` gives them at level
    3)."""

    def __init__(self, symbol, mesh=None, dtype=None,
                 label_names=("softmax_label",), policy=None):
        _check_mesh("EvalStep", mesh)
        _, self._dtype = _compute_dtype("EvalStep", dtype, policy)
        self._low = _Lowered(symbol)
        self.label_names = tuple(label_names)
        self.mesh = mesh
        if mesh is not None and "dp" in _mesh.axis_names(mesh):
            self._dp = _mesh.axis_size(mesh, "dp")
            self._row = _mesh.axis_rank(mesh, "dp")
            self._group = _mesh.axis_group(mesh, "dp")
        else:
            self._dp, self._row, self._group = 1, 0, None

    def __call__(self, params, aux, batch, rng=None):
        dev = next(iter(params.values())).device if params \
            else current_context().torch_device()
        if self._dp > 1 and not isinstance(batch, _RankBatch):
            batch = _batch_rows("EvalStep", batch, 0, self._dp, self._row)
        vals = _to_device(batch, dev)
        if self._dtype is not None:
            vals = _cast_inputs(vals, self._dtype, self.label_names)
            params = {k: v.to(self._dtype) for k, v in params.items()}
        vals.update(params)
        outs, _ = self._low.run(vals, aux, False)
        if self._dp > 1:
            outs = [_dist.all_gather_batch(o.contiguous(), self._group,
                                           self._dp) for o in outs]
        return tuple(outs)
