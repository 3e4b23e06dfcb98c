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
naming only ``dp`` (or no axis) leaves the parameter replicated.

Tensor parallelism (a ``dp x tp`` mesh, or ``tp`` alone, with
``param_shardings`` naming ``tp`` on a dimension of a parameter, as the
dryrun's ``{"fc1_weight": ("tp", None), "fc1_bias": ("tp",)}``): every
rank keeps its slice of each such parameter and of its optimizer state,
and the executor's walk reads it through the routes of a
``parallel.tensor_parallel.TensorParallel`` plan built once with the step
(a column- or row-parallel ``FullyConnected``, or the parameter
all-gathered where it is read), the collectives XLA inserts for the JAX
step. The ranks of one ``tp`` slice take the same rows (``shard_batch``
goes by the ``dp`` coordinate), so BatchNorm's sums and the split
gradients' all-reduce go over the ``dp`` group only (``axis_group(mesh,
"dp")``: this tp index's dp slice), and the outputs are the dp slice's
rows at full width. The replicas agree by construction, not by the
kernels' determinism: the replicated gradients are summed over the whole
mesh and scaled by 1/tp, and the moving statistics' updates averaged over
the ``tp`` group, so every rank takes the same update bit for bit (so the
mesh spans the world). Under a policy the overflow verdict is the world's
(the split gradients differ across the ``tp`` ranks). ZeRO with a ``tp``
spec refuses, in the JAX package's words. Without a mesh, or on a ``tp``
axis of size 1, a ``tp`` spec leaves the parameter whole, as in the JAX
package, where a spec without a mesh is not read. Any other mesh axis of
size > 1 refuses (``pp`` names ``PipelineTrainStep``; a sequence mesh goes
to ``parallel.mesh.set_sequence_mesh``).

Sequence parallelism (``parallel.mesh.set_sequence_mesh``, read each step
as the attention op reads it): every rank of the sequence mesh's axis runs
the step on the same batch and only the attention op is split (ring
attention). The replicas agree by construction, as the tp ones do: the
gradients (after the dp reduction) and the moving statistics' updates are
averaged over the axis's group (``sp_all_reduce``), so every rank takes
the same update bit for bit.

Checkpoints: ``checkpoint_topology`` (one stage, the ZeRO level and dp
width, the ``tp`` width, the logical shapes at level 3),
``place_checkpoint`` (re-chunked to this mesh's dp, whatever topology
saved them), ``export_host`` and the loss-scale hooks serve
``checkpoint.py``'s sharded format, whose optimizer-state tuples are the
JAX ``_FunctionalOptimizer.init_state``'s, in its order.

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
from .parallel.placement import (PlacementPlan, chunk_rows, flat_shards,
                                 from_flat, normalize_zero)
from .parallel import tensor_parallel as _tpar

__all__ = ["TrainStep", "EvalStep", "PipelineTrainStep",
           "pipeline_bubble_fraction"]

# remat="dots": the matrix products without batch dimensions whose outputs
# the recompute keeps (JAX's dots_with_no_batch_dims_saveable saves neither
# convolutions nor batched products)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _refuse_axis(who, axis, size=None):
    sized = "" if size is None else " of size %d" % size
    if axis == "pp":
        raise MXNetError("%s: a 'pp' axis%s: pipelined training runs "
                         "through PipelineTrainStep over "
                         "parallel.mesh.make_pp_mesh" % (who, sized))
    raise MXNetError("%s: mesh axis %r%s: the port shards a step over 'dp' "
                     "and 'tp' only (a sequence mesh goes to "
                     "parallel.mesh.set_sequence_mesh)" % (who, axis, sized))


def _check_mesh(who, mesh):
    """The mesh is a DeviceMesh whose axes other than ``dp`` and ``tp``
    have size 1."""
    if mesh is None:
        return
    if not _mesh._is_mesh(mesh):
        raise MXNetError("%s(mesh=...) takes a parallel.mesh.make_mesh "
                         "mesh (a torch DeviceMesh), got %r"
                         % (who, type(mesh).__name__))
    for axis in _mesh.axis_names(mesh):
        size = _mesh.axis_size(mesh, axis)
        if axis not in ("dp", "tp") and size > 1:
            _refuse_axis(who, axis, size)


def _check_shardings(who, mesh, shardings):
    """Each spec names ``dp`` (the parameter stays replicated over it),
    ``tp`` (a dimension split over it) or no axis.  Without a mesh a spec
    is not read (as the JAX package's), but a ``pp`` axis raises; on a
    mesh, an axis it lacks raises, and so does another axis of size > 1.
    Returns ``{name: dimension}`` of the dimensions split over a ``tp``
    axis of size > 1."""
    for name, spec in shardings.items():
        for axis in [a for entry in (spec or ())
                     for a in _tpar._axes(entry)]:
            if mesh is None or axis not in _mesh.axis_names(mesh):
                if axis == "pp":
                    _refuse_axis(who, axis)
                if mesh is None:
                    continue
                raise MXNetError("%s: param_shardings[%r] names axis %r, "
                                 "which the mesh has not" % (who, name,
                                                             axis))
            size = _mesh.axis_size(mesh, axis)
            if axis not in ("dp", "tp") and size > 1:
                _refuse_axis(who, axis, size)
    if mesh is None or _mesh.axis_size(mesh, "tp") == 1:
        return {}
    return _tpar.shard_dims(who, shardings)


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


def _write(dst, new, finite):
    """``new`` copied into ``dst`` in its dtype; with a ``finite`` verdict
    (a 0-d bool tensor) the old value stays where it is false: a select on
    the device, not a host branch."""
    new = new.to(dst.dtype)
    dst.copy_(new if finite is None else torch.where(finite, new, dst))


def _summed(tensors, names, group, scale=None, kind="all_reduce"):
    """``{name: tensor}`` of ``names`` summed across ``group`` (None: the
    world), one all-reduce a dtype, times ``scale`` when given."""
    by_dtype = {}
    for n in names:
        by_dtype.setdefault(tensors[n].dtype, []).append(n)
    out = {}
    for ns in by_dtype.values():
        flat = _dist.all_reduce_(torch.cat(
            [tensors[n].detach().reshape(-1) for n in ns]), group, kind)
        if scale is not None:
            flat = flat * scale
        off = 0
        for n in ns:
            k = tensors[n].numel()
            out[n] = flat[off:off + k].view(tensors[n].shape)
            off += k
    return out


def _apply_rule(fopt, plan, names, params, opt_state, grads, hyper, t,
                finite, group, dp):
    """One optimizer step of the parameters ``names`` into the caller's
    tensors.  Below ZeRO level 1 the rule runs on the whole tensors;
    levels >= 1 step this rank's rows of the flat view (``grads`` is then
    ``{"": row}`` of the reduce-scattered bucket, or the full tree whose
    rows the rule takes), and levels 1-2 gather the updated rows into the
    replicated parameters with one all-gather over ``group``."""
    if not plan.shard_state:
        for n in names:
            w = params[n]
            new_w, new_state = fopt.update(n, w, grads[n], opt_state[n],
                                           hyper, t)
            _write(w, new_w, finite)
            for st, v in zip(opt_state[n], new_state):
                _write(st, v, finite)
        return
    layout = plan.bucket_layout(names)
    bucket = grads.get("")
    rows, off = [], 0
    for n, c in layout:
        w = params[n] if plan.shard_params else plan.row_of(params[n])
        g = bucket[off:off + c] if bucket is not None \
            else plan.row_of(grads[n])
        off += c
        new_w, new_state = fopt.update(n, w, g, opt_state[n], hyper, t)
        for st, v in zip(opt_state[n], new_state):
            _write(st, v, finite)
        if plan.shard_params:
            _write(params[n], new_w, finite)
        else:
            rows.append(new_w.to(params[n].dtype))
    if rows:
        # one all-gather of every updated row
        row = torch.cat(rows)
        full = _dist.all_gather_rows(row, group, dp) if dp > 1 \
            else row.unsqueeze(0)
        off = 0
        for n, c in layout:
            _write(params[n], plan.from_flat(full[:, off:off + c],
                                             plan.shape_of(n)), finite)
            off += c


class _LossScale(object):
    """The loss-scale state of a step under a policy (``self.policy``,
    ``self._has_scale``, ``self.ctx``): on the step's device, moved by
    ``Policy.next_state`` after every step."""

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


class TrainStep(_LossScale):
    """Symbol + Optimizer -> one training step on one device, or on each
    rank of a data-parallel mesh (parity: mxnet_tpu.train.TrainStep).

    symbol : the loss-topped Symbol (e.g. a SoftmaxOutput head)
    optimizer : an ``optimizer.Optimizer``
    data_names / label_names : the input variables (not trained)
    mesh : None, or a ``parallel.mesh.make_mesh`` mesh with a ``dp`` axis:
        each rank steps on its rows of the global batch (see the module's
        docstring)
    param_shardings : {param name: spec}, a spec a tuple of one entry a
        dimension (None, ``"dp"``, ``"tp"``): ``tp`` splits that dimension
        over the mesh's ``tp`` axis (see the module's docstring), ``dp`` or
        no axis leaves the parameter replicated
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
        tp_dims = _check_shardings("TrainStep", mesh, self.param_shardings)
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
                    "combine it with tensor-parallel param_shardings is "
                    "not supported yet" % self.zero)
        # the data-parallel width, this rank's row and the group of the
        # mesh's dp axis (a mesh without one replicates the step)
        if mesh is not None and "dp" in _mesh.axis_names(mesh):
            self._dp = _mesh.axis_size(mesh, "dp")
            self._row = _mesh.axis_rank(mesh, "dp")
            self._group = _mesh.axis_group(mesh, "dp")
        else:
            self._dp, self._row, self._group = 1, 0, None
        # the tensor-parallel plan over a tp axis of size > 1: this rank's
        # slice of each split parameter, and the routes of their readers,
        # chosen once here
        tp_dims = {n: d for n, d in tp_dims.items() if n in self.param_names}
        self._tp = None
        if mesh is not None and _mesh.axis_size(mesh, "tp") > 1:
            self._tp = _tpar.TensorParallel(
                self._low, tp_dims, _mesh.axis_size(mesh, "tp"),
                _mesh.axis_rank(mesh, "tp"), _mesh.axis_group(mesh, "tp"))
            ranks = int(mesh.mesh.numel())
            if ranks != _dist.num_workers():
                raise MXNetError(
                    "TrainStep over a tp axis: the replicated gradients, "
                    "and an overflow verdict, are agreed over the whole "
                    "world; a mesh of %d of the world's %d ranks is not "
                    "ported (a mesh of every rank)"
                    % (ranks, _dist.num_workers()))
        # BatchNorm's statistics over the global batch: the dp group's rows
        # (never the world's: the tp ranks of a dp slice hold the same rows)
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
        tp = self._tp
        if tp is not None:
            for n, d in tp.dims.items():
                _tpar.check_divisible("TrainStep", n,
                                      self.param_shardings[n],
                                      tuple(host(params[n]).shape), d,
                                      tp.size)

        def mine(n, v):
            """This rank's slice of a tp-split leaf, else the leaf."""
            if tp is None or n not in tp.dims:
                return put(v)
            return _dist.slice_of(host(v), tp.dims[n], tp.index,
                                  tp.size).to(dev, copy=True)
        placed = {n: row(params[n]) if plan.shard_params
                  else mine(n, params[n]) for n in self.param_names}
        if state is None:
            state = self.fopt.init_state(
                {n: row(params[n]) if plan.shard_state else placed[n]
                 for n in self.param_names})
        else:
            state = {n: tuple(row(s) if plan.shard_state else mine(n, s)
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

    # ----------------------------------------------------------- checkpoint
    def checkpoint_topology(self):
        """The shard ownership of this step for ``checkpoint.snapshot``: one
        stage owns every parameter and aux state; the ZeRO level, its dp
        width, the ``tp`` width (``snapshot`` gathers the split parameters
        and states whole: ``gather_params`` / ``gather_state``) and, at
        level 3, the logical shapes (parity:
        TrainStep.checkpoint_topology)."""
        topo = {"pp": 1, "dp": self.plan.dp, "zero": self.zero,
                "row": self.plan.row, "microbatches": None,
                "tp": self._tp.size if self._tp is not None else 1,
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
                                     device=self.ctx, head_grad_scale=scale,
                                     tp=self._tp)
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
            sp = self._sp_group()
            if sp is not None:
                # the sequence replicas' gradients, their mean: the same
                # bits on every rank of the axis
                grads = _summed(grads, sorted(grads), sp[0], 1.0 / sp[1],
                                "sp_all_reduce")
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
        if self._tp is not None:
            return self._tp_reduce(grads)
        if plan.bucket_grads:
            layout = plan.bucket_layout(self.param_names)
            bucket = plan.fold_bucket(grads, layout)
            if self._dp == 1:
                return {"": bucket[0]}
            return {"": _dist.reduce_scatter_rows(bucket, self._group)}
        if self._dp == 1:
            return grads
        return _summed(grads, self.param_names, self._group)

    def _tp_reduce(self, grads):
        """The gradients under a tp plan: the split ones summed over the
        dp group; the replicated ones summed over the whole mesh and
        scaled by 1/tp, the mean of the tp replicas' sums, so every rank
        takes the same update bit for bit whatever order its kernels
        summed in (a card's convolution backward need not repeat its
        rounding from one process to another)."""
        tp = self._tp
        split = [n for n in self.param_names if n in tp.dims]
        rep = [n for n in self.param_names if n not in tp.dims]
        out = dict(grads)
        if self._dp > 1 and split:
            out.update(_summed(grads, split, self._group))
        if rep:
            out.update(_summed(grads, rep, None, 1.0 / tp.size))
        return out

    @staticmethod
    def _sp_group():
        """(group, size) of the active sequence mesh's axis when it spans
        more than one rank, else None."""
        mesh, axis = _mesh.sequence_mesh()
        if mesh is None or _mesh.axis_size(mesh, axis) == 1:
            return None
        return _mesh.axis_group(mesh, axis), _mesh.axis_size(mesh, axis)

    def _finite(self, grads):
        """The overflow verdict on the reduced gradients, a 0-d bool on
        the device: a bucket row's verdict is agreed across the ranks."""
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        if self.plan.bucket_grads and self._dp > 1:
            finite = _dist.all_finite(finite, self._group)
        elif self._tp is not None:
            # the tp ranks hold different slices: the world's verdict
            finite = _dist.all_finite(finite, None)
        return finite

    def _update(self, params, opt_state, aux, aux_upd, grads, hyper, t,
                finite):
        """The rule's results copied into the caller's tensors
        (``_apply_rule``), then the moving statistics; with a ``finite``
        verdict each copy keeps the old value where it is false."""
        _apply_rule(self.fopt, self.plan, self.param_names, params,
                    opt_state, grads, hyper, t, finite, self._group, self._dp)
        if self._tp is not None and aux_upd:
            # the tp replicas' moving statistics, their mean (one
            # all-reduce): the same bits on every rank of the slice
            aux_upd = _summed(aux_upd, sorted(aux_upd), self._tp.group,
                              1.0 / self._tp.size, "tp_all_reduce")
        sp = self._sp_group()
        if sp is not None and aux_upd:
            aux_upd = _summed(aux_upd, sorted(aux_upd), sp[0], 1.0 / sp[1],
                              "sp_all_reduce")
        for k, v in aux_upd.items():
            if k in aux:
                _write(aux[k], v, finite)

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
        ``zero.gather`` span while telemetry records), or from the
        tp-split slices (one all-gather over ``tp`` a split parameter).
        The identity otherwise: callers that need full weights (the fit's
        sync-back, an eval hand-off, a checkpoint) call it
        unconditionally."""
        if self._tp is not None:
            return {n: self._tp.whole(n, v) if n in self._tp.dims else v
                    for n, v in params.items()}
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
        all-gather a dtype's rows), or from the tp-split slices; the
        identity otherwise."""
        if self._tp is not None:
            return {n: tuple(self._tp.whole(n, x) for x in st)
                    if n in self._tp.dims else st
                    for n, st in opt_state.items()}
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
        elif self._tp is not None:
            # the tp slices' norms summed into the whole parameters'
            split = torch.tensor([n in self._tp.dims
                                  for n in self.param_names],
                                 device=sq.device)
            whole = _dist.all_reduce_(sq.clone(), self._tp.group, "monitor")
            sq = torch.where(split, whole, sq)
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

    ``mesh=`` (a ``dp`` mesh, or ``dp x tp``): each rank runs the forward
    on its dp rows of the global batch, and the outputs are gathered
    along the batch axis over the dp group, so every rank returns the
    whole batch's outputs.  The parameters are the logical, whole ones, as
    the JAX package's EvalStep takes them (``TrainStep.gather_params``
    gives them from level-3 rows or tp slices)."""

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


def pipeline_bubble_fraction(pp, microbatches, interleave=1):
    """Idle-slot share of the executed pipeline schedule under the
    equal-cost slot model (parity: train.pipeline_bubble_fraction): GPipe
    and 1F1B pay ``(pp - 1) / (pp - 1 + M)``, the interleaved schedule's
    ramps cost one chunk, ``(pp - 1) / ((pp - 1) + v * M)``.  The executed
    order is asserted against it when the plan is built
    (``parallel.schedule.simulate``)."""
    return float(pp - 1) / float(pp - 1 + interleave * microbatches)


# the pipeline's P2P message tags: (microbatch, virtual stage, direction,
# tensor index) packed into one int; the outputs' hand-off takes tags of
# (0, 0, forward), which no carry uses (stage 0 receives none)
_TAG_TENSORS = 64
_OUT_TAG = 1


def _pp_tag(m, k, V, back, j):
    return ((m * V + k) * 2 + int(back)) * _TAG_TENSORS + j


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _meta_nbytes(shape, dtype):
    return _numel(shape) * torch.empty((), dtype=dtype).element_size()


class PipelineTrainStep(_LossScale):
    """Stage-partitioned, microbatched training over the ``pp`` axis of a
    ``dp x pp`` mesh (parity: mxnet_tpu.train.PipelineTrainStep), one rank
    a device slice.

    The symbol's op sequence is cut into ``pp * v`` virtual stages
    (``executor._Lowered.stage_partition``: cuts where no peephole pair
    straddles them, the parameter footprint balanced); virtual stage ``k``
    lives on slice ``k % pp``, whose ranks (one a dp index, rank = d * pp
    + s) hold only its parameters, optimizer state and moving statistics.
    Every rank passes the GLOBAL batch; a step splits it into ``M``
    microbatches (``num_microbatches``, default pp) and each rank runs its
    slice's work items of the schedule in the planned order
    (``parallel.schedule``: ``gpipe``, ``1f1b``, ``interleaved``;
    ``schedule=`` / ``interleave=`` default to ``MXNET_PP_SCHEDULE`` /
    ``MXNET_PP_INTERLEAVE``).  The idle share of the planned order is
    asserted against :func:`pipeline_bubble_fraction` when the plan is
    built; the gpipe order is m-major, as the reference's.

    A forward item walks its stage (``_Lowered.run(stage=)``) without
    autograd and stashes only its boundary inputs (the received carry and
    its rows of the data or labels); the backward item recomputes the
    stage's forward under autograd, as the reference's ``jax.vjp`` of the
    rematerialised stage does, and accumulates the parameter gradients
    over the microbatches.  Boundary activations go forward and
    cotangents back point to point (``parallel.dist.send_`` / ``recv_``,
    counted as ``send`` / ``recv``); each rank posts its receives a few
    items ahead in its planned order, and a send never waits for its
    receiver, so no schedule can deadlock.  The final stage hands the
    step's outputs (the whole global batch's loss heads) to the other
    slices (``send_outputs`` / ``recv_outputs``), so every rank returns
    them.

    On a dp x pp mesh every microbatch is split over the stage's dp ranks:
    BatchNorm's statistics are the whole microbatch's (summed across the
    stage's dp group, ``ops.nn.global_batch_stats``) and the moving
    statistics chain through the microbatches in order.  A stage's dp
    gradients, counted by kind in ``dist.collective_calls``:

    - gpipe at ZeRO levels 0-1: accumulated whole, then all-reduced over
      the stage's dp group, one bucket a dtype;
    - the bucket (ZeRO levels 2-3 on every schedule, and the 1f1b and
      interleaved schedules at dp > 1): each microbatch's backward folds
      the stage's gradients into one flat ``(dp, chunk)`` bucket
      (``parallel.placement``'s layout over the stage's parameters) and
      reduce-scatters it, so this rank's row accumulates over the
      microbatches and is the stage's only gradient residency.  Levels
      1-3 update from the row directly; at level 0 the stage's one
      all-gather of the row is issued asynchronously at its last backward
      and waited for in the update, so it runs under the rank's remaining
      items.

    ZeRO (``zero=0..3``, True is 1; needs a ``dp`` axis): the placement
    plan applies to each stage over its dp group, as ``TrainStep(mesh=,
    zero=)`` over a dp mesh: levels >= 1 keep the optimizer state as this
    rank's rows of the flat view and gather the updated parameter rows
    once a stage (levels 1-2); level 3 keeps the parameters as rows too,
    and every forward item and backward recompute gathers its stage's
    parameters just in time (the ``zero.gather`` span), freed when the
    item ends: 2 M gathers a stage a step.

    Mixed precision (``policy=``, an ``amp.Policy``) and the pure cast
    (``dtype=``), as ``TrainStep``: a stage walk casts its float32 data
    inputs and a copy of its parameters to the compute dtype (labels and
    moving statistics uncast), the carries and their cotangents cross in
    it, and the outputs cross back in float32 under a policy.  The loss
    scale is the head-gradient scale of the loss-bearing stage (folded
    into the ``'batch'`` heads' 1/M).  Each rank judges its stages' reduced
    gradients (its rows in the bucket), and one verdict over the world
    (``dist.all_finite``, kind ``verdict``) makes every stage skip or
    update together: the update is unscaled by 1/S once and kept only
    where the verdict is finite (a select, no host read), and on overflow
    the moving statistics the forwards chained go back to their pre-step
    values.  Every rank holds the loss-scale state and moves it by the
    same verdict, so ``amp_stats()`` agrees on every rank.

    Semantics against the one-program ``TrainStep`` (same global batch,
    same update count), as the reference's: per-sample loss heads
    accumulate to the same gradient; ``'batch'``-normalized heads are
    folded by ``1/M`` (the head-gradient scale); ``'valid'`` raises when
    M > 1; BatchNorm nets match exactly at M = 1, at M > 1 the
    microbatched reference (``pp = 1`` with the same M).

    ``last_live_bytes`` is each slice's parameters, optimizer state and
    moving statistics (the sharded leaves at 1/dp) plus the peak stash of
    its planned order, from shape metadata (the global microbatch's bytes,
    as the reference counts them); ``zero_bytes`` the plan's per-device
    bytes.  While telemetry records, a step emits the ``pp.stage`` span of
    this rank's slice (its items' seconds, waited for), ``pp.bubble``, the
    ``pp_bubble_fraction`` / ``pp_stage<N>_live_bytes`` gauges, under a
    policy the ``loss_scale`` gauge and ``amp_overflow_steps`` counter,
    and at a ZeRO level the ``zero_param_bytes`` / ``zero_grad_bytes``
    gauges.

    A mesh axis other than ``dp`` and ``pp`` raises, in the JAX package's
    words ("composes with dp only").
    """

    # receives posted ahead of the item being run, in its slice's order
    RECV_AHEAD = 2

    def __init__(self, symbol, optimizer, data_names=("data",),
                 label_names=("softmax_label",), mesh=None,
                 num_microbatches=None, zero=False, policy=None, dtype=None,
                 schedule=None, interleave=None, ctx=None):
        from .base import get_env
        from .parallel import schedule as _sched
        if mesh is None or not _mesh._is_mesh(mesh) \
                or "pp" not in _mesh.axis_names(mesh):
            raise MXNetError(
                "PipelineTrainStep needs a mesh with a 'pp' axis "
                "(parallel.mesh.make_pp_mesh)")
        extra = set(_mesh.axis_names(mesh)) - {"dp", "pp"}
        if extra:
            raise MXNetError(
                "PipelineTrainStep composes with dp only; mesh axes %s "
                "are not supported yet" % sorted(extra))
        self.zero = normalize_zero(zero)
        if self.zero and "dp" not in _mesh.axis_names(mesh):
            raise MXNetError("PipelineTrainStep(zero=%d) needs a mesh with a "
                             "'dp' axis to shard over" % self.zero)
        self.policy, self._dtype = _compute_dtype("PipelineTrainStep", dtype,
                                                  policy)
        ranks = int(mesh.mesh.numel())
        if self.policy is not None and 1 < ranks != _dist.num_workers():
            raise MXNetError(
                "PipelineTrainStep(policy=): the overflow verdict is agreed "
                "over the whole world; a mesh of %d of the world's %d ranks "
                "is not ported (a mesh of every rank, or of one)"
                % (ranks, _dist.num_workers()))
        self._has_scale = self.policy is not None
        self._scale_state = None
        self._overflow_seen = 0
        self._amp_emit = True
        self.symbol = symbol
        self.mesh = mesh
        self.ctx = Context(ctx) if ctx is not None else current_context()
        self._pp = _mesh.axis_size(mesh, "pp")
        self._dp = _mesh.axis_size(mesh, "dp")
        self._slice = _mesh.axis_rank(mesh, "pp")
        self._row = _mesh.axis_rank(mesh, "dp") \
            if "dp" in _mesh.axis_names(mesh) else 0
        self._group = _mesh.axis_group(mesh, "dp") if self._dp > 1 else None
        self._sync = (self._group, self._dp) if self._dp > 1 else None
        self._subs = _mesh.pp_submeshes(mesh)
        # this rank's dp row: the global rank of each slice
        self._row_ranks = [sub.ranks[self._row] for sub in self._subs]
        self._micro = int(num_microbatches) \
            if num_microbatches is not None else self._pp
        if self._micro < 1:
            raise MXNetError("PipelineTrainStep: num_microbatches must be "
                             ">= 1, got %d" % self._micro)
        if schedule is None:
            schedule = get_env("MXNET_PP_SCHEDULE", "gpipe")
        if interleave is None:
            interleave = get_env("MXNET_PP_INTERLEAVE", None, typ=int)
            if interleave is None:
                interleave = 2 if str(schedule).lower() == "interleaved" \
                    else 1
        self._schedule, self._v = _sched.validate_schedule(
            schedule, self._pp, self._micro, interleave)
        self._V = self._pp * self._v
        # the overlapped dp gradients of the 1f1b and interleaved schedules,
        # and the flat bucket as the gradient residency (reference :1626,
        # :1640)
        self._overlap = self._dp > 1 and self._schedule != "gpipe"
        self._bucket = self.zero >= 2 or self._overlap
        self.plan = PlacementPlan(zero=self.zero, dp=self._dp,
                                  who="PipelineTrainStep", row=self._row)
        self._zb_cache = None
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
        self._stages = None
        self._var_stage = {}
        self._stage_has_loss = None
        self._micro_comp = False
        self._meta = None          # {name: (shape, dtype)} of every variable
        self._plans = {}
        self._carry_cache = {}
        self._opt_lens = {}
        self.last_live_bytes = None
        self._mon_force = False
        self._last_mon_entry = None

    # ------------------------------------------------------------- planning
    def _ensure_plan(self, param_sizes=None):
        if self._stages is not None:
            return
        self._stages = self._low.stage_partition(
            self._V, input_names=self._inputs, param_sizes=param_sizes)
        for st in self._stages:
            for n in list(st.params) + list(st.aux):
                self._var_stage[n] = st.index
        has_loss = [False] * self._V
        norm_modes = set()
        for st in self._stages:
            for n in st.nodes:
                if not n.is_var and getattr(n.op, "is_loss", False):
                    has_loss[st.index] = True
                    norm_modes.add(n.op.normalize_attrs(n.params)
                                   .get("normalization") or "null")
        self._stage_has_loss = has_loss
        if self._micro > 1 and "valid" in norm_modes:
            raise MXNetError(
                "pipeline microbatching: a loss head uses "
                "normalization='valid' — its per-microbatch valid count "
                "cannot be folded into a constant head-grad scale; use "
                "'null'/'batch' normalization or num_microbatches=1")
        if self._micro > 1 and "batch" in norm_modes and len(norm_modes) > 1:
            raise MXNetError(
                "pipeline microbatching: loss heads mix 'batch' and "
                "per-sample normalization — one head-grad scale cannot "
                "compensate both")
        self._micro_comp = self._micro > 1 and norm_modes == {"batch"}
        # the virtual stages of this rank's slice
        self._mine = [k for k in range(self._V)
                      if k % self._pp == self._slice]

    def stages(self):
        """The stage plan (``executor._Stage`` list, ``pp * interleave``
        virtual stages; stage ``k`` on slice ``k % pp``), or None before
        ``init`` / ``place_params``."""
        return self._stages

    def schedule(self):
        """(schedule name, interleave) of this step's plan."""
        return self._schedule, self._v

    def my_stages(self):
        """The virtual stages this rank runs."""
        self._require_plan("my_stages")
        return list(self._mine)

    def _require_plan(self, what):
        if self._stages is None:
            raise MXNetError(
                "PipelineTrainStep.%s: call init() or place_params() first "
                "— the stage plan is balanced from parameter sizes" % what)

    def _get_plan(self):
        """The dispatch plan of (schedule, interleave, M): every work item
        in planned order, this slice's items, the index in them of each
        stage's last backward, and the simulated idle share, asserted
        against the closed form."""
        from .parallel import schedule as _sched
        key = (self._schedule, self._v, self._micro)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        orders = _sched.stage_orders(self._pp, self._micro, self._schedule,
                                     self._v)
        if self._schedule == "gpipe":
            # the reference's m-major waves; the simulation scores the
            # per-slice order
            sim = _sched.simulate(orders, self._pp, self._v)
            items = [("fwd", m, k) for m in range(self._micro)
                     for k in range(self._V)]
            items += [("bwd", m, k) for m in reversed(range(self._micro))
                      for k in reversed(range(self._V))]
        else:
            items, sim = _sched.dispatch_order(orders, self._pp, self._v)
        want = pipeline_bubble_fraction(self._pp, self._micro, self._v)
        if abs(sim["bubble"] - want) > 1e-9:
            raise MXNetError(
                "pipeline schedule %s: executed idle share %.6f does not "
                "match pipeline_bubble_fraction(pp=%d, M=%d, v=%d)=%.6f"
                % (self._schedule, sim["bubble"], self._pp, self._micro,
                   self._v, want))
        slices = [[it for it in items if it[2] % self._pp == d]
                  for d in range(self._pp)]
        # where the overlap path issues a stage's gradient all-gather
        last_bwd = {}
        for i, (kind, _, k) in enumerate(slices[self._slice]):
            if kind == "bwd":
                last_bwd[k] = i
        plan = {"items": items, "bubble": sim["bubble"], "slices": slices,
                "last_bwd": last_bwd}
        self._plans[key] = plan
        return plan

    # ----------------------------------------------------------- placement
    def _host(self, v):
        t = v.value if isinstance(v, nd.NDArray) else v
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(
            _np.asarray(v))
        return t.detach()

    def _note_meta(self, host_params, host_aux=None):
        meta = dict(self._meta or {})
        for src in (host_params, host_aux or {}):
            for n, v in src.items():
                t = self._host(v)
                meta[n] = (tuple(t.shape), t.dtype)
        self._meta = meta

    def _put(self, v):
        return self._host(v).to(self.ctx.torch_device(), copy=True)

    def _row_put(self, v):
        """This rank's row of a logical host tensor's flat view, on the
        step's device."""
        return self.plan.row_of(self._host(v)).to(self.ctx.torch_device(),
                                                   copy=True)

    def _is_mine(self, name):
        return self._var_stage[name] % self._pp == self._slice

    def place_params(self, host_params):
        """Host {name: array} of every parameter -> this rank's stages'
        parameters on its device, rows of their flat views at ZeRO level 3
        (the stage plan is balanced from the sizes at the first call)."""
        self._ensure_plan({n: int(self._host(v).numel())
                           for n, v in host_params.items()})
        self._note_meta(host_params)
        self.plan.note_host({n: self._host(v) for n, v in
                             host_params.items()})
        put = self._row_put if self.plan.shard_params else self._put
        return {n: put(host_params[n]) for n in self.param_names
                if self._is_mine(n)}

    def place_aux(self, host_aux):
        """This rank's stages' aux states on its device (replicated at
        every ZeRO level)."""
        self._require_plan("place_aux")
        self._note_meta({}, host_aux)
        return {n: self._put(host_aux[n]) for n in self.aux_names
                if self._is_mine(n)}

    def place_state(self, host_state):
        """This rank's stages' replicated optimizer state tuples on its
        device.  At a ZeRO level the state is born as rows: ``init`` or
        ``place_checkpoint`` place it (as the reference refuses)."""
        self._require_plan("place_state")
        if self.zero:
            raise MXNetError(
                "PipelineTrainStep(zero=%d): the optimizer state is born as "
                "dp rows: use init() or place_checkpoint()" % self.zero)
        return {n: tuple(self._put(x) for x in host_state[n])
                for n in self.param_names if self._is_mine(n)}

    def _fresh_state(self, host_params):
        """Zero optimizer state of this rank's stages: rows at ZeRO levels
        >= 1, beside each parameter below."""
        put = self._row_put if self.plan.shard_state else self._put
        return self.fopt.init_state({n: put(host_params[n])
                                     for n in self.param_names
                                     if self._is_mine(n)})

    def init(self, data_shapes, label_shapes=None, initializer=None, seed=0):
        """Initialise every parameter and aux state on the host from
        ``seed`` (each rank draws the same values), balance the stage plan
        from their sizes, and keep this rank's stages' variables and their
        fresh optimizer state on its device (rows where the ZeRO level
        shards them).  Returns (params, opt_state, aux)."""
        params, aux = _host_init(self.symbol, self._low, self.param_names,
                                 self.aux_names, data_shapes, label_shapes,
                                 initializer, seed, "PipelineTrainStep")
        p = self.place_params(params)
        return p, self._fresh_state(params), self.place_aux(aux)

    def place_checkpoint(self, host_params, host_state, host_aux,
                         device=None):
        """Restored logical host trees placed on this rank's stages,
        re-chunked over each stage's dp group at a ZeRO level whatever
        topology saved them (``device`` is accepted for TrainStep's
        signature; the step's own device is used).  ``host_state`` None
        builds fresh state."""
        p = self.place_params(host_params)
        if host_state is None:
            s = self._fresh_state(host_params)
        else:
            put = self._row_put if self.plan.shard_state else self._put
            s = {n: tuple(put(x) for x in host_state[n])
                 for n in self.param_names if self._is_mine(n)}
        return p, s, self.place_aux(host_aux)

    def shard_batch(self, batch):
        """The global batch as host tensors: the step takes each
        microbatch's rows of this rank itself."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, nd.NDArray):
                v = v.value
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(_np.array(v, copy=True))
            out[k] = v
        return out

    def output_sharding(self):
        """The final stage's ``StageMesh``: where the outputs are made
        (every rank returns them after the hand-off)."""
        return self._subs[-1]

    # ----------------------------------------------------------- checkpoint
    def _owner(self, k):
        """The rank that writes virtual stage ``k``'s shards: its slice's
        rank of dp row 0."""
        return self._subs[k % self._pp].ranks[0]

    def checkpoint_topology(self):
        """Shard ownership for ``checkpoint.snapshot`` (parity:
        PipelineTrainStep.checkpoint_topology): every variable belongs to
        its virtual stage, whose ``stage<k>`` / ``stage<k>-opt`` shards its
        slice's rank of dp row 0 writes, and whose ZeRO rows
        ``stage<k>-zero<j>`` the slice's rank of dp row j writes; ``meta``
        lists every variable's logical shape and dtype for the manifest,
        which rank 0 writes."""
        self._require_plan("checkpoint_topology")
        meta = self._meta or {}
        return {"pp": self._pp, "dp": self._dp, "zero": self.zero,
                "param_shapes": {n: list(meta[n][0])
                                 for n in self.param_names if n in meta},
                "row": self._row, "microbatches": self._micro,
                "schedule": self._schedule, "interleave": self._v,
                "stage_of": dict(self._var_stage),
                "stage_owner": {k: self._owner(k) for k in range(self._V)},
                "zero_owner": {k: list(self._subs[k % self._pp].ranks)
                               for k in range(self._V)},
                "writes": self._row == 0,
                "aux_names": list(self.aux_names),
                "meta": {n: (list(s), str(d).replace("torch.", ""))
                         for n, (s, d) in meta.items()},
                "opt_len": {n: self._opt_len(n) for n in self.param_names}}

    def step_flops(self):
        return None

    def _opt_len(self, name):
        """The number of optimizer-state tensors of parameter ``name``."""
        n = self._opt_lens.get(name)
        if n is None:
            n = self._opt_lens[name] = len(
                self.fopt.init_state({name: torch.zeros(1)})[name])
        return n

    def _logical_mine(self, trees):
        """This rank's stages' leaves of ``trees`` (params, opt_state,
        aux; None skipped) as logical tensors: the ZeRO rows gathered over
        each stage's dp group (one all-gather a stage and dtype)."""
        params, opt_state, aux = trees
        out = [None if t is None else {} for t in trees]
        for k in self._mine:
            st = self._stages[k]
            rows = []         # (tree, name, tuple index or None)
            if params is not None:
                for n in st.params:
                    if self.plan.shard_params:
                        rows.append((0, n, None))
                    else:
                        out[0][n] = params[n]
            if opt_state is not None:
                for n in st.params:
                    if self.plan.shard_state:
                        rows += [(1, n, j) for j in range(len(opt_state[n]))]
                    else:
                        out[1][n] = tuple(opt_state[n])
            if aux is not None:
                for n in st.aux:
                    out[2][n] = aux[n]
            by_dt = {}
            for leaf in rows:
                i, n, j = leaf
                v = trees[i][n] if j is None else trees[i][n][j]
                by_dt.setdefault(v.dtype, []).append((leaf, v))
            for group in by_dt.values():
                row = torch.cat([v.reshape(-1) for _, v in group])
                full = _dist.all_gather_rows(row, self._group, self._dp) \
                    if self._dp > 1 else row.unsqueeze(0)
                off = 0
                for (i, n, j), v in group:
                    c = v.numel()
                    x = self.plan.from_flat(full[:, off:off + c],
                                            self.plan.shape_of(n))
                    off += c
                    if j is None:
                        out[i][n] = x
                    else:
                        out[i].setdefault(n, [None] * len(trees[i][n]))[j] = x
            if opt_state is not None:
                for n in st.params:
                    out[1][n] = tuple(out[1].get(n, ()))
        return out

    def gather_host(self, params=None, opt_state=None, aux=None):
        """Every stage's parameters, optimizer state and aux states (each
        tree given, None stays None) as logical host tensors on every
        rank: the ZeRO rows are gathered over each stage's dp group, then
        each virtual stage's owner (its slice's rank of dp row 0)
        broadcasts one flat buffer a dtype (``dist.broadcast_``, kind
        ``broadcast``).  A collective: every rank calls it."""
        self._require_plan("gather_host")
        meta = self._meta
        trees = self._logical_mine((params, opt_state, aux))
        out = [None if t is None else {} for t in trees]
        world = _dist.num_workers()
        for k in range(self._V):
            st = self._stages[k]
            owner = self._owner(k)
            mine = world == 1 or _dist.rank() == owner
            leaves = []         # (tree, name, tuple index or None)
            if params is not None:
                leaves += [(0, n, None) for n in st.params]
            if opt_state is not None:
                leaves += [(1, n, j) for n in st.params
                           for j in range(self._opt_len(n))]
                for n in st.params:
                    out[1][n] = ()
            if aux is not None:
                leaves += [(2, n, None) for n in st.aux]
            by_dt = {}
            for leaf in leaves:
                by_dt.setdefault(meta[leaf[1]][1], []).append(leaf)
            for dt, group in by_dt.items():
                sizes = [_meta_nbytes(meta[n][0], dt)
                         // torch.empty((), dtype=dt).element_size()
                         for _, n, _ in group]
                if mine:
                    buf = torch.cat([
                        (trees[i][n] if j is None else trees[i][n][j])
                        .detach().reshape(-1).to("cpu", dt)
                        for i, n, j in group])
                else:
                    buf = torch.empty(sum(sizes), dtype=dt)
                if world > 1:
                    _dist.broadcast_(buf, owner)
                off = 0
                for (i, n, j), c in zip(group, sizes):
                    v = buf[off:off + c].view(meta[n][0]).clone()
                    off += c
                    if j is None:
                        out[i][n] = v
                    else:
                        out[i][n] = out[i].get(n, ()) + (v,)
        return tuple(out)

    def gather_params(self, params):
        """Every stage's parameters as host tensors on every rank (a
        collective; see ``gather_host``)."""
        return self.gather_host(params=params)[0]

    def unflatten_host(self, name, arr):
        """A host flat (dp, chunk) array -> the logical array."""
        return self.plan.unflatten_host(name, arr)

    def export_host(self, params, opt_state, aux):
        """The live state as logical host tensors on every rank (parity:
        PipelineTrainStep.export_host, the stage partition merged away):
        ``(manifest, params, opt_state, aux)``, the manifest holding the
        step, the topology and the stage map."""
        p, s, a = self.gather_host(params, opt_state, aux)
        topo = self.checkpoint_topology()
        man = {"step": int(self.num_update),
               "topology": {"pp": self._pp, "dp": self._dp,
                            "zero": self.zero, "microbatches": self._micro},
               "stage_of": {n: int(v) for n, v in topo["stage_of"].items()}}
        return man, p, s, a

    # ------------------------------------------------------------ metadata
    def _chunk(self, name):
        """Row width of ``name``'s flat view over the stage's dp group."""
        return chunk_rows(_numel(self._meta[name][0]), self._dp)

    def _layout(self, k):
        """``[(name, chunk)]`` of stage ``k``'s gradient bucket over its dp
        group (``PlacementPlan.bucket_layout`` over the stage's names)."""
        return [(n, self._chunk(n)) for n in self._stages[k].params]

    def _slice_bytes(self):
        """Each slice's per-device {param, grad, opt} bytes of the
        placement plan, from shape metadata (``PlacementPlan.
        per_device_bytes`` over the stages' global layouts)."""
        meta = self._meta
        out = []
        for d in range(self._pp):
            acc = {"param": 0, "grad": 0, "opt": 0}
            for k in range(d, self._V, self._pp):
                names = self._stages[k].params
                ps = {n: _Meta((self._dp, self._chunk(n)), meta[n][1])
                      if self.plan.shard_params else _Meta(*meta[n])
                      for n in names}
                st = {n: tuple(_Meta((self._dp, self._chunk(n)), meta[n][1])
                               if self.plan.shard_state else _Meta(*meta[n])
                               for _ in range(self._opt_len(n)))
                      for n in names}
                zb = self.plan.per_device_bytes(ps, st)
                for key in acc:
                    acc[key] += zb[key]
            out.append(acc)
        return out

    def zero_bytes(self, params=None, opt_state=None, by_slice=False):
        """Per-device {param, grad, opt} bytes of the placement plan from
        shape metadata, the worst slice's of each (parity:
        PipelineTrainStep.zero_bytes; ``by_slice`` gives each slice's; the
        ``zero_param_bytes`` / ``zero_grad_bytes`` gauges).  Every stage's
        shapes are known on every rank, so the trees are not read; without
        ``opt_state`` the optimizer bytes are 0."""
        self._require_plan("zero_bytes")
        per = self._slice_bytes()
        if opt_state is None:
            for zb in per:
                zb["opt"] = 0
        if by_slice:
            return per
        return {k: max(zb[k] for zb in per) for k in ("param", "grad",
                                                      "opt")}

    def _carry_meta(self, shapes):
        """{virtual stage: ([carry_in (shape, dtype)], [carry_out ...])}
        and the outputs' (shape, dtype) list, from shape inference at the
        input shapes ``shapes`` (a microbatch of one rank); cached.  The
        carries cross in the compute dtype, the outputs in float32 under a
        policy."""
        key = tuple(sorted(shapes.items()))
        got = self._carry_cache.get(key)
        if got is not None:
            return got
        from .symbol import _run_shape_inference
        _, vshapes = _run_shape_inference(self.symbol, dict(shapes))
        dt = self._dtype or self._value_dtype()
        per = {}
        for st in self._stages:
            per[st.index] = ([(tuple(vshapes[k]), dt) for k in st.carry_in],
                             [(tuple(vshapes[k]), dt)
                              for k in st.carry_out])
        odt = torch.float32 if self._has_scale else dt
        outs = [(tuple(vshapes[k]), odt) for k in self._low.out_keys]
        self._carry_cache[key] = (per, outs)
        return per, outs

    def _value_dtype(self):
        """The masters' dtype (float32 or float64): the activations' when
        nothing is cast."""
        meta = self._meta or {}
        for n in self.param_names:
            if n in meta:
                return meta[n][1]
        return torch.float32

    def _live_bytes(self, per, in_nb):
        """Each slice's parameters, optimizer state and aux states (the
        ZeRO rows at 1/dp: their padded row) plus the peak stash of its
        planned order, from shape metadata; carries and inputs at the
        global microbatch (``per`` and ``in_nb`` are one rank's
        microbatch: times dp)."""
        meta = self._meta
        plan = self._get_plan()
        out = []
        for d in range(self._pp):
            static = 0
            for k in range(d, self._V, self._pp):
                st = self._stages[k]
                for n in st.params:
                    isz = _meta_nbytes((), meta[n][1])
                    whole = _meta_nbytes(*meta[n])
                    row = self._chunk(n) * isz
                    static += row if self.plan.shard_params else whole
                    static += (row if self.plan.shard_state else whole) \
                        * self._opt_len(n)
                static += sum(_meta_nbytes(*meta[n]) for n in st.aux)
            cur = peak = 0
            for kind, m, k in plan["slices"][d]:
                st = self._stages[k]
                nb = self._dp * (sum(_meta_nbytes(*c) for c in per[k][0])
                                 + sum(in_nb[n] for n in st.inputs))
                cur += nb if kind == "fwd" else -nb
                peak = max(peak, cur)
            out.append(static + peak)
        return out

    # ------------------------------------------------------------------ step
    def _stage_params(self, k, params):
        """Stage ``k``'s parameters for one work item: the resident tensors,
        or at ZeRO level 3 the logical ones gathered just in time from the
        stage's rows (one all-gather, the ``zero.gather`` span), which the
        caller drops when the item ends."""
        names = self._stages[k].params
        if not self.plan.shard_params or not names:
            return {n: params[n] for n in names}

        def gather():
            row = torch.cat([params[n].reshape(-1) for n in names])
            full = _dist.all_gather_rows(row, self._group, self._dp) \
                if self._dp > 1 else row.unsqueeze(0)
            out, off = {}, 0
            for n in names:
                c = params[n].numel()
                out[n] = self.plan.from_flat(full[:, off:off + c],
                                             self.plan.shape_of(n))
                off += c
            return out
        if not _tel._enabled:
            return gather()
        with _tel.span("zero.gather", cat="distributed", level=self.zero,
                       stage=k, tensors=len(names)):
            out = gather()
            _engine.settle(list(out.values()))
        return out

    def _agree(self, finite):
        """The overflow verdict of every rank of the mesh, which is one
        rank or the whole world (``__init__``): one sum of the ranks'
        flags over the world."""
        if int(self.mesh.mesh.numel()) == 1:
            return finite
        return _dist.all_finite(finite, None)

    def __call__(self, params, opt_state, aux, batch, rng=None):
        """One pipelined, microbatched step of the global ``batch`` under
        the planned schedule.  ``params`` / ``opt_state`` / ``aux`` hold
        this rank's stages' tensors and are updated in place.  Returns
        them with the outputs: the loss heads over the whole global batch
        (microbatches in order), on every rank."""
        import time as _time
        if self._stages is None:
            raise MXNetError(
                "PipelineTrainStep: call init() (or place_params/"
                "place_state/place_aux) before stepping")
        M, P, V = self._micro, self._pp, self._V
        batch = self.shard_batch(batch)
        for n in self.data_names + self.label_names:
            if n not in batch:
                raise MXNetError("pipeline step: missing input %s" % n)
        b0 = batch[self.data_names[0]].shape[0]
        if b0 % M:
            raise MXNetError(
                "pipeline step: global batch %d is not divisible by "
                "num_microbatches=%d" % (b0, M))
        mb = b0 // M
        if mb % self._dp:
            raise MXNetError(
                "pipeline step: microbatch %d (batch %d / M=%d) is not "
                "divisible by dp=%d" % (mb, b0, M, self._dp))
        rb = mb // self._dp
        plan = self._get_plan()
        dev = self.ctx.torch_device()
        shapes = {n: (rb,) + tuple(v.shape[1:]) for n, v in batch.items()}
        per, out_meta = self._carry_meta(shapes)
        hyper = self.fopt.hyper(self.num_update)
        self.num_update += 1
        t = self.num_update
        telem = _tel._enabled
        busy = [0.0]
        wall0 = _time.time()
        t_start = _time.perf_counter()
        ranks = self._row_ranks
        dt = self._dtype

        def rows(n, m):
            lo = m * mb + self._row * rb
            return batch[n][lo:lo + rb].to(dev)
        lsc = self._scale_state_dev() if self._has_scale else None
        # the head-gradient scale of the loss-bearing stage: the 'batch'
        # heads' 1/M fold and the loss scale in one product
        head = torch.tensor(_np.float32(1.0 / M), device=dev) \
            if self._micro_comp else None
        if lsc is not None:
            head = lsc["scale"] if head is None else lsc["scale"] * head
        mine = plan["slices"][self._slice]
        aux_w = {n: aux[n] for n in aux}
        if self._bucket:
            # this rank's row of each stage's flat (dp, C) bucket
            acc = {k: torch.zeros(sum(c for _, c in self._layout(k)),
                                  dtype=self._value_dtype(), device=dev)
                   for k in self._mine if self._stages[k].params}
        else:
            acc = {n: torch.zeros_like(params[n]) for n in params}
        pending = {}        # stage -> the asynchronous all-gather of its row
        recvs = {}          # item -> [handles]
        posted = [0]
        sends = []
        stash = {}
        outs_m = [None] * M

        def post_until(i):
            while posted[0] < len(mine) and posted[0] <= i + self.RECV_AHEAD:
                kind, m, k = it = mine[posted[0]]
                posted[0] += 1
                if kind == "fwd" and k > 0:
                    src, metas, back = ranks[(k - 1) % P], per[k][0], False
                elif kind == "bwd" and k < V - 1:
                    src, metas, back = ranks[(k + 1) % P], per[k][1], True
                else:
                    continue
                recvs[it] = [_dist.recv_(
                    torch.empty(sh, dtype=dt_, device=dev), src,
                    _pp_tag(m, k, V, back, j))
                    for j, (sh, dt_) in enumerate(metas)]

        def walk(k, vals, aux_k, carry, scale):
            with global_batch_stats(self._sync):
                return self._low._run(
                    vals, aux_k, True, self._inputs, self.ctx, scale, None,
                    frozenset(), False, self._stages[k], carry)

        def inputs(ex, sp):
            # the compute dtype's copies of the data inputs and parameters
            vals = dict(ex)
            if dt is not None:
                vals = _cast_inputs(vals, dt, self.label_names)
                sp = {n: v.to(dt) for n, v in sp.items()}
            vals.update(sp)
            return vals

        def send(ts, dst, tags, metas):
            return [_dist.send_(x.to(mt_), dst, tag)
                    for x, tag, (_, mt_) in zip(ts, tags, metas)]

        with _profiler.Scope("pipeline_step[%d]" % self.num_update,
                             "symbolic"):
            for i, it in enumerate(mine):
                kind, m, k = it
                st = self._stages[k]
                post_until(i)
                t0 = _time.perf_counter()
                if kind == "fwd":
                    cin = [h.wait() for h in recvs.pop(it, ())]
                    ex = {n: rows(n, m) for n in st.inputs}
                    vals = inputs(ex, self._stage_params(k, params))
                    gen = _random.generator(dev)
                    start = gen.get_state()
                    with torch.no_grad():
                        outs, aux_upd, cout = walk(
                            k, vals, {n: aux_w[n] for n in st.aux}, cin,
                            None)
                    del vals
                    for n, v in aux_upd.items():
                        if n in aux_w:
                            aux_w[n] = v.to(aux_w[n].dtype)
                    stash[(m, k)] = (cin, ex, start)
                    if k == V - 1:
                        outs_m[m] = [o.detach().to(odt) for o, (_, odt)
                                     in zip(outs, out_meta)]
                    else:
                        sends += send(cout, ranks[(k + 1) % P],
                                      [_pp_tag(m, k + 1, V, False, j)
                                       for j in range(len(cout))],
                                      per[k][1])
                else:
                    cin, ex, start = stash.pop((m, k))
                    gout = [h.wait() for h in recvs.pop(it, ())]
                    leaves = {n: v.detach().requires_grad_(True) for n, v
                              in self._stage_params(k, params).items()}
                    cin_l = [c.detach().requires_grad_(True)
                             if c.is_floating_point() else c for c in cin]
                    vals = inputs(ex, leaves)
                    scale = head if self._stage_has_loss[k] else None
                    gen = _random.generator(dev)
                    with torch.enable_grad(), \
                            _random.replaying(gen, start):
                        outs, _, cout = walk(
                            k, vals, {n: aux_w[n] for n in st.aux},
                            cin_l, scale)
                    del vals
                    targets = list(cout) + list(outs)
                    seeds = list(gout) + [
                        torch.ones((), dtype=o.dtype, device=o.device)
                        .expand(o.shape) for o in outs]
                    wrt = [leaves[n] for n in st.params] + \
                        [c for c in cin_l if c.requires_grad]
                    grads = head_grads(targets, seeds, wrt)
                    with torch.no_grad():
                        self._accumulate(k, acc, leaves, grads)
                    del outs, cout, targets, leaves
                    if k > 0:
                        gc = list(grads[len(st.params):])
                        full, it_g = [], iter(gc)
                        for c in cin_l:
                            g = next(it_g) if c.requires_grad else None
                            full.append(torch.zeros_like(c) if g is None
                                        else g.detach())
                        sends += send(full, ranks[(k - 1) % P],
                                      [_pp_tag(m, k - 1, V, True, j)
                                       for j in range(len(full))],
                                      per[k][0])
                    del grads
                    if self._overlap and not self.zero and k in acc \
                            and plan["last_bwd"][k] == i:
                        # the stage's backward wave is done: its one
                        # all-gather runs under the remaining items
                        pending[k] = _dist.all_gather_rows(
                            acc[k], self._group, self._dp, async_op=True)
                if telem:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    busy[0] += _time.perf_counter() - t0
                sends = [h for h in sends if not h.is_completed()]
            for h in sends:
                h.wait()
            self._update(params, opt_state, aux, aux_w, acc, pending, hyper,
                         t, lsc)
            outs = self._hand_off(outs_m, out_meta, M, dev)
            _engine.settle(list(outs))
        in_nb = {n: _meta_nbytes(shapes[n], batch[n].dtype)
                 for n in batch}
        self.last_live_bytes = self._live_bytes(per, in_nb)
        if telem:
            frac = plan["bubble"]
            _tel.record_span("pp.stage", wall0, busy[0], cat="pipeline",
                             stage=self._slice, microbatches=M,
                             schedule=self._schedule)
            wall = _time.perf_counter() - t_start
            _tel.record_span("pp.bubble", wall0, wall * frac,
                             cat="pipeline", pp=P, microbatches=M,
                             schedule=self._schedule, interleave=self._v)
            _tel.gauge("pp_bubble_fraction", frac)
            for d in range(P):
                _tel.gauge("pp_stage%d_live_bytes" % d,
                           self.last_live_bytes[d], stage=d)
            if self._has_scale and self._amp_emit \
                    and _tel.scalar_due(self.num_update):
                # a telemetry read of two scalars
                scale, overflow = self.amp_stats()
                _tel.gauge("loss_scale", scale)
                if overflow:
                    _tel.counter("amp_overflow_steps", overflow)
            if self.zero:
                if self._zb_cache is None:
                    self._zb_cache = self.zero_bytes(params, opt_state)
                _tel.gauge("zero_param_bytes", self._zb_cache["param"],
                           level=self.zero)
                _tel.gauge("zero_grad_bytes", self._zb_cache["grad"],
                           level=self.zero)
        return params, opt_state, aux, outs

    def _accumulate(self, k, acc, leaves, grads):
        """One microbatch's gradients of stage ``k`` into the accumulator:
        whole tensors, or folded into the stage's flat (dp, C) bucket and
        reduce-scattered over its dp group into this rank's row."""
        st = self._stages[k]
        if not self._bucket:
            for n, g in zip(st.params, grads):
                if g is not None:
                    acc[n] += g.to(acc[n].dtype)
            return
        if not st.params:
            return
        row = acc[k]
        bucket = torch.cat([flat_shards(
            torch.zeros_like(leaves[n], dtype=row.dtype) if g is None
            else g.to(row.dtype), self._dp)
            for n, g in zip(st.params, grads)], dim=1)
        row += _dist.reduce_scatter_rows(bucket, self._group) \
            if self._dp > 1 else bucket[0]

    def _update(self, params, opt_state, aux, aux_w, acc, pending, hyper, t,
                lsc):
        """Each of this rank's stages: its gradients reduced over the
        stage's dp group (gpipe levels 0-1: one all-reduce a dtype; the
        bucket's rows are reduced already), the overflow verdict and the
        loss-scale state under a policy, then the rule into the caller's
        tensors (``_apply_rule``: the rows at ZeRO levels >= 1, the stage's
        gathered row at level 0 under the overlap) and the moving
        statistics the forwards chained (their pre-step values on
        overflow)."""
        with torch.no_grad(), torch.profiler.record_function(
                "PipelineTrainStep.update"):
            if not self._bucket and self._dp > 1:
                for k in self._mine:
                    st = self._stages[k]
                    by_dtype = {}
                    for n in st.params:
                        by_dtype.setdefault(acc[n].dtype, []).append(n)
                    for names in by_dtype.values():
                        flat = _dist.all_reduce_(torch.cat(
                            [acc[n].reshape(-1) for n in names]),
                            self._group)
                        off = 0
                        for n in names:
                            c = acc[n].numel()
                            acc[n] = flat[off:off + c].view(acc[n].shape)
                            off += c
            finite = inv = None
            if lsc is not None:
                # judged on the scaled, reduced gradients (this rank's rows
                # in the bucket), agreed by every rank of the mesh
                flags = [torch.isfinite(g).all() for g in acc.values()]
                finite = torch.stack(flags).all() if flags else torch.ones(
                    (), dtype=torch.bool, device=self.ctx.torch_device())
                finite = self._agree(finite)
                inv = 1.0 / lsc["scale"]
            for k in self._mine:
                names = self._stages[k].params
                if not names:
                    continue
                if self._bucket:
                    if k in pending:
                        full = pending.pop(k).wait()
                        grads, off = {}, 0
                        for n, c in self._layout(k):
                            grads[n] = from_flat(full[:, off:off + c],
                                                 self._meta[n][0])
                            off += c
                    else:
                        grads = {"": acc[k]}
                else:
                    grads = {n: acc[n] for n in names}
                if inv is not None:
                    grads = {n: g * inv.to(g.dtype) for n, g in grads.items()}
                _apply_rule(self.fopt, self.plan, names, params, opt_state,
                            grads, hyper, t, finite, self._group, self._dp)
            for n, v in aux_w.items():
                if v is not aux[n]:
                    _write(aux[n], v, finite)
            if lsc is not None:
                self._scale_state = self.policy.next_state(lsc, finite)

    def _hand_off(self, outs_m, out_meta, M, dev):
        """The whole global batch's outputs on every rank: the final
        stage's dp ranks gather their rows of each microbatch, then send
        the result to the other slices of their dp row."""
        P = self._pp
        ranks = self._row_ranks
        gb = [(sh[0] * self._dp * M,) + tuple(sh[1:]) for sh, _ in out_meta]
        if self._slice == P - 1:
            outs = []
            for i in range(len(out_meta)):
                parts = [om[i] for om in outs_m]
                if self._dp > 1:
                    parts = [_dist.all_gather_batch(x.contiguous(),
                                                    self._group, self._dp)
                             for x in parts]
                outs.append(torch.cat(parts) if M > 1 else parts[0])
            hs = [_dist.send_(o, ranks[d], _OUT_TAG + i,
                              kind="send_outputs")
                  for d in range(P - 1) for i, o in enumerate(outs)]
            for h in hs:
                h.wait()
            return tuple(outs)
        hs = [_dist.recv_(torch.empty(sh, dtype=dt, device=dev),
                          ranks[P - 1], _OUT_TAG + i, kind="recv_outputs")
              for i, (sh, (_, dt)) in enumerate(zip(gb, out_meta))]
        return tuple(h.wait() for h in hs)
