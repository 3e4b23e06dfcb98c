"""Executor — runs a Symbol graph forward, and backward, on tensors
(counterpart: mxnet_tpu/executor.py, ``_Lowered.run`` and ``Executor``).

PyTorch runs eagerly, so the graph is walked op by op on every forward; the
walk keeps the JAX package's four passes:

- the NHWC layout pass (``MXNET_CONV_LAYOUT``, default NHWC): activations
  flow channel-last between layout-aware ops (Convolution, Pooling,
  BatchNorm) and through transparent ones; rigid ops see logical NCHW;
- the BatchNorm+ReLU peephole (one fused op);
- the NormConv peephole (``MXNET_NORM_CONV=1``, default off as in the JAX
  package): a BatchNorm[->ReLU] whose consumers are 1x1/3x3 convolutions
  becomes the prologue of those convolutions, run by ``ops.norm_conv`` —
  the Hopper kernel on the card.  In training the convolutions run through
  the ``NormConv`` autograd Function, and a BatchNorm whose input a fused
  convolution produced takes its batch statistics from that convolution's
  epilogue;
- the stem peephole (``MXNET_STEM_FUSE``, default on as in the JAX
  package): in training, a fix_gamma BatchNorm on a gradient-free graph
  input whose one consumer is a convolution (ResNet's bn_data -> conv0)
  runs as ``ops.nn.input_bn_conv`` (``MXNET_STEM_S2D=1``: the stride-2
  stem by space-to-depth), unless NormConv has taken either node.

The gradient pass is autograd over the walk, where the JAX package takes
``jax.vjp`` of it: ``forward(is_train=True)`` runs the walk with gradients
enabled on the arguments bound with a grad_req other than 'null', and
``backward`` runs ``torch.autograd.grad`` from the outputs and writes or adds
into the bound gradient arrays.  In training, BatchNorm normalises with the
batch statistics and its updated moving statistics land in ``aux_dict``.

``Executor.simple_bind`` (and ``Symbol.simple_bind``) allocates the argument,
gradient and aux arrays from inferred shapes; ``copy_params_from`` loads
parameters into them and ``reshape`` rebinds to new input shapes, sharing
every array whose shape is unchanged.

Model parallelism (``group2ctx``, parity: the JAX package's ``_walk``): an
op whose ``ctx_group`` the map names runs on that group's device, any other
op on the device of its first input (one with no input on the bind
context's).  The placement is resolved once at bind (``_Lowered.placement``);
where it spans two torch devices the walk moves each input that sits on
another device with one ``to_device`` a value and device, and autograd
carries the backward across it.  ``cross_device_copies`` counts every copy
that moves a tensor between two torch devices, in the walk, its backward,
the head gradients and the write-back into bound arrays; ``cpu(0)`` and
``cpu(1)`` are one torch device, so a plan over them copies nothing.  A
peephole fires only where every node it fuses sits on one device.  A graph
that resolves to one device walks as it does without ``group2ctx``.
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from .base import MXNetError, get_env, string_types
from .context import Context
from . import engine as _engine
from . import ndarray as nd
from . import profiler as _profiler
from . import random as _random
from . import telemetry as _tel
from .ops.nn import (_bn_moving, bn_scale_shift, input_bn_conv,
                     stats_sync)
from .ops.norm_conv import (NormConv, PEEPHOLE_DTYPES, _apply, geometry_ok,
                             norm_conv)
from .ops.registry import get_op
from .parallel.dist import sum_across
from .symbol import _topo

__all__ = ["Executor"]

# copies that moved a tensor between two torch devices (see to_device)
cross_device_copies = 0


class _DeviceCopy(torch.autograd.Function):
    """``x.to(device)`` whose forward and backward copies are each counted
    in ``cross_device_copies`` (parity: the reference's _CrossDeviceCopy
    node and its gradient)."""

    @staticmethod
    def forward(ctx, x, device):
        global cross_device_copies
        ctx.src = x.device
        cross_device_copies += 1
        return x.to(device)

    @staticmethod
    def backward(ctx, g):
        global cross_device_copies
        cross_device_copies += 1
        return g.to(ctx.src), None


def to_device(v, device):
    """``v`` on ``device``: ``v`` itself when it is there, else one counted
    copy (through autograd when ``v`` needs a gradient)."""
    global cross_device_copies
    if v.device == device:
        return v
    if v.requires_grad and torch.is_grad_enabled():
        return _DeviceCopy.apply(v, device)
    cross_device_copies += 1
    return v.to(device)


def _group(node):
    return node.attr.get("ctx_group") or node.attr.get("__ctx_group__")


def _hwio(w):
    """The (k, k, Cin, Cout) copy of an (O, I, k, k) weight that the NormConv
    kernel reads in inference.  It is made once and kept on the weight
    tensor itself, so forwards reuse it and every binding that shares the
    weight (the rungs of a ServedModel) shares one copy; a rebound weight
    is a new tensor, and an in-place write bumps its version, so neither
    reads a stale copy.  Training never reads it: the ``NormConv``
    Function makes its own copy under autograd."""
    cached = getattr(w, "_nc_hwio", None)
    if cached is None or cached[0] != w._version:
        cached = (w._version, w.permute(2, 3, 1, 0).contiguous())
        w._nc_hwio = cached
    return cached[1]


def _to_cl(v):
    # channel-last in memory too, so the NormConv kernel and cuDNN's
    # channels_last convolutions read it without another copy
    return torch.movedim(v, 1, -1).contiguous()


def _to_cf(v):
    return torch.movedim(v, -1, 1)


def _is_arr(v):
    return isinstance(v, torch.Tensor) and v.dim() >= 3


def head_grads(outs, seeds, leaves, **kwargs):
    """``torch.autograd.grad`` of the outputs seeded with ``seeds`` into
    ``leaves``, skipping the outputs that no leaf reaches (a MakeLoss of
    MultiBoxTarget's targets, say): they contribute nothing, as in the JAX
    package's vjp.  A leaf no output reaches gets None."""
    pairs = [(o, g) for o, g in zip(outs, seeds) if o.requires_grad]
    if not pairs:
        return [None] * len(leaves)
    return torch.autograd.grad([o for o, _ in pairs], leaves,
                               [g for _, g in pairs], allow_unused=True,
                               **kwargs)


class _ScaleBackward(torch.autograd.Function):
    """Identity forward, cotangent-times-scale backward (counterpart: the
    JAX package's ``_make_scale_backward``).

    The loss heads (ops/loss.py) emit their fixed gradient and ignore the
    cotangent that reaches them, so AMP's loss scale cannot ride the seeds
    of ``torch.autograd.grad``.  ``_Lowered.run(head_grad_scale=s)`` wraps
    each loss head's data input in this op instead: everything below the
    head sees its cotangents multiplied by ``s``, which is "scale the loss
    before backward".  ``s`` is a tensor and gets no gradient."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(s)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * s.to(g.dtype), None


class _Lowered(object):
    """The graph in walk order, with the peephole maps built once."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.order = _topo([n for n, _ in symbol._outputs])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.out_keys = [(id(n), i) for n, i in symbol._outputs]
        consumers = {}
        for n in self.order:
            if n.is_var:
                continue
            for c, i in n.inputs:
                consumers.setdefault((id(c), i), []).append(n)
        outs = set(self.out_keys)
        # peephole: BatchNorm whose single consumer is Activation(relu) runs
        # as the fused _BatchNormReLU op
        self.fused_relu = {}
        for n in self.order:
            if n.is_var or n.op.name != "BatchNorm":
                continue
            if n.op.normalize_attrs(n.params).get("output_mean_var"):
                continue
            if (id(n), 0) in outs:
                continue
            cons = consumers.get((id(n), 0), [])
            if len(cons) != 1 or cons[0].is_var:
                continue
            act = cons[0]
            if act.op.name == "Activation" and \
                    act.op.normalize_attrs(act.params).get("act_type") \
                    == "relu":
                self.fused_relu[id(n)] = act
        self._init_norm_conv(consumers, outs)
        self._init_stem(consumers, outs)

    def placement(self, group2ctx, var_ctx, default_ctx):
        """{node id: Context} of every node (parity: the JAX package's
        ``want_dev``, resolved once at bind): an op whose ``ctx_group`` is
        in ``group2ctx`` on that group's context, any other op on its first
        input's, an op with no input on ``default_ctx``; a variable on its
        bound array's context (``var_ctx``), else ``default_ctx``."""
        ctx_of = {}
        for node in self.order:
            if node.is_var:
                c = var_ctx.get(node.name, default_ctx)
            else:
                grp = _group(node)
                if grp is not None and grp in group2ctx:
                    c = group2ctx[grp]
                elif node.inputs:
                    c = ctx_of[id(node.inputs[0][0])]
                else:
                    c = default_ctx
            ctx_of[id(node)] = c
        return ctx_of

    def unfusable(self, dev):
        """The peepholes whose fused nodes would sit on two devices of
        ``dev`` ({node id: torch.device}), as ("relu" | "nc" | "stem",
        BatchNorm id): fusing them would move an op off its device."""
        def spans(nodes):
            return len({dev[id(n)] for n in nodes}) > 1
        by_id = {id(n): n for n in self.order}
        out = set()
        for b_id, act in self.fused_relu.items():
            if spans((by_id[b_id], act)):
                out.add(("relu", b_id))
        for b_id, info in self.nc_bn.items():
            region = [info["bn"]] + info["convs"]
            if info["act"] is not None:
                region.append(info["act"])
            if b_id in self.nc_stats_src:
                region.append(self.nc_stats_src[b_id])
            if spans(region):
                out.add(("nc", b_id))
        for b_id, info in self.stem_fuse.items():
            if spans((by_id[b_id], info["conv"])):
                out.add(("stem", b_id))
        return frozenset(out)

    def _init_stem(self, consumers, outs):
        """Stem map (parity: the JAX package's ``stem_fuse``): a training
        BatchNorm(fix_gamma) applied to a graph input and consumed by one
        ungrouped, undilated, bias-free 2-D Convolution fuses to
        ``input_bn_conv``, whose backward takes d(beta) without the data
        gradient of the conv.  It fires at run time only when the input is
        declared gradient-free."""
        self.stem_fuse = {}    # bn id -> {var, conv, eps, momentum, geometry}
        for b in self.order:
            if b.is_var or b.op.name != "BatchNorm":
                continue
            a = b.op.normalize_attrs(b.params)
            if (not a.get("fix_gamma", True) or a.get("output_mean_var")
                    or a.get("use_global_stats")
                    or a.get("layout") not in (None, "NCHW")):
                continue
            src, si = b.inputs[0]
            if not src.is_var or si != 0 or (id(b), 0) in outs:
                continue
            cons = consumers.get((id(b), 0), [])
            if len(cons) != 1 or cons[0].is_var:
                continue
            conv = cons[0]
            if conv.op.name != "Convolution" or conv.inputs[0] != (b, 0):
                continue
            ca = conv.op.normalize_attrs(conv.params)
            kernel = tuple(ca.get("kernel") or ())
            dilate = tuple(ca.get("dilate") or ()) or (1,) * len(kernel)
            if (len(kernel) != 2 or not ca.get("no_bias")
                    or int(ca.get("num_group") or 1) != 1
                    or any(d != 1 for d in dilate)
                    or ca.get("layout") not in (None, "NCHW")):
                continue
            self.stem_fuse[id(b)] = {
                "var": src.name, "conv": conv,
                "eps": float(a.get("eps", 1e-3)),
                "momentum": float(a.get("momentum", 0.9)),
                "kernel": kernel,
                "stride": tuple(ca.get("stride") or ()) or (1, 1),
                "pad": tuple(ca.get("pad") or ()) or (0, 0)}

    @staticmethod
    def _nc_conv_attrs(n):
        """Conv geometry if the node is NormConv-fusable, else None: the
        kernel's geometry rule (``norm_conv.geometry_ok``) on an ungrouped,
        undilated, bias-free 2-D convolution."""
        a = n.op.normalize_attrs(n.params)
        k = tuple(a.get("kernel") or ())
        s = tuple(a.get("stride") or ()) or (1, 1)
        p = tuple(a.get("pad") or ()) or (0, 0)
        d = tuple(a.get("dilate") or ()) or (1, 1)
        if not geometry_ok(k, s, p) or d != (1, 1):
            return None
        if int(a.get("num_group") or 1) != 1 or not a.get("no_bias"):
            return None
        if a.get("layout") not in (None, "NCHW"):
            return None
        return {"k": k[0], "s": s[0], "p": p[0]}

    def _init_norm_conv(self, consumers, outs):
        """NormConv fusion map: a BatchNorm[->relu] whose consumers are
        fusable Convolutions becomes the prologue of those convs.  A
        training BatchNorm whose data producer is such a conv reads its
        batch statistics from that conv's epilogue instead of reducing the
        activation again."""
        self.nc_bn = {}        # bn id -> {bn, act, convs, others, attrs}
        self.nc_conv = {}      # conv id -> bn id
        self.nc_stats_src = {}  # bn id -> producer conv node
        self.nc_stats_for = {}  # conv id -> [bn ids reading its statistics]
        for b in self.order:
            if b.is_var or b.op.name != "BatchNorm":
                continue
            attrs = b.op.normalize_attrs(b.params)
            if attrs.get("output_mean_var"):
                continue
            chain, act = b, None
            cons = consumers.get((id(b), 0), [])
            if len(cons) == 1 and not cons[0].is_var and \
                    cons[0].op.name == "Activation" and \
                    cons[0].op.normalize_attrs(cons[0].params).get(
                        "act_type") == "relu" and (id(b), 0) not in outs:
                chain, act = cons[0], cons[0]
                cons = consumers.get((id(chain), 0), [])
            convs, others = [], (id(chain), 0) in outs
            for c in cons:
                if (not c.is_var and c.op.name == "Convolution"
                        and c.inputs[0] == (chain, 0)
                        and self._nc_conv_attrs(c) is not None
                        and sum(1 for inp in c.inputs
                                if inp == (chain, 0)) == 1):
                    convs.append(c)
                else:
                    others = True
            if not convs:
                continue
            self.nc_bn[id(b)] = {"bn": b, "act": act, "convs": convs,
                                 "others": others, "attrs": attrs}
            for c in convs:
                self.nc_conv[id(c)] = id(b)
        for b_id, info in self.nc_bn.items():
            src, si = info["bn"].inputs[0]
            if si == 0 and not src.is_var and id(src) in self.nc_conv \
                    and not info["attrs"].get("use_global_stats"):
                self.nc_stats_src[b_id] = src
                self.nc_stats_for.setdefault(id(src), []).append(b_id)

    def _nc_run_bn(self, node, values, nhwc, aux_updates, nc_ctx, is_train,
                   skip, take):
        """Resolve a fused BatchNorm to per-channel (scale, shift): in
        training from the batch statistics (the producer conv's epilogue
        sums when it emitted them, one reduce otherwise), updating the
        moving statistics into ``aux_updates``; else from the moving
        statistics.  The apply pass only materialises for consumers that
        are not fused convolutions.  ``take(key)`` reads a value on the
        region's device."""
        info = self.nc_bn[id(node)]
        xk = (id(node.inputs[0][0]), node.inputs[0][1])
        x = take(xk)
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            return False
        if x.dtype not in PEEPHOLE_DTYPES:
            # float16: the kernel takes float32 and bfloat16 only, so the
            # BatchNorm and its convolutions run unfused
            return False
        attrs = info["attrs"]
        eps = float(attrs.get("eps", 1e-3))
        fix_gamma = attrs.get("fix_gamma", True)
        gamma, beta, mm, mv = (take((id(c), i))
                               for c, i in node.inputs[1:5])
        if is_train and not attrs.get("use_global_stats"):
            acc = torch.promote_types(x.dtype, torch.float32)
            src = self.nc_stats_src.get(id(node))
            dims = (0, 1, 2) if xk in nhwc else (0, 2, 3)
            if src is not None and (id(src), 1) in values:
                ssum = values[(id(src), 1)].to(acc)
                ssq = values[(id(src), 2)].to(acc)
            else:
                x32 = x.to(acc)
                ssum = x32.sum(dim=dims)
                ssq = x32.square().sum(dim=dims)
            nhw = x.numel() // ssum.numel()
            sync = stats_sync()
            if sync is not None:
                # the global batch's sums, summed again in the backward
                group, size = sync
                ssum, ssq = sum_across(torch.stack([ssum, ssq]), group)
                nhw *= size
            mean = ssum / nhw
            var = torch.maximum(ssq / nhw - mean.square(),
                                torch.zeros((), dtype=acc))
            momentum = float(attrs.get("momentum", 0.9))
            for pos, stat in ((3, mean), (4, var)):
                child = node.inputs[pos][0]
                if child.is_var:
                    aux_updates[child.name] = _bn_moving(
                        take((id(child), 0)), stat, momentum)
            inv = torch.rsqrt(var + eps)
            g = torch.ones_like(gamma) if fix_gamma else gamma
            scale = g.to(acc) * inv
            shift = beta.to(acc) - mean * scale
        else:
            scale, shift = bn_scale_shift(gamma, beta, mm, mv, eps,
                                          fix_gamma, x.dtype)
        relu = info["act"] is not None
        nc_ctx[id(node)] = (scale, shift, xk, relu)
        if info["others"]:
            x_cl = x if xk in nhwc else _to_cl(x)
            key = (id(info["act"]), 0) if relu else (id(node), 0)
            values[key] = _apply(x_cl, scale, shift, relu)
            nhwc.add(key)
        if relu:
            skip.add(id(info["act"]))
        return True

    def _nc_run_conv(self, node, values, nhwc, nc_ctx, is_train, take):
        """Run a Convolution as the fused NormConv: the BatchNorm(+relu)
        resolved by _nc_run_bn is its prologue.  In training it runs
        through the ``NormConv`` Function and emits the epilogue statistics
        when a BatchNorm below reads them (pseudo-slots 1 and 2 of the
        conv's values)."""
        scale, shift, xk, relu = nc_ctx[self.nc_conv[id(node)]]
        x = take(xk)
        x_cl = x.contiguous() if xk in nhwc else _to_cl(x)
        w = take((id(node.inputs[1][0]), node.inputs[1][1]))  # (O, I, k, k)
        g = self._nc_conv_attrs(node)
        if is_train:
            stats = bool(self.nc_stats_for.get(id(node)))
            out = NormConv.apply(x_cl, w, scale, shift, g["k"], g["s"],
                                 g["p"], relu, True, stats)
            if stats:
                out, values[(id(node), 1)], values[(id(node), 2)] = out
            values[(id(node), 0)] = out
        else:
            values[(id(node), 0)] = norm_conv(
                x_cl, _hwio(w), scale, shift, kernel=g["k"], stride=g["s"],
                pad=g["p"], relu=relu, prologue=True, stats=False)[0]
        nhwc.add((id(node), 0))

    def _stem_run(self, node, values, nhwc, aux_updates, skip, arg_vals,
                  s2d, take, device):
        """Run a fused input BatchNorm + conv pair (see ``_init_stem``):
        the conv's output channel-last, the BatchNorm's moving statistics
        into ``aux_updates``; each operand on ``device`` when the walk is
        placed."""
        info = self.stem_fuse[id(node)]
        xk = (id(node.inputs[0][0]), node.inputs[0][1])
        x = take(xk)
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            return False
        x_cl = x if xk in nhwc else _to_cl(x)
        conv = info["conv"]
        beta = take((id(node.inputs[2][0]), node.inputs[2][1]))
        # the conv's weight variable comes after the BatchNorm in walk
        # order, so it is not in values yet: read it from the arguments
        wvar = conv.inputs[1][0]
        w = values.get((id(wvar), conv.inputs[1][1]))
        if w is None:
            if not wvar.is_var or wvar.name not in arg_vals:
                return False
            w = arg_vals[wvar.name]
        if device is not None:
            w = to_device(w, device)
        out, mean, var = input_bn_conv(x_cl, beta, w, info["eps"],
                                       info["kernel"], info["stride"],
                                       info["pad"], s2d=s2d)
        for pos, stat in ((3, mean), (4, var)):
            child = node.inputs[pos][0]
            if child.is_var:
                aux_updates[child.name] = _bn_moving(
                    take((id(child), 0)), stat, info["momentum"])
        values[(id(conv), 0)] = out
        nhwc.add((id(conv), 0))
        skip.add(id(conv))
        return True

    def run(self, arg_vals, aux_vals, is_train=False, no_grad_inputs=(),
            device=None, head_grad_scale=None, place=None,
            unfusable=frozenset(), collect=False):
        """Walk the graph: {name: tensor} in, (outputs in logical layout,
        {aux name: updated value}) out.  Autograd records the walk only
        under ``is_train``; inputs named in ``no_grad_inputs`` (data and
        labels) enter it detached.  ``head_grad_scale`` (a scalar tensor,
        training only) multiplies the gradient every loss head sends down
        (``_ScaleBackward``): AMP's loss scale.

        ``device`` (a Context or ``torch.device``; by default the device of
        the first bound value) is where an op with no input runs, as in
        ``registry.imperative_invoke``: creation and sampling ops build
        their tensors there, and a sampling op draws from that device's
        generator (``random.generator``).

        ``place`` ({node id: torch.device}, from ``placement``) runs each op
        on its device, each input moved there by ``to_device`` once a walk
        (an input's layout tag comes with it); ``unfusable`` (from
        ``unfusable``) names the peepholes that stay off.

        ``collect`` (the Monitor) also returns {node output name: tensor}
        of every op output in walk order, in logical layout and detached,
        as a third value; the peepholes stay off so that every node's
        output exists (parity: the JAX package's ``collect``)."""
        with torch.set_grad_enabled(bool(is_train)):
            return self._run(arg_vals, aux_vals, bool(is_train),
                             frozenset(no_grad_inputs), device,
                             head_grad_scale if is_train else None, place,
                             unfusable, collect)

    @staticmethod
    def _device(device, arg_vals, aux_vals):
        if isinstance(device, Context):
            return device.torch_device()
        if device is not None:
            return torch.device(device)
        for v in list(arg_vals.values()) + list(aux_vals.values()):
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def _run(self, arg_vals, aux_vals, is_train, no_grad_inputs, device,
             head_grad_scale, place, unfusable, collect):
        use_nhwc = get_env("MXNET_CONV_LAYOUT", "NHWC") == "NHWC"
        nc_on = (use_nhwc and not collect and bool(self.nc_bn)
                 and get_env("MXNET_NORM_CONV", "0") == "1")
        stem_on = (use_nhwc and is_train and not collect
                   and bool(self.stem_fuse) and bool(no_grad_inputs)
                   and get_env("MXNET_STEM_FUSE", "1") == "1")
        collected = {}
        stem_s2d = get_env("MXNET_STEM_S2D", "0") == "1"
        nc_ctx = {}
        values = {}
        nhwc = set()      # value keys currently stored channel-last
        skip = set()
        aux_updates = {}
        dev = None        # resolved at the first op with no input
        moved = {}        # (value key, device) -> the value there

        def take_to(k, tgt):
            v = values[k]
            if tgt is None or not isinstance(v, torch.Tensor) \
                    or v.device == tgt:
                return v
            m = moved.get((k, tgt))
            if m is None:
                m = moved[(k, tgt)] = to_device(v, tgt)
            return m
        for node in self.order:
            if node.is_var:
                if node.name in arg_vals:
                    v = arg_vals[node.name]
                    if v.requires_grad and node.name in no_grad_inputs:
                        v = v.detach()
                    values[(id(node), 0)] = v
                elif node.name in aux_vals:
                    values[(id(node), 0)] = aux_vals[node.name]
                else:
                    raise MXNetError("unbound variable %s" % node.name)
                continue
            if id(node) in skip:
                continue
            tgt = place[id(node)] if place is not None else None
            take = values.__getitem__ if tgt is None \
                else functools.partial(take_to, tgt=tgt)
            stem = self.stem_fuse.get(id(node)) if stem_on else None
            if stem is not None and stem["var"] in no_grad_inputs \
                    and ("stem", id(node)) not in unfusable \
                    and not (nc_on and (id(node) in self.nc_bn
                                        or id(stem["conv"]) in self.nc_conv)):
                if self._stem_run(node, values, nhwc, aux_updates, skip,
                                  arg_vals, stem_s2d, take, tgt):
                    continue
            if nc_on and id(node) in self.nc_bn \
                    and ("nc", id(node)) not in unfusable:
                if self._nc_run_bn(node, values, nhwc, aux_updates, nc_ctx,
                                   is_train, skip, take):
                    continue
            if nc_on and id(node) in self.nc_conv \
                    and self.nc_conv[id(node)] in nc_ctx:
                self._nc_run_conv(node, values, nhwc, nc_ctx, is_train, take)
                continue
            fused_act = self.fused_relu.get(id(node))
            if collect or ("relu", id(node)) in unfusable:
                fused_act = None
            op = get_op("_BatchNormReLU") if fused_act is not None \
                else node.op
            in_keys = [(id(c), i) for c, i in node.inputs]
            ins = [take(k) for k in in_keys]
            params = node.params
            out_cl = False
            rule = op.layout_rule if use_nhwc else None
            if callable(rule):
                rule = rule(params)
            # never second-guess a user-specified channel-last layout
            if rule == "aware" and params.get("layout") not in (None, "NCHW"):
                rule = None
            if rule == "aware" and ins and _is_arr(ins[0]):
                li = set(op.layout_inputs)

                def lay(j, v):
                    if not _is_arr(v):
                        return v
                    tagged = in_keys[j] in nhwc
                    if j in li:          # activation input: channel-last
                        return v if tagged else _to_cl(v)
                    return _to_cf(v) if tagged else v
                ins = [lay(j, v) for j, v in enumerate(ins)]
                params = dict(params, layout="NHWC")
                out_cl = True
            elif rule == "transparent":
                tags = [in_keys[j] in nhwc for j, v in enumerate(ins)
                        if _is_arr(v)]
                if tags and all(tags):
                    out_cl = True        # flow through unchanged
                elif any(tags):          # mixed: restore logical layout
                    ins = [_to_cf(v) if in_keys[j] in nhwc else v
                           for j, v in enumerate(ins)]
            else:
                ins = [_to_cf(v) if in_keys[j] in nhwc else v
                       for j, v in enumerate(ins)]
            if head_grad_scale is not None and op.is_loss and ins:
                # the heads ignore their incoming cotangent: scale the
                # gradient they send down instead
                ins = [_ScaleBackward.apply(ins[0], head_grad_scale)] \
                    + ins[1:]
            call = op.make_callable(params, is_train)
            if not ins and dev is None:
                dev = self._device(device, arg_vals, aux_vals)
            at = ins[0].device if ins else (dev if tgt is None else tgt)
            args = ([_random.generator(at)] if op.needs_rng else []) + ins
            if ins:
                out = call(*args)
            else:
                with torch.device(at):
                    out = call(*args)
            if not isinstance(out, (tuple, list)):
                out = (out,)
            n_vis = op.num_outputs_for(node.params)
            for i in range(n_vis):
                values[(id(node), i)] = out[i]
                if out_cl and _is_arr(out[i]):
                    nhwc.add((id(node), i))
                if collect and isinstance(out[i], torch.Tensor):
                    nm = node.name + ("_output" if n_vis == 1
                                      else "_output%d" % i)
                    v = out[i]
                    collected[nm] = (_to_cf(v) if out_cl and _is_arr(v)
                                     else v).detach()
            if fused_act is not None:
                # the relu consumer's value IS the fused output
                values[(id(fused_act), 0)] = out[0]
                if out_cl and _is_arr(out[0]):
                    nhwc.add((id(fused_act), 0))
                skip.add(id(fused_act))
            if op.num_aux and is_train:
                names = op.arg_names_for(node.params)
                aux_pos = [i for i, nm in enumerate(names)
                           if nm in op.aux_names]
                for k, pos in enumerate(aux_pos):
                    child = node.inputs[pos][0]
                    if child.is_var:
                        aux_updates[child.name] = out[n_vis + k]
        outputs = [_to_cf(values[k]) if k in nhwc else values[k]
                   for k in self.out_keys]
        if collect:
            return outputs, aux_updates, collected
        return outputs, aux_updates


def _check_group2ctx(group2ctx):
    group2ctx = dict(group2ctx or {})
    bad = {g: c for g, c in group2ctx.items() if not isinstance(c, Context)}
    if bad:
        raise MXNetError("group2ctx maps a ctx_group to a Context, got %s"
                         % bad)
    return group2ctx


def _write(arr, t):
    """``arr._set_value(t)``, the copy counted in ``cross_device_copies``
    when it moves ``t`` to another torch device."""
    global cross_device_copies
    if t.device != arr.value.device:
        cross_device_copies += 1
    arr._set_value(t)


class Executor(object):
    """Bound computation (parity: mx.executor.Executor).

    grad_req : 'write', 'add' or 'null', as one string for every argument,
        a list in argument order or a dict by name (missing names: 'null').
        Gradients are computed for the arguments whose request is not
        'null' and that have an array in ``args_grad``.
    group2ctx : {ctx_group: Context}: each op of a named group runs on its
        context (see the module's docstring); each output array lives where
        its op runs, reported as the bind context when that is the same
        torch device.
    shared_exec : taken for the reference's signature; ``simple_bind``
        is where it shares arrays."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._group2ctx = _check_group2ctx(group2ctx)
        self._low = _Lowered(symbol)
        self.arg_names = self._low.arg_names
        self.aux_names = self._low.aux_names
        self.arg_dict = self._dictify(args, self.arg_names, "args")
        self.aux_dict = self._dictify(aux_states, self.aux_names,
                                      "aux_states", allow_none=True)
        if isinstance(grad_req, string_types):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = {n: grad_req.get(n, "null")
                             for n in self.arg_names}
        bad = {n: r for n, r in self.grad_req.items()
               if r not in ("null", "write", "add")}
        if bad:
            raise MXNetError("grad_req must be 'null', 'write' or 'add', "
                             "got %s" % bad)
        self.grad_dict = self._dictify(args_grad, self.arg_names,
                                       "args_grad", allow_none=True,
                                       partial=True)
        for n, req in self.grad_req.items():
            if req == "null":
                self.grad_dict.pop(n, None)
        shapes = {n: a.shape for n, a in self.arg_dict.items()}
        _, out_shapes, _ = symbol.infer_shape_partial(**shapes)
        types = {n: a.dtype for n, a in self.arg_dict.items()
                 if isinstance(a.dtype, _np.dtype)}
        _, out_types, _ = symbol.infer_type(**types)
        out_ctxs = self._plan()
        self._output_nds = [
            nd.zeros(s if s else (1,), ctx=c,
                     dtype=t if t is not None else _np.float32)
            for s, t, c in zip(out_shapes, out_types, out_ctxs)]
        # the last forward(is_train=True) with gradients: (outputs still in
        # the autograd graph, {name: leaf tensor})
        self._graph = None
        self._warned_default_heads = False
        self._monitor_cb = None

    def _plan(self):
        """Resolve where the walk runs: ``_place`` ({node id:
        torch.device}, or None when the graph sits on one device),
        ``_unfusable``, ``_run_device`` (where an op with no input runs
        when ``_place`` is None); returns each output's Context."""
        self._place, self._unfusable = None, frozenset()
        self._run_device = self._ctx
        bound = list(self.arg_dict.values()) + list(self.aux_dict.values())
        n_out = len(self._low.out_keys)
        if not self._group2ctx and \
                len({a.value.device for a in bound}) <= 1:
            return [self._ctx] * n_out
        ctx_of = self._low.placement(
            self._group2ctx, {n: a.context for n, a in
                              list(self.arg_dict.items())
                              + list(self.aux_dict.items())}, self._ctx)
        devs = {c: c.torch_device() for c in set(ctx_of.values())}
        place = {k: devs[c] for k, c in ctx_of.items()}
        if len(set(devs.values())) > 1:
            self._place = place
            self._unfusable = self._low.unfusable(place)
        elif devs:
            self._run_device = next(iter(ctx_of.values()))
        home = self._ctx.torch_device()
        outs = []
        for nid, _ in self._low.out_keys:
            c = ctx_of[nid]
            outs.append(self._ctx if devs[c] == home else c)
        return outs

    @staticmethod
    def _dictify(data, names, what, allow_none=False, partial=False):
        if data is None:
            if allow_none:
                return {}
            raise MXNetError("%s must be provided" % what)
        if isinstance(data, dict):
            out = {}
            for n in names:
                if n in data:
                    out[n] = data[n]
                elif not (allow_none or partial):
                    raise MXNetError("missing %s entry %s" % (what, n))
            return out
        data = list(data)
        if len(data) != len(names) and not partial:
            raise MXNetError("%s length %d != expected %d"
                             % (what, len(data), len(names)))
        return {n: a for n, a in zip(names, data) if a is not None}

    @staticmethod
    def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Allocate zeroed argument, gradient and aux arrays on ``ctx`` from
        the shapes inferred from ``kwargs`` (the input shapes) and bind
        (parity: Executor.simple_bind).  ``type_dict`` gives argument
        dtypes (default float32); the gradient of every argument whose
        request is not 'null' is allocated.  With ``shared_exec`` every
        argument, gradient and aux array of that executor whose name and
        shape match is taken as it is, not allocated: bucketed executors
        bind onto one set of parameters.  With ``group2ctx`` each argument
        and its gradient are allocated on the context of the variable's
        ``ctx_group`` (the bind context when the map does not name it) and
        the aux states on the bind context (parity: the JAX package's
        ``node_ctx``)."""
        group2ctx = _check_group2ctx(group2ctx)
        shared = ((shared_exec.arg_dict, shared_exec.grad_dict,
                   shared_exec.aux_dict) if shared_exec is not None
                  else ({}, {}, {}))
        ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        var_ctx = {}
        if group2ctx:
            for n in _topo([x for x, _ in symbol._outputs]):
                if n.is_var and _group(n) in group2ctx:
                    var_ctx[n.name] = group2ctx[_group(n)]

        def alloc(which, name, shape, dt):
            have = shared[which].get(name)
            if have is not None and tuple(have.shape) == tuple(shape):
                return have
            return nd.zeros(shape, ctx=var_ctx.get(name, ctx) if which < 2
                            else ctx, dtype=dt)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("simple_bind: could not infer all shapes from %s"
                             % kwargs)
        arg_types = dict(type_dict or {})
        arg_names = symbol.list_arguments()
        args, grads = {}, {}
        for i, (name, shape) in enumerate(zip(arg_names, arg_shapes)):
            dt = arg_types.get(name, _np.float32)
            args[name] = alloc(0, name, shape, dt)
            if isinstance(grad_req, string_types):
                req = grad_req
            elif isinstance(grad_req, (list, tuple)):
                req = grad_req[i]
            else:
                req = grad_req.get(name, "null")
            if req != "null":
                grads[name] = alloc(1, name, shape, dt)
        _, _, aux_types = symbol.infer_type(
            **{n: arg_types.get(n, _np.float32) for n in arg_names})
        auxs = {name: alloc(2, name, shape, at if at is not None
                            else _np.float32)
                for name, shape, at in zip(symbol.list_auxiliary_states(),
                                           aux_shapes, aux_types)}
        return Executor(symbol, ctx, args, grads, grad_req, auxs,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    @property
    def outputs(self):
        return self._output_nds

    @property
    def arg_arrays(self):
        """The argument arrays in ``list_arguments`` order."""
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        """The gradient arrays in ``list_arguments`` order (None where an
        argument has none)."""
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        """The aux-state arrays in ``list_auxiliary_states`` order."""
        return [self.aux_dict[n] for n in self.aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: NDArray or array-like}`` parameters and aux states
        into the bound arrays, each at the bound array's dtype and device
        (parity: Executor.copy_params_from).  A name the graph lacks raises
        unless ``allow_extra_params``."""
        for what, params, bound in (("arg", arg_params, self.arg_dict),
                                    ("aux", aux_params or {},
                                     self.aux_dict)):
            for name, arr in params.items():
                if name not in bound:
                    if allow_extra_params:
                        continue
                    raise MXNetError("unknown %s %s" % (what, name))
                dst = bound[name]
                if isinstance(arr, nd.NDArray):
                    src = arr.value
                else:
                    arr = _np.asarray(arr)
                    src = nd._host_tensor(arr, arr.dtype)
                dst._set_value(src.detach().to(dst.value.device,
                                               dst.value.dtype))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new Executor for the input shapes in ``kwargs`` (parity:
        Executor.reshape): every argument, gradient and aux array whose
        shape is unchanged is shared with this one (the parameters), the
        others are new zeroed arrays on the same device and dtype."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("reshape: cannot infer shapes")
        arg_shape = dict(zip(self.arg_names, arg_shapes))

        def keep(arr, shape):
            if tuple(arr.shape) == tuple(shape):
                return arr
            return nd.zeros(shape, ctx=arr.context, dtype=arr.dtype)
        args = {n: keep(a, arg_shape[n]) for n, a in self.arg_dict.items()}
        grads = {n: keep(a, arg_shape[n]) for n, a in self.grad_dict.items()}
        auxs = {n: keep(self.aux_dict[n], s)
                for n, s in zip(self.aux_names, aux_shapes)}
        return Executor(self._symbol, self._ctx, args, grads, self.grad_req,
                        auxs, group2ctx=self._group2ctx)

    def _grad_arg_names(self):
        return [n for n in self.arg_names
                if self.grad_req.get(n, "null") != "null"
                and n in self.grad_dict]

    def forward(self, is_train=False, **kwargs):
        """Run the graph forward (parity: Executor::Forward).  Keyword
        arguments replace bound inputs first.  With ``is_train`` and
        gradient arguments the walk is recorded for :meth:`backward`;
        otherwise it runs without autograd.  The region is the profiler
        range ``executor.forward[train|test]`` and, while telemetry
        records, the span ``executor.forward``."""
        mode = "train" if is_train else "test"
        with _profiler.Scope("executor.forward[%s]" % mode, "symbolic"):
            if not _tel._enabled:
                return self._forward_impl(is_train, **kwargs)
            # mirror=False: the profiler Scope above records this region
            with _tel.span("executor.forward", cat="executor",
                           mirror=False, mode=mode):
                return self._forward_impl(is_train, **kwargs)

    def _forward_impl(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward input %s" % k)
            arr = self.arg_dict[k]
            if isinstance(v, nd.NDArray) and v.shape != arr.shape:
                # rebound, as the reference rebinds it: the bound array
                # takes a copy of v on its own device (writing in place
                # cannot change its shape)
                arr._data = v.value.detach().to(arr.value.device,
                                                copy=True)
            else:
                arr[:] = v
        self._graph = None
        args = {n: a.value for n, a in self.arg_dict.items()}
        gnames = self._grad_arg_names() if is_train else []
        leaves = {n: args[n].detach().requires_grad_(True) for n in gnames}
        args.update(leaves)
        monitor = self._monitor_cb is not None
        res = self._low.run(
            args, {n: a.value for n, a in self.aux_dict.items()}, is_train,
            no_grad_inputs=[n for n in self.arg_names if n not in leaves],
            device=self._run_device, place=self._place,
            unfusable=self._unfusable, collect=monitor)
        outs, aux_upd = res[0], res[1]
        if leaves:
            self._graph = (outs, leaves)
        for ndarr, v in zip(self._output_nds, outs):
            _write(ndarr, v.detach())
        for name, v in aux_upd.items():
            if name in self.aux_dict:
                _write(self.aux_dict[name], v.detach())
        if monitor:
            # by name, as the JAX package's jitted walk returns them (a
            # pytree dict); in walk order on a placed walk, as its eager
            # multi-device walk streams them
            items = res[2].items()
            for name, v in (items if self._place is not None
                            else sorted(items)):
                self._monitor_cb(name, nd.NDArray(v))
        # NaiveEngine, a running profiler or telemetry: wait here, so a
        # fault surfaces at this forward and the span covers its device
        # time
        _engine.settle(self._output_nds)
        return self._output_nds

    def _check_default_heads(self):
        """Warn once when implicit all-ones head gradients reach outputs that
        are not loss heads (the reference requires explicit out_grads
        there)."""
        if self._warned_default_heads:
            return
        bad = [node.name for node, _ in self._symbol._outputs
               if node.is_var or not (node.op.is_loss
                                      or node.op.name == "BlockGrad")]
        if bad:
            import warnings
            warnings.warn(
                "backward() without out_grads on non-loss output(s) %s: "
                "gradients use implicit all-ones head gradients (the "
                "reference requires explicit out_grads here)" % bad,
                stacklevel=3)
        self._warned_default_heads = True

    def backward(self, out_grads=None):
        """Gradients of the last forward(is_train=True) into the bound
        gradient arrays, written or added per grad_req (parity:
        Executor::Backward).  Without ``out_grads`` every output is seeded
        with ones (the loss heads ignore it).  The recorded graph is kept,
        so backward may run again until the next forward.  The region is
        the profiler range ``executor.backward`` and, while telemetry
        records, the span of that name."""
        with _profiler.Scope("executor.backward", "symbolic"):
            if not _tel._enabled:
                return self._backward_impl(out_grads)
            with _tel.span("executor.backward", cat="executor",
                           mirror=False):
                return self._backward_impl(out_grads)

    def _backward_impl(self, out_grads=None):
        gnames = self._grad_arg_names()
        if not gnames:
            return
        if self._graph is None:
            raise MXNetError(
                "backward() requires a preceding forward(is_train=True)")
        outs, leaves = self._graph
        if out_grads is None:
            self._check_default_heads()
            ogs = [torch.ones((), dtype=o.dtype, device=o.device)
                   .expand(o.shape) for o in outs]
        else:
            # each head gradient on its output's device (parity: the JAX
            # package's _out_devices)
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            ogs = [to_device((g.value if isinstance(g, nd.NDArray) else g)
                             .detach(), o.device).to(o.dtype)
                   for g, o in zip(out_grads, outs)]
        grads = head_grads(outs, ogs, [leaves[n] for n in gnames],
                           retain_graph=True)
        for name, g in zip(gnames, grads):
            tgt = self.grad_dict[name]
            if g is None:        # the output does not depend on it
                g = torch.zeros_like(leaves[name])
            if self.grad_req[name] == "add":
                # accumulated on the gradient array's device
                tgt._set_value(tgt.value + to_device(g, tgt.value.device))
            else:
                _write(tgt, g)
        _engine.settle([self.grad_dict[n] for n in gnames])

    def set_monitor_callback(self, callback):
        """Install a per-op output monitor (parity:
        MXExecutorSetMonitorCallback): each forward then calls
        ``callback(name, NDArray)`` for every node output of its one walk
        (``<node>_output``, ``<node>_output<i>`` for several outputs) after
        the outputs are written: by name, or in walk order on a walk placed
        over several devices, as in the JAX package.  The walk runs with the
        peepholes off while a callback is installed, so that every node's
        output exists; ``None`` removes it."""
        self._monitor_cb = callback

    def debug_str(self):
        """The bound graph's ``Symbol.debug_str``."""
        return self._symbol.debug_str()
