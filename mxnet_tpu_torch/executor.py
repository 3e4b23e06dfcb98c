"""Executor — runs a Symbol graph forward, and backward, on tensors
(counterpart: mxnet_tpu/executor.py, ``_Lowered.run`` and ``Executor``).

PyTorch runs eagerly, so the graph is walked op by op on every forward; the
walk keeps the JAX package's three passes:

- the NHWC layout pass (``MXNET_CONV_LAYOUT``, default NHWC): activations
  flow channel-last between layout-aware ops (Convolution, Pooling,
  BatchNorm) and through transparent ones; rigid ops see logical NCHW;
- the BatchNorm+ReLU peephole (one fused op);
- the NormConv peephole (``MXNET_NORM_CONV=1``, default off as in the JAX
  package): a BatchNorm[->ReLU] whose consumers are 1x1/3x3 convolutions
  becomes the prologue of those convolutions, run by ``ops.norm_conv`` —
  the Hopper kernel on the card.  It has no backward yet, so under
  ``is_train`` it raises rather than drop the gradients of what lies below.

The gradient pass is autograd over the walk, where the JAX package takes
``jax.vjp`` of it: ``forward(is_train=True)`` runs the walk with gradients
enabled on the arguments bound with a grad_req other than 'null', and
``backward`` runs ``torch.autograd.grad`` from the outputs and writes or adds
into the bound gradient arrays.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError, get_env, string_types
from .context import Context
from . import ndarray as nd
from . import random as _random
from .ops.nn import bn_scale_shift
from .ops.norm_conv import _apply, geometry_ok, norm_conv
from .ops.registry import RESNET_TRAINING, get_op
from .symbol import _topo

__all__ = ["Executor"]


def _hwio(w):
    """The (k, k, Cin, Cout) copy of an (O, I, k, k) weight that the NormConv
    kernel reads.  It is made once and kept on the weight tensor itself, so
    forwards reuse it and every binding that shares the weight (the rungs of
    a ServedModel) shares one copy; a rebound weight is a new tensor, and an
    in-place write bumps its version, so neither reads a stale copy."""
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
        fusable Convolutions becomes the prologue of those convs.  (The
        epilogue-statistics map of the JAX package feeds training only and
        arrives with the training slice.)"""
        self.nc_bn = {}        # bn id -> {bn, act, convs, others, attrs}
        self.nc_conv = {}      # conv id -> bn id
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

    def _nc_run_bn(self, node, values, nhwc, nc_ctx, skip):
        """Resolve a fused BatchNorm to per-channel (scale, shift) from its
        moving statistics; the apply pass only materialises for consumers
        that are not fused convolutions."""
        info = self.nc_bn[id(node)]
        xk = (id(node.inputs[0][0]), node.inputs[0][1])
        x = values[xk]
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            return False
        attrs = info["attrs"]
        gamma, beta, mm, mv = (values[(id(c), i)]
                               for c, i in node.inputs[1:5])
        scale, shift = bn_scale_shift(gamma, beta, mm, mv,
                                      float(attrs.get("eps", 1e-3)),
                                      attrs.get("fix_gamma", True), x.dtype)
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

    def _nc_run_conv(self, node, values, nhwc, nc_ctx):
        """Run a Convolution as the fused NormConv: the BatchNorm(+relu)
        resolved by _nc_run_bn is its prologue."""
        scale, shift, xk, relu = nc_ctx[self.nc_conv[id(node)]]
        x = values[xk]
        x_cl = x.contiguous() if xk in nhwc else _to_cl(x)
        w = values[(id(node.inputs[1][0]), node.inputs[1][1])]  # (O, I, k, k)
        g = self._nc_conv_attrs(node)
        y, _, _ = norm_conv(x_cl, _hwio(w), scale,
                            shift, kernel=g["k"], stride=g["s"], pad=g["p"],
                            relu=relu, prologue=True, stats=False)
        values[(id(node), 0)] = y
        nhwc.add((id(node), 0))

    def run(self, arg_vals, aux_vals, is_train=False, no_grad_inputs=(),
            device=None):
        """Walk the graph: {name: tensor} in, (outputs in logical layout,
        {aux name: updated value}) out.  Autograd records the walk only
        under ``is_train``; inputs named in ``no_grad_inputs`` (data and
        labels) enter it detached.

        ``device`` (a Context or ``torch.device``; by default the device of
        the first bound value) is where an op with no input runs, as in
        ``registry.imperative_invoke``: creation and sampling ops build
        their tensors there, and a sampling op draws from that device's
        generator (``random.generator``)."""
        with torch.set_grad_enabled(bool(is_train)):
            return self._run(arg_vals, aux_vals, bool(is_train),
                             frozenset(no_grad_inputs), device)

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

    def _run(self, arg_vals, aux_vals, is_train, no_grad_inputs, device):
        use_nhwc = get_env("MXNET_CONV_LAYOUT", "NHWC") == "NHWC"
        nc_on = (use_nhwc and bool(self.nc_bn)
                 and get_env("MXNET_NORM_CONV", "0") == "1")
        if nc_on and is_train:
            raise MXNetError("MXNET_NORM_CONV=1: the NormConv peephole has "
                             "no backward yet and would drop the gradients "
                             "below it; training it arrives with %s (set "
                             "MXNET_NORM_CONV=0 to train unfused)"
                             % RESNET_TRAINING)
        nc_ctx = {}
        values = {}
        nhwc = set()      # value keys currently stored channel-last
        skip = set()
        aux_updates = {}
        dev = None        # resolved at the first op with no input
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
            if nc_on and id(node) in self.nc_bn:
                if self._nc_run_bn(node, values, nhwc, nc_ctx, skip):
                    continue
            if nc_on and id(node) in self.nc_conv \
                    and self.nc_conv[id(node)] in nc_ctx:
                self._nc_run_conv(node, values, nhwc, nc_ctx)
                continue
            fused_act = self.fused_relu.get(id(node))
            op = get_op("_BatchNormReLU") if fused_act is not None \
                else node.op
            in_keys = [(id(c), i) for c, i in node.inputs]
            ins = [values[k] for k in in_keys]
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

                def place(j, v):
                    if not _is_arr(v):
                        return v
                    tagged = in_keys[j] in nhwc
                    if j in li:          # activation input: channel-last
                        return v if tagged else _to_cl(v)
                    return _to_cf(v) if tagged else v
                ins = [place(j, v) for j, v in enumerate(ins)]
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
            call = op.make_callable(params, is_train)
            if not ins and dev is None:
                dev = self._device(device, arg_vals, aux_vals)
            at = ins[0].device if ins else dev
            args = ([_random.generator(at)] if op.needs_rng else []) + ins
            if ins:
                out = call(*args)
            else:
                with torch.device(dev):
                    out = call(*args)
            if not isinstance(out, (tuple, list)):
                out = (out,)
            n_vis = op.num_outputs_for(node.params)
            for i in range(n_vis):
                values[(id(node), i)] = out[i]
                if out_cl and _is_arr(out[i]):
                    nhwc.add((id(node), i))
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
        return outputs, aux_updates


class Executor(object):
    """Bound computation (parity: mx.executor.Executor).

    grad_req : 'write', 'add' or 'null', as one string for every argument,
        a list in argument order or a dict by name (missing names: 'null').
        Gradients are computed for the arguments whose request is not
        'null' and that have an array in ``args_grad``."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
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
        self._output_nds = [
            nd.zeros(s if s else (1,), ctx=self._ctx,
                     dtype=t if t is not None else _np.float32)
            for s, t in zip(out_shapes, out_types)]
        # the last forward(is_train=True) with gradients: (outputs still in
        # the autograd graph, {name: leaf tensor})
        self._graph = None
        self._warned_default_heads = False

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

    @property
    def outputs(self):
        return self._output_nds

    def _grad_arg_names(self):
        return [n for n in self.arg_names
                if self.grad_req.get(n, "null") != "null"
                and n in self.grad_dict]

    def forward(self, is_train=False, **kwargs):
        """Run the graph forward (parity: Executor::Forward).  Keyword
        arguments replace bound inputs first.  With ``is_train`` and
        gradient arguments the walk is recorded for :meth:`backward`;
        otherwise it runs without autograd."""
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
        outs, aux_upd = self._low.run(
            args, {n: a.value for n, a in self.aux_dict.items()}, is_train,
            no_grad_inputs=[n for n in self.arg_names if n not in leaves],
            device=self._ctx)
        if leaves:
            self._graph = (outs, leaves)
        for ndarr, v in zip(self._output_nds, outs):
            ndarr._set_value(v.detach())
        for name, v in aux_upd.items():
            if name in self.aux_dict:
                self.aux_dict[name]._set_value(v.detach())
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
        so backward may run again until the next forward."""
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
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            ogs = [(g.value if isinstance(g, nd.NDArray) else g)
                   .to(o.device, o.dtype) for g, o in zip(out_grads, outs)]
        grads = torch.autograd.grad(outs, [leaves[n] for n in gnames], ogs,
                                    retain_graph=True, allow_unused=True)
        for name, g in zip(gnames, grads):
            tgt = self.grad_dict[name]
            if g is None:        # the output does not depend on it
                g = torch.zeros_like(leaves[name])
            if self.grad_req[name] == "add":
                tgt._set_value(tgt.value + g)
            else:
                tgt._set_value(g)
