"""Fused multi-layer RNN operator (counterpart: mxnet_tpu/ops/rnn_op.py).

The JAX package runs each layer and direction as one ``lax.scan`` with the
input projection hoisted out of it as one matmul; XLA compiles the lot.  It
is not a Pallas kernel, so the port has two routes of its own, chosen by the
device of ``data``:

- the plain version (CPU tensors, and the tests' yardstick): the same
  hoisted projection, then the cell stepped T times in PyTorch ops
  (``_run_layer`` / ``_cell_step``), differentiated by autograd;
- the card route (CUDA tensors): one cuDNN RNN call per layer through
  torch's RNN functional (``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` /
  ``rnn_relu``, the calls behind ``nn.LSTM``), handed the layer's slices of
  the flat parameter vector.  One call per layer, not one for the stack, so
  that dropout between layers draws from the executor's generator rather
  than cuDNN's.  ``cudnn_calls`` counts them.  A CUDA tensor goes to cuDNN
  or raises; nothing falls back to the plain version.

torch's RNN functional runs on the CPU as well, so ``rnn_forward(...,
route="cudnn")`` on CPU tensors lets the tests hold the card route's math
(gate order, the GRU candidate) against the plain version here.

Weight layout (flat ``parameters`` vector), per layer then per direction:
W_i2h (G*H, I_layer), W_h2h (G*H, H), b_i2h (G*H,), b_h2h (G*H,) with G = 1
(rnn_relu, rnn_tanh), 4 (lstm, gates i,f,g,o) or 3 (gru, gates r,z,n).  The
GRU candidate is n = tanh(x W_in + b_in + r * (h W_hn + b_hn)), which is
torch's (and cuDNN's) as well.

Mixed float dtypes promote, as ``jnp.dot`` promotes them in the JAX
package: under a bfloat16 policy the begin states stay float32, and so does
the recurrence (the card route hands cuDNN every operand at the promoted
dtype).
"""
from __future__ import annotations

import warnings

import numpy as _np
import torch

from ..base import MXNetError
from .elemwise import promoted
from .registry import register, parse_bool, parse_float, parse_int, parse_str

__all__ = ["rnn_param_size", "rnn_unpack_params", "rnn_forward",
           "cudnn_calls"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

# cuDNN RNN calls made on the card (one per layer of a forward)
cudnn_calls = 0


def _layer_param_shapes(mode, input_size, state_size, num_layers,
                        bidirectional):
    """Yield (layer, direction, name, shape) for the flat layout."""
    gates = _GATES[mode]
    ndir = 2 if bidirectional else 1
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * ndir
        for d in range(ndir):
            yield (layer, d, "i2h_weight", (gates * state_size, in_size))
            yield (layer, d, "h2h_weight", (gates * state_size, state_size))
            yield (layer, d, "i2h_bias", (gates * state_size,))
            yield (layer, d, "h2h_bias", (gates * state_size,))


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    return sum(int(_np.prod(s)) for _, _, _, s in _layer_param_shapes(
        mode, input_size, state_size, num_layers, bidirectional))


def rnn_unpack_params(params, mode, input_size, state_size, num_layers,
                      bidirectional):
    """Flat vector (numpy array or tensor) -> {(layer, dir, name): view}."""
    out = {}
    off = 0
    for layer, d, name, shape in _layer_param_shapes(
            mode, input_size, state_size, num_layers, bidirectional):
        n = int(_np.prod(shape))
        out[(layer, d, name)] = params[off:off + n].reshape(shape)
        off += n
    return out


# ------------------------------------------------------------ plain version
def _cell_step(mode, xw, h, c, w_hh, b_hh):
    """One step given the precomputed input projection ``xw``."""
    H = h.shape[-1]
    hh = torch.matmul(*promoted(h, w_hh.t()))
    if mode == "gru":
        # r and z add the whole h2h term; the candidate gates its own
        hh = hh + b_hh
        r = torch.sigmoid(xw[..., 0:H] + hh[..., 0:H])
        z = torch.sigmoid(xw[..., H:2 * H] + hh[..., H:2 * H])
        n = torch.tanh(xw[..., 2 * H:3 * H] + r * hh[..., 2 * H:3 * H])
        return (1 - z) * n + z * h, None
    gates = xw + hh + b_hh
    if mode == "rnn_relu":
        return torch.relu(gates), None
    if mode == "rnn_tanh":
        return torch.tanh(gates), None
    if mode == "lstm":
        i = torch.sigmoid(gates[..., 0:H])
        f = torch.sigmoid(gates[..., H:2 * H])
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:4 * H])
        new_c = f * c + i * g
        return o * torch.tanh(new_c), new_c
    raise MXNetError("unknown RNN mode %s" % mode)


def _run_layer(mode, x, h0, c0, w_ih, w_hh, b_ih, b_hh, reverse):
    """One direction of one layer, stepped over time.  x: (T, N, I)."""
    # the input projection of every step in one matmul
    xw = torch.matmul(*promoted(x, w_ih.t())) + b_ih
    if reverse:
        xw = torch.flip(xw, (0,))
    h, c = h0, c0
    outs = []
    for t in range(xw.shape[0]):
        h, c = _cell_step(mode, xw[t], h, c, w_hh, b_hh)
        outs.append(h)
    out = torch.stack(outs)
    if reverse:
        out = torch.flip(out, (0,))
    return out, h, c


def _plain_layer(mode, x, h0, c0, w, ndir):
    """A layer's directions by the plain version: (out, [hT], [cT])."""
    outs, hs, cs = [], [], []
    for d in range(ndir):
        out, hT, cT = _run_layer(mode, x, h0[d], None if c0 is None
                                 else c0[d], *w[d], reverse=(d == 1))
        outs.append(out)
        hs.append(hT)
        cs.append(cT)
    return (outs[0] if ndir == 1 else torch.cat(outs, -1)), hs, cs


# ---------------------------------------------------------------- card route
def _cudnn_layer(mode, x, h0, c0, w, ndir):
    """A layer's directions in one call of torch's RNN functional (cuDNN on
    a CUDA tensor): (out, [hT], [cT])."""
    global cudnn_calls
    if x.is_cuda and not (torch.backends.cudnn.enabled
                          and torch.backends.cudnn.is_acceptable(x)):
        raise MXNetError("RNN: cuDNN cannot take this CUDA input (enabled=%s,"
                         " dtype %s); the op has no other card route"
                         % (torch.backends.cudnn.enabled, x.dtype))
    weights = [t for d in range(ndir) for t in w[d]]
    x, h0, c0, *weights = promoted(x, h0, c0, *weights)
    fn = getattr(torch._VF, mode)
    hx = [h0, c0] if mode == "lstm" else h0
    # ``train`` keeps cuDNN's reserve space for the backward (the dropout
    # between layers is ours, so cuDNN's own is 0).  The layer's slices of
    # the flat vector are not in cuDNN's weight layout, so torch copies
    # them into one buffer at every call (and warns that it does); the
    # copy is differentiable and its size is the layer's weights'.
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "RNN module weights are not part",
                                UserWarning)
        res = fn(x, hx, weights, True, 1, 0.0, torch.is_grad_enabled(),
                 ndir == 2, False)
    if x.is_cuda:
        cudnn_calls += 1
    cN = res[2] if mode == "lstm" else None
    return (res[0], list(res[1].unbind(0)),
            list(cN.unbind(0)) if cN is not None else [None] * ndir)


def rnn_forward(data, parameters, state, state_cell=None, mode="lstm",
                state_size=None, num_layers=1, bidirectional=False, p=0.0,
                is_train=False, rng=None, route=None):
    """The RNN over a whole sequence: (out, hN, cN) with hN / cN of shape
    (L * ndir, N, H) (cN None unless lstm).  ``route`` None picks by the
    device of ``data``: "cudnn" on the card, "plain" on the host; the tests
    and the smoke run ask for either explicitly."""
    if route is None:
        route = "cudnn" if data.is_cuda else "plain"
    layer_fn = {"cudnn": _cudnn_layer, "plain": _plain_layer}[route]
    T, N, I = data.shape
    ndir = 2 if bidirectional else 1
    wd = rnn_unpack_params(parameters, mode, I, state_size, num_layers,
                           bidirectional)
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        lo = layer * ndir
        w = [tuple(wd[(layer, d, n)] for n in ("i2h_weight", "h2h_weight",
                                               "i2h_bias", "h2h_bias"))
             for d in range(ndir)]
        c0 = state_cell[lo:lo + ndir] if mode == "lstm" else None
        x, hs, cs = layer_fn(mode, x, state[lo:lo + ndir], c0, w, ndir)
        h_states += hs
        c_states += cs
        if is_train and p > 0.0 and layer < num_layers - 1:
            keep = 1.0 - p
            mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
            x = torch.where(mask, x / keep, 0.0).to(x.dtype)
    hN = torch.stack(h_states, 0)
    cN = torch.stack(c_states, 0) if mode == "lstm" else None
    return x, hN, cN


# ---------------------------------------------------------------- the op
def _rnn_args(attrs):
    args = ["data", "parameters", "state"]
    if attrs.get("mode", "lstm") == "lstm":
        args.append("state_cell")
    return args


def _rnn_num_outputs(attrs):
    n = 1
    if attrs.get("state_outputs", False):
        n += 2 if attrs.get("mode", "lstm") == "lstm" else 1
    return n


def _rnn_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None] * _rnn_num_outputs(attrs), None
    T, N, I = data
    H = int(attrs["state_size"])
    L = int(attrs["num_layers"])
    bi = attrs.get("bidirectional", False)
    ndir = 2 if bi else 1
    psize = rnn_param_size(attrs.get("mode", "lstm"), I, H, L, bi)
    ins = list(in_shapes)
    ins[1] = (psize,)
    ins[2] = (L * ndir, N, H)
    if len(ins) > 3:
        ins[3] = (L * ndir, N, H)
    outs = [(T, N, H * ndir)]
    if attrs.get("state_outputs", False):
        outs.append((L * ndir, N, H))
        if attrs.get("mode", "lstm") == "lstm":
            outs.append((L * ndir, N, H))
    return ins, outs, None


@register("RNN", arg_names=_rnn_args, num_outputs=_rnn_num_outputs,
          attr_types={"state_size": parse_int, "num_layers": parse_int,
                      "bidirectional": parse_bool, "mode": parse_str,
                      "p": parse_float, "state_outputs": parse_bool,
                      "pkeep_": parse_float},
          defaults={"bidirectional": False, "mode": "lstm", "p": 0.0,
                    "state_outputs": False},
          infer_shape=_rnn_infer, needs_rng=True, train_aware=True)
def _rnn(data, parameters, state, state_cell=None, rng=None, is_train=False,
         state_size=None, num_layers=1, bidirectional=False, mode="lstm",
         p=0.0, state_outputs=False, pkeep_=None):
    """Fused multi-layer (bi)RNN / LSTM / GRU over a full sequence."""
    out, hN, cN = rnn_forward(data, parameters, state, state_cell, mode,
                              state_size, num_layers, bidirectional, p,
                              is_train, rng)
    if not state_outputs:
        return out
    return (out, hN, cN) if mode == "lstm" else (out, hN)
