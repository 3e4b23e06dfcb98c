"""The port's ``RNN`` op (mxnet_tpu_torch/ops/rnn_op.py) against mxnet_tpu's,
on the CPU in float64.

- The flat parameter layout: ``rnn_param_size`` and ``rnn_unpack_params``
  give the JAX package's sizes, keys and slices.
- The op in every mode (lstm, gru, rnn_tanh, rnn_relu), one- and
  bidirectional, with ``state_outputs``: outputs, final states and the
  gradients of data, parameters and states through ``bind`` /
  ``forward(is_train=True)`` / ``backward(out_grads)`` in both packages,
  within 1e-9 relative.
- The card route's math: torch's RNN functional (``route="cudnn"``, which
  is cuDNN on a CUDA tensor and torch's own on the host) against the plain
  version within 1e-9 in float64, which pins the gate orders and the GRU
  candidate n = tanh(x W_in + b_in + r * (h W_hn + b_hn)).
- Inter-layer dropout: the op's output equals the layers run one by one
  with the mask drawn from a generator in the same state (an injected
  mask: torch's and JAX's random streams differ); outside training it is
  the identity.
- On the card (``cuda`` marker): the cuDNN route against the plain version
  on the card and against float64 on the host, one ``cudnn_calls`` per
  layer.

JAX is imported by the tests that compare with it, so that the ``cuda``
test also runs where only the port is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_rnn_op.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import rnn_op

TOL = 1e-9
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]
# (T, N, I, H, layers): small, with two layers so the second layer's input
# is the first one's (both directions') output
T, N, I, H, L = 4, 3, 5, 6, 2


@pytest.fixture
def jx():
    """mxnet_tpu with 64-bit mode on (scoped to the test)."""
    jax = pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    jax.config.update("jax_enable_x64", True)
    yield mx
    jax.config.update("jax_enable_x64", False)


def _inputs(mode, bi, seed=0):
    ndir = 2 if bi else 1
    rs = np.random.RandomState(seed)
    n = rnn_op.rnn_param_size(mode, I, H, L, bi)
    vals = {"data": rs.randn(T, N, I), "parameters": rs.randn(n) * 0.4,
            "state": rs.randn(L * ndir, N, H) * 0.5}
    if mode == "lstm":
        vals["state_cell"] = rs.randn(L * ndir, N, H) * 0.5
    return vals


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_param_layout_matches_mxnet_tpu(mode, bi):
    from mxnet_tpu.ops import rnn_op as jrnn
    for i_size in (1, 7):
        n = rnn_op.rnn_param_size(mode, i_size, H, 3, bi)
        assert n == jrnn.rnn_param_size(mode, i_size, H, 3, bi)
        flat = np.arange(n, dtype=np.float64)
        got = rnn_op.rnn_unpack_params(flat, mode, i_size, H, 3, bi)
        want = jrnn.rnn_unpack_params(flat, mode, i_size, H, 3, bi)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _run(pkg, mode, bi, vals, heads):
    """(outputs, {input: gradient}) of the RNN op bound on the CPU in
    float64, backward from the head gradients ``heads``."""
    ctx = pkg.cpu()
    names = ["data", "parameters", "state"] + (
        ["state_cell"] if mode == "lstm" else [])
    net = pkg.sym.RNN(*[pkg.sym.Variable(n) for n in names], state_size=H,
                      num_layers=L, mode=mode, bidirectional=bi,
                      state_outputs=True, name="rnn")
    assert net.list_arguments() == names
    args = {n: pkg.nd.array(vals[n], ctx=ctx, dtype=np.float64)
            for n in names}
    grads = {n: pkg.nd.zeros(vals[n].shape, ctx=ctx, dtype=np.float64)
             for n in names}
    ex = net.bind(ctx, args, args_grad=grads)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([pkg.nd.array(h, ctx=ctx, dtype=np.float64) for h in heads])
    return outs, {n: g.asnumpy() for n, g in ex.grad_dict.items()}


@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_matches_mxnet_tpu(mode, bi, jx):
    vals = _inputs(mode, bi)
    ndir = 2 if bi else 1
    rs = np.random.RandomState(1)
    heads = [rs.randn(T, N, H * ndir)] + [
        rs.randn(L * ndir, N, H) for _ in range(2 if mode == "lstm" else 1)]
    got, got_g = _run(mt, mode, bi, vals, heads)
    want, want_g = _run(jx, mode, bi, vals, heads)
    assert [o.shape for o in got] == [o.shape for o in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float64
        assert _rel(g, w) < TOL, ("output", i, _rel(g, w))
    assert sorted(got_g) == sorted(want_g)
    for n in want_g:
        assert _rel(got_g[n], want_g[n]) < TOL, (n, _rel(got_g[n],
                                                         want_g[n]))


def _routes(mode, bi, route, vals, dtype=torch.float64, device="cpu",
            p=0.0, rng=None, is_train=False):
    """(out, hN, cN, {input: gradient}) of ``rnn_forward`` by ``route``
    with a fixed cotangent on every output."""
    ts = {n: torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
          for n, v in vals.items()}
    out, hN, cN = rnn_op.rnn_forward(
        ts["data"], ts["parameters"], ts["state"], ts.get("state_cell"),
        mode, H, L, bi, p=p, is_train=is_train, rng=rng, route=route)
    outs = [out, hN] + ([cN] if cN is not None else [])
    loss = sum((o * torch.cos(torch.arange(o.numel(), dtype=dtype,
                                           device=device)
                              .reshape(o.shape))).sum() for o in outs)
    gs = torch.autograd.grad(loss, list(ts.values()))
    return [o.detach() for o in outs], dict(zip(ts, gs))


@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cudnn_route_math_matches_plain(mode, bi):
    """torch's RNN functional, the card route's call, against the plain
    version on the host in float64: outputs, final states and gradients."""
    vals = _inputs(mode, bi, seed=2)
    got, got_g = _routes(mode, bi, "cudnn", vals)
    want, want_g = _routes(mode, bi, "plain", vals)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) < TOL, ("output", i)
    for n in want_g:
        assert _rel(got_g[n], want_g[n]) < TOL, n
    # the counter counts cuDNN calls on the card only
    assert rnn_op.cudnn_calls == 0


def test_gru_candidate_gates_the_h2h_term():
    """The GRU candidate multiplies r into (h W_hn + b_hn), not into h:
    one step by hand against both routes."""
    rs = np.random.RandomState(3)
    x, h = rs.randn(1, 2, 3), rs.randn(1, 2, 4)
    p = rs.randn(rnn_op.rnn_param_size("gru", 3, 4, 1, False))
    w = rnn_op.rnn_unpack_params(p, "gru", 3, 4, 1, False)
    wi, wh = w[(0, 0, "i2h_weight")], w[(0, 0, "h2h_weight")]
    bi, bh = w[(0, 0, "i2h_bias")], w[(0, 0, "h2h_bias")]
    xi, hh = x[0] @ wi.T + bi, h[0] @ wh.T + bh

    def sig(v):
        return 1 / (1 + np.exp(-v))
    r, z = sig(xi[:, :4] + hh[:, :4]), sig(xi[:, 4:8] + hh[:, 4:8])
    n = np.tanh(xi[:, 8:] + r * hh[:, 8:])
    want = (1 - z) * n + z * h[0]
    for route in ("plain", "cudnn"):
        out, _, _ = rnn_op.rnn_forward(
            torch.tensor(x), torch.tensor(p), torch.tensor(h), None, "gru",
            4, 1, False, route=route)
        assert _rel(out[0].numpy(), want) < TOL, route


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_dropout_between_layers_is_the_injected_mask(mode):
    """p > 0 in training: the op's output equals the layers run one at a
    time with the mask drawn from a generator in the same state; outside
    training the op ignores p."""
    layers, p = 3, 0.4
    rs = np.random.RandomState(4)
    n = rnn_op.rnn_param_size(mode, I, H, layers, False)
    flat = torch.tensor(rs.randn(n) * 0.4)
    x = torch.tensor(rs.randn(T, N, I))
    h0 = torch.tensor(rs.randn(layers, N, H))
    c0 = torch.tensor(rs.randn(layers, N, H)) if mode == "lstm" else None
    got, hN, _ = rnn_op.rnn_forward(
        x, flat, h0, c0, mode, H, layers, p=p, is_train=True,
        rng=torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(11)
    wd = rnn_op.rnn_unpack_params(flat, mode, I, H, layers, False)
    want, dropped = x, 0
    for layer in range(layers):
        sub = torch.cat([wd[(layer, 0, k)].reshape(-1) for k in
                         ("i2h_weight", "h2h_weight", "i2h_bias",
                          "h2h_bias")])
        want, hl, _ = rnn_op.rnn_forward(
            want, sub, h0[layer:layer + 1],
            None if c0 is None else c0[layer:layer + 1], mode, H, 1)
        assert torch.equal(hN[layer], hl[0])
        if layer < layers - 1:
            mask = torch.rand(want.shape, generator=gen) < 1 - p
            dropped += int((~mask).sum())
            want = torch.where(mask, want / (1 - p), 0.0)
    assert dropped > 0
    assert torch.equal(got, want)
    plain, _, _ = rnn_op.rnn_forward(x, flat, h0, c0, mode, H, layers)
    off, _, _ = rnn_op.rnn_forward(x, flat, h0, c0, mode, H, layers, p=p,
                                   is_train=False,
                                   rng=torch.Generator().manual_seed(11))
    assert torch.equal(off, plain)


def test_rnn_in_a_graph_draws_from_the_executor_generator():
    """Bound in a graph, the op takes the generator the executor hands to
    ``needs_rng`` ops: two training forwards from one seed agree, and the
    dropout shows (the output differs from inference)."""
    vals = _inputs("lstm", False, seed=5)
    net = mt.sym.RNN(mt.sym.Variable("data"), mt.sym.Variable("parameters"),
                     mt.sym.Variable("state"), mt.sym.Variable("state_cell"),
                     state_size=H, num_layers=L, mode="lstm", p=0.5)
    ex = net.bind(mt.cpu(), {k: mt.nd.array(v, ctx=mt.cpu())
                             for k, v in vals.items()})
    outs = []
    for _ in range(2):
        mt.random.seed(3)
        outs.append(ex.forward(is_train=True)[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.allclose(outs[0], ex.forward()[0].asnumpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", False),
                                     ("rnn_tanh", True), ("lstm", True)])
def test_cudnn_route_on_the_card(mode, bi):
    """float64 on the card: cuDNN against the plain version (both on the
    card) and against the host's plain version, one call per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    vals = _inputs(mode, bi, seed=6)
    before = rnn_op.cudnn_calls
    got, got_g = _routes(mode, bi, None, vals, device="cuda")
    assert rnn_op.cudnn_calls - before == L
    for route, dev in (("plain", "cuda"), ("plain", "cpu")):
        want, want_g = _routes(mode, bi, route, vals, device=dev)
        for g, w in zip(got, want):
            assert _rel(g.cpu(), w.cpu()) < TOL, (route, dev)
        for n in want_g:
            assert _rel(got_g[n].cpu(), want_g[n].cpu()) < TOL, (n, dev)
