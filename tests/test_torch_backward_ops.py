"""Per-op backward parity, mxnet_tpu_torch (autograd, and the loss heads'
fixed-gradient Functions) vs mxnet_tpu (``jax.vjp``), in float64 (1e-9):
every loss head with each normalization and with use_ignore, Embedding with
repeated, negative and out-of-range indices, LayerNorm, FullyConnected,
Activation, transpose, slice_axis, Reshape, Flatten and _plus; the optimizer
update ops' forward; and the Executor's grad_req write/add/null against the
JAX Executor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from test_torch_threads import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _labels(rng, shape, nclass, ignore=False):
    lab = rng.randint(0, nclass, shape).astype(np.float64)
    if ignore:
        lab.flat[::3] = -1.0
    return lab


def _softmax_cases():
    out = []
    for norm in ("null", "batch", "valid"):
        for ignore in (False, True):
            out.append(({"normalization": norm, "use_ignore": ignore},
                        (5, 6), (5,)))
    out += [({"grad_scale": 0.5}, (5, 6), (5,)),
            ({"multi_output": True}, (2, 4, 3), (2, 3)),
            ({"multi_output": True, "use_ignore": True,
              "normalization": "valid"}, (2, 4, 3), (2, 3)),
            ({"preserve_shape": True}, (2, 3, 4), (2, 3)),
            ({"preserve_shape": True, "use_ignore": True,
              "normalization": "batch"}, (2, 3, 4), (2, 3))]
    return out


def _loss_cases():
    rng = np.random.RandomState(0)
    cases = []
    for attrs, dshape, lshape in _softmax_cases():
        nclass = dshape[1] if attrs.get("multi_output") else dshape[-1]
        cases.append(("SoftmaxOutput", attrs,
                      [rng.randn(*dshape),
                       _labels(rng, lshape, nclass,
                               attrs.get("use_ignore", False))], (0, 1)))
    for name in ("LinearRegressionOutput", "LogisticRegressionOutput",
                 "MAERegressionOutput"):
        for attrs in ({}, {"grad_scale": 2.0}):
            cases.append((name, attrs, [rng.randn(4, 3), rng.randn(4, 3)],
                          (0, 1)))
    for norm in ("null", "batch", "valid"):
        cases.append(("MakeLoss", {"normalization": norm, "grad_scale": 0.7,
                                   "valid_thresh": 0.1},
                      [rng.randn(4, 3)], (0,)))
    for linear in (False, True):
        cases.append(("SVMOutput", {"use_linear": linear, "margin": 0.5,
                                    "regularization_coefficient": 0.7},
                      [rng.randn(4, 5), _labels(rng, (4,), 5)], (0, 1)))
    cases.append(("softmax_cross_entropy", {},
                  [rng.randn(4, 5), _labels(rng, (4,), 5)], (0, 1)))
    return cases


def _op_cases():
    rng = np.random.RandomState(1)
    n = 7
    idx = np.array([[0, 3, 3, 6, -1, -7], [3, 7, -8, 12, 2, 3]],
                   dtype=np.float64)       # repeats, wraps, out of range
    return [
        ("Embedding", {"input_dim": n, "output_dim": 4},
         [idx, rng.randn(n, 4)], (1,)),
        ("LayerNorm", {}, [rng.randn(3, 4, 6), rng.randn(6), rng.randn(6)],
         (0, 1, 2)),
        ("LayerNorm", {"eps": 1e-3}, [rng.randn(5, 8), rng.randn(8),
                                      rng.randn(8)], (0, 1, 2)),
        ("FullyConnected", {"num_hidden": 5},
         [rng.randn(3, 4, 2, 2), rng.randn(5, 16), rng.randn(5)], (0, 1, 2)),
        ("FullyConnected", {"num_hidden": 5, "no_bias": True},
         [rng.randn(3, 16), rng.randn(5, 16)], (0, 1)),
        ("Activation", {"act_type": "relu"}, [rng.randn(3, 7)], (0,)),
        ("Activation", {"act_type": "tanh"}, [rng.randn(3, 7)], (0,)),
        ("Activation", {"act_type": "sigmoid"}, [rng.randn(3, 7)], (0,)),
        ("Activation", {"act_type": "softrelu"}, [rng.randn(3, 7)], (0,)),
        ("transpose", {"axes": (2, 0, 3, 1, 4)}, [rng.randn(2, 3, 3, 2, 4)],
         (0,)),
        ("transpose", {}, [rng.randn(2, 3, 4)], (0,)),
        ("slice_axis", {"axis": 0, "begin": 1, "end": 2},
         [rng.randn(3, 2, 4)], (0,)),
        ("slice_axis", {"axis": -1, "begin": -3, "end": None},
         [rng.randn(3, 2, 5)], (0,)),
        ("Reshape", {"shape": (-3, -2)}, [rng.randn(1, 2, 3, 4)], (0,)),
        ("Reshape", {"shape": (-1, 6)}, [rng.randn(2, 3, 4)], (0,)),
        ("Flatten", {}, [rng.randn(2, 3, 4)], (0,)),
        ("_plus", {}, [rng.randn(2, 3), rng.randn(2, 3)], (0, 1)),
    ]


CASES = _loss_cases() + _op_cases()
IDS = ["%d-%s" % (i, c[0]) for i, c in enumerate(CASES)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_f64_matches_mxnet_tpu(case, f64):
    """The same inputs and output cotangent through ``jax.vjp`` of the JAX
    op and ``torch.autograd.grad`` of the port's; the loss heads ignore the
    cotangent (checked by giving a random one) and give the label zeros."""
    name, attrs, ins, wrt = case
    jop, pop = jget_op(name), pget_op(name)
    jcall = jop.make_callable(jop.normalize_attrs(attrs), True)
    pcall = pop.make_callable(pop.normalize_attrs(attrs), True)

    def jf(*diff):
        full = [jnp.asarray(a) for a in ins]
        for i, x in zip(wrt, diff):
            full[i] = x
        out = jcall(*full)
        return out[0] if isinstance(out, (tuple, list)) else out
    jout, pull = jax.vjp(jf, *[jnp.asarray(ins[i]) for i in wrt])
    cot = np.random.RandomState(len(IDS)).randn(*jout.shape)
    jgrads = pull(jnp.asarray(cot))

    pins = [torch.from_numpy(np.array(a)) for a in ins]
    for i in wrt:
        pins[i].requires_grad_(True)
    pout = pcall(*pins)
    pout = pout[0] if isinstance(pout, (tuple, list)) else pout
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               **TOL)
    pgrads = torch.autograd.grad(pout, [pins[i] for i in wrt],
                                 torch.from_numpy(cot), allow_unused=True)
    for i, p, j in zip(wrt, pgrads, jgrads):
        j = np.asarray(j)
        p = np.zeros_like(ins[i]) if p is None else p.numpy()
        assert p.shape == j.shape, (i, p.shape, j.shape)
        np.testing.assert_allclose(p, j, **TOL)


def test_loss_heads_are_flagged():
    for name in ("SoftmaxOutput", "LinearRegressionOutput",
                 "LogisticRegressionOutput", "MAERegressionOutput",
                 "MakeLoss", "SVMOutput"):
        assert pget_op(name).is_loss and jget_op(name).is_loss
    for name in ("softmax_cross_entropy", "FullyConnected"):
        assert not pget_op(name).is_loss


UPDATES = [
    ("sgd_update", {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5,
                    "clip_gradient": 0.3}, 0),
    ("sgd_mom_update", {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, 1),
    ("adam_update", {"lr": 0.01, "wd": 0.001, "clip_gradient": 1.0}, 2),
    ("rmsprop_update", {"lr": 0.01, "gamma1": 0.9, "clip_weights": 0.5}, 1),
    ("rmspropalex_update", {"lr": 0.01, "gamma1": 0.9, "gamma2": 0.8}, 3),
]


@pytest.mark.parametrize("case", UPDATES, ids=[u[0] for u in UPDATES])
def test_optimizer_update_ops_f64(case, f64):
    name, attrs, n_state = case
    rng = np.random.RandomState(2)
    ins = [rng.randn(4, 3), rng.randn(4, 3)] + \
        [np.abs(rng.randn(4, 3)) for _ in range(n_state)]
    if name == "rmspropalex_update":
        ins[3] = ins[3] * 0.1          # keep n - g^2 + eps positive
    jop, pop = jget_op(name), pget_op(name)
    jout = jop.fn(*[jnp.asarray(a) for a in ins], **attrs)
    pout = pop.fn(*[torch.from_numpy(a) for a in ins], **attrs)
    jout = jout if isinstance(jout, tuple) else (jout,)
    pout = pout if isinstance(pout, tuple) else (pout,)
    assert len(pout) == len(jout) == 1 + n_state
    for p, j in zip(pout, jout):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


def _mlp(S):
    x = S.FullyConnected(S.Variable("data"), num_hidden=6, name="fc1")
    x = S.Activation(x, act_type="tanh")
    x = S.FullyConnected(x, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(x, S.Variable("softmax_label"), name="softmax")


GRAD_REQS = ["write", "add", "null",
             {"fc1_weight": "write", "fc1_bias": "add", "fc2_weight": "add"},
             ["null", "write", "add", "write", "null", "null"]]


@pytest.mark.parametrize("grad_req", GRAD_REQS,
                         ids=["write", "add", "null", "dict", "list"])
def test_executor_grad_req_matches_mxnet_tpu(grad_req, f64):
    """forward(is_train=True) + backward() twice into preset gradient
    arrays: 'write' overwrites, 'add' accumulates, 'null' leaves no
    array; the port's arrays equal the JAX Executor's."""
    jsym = _mlp(mx.sym)
    psym = mt.sym.load_json(jsym.tojson())
    shapes = {"data": (5, 3), "softmax_label": (5,)}
    arg_shapes, _, _ = jsym.infer_shape(**shapes)
    rng = np.random.RandomState(3)
    args = {n: rng.randn(*s) for n, s in zip(jsym.list_arguments(),
                                             arg_shapes)}
    args["softmax_label"] = rng.randint(0, 4, 5).astype(np.float64)
    preset = {n: rng.randn(*a.shape) for n, a in args.items()}
    cpu = mt.cpu()
    jex = jsym.bind(mx.cpu(), {n: mx.nd.array(v, dtype=np.float64)
                               for n, v in args.items()},
                    args_grad={n: mx.nd.array(v, dtype=np.float64)
                               for n, v in preset.items()},
                    grad_req=grad_req)
    pex = psym.bind(cpu, {n: mt.nd.array(v, ctx=cpu, dtype=np.float64)
                          for n, v in args.items()},
                    args_grad={n: mt.nd.array(v, ctx=cpu, dtype=np.float64)
                               for n, v in preset.items()},
                    grad_req=grad_req)
    for ex in (jex, pex):
        ex.forward(is_train=True)
        ex.backward()
        ex.backward()
    assert sorted(pex.grad_dict) == sorted(jex.grad_dict)
    for n, g in jex.grad_dict.items():
        np.testing.assert_allclose(pex.grad_dict[n].asnumpy(), g.asnumpy(),
                                   **TOL)
    np.testing.assert_allclose(pex.outputs[0].asnumpy(),
                               jex.outputs[0].asnumpy(), **TOL)


def test_executor_explicit_out_grads_and_errors(f64):
    """A non-loss output takes explicit out_grads (equal to the JAX
    Executor's gradient); backward before a training forward raises; a bad
    grad_req raises; an inference forward records nothing."""
    S = mt.sym
    net = S.FullyConnected(S.Variable("data"), num_hidden=3, name="fc")
    rng = np.random.RandomState(4)
    x, w, b = rng.randn(2, 4), rng.randn(3, 4), rng.randn(3)
    og = rng.randn(2, 3)
    cpu = mt.cpu()
    pex = net.bind(cpu, {"data": mt.nd.array(x, ctx=cpu, dtype=np.float64),
                         "fc_weight": mt.nd.array(w, ctx=cpu,
                                                  dtype=np.float64),
                         "fc_bias": mt.nd.array(b, ctx=cpu,
                                                dtype=np.float64)},
                   args_grad={"fc_weight": mt.nd.zeros((3, 4), ctx=cpu,
                                                       dtype=np.float64)},
                   grad_req={"fc_weight": "write"})
    with pytest.raises(mt.MXNetError, match="forward\\(is_train=True\\)"):
        pex.backward()
    out = pex.forward(is_train=False)[0]
    assert not out.value.requires_grad
    pex.forward(is_train=True)
    pex.backward([mt.nd.array(og, ctx=cpu, dtype=np.float64)])
    np.testing.assert_allclose(pex.grad_dict["fc_weight"].asnumpy(),
                               og.T @ x, **TOL)
    with pytest.raises(mt.MXNetError, match="grad_req"):
        net.bind(cpu, pex.arg_dict, grad_req="sometimes")
