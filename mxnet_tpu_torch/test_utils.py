"""Test helpers (counterpart: mxnet_tpu/test_utils.py): numeric-gradient
checks, symbolic forward/backward checks against numpy, and the
consistency check of one symbol over several contexts and dtypes
(``check_consistency([{"ctx": cpu(0), ...}, {"ctx": gpu(0), ...}])``
holds the card to the host).

Every array these helpers make lives on the ``ctx`` they are given; the
default is the current context, ``gpu(0)`` unless a ``with cpu():`` block
says otherwise.
"""
from __future__ import annotations

import zlib

import numpy as np

from .context import cpu, current_context
from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["default_context", "assert_almost_equal", "almost_equal",
           "check_numeric_gradient", "check_symbolic_forward",
           "check_symbolic_backward", "check_consistency", "rand_ndarray",
           "numeric_grad", "reldiff", "same", "random_arrays"]

default_dtype = np.float32


def default_context():
    return current_context()


def random_arrays(*shapes):
    """Random float32 arrays in [-1, 1)."""
    arrays = [np.random.uniform(-1.0, 1.0, s).astype(default_dtype)
              for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def rand_ndarray(shape, ctx=None):
    return nd.array(np.random.uniform(-1.0, 1.0, shape), ctx=ctx)


def same(a, b):
    return np.array_equal(a, b)


def reldiff(a, b):
    """sum |a - b| / (sum |a| + sum |b|) (parity: test_utils.reldiff)."""
    diff = np.sum(np.abs(a - b))
    norm = np.sum(np.abs(a)) + np.sum(np.abs(b))
    if diff == 0:
        return 0
    return diff / norm


def almost_equal(a, b, rtol=None, atol=None):
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    return np.allclose(a, b, rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    """Raise AssertionError naming the worst entry unless a and b are
    close (parity: test_utils.assert_almost_equal)."""
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        index = np.unravel_index(np.argmax(np.abs(a - b)), a.shape)
        relerr = np.max(np.abs(a - b) / (np.abs(b) + atol))
        raise AssertionError(
            "Items are not equal:\nError %f exceeds tolerance rtol=%f, "
            "atol=%f. Location of maximum error:%s, %s=%f, %s=%f"
            % (relerr, rtol, atol, str(index), names[0], a[index], names[1],
               b[index]))


def _parse_location(sym, location, ctx):
    if isinstance(location, dict):
        if set(location.keys()) != set(sym.list_arguments()):
            raise ValueError(
                "Symbol arguments and keys of the given location do not match."
                "symbol args:%s, location.keys():%s"
                % (str(set(sym.list_arguments())),
                   str(set(location.keys()))))
    else:
        location = dict(zip(sym.list_arguments(), location))
    return {k: nd.array(v, ctx=ctx) if not isinstance(v, nd.NDArray) else v
            for k, v in location.items()}


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Central finite differences of the sum of the first output (parity:
    test_utils.numeric_grad)."""
    approx_grads = {k: np.zeros(v.shape, dtype=np.float32)
                    for k, v in location.items()}
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    for k in location:
        old_value = location[k].copy()
        flat = old_value.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            executor.arg_dict[k][:] = old_value
            executor.forward(is_train=use_forward_train)
            f_peps = executor.outputs[0].asnumpy().sum()
            flat[i] = orig - eps
            executor.arg_dict[k][:] = old_value
            executor.forward(is_train=use_forward_train)
            f_neps = executor.outputs[0].asnumpy().sum()
            flat[i] = orig
            approx_grads[k].reshape(-1)[i] = (f_peps - f_neps) / (2 * eps)
        executor.arg_dict[k][:] = old_value
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None):
    """Finite differences against the backward's gradients (parity:
    test_utils.check_numeric_gradient).  A single non-loss head is wrapped
    in MakeLoss, so its head gradient is all ones."""
    ctx = ctx or default_context()
    head = sym._outputs[0][0]
    if len(sym._outputs) == 1 and not head.is_var \
            and not getattr(head.op, "is_loss", False) \
            and head.op.name != "BlockGrad":
        sym = sym_mod.create("MakeLoss", data=sym)
    location = _parse_location(sym, location, ctx)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    if grad_nodes is None:
        grad_nodes = sym.list_arguments()
    grad_req = {k: "write" if k in grad_nodes else "null"
                for k in sym.list_arguments()}
    args_grad = {k: nd.zeros(location[k].shape, ctx=ctx) for k in grad_nodes}
    executor = sym.bind(ctx, args=location, args_grad=args_grad,
                        grad_req=grad_req)
    executor.forward(is_train=use_forward_train)
    assert len(executor.outputs) == 1
    executor.backward()
    symbolic_grads = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}
    numeric_gradients = numeric_grad(executor, location_npy,
                                     eps=numeric_eps,
                                     use_forward_train=use_forward_train)
    for name in grad_nodes:
        fd_grad = numeric_gradients[name]
        sym_grad = symbolic_grads[name]
        rel = reldiff(fd_grad, sym_grad)
        if rel > rtol:
            raise AssertionError(
                "numeric gradient check failed for %s: reldiff %f > %f\n"
                "numeric:\n%s\nsymbolic:\n%s"
                % (name, rel, rtol, fd_grad, sym_grad))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None):
    """The outputs against ``expected`` (parity:
    test_utils.check_symbolic_forward); returns them."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    executor = sym.bind(ctx, args=location, grad_req="null")
    outputs = [o.asnumpy() for o in executor.forward()]
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out, exp, rtol=rtol,
                            atol=atol if atol is not None else 1e-8)
    return outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None):
    """The gradients for ``out_grads`` against ``expected`` (parity:
    test_utils.check_symbolic_backward); returns them."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    expected = expected if isinstance(expected, dict) else \
        dict(zip(sym.list_arguments(), expected))
    args_grad = {k: nd.zeros(v.shape, ctx=ctx)
                 for k, v in location.items() if k in expected}
    grad_reqs = {k: grad_req if k in expected else "null"
                 for k in sym.list_arguments()}
    executor = sym.bind(ctx, args=location, args_grad=args_grad,
                        grad_req=grad_reqs)
    executor.forward(is_train=True)
    ogs = [nd.array(g, ctx=ctx) if not isinstance(g, nd.NDArray) else g
           for g in (out_grads if isinstance(out_grads, (list, tuple))
                     else [out_grads])]
    executor.backward(ogs)
    grads = {k: v.asnumpy() for k, v in args_grad.items()}
    for name, exp in expected.items():
        assert_almost_equal(grads[name], exp, rtol=rtol,
                            atol=atol if atol is not None else 1e-8)
    return grads


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, seed=None):
    """Run one symbol under each entry of ``ctx_list`` (a dict: ``ctx``,
    an optional ``type_dict`` and the input shapes) and hold the outputs
    and gradients of each to those of the widest dtype's run (parity:
    test_utils.check_consistency).  The arguments are drawn from a
    RandomState seeded by their names and shapes (or ``seed``); returns
    the reference run's arguments and outputs."""
    tol = tol or {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
                  np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
                  np.dtype(np.int32): 0}
    assert len(ctx_list) > 1
    if isinstance(sym, sym_mod.Symbol):
        sym = [sym] * len(ctx_list)
    else:
        assert len(sym) == len(ctx_list)
    exe_list = []
    for s, ctx in zip(sym, ctx_list):
        ctx = dict(ctx)
        ctx_ctx = ctx.pop("ctx", cpu())
        type_dict = ctx.pop("type_dict", {})
        exe_list.append(s.simple_bind(ctx=ctx_ctx, grad_req=grad_req,
                                      type_dict=type_dict, **ctx))
    arg_params = arg_params or {}
    aux_params = aux_params or {}
    if seed is None:
        sig = ";".join("%s:%s" % (n, tuple(a.shape)) for n, a in
                       sorted(exe_list[0].arg_dict.items()))
        seed = zlib.crc32(sig.encode()) & 0x7FFFFFFF
    rng = np.random.RandomState(seed)
    for name, arr in exe_list[0].arg_dict.items():
        if name not in arg_params:
            arg_params[name] = rng.normal(
                size=arr.shape, scale=scale).astype(np.float32)
    for name in exe_list[0].aux_dict:
        if name not in aux_params:
            aux_params[name] = 0
    for exe in exe_list:
        for name, arr in exe.arg_dict.items():
            arr[:] = arg_params[name].astype(arr.dtype)
        for name, arr in exe.aux_dict.items():
            arr[:] = aux_params[name]
        exe.forward(is_train=grad_req != "null")
        if grad_req != "null":
            exe.backward(exe.outputs)
    dtypes = [np.dtype(e.outputs[0].dtype) for e in exe_list]
    max_idx = int(np.argmax([d.itemsize for d in dtypes]))
    gt = {n: v.asnumpy() for n, v in exe_list[max_idx].arg_dict.items()}
    gt.update({"__output__%d" % i: o.asnumpy()
               for i, o in enumerate(exe_list[max_idx].outputs)})
    for i, exe in enumerate(exe_list):
        if i == max_idx:
            continue
        rtol = tol[dtypes[i]]
        for j, o in enumerate(exe.outputs):
            assert_almost_equal(o.asnumpy().astype(np.float64),
                                gt["__output__%d" % j].astype(np.float64),
                                rtol=rtol, atol=rtol)
        if grad_req != "null":
            for name, arr in exe.grad_dict.items():
                if arr is None:
                    continue
                gt_arr = exe_list[max_idx].grad_dict[name].asnumpy()
                assert_almost_equal(arr.asnumpy().astype(np.float64),
                                    gt_arr.astype(np.float64),
                                    rtol=rtol, atol=rtol)
    return gt
