"""Loss heads with their fixed gradients (counterpart: mxnet_tpu/ops/loss.py):
SoftmaxOutput, LinearRegressionOutput, LogisticRegressionOutput,
MAERegressionOutput, MakeLoss, SVMOutput, softmax_cross_entropy.

An MXNet loss head defines its own backward: SoftmaxOutput's gradient is
``softmax - one_hot(label)`` whatever gradient reaches its output.  The JAX
package writes each as a ``jax.custom_vjp``; here each is a
``torch.autograd.Function`` whose backward ignores the incoming gradient and
gives the label a zero gradient.  At inference they are the plain forward
(SoftmaxOutput's label is bound, as zeros by the predictor, and ignored).
Under a data-parallel step (``nn.global_batch_stats``) the "batch" and
"valid" normalizations count the global batch, as the JAX package's one
program does.
"""
from __future__ import annotations

import torch

from .nn import stats_sync
from .registry import register, parse_bool, parse_float, parse_str


def _global_rows(n, sync):
    """A row count over every rank's batch (``n`` on this rank)."""
    return n if sync is None else n * sync[1]


def _global_valid(valid, sync):
    """A count tensor of this rank's valid entries, summed over the ranks
    of a data-parallel step."""
    if sync is None:
        return valid
    from ..parallel.dist import all_reduce_
    return all_reduce_(valid.reshape(1).to(torch.float64), sync[0],
                       "stats")[0]


def _no_label_grad(ctx, label):
    return torch.zeros_like(label) if ctx.needs_input_grad[1] else None


# ---------------------------------------------------------------- SoftmaxOutput
def _softmax_out_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], None
    if attrs.get("multi_output", False):
        label = (data[0],) + tuple(data[2:])
    elif attrs.get("preserve_shape", False):
        label = tuple(data[:-1])
    else:
        label = (data[0],)
    return [data, label], [data], None


def _softmax_fwd(data, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


def _one_hot(lab, nclass, dtype):
    """One-hot rows of int64 labels; a label outside [0, nclass) (an
    ignored -1) gives a row of zeros, as ``jax.nn.one_hot`` does."""
    valid = ((lab >= 0) & (lab < nclass)).unsqueeze(-1)
    idx = torch.where(valid, lab.unsqueeze(-1), torch.zeros_like(valid,
                                                                dtype=lab.dtype))
    out = torch.zeros(tuple(lab.shape) + (nclass,), dtype=dtype,
                      device=lab.device)
    return out.scatter_(-1, idx, valid.to(dtype))


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; backward (softmax - one_hot(label)), masked by
    ``use_ignore``, normalized, times ``grad_scale`` (parity:
    softmax_output-inl.h and the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, preserve_shape, normalization):
        out = _softmax_fwd(data, multi_output, preserve_shape)
        ctx.save_for_backward(out, label)
        ctx.sync = stats_sync()
        ctx.attrs = (grad_scale, ignore_label, multi_output, use_ignore,
                     preserve_shape, normalization)
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, multi_output, use_ignore, preserve_shape,
         normalization) = ctx.attrs
        lab = label.to(torch.int64)
        if multi_output:
            onehot = torch.movedim(_one_hot(lab, out.shape[1], out.dtype),
                                   -1, 1)
        elif preserve_shape:
            onehot = _one_hot(lab.reshape(out.shape[:-1]), out.shape[-1],
                              out.dtype)
        else:
            flat = out.reshape(out.shape[0], -1)
            onehot = _one_hot(lab.reshape(out.shape[0]), flat.shape[1],
                              out.dtype).reshape(out.shape)
        grad = out - onehot
        if use_ignore:
            mask = (label != ignore_label).to(out.dtype)
            if multi_output:
                grad = grad * mask.unsqueeze(1)
            elif preserve_shape:
                grad = grad * mask.reshape(tuple(out.shape[:-1]) + (1,))
            else:
                grad = grad * mask.reshape((-1,) + (1,) * (out.dim() - 1))
        if normalization == "batch":
            grad = grad / _global_rows(out.shape[0], ctx.sync)
        elif normalization == "valid":
            if use_ignore:
                valid = _global_valid((label != ignore_label).sum(),
                                      ctx.sync).clamp_min(1)
            else:
                valid = _global_rows(label.numel(), ctx.sync)
            grad = grad / valid
        return (grad * grad_scale, _no_label_grad(ctx, label)) + (None,) * 6


@register("SoftmaxOutput", aliases=("Softmax",), arg_names=("data", "label"),
          attr_types={"grad_scale": parse_float, "ignore_label": parse_float,
                      "multi_output": parse_bool, "use_ignore": parse_bool,
                      "preserve_shape": parse_bool, "normalization": parse_str,
                      "out_grad": parse_bool, "smooth_alpha": parse_float},
          defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                    "multi_output": False, "use_ignore": False,
                    "preserve_shape": False, "normalization": "null"},
          infer_shape=_softmax_out_infer, is_loss=True)
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax with the cross-entropy gradient (parity:
    softmax_output-inl.h)."""
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                multi_output, use_ignore, preserve_shape,
                                normalization)


# ------------------------------------------------------------ regression heads
class _Regression(torch.autograd.Function):
    """Forward data (linear, mae) or sigmoid(data) (logistic); backward
    (out - label) or sign(out - label), times grad_scale over the outputs
    per sample (parity: regression_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        num_output = max(1, out[0].numel()) if out.dim() else 1
        return (diff * (ctx.grad_scale / num_output),
                _no_label_grad(ctx, label), None, None)


def _reg_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], None
    label = in_shapes[1]
    if label is None:
        # 1-output nets accept 1-D labels (regression_output-inl.h:113-121)
        label = (data[0],) if (len(data) == 2 and data[1] == 1) else data
    return [data, label], [data], None


def _make_regression(name, kind):
    @register(name, arg_names=("data", "label"),
              attr_types={"grad_scale": parse_float},
              defaults={"grad_scale": 1.0}, infer_shape=_reg_infer,
              is_loss=True)
    def _fn(data, label, grad_scale=1.0):
        return _Regression.apply(data, label, kind, grad_scale)
    return _fn


_make_regression("LinearRegressionOutput", "linear")
_make_regression("LogisticRegressionOutput", "logistic")
_make_regression("MAERegressionOutput", "mae")


# --------------------------------------------------------------------- MakeLoss
class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward the constant grad_scale, normalized
    (parity: make_loss-inl.h)."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(data)
        ctx.attrs = (grad_scale, valid_thresh, normalization)
        ctx.sync = stats_sync()
        return data.clone()

    @staticmethod
    def backward(ctx, _g):
        (data,) = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.attrs
        grad = torch.full_like(data, grad_scale)
        if normalization == "batch":
            grad = grad / _global_rows(data.shape[0], ctx.sync)
        elif normalization == "valid":
            valid = _global_valid((data > valid_thresh).sum(), ctx.sync)
            grad = grad / valid.clamp_min(1).to(data.dtype)
        return grad, None, None, None


@register("MakeLoss",
          attr_types={"grad_scale": parse_float, "valid_thresh": parse_float,
                      "normalization": parse_str},
          defaults={"grad_scale": 1.0, "valid_thresh": 0.0,
                    "normalization": "null"}, is_loss=True)
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Identity forward, constant grad_scale backward."""
    return _MakeLoss.apply(data, grad_scale, valid_thresh, normalization)


# -------------------------------------------------------------------- SVMOutput
class _SVMOutput(torch.autograd.Function):
    """Identity forward; the L1 or L2 hinge gradient backward (parity:
    svm_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.attrs
        onehot = _one_hot(label.to(torch.int64), out.shape[1], out.dtype)
        ycoef = 2.0 * onehot - 1.0      # +1 for the true class, -1 otherwise
        if use_linear:
            active = (margin - ycoef * out) > 0
            grad = torch.where(active, -ycoef, torch.zeros_like(ycoef)) \
                * reg_coef
        else:
            viol = (margin - ycoef * out).clamp_min(0.0)
            grad = -2.0 * reg_coef * viol * ycoef
        return (grad.to(out.dtype), _no_label_grad(ctx, label), None, None,
                None)


@register("SVMOutput", arg_names=("data", "label"),
          attr_types={"margin": parse_float,
                      "regularization_coefficient": parse_float,
                      "use_linear": parse_bool},
          defaults={"margin": 1.0, "regularization_coefficient": 1.0,
                    "use_linear": False},
          infer_shape=lambda attrs, ins: (
              [ins[0], None if ins[0] is None else (ins[0][0],)],
              [ins[0]], None), is_loss=True)
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


# -------------------------------------------------------- softmax_cross_entropy
@register("softmax_cross_entropy", arg_names=("data", "label"),
          infer_shape=lambda attrs, ins: (ins, [(1,)], None))
def _softmax_cross_entropy(data, label):
    """Scalar cross-entropy loss under plain autograd; the label gets no
    gradient (parity: loss_binary_op.cc)."""
    lab = label.detach().to(torch.int64)
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, 1, lab.reshape(-1, 1))
    return -picked.sum().reshape((1,))
