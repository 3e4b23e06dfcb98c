"""Evaluation metrics (counterpart: mxnet_tpu/metric.py).

``Accuracy`` reduces on the device: the argmax and the comparison run where
the predictions are, and the count of correct rows accumulates as a device
tensor, so ``Module.fit``'s batch loop never waits on the host; ``get()``
fetches the one scalar.  Only ``num_inst`` grows, from shapes.  The other
metrics compute on the host from ``asnumpy()``, as the JAX package's do.
"""
from __future__ import annotations

import math

import numpy
import torch

from .base import MXNetError, string_types

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy", "Loss",
           "CustomMetric", "np", "create"]

def check_label_shapes(labels, preds, shape=0):
    """Guard that label/prediction structure lines up before accumulating
    (count of output heads by default; tensor shapes with shape=1)."""
    a = labels.shape if shape else len(labels)
    b = preds.shape if shape else len(preds)
    if a != b:
        raise ValueError(
            "labels %s and predictions %s do not line up" % (a, b))


class EvalMetric(object):
    """Streaming-average base class: subclasses fold each batch into
    ``sum_metric``/``num_inst`` and ``get()`` reports their ratio.

    ``sum_metric`` may be held as a device scalar (see ``Accuracy``): batch
    updates then stay on the accelerator and the single host sync happens
    at get() time — the reference pays a device->host copy per batch.
    A metric with ``num`` set keeps one accumulator pair per output head."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        n = 1 if self.num is None else self.num
        sums, counts = [0.0] * n, [0] * n
        if self.num is None:
            self.sum_metric, self.num_inst = sums[0], counts[0]
        else:
            self.sum_metric, self.num_inst = sums, counts

    @staticmethod
    def _ratio(total, count):
        return float(total) / count if count else float("nan")

    def get(self):
        if self.num is None:
            return (self.name, self._ratio(self.sum_metric, self.num_inst))
        return (["%s_%d" % (self.name, i) for i in range(self.num)],
                [self._ratio(s, c)
                 for s, c in zip(self.sum_metric, self.num_inst)])

    def get_name_value(self):
        names, values = self.get()
        if not isinstance(names, list):
            names, values = [names], [values]
        return list(zip(names, values))

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


class CompositeEvalMetric(EvalMetric):
    """Fan one update() out to several child metrics (parity surface:
    CompositeEvalMetric with add/get_metric)."""

    def __init__(self, **kwargs):
        super().__init__("composite")
        self.metrics = list(kwargs.get("metrics") or [])

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        if 0 <= index < len(self.metrics):
            return self.metrics[index]
        return ValueError("Metric index %d is out of range 0 and %d"
                          % (index, len(self.metrics)))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", ()):
            m.reset()

    def get(self):
        pairs = [m.get() for m in self.metrics]
        return ([n for n, _ in pairs], [v for _, v in pairs])


class Accuracy(EvalMetric):
    """Classification accuracy (parity: Accuracy)."""

    def __init__(self):
        super().__init__("accuracy")

    def reset(self):
        # an int start keeps a device sum of correct rows an exact int64
        self.sum_metric, self.num_inst = 0, 0

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pv = pred_label.value
            lv = label.value
            if pv.dim() > 1 and pv.shape[1] > 1:
                pv = torch.argmax(pv, dim=1)
            pv = pv.reshape(-1)
            lv = lv.reshape(-1)
            if pv.device == lv.device:
                if pv.shape != lv.shape:
                    raise ValueError(
                        "Shape of labels %s does not match shape of "
                        "predictions %s" % (tuple(label.shape),
                                            tuple(pred_label.shape)))
                # no host sync in the batch loop: get() fetches the sum
                self.sum_metric = self.sum_metric + torch.sum(
                    pv.to(torch.int32) == lv.to(torch.int32))
                self.num_inst += pv.shape[0]
                continue
            pl = pv.to(torch.int32).cpu().numpy()
            lab = lv.to(torch.int32).cpu().numpy()
            check_label_shapes(lab, pl, 1)
            self.sum_metric += (pl == lab).sum()
            self.num_inst += len(pl)


class TopKAccuracy(EvalMetric):
    """Top-k accuracy (parity: TopKAccuracy)."""

    def __init__(self, **kwargs):
        super().__init__("top_k_accuracy")
        try:
            self.top_k = kwargs["top_k"]
        except KeyError:
            self.top_k = 1
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            pl = numpy.argsort(pred_label.asnumpy().astype("float32"), axis=1)
            lab = label.asnumpy().astype("int32")
            num_samples = pl.shape[0]
            num_dims = len(pl.shape)
            if num_dims == 1:
                self.sum_metric += (pl.flat == lab.flat).sum()
            elif num_dims == 2:
                num_classes = pl.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (pl[:, num_classes - 1 - j].flat ==
                                        lab.flat).sum()
            self.num_inst += num_samples


class F1(EvalMetric):
    """Binary F1 score (parity: F1)."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = pred.asnumpy()
            label = label.asnumpy().astype("int32")
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred, 1 if label.ndim > 1 else 0)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            true_pos = ((pred_label == 1) * (label == 1)).sum()
            false_pos = ((pred_label == 1) * (label == 0)).sum()
            false_neg = ((pred_label == 0) * (label == 1)).sum()
            precision = true_pos / (true_pos + false_pos) if \
                true_pos + false_pos > 0 else 0.0
            recall = true_pos / (true_pos + false_neg) if \
                true_pos + false_neg > 0 else 0.0
            f1_score = 2 * precision * recall / (precision + recall) if \
                precision + recall > 0 else 0.0
            self.sum_metric += f1_score
            self.num_inst += 1


class Perplexity(EvalMetric):
    """exp(mean NLL) (parity: Perplexity)."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            probs = pred.asnumpy()
            lab = label.asnumpy().astype("int32").reshape(-1)
            probs = probs.reshape(-1, probs.shape[-1])
            picked = probs[numpy.arange(lab.shape[0]), lab]
            if self.ignore_label is not None:
                ignore = (lab == self.ignore_label)
                picked = numpy.where(ignore, 1.0, picked)
                num -= ignore.sum()
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, picked)))
            num += lab.shape[0]
        self.sum_metric += math.exp(loss / max(1, num)) * num
        self.num_inst += num


class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


class CrossEntropy(EvalMetric):
    """Mean NLL of the true class (parity: CrossEntropy)."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


class Loss(EvalMetric):
    """Mean of the raw output values (for MakeLoss heads)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += pred.asnumpy().sum()
            self.num_inst += pred.size


class Torch(Loss):
    """Kept for API parity with reference metric.Torch."""

    def __init__(self):
        super().__init__()
        self.name = "torch"


class CustomMetric(EvalMetric):
    """Metric from a python function feval(label, pred) (parity: CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = label.asnumpy()
            pred = pred.asnumpy()
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (parity: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_CREATORS = {
    "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
    "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
    "top_k_accuracy": TopKAccuracy, "top_k_acc": TopKAccuracy,
    "perplexity": Perplexity, "loss": Loss, "torch": Torch,
}


def create(metric, **kwargs):
    """Create a metric by name/callable/list (parity: metric.create)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    if isinstance(metric, string_types):
        try:
            return _CREATORS[metric.lower()](**kwargs)
        except KeyError:
            raise MXNetError("unknown metric %s" % metric)
    raise MXNetError("invalid metric spec %r" % (metric,))
