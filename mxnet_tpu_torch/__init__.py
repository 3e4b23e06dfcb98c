"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for one NVIDIA H100.

The same Symbol / NDArray / Executor / Predictor / ServedModel API, symbol
JSON and ``.params`` format, and ``MXNET_*`` knobs as the JAX package, on
``torch`` tensors.  The TPU's Pallas kernels become hand-written Hopper
kernels (``ops/norm_conv.py`` + ``csrc/norm_conv.cu``,
``ops/flash_attention.py`` + ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``), and ``rtc.Rtc`` compiles a user's CUDA C
kernel for the card.  Entry points run on ``gpu(0)`` unless the caller asks
for ``cpu()``.

Ported so far: ResNet-50 inference and serving, the transformer LM's
inference, its training through ``train.TrainStep`` (ResNet-50 too, in
float32 or under an ``amp.Policy``) and through ``Module.fit`` (with the
data iterators, metrics, callbacks and checkpoints of ``io``, ``metric``,
``callback`` and ``model``), the sequences slice (the ``RNN`` op, cuDNN on
the card; the sequence ops; the ``rnn`` cells and ``BucketSentenceIter``;
``module.BucketingModule``), and the imperative entry point: ``mx.nd`` ops
and views, the optimizers' ``update`` and ``Updater``, and ``rtc``.
"""
from .base import MXNetError
from .context import Context, cpu, gpu, current_context
from . import ndarray
from . import ndarray as nd
from . import ops
from . import symbol
from . import symbol as sym
from .symbol import Variable
from . import executor
from . import predictor
from .predictor import Predictor
from . import serving
from . import convert
from . import models
from . import random
from . import lr_scheduler
from . import initializer
from . import initializer as init
from . import optimizer
from . import rtc
from . import amp
from . import train
from .train import TrainStep, EvalStep
from . import io
from . import metric
from . import callback
from . import model
from . import module
from . import module as mod
from .module import Module
from . import rnn

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context", "nd",
           "ndarray", "sym", "symbol", "Variable", "executor", "Predictor",
           "predictor", "serving", "convert", "models", "ops", "random",
           "lr_scheduler", "initializer", "init", "optimizer", "rtc", "amp",
           "train", "TrainStep", "EvalStep", "io", "metric", "callback",
           "model", "module", "mod", "Module", "rnn"]
