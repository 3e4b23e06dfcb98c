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
``module.BucketingModule``), the SSD slice, the imperative entry point:
``mx.nd`` ops and views, the optimizers' ``update`` and ``Updater``, and
``rtc``; and the single-process parallel slice: ``group2ctx`` model
parallelism (``AttrScope(ctx_group=...)``, ``_CrossDeviceCopy``), the
``local`` and ``device`` ``kvstore`` and ``Module`` over several contexts;
the observability slice's first half: ``telemetry`` (spans, counters,
gauges, histograms, scalars, the JSON-lines sink), ``profiler`` (the
chrome trace, with a ``torch.profiler`` trace of the card beside it),
``engine`` (``MXNET_ENGINE_TYPE=NaiveEngine``), ``monitor.Monitor`` and
``cost`` (MFU against the card's peaks); the custom-op bridge
(``operator.CustomOp``/``CustomOpProp``, the ``Custom`` op), the rest of
the symbol frontend (``Symbol.attr``/``eval``/``debug_str``, backward shape
rules, ``name.Prefix``) and the VGG and Inception-v3 symbols; the image
slice: ``recordio``, ``image`` (decode, augmenters, ``ImageIter`` and the
threaded ``ImageRecordIter``), ``module.SequentialModule`` and the Python
modules, ``visualization`` and ``test_utils``; the distributed slice's
first part: ``parallel.dist`` (the multi-process runtime on
``torch.distributed``), ``launch`` (``python -m mxnet_tpu_torch.launch -n
N``), the ``dist*`` kvstores, ``checkpoint`` (sharded checkpoints in the
JAX package's format) and ``parallel.elastic`` (``fit_elastic``).
"""
from .base import MXNetError
from . import telemetry
from . import engine
from . import profiler
from .context import Context, cpu, gpu, tpu, cpu_pinned, current_context
from . import ndarray
from . import ndarray as nd
from . import ops
from . import symbol
from . import symbol as sym
from .symbol import Variable, Group
from . import executor
from .executor import Executor
from .attribute import AttrScope
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
from . import optimizer as opt
from . import name
from . import operator
from . import rtc
from . import amp
from . import train
from .train import TrainStep, EvalStep
from . import io
from . import metric
from . import callback
from . import kvstore
from . import kvstore as kv
from . import model
from . import checkpoint
from . import parallel
from . import module
from . import module as mod
from .module import Module
from . import rnn
from . import cost
from . import monitor
from .monitor import Monitor
from . import recordio
from . import image
from . import visualization
from . import visualization as viz
from . import test_utils

__all__ = ["MXNetError", "telemetry", "engine", "profiler", "cost",
           "monitor", "Monitor", "Context", "cpu", "gpu", "tpu",
           "current_context", "nd",
           "ndarray", "sym", "symbol", "Variable", "Group", "executor",
           "Executor", "AttrScope", "kvstore", "kv", "Predictor",
           "predictor", "serving", "convert", "models", "ops", "random",
           "lr_scheduler", "initializer", "init", "optimizer", "opt", "name",
           "operator", "rtc", "amp",
           "train", "TrainStep", "EvalStep", "io", "metric", "callback",
           "model", "module", "mod", "Module", "rnn", "recordio", "image",
           "visualization", "viz", "test_utils"]
