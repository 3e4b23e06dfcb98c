"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for one NVIDIA H100.

The same Symbol / NDArray / Executor / Predictor / ServedModel API, symbol
JSON and ``.params`` format, and ``MXNET_*`` knobs as the JAX package, on
``torch`` tensors.  The TPU's Pallas kernels become hand-written Hopper
kernels (``ops/norm_conv.py`` + ``csrc/norm_conv.cu``).  Entry points run on
``gpu(0)`` unless the caller asks for ``cpu()``.

This slice ports ResNet-50 inference and serving.
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

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context", "nd",
           "ndarray", "sym", "symbol", "Variable", "executor", "Predictor",
           "predictor", "serving", "convert", "models", "ops"]
