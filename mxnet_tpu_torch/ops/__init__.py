"""Operator library of the port (counterpart: mxnet_tpu/ops).

Importing this package registers the ops of the ported paths (ResNet-50
inference, the transformer LM's inference and training) before ``symbol.py``
generates its constructors.
"""
from . import registry   # noqa: F401

from . import elemwise   # noqa: F401  (_plus, the residual add)
from . import matrix     # noqa: F401  (Reshape, Flatten, transpose, slice_axis)
from . import nn         # noqa: F401  (FC, Activation, Conv, Pooling, BN)
from . import loss       # noqa: F401  (the loss heads)
from . import norm_conv  # noqa: F401  (the NormConv kernel and its guard)
from . import indexing   # noqa: F401  (Embedding)
from . import attention  # noqa: F401  (dot_product_attention, LayerNorm, ...)
from . import optimizer_ops  # noqa: F401  (sgd/adam/rmsprop updates)
