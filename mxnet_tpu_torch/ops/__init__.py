"""Operator library of the port (counterpart: mxnet_tpu/ops).

Importing this package registers the ops the ResNet-50 serving path needs.
"""
from . import registry   # noqa: F401

from . import elemwise   # noqa: F401  (_plus, the residual add)
from . import matrix     # noqa: F401  (Reshape, Flatten)
from . import nn         # noqa: F401  (FC, Activation, Conv, Pooling, BN)
from . import loss       # noqa: F401  (SoftmaxOutput)
from . import norm_conv  # noqa: F401  (the NormConv kernel and its guard)
