"""Operator library of the port (counterpart: mxnet_tpu/ops).

Importing this package registers the ops of the ported paths (ResNet-50
inference, the transformer LM's inference and training, the imperative
``mx.nd`` API, the sequences slice) before ``symbol.py`` and ``ndarray.py``
generate their constructors and frontends.
"""
from . import registry   # noqa: F401

from . import elemwise   # noqa: F401  (unary, binary, scalar, add_n, clip)
from . import reduce_ops  # noqa: F401  (sum/mean/max..., argmax, broadcast_to)
from . import init_ops   # noqa: F401  (_zeros, _ones, _full, _arange, ...)
from . import sample_ops  # noqa: F401  (_random_uniform, _random_normal)
from . import matrix     # noqa: F401  (Reshape, transpose, dot, Concat, ...)
from . import nn         # noqa: F401  (FC, Activation, Conv, Pooling, BN)
from . import loss       # noqa: F401  (the loss heads)
from . import norm_conv  # noqa: F401  (the NormConv kernel and its guard)
from . import indexing   # noqa: F401  (Embedding, take, one_hot, where)
from . import attention  # noqa: F401  (dot_product_attention, LayerNorm, ...)
from . import optimizer_ops  # noqa: F401  (sgd/adam/rmsprop updates)
from . import sequence   # noqa: F401  (SequenceLast/Mask/Reverse)
from . import rnn_op     # noqa: F401  (RNN: cuDNN on the card)
