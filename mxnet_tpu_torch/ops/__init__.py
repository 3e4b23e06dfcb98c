"""Operator library of the port (counterpart: mxnet_tpu/ops).

Importing this package registers the ops of the ported paths (ResNet-50
inference, the transformer LM's inference and training, the imperative
``mx.nd`` API, the sequences slice, the SSD slice, the operator surface's
``nn``, ordering and ``misc`` ops, the spatial ops, Proposal and CTCLoss,
and ``Custom``) before ``symbol.py``
and ``ndarray.py`` generate their constructors and frontends.
"""
from . import registry   # noqa: F401

from . import elemwise   # noqa: F401  (unary, binary, scalar, add_n, clip)
from . import reduce_ops  # noqa: F401  (sum/mean/max..., argmax, broadcast_to)
from . import init_ops   # noqa: F401  (_zeros, _ones, _full, _arange, ...)
from . import sample_ops  # noqa: F401  (_random_uniform, _random_normal)
from . import matrix     # noqa: F401  (Reshape, transpose, dot, Concat, ...)
from . import nn         # noqa: F401  (FC, Conv, Deconv, Pooling, BN, LRN...)
from . import loss       # noqa: F401  (the loss heads)
from . import norm_conv  # noqa: F401  (the NormConv kernel and its guard)
from . import indexing   # noqa: F401  (Embedding, take, one_hot, where)
from . import attention  # noqa: F401  (dot_product_attention, LayerNorm, ...)
from . import optimizer_ops  # noqa: F401  (sgd/adam/rmsprop updates)
from . import sequence   # noqa: F401  (SequenceLast/Mask/Reverse)
from . import rnn_op     # noqa: F401  (RNN: cuDNN on the card)
from . import contrib    # noqa: F401  (MultiBox*: the NMS kernel on the card)
from . import ordering   # noqa: F401  (topk, sort, argsort)
from . import misc       # noqa: F401  (0-index ops, KL sparse reg, ...)
from . import spatial    # noqa: F401  (Crop, samplers, ROIPooling, ...)
from . import custom     # noqa: F401  (Custom: the user's CustomOp)
