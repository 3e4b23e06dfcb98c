"""RNN toolkit (counterpart: mxnet_tpu/rnn): the symbolic cells and the
bucketed sentence iterator."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell, FusedRNNCell,
                       SequentialRNNCell, BidirectionalCell, DropoutCell,
                       ZoneoutCell, ResidualCell, ModifierCell, RNNParams)
from .io import BucketSentenceIter, encode_sentences
