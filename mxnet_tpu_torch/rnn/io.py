"""Bucketed sentence iterator (counterpart: mxnet_tpu/rnn/io.py).

Batches are CPU NDArrays, as every iterator's of the port; the Module moves
them to its card.  The walk order comes from ``random.shuffle`` (the bucket
windows) and ``np.random.shuffle`` (the rows of each bucket), the JAX
package's own calls, so seeding both gives both packages one order."""
from __future__ import annotations

import bisect
import random

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .. import ndarray as nd
from ..io import DataBatch, DataIter, DataDesc

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0):
    """Map token sequences to integer-id sequences (parity:
    encode_sentences).

    With ``vocab=None`` a fresh vocabulary is grown on the fly: ids are
    handed out in first-appearance order starting at ``start_label``, the
    padding token ``invalid_key`` is pinned to ``invalid_label``, and the
    counter skips over ``invalid_label`` so no real token collides with the
    padding id.  With a caller-supplied vocab, unseen tokens are an error.
    """
    growable = vocab is None
    if growable:
        vocab = {invalid_key: invalid_label}
    next_id = start_label

    def assign(token):
        nonlocal next_id
        known = vocab.get(token)
        if known is not None:
            return known
        if not growable:
            raise MXNetError("token %r not in the supplied vocabulary"
                             % (token,))
        if next_id == invalid_label:
            next_id += 1          # keep the padding id unique
        vocab[token] = next_id
        next_id += 1
        return vocab[token]

    encoded = [[assign(tok) for tok in sentence] for sentence in sentences]
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator over variable-length sequences (parity:
    BucketSentenceIter): each batch is one bucket's window of
    ``batch_size`` rows padded with ``invalid_label``, with its
    ``bucket_key`` and its own ``provide_data`` / ``provide_label``."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__()
        if not buckets:
            buckets = [i for i, j in enumerate(np.bincount(
                [len(s) for s in sentences]))
                if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # drop buckets that received no sentences (an empty bucket has no
        # 2-D array shape and can never produce a batch)
        kept = [i for i, b in enumerate(self.data) if b]
        if not kept:
            raise ValueError(
                "BucketSentenceIter: no sentence fits any bucket %s "
                "(%d sentences discarded as too long)" % (buckets, ndiscard))
        buckets = [buckets[i] for i in kept]
        self.data = [np.asarray(self.data[i], dtype=dtype) for i in kept]
        if ndiscard:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % ndiscard)
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: Must by NT (batch major) or"
                             " TN (time major)" % layout)

        def desc_shape(t):
            return (batch_size, t) if self.major_axis == 0 else (t, batch_size)
        # the descriptor carries the layout so consumers (the Module,
        # downstream modules) can find the batch axis of TN-major batches
        self.provide_data = [DataDesc(data_name,
                                      desc_shape(self.default_bucket_key),
                                      layout=layout)]
        self.provide_label = [DataDesc(label_name,
                                       desc_shape(self.default_bucket_key),
                                       layout=layout)]
        # the walk order: every full batch window of every bucket
        self.idx = [(b, start)
                    for b, rows in enumerate(self.data)
                    for start in range(0, len(rows) - batch_size + 1,
                                       batch_size)]
        self.curr_idx = 0
        self.reset()

    def reset(self):
        """Reshuffle windows and rows and rebuild the arrays with next-token
        labels (each label row is its data row shifted left by one, closed
        with the padding id: the LM's training target)."""
        self.curr_idx = 0
        random.shuffle(self.idx)
        for rows in self.data:
            np.random.shuffle(rows)
        self.nddata, self.ndlabel = [], []
        for rows in self.data:
            targets = np.roll(rows, -1, axis=1)
            targets[:, -1] = self.invalid_label
            self.nddata.append(nd.array(rows, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(nd.array(targets, ctx=cpu(),
                                         dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        b, start = self.idx[self.curr_idx]
        self.curr_idx += 1
        window = slice(start, start + self.batch_size)
        data, label = self.nddata[b][window], self.ndlabel[b][window]
        if self.major_axis == 1:     # time-major: transpose the window
            data = nd.array(data.asnumpy().T, ctx=cpu())
            label = nd.array(label.asnumpy().T, ctx=cpu())
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[b],
                         provide_data=[DataDesc(self.data_name, data.shape)],
                         provide_label=[DataDesc(self.label_name,
                                                 label.shape)])
