"""The bucketed LSTM language model trained through ``BucketingModule.fit``
(the port's twin of ``examples/lstm_bucketing.py``), at the published
widths of MXNet's ``example/rnn/lstm_bucketing.py`` and its
``cudnn_lstm_bucketing.py`` twin.

    python -m mxnet_tpu_torch.bench.lstm_bucketing --cell fused
    python -m mxnet_tpu_torch.bench.lstm_bucketing --cell lstm

The model: an embedding of 200, two LSTM layers of 200, a FullyConnected
head over the vocabulary and ``SoftmaxOutput``; PTB's 10,000 words plus the
invalid label 0; batch 32; buckets 10, 20, ..., 60; SGD with lr 0.01,
momentum 0 and wd 1e-5 (``rescale_grad`` 1 / batch, as ``init_optimizer``
sets it); ``Xavier(factor_type="in", magnitude=2.34)``; the metric
``Perplexity(0)``.  ``--cell fused`` unrolls one
``FusedRNNCell(num_layers=2)`` (the ``RNN`` op: one cuDNN call a layer on
the card), ``--cell lstm`` a ``SequentialRNNCell`` of ``LSTMCell``s (per
step FullyConnected, SliceChannel and Activation nodes).

The corpus is synthetic (PTB's text is not in the repository): the
example's Markov chain (next word (w * 3 + 1) mod V with probability 0.9,
else uniform) over the 10,000 words, with sentence lengths drawn from
``RandomState(seed)`` uniformly over 2-60, so that every bucket fills, and
enough sentences for ``--batches-per-bucket`` batches in each bucket.

Runs on ``gpu(0)`` (``--cpu`` for a toy run; ``--num-hidden`` and
``--vocab`` shrink it).  Prints one JSON line a fit: tokens per second
(the labels that are not padding) in steady state (``value``: the batches
after each epoch's first, over the gaps between their batch ends) and over
the fit's wall time with its set-up (binding each bucket, the first use of
cuDNN and cuBLAS in a fresh process), host ms per batch by bucket (the
median gap between batch ends), each epoch's
training perplexity, the device-busy share and the device ms by kernel
group of a profiled pass over one batch of each bucket, peak memory,
``rnn_op.cudnn_calls`` of the fit, and the card's name and power limit.
"""
import argparse
import json
import logging
import random
import subprocess
import sys
import time

import numpy as np
import torch

BUCKETS = (10, 20, 30, 40, 50, 60)
WIDTHS = dict(num_layers=2, num_hidden=200, num_embed=200, words=10000)
BATCH = 32
INVALID_LABEL = 0
OPTIMIZER_PARAMS = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}


def synthetic_corpus(words=10000, batches_per_bucket=4, batch=BATCH,
                     buckets=BUCKETS, seed=0):
    """Markov-chain sentences over word ids 1..``words`` (0 is the padding
    id) with lengths uniform over 2..max(buckets), as many as give every
    bucket ``batches_per_bucket`` batches."""
    rs = np.random.RandomState(seed)
    counts = dict.fromkeys(buckets, 0)
    need = batches_per_bucket * batch
    sents = []
    while min(counts.values()) < need:
        length = rs.randint(2, max(buckets) + 1)
        w = rs.randint(1, words + 1)
        sent = [w]
        for _ in range(length - 1):
            w = (w * 3 + 1) % words + 1 if rs.rand() < 0.9 \
                else rs.randint(1, words + 1)
            sent.append(w)
        sents.append(np.array(sent, np.float32))
        counts[min(b for b in buckets if b >= length)] += 1
    return sents


def make_cell(mt, cell, num_layers, num_hidden):
    if cell == "fused":
        return mt.rnn.FusedRNNCell(num_hidden, num_layers=num_layers,
                                   mode="lstm", prefix="lstm_")
    stack = mt.rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(mt.rnn.LSTMCell(num_hidden=num_hidden,
                                  prefix="lstm_l%d_" % i))
    return stack


def make_sym_gen(mt, cell, vocab_size, num_embed, num_hidden):
    """The example's ``sym_gen``: embedding, the unrolled cell, the head."""
    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data=data, input_dim=vocab_size,
                                 output_dim=num_embed, name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mt.sym.FullyConnected(data=pred, num_hidden=vocab_size,
                                     name="pred")
        label = mt.sym.Reshape(label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def card_name():
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return "nvidia-smi: %s" % exc


# kernel-name pieces (lower case) of each group of the device breakdown,
# first match wins
GROUPS = (("rnn", ("rnn", "lstm")), ("gemm", ("gemm", "cutlass", "xmma")),
          ("softmax", ("softmax",)),
          ("embedding", ("embedding", "index", "scatter", "gather")))


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_share(mod, batches, dev):
    """(device-busy share, kernel launches, {group: device ms}) of one
    forward, backward and update per batch, profiled: the kernels' summed
    time over the wall time of the pass (the profiler's own host cost
    included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            mod.forward_backward(b)
            mod.update()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total * 1e-3
    return busy_us * 1e-6 / wall, sum(e.count for e in kernels), groups


def run(cell="fused", epochs=2, batches_per_bucket=4, ctx=None,
        num_layers=WIDTHS["num_layers"], num_hidden=WIDTHS["num_hidden"],
        num_embed=WIDTHS["num_embed"], words=WIDTHS["words"], batch=BATCH,
        buckets=BUCKETS, seed=0):
    """One fit of the bucketed LM: (record dict, BucketingModule, iterator,
    sym_gen).  The iterator's walk and the initializer draw from ``seed``
    (``random``, ``np.random`` and the port's generators)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import rnn_op
    ctx = ctx if ctx is not None else mt.gpu(0)
    dev = ctx.torch_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    random.seed(seed)
    np.random.seed(seed)
    mt.random.seed(seed)
    vocab_size = words + 1
    it = mt.rnn.BucketSentenceIter(
        synthetic_corpus(words, batches_per_bucket, batch, buckets, seed),
        batch, buckets=list(buckets), invalid_label=INVALID_LABEL)
    sym_gen = make_sym_gen(mt, make_cell(mt, cell, num_layers, num_hidden),
                           vocab_size, num_embed, num_hidden)
    mod = mt.module.BucketingModule(sym_gen,
                                    default_bucket_key=it.default_bucket_key,
                                    context=ctx)
    gaps = {}
    perplexity = []
    tokens = [0, 0]          # every batch's, the steady batches'
    last = [None]

    def batch_end(param):
        now = time.perf_counter()
        b = param.locals["data_batch"]
        n = int((b.label[0].asnumpy() != INVALID_LABEL).sum())
        tokens[0] += n
        if last[0] is not None:
            gaps.setdefault(b.bucket_key, []).append((now - last[0]) * 1e3)
            tokens[1] += n
        last[0] = now

    def epoch_end(epoch, symbol, arg, aux):
        perplexity.append(metric.get()[1])
        last[0] = None              # the epoch's end work is not a batch
    metric = mt.metric.Perplexity(INVALID_LABEL)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)       # the card's context first
        torch.cuda.reset_peak_memory_stats(dev)
    calls = rnn_op.cudnn_calls
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=epochs, eval_metric=metric, optimizer="sgd",
            optimizer_params=dict(OPTIMIZER_PARAMS),
            initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
            batch_end_callback=batch_end, epoch_end_callback=epoch_end)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    calls = rnn_op.cudnn_calls - calls
    steady_s = sum(sum(v) for v in gaps.values()) * 1e-3
    rec = {
        "metric": "lstm_bucketing_tokens_per_sec_b%d" % batch,
        "cell": cell, "value": tokens[1] / steady_s, "unit": "tokens/s",
        "fit_tokens_per_s": tokens[0] / seconds, "fit_seconds": seconds,
        "epochs": epochs, "tokens": tokens[0],
        "batches": sum(len(v) for v in gaps.values()) + epochs,
        "host_ms_per_batch": {str(k): float(np.median(v))
                              for k, v in sorted(gaps.items())},
        "train_perplexity": perplexity,
        "cudnn_calls": calls,
        "buckets_bound": sorted(mod._buckets),
        "config": {"num_layers": num_layers, "num_hidden": num_hidden,
                   "num_embed": num_embed, "vocab_size": vocab_size,
                   "batch": batch, "buckets": list(buckets),
                   "batches_per_bucket": batches_per_bucket,
                   "optimizer": "sgd", "optimizer_params": OPTIMIZER_PARAMS,
                   "device": str(dev)}}
    if dev.type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["card"] = card_name()
        it.reset()
        one = {}
        for b in it:
            one.setdefault(b.bucket_key, b)
        (rec["device_busy_share"], rec["profiled_launches"],
         rec["device_ms_by_group"]) = busy_share(
             mod, [one[k] for k in sorted(one)], dev)
    return rec, mod, it, sym_gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("fused", "lstm"), default="fused")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batches-per-bucket", type=int, default=4)
    ap.add_argument("--num-hidden", type=int, default=WIDTHS["num_hidden"])
    ap.add_argument("--vocab", type=int, default=WIDTHS["words"],
                    help="words, besides the invalid label 0")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (a toy run at small widths)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import mxnet_tpu_torch as mt
    rec, _, _, _ = run(args.cell, args.epochs, args.batches_per_bucket,
                       mt.cpu() if args.cpu else None,
                       num_hidden=args.num_hidden, num_embed=args.num_hidden,
                       words=args.vocab)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
