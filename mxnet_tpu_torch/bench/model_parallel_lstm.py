"""The model-parallel LSTM (BASELINE #5) trained through an ``Executor``
bound with ``group2ctx``: the port's twin of
``examples/model_parallel_lstm.py``, at the published widths of MXNet's
``example/model-parallel-lstm/lstm_ptb.py``.

    python -m mxnet_tpu_torch.bench.model_parallel_lstm                 # card
    python -m mxnet_tpu_torch.bench.model_parallel_lstm --devices gpu0,cpu
    python -m mxnet_tpu_torch.bench.model_parallel_lstm --cpu \\
        --num-layers 2 --num-hidden 32 --num-embed 32 --vocab-size 40

The model (``lstm_unroll``): an embedding, ``num_layers`` ``rnn.LSTMCell``
layers unrolled over ``seq_len`` steps, each layer in its ``ctx_group``
(``layer%d``), the embedding in ``embed`` and the head (Concat,
FullyConnected over the vocabulary, ``SoftmaxOutput``) in ``decode``.
``lstm_ptb.py``'s widths are the defaults: 8 layers of 400, an embedding
of 200, ``seq_len`` 35, batch 20, PTB's 10,000 words.  ``group2ctx``
follows the reference's placement plan over the ``--devices`` list
(``ngpu`` of them): ``embed`` on the first, ``decode`` on the last, layer
``i`` on device ``i * ngpu // num_layers``.

The loop is the JAX example's: ``Xavier(magnitude=2)``, SGD at ``--lr``
with ``rescale_grad`` 1 / (batch x seq_len) through ``optimizer.Updater``,
``Perplexity``, and its synthetic next-token task (y = (3 x + 1) mod V),
since PTB's text is not in the repository.  The example draws x uniformly
over 1..V-1 (``--corpus uniform``); by default x follows a Zipf law over
the words (``--corpus zipf``), as a text's words roughly do: over 10,000
uniform words a batch of 700 tokens sees each word 0.07 times, and the
perplexity cannot move in a few batches, while a Zipf corpus has a
unigram distribution for the head to learn.  There is no dropout (the JAX
example has none; ``lstm_ptb.py``'s is 0.5).

Prints one JSON line: tokens per second over the batches after
``--warmup`` (the mean gap between batch ends), host ms a batch (their
median), ``executor.cross_device_copies`` a batch, the perplexity of each
window of ``--window`` batches, the device-busy share of a profiled batch
when a card takes part, and the card's name and power limit.
"""
import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from .lstm_bucketing import card_name

WIDTHS = dict(num_layers=8, num_hidden=400, num_embed=200, seq_len=35,
              batch_size=20, vocab_size=10000)
INPUTS = ("data", "softmax_label")


def lstm_unroll(mt, num_layers, seq_len, input_size, num_hidden, num_embed,
                vocab_size, group_of_layer, embed_group=None,
                decode_group=None):
    """The JAX example's unrolled multi-layer LSTM, each layer in the
    ``ctx_group`` ``group_of_layer(i)``; the embedding (with the data and
    label variables) in ``embed_group`` and the head in ``decode_group``,
    by default the first and the last layer's groups, as in the example."""
    embed_group = embed_group or group_of_layer(0)
    decode_group = decode_group or group_of_layer(num_layers - 1)
    cells = []
    for i in range(num_layers):
        with mt.AttrScope(ctx_group=group_of_layer(i)):
            cells.append(mt.rnn.LSTMCell(num_hidden=num_hidden,
                                         prefix="lstm_l%d_" % i))
    with mt.AttrScope(ctx_group=embed_group):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data=data, input_dim=input_size,
                                 output_dim=num_embed, name="embed")
        outputs = mt.sym.SliceChannel(embed, num_outputs=seq_len,
                                      squeeze_axis=True)
    for i, cell in enumerate(cells):
        with mt.AttrScope(ctx_group=group_of_layer(i)):
            cell.reset()
            new_outputs = []
            states = cell.begin_state()
            for t in range(seq_len):
                out, states = cell(outputs[t], states)
                new_outputs.append(out)
            outputs = new_outputs
    with mt.AttrScope(ctx_group=decode_group):
        concat = mt.sym.Concat(*[mt.sym.expand_dims(o, axis=1)
                                 for o in outputs], dim=1)
        pred = mt.sym.Reshape(concat, shape=(-1, num_hidden))
        pred = mt.sym.FullyConnected(data=pred, num_hidden=vocab_size,
                                     name="pred")
        label_r = mt.sym.Reshape(label, shape=(-1,))
        sm = mt.sym.SoftmaxOutput(data=pred, label=label_r, name="softmax")
    return sm


def model(mt, num_layers=WIDTHS["num_layers"],
          seq_len=WIDTHS["seq_len"], num_hidden=WIDTHS["num_hidden"],
          num_embed=WIDTHS["num_embed"], vocab_size=WIDTHS["vocab_size"]):
    """The bench's graph: groups ``embed``, ``layer%d`` and ``decode``."""
    return lstm_unroll(mt, num_layers, seq_len, vocab_size, num_hidden,
                       num_embed, vocab_size, lambda i: "layer%d" % i,
                       "embed", "decode")


def placement(devices, num_layers):
    """The reference's placement plan over ``devices`` (ngpu of them)."""
    ngpu = len(devices)
    plan = {"embed": devices[0], "decode": devices[ngpu - 1]}
    for i in range(num_layers):
        plan["layer%d" % i] = devices[i * ngpu // num_layers]
    return plan


def parse_devices(mt, spec):
    """``"gpu0,cpu"`` -> [gpu(0), cpu(0)]."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        kind = item.rstrip("0123456789")
        out.append(mt.Context(kind, int(item[len(kind):] or 0)))
    return out


def init_state(mt, net, batch_size, seq_len, seed=0):
    """{name: float32 numpy array} of every parameter: the example's
    ``Xavier(magnitude=2.0)`` on the host, from ``seed``."""
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(batch_size, seq_len), softmax_label=(batch_size, seq_len))[0]))
    mt.random.seed(seed)
    np.random.seed(seed)
    init = mt.init.Xavier(magnitude=2.0)
    state = {}
    for name in sorted(shapes):
        if name in INPUTS:
            continue
        arr = mt.nd.zeros(shapes[name], ctx=mt.cpu())
        init(mt.init.InitDesc(name), arr)
        state[name] = arr.asnumpy()
    return state


def synthetic_batch(rs, batch_size, seq_len, vocab_size, corpus="zipf"):
    """The JAX example's next-token task, y = (3 x + 1) mod V: (x, y)
    float32 numpy arrays.  ``corpus`` "uniform" draws x uniformly over
    1..V-1, as the example does; "zipf" draws word k with probability
    proportional to 1 / k, as a text's words roughly are."""
    shape = (batch_size, seq_len)
    if corpus == "uniform":
        x = rs.randint(1, vocab_size, shape)
    else:
        p = 1.0 / np.arange(1, vocab_size)
        x = rs.choice(np.arange(1, vocab_size), size=shape, p=p / p.sum())
    x = x.astype(np.float32)
    return x, (x * 3 + 1) % vocab_size


class Trainer(object):
    """An executor of ``net`` bound with ``group2ctx`` (``simple_bind``
    on ``ctx``), loaded with ``state``, and the example's SGD
    ``Updater``."""

    def __init__(self, mt, net, ctx, group2ctx, state, batch_size, seq_len,
                 lr=0.2, dtype=np.float32):
        types = {n: dtype for n in net.list_arguments() if n not in INPUTS}
        self.ex = net.simple_bind(ctx, grad_req="write", type_dict=types,
                                  group2ctx=group2ctx,
                                  data=(batch_size, seq_len),
                                  softmax_label=(batch_size, seq_len))
        self.ex.copy_params_from(state)
        self.opt = mt.optimizer.SGD(learning_rate=lr,
                                    rescale_grad=1.0 / (batch_size
                                                        * seq_len))
        self.updater = mt.optimizer.get_updater(self.opt)
        self.names = net.list_arguments()

    def load(self, x, y):
        self.ex.arg_dict["data"][:] = x
        self.ex.arg_dict["softmax_label"][:] = y

    def step(self):
        """forward(is_train=True), backward() and one Updater pass, as the
        example's loop runs them."""
        ex = self.ex
        ex.forward(is_train=True)
        ex.backward()
        for i, name in enumerate(self.names):
            if name not in INPUTS:
                self.updater(i, ex.grad_dict[name], ex.arg_dict[name])


def busy_share(fn, reps=1):
    """(device-busy share, kernel launches) of ``reps`` calls of ``fn``,
    profiled: the kernels' summed time over the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    return busy_us * 1e-6 / wall, sum(e.count for e in kernels)


def train(mt, trainer, num_batches, batch_size, seq_len, vocab_size,
          seed=0, window=10, corpus="zipf"):
    """The example's loop over ``num_batches`` synthetic batches: (batch
    end times, perplexity of each window of ``window`` batches, copies of
    each batch)."""
    from mxnet_tpu_torch import executor as exm
    rs = np.random.RandomState(seed)
    metric = mt.metric.Perplexity(ignore_label=None)
    ends, ppl, copies = [], [], []
    for b in range(num_batches):
        x, y = synthetic_batch(rs, batch_size, seq_len, vocab_size, corpus)
        before = exm.cross_device_copies
        trainer.load(x, y)
        trainer.step()
        copies.append(exm.cross_device_copies - before)
        metric.update([mt.nd.array(y.reshape(-1), ctx=mt.cpu())],
                      [trainer.ex.outputs[0]])
        ends.append(time.perf_counter())
        if (b + 1) % window == 0 or b + 1 == num_batches:
            ppl.append(metric.get()[1])
            metric.reset()
    return ends, ppl, copies


def run(devices, num_batches=30, warmup=2, lr=0.2, seed=0, corpus="zipf",
        window=10, **widths):
    """Bind, initialise from ``seed`` and train: the record of one run."""
    import mxnet_tpu_torch as mt
    w = dict(WIDTHS)
    w.update(widths)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = model(mt, w["num_layers"], w["seq_len"], w["num_hidden"],
                w["num_embed"], w["vocab_size"])
    state = init_state(mt, net, w["batch_size"], w["seq_len"], seed)
    plan = placement(devices, w["num_layers"])
    trainer = Trainer(mt, net, devices[0], plan, state, w["batch_size"],
                      w["seq_len"], lr)
    ends, ppl, copies = train(mt, trainer, num_batches, w["batch_size"],
                              w["seq_len"], w["vocab_size"], seed, window,
                              corpus)
    gaps = np.diff(ends[warmup:]) * 1e3
    card = any(d.device_type == "gpu" for d in devices)
    rec = {
        "metric": "model_parallel_lstm_tokens_per_sec",
        "value": w["batch_size"] * w["seq_len"] / (gaps.mean() * 1e-3)
        if len(gaps) else None, "unit": "tokens/s",
        "host_ms_per_batch": float(np.median(gaps)) if len(gaps) else None,
        "cross_device_copies_per_batch": copies[-1],
        "perplexity_per_window": ppl, "window": window, "corpus": corpus,
        "devices": [str(d) for d in devices],
        "group2ctx": {g: str(c) for g, c in sorted(plan.items())},
        "config": dict(w, num_batches=num_batches, warmup=warmup, lr=lr)}
    if card:
        rec["device_busy_share"], rec["profiled_launches"] = busy_share(
            trainer.step)
        rec["card"] = card_name()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-layers", type=int, default=WIDTHS["num_layers"])
    ap.add_argument("--num-hidden", type=int, default=WIDTHS["num_hidden"])
    ap.add_argument("--num-embed", type=int, default=WIDTHS["num_embed"])
    ap.add_argument("--seq-len", type=int, default=WIDTHS["seq_len"])
    ap.add_argument("--vocab-size", type=int, default=WIDTHS["vocab_size"])
    ap.add_argument("--batch-size", type=int, default=WIDTHS["batch_size"])
    ap.add_argument("--num-batches", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", choices=("zipf", "uniform"), default="zipf")
    ap.add_argument("--window", type=int, default=10,
                    help="batches a perplexity is reported over")
    ap.add_argument("--devices", default="gpu0",
                    help="comma-separated contexts, e.g. gpu0,cpu")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (--devices cpu)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import mxnet_tpu_torch as mt
    devices = parse_devices(mt, "cpu" if args.cpu else args.devices)
    rec = run(devices, args.num_batches, args.warmup, args.lr, args.seed,
              corpus=args.corpus, window=args.window,
              num_layers=args.num_layers, num_hidden=args.num_hidden,
              num_embed=args.num_embed, seq_len=args.seq_len,
              vocab_size=args.vocab_size, batch_size=args.batch_size)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
