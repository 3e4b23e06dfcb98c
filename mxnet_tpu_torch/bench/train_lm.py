"""The decoder-only transformer LM on a synthetic bigram corpus (the port's
twin of ``examples/train_lm.py``, with its options):

    python -m mxnet_tpu_torch.bench.train_lm                     # the card
    python -m mxnet_tpu_torch.bench.train_lm --cpu --steps 20 --seq-len 64
    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.bench.train_lm --sequence-parallel 2

The same symbol graph runs through the attention ladder: short T the plain
attention, T >= 512 on the card the flash kernel, and with
``--sequence-parallel N`` ring attention over an ``sp`` mesh of the N ranks
the launcher started (``parallel.mesh.set_sequence_mesh``; every rank runs
the same step on the same batch and only the attention op is split).
Training is ``TrainStep.run_steps`` with Adam, chunks of ``--chunk + 1``
steps on one batch drawn from windows of the corpus (the example's
arithmetic, so a perplexity floor near 4: each token has 4 likely
successors).  Prints a line a chunk and, last, one JSON line: the
perplexity after each chunk, tokens/s, ms a step, the ring's messages a
step and the trained parameters' sha256 (the ranks' agree: the step
averages the sequence replicas' gradients).  Exits 0 when the final
perplexity is below vocab / 4, as the example does.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.bench import tp_sp_ladder
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel import mesh as pmesh


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-hidden", type=int, default=128)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--chunk", type=int, default=9,
                   help="steps a run_steps call beyond its first")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--sequence-parallel", type=int, default=0,
                   help="split the sequence over this many ranks (ring "
                        "attention); 0 = off")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host (default: the card)")
    return p.parse_args(argv)


def bigram_corpus(vocab, n_tokens, seed=0):
    """The example's corpus: each token has 4 likely successors."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab, (vocab, 4))
    toks = np.empty(n_tokens, np.int64)
    toks[0] = 0
    choices = rng.randint(0, 4, n_tokens)
    for i in range(1, n_tokens):
        toks[i] = succ[toks[i - 1], choices[i]]
    return toks


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    T, B = args.seq_len, args.batch_size
    ctx = mt.cpu() if args.cpu else mt.gpu(0)
    if args.cpu:
        torch.set_num_threads(1)
    n = args.sequence_parallel
    if n:
        dist.init_process_group()
        if dist.num_workers() != n:
            raise mt.MXNetError(
                "--sequence-parallel %d needs a world of %d ranks (python -m "
                "mxnet_tpu_torch.launch -n %d ...), got %d"
                % (n, n, n, dist.num_workers()))
        pmesh.set_sequence_mesh(pmesh.make_mesh({"sp": n}))
        logging.info("ring attention over sp=%d ranks", n)
    net = mt.models.transformer.get_symbol(
        vocab_size=args.vocab, seq_len=T, num_layers=args.num_layers,
        num_hidden=args.num_hidden, num_heads=args.num_heads)
    ts = mt.TrainStep(net, mt.optimizer.Adam(learning_rate=args.lr),
                      ctx=ctx)
    params, state, aux = ts.init({"data": (B, T)}, {"softmax_label": (B, T)})
    toks = bigram_corpus(args.vocab, B * (T + 1) * 8)
    windows = toks[:B * 8 * (T + 1)].reshape(B * 8, T + 1)
    logging.info("training %d steps (chunks of %d) ...", args.steps,
                 args.chunk + 1)
    dist.reset_collectives()
    t0 = time.time()
    done, ppls = 0, []
    while done < args.steps:
        sel = np.random.RandomState(done).randint(0, windows.shape[0], B)
        x = windows[sel, :-1].astype(np.float32)
        y = windows[sel, 1:].astype(np.float32)
        bd = ts.shard_batch({"data": x, "softmax_label": y})
        params, state, aux, outs = ts.run_steps(params, state, aux, bd,
                                                args.chunk)
        done += args.chunk + 1
        probs = outs[0].float().cpu().numpy().reshape(B, T, args.vocab)
        picked = np.take_along_axis(
            probs, y.astype(int)[..., None], axis=2)[..., 0]
        ppl = float(np.exp(-np.log(np.clip(picked, 1e-9, 1)).mean()))
        ppls.append(ppl)
        logging.info("step %d: train ppl %.2f (%.1f tok/s)", done, ppl,
                     done * B * T / (time.time() - t0))
    secs = time.time() - t0
    pmesh.set_sequence_mesh(None)
    logging.info("final train perplexity: %.2f (floor ~4 for this corpus)",
                 ppl)
    print(json.dumps({
        "rank": dist.rank() if n else 0, "sequence_parallel": n,
        "perplexity": ppls, "steps": done,
        "tokens_per_s": done * B * T / secs, "ms_per_step": secs / done * 1e3,
        # the trained parameters' digest: the sp replicas' agree
        "params_sha256": tp_sp_ladder.digest(torch, params).hex(),
        "collectives_per_step": {k: v / done for k, v in
                                 dist.collective_calls.items()}}),
        flush=True)
    if n:
        dist.barrier()
        dist.shutdown_process_group()
    return 0 if ppl < args.vocab / 4 else 1


if __name__ == "__main__":
    sys.exit(main())
