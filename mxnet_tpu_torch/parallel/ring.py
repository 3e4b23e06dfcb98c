"""Ring attention over a sequence mesh (counterpart:
mxnet_tpu/parallel/ring.py), and the plain full-sequence attention that is
the ``impl='xla'`` rung of ``dot_product_attention`` and the reference of
the flash kernel's tests.

The JAX package shards the sequence axis of Q/K/V over the ``sp`` mesh axis
inside one ``shard_map``: queries stay put, K/V blocks rotate one hop right
by ``ppermute`` n-1 times, each block folded into the online softmax
(running max ``m``, normaliser ``l``, unnormalised output ``o``, all
float32), and ``jax.vjp`` gives the backward.  Here the ranks of the
mesh's ``sp`` axis run the same replicated step (the rest of the graph is
not sharded, in the JAX package either), so every rank holds the full
(B, H, T, D) inputs.  ``ring_attention`` is one autograd Function:

- forward: rank ``idx`` of ``n`` takes its query block and its own K/V
  block (``sequence_sharding``), folds the block it holds, and passes
  K/V one hop right n-1 times (``dist.ring_exchange`` over point-to-point
  sends: ``2 (n-1)`` sends a rank a call); the last block is folded in
  place.  Causal masking compares global positions; a block wholly above
  the diagonal is skipped, which leaves ``o``, ``m``, ``l`` exactly as
  folding it would (a correction of 1, a sum of 0).  The output blocks are
  all-gathered over ``sp`` into the full output;
- backward: each rank takes its rows of the (replicated) output cotangent,
  recomputes every block's probabilities from its saved Q/K/V blocks (the
  forward keeps this rank's blocks, never the full inputs), ``m`` and ``l``
  and the row sums ``delta = rowsum(dO * O)``, and rotates K/V again with
  dK/dV accumulators that travel with them (``4 (n-1)`` sends a rank).
  After n-1 hops rank ``idx`` holds block ``idx + 1``'s whole dK/dV, so one
  all-gather of (dQ, dK, dV) over ``sp`` and a roll of the dK/dV blocks by
  one give the full gradients on every rank.

Scores and the softmax state are float32 whatever the input dtype, as the
JAX package's ``preferred_element_type=float32``: a product is taken at
the inputs' dtype promoted to float32 at least (bfloat16 inputs exactly in
float32; float64 inputs in float64) and rounded to float32.  A rank's fold
is stock torch matrix products, as the reference's is ``einsum``.  The
messages' tags pack (call, direction, hop, tensor): each call draws its
number from a process counter that every rank advances alike, and its
backward reuses it, so rings of different layers and directions never
match each other's messages; the backward holds no thread-local state, so
autograd's device thread can run it.
"""
from __future__ import annotations

import math
import threading

import torch

from ..base import MXNetError

__all__ = ["ring_attention", "attention_reference", "sequence_sharding",
           "SequenceSharding"]

# message tags: above the pipeline's, (call, direction, hop, tensor)
_TAG_BASE = 1 << 24
_TAG_CALLS = 1 << 12
_MAX_HOPS = 64
_TAG_TENSORS = 4
_calls = [0]
_lock = threading.Lock()


def attention_reference(q, k, v, causal=False, scale=None):
    """softmax(q·kᵀ·scale)·v over (B, H, T, D); the causal mask is -inf above
    the diagonal and the default scale 1/sqrt(D)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", p, v) / p.sum(dim=-1,
                                                         keepdim=True)


class SequenceSharding(object):
    """This rank's share of a sequence split over ``axis`` of a mesh (the
    port's ``sequence_sharding``: the JAX package's is a NamedSharding of
    (B, H, T, D) arrays with T over ``axis``)."""

    def __init__(self, mesh, axis="sp"):
        from . import mesh as _mesh
        if axis not in _mesh.axis_names(mesh):
            raise MXNetError("sequence_sharding: mesh %r has no %r axis"
                             % (_mesh.axis_names(mesh), axis))
        self.axis = axis
        self.size = _mesh.axis_size(mesh, axis)
        self.index = _mesh.axis_rank(mesh, axis)
        self.ranks = _mesh.axis_ranks(mesh, axis)
        self.group = _mesh.axis_group(mesh, axis)

    def block(self, t):
        """The slice of positions ``0..t-1`` this rank owns (``t`` must
        divide by the axis size, as the JAX package's sharding requires)."""
        if t % self.size:
            raise MXNetError(
                "ring attention: a sequence of %d positions over an %r axis "
                "of %d ranks: the global size of its dimension 2 should be "
                "divisible by %d" % (t, self.axis, self.size, self.size))
        tl = t // self.size
        return slice(self.index * tl, (self.index + 1) * tl)


def sequence_sharding(mesh, axis="sp"):
    """This rank's share of a sequence split over ``axis`` of ``mesh``."""
    return SequenceSharding(mesh, axis)


def _tag(seq, back, hop):
    return _TAG_BASE + ((seq * 2 + int(back)) * _MAX_HOPS + hop) \
        * _TAG_TENSORS


def _acc(dtype):
    """The dtype a product of ``dtype`` operands is taken in."""
    return torch.promote_types(dtype, torch.float32)


def _scores(qb, kb, sc):
    """float32 scores of a query block against a key block."""
    acc = _acc(qb.dtype)
    return torch.einsum("bhqd,bhkd->bhqk", qb.to(acc),
                        kb.to(acc)).to(torch.float32) * sc


def _mask(idx, src, tl, device):
    """Causal mask of query block ``idx`` against key block ``src`` over
    global positions (True: kept)."""
    q_pos = idx * tl + torch.arange(tl, device=device)
    k_pos = src * tl + torch.arange(tl, device=device)
    return k_pos[None, :] <= q_pos[:, None]


def _skipped(causal, idx, src):
    """A block wholly above the diagonal (every key after every query)."""
    return causal and src > idx


def _fold(qb, kb, vb, o, m, l, mask, sc):
    """Fold one K/V block into the online softmax (o, m, l)."""
    s = _scores(qb, kb, sc)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    new_m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # an all-masked block gives -inf maxima: keep the math finite
    safe_m = torch.where(torch.isneginf(new_m), torch.zeros_like(new_m),
                         new_m)
    p = torch.exp(s - safe_m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    corr = torch.exp(m - safe_m)
    corr = torch.where(torch.isneginf(m), torch.zeros_like(corr), corr)
    acc = _acc(vb.dtype)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p.to(acc),
                                vb.to(acc)).to(torch.float32)
    return o, new_m, l


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sh, causal, sc):
        from . import dist as _dist
        with _lock:
            seq = _calls[0] % _TAG_CALLS
            _calls[0] += 1
        n, idx = sh.size, sh.index
        blk = sh.block(q.shape[2])
        tl = blk.stop - blk.start
        right, left = sh.ranks[(idx + 1) % n], sh.ranks[(idx - 1) % n]
        qb = q[:, :, blk].contiguous()
        kb, vb = k[:, :, blk].contiguous(), v[:, :, blk].contiguous()
        # the backward reads this rank's blocks only: keep those
        blocks = (qb, kb, vb)
        f32 = torch.float32
        o = torch.zeros(qb.shape, dtype=f32, device=q.device)
        m = torch.full(qb.shape[:3] + (1,), float("-inf"), dtype=f32,
                       device=q.device)
        l = torch.zeros(qb.shape[:3] + (1,), dtype=f32, device=q.device)
        for i in range(n):
            src = (idx - i) % n
            if not _skipped(causal, idx, src):
                mask = _mask(idx, src, tl, q.device) if causal else None
                o, m, l = _fold(qb, kb, vb, o, m, l, mask, sc)
            if i < n - 1:
                # the last block is folded in place: no wasted final hop
                kb, vb = _dist.ring_exchange([kb, vb], right, left,
                                             _tag(seq, False, i))
        ob = o / torch.clamp_min(l, 1e-30)
        out = ob.to(q.dtype)
        if n > 1:
            out = _dist.gather_cat(out, 2, sh.group, n, "sp_all_gather")
        ctx.save_for_backward(*blocks, ob, m, l)
        ctx.args = (sh, causal, sc, seq, q.shape[2])
        return out

    @staticmethod
    def backward(ctx, dout):
        from . import dist as _dist
        q0, kb, vb, ob, m, l = ctx.saved_tensors
        dts = (q0.dtype, kb.dtype, vb.dtype)
        sh, causal, sc, seq, t = ctx.args
        n, idx = sh.size, sh.index
        blk = sh.block(t)
        tl = blk.stop - blk.start
        right, left = sh.ranks[(idx + 1) % n], sh.ranks[(idx - 1) % n]
        f32 = torch.float32
        qb = q0.to(_acc(q0.dtype))
        dob = dout[:, :, blk].to(f32)
        delta = (dob * ob).sum(dim=-1, keepdim=True)
        safe_m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
        inv_l = 1.0 / torch.clamp_min(l, 1e-30)
        dq = torch.zeros(ob.shape, dtype=f32, device=q0.device)
        dkb = torch.zeros(ob.shape, dtype=f32, device=q0.device)
        dvb = torch.zeros(ob.shape, dtype=f32, device=q0.device)
        for i in range(n):
            src = (idx - i) % n
            if not _skipped(causal, idx, src):
                s = _scores(qb, kb, sc)
                p = torch.exp(s - safe_m) * inv_l
                if causal:
                    p = p.masked_fill(~_mask(idx, src, tl, q0.device), 0.0)
                kf, vf = kb.to(f32), vb.to(f32)
                ds = p * (torch.einsum("bhqd,bhkd->bhqk", dob, vf) - delta)
                dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sc
                dkb = dkb + torch.einsum("bhqk,bhqd->bhkd", ds,
                                         qb.to(f32)) * sc
                dvb = dvb + torch.einsum("bhqk,bhqd->bhkd", p, dob)
            if i < n - 1:
                # dK/dV travel with their block
                kb, vb, dkb, dvb = _dist.ring_exchange(
                    [kb, vb, dkb, dvb], right, left, _tag(seq, True, i))
        if n == 1:
            return dq.to(dts[0]), dkb.to(dts[1]), dvb.to(dts[2]), None, \
                None, None
        rows = _dist.all_gather_rows(torch.stack([dq, dkb, dvb]), sh.group,
                                     n, kind="sp_all_gather")
        # rank r holds block r's dQ and block r + 1's dK/dV
        dkv = torch.roll(rows[:, 1:], 1, dims=0)
        grads = [torch.cat(rows[:, 0].unbind(0), dim=2)] + [
            torch.cat(dkv[:, j].unbind(0), dim=2) for j in range(2)]
        return grads[0].to(dts[0]), grads[1].to(dts[1]), \
            grads[2].to(dts[2]), None, None, None


def ring_attention(q, k, v, mesh, axis="sp", causal=False, scale=None):
    """Attention over (B, H, T, D) ``q``, ``k``, ``v`` with the sequence
    split over ``axis`` of ``mesh`` (every rank of the axis passes the full
    tensors and gets the full output; see the module's docstring)."""
    if q.dim() != 4:
        raise MXNetError("ring_attention takes (B, H, T, D) tensors, got "
                         "%r" % (tuple(q.shape),))
    sh = sequence_sharding(mesh, axis)
    if sh.size > _MAX_HOPS:
        raise MXNetError("ring_attention: an %r axis of %d ranks (at most "
                         "%d)" % (axis, sh.size, _MAX_HOPS))
    sh.block(q.shape[2])
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, sh, bool(causal), float(sc))
