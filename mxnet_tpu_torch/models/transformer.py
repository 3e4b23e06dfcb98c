"""Decoder-only transformer language model (counterpart:
mxnet_tpu/models/transformer.py, copied: the same blocks and node names, so
the two packages build the same graph).

Layout: tokens (B, T) -> embedding (B, T, C) -> N blocks of
[LayerNorm -> causal MHA -> residual -> LayerNorm -> MLP -> residual]
-> LayerNorm -> logits (B*T, vocab) -> SoftmaxOutput.
"""
from .. import symbol as sym


def _mha(x, name, seq_len, num_heads, num_hidden, attn_impl=None):
    """Multi-head causal self-attention from FullyConnected/Reshape/
    transpose around ``dot_product_attention``."""
    head = num_hidden // num_heads
    qkv = sym.FullyConnected(x, num_hidden=3 * num_hidden, no_bias=False,
                             name="%s_qkv" % name)           # (B*T, 3C)
    qkv = sym.Reshape(qkv, shape=(-1, seq_len, 3, num_heads, head))
    qkv = sym.transpose(qkv, axes=(2, 0, 3, 1, 4))           # (3,B,H,T,D)
    q = sym.Reshape(sym.slice_axis(qkv, axis=0, begin=0, end=1),
                    shape=(-3, -2), name="%s_q" % name)
    k = sym.Reshape(sym.slice_axis(qkv, axis=0, begin=1, end=2),
                    shape=(-3, -2), name="%s_k" % name)
    v = sym.Reshape(sym.slice_axis(qkv, axis=0, begin=2, end=3),
                    shape=(-3, -2), name="%s_v" % name)
    att = sym.dot_product_attention(q, k, v, causal=True,
                                    name="%s_attn" % name,
                                    **({"impl": attn_impl}
                                       if attn_impl else {}))  # (B,H,T,D)
    att = sym.transpose(att, axes=(0, 2, 1, 3))              # (B,T,H,D)
    att = sym.Reshape(att, shape=(-1, num_hidden))           # (B*T, C)
    return sym.FullyConnected(att, num_hidden=num_hidden,
                              name="%s_proj" % name)


def _ln(x, name):
    return sym.LayerNorm(x, name=name)


def get_symbol(vocab_size=1000, seq_len=128, num_layers=2, num_hidden=128,
               num_heads=4, attn_impl=None, **kwargs):
    """Causal LM head symbol; data (B, T) int tokens, label (B, T)."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    x = sym.Embedding(data=data, input_dim=vocab_size,
                      output_dim=num_hidden, name="embed")    # (B,T,C)
    pos = sym.Embedding(data=sym.position_ids(data, seq_len=seq_len),
                        input_dim=seq_len, output_dim=num_hidden,
                        name="pos_embed")
    x = x + pos
    x = sym.Reshape(x, shape=(-1, num_hidden))                # (B*T, C)
    for i in range(num_layers):
        name = "layer%d" % i
        a = _mha(_ln(x, "%s_ln1" % name), name, seq_len, num_heads,
                 num_hidden, attn_impl=attn_impl)
        x = x + a
        h = sym.FullyConnected(_ln(x, "%s_ln2" % name),
                               num_hidden=4 * num_hidden,
                               name="%s_mlp1" % name)
        h = sym.Activation(h, act_type="relu")
        h = sym.FullyConnected(h, num_hidden=num_hidden,
                               name="%s_mlp2" % name)
        x = x + h
    x = _ln(x, "final_ln")
    logits = sym.FullyConnected(x, num_hidden=vocab_size, name="lm_head")
    label = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, label, name="softmax")
