"""Attention functionals.

Ports paddle_tpu/nn/functional/transformer.py: one attention entry point
that routes to the flash-attention kernels (ops/flash_attention.py, forward
and backward) when the shapes allow it and the tensors lie on a CUDA
device, and to the naive softmax(QK^T)V otherwise, with the same causal,
window and mask handling. Gradients flow through both paths; attention
dropout draws its mask from a torch.Generator. The naive path runs with
torch's autocast off: the reference's auto_cast reaches only linear and
matmul, so its scores, softmax and probabilities keep q's dtype (under
torch's autocast a CUDA softmax would come out fp32). ``routes`` counts
the calls by the route they took (``flash`` or ``naive``).
"""
import collections
import math

import torch

from ...amp.auto_cast import disabled as _autocast_off
from ...ops import flash_attention as fa
from .common import dropout

_NEG = -1e30


def _neg(dtype):
    """The masked scores' value: -1e30 as the reference's
    ``jnp.asarray(-1e30, dtype)`` holds it (-inf in fp16)."""
    return torch.tensor(_NEG, dtype=dtype).item()

#: calls of scaled_dot_product_attention by route
routes = collections.Counter()


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_flash=True, window=None):
    """query/key/value: [batch, seq, heads, head_dim] (the reference's
    layout).

    Takes the flash kernel when use_flash, no mask, no dropout and
    ``fa.supported`` (which includes "on a CUDA device") all hold; the
    naive path otherwise. window=W (requires is_causal) keeps only the last
    W tokens. attn_mask: a bool keep-mask, or an additive mask,
    broadcastable to [batch, heads, seq_q, seq_k]."""
    if window is not None and not is_causal:
        raise ValueError("window requires is_causal=True")
    if (use_flash and attn_mask is None and dropout_p == 0.0
            and fa.supported(tuple(query.shape), query.dtype, query.device)):
        routes["flash"] += 1
        return fa.flash_attention(query, key, value, causal=is_causal,
                                  window=window)

    routes["naive"] += 1
    with _autocast_off():
        return _naive(query, key, value, attn_mask, dropout_p, is_causal,
                      training, window)


def _naive(query, key, value, attn_mask, dropout_p, is_causal, training,
           window):
    """softmax(q k^T / sqrt(d)) v in q's dtype, as the reference's
    `fn_probs` / `fn_out`."""
    q = query.transpose(1, 2)                                # [b, h, s, d]
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (
        1.0 / math.sqrt(q.shape[-1]))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, _neg(scores.dtype))
        else:
            scores = scores + attn_mask.to(scores.dtype)
    if is_causal:
        s_q, s_k = scores.shape[-2:]
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=scores.device).tril()
        if window is not None:
            qp = torch.arange(s_q, device=scores.device)[:, None]
            kp = torch.arange(s_k, device=scores.device)[None, :]
            keep &= (qp - kp) < window
        scores = scores.masked_fill(~keep, _neg(scores.dtype))
    probs = torch.softmax(scores, dim=-1)
    if dropout_p and training:
        probs = dropout(probs, p=dropout_p, training=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2)
