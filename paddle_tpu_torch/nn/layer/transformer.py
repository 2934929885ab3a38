"""Transformer layers: ``MultiHeadAttention``, ``TransformerEncoderLayer``
and ``TransformerEncoder``.

Ports those three of paddle_tpu/nn/layer/transformer.py (:43, :101,
:141) with ``_convert_attn_mask`` (:17):

- ``MultiHeadAttention`` projects q, k and v with ``Linear`` layers
  (under ``amp.auto_cast`` they come out in the amp dtype), reshapes them
  to [b, s, heads, head_dim] and runs ``nn.functional.
  scaled_dot_product_attention`` (its flash route at seq >= 1024 with no
  mask and no dropout on a CUDA device, the naive one otherwise), then
  ``out_proj``. Attention dropout applies in training mode only.
- A 2-D mask is read as the reference reads it: of shape (q_len, k_len)
  it is a [q, k] score mask (bool keep or additive float) and passes as
  it is; a float mask of another shape is additive and passes as it is;
  an integer or bool [b, k_len] mask is a key-padding keep-mask and
  becomes bool [b, 1, 1, k_len]. Masks of three or more dims pass as
  they are.
- ``TransformerEncoderLayer`` takes both ``normalize_before`` settings and
  any activation of ``nn.functional`` by name (BERT passes ``"gelu"``).
- ``TransformerEncoder`` deep-copies its first layer into the others, as
  the reference does (:146), so every layer starts from the same
  weights; its ``reset_parameters`` draws the first layer and copies it
  again.

Not ported yet (NotImplementedError): the incremental ``cache`` of the
forwards and ``gen_cache``. The decoder classes and ``Transformer`` are
not in the port.
"""
import copy

import torch
from torch import nn

from .. import functional as F
from .common import Dropout, LayerList, Linear, init_weights
from .norm import LayerNorm


def _convert_attn_mask(attn_mask, q_len=None, k_len=None):
    """A user mask in SDPA's [b, heads, q, k] broadcast space (see the
    module docstring)."""
    if attn_mask is None or attn_mask.ndim != 2:
        return attn_mask
    if q_len is not None and tuple(attn_mask.shape) == (q_len, k_len):
        return attn_mask
    if attn_mask.is_floating_point():
        return attn_mask
    if k_len is None or attn_mask.shape[-1] == k_len:
        return attn_mask.bool()[:, None, None, :]
    return attn_mask


def _no_cache(cache):
    if cache is not None:
        raise NotImplementedError("the incremental attention cache is not "
                                  "ported yet")


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} does not divide into "
                             f"{num_heads} heads")
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        _no_cache(cache)
        key = query if key is None else key
        value = query if value is None else value
        b, sq = query.shape[0], query.shape[1]
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(query).reshape(b, sq, *heads)
        k = self.k_proj(key).reshape(b, key.shape[1], *heads)
        v = self.v_proj(value).reshape(b, value.shape[1], *heads)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attn_mask(attn_mask, q_len=sq,
                                                  k_len=k.shape[1]),
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        return self.out_proj(out.reshape(b, sq, self.embed_dim))

    def gen_cache(self, key, value=None, type=None):
        _no_cache(True)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def reset_parameters(self, generator=None):
        """Draw the first layer (and the final norm) anew and copy the
        first layer into the others, as construction does."""
        init_weights(self.layers[0], generator)
        with torch.no_grad():
            for layer in self.layers[1:]:
                for dst, src in zip(layer.state_dict().values(),
                                    self.layers[0].state_dict().values()):
                    dst.copy_(src)
        if self.norm is not None:
            init_weights(self.norm, generator)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        for layer in self.layers:
            src = layer(src, src_mask)
        return src if self.norm is None else self.norm(src)
