"""BERT pretraining: ``BertConfig``, ``BertEmbeddings``, ``BertModel``,
``BertForPretraining`` and ``BertPretrainLoss``.

Ports those five of paddle_tpu/models/bert.py (:11, :35, :59, :87,
:150) under the reference's parameter names, over the port's
``TransformerEncoder`` (post-norm layers with an exact-gelu MLP):

- position ids are ``arange(s)``; an absent ``token_type_ids`` means
  segment 0, whose embedding still adds;
- ``BertModel`` sets ``_epsilon = layer_norm_eps`` (1e-12) on every
  LayerNorm inside it; ``BertForPretraining.ln`` lies outside it and
  keeps 1e-5;
- the pooled output is ``tanh(pooler(x[:, 0]))``;
- the MLM head is tied: ``tensor.matmul(h, word.weight,
  transpose_y=True)``, which reads ``amp.auto_cast``'s state as the
  reference's does; the NSP head is ``nsp(pooled)``;
- ``BertPretrainLoss`` uses only the MLM logits (hard labels,
  ``ignore_index=-100``), so ``pooler`` and ``nsp`` get no gradient; the
  trainer's optimizer still applies zero grads to them (AdamW decays
  them), as the reference's ``jax.grad`` zeros do.

Under bf16 ``auto_cast`` the Linear layers and the tied head compute in
bf16 (q, k, v, the attention output, the logits), the residual stream
and the encoder's LayerNorms stay fp32, and the MLM head's LayerNorm
takes the bf16 gelu output and, through its fp32 weight, gives fp32 — all
as in the reference. At seq 512 attention takes SDPA's naive route.

``BertForPretraining`` runs on ``device`` (default ``cuda``; raises
without a CUDA device unless ``device="cpu"``), with weights drawn from
``generator`` (default: the CPU default generator) by the reference's
initializers; every encoder layer starts from the same weights, as the
reference's deep copy gives them. The fine-tuning heads (sequence, token
and question-answering; bert.py:108-147) are not ported yet.
"""
import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layer import (Dropout, Embedding, LayerNorm, Linear,
                        TransformerEncoder, TransformerEncoderLayer,
                        init_weights)
from ..tensor.math import matmul


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position=128, dropout=0.0)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.word = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position = Embedding(cfg.max_position, cfg.hidden_size)
        self.token_type = Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size)
        self.drop = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word(input_ids) + self.position(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type(token_type_ids)
        return self.drop(self.ln(x))


class BertModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu")
        self.encoder = TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size)
        for sub in self.modules():
            if isinstance(sub, LayerNorm):
                sub._epsilon = cfg.layer_norm_eps

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        x = self.encoder(x, attention_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class BertForPretraining(nn.Module):
    """The tied MLM head and the NSP head over ``BertModel``."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        with torch.device("meta"):
            self.bert = BertModel(cfg)
            self.transform = Linear(cfg.hidden_size, cfg.hidden_size)
            self.ln = LayerNorm(cfg.hidden_size)
            self.nsp = Linear(cfg.hidden_size, 2)
        self.cfg = cfg
        self.to_empty(device="cpu")
        init_weights(self, generator)
        self.to(dev)

    @property
    def device(self):
        return self.bert.embeddings.word.weight.device

    def forward(self, input_ids, token_type_ids=None):
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if token_type_ids is not None:
            token_type_ids = torch.as_tensor(token_type_ids,
                                             device=self.device)
        seq, pooled = self.bert(input_ids, token_type_ids)
        h = self.ln(F.gelu(self.transform(seq)))
        mlm_logits = matmul(h, self.bert.embeddings.word.weight,
                            transpose_y=True)
        return mlm_logits, self.nsp(pooled)


class BertPretrainLoss(nn.Module):
    def forward(self, outputs, labels):
        mlm_logits = outputs[0] if isinstance(outputs, (tuple, list)) \
            else outputs
        b, s, v = mlm_logits.shape
        return F.cross_entropy(mlm_logits.reshape(b * s, v),
                               labels.reshape(b * s), ignore_index=-100)


_HEADS = ("BertForSequenceClassification", "BertForTokenClassification",
          "BertForQuestionAnswering")


def __getattr__(name):
    if name in _HEADS:
        raise NotImplementedError(
            f"{name} is not ported yet (the fine-tuning heads, "
            "paddle_tpu/models/bert.py:108-147)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
