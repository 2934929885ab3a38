"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

A second package beside paddle_tpu/, in PyTorch for one NVIDIA H100. Each
module mirrors the path of the reference module it ports and names it in
its docstring; each Pallas kernel on a ported path is a hand-written CUDA
kernel under ops/csrc/, beside a plain PyTorch version of the same
function. The port imports neither jax nor paddle_tpu.

The slices so far. Serving GPT-2: the eval forward (flash-attention and
TPP matmul kernels) and KV-cache ``generate``. Training GPT-2 on one
device: the flash-attention backward kernels, the TPP ops as autograd
Functions, the hard-label cross-entropy, AdamW, bf16 ``amp.auto_cast``
and ``distributed.SpmdTrainer``. Serving the PP-YOLOE detector
(``vision``): convolutions, eval BatchNorm, box decoding and multiclass
NMS on the greedy-NMS kernel; with it the TPP row primitives
(``ops.tpp.bias_act``, ``softmax_rows``, ``masked_reduce``). The
continuous-batching ``inference.ServingEngine``, dense or on the paged KV
pool of ``serving`` (``FLAGS_paged_kv``), with the block-table decode
kernel ``ops.tpp.paged_attention``. KV caches may be kept as int8 or fp8
codes (``cache_dtype``), and the detector trains (``PPYOLOELoss``,
BatchNorm with batch statistics, ``optimizer.Momentum``). ResNet
(``vision.models.resnet50`` and the rest of the family) and BERT
(``models.BertForPretraining``) train through ``SpmdTrainer``, and LeNet
through the high-level ``Model`` (``hapi``: ``prepare`` and
``train_batch`` / ``eval_batch`` / ``predict_batch``), over the pooling,
LayerNorm, embedding, cross-entropy and transformer-encoder layers of
``nn``. The rest of training: the learning-rate schedules
(``optimizer.lr``), the regularizers (``regularizer``), the gradient clips
(``nn.clip``), the other optimizers and the averaging wrappers, loss
scaling and O2 (``amp.GradScaler``, ``amp.decorate``), NaN / inf checks
(``amp.debugging``), every option of ``cross_entropy``, and recompute
and gradient merge in ``SpmdTrainer``. The rest of serving: ragged
prompts, beam search and speculative decoding in ``generate``;
speculative continuous batching, multi-LoRA serving (``incubate.lora``),
``hot_swap`` with weight lineage (``framework.lineage``), prefill/decode
disaggregation (``serving.disagg``) and the async engine step in the
engine. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from . import (amp, distributed, framework, hapi, incubate, inference,
               models, nn, optimizer, regularizer, serving, tensor, vision)
from .core.generator import seed
from .flags import get_flag, get_flags, set_flags
from .hapi import Model

__all__ = ["Model", "amp", "distributed", "framework", "get_flag",
           "get_flags", "hapi", "incubate", "inference", "models", "nn",
           "optimizer", "regularizer", "seed", "serving", "set_flags",
           "tensor", "vision"]
