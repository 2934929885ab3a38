"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

A second package beside paddle_tpu/, in PyTorch for one NVIDIA H100. Each
module mirrors the path of the reference module it ports and names it in
its docstring; each Pallas kernel on a ported path is a hand-written CUDA
kernel under ops/csrc/, beside a plain PyTorch version of the same
function. The port imports neither jax nor paddle_tpu.

Four slices so far. Serving GPT-2: the eval forward (flash-attention and
TPP matmul kernels) and KV-cache ``generate``. Training GPT-2 on one
device: the flash-attention backward kernels, the TPP ops as autograd
Functions, the hard-label cross-entropy, AdamW, bf16 ``amp.auto_cast``
and ``distributed.SpmdTrainer``. Serving the PP-YOLOE detector
(``vision``): convolutions, eval BatchNorm, box decoding and multiclass
NMS on the greedy-NMS kernel; with it the TPP row primitives
(``ops.tpp.bias_act``, ``softmax_rows``, ``masked_reduce``). The
continuous-batching ``inference.ServingEngine``, dense or on the paged KV
pool of ``serving`` (``FLAGS_paged_kv``), with the block-table decode
kernel ``ops.tpp.paged_attention``. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
from . import amp, distributed, inference, models, optimizer, serving, vision
from .core.generator import seed
from .flags import get_flag, get_flags, set_flags

__all__ = ["amp", "distributed", "get_flag", "get_flags", "inference",
           "models", "optimizer", "seed", "serving", "set_flags", "vision"]
