"""Carry the JAX package's GPT weights and optimizer state, and its
PP-YOLOE weights and BatchNorm statistics, into the port (no counterpart
in paddle_tpu/).

The reference's ``nn.Linear`` stores its weight as [in, out] (used as
``h @ w``); the port's layers are ``torch.nn.Linear``, whose weight is
[out, in]. So every Linear weight is transposed on the way across, and so
are the optimizer moments kept beside it; embeddings ([rows, h]),
LayerNorm parameters and biases are taken as they are. Names do not
change.
"""
import re

import numpy as np
import torch

from ..core.device import resolve_device

#: the Linear weights of the GPT model (and an untied head's, if present)
_LINEAR_WEIGHT = re.compile(
    r"(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2|lm_head)\.weight$")


def params_from_jax(named):
    """named: ``{n: np.asarray(p._data) for n, p in
    model.named_parameters()}`` of a paddle_tpu GPTForCausalLM. Returns the
    port's state dict (CPU tensors) for ``GPTForCausalLM.load_state_dict``."""
    out = {}
    for name, arr in named.items():
        arr = np.asarray(arr)
        if _LINEAR_WEIGHT.search(name):
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D Linear weight, got "
                                 f"shape {arr.shape}")
            arr = arr.T
        out[name] = torch.tensor(arr)
    return out


def opt_state_from_jax(named_state, device=None):
    """named_state: the reference optimizer's ``functional_init`` /
    ``functional_apply`` state as numpy arrays, ``{param name: {slot:
    array}, "__step__": array}`` (an SpmdTrainer's ``opt_state``). Returns
    the port optimizer's state in the same layout, as tensors on `device`
    (``cuda`` unless the caller names another; raises without a CUDA
    device): moments of Linear weights transposed like their weights,
    scalar slots (``beta1_pow``, ``beta2_pow``) and ``__step__`` as they
    are."""
    device = resolve_device(device)
    out = {}
    for name, slots in named_state.items():
        if name == "__step__":
            out[name] = torch.tensor(np.asarray(slots), dtype=torch.int32,
                                     device=device)
            continue
        out[name] = {}
        for slot, arr in slots.items():
            arr = np.asarray(arr)
            if arr.ndim == 2 and _LINEAR_WEIGHT.search(name):
                arr = arr.T
            out[name][slot] = torch.tensor(np.ascontiguousarray(arr),
                                           device=device)
    return out


def ppyoloe_params_from_jax(state):
    """state: ``{n: np.asarray(t._data) for n, t in
    model.state_dict().items()}`` of a paddle_tpu PPYOLOE (parameters and
    the BatchNorm buffers ``_mean``/``_variance``: 202 entries for
    ``ppyoloe_tiny``). Returns the port's state dict (CPU tensors) for
    ``PPYOLOE.load_state_dict``: the conv weights are [out, in/groups, kh,
    kw] in both packages, so nothing is transposed and no name changes."""
    return {name: torch.tensor(np.asarray(arr)) for name, arr in
            state.items()}
