"""Carry the JAX package's weights, BatchNorm statistics and optimizer
state into the port (no counterpart in paddle_tpu/).

The reference's ``nn.Linear`` stores its weight as [in, out] (used as
``h @ w``); the port's layers are ``torch.nn.Linear``, whose weight is
[out, in]. So every Linear weight is transposed on the way across, and so
are the optimizer slots kept beside it; conv weights (the same [out,
in/groups, kh, kw] in both packages), embeddings ([rows, h], the tied
word embedding included), LayerNorm and BatchNorm parameters, the
BatchNorm buffers ``_mean`` / ``_variance`` and biases are taken as they
are. Names do not change.

Which weights are Linear ones is read off the port model:
``linear_weights(model)`` names the 2-D weight of every ``torch.nn.
Linear`` module in it (``fc`` of ResNet, ``fc.0`` to ``fc.2`` of LeNet,
BERT's projections, ``pooler``, ``transform`` and ``nsp``, the GPT's).
``state_from_jax`` and ``opt_state_from_jax`` transpose exactly those.
``params_from_jax`` (the GPT's, which has no model to read; and
``opt_state_from_jax`` without a model) reads the GPT's names, and
``ppyoloe_params_from_jax`` (no Linear layer) transposes nothing.
"""
import re

import numpy as np
import torch

from ..core.device import resolve_device

#: the Linear weights of the GPT model (and an untied head's, if present)
_LINEAR_WEIGHT = re.compile(
    r"(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2|lm_head)\.weight$")
#: the GPT model's embeddings
_GPT_EMBEDDING = re.compile(r"gpt\.(wte|wpe)\.weight$")


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


def linear_weights(model):
    """The names of the 2-D weights of every ``torch.nn.Linear`` module of
    the port model `model` (the port's ``nn.Linear`` is one)."""
    return {f"{prefix}.weight" if prefix else "weight"
            for prefix, mod in model.named_modules()
            if isinstance(mod, torch.nn.Linear) and mod.weight.ndim == 2}


def state_from_jax(state, model):
    """state: ``{n: np.asarray(t._data) for n, t in
    model.state_dict().items()}`` of a paddle_tpu model (parameters and
    buffers). Returns the port's state dict (CPU tensors) for
    ``load_state_dict`` of the port model `model` of the same class: the
    weights of its Linear layers transposed, every other entry as it
    is."""
    linear = linear_weights(model)
    return {name: torch.tensor(np.ascontiguousarray(
        np.asarray(arr).T if name in linear else np.asarray(arr)))
        for name, arr in state.items()}


def opt_state_from_jax(named_state, model=None, device=None):
    """named_state: the reference optimizer's ``functional_init`` /
    ``functional_apply`` state as numpy arrays, ``{param name: {slot:
    array}, "__step__": array}`` (an SpmdTrainer's ``opt_state``: Adam's
    or AdamW's moments, or Momentum's ``velocity``). Returns the port
    optimizer's state in the same layout, as tensors on `device` (``cuda``
    unless the caller names another; raises without a CUDA device): the
    2-D slots of the weights of `model`'s Linear layers transposed like
    their weights (``linear_weights``), Adam's ``beta1_pow`` and
    ``beta2_pow`` as the scalars the port keeps, every other slot (conv
    and embedding slots) and ``__step__`` as they are.
    Without `model` the GPT's names decide, as ``params_from_jax``'s do
    (its Linear weights transposed, its embeddings not), and any other
    2-D slot is ambiguous and raises ValueError."""
    device = resolve_device(device)
    linear = None if model is None else linear_weights(model)
    out = {}
    for name, slots in named_state.items():
        if name == "__step__":
            out[name] = torch.tensor(np.asarray(slots), dtype=torch.int32,
                                     device=device)
            continue
        out[name] = {}
        for slot, arr in slots.items():
            arr = np.asarray(arr)
            if arr.ndim == 2 and linear is None:
                if _LINEAR_WEIGHT.search(name):
                    arr = arr.T
                elif not _GPT_EMBEDDING.search(name):
                    raise ValueError(
                        f"{name}.{slot} is 2-D and not the GPT's: pass the "
                        "port model so that the slots of its Linear "
                        "weights are transposed")
            elif arr.ndim == 2 and name in linear:
                arr = arr.T
            if slot.endswith("_pow"):
                arr = arr.reshape(())
            out[name][slot] = torch.tensor(np.array(arr, order="C"),
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
