"""LoRA (low-rank adaptation) fine-tuning.

Ports paddle_tpu/incubate/lora.py: ``LoRALinear``, ``apply_lora``,
``mark_only_lora_trainable``, ``merge_lora``, ``lora_parameters``,
``lora_state_dict`` and ``export_lora``. The recipe of Hu et al. (2021):
the pretrained weight W stays frozen and a rank-r update is learnt,
``y = x W + b + (alpha / r) (x A) B``, A drawn from N(0, 0.02) and B zero,
so training starts from the base model exactly.

Layouts are the reference's: ``lora_A`` is [in, r] and ``lora_B`` [r,
out], applied through the port's ``nn.functional.linear`` (weight [in,
out]). The wrapped ``nn.Linear`` keeps torch's [out, in] weight, so
``merge()`` adds the transpose of ``scaling * (A @ B)``. "Trainable" is
``requires_grad``. A's initial values come from a ``torch.Generator``
(default: the CPU default generator, see ``paddle_tpu_torch.seed``), drawn
on the CPU, so a seed gives the same factors on every device. The
reference also wraps its tensor-parallel Linears; the port has none yet
(ROADMAP), so only ``torch.nn.Linear`` layers (the port's ``nn.Linear``
among them) are wrapped.

Usage::

    replaced = apply_lora(model, r=8, alpha=16,
                          target_modules=["attn.qkv", "mlp.fc1"])
    opt = AdamW(parameters=lora_parameters(model))
    ... train ...
    sd = lora_state_dict(model)      # adapter-only checkpoint
    merge_lora(model)                # fold A @ B into W for serving
"""
import torch
from torch import nn

from ..core import generator as _generator
from ..nn.functional.common import dropout as _dropout
from ..nn.functional.common import linear as _linear

__all__ = ["LoRALinear", "apply_lora", "merge_lora", "lora_parameters",
           "lora_state_dict", "mark_only_lora_trainable", "export_lora"]


def _freeze(p):
    p.requires_grad_(False)


def _unfreeze(p):
    p.requires_grad_(True)


def _is_lora_name(name):
    return "lora_A" in name or "lora_B" in name


class LoRALinear(nn.Module):
    """Wraps an existing ``nn.Linear``; the base weight and bias are
    frozen and only ``lora_A`` / ``lora_B`` train. ``merge()`` folds the
    adapter back into the base layer for serving at no extra cost."""

    def __init__(self, base, r=8, alpha=None, dropout=0.0, generator=None):
        super().__init__()
        if not isinstance(base, nn.Linear):
            raise TypeError(
                f"LoRALinear wraps nn.Linear (the reference's tensor-"
                f"parallel Linears are not ported yet), got {type(base)}")
        if r <= 0:
            raise ValueError(f"rank must be positive, got {r}")
        self.base = base
        _freeze(base.weight)
        if base.bias is not None:
            _freeze(base.bias)
        self.r = r
        self.scaling = (alpha if alpha is not None else r) / r
        self.dropout_p = dropout
        gen = generator or _generator.default_generator("cpu")
        a = torch.empty(base.in_features, r).normal_(0.0, 0.02,
                                                     generator=gen)
        dev = base.weight.device
        self.lora_A = nn.Parameter(a.to(dev))
        self.lora_B = nn.Parameter(torch.zeros(r, base.out_features,
                                               device=dev))

    def forward(self, x):
        y = self.base(x)
        h = x
        if self.dropout_p:
            h = _dropout(h, p=self.dropout_p, training=self.training)
        delta = _linear(_linear(h, self.lora_A), self.lora_B)
        return y + delta * self.scaling

    def merge(self):
        """Fold ``scaling * A @ B`` into the base weight (its transpose:
        the weight is [out, in]) and return the base layer, unfrozen,
        dropping the adapter. The parameter object is kept."""
        w = self.base.weight
        with torch.no_grad():
            upd = self.scaling * (self.lora_A.float() @ self.lora_B.float())
            w.copy_((w.float() + upd.t()).to(w.dtype))
        _unfreeze(w)
        if self.base.bias is not None:
            _unfreeze(self.base.bias)
        return self.base

    def extra_repr(self):
        return (f"in={self.base.in_features}, out={self.base.out_features}, "
                f"r={self.r}, scaling={self.scaling}")


def _named_sublayers(layer):
    """Every sublayer under every path it is registered at (a shared
    layer appears once a parent), as the reference's named_sublayers."""
    return layer.named_modules(remove_duplicate=False)


def _iter_linear_sites(layer, target_modules):
    """(parent, attr_key, qualified_name) for every nn.Linear to wrap.
    target_modules: substrings matched against the qualified sublayer
    name (e.g. ["attn.qkv", "mlp.fc1"]); None matches every Linear."""
    sites = []

    def walk(parent, prefix):
        for key, sub in list(parent._modules.items()):
            if sub is None:
                continue
            qual = f"{prefix}.{key}" if prefix else key
            if isinstance(sub, LoRALinear):
                continue  # never double-wrap (also skips its .base)
            if isinstance(sub, nn.Linear):
                if target_modules is None or any(t in qual
                                                 for t in target_modules):
                    sites.append((parent, key, qual))
            else:
                walk(sub, qual)

    walk(layer, "")
    return sites


def apply_lora(layer, r=8, alpha=None, dropout=0.0, target_modules=None,
               freeze_rest=True, generator=None):
    """Replace the matching ``nn.Linear`` sublayers by ``LoRALinear`` in
    place; returns the qualified names replaced. With ``freeze_rest`` (the
    default) every other parameter is frozen, so the trainable parameters
    are the adapters; ``merge_lora`` restores the trainable set found
    here. A Linear registered under several parents gets ONE shared
    adapter. The A factors are drawn from `generator` in site order."""
    sites = _iter_linear_sites(layer, target_modules)
    if not sites:
        raise ValueError(
            f"no nn.Linear sublayer matched target_modules={target_modules}")
    # first seen wins: a second apply_lora (disjoint target_modules) must
    # not overwrite the snapshot with the post-freeze_rest state. Params
    # under an earlier apply_lora's wrappers are excluded by wrapper
    # membership (a user module may well be named 'base')
    wrapped_prefixes = [qual for qual, sub in _named_sublayers(layer)
                        if qual and isinstance(sub, LoRALinear)]

    def _under_wrapper(name):
        return any(name.startswith(p + ".") for p in wrapped_prefixes)

    prev_trainable = {n: p.requires_grad
                      for n, p in layer.named_parameters()
                      if not _under_wrapper(n)}
    prev_trainable.update(layer.__dict__.get("_lora_prev_trainable", {}))
    wrappers = {}  # id(base Linear) -> its one shared LoRALinear
    for parent, key, _ in sites:
        base = parent._modules[key]
        if id(base) not in wrappers:
            wrappers[id(base)] = LoRALinear(base, r=r, alpha=alpha,
                                            dropout=dropout,
                                            generator=generator)
        parent._modules[key] = wrappers[id(base)]
    if freeze_rest:
        mark_only_lora_trainable(layer)
    layer.__dict__["_lora_prev_trainable"] = prev_trainable
    return [qual for _, _, qual in sites]


def mark_only_lora_trainable(layer):
    """Freeze every parameter but lora_A / lora_B."""
    for name, p in layer.named_parameters():
        (_unfreeze if _is_lora_name(name) else _freeze)(p)


def merge_lora(layer):
    """Fold every LoRALinear back into its base layer, in place, and
    restore the trainable set ``apply_lora`` found. Returns the number of
    distinct adapters merged (a shared adapter merges once)."""
    merged_bases = {}  # id(wrapper) -> merged base Linear

    def walk(parent):
        for key, sub in list(parent._modules.items()):
            if sub is None:
                continue
            if isinstance(sub, LoRALinear):
                if id(sub) not in merged_bases:
                    merged_bases[id(sub)] = sub.merge()
                parent._modules[key] = merged_bases[id(sub)]
            else:
                walk(sub)

    walk(layer)
    prev = layer.__dict__.pop("_lora_prev_trainable", None)
    if prev is not None:
        for n, p in layer.named_parameters():
            if n in prev:
                (_unfreeze if prev[n] else _freeze)(p)
    return len(merged_bases)


def lora_parameters(layer):
    """The adapter parameters (for the optimizer)."""
    return [p for n, p in layer.named_parameters() if _is_lora_name(n)]


def lora_state_dict(layer):
    """Adapter-only checkpoint: {qualified name: numpy array} of A / B."""
    return {n: p.detach().cpu().numpy() for n, p in layer.named_parameters()
            if _is_lora_name(n)}


def export_lora(layer):
    """One adapter in serving-export form: ``{"rank": r, "scaling": s,
    "factors": {qualified_name: {"A": [in, r], "B": [r, out]}}}`` with
    numpy factors: the unit ``ServingEngine.load_adapter`` takes (the
    decode model's ``lora_pack`` maps the names onto its stacked sites).
    Rank and scaling must be uniform across sites: the batched decode
    stacks every adapter into ONE ``[S, L, in, r]`` tensor."""
    factors, ranks, scalings = {}, set(), set()
    for qual, sub in _named_sublayers(layer):
        if qual and isinstance(sub, LoRALinear):
            factors[qual] = {"A": sub.lora_A.detach().cpu().numpy(),
                             "B": sub.lora_B.detach().cpu().numpy()}
            ranks.add(int(sub.r))
            scalings.add(float(sub.scaling))
    if not factors:
        raise ValueError(
            "export_lora: no LoRALinear sublayers found; apply_lora first "
            "(merged adapters cannot be exported; keep them un-merged for "
            "multi-LoRA serving)")
    if len(ranks) != 1 or len(scalings) != 1:
        raise ValueError(
            f"export_lora: multi-LoRA serving needs ONE uniform rank and "
            f"scaling per adapter, got ranks={sorted(ranks)}, "
            f"scalings={sorted(scalings)}")
    return {"rank": ranks.pop(), "scaling": scalings.pop(),
            "factors": factors}
