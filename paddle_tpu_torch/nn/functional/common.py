"""Common functionals: dropout.

Ports ``dropout`` of paddle_tpu/nn/functional/common.py. The reference
draws its keep-mask from the framework's PRNG key; here the mask comes
from a ``torch.Generator`` — the caller's, or the default generator of
the tensor's device (``paddle_tpu_torch.seed`` reseeds those) — never
from torch's global RNG. The two frameworks draw different masks from
the same seed.
"""
import torch

from ...core import generator as _generator


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """Zero each element with probability p in training (a mask broadcast
    over the dims not in `axis`, when given); identity otherwise. Mode
    ``upscale_in_train`` divides the kept values by 1 - p, any other mode
    keeps them as they are (the reference's two branches)."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    gen = generator or _generator.default_generator(x.device)
    keep = torch.rand(shape, generator=gen, device=x.device) >= p
    if mode == "upscale_in_train":
        x = x / (1.0 - p)
    return torch.where(keep, x, torch.zeros_like(x))
