"""Activation functionals: ``relu``, ``sigmoid``, ``tanh``, ``gelu``,
``silu`` and ``softplus``.

Ports those six of paddle_tpu/nn/functional/activation.py with the
formulas of the jax.nn functions they call. ``relu`` (:19) and ``tanh``
(:37) are torch's; ``gelu`` (:41) is exact, ``x * Phi(x)`` through erf,
unless ``approximate`` asks for the tanh form, as ``jax.nn.gelu`` is; each
keeps its input's dtype. ``silu`` (:78) is
``x * sigmoid(x)`` as ``jax.nn.silu`` is, and ``softplus`` (:121) is
``x`` above the threshold and ``jax.nn.softplus(beta x) / beta`` below,
``jax.nn.softplus`` being ``logaddexp(x, 0) = max(x, 0) +
log1p(exp(-|x|))``. torch's exp and log1p round the last bit differently
from XLA's, so results agree with the reference to about one ulp, not bit
for bit.
"""
import torch
import torch.nn.functional as F


def relu(x, name=None):
    return torch.relu(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def gelu(x, approximate=False, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return x * torch.sigmoid(x)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    xb = x * beta
    return torch.where(xb > threshold, x, _softplus(xb) / beta)
