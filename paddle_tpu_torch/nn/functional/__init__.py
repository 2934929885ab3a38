"""Functionals (ports paddle_tpu/nn/functional/)."""
from .common import dropout
from .loss import cross_entropy
from .transformer import scaled_dot_product_attention

__all__ = ["cross_entropy", "dropout", "scaled_dot_product_attention"]
