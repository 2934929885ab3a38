"""Functionals (ports paddle_tpu/nn/functional/)."""
from .activation import sigmoid, silu, softplus
from .common import dropout, interpolate, linear
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm
from .transformer import scaled_dot_product_attention

__all__ = ["batch_norm", "conv2d", "cross_entropy", "dropout", "interpolate",
           "linear", "scaled_dot_product_attention", "sigmoid", "silu",
           "softplus"]
