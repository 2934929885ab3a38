"""Functionals (ports paddle_tpu/nn/functional/)."""
from .activation import gelu, relu, sigmoid, silu, softplus, tanh
from .common import dropout, embedding, interpolate, linear
from .conv import conv2d
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d
from .transformer import scaled_dot_product_attention

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm", "conv2d",
           "cross_entropy", "dropout", "embedding", "gelu", "interpolate",
           "layer_norm", "linear", "max_pool2d",
           "scaled_dot_product_attention", "relu", "sigmoid", "silu",
           "softmax_with_cross_entropy", "softplus", "tanh"]
