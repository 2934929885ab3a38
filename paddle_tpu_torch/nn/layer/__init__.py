"""Layers (ports paddle_tpu/nn/layer/): Linear, Conv2D and BatchNorm2D."""
from .common import Linear
from .conv import Conv2D
from .norm import BatchNorm2D

__all__ = ["BatchNorm2D", "Conv2D", "Linear"]
