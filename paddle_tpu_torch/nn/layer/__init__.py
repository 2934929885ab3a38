"""Layers (ports paddle_tpu/nn/layer/): Conv2D and BatchNorm2D."""
from .conv import Conv2D
from .norm import BatchNorm2D

__all__ = ["BatchNorm2D", "Conv2D"]
