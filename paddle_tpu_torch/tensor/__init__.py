"""Tensor ops (ports paddle_tpu/tensor/): ``matmul``."""
from .math import matmul

__all__ = ["matmul"]
