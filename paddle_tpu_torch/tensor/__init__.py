"""Tensor ops (ports paddle_tpu/tensor/): ``matmul`` and ``trace``."""
from .math import matmul, trace

__all__ = ["matmul", "trace"]
