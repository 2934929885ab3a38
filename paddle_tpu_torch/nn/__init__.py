"""Neural-network functionals and layers (ports paddle_tpu/nn/)."""
from .layer import BatchNorm2D, Conv2D, Linear

__all__ = ["BatchNorm2D", "Conv2D", "Linear"]
