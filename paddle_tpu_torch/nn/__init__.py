"""Neural-network functionals and layers (ports paddle_tpu/nn/)."""
from . import functional
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["functional", *_layers]
