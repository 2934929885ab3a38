"""Neural-network functionals and layers (ports paddle_tpu/nn/), and the
gradient clips of ``nn.clip``, exported here as paddle_tpu/nn/__init__.py
exports them."""
from . import clip, functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "clip", "clip_grad_norm_", "functional",
           *_layers]
