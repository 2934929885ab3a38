"""Automatic mixed precision (ports paddle_tpu/amp/, python/paddle/amp
parity): ``auto_cast``, the loss scalers, ``decorate`` and the
white / black op lists."""
import torch

from . import debugging
from .auto_cast import (_convert_dtype, amp_dtype, amp_guard, amp_state,
                        auto_cast, black_list, white_list)
from .grad_scaler import AmpScaler, GradScaler


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate parity: level ``"O2"`` casts every parameter of
    the model(s) to `dtype` in place (buffers keep theirs); ``"O1"``
    changes nothing. ``master_weight`` and ``save_dtype`` are accepted and
    not read, as in the reference. Returns the model(s), and the
    optimizer(s) when given."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        d = _convert_dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    p.data = p.data.to(d)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


__all__ = ["AmpScaler", "GradScaler", "amp_dtype", "amp_guard", "amp_state",
           "auto_cast", "black_list", "debugging", "decorate", "white_list"]
