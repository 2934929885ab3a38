"""The high-level API (ports paddle_tpu/hapi/): ``Model``'s batch-level
training, evaluation and prediction."""
from .model import Model

__all__ = ["Model"]
