"""Inference (ports paddle_tpu/inference/): the continuous-batching
``ServingEngine``. The reference's predictor API is not ported."""
from .serving import QueueFullError, Request, ServingEngine

__all__ = ["QueueFullError", "Request", "ServingEngine"]
