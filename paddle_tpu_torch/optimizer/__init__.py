"""Optimizers (ports paddle_tpu/optimizer/): SGD, Momentum, Adam and
AdamW."""
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Adam", "AdamW", "Momentum", "Optimizer", "SGD"]
