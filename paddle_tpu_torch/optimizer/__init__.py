"""Optimizers (ports paddle_tpu/optimizer/, python/paddle/optimizer
parity): the optimizer family, the averaging wrappers of ``extras`` and
the learning-rate schedules of ``lr``."""
from . import lr
from .extras import ExponentialMovingAverage, LookAhead, ModelAverage
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Dpsgd,
                        Ftrl, Lamb, Lars, LarsMomentum, Momentum, Optimizer,
                        RMSProp)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Dpsgd",
           "ExponentialMovingAverage", "Ftrl", "Lamb", "Lars",
           "LarsMomentum", "LookAhead", "ModelAverage", "Momentum",
           "Optimizer", "RMSProp", "SGD", "lr"]
