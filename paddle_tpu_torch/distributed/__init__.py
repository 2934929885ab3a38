"""Distributed training (ports paddle_tpu/distributed/): the
single-device SpmdTrainer."""
from . import spmd
from .spmd import SpmdTrainer

__all__ = ["SpmdTrainer", "spmd"]
