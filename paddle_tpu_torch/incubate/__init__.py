"""Incubating APIs (ports paddle_tpu/incubate/): LoRA fine-tuning
(``lora``). The reference's auto-checkpoint, segment reductions, readers,
optimizers and contrib layers are not ported."""
from . import lora

__all__ = ["lora"]
