"""Incubating APIs (ports paddle_tpu/incubate/): LoRA fine-tuning
(``lora``) and auto-checkpoint (``checkpoint``: ``CheckpointSaver``,
``TrainEpochRange``). The reference's segment reductions, readers,
optimizers and contrib layers are not ported."""
from . import checkpoint, lora

__all__ = ["checkpoint", "lora"]
