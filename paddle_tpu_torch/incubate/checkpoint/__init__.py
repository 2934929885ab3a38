"""Auto-checkpoint (ports paddle_tpu/incubate/checkpoint/)."""
from .auto_checkpoint import (CheckpointSaver, TrainEpochRange,
                              train_epoch_range)

__all__ = ["CheckpointSaver", "TrainEpochRange", "train_epoch_range"]
