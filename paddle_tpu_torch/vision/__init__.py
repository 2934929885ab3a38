"""Vision (ports paddle_tpu/vision/): the PP-YOLOE detector's inference
path and the detection ops it calls."""
from . import models, ops

__all__ = ["models", "ops"]
