"""Vision models (ports paddle_tpu/vision/models/): PP-YOLOE inference
and training loss."""
from .ppyolo import (PPYOLOE, CSPBackbone, CSPBlock, ConvBNLayer, PANNeck,
                     PPYOLOEHead, PPYOLOELoss, ppyoloe_tiny)

__all__ = ["CSPBackbone", "CSPBlock", "ConvBNLayer", "PANNeck", "PPYOLOE",
           "PPYOLOEHead", "PPYOLOELoss", "ppyoloe_tiny"]
