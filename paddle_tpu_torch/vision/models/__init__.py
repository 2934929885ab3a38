"""Vision models (ports paddle_tpu/vision/models/): PP-YOLOE inference."""
from .ppyolo import (PPYOLOE, CSPBackbone, CSPBlock, ConvBNLayer, PANNeck,
                     PPYOLOEHead, ppyoloe_tiny)

__all__ = ["CSPBackbone", "CSPBlock", "ConvBNLayer", "PANNeck", "PPYOLOE",
           "PPYOLOEHead", "ppyoloe_tiny"]
