"""Vision models (ports paddle_tpu/vision/models/): PP-YOLOE inference and
training loss, ResNet and LeNet."""
from .lenet import LeNet
from .ppyolo import (PPYOLOE, CSPBackbone, CSPBlock, ConvBNLayer, PANNeck,
                     PPYOLOEHead, PPYOLOELoss, ppyoloe_tiny)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)

__all__ = ["BasicBlock", "BottleneckBlock", "CSPBackbone", "CSPBlock",
           "ConvBNLayer", "LeNet", "PANNeck", "PPYOLOE", "PPYOLOEHead",
           "PPYOLOELoss", "ResNet", "ppyoloe_tiny", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]
