"""LeNet.

Ports ``LeNet`` of paddle_tpu/vision/models/lenet.py (:5) under the
reference's layer names (``features.0``, ``features.3``, ``fc.0`` to
``fc.2``): two convolutions with ReLU and 2 x 2 max pooling over a 1 x 28
x 28 image, then three ``Linear`` layers with no activation between them,
as in the reference. It runs on ``device`` (default ``cuda``; raises
without a CUDA device unless ``device="cpu"``), with weights drawn from
``generator`` (default: the CPU default generator) by the reference's
initializers.
"""
import torch
from torch import nn

from ...core.device import resolve_device
from ...nn.layer import (Conv2D, Linear, MaxPool2D, ReLU, Sequential,
                         init_weights)


class LeNet(nn.Module):
    def __init__(self, num_classes=10, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        with torch.device("meta"):
            self.features = Sequential(
                Conv2D(1, 6, 3, stride=1, padding=1), ReLU(),
                MaxPool2D(2, 2),
                Conv2D(6, 16, 5, stride=1, padding=0), ReLU(),
                MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = Sequential(Linear(400, 120), Linear(120, 84),
                                     Linear(84, num_classes))
        self.to_empty(device="cpu")
        init_weights(self, generator)
        self.to(dev)

    @property
    def device(self):
        return self.features[0].weight.device

    def forward(self, inputs):
        x = self.features(torch.as_tensor(inputs, device=self.device))
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
