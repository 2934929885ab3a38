"""Activation layers: ``ReLU``.

Ports ``ReLU`` of paddle_tpu/nn/layer/activation.py (:71, one of the
reference's ``_simple`` wrappers over a functional): a layer without
parameters whose forward is ``nn.functional.relu``.
"""
from torch import nn

from ..functional.activation import relu


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)
