"""Layers (ports paddle_tpu/nn/layer/): the common, conv, norm, pooling,
activation, loss and transformer-encoder layers the port's models use."""
from .activation import ReLU
from .common import (Dropout, Embedding, LayerList, Linear, Sequential,
                     init_weights)
from .conv import Conv2D
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm2D", "Conv2D",
           "CrossEntropyLoss", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "MaxPool2D", "MultiHeadAttention", "ReLU",
           "Sequential", "TransformerEncoder", "TransformerEncoderLayer",
           "init_weights"]
