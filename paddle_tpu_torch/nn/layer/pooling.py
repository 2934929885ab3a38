"""Pooling layers: ``MaxPool2D``, ``AvgPool2D`` and ``AdaptiveAvgPool2D``.

Ports those three of paddle_tpu/nn/layer/pooling.py (:24, :39, :65):
layers without parameters that keep their arguments and call
``nn.functional.max_pool2d``, ``avg_pool2d`` and ``adaptive_avg_pool2d``
(whose docstring says what is ported and what raises). As in the
reference, the refusals reach the caller at the first forward.
"""
from torch import nn

from ..functional.pooling import adaptive_avg_pool2d, avg_pool2d, \
    max_pool2d


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding)
        self._kwargs = dict(return_mask=return_mask, ceil_mode=ceil_mode,
                            data_format=data_format)

    def forward(self, x):
        return max_pool2d(x, *self._args, **self._kwargs)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding)
        self._kwargs = dict(ceil_mode=ceil_mode, exclusive=exclusive,
                            divisor_override=divisor_override,
                            data_format=data_format)

    def forward(self, x):
        return avg_pool2d(x, *self._args, **self._kwargs)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self._output_size, self._data_format)
