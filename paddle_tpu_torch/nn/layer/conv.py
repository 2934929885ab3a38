"""Conv layers: ``Conv2D``.

Ports ``Conv2D`` (:65) and the ``_ConvNd`` parameters of
paddle_tpu/nn/layer/conv.py: ``weight`` [out, in/groups, kh, kw] (the
reference's layout is torch's, so a JAX weight loads as it is) and an
optional ``bias`` [out], both initialised Uniform(-1/sqrt(fan_in),
1/sqrt(fan_in)) as the reference's defaults are. The forward is
``nn.functional.conv2d``. Custom weight and bias attributes are not
ported; ``bias_attr=False`` drops the bias.
"""
import math

import torch
from torch import nn

from ...core import generator as _generator
from ..functional.conv import _pair, conv2d


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"Conv2D: channels {in_channels} -> "
                             f"{out_channels} do not divide into {groups} "
                             "groups")
        if padding_mode != "zeros" or weight_attr is not None \
                or bias_attr not in (None, False):
            raise NotImplementedError(
                "Conv2D padding_mode other than 'zeros' and weight/bias "
                "attributes are not ported (bias_attr=False drops the bias)")
        self._kernel_size = _pair(kernel_size, "kernel_size")
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self._kernel_size))
        self.bias = None if bias_attr is False \
            else nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The reference's default initializers, drawn from `generator`
        (default: the CPU default generator). A no-op on the meta
        device."""
        if self.weight.is_meta:
            return
        gen = generator or _generator.default_generator("cpu")
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)
