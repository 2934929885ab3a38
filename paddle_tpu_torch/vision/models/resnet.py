"""ResNet: ``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and
``resnet18`` / ``34`` / ``50`` / ``101`` / ``152``.

Ports paddle_tpu/vision/models/resnet.py (:5, :29, :56, :121-138) under
the reference's layer names (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``, ``fc``, ...), so a state dict crosses between
the packages by name (``models.convert.state_from_jax`` transposes
``fc.weight``). Convolutions, BatchNorm and pooling are the port's
layers (cuDNN and ATen on the card: the reference runs them as lax code,
outside any Pallas kernel). Under ``amp.auto_cast`` only ``fc`` casts, as
in the reference, so its logits and the loss over them are bf16 while
the backbone stays fp32.

``ResNet`` runs on ``device`` (default ``cuda``; raises without a CUDA
device unless ``device="cpu"``), with weights drawn from ``generator``
(default: the CPU default generator) by the reference's initializers, as
``PPYOLOE`` is built. The builders take no ``pretrained`` weights.
"""
import torch
from torch import nn

from ...core.device import resolve_device
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                         MaxPool2D, ReLU, Sequential, init_weights)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


_DEPTHS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
           101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        layers = _DEPTHS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        with torch.device("meta"):
            self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                                padding=3, bias_attr=False)
            self.bn1 = self._norm_layer(self.inplanes)
            self.relu = ReLU()
            self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = Linear(512 * block.expansion, num_classes)
        self.to_empty(device="cpu")
        init_weights(self, generator)
        self.to(dev)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, norm_layer=norm_layer,
                                groups=self.groups,
                                base_width=self.base_width))
        return Sequential(*layers)

    @property
    def device(self):
        return self.conv1.weight.device

    def forward(self, x):
        x = torch.as_tensor(x, device=self.device)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported (no "
                                  "downloads)")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
