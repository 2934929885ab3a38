"""Common layers: ``Linear``, ``Embedding``, ``Dropout``, ``LayerList``
and ``Sequential``.

Ports those five of paddle_tpu/nn/layer/common.py (``Linear`` :11,
``Embedding`` :34, ``Dropout`` :56, ``LayerList`` :250, ``Sequential``
:292).

- ``Linear`` is a ``torch.nn.Linear``, so its weight keeps torch's
  [out, in] layout (``models/convert.py`` transposes the reference's
  [in, out] weight on the way across); its forward is
  ``nn.functional.linear``'s (on the [out, in] weight as it is), which
  reads ``amp.auto_cast``'s state as the reference's layer does.
- ``Linear`` and ``Embedding`` draw their weights by the reference's
  default initializer, Xavier-normal (std sqrt(2 / (rows + cols))), with
  zero biases, from a torch.Generator (``reset_parameters``).
- ``Dropout`` draws its mask as ``nn.functional.dropout`` does, from a
  torch.Generator; it is the identity in eval mode.
- ``LayerList`` and ``Sequential`` name their children ``0, 1, ...``, as
  the reference's containers do, so state-dict names such as
  ``features.0.weight`` match across the two packages (the reference's
  ``(name, layer)`` pairs are not ported).

Custom weight and bias attributes are not ported; ``bias_attr=False``
drops the bias. ``Embedding(padding_idx=...)`` and ``sparse=True`` raise
NotImplementedError.

``init_weights(module, generator)`` draws every port layer under
`module` anew by the reference's initializers, from one generator.
"""
import math

import torch
from torch import nn

from ...core import generator as _generator
from ..functional.common import _linear, dropout, embedding


def _xavier_normal_(weight, generator):
    """The reference's XavierNormal on a 2-D weight (fans from the shape,
    which is symmetric in them). A no-op on the meta device."""
    if weight.is_meta:
        return
    rows, cols = weight.shape
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / (rows + cols)),
                       generator=generator
                       or _generator.default_generator("cpu"))


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError(
                "Linear weight/bias attributes are not ported "
                "(bias_attr=False drops the bias)")
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False)

    def reset_parameters(self, generator=None):
        _xavier_normal_(self.weight, generator)
        if self.bias is not None and not self.bias.is_meta:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return _linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        if padding_idx is not None or sparse or weight_attr is not None:
            raise NotImplementedError(
                "Embedding padding_idx, sparse=True and weight attributes "
                "are not ported yet")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(num_embeddings,
                                               embedding_dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _xavier_normal_(self.weight, generator)

    def forward(self, x):
        return embedding(x, self.weight)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode)


class LayerList(nn.ModuleList):
    """A list of layers named ``0, 1, ...``."""


class Sequential(nn.Sequential):
    """Layers applied in order, named ``0, 1, ...``."""


def init_weights(module, generator=None):
    """Draw every port layer under `module` anew by the reference's
    initializers, in module order, from `generator` (default: the CPU
    default generator): each layer that has ``reset_parameters`` is reset
    as a whole (a ``TransformerEncoder`` draws its first layer and copies
    it into the others); any other module is searched through."""
    gen = generator or _generator.default_generator("cpu")
    reset = getattr(module, "reset_parameters", None)
    if reset is not None:
        reset(generator=gen)
        return
    for child in module.children():
        init_weights(child, gen)
