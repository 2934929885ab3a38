"""Common layers: ``Linear``.

Ports ``Linear`` of paddle_tpu/nn/layer/common.py (:11). The layer is a
``torch.nn.Linear``, so its weight keeps torch's [out, in] layout
(``models/convert.py`` transposes the reference's [in, out] weight on the
way across); its forward is ``nn.functional.linear``'s (on the [out, in]
weight as it is), which reads ``amp.auto_cast``'s state as the
reference's layer does.
Custom weight and bias attributes are not ported; ``bias_attr=False``
drops the bias.
"""
from torch import nn

from ..functional.common import _linear


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError(
                "Linear weight/bias attributes are not ported "
                "(bias_attr=False drops the bias)")
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False)

    def forward(self, x):
        return _linear(x, self.weight, self.bias)
