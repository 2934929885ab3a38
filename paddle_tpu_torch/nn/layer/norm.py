"""Norm layers: ``BatchNorm2D`` and ``LayerNorm``.

Ports ``BatchNorm2D`` (:57) and ``_BatchNormBase`` (:10) of
paddle_tpu/nn/layer/norm.py, under the reference's names: the parameters
``weight`` (ones) and ``bias`` (zeros), and the fp32 buffers ``_mean``
(zeros) and ``_variance`` (ones) that hold the running statistics
(norm.py:29-30). In eval mode the forward normalises by those buffers;
in training mode by the batch's statistics, and it updates the buffers in
place by ``nn.functional.batch_norm``'s rule (momentum 0.9: ``running =
0.9 * running + 0.1 * batch``, the variance biased).

``LayerNorm`` ports norm.py:102: ``weight`` (ones) and ``bias`` (zeros)
over ``normalized_shape`` (either dropped by a ``False`` attribute), and
the reference's attribute ``_epsilon``, which ``BertModel`` sets on its
norms; the forward is ``nn.functional.layer_norm``.
"""
import torch
from torch import nn

from ..functional.norm import batch_norm, layer_norm


class BatchNorm2D(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None, False):
            raise NotImplementedError("BatchNorm2D weight/bias attributes "
                                      "are not ported (None or False only)")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False \
            else nn.Parameter(torch.empty(num_features))
        self.bias = None if bias_attr is False \
            else nn.Parameter(torch.empty(num_features))
        self.register_buffer("_mean", torch.empty(num_features))
        self.register_buffer("_variance", torch.empty(num_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The reference's initial values (no draw: `generator` is not
        used). A no-op on the meta device."""
        if self._mean.is_meta:
            return
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
            self._mean.zero_()
            self._variance.fill_(1.0)

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None, False):
            raise NotImplementedError("LayerNorm weight/bias attributes are "
                                      "not ported (None or False only)")
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False \
            else nn.Parameter(torch.empty(self._normalized_shape))
        self.bias = None if bias_attr is False \
            else nn.Parameter(torch.empty(self._normalized_shape))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """Weight 1, bias 0 (no draw). A no-op on the meta device."""
        with torch.no_grad():
            if self.weight is not None and not self.weight.is_meta:
                self.weight.fill_(1.0)
            if self.bias is not None and not self.bias.is_meta:
                self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)
