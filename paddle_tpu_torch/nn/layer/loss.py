"""Loss layers: ``CrossEntropyLoss``.

Ports ``CrossEntropyLoss`` of paddle_tpu/nn/layer/loss.py (:6): the
layer keeps its options and calls ``nn.functional.cross_entropy``, whose
hard-label path takes integer labels of the logits' shape without the
class axis ([B], as ResNet's bench run gives them) or with it of size 1
([B, 1], as LeNet's); every option (soft labels, ``weight``,
``label_smoothing``, ``use_softmax=False``) passes through to it.
"""
from torch import nn

from ..functional.loss import cross_entropy


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return cross_entropy(
            input, label, weight=self.weight,
            ignore_index=self.ignore_index, reduction=self.reduction,
            soft_label=self.soft_label, axis=self.axis,
            use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)
