"""The matmul family's ``matmul``.

Ports ``matmul`` of paddle_tpu/tensor/math.py (:320): ``x @ y`` with
``transpose_x`` / ``transpose_y`` swapping the last two dims of an
operand of two or more dims. It is one of the two ops that read
``amp.auto_cast``'s state (``nn.functional.linear`` is the other): under
it a floating x and y are cast to the amp dtype first.
"""
import torch

from ..amp.auto_cast import cast_inputs


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.ndim >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(*cast_inputs(x, y))
