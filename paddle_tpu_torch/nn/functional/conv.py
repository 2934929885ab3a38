"""Convolution functionals: ``conv2d``.

Ports ``conv2d`` (:122) and ``_conv`` (:51) of
paddle_tpu/nn/functional/conv.py, NCHW only, with an int or tuple
``padding``, ``stride`` and ``dilation`` and integer ``groups``. The
reference hands the convolution to XLA (``lax.conv_general_dilated``),
outside any Pallas kernel, so here it is ``torch.nn.functional.conv2d``
(cuDNN on the card), with the bias added after it as the reference adds
it.

The reference's ``auto_cast`` never casts a convolution's inputs (only
``linear`` and ``matmul`` read the amp state), so ``conv2d`` runs with
torch's autocast off: under ``amp.auto_cast`` it computes in its inputs'
dtype, and a mixed input/weight pair is promoted as the reference's
``_match_dtypes`` (:42) promotes it.
"""
import torch
import torch.nn.functional as F

from ...amp.auto_cast import disabled as _autocast_off


def _pair(v, what):
    if isinstance(v, int):
        return (v, v)
    v = tuple(v)
    if len(v) == 1:
        v = v * 2
    if len(v) != 2 or not all(isinstance(i, int) for i in v):
        raise ValueError(f"conv2d {what} must be an int or two ints, got {v}")
    return v


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """x [N, C_in, H, W], weight [C_out, C_in/groups, kh, kw] (the
    reference's layout, which is torch's), bias [C_out]."""
    if data_format != "NCHW":
        raise NotImplementedError(f"conv2d data_format={data_format!r} is "
                                  "not ported (NCHW only)")
    if isinstance(padding, str):
        raise NotImplementedError(f"conv2d padding={padding!r} is not "
                                  "ported (an int or two ints)")
    stride, padding, dilation = (_pair(stride, "stride"),
                                 _pair(padding, "padding"),
                                 _pair(dilation, "dilation"))
    with _autocast_off():
        if x.dtype != weight.dtype:
            ct = torch.promote_types(x.dtype, weight.dtype)
            x, weight = x.to(ct), weight.to(ct)
        out = F.conv2d(x, weight, None, stride, padding, dilation, groups)
        if bias is not None:
            out = out + bias.reshape(1, -1, 1, 1)
    return out
