"""Pooling functionals: ``max_pool2d``, ``avg_pool2d`` and
``adaptive_avg_pool2d``, NCHW.

Ports those three of paddle_tpu/nn/functional/pooling.py (:65, :81,
:153) with the semantics of the reference's ``_pool`` (:25-57) and
``_adaptive_pool`` (:122-146), which hand the windows to
``lax.reduce_window`` outside any Pallas kernel; here they are torch's
pooling ops (cuDNN or ATen kernels on the card):

- max pooling pads with -inf;
- average pooling is ``exclusive`` by default: a window's sum is divided
  by the number of its cells inside the input (``exclusive=False``
  divides by the window's size);
- ``stride`` defaults to the kernel size, and a padding wider than half
  the kernel (which torch's ops refuse) is applied beforehand;
- ``_pool`` never reads ``ceil_mode``: ``ceil_mode=True`` gives the
  floor-mode windows here too, as in the reference;
- adaptive windows run from floor(i * in / out) to ceil((i + 1) * in /
  out), torch's rule as well; an ``output_size`` entry of None keeps that
  dim.

Not ported yet (NotImplementedError): ``return_mask``, NHWC, string
paddings, ``divisor_override``; the 1-D and 3-D pools, adaptive max
pooling, ``max_unpool2d`` and ``spp`` are not in the port.
"""
import torch
import torch.nn.functional as F


def _pair(v):
    if isinstance(v, int):
        return (v, v)
    v = tuple(v)
    return v * 2 if len(v) == 1 else v


def _refuse(data_format, padding=0, return_mask=False, divisor=None):
    if data_format != "NCHW":
        raise NotImplementedError(f"pooling data_format={data_format!r} is "
                                  "not ported (NCHW only)")
    if isinstance(padding, str):
        raise NotImplementedError(f"pooling padding={padding!r} is not "
                                  "ported (an int or two ints)")
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported yet")
    if divisor is not None:
        raise NotImplementedError("avg_pool2d(divisor_override=) is not "
                                  "ported yet")


def _windows(kernel_size, stride, padding):
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    pd = _pair(padding)
    # torch's ops take at most half the kernel as implicit padding
    wide = any(p > k // 2 for p, k in zip(pd, ks))
    return ks, st, pd, wide


def _pad(x, pd, value):
    return F.pad(x, (pd[1], pd[1], pd[0], pd[0]), value=value)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    _refuse(data_format, padding, return_mask)
    ks, st, pd, wide = _windows(kernel_size, stride, padding)
    if wide:
        x, pd = _pad(x, pd, float("-inf")), (0, 0)
    return F.max_pool2d(x, ks, st, pd)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _refuse(data_format, padding, divisor=divisor_override)
    ks, st, pd, wide = _windows(kernel_size, stride, padding)
    if not wide:
        return F.avg_pool2d(x, ks, st, pd, count_include_pad=not exclusive)
    summed = F.avg_pool2d(_pad(x, pd, 0.0), ks, st, divisor_override=1)
    if not exclusive:
        return summed / (ks[0] * ks[1])
    ones = _pad(torch.ones_like(x[:1, :1]), pd, 0.0)
    return summed / F.avg_pool2d(ones, ks, st, divisor_override=1)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    _refuse(data_format)
    return F.adaptive_avg_pool2d(x, output_size)
