"""Common functionals: linear, dropout, interpolate and embedding.

Ports ``linear`` (:22), ``dropout``, ``interpolate`` (:121) and
``embedding`` (:315) of paddle_tpu/nn/functional/common.py.
``embedding`` gathers rows of the weight by integer ids; ``padding_idx``
and ``sparse=True`` are not ported yet and raise NotImplementedError.
``linear`` takes the reference's weight layout, [in, out] (``x @ weight
+ bias``), and is one of the two ops that read ``amp.auto_cast``'s state
(``tensor.matmul`` is the other): under it a floating x, the weight and
the bias are cast to the amp dtype first. The reference draws its dropout
keep-mask from the framework's PRNG key; here the mask comes from a
``torch.Generator`` — the caller's, or the default generator of the
tensor's device (``paddle_tpu_torch.seed`` reseeds those) — never from
torch's global RNG. The two frameworks draw different masks from the
same seed. ``interpolate`` is ported for nearest-neighbour upsampling by
an integer ``scale_factor`` in NCHW (what the detector's neck calls);
every other mode, size or layout raises.
"""
import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast_inputs
from ...core import generator as _generator


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias``, weight [in, out] (an ``nn.Linear`` layer
    passes its [out, in] weight as ``weight.t()``, which costs no copy).
    Under auto_cast x, weight and bias compute in the amp dtype; otherwise
    the bias takes the product's dtype, as the reference adds it."""
    return _linear(x, weight.t(), bias)


def _linear(x, weight, bias):
    """``linear`` on a weight in torch's [out, in] layout (the
    ``nn.Linear`` layer's), with no transposed view in between."""
    x, weight = cast_inputs(x, weight)
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return F.linear(x, weight, bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """Zero each element with probability p in training (a mask broadcast
    over the dims not in `axis`, when given); identity otherwise. Mode
    ``upscale_in_train`` divides the kept values by 1 - p, any other mode
    keeps them as they are (the reference's two branches)."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    gen = generator or _generator.default_generator(x.device)
    keep = torch.rand(shape, generator=gen, device=x.device) >= p
    if mode == "upscale_in_train":
        x = x / (1.0 - p)
    return torch.where(keep, x, torch.zeros_like(x))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Nearest-neighbour upsampling of [N, C, H, W] by an integer
    scale_factor: output pixel i reads input pixel i // scale_factor, as
    ``jax.image.resize(method="nearest")`` does at an integer factor."""
    if mode != "nearest" or size is not None or data_format != "NCHW" \
            or x.ndim != 4:
        raise NotImplementedError(
            f"interpolate(mode={mode!r}, size={size!r}, data_format="
            f"{data_format!r}) on a {x.ndim}-D input is not ported: only "
            "nearest NCHW 4-D with an integer scale_factor")
    factors = scale_factor if isinstance(scale_factor, (list, tuple)) \
        else [scale_factor] * 2
    if len(factors) != 2 or not all(
            isinstance(f, (int, float)) and f >= 1 and float(f).is_integer()
            for f in factors):
        raise NotImplementedError(f"interpolate scale_factor={scale_factor!r}"
                                  " is not ported (positive integers only)")
    return F.interpolate(x, scale_factor=tuple(float(f) for f in factors),
                         mode="nearest")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` [num, dim] at the integer ids `x`: [*x.shape,
    dim]."""
    if padding_idx is not None or sparse:
        raise NotImplementedError("embedding padding_idx and sparse=True "
                                  "are not ported yet")
    return F.embedding(x.long(), weight)
