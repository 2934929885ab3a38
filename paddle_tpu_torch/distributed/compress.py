"""The int8 row codec: ``quantize_rows`` and ``dequantize_rows``.

Ports ``quantize_rows`` (:124) and ``dequantize_rows`` (:146) of
paddle_tpu/distributed/compress.py, the codec the paged KV pool's cold
pages are stored in (serving/paging.py) and the int8 pages of the
paged-attention kernel (ops/tpp.py) are made from. Symmetric int8 over
the last axis with one float32 scale a row (its absmax / 127), rounding
to nearest even (``torch.round``, as ``jnp.round``), so a round trip is
deterministic and within ``absmax / 254`` of the input. A zero row
encodes to zeros with scale 0; a non-finite element poisons its row's
scale, so the row decodes non-finite.

The reference module's gradient codec (stochastic rounding) and its
quantized all-reduce belong to the distributed slice and are not ported.
"""
import torch


def quantize_rows(x):
    """``(q, scales)``: q int8 of x's shape, scales float32 of shape
    ``x.shape[:-1] + (1,)``."""
    scale = x.abs().amax(dim=-1, keepdim=True).float() / 127.0
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(x.float() / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q, scales, dtype=torch.float32):
    """Inverse of :func:`quantize_rows`: int8 rows times their row scale,
    in `dtype`. A zero-scale row decodes to zeros."""
    return (q.float() * scales.float()).to(dtype)
