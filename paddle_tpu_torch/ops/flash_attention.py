"""Flash attention: the CUDA kernels, their plain PyTorch versions, and the
autograd Function around them.

Ports paddle_tpu/ops/flash_attention.py. The Pallas `_fwd_kernel` becomes
``csrc/flash_fwd.cu`` and the backward pair `_dq_kernel` / `_dkv_kernel`
becomes ``csrc/flash_bwd.cu`` (the design notes are in each source): one
thread block per (b*h, query or key tile) looping over the other side's
tiles, causal and window tiles skipped whole and masked per element on
their edges. The bf16 forward runs on the tensor cores (mma.sync, 128-row
query tiles, K and V double-buffered by cp.async, fp32 softmax state); the
fp32 forward and the backward pair use 64-row tiles and fp32 FMAs out of
shared memory. ``flash_attention`` is a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``): it saves
q, k, v, o and lse, and its backward returns dq, dk, dv in q's dtype.

A tensor on a CUDA device launches the kernel or raises; a tensor on the
CPU takes the plain version, ``flash_attention_ref`` forward and
``flash_attention_bwd_ref`` backward. ``launches`` counts kernel launches
by ``"flash_fwd:<dtype>"``, ``"flash_dq:<dtype>"`` and
``"flash_dkv:<dtype>"``, where each kernel is launched and nowhere else.
"""
import collections
import ctypes
import math
import operator

import torch

from .. import flags as _flags
from ..amp.auto_cast import disabled as _autocast_off
from . import _build

_NEG = -1e30

#: kernel launches by "flash_fwd:<dtype>", "flash_dq:<dtype>" and
#: "flash_dkv:<dtype>"
launches = collections.Counter()

#: the head dims csrc/flash_fwd.cu and csrc/flash_bwd.cu have a tiling for;
#: a wider head's fp32 tiles do not fit in a block's shared memory (the
#: bf16 forward takes 32-row K and V tiles at 192 and 256)
KERNEL_HEAD_DIMS = (64, 128, 192, 256)


def _block_for(s):
    """Largest of 512/256/128 that tiles seq exactly, or the size
    FLAGS_flash_attention_block forces. This is the reference's block; the
    CUDA kernels tile by their own rows (128 query rows in the bf16
    forward, 64 elsewhere) whatever it says, so here it only keeps the
    reference's validation of seq and of the flag."""
    forced = _flags.get_flag("flash_attention_block", 0)
    if forced:
        if forced not in (128, 256, 512) or s % forced:
            raise ValueError(
                f"FLAGS_flash_attention_block={forced} must be 128/256/512 "
                f"and divide seq {s}")
        return forced
    for blk in (512, 256, 128):
        if s % blk == 0:
            return blk
    raise ValueError(f"seq {s} not divisible by 128")


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def supported(q_shape, dtype_str, device="cuda"):
    """Does SDPA route q [batch, seq, heads, head_dim] to the kernel? The
    reference's gate (head_dim % 64 == 0, seq % 128 == 0, seq >= 1024,
    fp32 or bf16) with "on TPU" replaced by "on a CUDA device". A shape it
    passes that the kernel has no tiling for (head_dim above 256) raises
    in the kernel's wrapper; it never falls back to the plain version."""
    if len(q_shape) != 4:
        return False
    _, s, _, d = q_shape
    if torch.device(device).type != "cuda":
        return False
    if d % 64 != 0 or s % 128 != 0 or s < 1024:
        return False
    return _dtype_name(dtype_str) in ("float32", "bfloat16")


def _check_window(window, causal):
    """The reference's window validation (flash_attention.py:463-474):
    a positive int (numpy ints too, bools refused), causal only."""
    if window is None:
        return None
    if not causal:
        raise ValueError("window requires causal=True")
    if isinstance(window, bool):
        raise ValueError(f"window must be a positive int, got {window!r}")
    try:
        window = int(operator.index(window))
    except TypeError:
        raise ValueError(
            f"window must be a positive int, got {window!r}") from None
    if window < 1:
        raise ValueError(f"window must be a positive int, got {window!r}")
    return window


def _keep_mask(s_q, s_k, window, device):
    """The reference's `_causal_mask` rule as a [s_q, s_k] keep-mask:
    k_pos <= q_pos, and q_pos - k_pos < window."""
    qp = torch.arange(s_q, device=device)[:, None]
    kp = torch.arange(s_k, device=device)[None, :]
    keep = kp <= qp
    if window is not None:
        keep &= (qp - kp) < window
    return keep


def flash_attention_ref(q3, k3, v3, causal, scale, window=None):
    """Plain PyTorch forward over q3/k3/v3 [bh, s, d]: fp32 scores
    (q * scale) k^T, the reference's mask (keep k_pos <= q_pos, and
    q_pos - k_pos < window), softmax. Returns (o [bh, s, d] in q3's dtype,
    lse [bh, s] fp32)."""
    qf = q3.float() * scale
    scores = qf @ k3.float().transpose(-1, -2)              # [bh, s, s]
    if causal:
        scores = scores.masked_fill(
            ~_keep_mask(*scores.shape[-2:], window, q3.device), _NEG)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    o = (p @ v3.float()) / l
    return o.to(q3.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_ref(q3, k3, v3, o3, lse, do3, causal, scale,
                            delta=None, window=None):
    """Plain PyTorch backward over [bh, s, d] arrays, the reference
    kernels' math in fp32: P = exp((q * scale) k^T - lse) under the
    forward's mask, dP = dO v^T, dS = P (dP - delta) with delta =
    rowsum(dO o) unless given, dq = scale dS k, dk = dS^T (q * scale),
    dv = P^T dO. Returns (dq, dk, dv) in q3's dtype."""
    qf = q3.float() * scale
    kf, vf, dof = k3.float(), v3.float(), do3.float()
    if delta is None:
        delta = (dof * o3.float()).sum(-1)                  # [bh, s]
    p = torch.exp(qf @ kf.transpose(-1, -2) - lse[..., None])
    if causal:
        p = p.masked_fill(~_keep_mask(*p.shape[-2:], window, q3.device), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ dof
    return dq.to(q3.dtype), dk.to(q3.dtype), dv.to(q3.dtype)


def _check_operands(operands, dtype, shape, device):
    """Every kernel operand (name, tensor) must lie on `device` with q's
    dtype and [B, S, H, D] shape, and a contiguous head_dim."""
    for name, t in operands:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"flash kernel: {name} must lie on {device}, "
                             f"got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"flash kernel: {name} is {t.dtype} {tuple(t.shape)}, "
                f"expected {dtype} {shape}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash kernel: {name} needs a contiguous "
                             f"head_dim, got strides {t.stride()}")


def _check_aligned(operands):
    """The bf16 forward copies 16-byte chunks: every operand's pointer and
    its step along each dimension of more than one element (b, s, h) must
    be 16-byte aligned."""
    for name, t in operands:
        steps = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in steps):
            raise ValueError(
                f"flash kernel: bf16 {name} must be 16-byte aligned, its "
                f"pointer and its (b, s, h) strides {t.stride()[:3]}")


def _check_shape(q):
    """The kernels' tilings: fp32/bf16, head_dim in KERNEL_HEAD_DIMS, seq a
    multiple of 64, b*h within the grid. Returns q's dtype name."""
    B, S, H, D = q.shape
    dtype = _dtype_name(q.dtype)
    if dtype not in ("float32", "bfloat16") or D not in KERNEL_HEAD_DIMS \
            or S % 64 or B * H > 65535:
        raise ValueError(
            f"flash kernel takes fp32/bf16, head_dim in {KERNEL_HEAD_DIMS}, "
            f"seq a multiple of 64 and b*h <= 65535; got {dtype} "
            f"{(B, S, H, D)}")
    return dtype


_FN = {}


def _kernel(name):
    """(library, C entry) of kernel `name`: flash_fwd, flash_dq or
    flash_dkv, with its ctypes signature (pointers, then B, H, S, D, then
    (b, s, h) strides per tensor, then causal, scale, window, dtype,
    stream)."""
    if name not in _FN:
        n_ptr, n_strided = {"flash_fwd": (5, 4), "flash_dq": (7, 5),
                            "flash_dkv": (8, 6)}[name]
        lib = _build.load("flash_fwd" if name == "flash_fwd" else "flash_bwd")
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * (3 * n_strided)
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[name] = (lib, fn)
    return _FN[name]


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


def _tail(q, causal, scale, window, dtype):
    return (int(causal), float(scale), int(window or 0),
            0 if dtype == "float32" else 1,
            _build.stream(q))


def _launch(q, k, v, causal, scale, window):
    """Run the forward kernel on [B, S, H, D] views (any strides over b, s,
    h, 16-byte aligned in bf16; d contiguous). Returns (o [B, S, H, D]
    contiguous, lse [B*H, S] fp32)."""
    dtype = _check_shape(q)
    B, S, H, D = q.shape
    operands = (("q", q), ("k", k), ("v", v))
    _check_operands(operands, q.dtype, (B, S, H, D), q.device)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib, fn = _kernel("flash_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, H, S, D, *_strides(q, k, v, o),
             *_tail(q, causal, scale, window, dtype))
    if err and dtype == "bfloat16":
        # the C entry refuses a view it cannot copy in 16-byte chunks;
        # say which operand
        _check_aligned(operands)
    _build.check(lib, "flash_fwd", err)
    launches[f"flash_fwd:{dtype}"] += 1
    return o, lse


def _check_rows(q, lse, delta):
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (B * H, S) or not t.is_contiguous():
            raise ValueError(
                f"flash kernel: {name} must be a contiguous float32 "
                f"[{B * H}, {S}] array on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _launch_dq(q, k, v, do, lse, delta, causal, scale, window):
    """Run the dQ kernel on [B, S, H, D] views of q, k, v, dO and the
    [B*H, S] fp32 rows lse and delta. Returns dq [B, S, H, D]."""
    dtype = _check_shape(q)
    B, S, H, D = q.shape
    _check_operands((("q", q), ("k", k), ("v", v), ("dout", do)), q.dtype,
                    (B, S, H, D), q.device)
    _check_rows(q, lse, delta)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib, fn = _kernel("flash_dq")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, S, D,
             *_strides(q, k, v, do, dq),
             *_tail(q, causal, scale, window, dtype))
    _build.check(lib, "flash_bwd", err)
    launches[f"flash_dq:{dtype}"] += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, scale, window):
    """Run the dK/dV kernel on the same operands as _launch_dq. Returns
    (dk, dv), each [B, S, H, D]."""
    dtype = _check_shape(q)
    B, S, H, D = q.shape
    _check_operands((("q", q), ("k", k), ("v", v), ("dout", do)), q.dtype,
                    (B, S, H, D), q.device)
    _check_rows(q, lse, delta)
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib, fn = _kernel("flash_dkv")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, H, S, D, *_strides(q, k, v, do, dk, dv),
             *_tail(q, causal, scale, window, dtype))
    _build.check(lib, "flash_bwd", err)
    launches[f"flash_dkv:{dtype}"] += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, causal, scale, window, delta=None):
    """Both backward kernels on [B, S, H, D] views. delta [B*H, S] fp32 =
    rowsum(dO o) is computed here with torch ops unless given, as the
    reference computes it outside Pallas. Returns (dq, dk, dv)."""
    if do.stride(-1) != 1:
        do = do.contiguous()      # the kernels read d contiguously
    if delta is None:
        B, S, H, _ = q.shape
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .reshape(B * H, S)
    delta = delta.contiguous()
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale, window)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, scale, window)
    return dq, dk, dv


def _flash_fwd(q3, k3, v3, causal, scale, window=None):
    """q3/k3/v3: [bh, s, d] -> (o [bh, s, d], lse [bh, s] fp32). window:
    sliding-window causal attention (keep q_pos - k_pos < window)."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    _block_for(q3.shape[1])
    if not q3.is_cuda:
        return flash_attention_ref(q3, k3, v3, causal, scale, window)
    o, lse = _launch(q3.unsqueeze(2), k3.unsqueeze(2), v3.unsqueeze(2),
                     causal, scale, window)
    return o.squeeze(2), lse


def _flash_bwd(q3, k3, v3, o3, lse, do3, causal, scale, delta=None,
               window=None):
    """[bh, s, d] arrays and the forward's lse [bh, s] -> (dq, dk, dv) in
    q3's dtype. delta [bh, s] fp32 = rowsum(dO o) may be passed in (ring
    attention computes it once for every hop); otherwise it is computed
    here."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    _block_for(q3.shape[1])
    if not q3.is_cuda:
        return flash_attention_bwd_ref(q3, k3, v3, o3, lse, do3, causal,
                                       scale, delta=delta, window=window)
    grads = _launch_bwd(q3.unsqueeze(2), k3.unsqueeze(2), v3.unsqueeze(2),
                        o3.unsqueeze(2), lse, do3.unsqueeze(2), causal, scale,
                        window, delta=delta)
    return tuple(g.squeeze(2) for g in grads)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom_vjp: forward saves (q, k, v, o,
    lse), backward runs the dQ and dK/dV kernels (or their plain version
    on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        b, s, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        if q.is_cuda:      # the launch runs no autocast-affected op
            o, lse = _launch(q, k, v, causal, scale, window)
        else:
            with _autocast_off():
                o3, lse = flash_attention_ref(_heads(q), _heads(k),
                                              _heads(v), causal, scale,
                                              window)
            o = _unheads(o3, b, h)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, _, h, _ = q.shape
        with _autocast_off():
            if q.is_cuda:
                return (*_launch_bwd(q, k, v, o, lse, do, ctx.causal,
                                     ctx.scale, ctx.window), None, None)
            grads = flash_attention_bwd_ref(
                _heads(q), _heads(k), _heads(v), _heads(o), lse, _heads(do),
                ctx.causal, ctx.scale, window=ctx.window)
        return (*(_unheads(g, b, h) for g in grads), None, None)


def _heads(t):
    """[b, s, h, d] -> [b*h, s, d]."""
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d)


def _unheads(t, b, h):
    """[b*h, s, d] -> [b, s, h, d]."""
    return t.reshape(b, h, *t.shape[1:]).transpose(1, 2)


def flash_attention(q, k, v, causal=False, window=None):
    """q, k, v: [b, s, h, d] -> [b, s, h, d] (the reference's layout).
    Differentiable (a torch.autograd.Function over the forward and
    backward kernels). window=W (requires causal=True) keeps only the last
    W tokens; tiles wholly outside the band are skipped by the kernels."""
    window = _check_window(window, causal)
    _block_for(q.shape[1])
    if q.is_cuda and not (torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)):
        # inference: the kernel without the autograd Function around it,
        # which costs the host time per call
        return _launch(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1]),
                       window)[0]
    return _FlashAttention.apply(q, k, v, causal, window)
