"""Flash attention: the CUDA kernels, their plain PyTorch versions, and the
autograd Function around them.

Ports paddle_tpu/ops/flash_attention.py. The Pallas `_fwd_kernel` becomes
``csrc/flash_fwd.cu`` and the backward pair `_dq_kernel` / `_dkv_kernel`
becomes ``csrc/flash_bwd.cu`` (the design notes are in each source): one
thread block per (b*h, query or key tile) looping over the other side's
tiles, causal and window tiles skipped whole and masked per element on
their edges. Every kernel runs on the tensor cores and reads 16-byte-aligned
views. In bf16 the forward (head_dim up to 256) and the backward pair (64
and 128) run on mma.sync (cp.async double-buffering, fp32 softmax state
and accumulators); in fp32 the forward and the backward pair at 64 and
128 run on the TF32 tensor cores, each product in three passes (big and
small TF32 parts of each operand) that keep fp32 accuracy. At the other
head dims (the bf16 forward from 320, the bf16 backward and fp32 from
192, any width above 512) a 64-row fp32 accumulator of the whole head
does not fit in registers, nor above 512 a tile of it in shared memory:
the streaming kernels (fp32 and bf16, TF32 in three passes for fp32)
split each output's columns into groups, a block each or (above head
dim 320, or past one wave of the SMs, up to 512) two a block whose
warpgroups share S, and form S (and dP) over the whole head from chunk
tiles of a few columns that cp.async streams through a ring, once per
tile a block visits; the forward in one pass (online softmax). The backward's C
entry computes delta = rowsum(dO o) by a pre-pass kernel unless the
caller passes it. ``flash_attention`` is a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``): it saves
q, k, v, o and lse, and its backward returns dq, dk, dv in q's dtype. Its
forward launches on the card through the custom op
``paddle_tpu_torch::flash_fwd``, which a selective checkpoint sees as one
op (the trainer's ``everything`` recompute policy keeps its outputs), and
its backward through ``paddle_tpu_torch::flash_bwd``. Both ops carry flop
formulas (``torch.utils.flop_counter``) for the cost registry
(trace/costs.py): 4·d a key-query pair forward, 6·d dQ and 8·d dK/dV
(the backward recomputes the scores in both kernels), the pairs counted
as the mask keeps them (s² a head; s(s+1)/2 causal; fewer in a window).
The inference fast path also launches through the op while a dispatch
mode (the FLOP counter) is active, so that it is counted too.

A tensor on a CUDA device launches the kernel or raises; a tensor on the
CPU takes the plain version, ``flash_attention_ref`` forward and
``flash_attention_bwd_ref`` backward. ``launches`` counts kernel launches
by ``"flash_fwd:<dtype>"``, ``"flash_dq:<dtype>"``, ``"flash_dkv:<dtype>"``
and ``"flash_delta:<dtype>"``, where each kernel is launched and nowhere
else; ``routes`` splits the forward, dQ and dK/dV launches by the kernel
the C entry chose (``mma``, ``stream`` or ``tf32x3``).
"""
import collections
import ctypes
import math
import operator
from typing import Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from .. import flags as _flags
from ..amp.auto_cast import disabled as _autocast_off
from . import _build

_NEG = -1e30

#: kernel launches by "flash_fwd:<dtype>", "flash_dq:<dtype>",
#: "flash_dkv:<dtype>" and "flash_delta:<dtype>" (the backward's pre-pass)
launches = collections.Counter()

#: forward, dQ and dK/dV launches by "<kernel>:<dtype>:<route>", route
#: "mma" (the bf16 tensor-core kernels), "tf32x3" (the fp32 ones on the
#: TF32 tensor cores, three passes a product) or "stream" (column groups
#: over chunk tiles), as the C entry reports the kernel it launched: bf16
#: takes "mma" at head_dim 64 and 128, and in the forward also at 192 and
#: 256; fp32 takes "tf32x3" at 64 and 128; every other head dim "stream"
routes = collections.Counter()
_ROUTES = {1: "mma", 3: "stream", 4: "tf32x3"}


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
    fp32 or bf16) with "on TPU" replaced by "on a CUDA device"; the kernels
    take every shape it passes (the head dims that the mma and TF32
    routes leave by the streaming one)."""
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


def _aligned(t):
    """t's pointer and its step along each dimension of more than one
    element (b, s, h) are 16-byte aligned."""
    steps = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in steps)


def _aligned_copy(t):
    """t where its head_dim is contiguous and it is `_aligned`, else a fresh
    contiguous copy (which is: its rows are multiples of 64 elements)."""
    if t.stride(-1) == 1 and _aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_aligned(operands):
    """Every flash kernel copies 16-byte chunks: every operand must be
    `_aligned`."""
    for name, t in operands:
        if not _aligned(t):
            raise ValueError(
                f"flash kernel: {_dtype_name(t.dtype)} {name} must be "
                f"16-byte aligned, its pointer and its (b, s, h) strides "
                f"{t.stride()[:3]}")


def _check_shape(q):
    """The kernels' tilings: fp32/bf16, head_dim a multiple of 64 (above
    512 the streaming route), seq a multiple of 64. Returns q's dtype
    name."""
    B, S, H, D = q.shape
    dtype = _dtype_name(q.dtype)
    if dtype not in ("float32", "bfloat16") or D < 64 or D % 64 or S % 64:
        raise ValueError(
            f"flash kernel takes fp32/bf16, head_dim a multiple of 64 and "
            f"seq a multiple of 64; got {dtype} {(B, S, H, D)}")
    return dtype


_FN = {}


def _kernel(name):
    """(library, C entry) of `flash_fwd` (pointers, B, H, S, D, (b, s, h)
    strides of q, k, v, o, then causal, scale, window, dtype, stream and
    the route out-parameter) or `flash_bwd` (pointers, B, H, S, D, a
    pointer to 24 strides, causal, scale, window, dtype, stream, route),
    with its ctypes signature."""
    if name not in _FN:
        lib = _build.load(name)
        fn = getattr(lib, name)
        if name == "flash_fwd":
            head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
                + [ctypes.c_longlong] * 12
        else:
            head = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
                + [ctypes.POINTER(ctypes.c_longlong)]
        fn.argtypes = head + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _FN[name] = (lib, fn)
    return _FN[name]


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


def _tail(q, causal, scale, window, dtype, route):
    return (int(causal), float(scale), int(window or 0),
            0 if dtype == "float32" else 1,
            _build.stream(q), ctypes.byref(route))


def _launch(q, k, v, causal, scale, window):
    """Run the forward kernel on [B, S, H, D] views (any 16-byte-aligned
    strides over b, s, h; d contiguous).
    Returns (o [B, S, H, D] contiguous, lse [B*H, S] fp32)."""
    dtype = _check_shape(q)
    B, S, H, D = q.shape
    operands = (("q", q), ("k", k), ("v", v))
    _check_operands(operands, q.dtype, (B, S, H, D), q.device)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib, fn = _kernel("flash_fwd")
    route = ctypes.c_int(0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, H, S, D, *_strides(q, k, v, o),
             *_tail(q, causal, scale, window, dtype, route))
    if err:
        # every route refuses a view it cannot copy in 16-byte chunks; say
        # which operand
        _check_aligned(operands)
    _build.check(lib, "flash_fwd", err)
    launches[f"flash_fwd:{dtype}"] += 1
    routes[f"flash_fwd:{dtype}:{_ROUTES[route.value]}"] += 1
    return o, lse


def _check_rows(q, name, t):
    B, S, H, _ = q.shape
    if t.device != q.device or t.dtype != torch.float32 \
            or tuple(t.shape) != (B * H, S) or not t.is_contiguous():
        raise ValueError(
            f"flash kernel: {name} must be a contiguous float32 "
            f"[{B * H}, {S}] array on {q.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _run_bwd(q, k, v, do, lse, causal, scale, window, *, o=None,
             delta=None, dq=False, dkv=False):
    """One call of the backward's C entry on [B, S, H, D] views of q, k, v
    (d contiguous, 16-byte aligned: every route refuses a view that is not,
    before any launch) and dO, and the [B*H, S] fp32 rows lse (None if only
    the pre-pass runs): the delta pre-pass from o when `delta` is None,
    then the dQ kernel if `dq` and the dK/dV kernel if `dkv`. dO and o are
    copied where they are not `_aligned` (the pre-pass and the kernels read
    16-byte chunks of their rows). Returns (delta, dq, dk, dv), None for
    what was not asked."""
    dtype = _check_shape(q)
    B, S, H, D = q.shape
    do = _aligned_copy(do)
    operands = [("q", q), ("k", k), ("v", v), ("dout", do)]
    made = delta is None
    if made:
        o = _aligned_copy(o)
        operands.append(("o", o))
    _check_operands(operands, q.dtype, (B, S, H, D), q.device)
    if lse is not None:
        _check_rows(q, "lse", lse)
    if made:
        delta = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    else:
        _check_rows(q, "delta", delta)

    def grad(want):
        return torch.empty((B, S, H, D), dtype=q.dtype, device=q.device) \
            if want else None

    outs = {"dq": grad(dq), "dk": grad(dkv), "dv": grad(dkv)}
    strides = []
    for t in (q, k, v, o, do, *outs.values()):
        strides += t.stride()[:3] if t is not None else (0, 0, 0)
    ptr = [None if t is None else t.data_ptr() for t in (o, *outs.values())]
    route = ctypes.c_int(0)
    lib, fn = _kernel("flash_bwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr[0], do.data_ptr(),
             None if lse is None else lse.data_ptr(),
             None if made else delta.data_ptr(),
             delta.data_ptr() if made else None, *ptr[1:], B, H, S, D,
             (ctypes.c_longlong * 24)(*strides),
             *_tail(q, causal, scale, window, dtype, route))
    if err:
        # every route refuses a view it cannot copy in 16-byte chunks; say
        # which operand
        _check_aligned(operands + [(n, t) for n, t in outs.items()
                                   if t is not None])
    _build.check(lib, "flash_bwd", err)
    if made:
        launches[f"flash_delta:{dtype}"] += 1
    for kind, want in (("dq", dq), ("dkv", dkv)):
        if want:
            launches[f"flash_{kind}:{dtype}"] += 1
            routes[f"flash_{kind}:{dtype}:{_ROUTES[route.value]}"] += 1
    return delta, outs["dq"], outs["dk"], outs["dv"]


def _launch_dq(q, k, v, do, lse, delta, causal, scale, window):
    """Run the dQ kernel on [B, S, H, D] views of q, k, v, dO and the
    [B*H, S] fp32 rows lse and delta. Returns dq [B, S, H, D]."""
    return _run_bwd(q, k, v, do, lse, causal, scale, window, delta=delta,
                    dq=True)[1]


def _launch_dkv(q, k, v, do, lse, delta, causal, scale, window):
    """Run the dK/dV kernel on the same operands as _launch_dq. Returns
    (dk, dv), each [B, S, H, D]."""
    return _run_bwd(q, k, v, do, lse, causal, scale, window, delta=delta,
                    dkv=True)[2:]


def _launch_delta(o, do):
    """Run the delta pre-pass alone: rowsum(dO o) [B*H, S] fp32 over
    [B, S, H, D] views of o and dO."""
    o = _aligned_copy(o)
    return _run_bwd(o, o, o, do, None, False, 1.0, None, o=o)[0]


def _launch_bwd(q, k, v, o, lse, do, causal, scale, window, delta=None):
    """The backward on [B, S, H, D] views in one call of the C entry: the
    delta pre-pass (rowsum(dO o), unless `delta` [B*H, S] fp32 is given),
    the dQ kernel and the dK/dV kernel. Returns (dq, dk, dv)."""
    if delta is not None:
        delta = delta.contiguous()
    return _run_bwd(q, k, v, do, lse, causal, scale, window, o=o,
                    delta=delta, dq=True, dkv=True)[1:]


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


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float,
                  window: Optional[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch as one op that the dispatcher sees, so
    that a selective checkpoint can keep its outputs instead of launching
    it again in the recompute."""
    return _launch(q, k, v, causal, scale, window)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale, window):
    B, S, H, D = q.shape
    return (q.new_empty((B, S, H, D)),
            q.new_empty((B * H, S), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool, scale: float, window: Optional[int]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's C call (pre-pass, dQ, dK/dV) as one op that the
    dispatcher, and so the FLOP counter, sees."""
    return _launch_bwd(q, k, v, o, lse, do, causal, scale, window)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, scale, window):
    return q.new_empty(q.shape), q.new_empty(q.shape), q.new_empty(q.shape)


def _pairs(s, causal, window):
    """Key-query pairs a head keeps: s², s(s+1)/2 causal, and under a
    window W the last W keys of each query."""
    if not causal:
        return s * s
    w = s if window is None else min(int(window), s)
    return w * (w + 1) // 2 + (s - w) * w


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_fwd)
def _flash_fwd_flops(q, k, v, causal, scale, window, *args, **kwargs):
    B, S, H, D = q
    return 4 * D * _pairs(S, causal, window) * B * H


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_bwd)
def _flash_bwd_flops(q, k, v, o, lse, do, causal, scale, window, *args,
                     **kwargs):
    B, S, H, D = q
    return (6 + 8) * D * _pairs(S, causal, window) * B * H


def _counting():
    """Is a dispatch mode (the FLOP counter of trace/costs.py) active?"""
    return _get_current_dispatch_mode() is not None


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom_vjp: forward saves (q, k, v, o,
    lse), backward runs the dQ and dK/dV kernels (or their plain version
    on the CPU). On the card the forward launches through the custom op
    ``paddle_tpu_torch::flash_fwd``, the backward through
    ``paddle_tpu_torch::flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        b, s, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        if q.is_cuda:      # the launch runs no autocast-affected op
            o, lse = _flash_fwd_op(q, k, v, causal, scale, window)
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
                return (*_flash_bwd_op(q, k, v, o, lse, do, ctx.causal,
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


def _kernel_views(*ts):
    """The views the kernels read: each of `ts` as it is, or copied where
    the kernels cannot read it (the `_aligned_copy` rule: a strided
    head_dim, or a pointer or (b, s, h) step off 16 bytes), in either
    type."""
    return tuple(_aligned_copy(t) for t in ts)


def flash_attention(q, k, v, causal=False, window=None):
    """q, k, v: [b, s, h, d] -> [b, s, h, d] (the reference's layout).
    Differentiable (a torch.autograd.Function over the forward and
    backward kernels). window=W (requires causal=True) keeps only the last
    W tokens; tiles wholly outside the band are skipped by the kernels."""
    window = _check_window(window, causal)
    _block_for(q.shape[1])
    if q.is_cuda:
        q, k, v = _kernel_views(q, k, v)
    if q.is_cuda and not (torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)):
        # inference: the kernel without the autograd Function around it,
        # which costs the host time per call (through the op while the
        # FLOP counter watches)
        launch = _flash_fwd_op if _counting() else _launch
        return launch(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1]),
                      window)[0]
    return _FlashAttention.apply(q, k, v, causal, window)
