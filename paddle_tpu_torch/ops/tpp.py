"""TPP micro-kernels: the blocked matmul with the autograd Functions
around it and the GPT block hook, and the row primitives; each CUDA
kernel beside its plain PyTorch version.

Ports paddle_tpu/ops/tpp.py: ``pick_block``, ``supported_2d``,
``ln_matmul_supported``, ``matmul``, ``ln_matmul``, ``fused_mlp``,
``_fused_tail``, ``gpt_block_mlp``, ``bias_act``, ``softmax_rows`` and
``masked_reduce``, and ``_PAGED_AUDIT_SHAPES``, ``paged_attention`` and
``paged_attention_ref``. The Pallas ``_matmul_kernel`` becomes
``csrc/tpp_matmul.cu`` (the design notes are there): one C entry computes
``act(in_act(LN?(x)) @ w + bias)`` with an fp32 accumulator, the
LayerNorm prologue (``ln_matmul``) and the gelu-on-load + bias variant
(``_fused_tail``) being two of its modes. In bf16 it runs on the tensor
cores (TMA and wgmma, 128-row tiles, 128 to 256 columns), in fp32 on the
CUDA cores (128 x 128 tiles); the LN mode's row mean and rstd come from a
small pre-pass kernel of the same source. The row primitives'
``_bias_act_kernel``, ``_softmax_kernel`` and ``_masked_reduce_kernel``
become the three kernels of ``csrc/tpp_rowwise.cu``. None of the three has
a backward in the reference, so none has one here. The block-table decode
attention ``_paged_attention_kernel`` becomes ``csrc/paged_attention.cu``
(dense pages, or int8 pages with f32 row scales).

``ln_matmul``, ``fused_mlp`` and ``_fused_tail`` are
``torch.autograd.Function``s, the counterparts of the reference's
custom_vjps: the forward runs the kernel, the backward is plain PyTorch —
autograd of the op's fp32 reference math (``_matmul_ref`` with the LN
prologue or the gelu on its input, and ``_mlp_ref``), as the reference's
backward is ``jax.vjp`` of its ``_ln_matmul_ref`` / ``_mlp_ref`` /
``_fused_tail_ref``, with grads cast back to the input dtypes.
Both run with autocast off, so an enclosing bf16 autocast never turns
that fp32 math into bf16 products. ``matmul`` alone has no backward, as
in the reference. The Functions' forwards launch on the card through the
custom op ``paddle_tpu_torch::tpp_matmul``, which a selective checkpoint
sees as one op, and which carries a flop formula (2·M·N·K) for the cost
registry (trace/costs.py); the inference path launches through it too
while a dispatch mode (the FLOP counter) is active.

A tensor on a CUDA device launches the kernel or raises; each public
entry first copies what its kernel cannot read as it is (a strided
operand, a w with no contiguous dimension, an fp16 row array or q
computed in fp32 and cast back, pages of another dtype than the kernel
takes), and the private ``_launch*`` functions refuse it. A tensor on the
CPU takes the plain version (``_matmul_ref``, ``_row_stats_ref``,
``_bias_act_ref``,
``_softmax_rows_ref``, ``_masked_reduce_ref``, ``paged_attention_ref``).
``launches`` counts kernel launches by ``"tpp_matmul.<variant>:<dtype>"``
(variant ``plain``, ``ln`` or ``in_act``), ``"tpp_row_stats:<dtype>"``
(the LN pre-pass), ``"tpp_bias_act:<act>:<dtype>"``,
``"tpp_softmax_rows:<dtype>"``, ``"tpp_masked_reduce:<kind>:<dtype>"`` and
``"tpp_paged_attention.<dense|int8>:<q dtype>"``, where each kernel is
launched and nowhere else; ``routes`` splits the TPP matmul's launches
by the kernel the C entry chose (``wgmma`` or ``simt``), softmax_rows's
(``register`` or ``block``) and paged attention's (``split``, ``stream``
or ``stream_direct``).
"""
import collections
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from ..amp.auto_cast import disabled as _autocast_off
from . import _build

_LN_EPS = 1e-5   # nn.LayerNorm's default epsilon (the only one GPT uses)

#: kernel launches by "tpp_matmul.<variant>:<dtype>", "tpp_row_stats:<dtype>"
#: and the row primitives' keys
launches = collections.Counter()

#: TPP matmul launches by "tpp_matmul.<variant>:<dtype>:<route>", route
#: "wgmma" (the tensor-core kernel) or "simt" (the CUDA-core one), and
#: softmax_rows launches by "tpp_softmax_rows:<dtype>:<route>", route
#: "register" (the row held in registers by one to four warps: 16-byte
#: aligned rows of a whole number of 16-byte vectors, at most 2,048 long)
#: or "block" (a block a row), as the C entry reports the kernel it
#: launched; paged attention's by "tpp_paged_attention.<dense|int8>:<q
#: dtype>:<route>", route "split", "stream" (the stream kernel's ring of
#: bulk copies) or "stream_direct" (its one-element loads)
routes = collections.Counter()
_ROUTES = {1: "wgmma", 2: "simt"}
_SOFTMAX_ROUTES = {1: "register", 2: "block"}

#: candidate block edges of the reference registry; the CUDA kernels tile
#: by 128 rows (128 to 256 columns) and mask ragged edges, so these only
#: gate which shapes the hook sends to them, exactly as the reference gates
#: its own kernel
_BLOCK_EDGES = (256, 128, 64, 32, 16, 8)

_ACTS = ("none", "gelu", "gelu_tanh", "relu")


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def pick_block(dim):
    """Largest registry block edge dividing `dim` (None if indivisible —
    callers fall back to the dense path)."""
    for b in _BLOCK_EDGES:
        if dim % b == 0:
            return b
    return None


def supported_2d(m, k, n, dtype):
    """Can the registry tile an [m, k] @ [k, n] op? Returns the
    (bm, bn, bk) block shape, or None."""
    if _dtype_name(dtype) not in ("float32", "bfloat16"):
        return None
    bm, bk, bn = pick_block(m), pick_block(k), pick_block(n)
    if bm is None or bk is None or bn is None:
        return None
    return (bm, bn, bk)


def ln_matmul_supported(m, k, n, dtype):
    """Tiling gate for the ln_matmul port (the reference pins bk to k)."""
    return (_dtype_name(dtype) in ("float32", "bfloat16")
            and pick_block(m) is not None and pick_block(n) is not None)


def _apply_act(x, act):
    if act == "gelu":
        return F.gelu(x, approximate="none")
    if act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    return x


def _check_act(act):
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")


def _matmul_ref(x, w, bias=None, in_act="none", act="none", gamma=None,
                beta=None):
    """Plain PyTorch version of the kernel: fp32 math on the upcast
    operands, ``act(in_act(LN?(x)) @ w + bias)``, cast to x's dtype. The
    LN (when gamma is given) takes the full-row mean and mean squared
    deviation, eps 1e-5."""
    xf = x.float()
    if gamma is not None:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) * (xf - mu)).mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + _LN_EPS)
        xf = xf * gamma.float() + beta.float()
    acc = _apply_act(xf, in_act) @ w.float()
    if bias is not None:
        acc = acc + bias.float()
    return _apply_act(acc, act).to(x.dtype)


_FN = []


def _kernel():
    """(library, matmul entry, row-statistics entry), argtypes set."""
    if not _FN:
        lib = _build.load("tpp_matmul")
        fn = lib.tpp_matmul
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        stats = lib.tpp_row_stats
        stats.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        stats.restype = ctypes.c_int
        _FN.append((lib, fn, stats))
    return _FN[0]


def _row_stats_ref(x):
    """Plain version of the LN pre-pass: each row's mean and rstd (eps
    1e-5) over its full row in fp32, as a float32 [2, m] array."""
    xf = x.float()
    mu = xf.mean(-1)
    var = ((xf - mu[:, None]) * (xf - mu[:, None])).mean(-1)
    return torch.stack([mu, torch.rsqrt(var + _LN_EPS)])


def _row_stats(x):
    """The LN prologue's pre-pass: each row's mean and rstd over its full
    K row in fp32, as a float32 [2, m] array (mean, then rstd)."""
    if not x.is_cuda:
        return _row_stats_ref(x)
    m, k = x.shape
    dtype = _dtype_name(x.dtype)
    stats = torch.empty((2, m), dtype=torch.float32, device=x.device)
    lib, _, fn = _kernel()
    err = fn(x.data_ptr(), stats.data_ptr(), m, k,
             0 if dtype == "float32" else 1, _build.stream(x))
    _build.check(lib, "tpp_matmul", err)
    launches[f"tpp_row_stats:{dtype}"] += 1
    return stats


def _launch(x, w, bias, in_act, act, gamma=None, beta=None):
    """Run the kernel: x a contiguous [m, k] array, w [k, n] with either
    dimension contiguous (a [k, n] array, or an nn.Linear weight [n, k]
    seen through .t()), bias [n], gamma/beta [k]. With gamma the C entry
    launches the row statistics pre-pass first, into a scratch allocated
    here (one host call for both launches). bf16 takes the tensor-core kernel
    where TMA can read the operands (k and w's strided step multiples of
    8; x, w, gamma and beta 16-byte aligned), else the CUDA-core one, as
    fp32 does."""
    m, k = x.shape
    n = w.shape[1]
    operands = [("x", x, (m, k)), ("w", w, (k, n))]
    if bias is not None:
        operands.append(("bias", bias, (n,)))
    if gamma is not None:
        operands += [("gamma", gamma, (k,)), ("beta", beta, (k,))]
    for name, t, shape in operands:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"tpp kernel: {name} must lie on {x.device}, "
                             f"got {t.device}")
        if t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"tpp kernel: {name} is {t.dtype} {tuple(t.shape)}, "
                f"expected {x.dtype} {shape}")
        if name != "w" and not t.is_contiguous():
            raise ValueError(f"tpp kernel: {name} must be contiguous")
    if w.stride(0) != 1 and w.stride(1) != 1:
        raise ValueError(f"tpp kernel: w needs one contiguous dimension, "
                         f"got strides {w.stride()}")
    dtype = _dtype_name(x.dtype)
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"tpp kernel takes fp32 or bf16, got {dtype}")
    stats = None if gamma is None else \
        torch.empty((2, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib, fn, _ = _kernel()
    swk, swn = w.stride()
    route = ctypes.c_int(0)
    err = fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(),
             None if gamma is None else gamma.data_ptr(),
             None if beta is None else beta.data_ptr(),
             None if stats is None else stats.data_ptr(), out.data_ptr(),
             m, n, k, swk, swn, _ACTS.index(in_act), _ACTS.index(act),
             int(gamma is not None), 0 if dtype == "float32" else 1,
             _build.stream(x), ctypes.byref(route))
    _build.check(lib, "tpp_matmul", err)
    variant = "ln" if gamma is not None else \
        "in_act" if in_act != "none" else "plain"
    if gamma is not None:
        launches[f"tpp_row_stats:{dtype}"] += 1
    launches[f"tpp_matmul.{variant}:{dtype}"] += 1
    routes[f"tpp_matmul.{variant}:{dtype}:{_ROUTES[route.value]}"] += 1
    return out


def _contiguous(t):
    return t if t is None or t.is_contiguous() else t.contiguous()


def _run(x, w, bias, in_act, act, gamma=None, beta=None):
    """The kernel on a CUDA tensor (no autocast-affected op runs there),
    else the plain version with autocast off. What the kernel cannot read
    as it is goes in as a contiguous copy: a strided x, bias, gamma or
    beta, and a w with no contiguous dimension."""
    if x.is_cuda:
        if w.stride(0) != 1 and w.stride(1) != 1:
            w = w.contiguous()
        # through the op while the FLOP counter (a dispatch mode) watches
        launch = _tpp_matmul_op if _get_current_dispatch_mode() is not None \
            else _launch
        return launch(_contiguous(x), w, _contiguous(bias), in_act, act,
                      _contiguous(gamma), _contiguous(beta))
    with _autocast_off():
        return _matmul_ref(x, w, bias, in_act, act, gamma, beta)


@torch.library.custom_op("paddle_tpu_torch::tpp_matmul", mutates_args=())
def _tpp_matmul_op(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], in_act: str, act: str,
                   gamma: Optional[torch.Tensor],
                   beta: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's launch as one op that the dispatcher sees, so that a
    selective checkpoint can keep its output instead of launching it again
    in the recompute."""
    return _launch(x, w, bias, in_act, act, gamma, beta)


@_tpp_matmul_op.register_fake
def _(x, w, bias, in_act, act, gamma, beta):
    return x.new_empty((x.shape[0], w.shape[1]))


@register_flop_formula(torch.ops.paddle_tpu_torch.tpp_matmul)
def _tpp_matmul_flops(x, w, *args, **kwargs):
    """2·M·N·K for the cost registry (trace/costs.py); the LN prologue,
    the activations and the bias count 0, as aten's addmm formula counts
    them."""
    (m, k), (_, n) = x, w
    return 2 * m * k * n


def _run_fwd(x, w, bias, in_act, act, gamma=None, beta=None):
    """_run in an autograd Function's forward: on the card through the
    custom op ``paddle_tpu_torch::tpp_matmul``."""
    if not x.is_cuda:
        return _run(x, w, bias, in_act, act, gamma, beta)
    if w.stride(0) != 1 and w.stride(1) != 1:
        w = w.contiguous()
    return _tpp_matmul_op(_contiguous(x), w, _contiguous(bias), in_act, act,
                          _contiguous(gamma), _contiguous(beta))


def matmul(x, w, bias=None, in_act="none", act="none"):
    """Blocked matmul-accumulate: ``act(in_act(x) @ w + bias)``.
    x [m, k], w [k, n] (an nn.Linear weight passes as ``weight.t()``);
    raises when the reference's registry could not tile the shapes (check
    :func:`supported_2d`)."""
    _check_act(in_act), _check_act(act)
    m, k = x.shape
    n = w.shape[1]
    if supported_2d(m, k, n, x.dtype) is None:
        raise ValueError(
            f"tpp.matmul cannot tile [{m},{k}]@[{k},{n}] {x.dtype} — "
            "gate on supported_2d() and fall back to the dense path")
    if x.is_cuda and _grad_needed(x, w, bias):
        raise NotImplementedError(
            "tpp.matmul has no backward (as in the reference): use "
            "ln_matmul, fused_mlp or _fused_tail, or call it under "
            "torch.no_grad()")
    return _run(x, w, bias, in_act, act)


def _mlp_ref(x, w1, b1, w2, b2, approx):
    """The reference's ``_mlp_ref``: ``gelu(x @ w1 + b1) @ w2 + b2`` in
    fp32, cast to x's dtype."""
    act = "gelu_tanh" if approx else "gelu"
    h = _apply_act(x.float() @ w1.float() + b1.float(), act)
    return (h @ w2.float() + b2.float()).to(x.dtype)


def _grad_needed(*ts):
    """Would autograd record a graph through these tensors? Where it would
    not (inference), the CUDA path launches the kernel without the
    autograd Function around it, which costs the host time per call."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _vjp(ref, inputs, g):
    """The grads of ``ref(*inputs)`` against cotangent g, by autograd of
    the plain math (the reference's ``jax.vjp`` of its ``*_ref``): fp32
    inside, each grad in its input's dtype, autocast off."""
    with torch.enable_grad(), _autocast_off():
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in inputs]
        out = ref(*leaves)
        grads = iter(torch.autograd.grad(
            out, [t for t in leaves if t is not None], g))
    return tuple(None if t is None else next(grads) for t in leaves)


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        return _run_fwd(x, w, bias, "none", "none", gamma, beta)

    @staticmethod
    def backward(ctx, g):
        return _vjp(lambda x, gamma, beta, w, bias: _matmul_ref(
            x, w, bias, gamma=gamma, beta=beta), ctx.saved_tensors, g)


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, approx):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.approx = approx
        act = "gelu_tanh" if approx else "gelu"
        # leg 1: x @ w1 + b1, the one intermediate in device memory;
        # leg 2: gelu on the second matmul's loads, + b2 on the way out
        h = _run_fwd(x, w1, b1, "none", "none")
        return _run_fwd(h, w2, b2, act, "none")

    @staticmethod
    def backward(ctx, g):
        approx = ctx.approx
        grads = _vjp(lambda *a: _mlp_ref(*a, approx), ctx.saved_tensors, g)
        return (*grads, None)


class _FusedTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, w2, b2, approx):
        ctx.save_for_backward(pre, w2, b2)
        ctx.approx = approx
        return _run_fwd(pre, w2, b2, "gelu_tanh" if approx else "gelu",
                        "none")

    @staticmethod
    def backward(ctx, g):
        approx = ctx.approx
        act = "gelu_tanh" if approx else "gelu"
        grads = _vjp(lambda pre, w2, b2: _matmul_ref(pre, w2, b2, act),
                     ctx.saved_tensors, g)
        return (*grads, None)


def ln_matmul(x, gamma, beta, w, bias):
    """Fused layernorm -> matmul prologue: ``LN(x; gamma, beta) @ w +
    bias``, the normalized rows living only in the kernel's tiles.
    Differentiable (reference-math backward). x [m, k], w [k, n]; m and n
    must tile (:func:`ln_matmul_supported`)."""
    m, k = x.shape
    n = w.shape[1]
    if not ln_matmul_supported(m, k, n, x.dtype):
        raise ValueError(f"tpp.ln_matmul cannot tile [{m},{k}]@[{k},{n}] "
                         f"{x.dtype}")
    if x.is_cuda and not _grad_needed(x, gamma, beta, w, bias):
        return _run(x, w, bias, "none", "none", gamma, beta)
    return _LnMatmul.apply(x, gamma, beta, w, bias)


def fused_mlp(x, w1, b1, w2, b2, approx=False):
    """The GPT MLP block ``gelu(x @ w1 + b1) @ w2 + b2`` through two
    kernel launches, gelu fused into the second one's loads.
    Differentiable (reference-math backward). x [m, k]; both matmuls must
    tile (:func:`supported_2d`)."""
    m, k = x.shape
    inter, n = w1.shape[1], w2.shape[1]
    if supported_2d(m, k, inter, x.dtype) is None \
            or supported_2d(m, inter, n, x.dtype) is None:
        raise ValueError(f"tpp.fused_mlp cannot tile [{m},{k}]@[{k},"
                         f"{inter}]@[{inter},{n}] {x.dtype}")
    return _FusedMlp.apply(x, w1, b1, w2, b2, approx)


def _fused_tail(pre, w2, b2, approx):
    """gelu + projection half of the MLP block: gelu applied to the
    pre-activation hidden as its tiles load, then ``@ w2 + b2``.
    Differentiable (reference-math backward)."""
    m, k = pre.shape
    n = w2.shape[1]
    if supported_2d(m, k, n, pre.dtype) is None:
        raise ValueError(f"tpp.matmul cannot tile [{m},{k}]@[{k},{n}] "
                         f"{pre.dtype}")
    if pre.is_cuda and not _grad_needed(pre, w2, b2):
        return _run(pre, w2, b2, "gelu_tanh" if approx else "gelu", "none")
    return _FusedTail.apply(pre, w2, b2, approx)


def gpt_block_mlp(x, ln, mlp):
    """The GPT block's MLP path ``fc2(gelu(fc1(LN(x))))`` through the two
    ported ops: ln_matmul covers ln2 + fc1, the fused tail covers
    gelu + fc2. Takes the [b, s, h] residual stream, the block's
    nn.LayerNorm and its GPTMLP (nn.Linear weights [out, in], read through
    their transpose without a copy); returns [b, s, h], or None when the
    shapes or dtype don't tile or the LayerNorm's eps is not 1e-5 (the
    caller takes the dense path)."""
    b, s, h = x.shape
    w1, b1 = mlp.fc1.weight.t(), mlp.fc1.bias
    w2, b2 = mlp.fc2.weight.t(), mlp.fc2.bias
    inter = w1.shape[1]
    m = b * s
    if not ln_matmul_supported(m, h, inter, x.dtype) \
            or supported_2d(m, inter, h, x.dtype) is None \
            or getattr(ln, "eps", _LN_EPS) != _LN_EPS:
        return None
    pre = ln_matmul(x.reshape(m, h), ln.weight, ln.bias, w1, b1)
    out = _fused_tail(pre, w2, b2, getattr(mlp, "_gelu_approx", False))
    return out.reshape(b, s, h)


# ---- the row primitives (csrc/tpp_rowwise.cu) ------------------------------

_ROW_FN = {}
_KINDS = ("sum", "max")


def _row_kernel(name):
    """(library, C entry) of csrc/tpp_rowwise.cu's `name`, argtypes set."""
    if name not in _ROW_FN:
        lib = _build.load("tpp_rowwise")
        fn = getattr(lib, name)
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "tpp_bias_act": [vp, vp, vp, ctypes.c_longlong, i, i, i, i, vp],
            "tpp_softmax_rows": [vp, vp, i, i, i, vp,
                                 ctypes.POINTER(i)],
            "tpp_masked_reduce": [vp, vp, vp, i, i, i, i, i, vp]}[name]
        fn.restype = ctypes.c_int
        _ROW_FN[name] = (lib, fn)
    return _ROW_FN[name]


def _check_rows(what, x, *others):
    """Raise unless x is a contiguous fp32/bf16 2-D CUDA tensor and the
    others lie on its device. Returns x's dtype name."""
    dtype = _dtype_name(x.dtype)
    if x.ndim != 2 or dtype not in ("float32", "bfloat16"):
        raise ValueError(f"tpp.{what} kernel takes a 2-D fp32 or bf16 x, "
                         f"got {dtype} {tuple(x.shape)}")
    for t in (x, *others):
        if not t.is_cuda or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"tpp.{what} kernel: operands must be "
                             f"contiguous and lie on {x.device}")
    return dtype


def _rows_readable(x):
    """(x as the row kernels read it, the dtype to return): a contiguous
    fp32 or bf16 array; any other floating x computes in fp32 (as the
    reference's kernel does in every dtype) and its result is cast back."""
    want = x.dtype
    if x.dtype not in (torch.float32, torch.bfloat16) \
            and x.is_floating_point():
        x = x.float()
    return _contiguous(x), want


def _bias_act_ref(x, bias, act):
    """Plain version: ``act(x + bias)`` in fp32, cast to x's dtype."""
    return _apply_act(x.float() + bias.float(), act).to(x.dtype)


def _launch_bias_act(x, bias, act):
    bias = bias.float().contiguous()
    dtype = _check_rows("bias_act", x, bias)
    m, n = x.shape
    if tuple(bias.shape) != (n,):
        raise ValueError(f"tpp.bias_act: bias must be [{n}], got "
                         f"{tuple(bias.shape)}")
    out = torch.empty_like(x)
    vec = 4 if dtype == "float32" else 8
    use_vec = n % vec == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    lib, fn = _row_kernel("tpp_bias_act")
    err = fn(x.data_ptr(), bias.data_ptr(), out.data_ptr(), m * n, n,
             _ACTS.index(act), 0 if dtype == "float32" else 1, int(use_vec),
             _build.stream(x))
    _build.check(lib, "tpp_rowwise", err)
    launches[f"tpp_bias_act:{act}:{dtype}"] += 1
    return out


def bias_act(x, bias, act="gelu"):
    """Fused ``act(x + bias)``. x [m, n], bias [n]; raises where the
    reference's registry could not tile [m, n]."""
    _check_act(act)
    m, n = x.shape
    if pick_block(m) is None or pick_block(n) is None:
        raise ValueError(f"tpp.bias_act cannot tile [{m},{n}]")
    if x.is_cuda:
        xk, want = _rows_readable(x)
        return _launch_bias_act(xk, bias, act).to(want)
    return _bias_act_ref(x, bias, act)


def _softmax_rows_ref(x):
    """Plain version: the stable row softmax in fp32 (max and sum over the
    full row), cast to x's dtype."""
    xf = x.float()
    ex = torch.exp(xf - xf.max(dim=-1, keepdim=True).values)
    return (ex / ex.sum(dim=-1, keepdim=True)).to(x.dtype)


def _launch_softmax_rows(x):
    dtype = _check_rows("softmax_rows", x)
    m, n = x.shape
    out = torch.empty_like(x)
    lib, fn = _row_kernel("tpp_softmax_rows")
    route = ctypes.c_int(0)
    err = fn(x.data_ptr(), out.data_ptr(), m, n,
             0 if dtype == "float32" else 1,
             _build.stream(x), ctypes.byref(route))
    _build.check(lib, "tpp_rowwise", err)
    launches[f"tpp_softmax_rows:{dtype}"] += 1
    routes[f"tpp_softmax_rows:{dtype}:{_SOFTMAX_ROUTES[route.value]}"] += 1
    return out


def softmax_rows(x):
    """Stable row softmax (fp32 max and sum over each full row). x [m, n];
    raises where the reference's registry could not tile m."""
    m, n = x.shape
    if pick_block(m) is None:
        raise ValueError(f"tpp.softmax_rows cannot tile {m} rows")
    if x.is_cuda:
        xk, want = _rows_readable(x)
        return _launch_softmax_rows(xk).to(want)
    return _softmax_rows_ref(x)


def _mask_keep(mask):
    """The reference's ``mask.astype(int32) != 0``: a fractional float
    mask truncates toward zero first."""
    if mask.dtype == torch.bool:
        return mask
    return mask.to(torch.int32) != 0


def _masked_reduce_ref(x, mask, kind):
    """Plain version: the row sum (0 where no column is kept) or max (-inf
    where none is) of x over the columns kept by the mask, in fp32, as
    [m, 1] in x's dtype."""
    xf, keep = x.float(), _mask_keep(mask)
    if kind == "sum":
        out = torch.where(keep, xf, 0.0).sum(dim=-1, keepdim=True)
    else:
        out = torch.where(keep, xf, float("-inf")).amax(dim=-1, keepdim=True)
    return out.to(x.dtype)


def _launch_masked_reduce(x, mask, kind):
    m, n = x.shape
    if tuple(mask.shape) != (m, n):
        raise ValueError(f"tpp.masked_reduce: mask must be [{m}, {n}], got "
                         f"{tuple(mask.shape)}")
    if mask.dtype in (torch.bool, torch.uint8):
        mask_dtype = 0
    else:                       # the reference's cast, then the int32 path
        mask = mask if mask.dtype == torch.int32 else mask.to(torch.int32)
        mask_dtype = 1
    dtype = _check_rows("masked_reduce", x, mask)
    out = torch.empty((m, 1), dtype=x.dtype, device=x.device)
    lib, fn = _row_kernel("tpp_masked_reduce")
    err = fn(x.data_ptr(), mask.data_ptr(), out.data_ptr(), m, n,
             _KINDS.index(kind), 0 if dtype == "float32" else 1, mask_dtype,
             _build.stream(x))
    _build.check(lib, "tpp_rowwise", err)
    launches[f"tpp_masked_reduce:{kind}:{dtype}"] += 1
    return out


def masked_reduce(x, mask, kind="sum"):
    """Row-wise masked ``sum``/``max``: reduce x[i, j] over the columns
    where mask[i, j] != 0 (the mask taken as int32, as the reference takes
    it). x [m, n] -> [m, 1] in x's dtype; raises where the reference's
    registry could not tile m."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be sum|max, got {kind!r}")
    m, n = x.shape
    if pick_block(m) is None:
        raise ValueError(f"tpp.masked_reduce cannot tile {m} rows")
    if x.is_cuda:
        xk, want = _rows_readable(x)
        return _launch_masked_reduce(xk, _contiguous(mask), kind).to(want)
    return _masked_reduce_ref(x, mask, kind)


# ---- paged attention (csrc/paged_attention.cu) -----------------------------

#: the reference's paged_attention audit shapes: (B, H, hd, bs, maxb)
_PAGED_AUDIT_SHAPES = ((16, 8, 128, 32, 16),)

_PAGED_MAX_HD = _PAGED_MAX_BS = 256   # the kernel's shared-memory arrays

#: the kernel cuts each row's frames into splits: about this many columns
#: a split, and more splits while the grid holds fewer blocks than two
#: waves of the H100's 132 SMs; at most _PAGED_MAX_FPS frames a split and
#: _PAGED_MAX_SPLITS splits a row (the kernel's shared-memory arrays)
_PAGED_SPLIT_COLS, _PAGED_MIN_BLOCKS = 128, 2 * 132
_PAGED_MAX_FPS, _PAGED_MAX_SPLITS = 128, 1024

#: the stream route's column splits: this many columns a split, halved
#: (down to _PAGED_STREAM_MIN_COLS) while the grid holds fewer than
#: _PAGED_MIN_BLOCKS blocks
_PAGED_STREAM_COLS, _PAGED_STREAM_MIN_COLS = 256, 32

#: the stream kernel's ring (its RING path): tiles of up to _PAGED_MAX_TC
#: columns, sized so that a slot's K and V hold about _PAGED_SLOT_BYTES
_PAGED_MAX_TC, _PAGED_SLOT_BYTES = 64, 32768

_PAGED_FN = []

#: the C entry's dtype codes: q (and out), and the pages
_PAGED_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PAGED_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                      torch.int8: 3}
#: the kernels the C entry reports it launched: the split kernel, and the
#: stream kernel's RING path (bulk copies through a ring in shared memory)
#: and its DIRECT path (one element a load: a view off 16 bytes, or rows
#: above 8 KB), which the C entry picks from the view
_PAGED_ROUTES = ("split", "stream", "stream_direct")


def _paged_splits(B, H, bs, maxb):
    """(frames a split, splits a row) of the split route's grid (b, h,
    split), from the shapes alone (never from the lengths, which lie on
    the device): ~_PAGED_SPLIT_COLS columns a split, halved while the grid
    has fewer than _PAGED_MIN_BLOCKS blocks."""
    fps = max(1, min(maxb, _PAGED_SPLIT_COLS // bs),
              -(-maxb // _PAGED_MAX_SPLITS))
    while fps > 1 and B * H * -(-maxb // fps) < _PAGED_MIN_BLOCKS:
        fps = (fps + 1) // 2
    return fps, -(-maxb // fps)


def _paged_stream_splits(B, H, bs, maxb):
    """(columns a split, splits a row) of the stream route's grid (b, h,
    split), from the shapes alone: a split is a range of columns whose ends
    may fall inside a frame; _PAGED_STREAM_COLS columns, halved while the
    grid has fewer than _PAGED_MIN_BLOCKS blocks, and at most
    _PAGED_MAX_SPLITS splits a row."""
    cols = maxb * bs
    span = min(cols, _PAGED_STREAM_COLS)
    while span > _PAGED_STREAM_MIN_COLS \
            and B * H * -(-cols // span) < _PAGED_MIN_BLOCKS:
        span = -(-span // 2)
    span = max(span, -(-cols // _PAGED_MAX_SPLITS))
    return span, -(-cols // span)


def _paged_ring(hd, item):
    """Columns a tile of the stream kernel's RING path for page rows of hd
    elements of `item` bytes: the largest power of two of columns whose K
    and V fit _PAGED_SLOT_BYTES (at least 1, at most _PAGED_MAX_TC)."""
    tc = 1
    while tc < _PAGED_MAX_TC and 2 * (2 * tc) * hd * item <= _PAGED_SLOT_BYTES:
        tc *= 2
    return tc


def _paged_kernel():
    if not _PAGED_FN:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 9 + [i] * 8 + [ll, ll, ctypes.c_float, i, i, i,
                                            vp, ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
        _PAGED_FN.append((lib, fn))
    return _PAGED_FN[0]


def _paged_stream_route(hd, bs, maxb):
    """Do these shapes need the stream route (past the split kernel's
    registers and shared memory)?"""
    return hd > _PAGED_MAX_HD or bs > _PAGED_MAX_BS \
        or maxb > _PAGED_MAX_FPS * _PAGED_MAX_SPLITS


def _check_paged(q, kp, vp, tables, lengths, k_scales, v_scales, stream):
    """Raise unless the kernel reads these operands as they are: a
    contiguous fp32 / bf16 / fp16 q; pages of one dtype (fp32, bf16 or
    fp16, or int8 with scales), shape and strides, their last three dims
    contiguous; fp32 scales [NB, H, bs, 1] with their last dims
    contiguous; table entries and lengths in range; everything on q's
    device; and, on the split route (not `stream`), hd and bs up to 256
    and maxb up to 131,072. Returns (tables, lengths) as contiguous int32
    arrays on q's device."""
    B, H, hd = q.shape
    NB, _, bs, _ = kp.shape
    maxb = tables.shape[1]
    quantized = k_scales is not None
    dtype = _dtype_name(q.dtype)
    if q.dtype not in _PAGED_Q_DTYPES or not q.is_contiguous():
        raise ValueError(f"paged_attention kernel takes a contiguous fp32, "
                         f"bf16 or fp16 q, got {dtype}")
    if quantized and (kp.dtype != torch.int8 or vp.dtype != torch.int8):
        raise ValueError(f"paged_attention kernel: scales come with int8 "
                         f"pages, got {kp.dtype} / {vp.dtype}")
    if not quantized and (kp.dtype != vp.dtype or kp.dtype
                          not in (torch.float32, torch.bfloat16,
                                  torch.float16)):
        raise ValueError(f"paged_attention kernel takes dense pages of one "
                         f"floating dtype, got {kp.dtype} / {vp.dtype}")
    if not stream and _paged_stream_route(hd, bs, maxb):
        raise ValueError(f"paged_attention kernel takes hd and bs up to "
                         f"{_PAGED_MAX_HD} and maxb up to "
                         f"{_PAGED_MAX_FPS * _PAGED_MAX_SPLITS}, got hd {hd}, "
                         f"bs {bs}, maxb {maxb}")
    if vp.shape != kp.shape or vp.stride() != kp.stride() \
            or kp.stride()[1:] != (bs * hd, hd, 1):
        raise ValueError(
            f"paged_attention kernel: kp and vp must have one shape and "
            f"strides, their last three dims contiguous; got strides "
            f"{kp.stride()} / {vp.stride()}")
    operands = [q, kp, vp]
    if quantized:
        for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            if s.dtype != torch.float32 or tuple(s.shape) != (NB, H, bs, 1) \
                    or s.stride()[1:3] != (bs, 1):
                raise ValueError(
                    f"paged_attention kernel: {name} must be float32 "
                    f"[{NB}, {H}, {bs}, 1] with its last dims contiguous, "
                    f"got {s.dtype} {tuple(s.shape)} {s.stride()}")
        if k_scales.stride(0) != v_scales.stride(0):
            raise ValueError("paged_attention kernel: k_scales and v_scales "
                             "must share a frame stride")
        operands += [k_scales, v_scales]
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(lengths.shape) != (B,) or tables.shape[0] != B:
        raise ValueError(f"paged_attention: tables [{B}, maxb] and lengths "
                         f"[{B}] expected, got {tuple(tables.shape)} / "
                         f"{tuple(lengths.shape)}")
    # the kernel reads tables[b, j] for j < ceil(lengths[b] / bs): every
    # entry in range and every length within the table, or no launch
    bad = ((tables < 0) | (tables >= NB)).any() \
        | ((lengths < 0) | (lengths > maxb * bs)).any()
    if bool(bad):
        raise ValueError(f"paged_attention: a table entry outside [0, {NB}) "
                         f"or a length outside [0, {maxb * bs}]")
    for t in operands:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention kernel: operands must lie on "
                             f"{q.device}, got {t.device}")
    return tables, lengths


def _launch_paged_attention(q, kp, vp, tables, lengths, k_scales, v_scales,
                            route="split"):
    """The kernel of `route` ("split", or "stream" for any hd, bs and
    maxb), on operands it reads as they are (else raises)."""
    tables, lengths = _check_paged(q, kp, vp, tables, lengths, k_scales,
                                   v_scales, stream=route == "stream")
    return _paged_kernel_call(q, kp, vp, tables, lengths, k_scales, v_scales,
                              route=route)[0]


def _paged_kernel_call(q, kp, vp, tables, lengths, k_scales, v_scales,
                       route="split"):
    """The launch itself, on operands _check_paged has checked (int32
    contiguous tables and lengths on q's device): (out, the launch's
    plan). The plan: {"route", "columns_a_split", "splits_a_row"}, and on
    the stream kernel's RING path "columns_a_tile" and "ring_stages".
    Route "stream" runs the RING path where the C entry can copy the pages
    as they are, else its DIRECT path ("stream_direct"); the route counted
    is the one the C entry reports."""
    B, H, hd = q.shape
    bs, maxb = kp.shape[2], tables.shape[1]
    quantized = k_scales is not None
    dtype = _dtype_name(q.dtype)
    if route == "split":
        fps, nsplit = _paged_splits(B, H, bs, maxb)
        cols, tc = fps * bs, 0
    else:
        cols, nsplit = _paged_stream_splits(B, H, bs, maxb)
        tc = _paged_ring(hd, kp.element_size())
    out = torch.empty_like(q)
    # each split's partial (m, l, acc[hd]) in fp32, merged by the combine
    # pass; with one split the kernel writes out itself
    part = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32,
                       device=q.device) if nsplit > 1 else None
    taken = (ctypes.c_int * 2)()
    lib, fn = _paged_kernel()
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
             k_scales.data_ptr() if quantized else None,
             v_scales.data_ptr() if quantized else None,
             tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(),
             B, H, hd, bs, maxb, cols, nsplit, tc, kp.stride(0),
             k_scales.stride(0) if quantized else 0, 1.0 / (hd ** 0.5),
             _PAGED_Q_DTYPES[q.dtype], _PAGED_PAGE_DTYPES[kp.dtype],
             0 if route == "split" else 1, _build.stream(q), taken)
    _build.check(lib, "paged_attention", err)
    route = _PAGED_ROUTES[taken[0]]
    kind = f"{'int8' if quantized else 'dense'}:{dtype}"
    launches[f"tpp_paged_attention.{kind}"] += 1
    routes[f"tpp_paged_attention.{kind}:{route}"] += 1
    plan = {"route": route, "columns_a_split": cols, "splits_a_row": nsplit}
    if route == "stream":
        plan.update(columns_a_tile=tc, ring_stages=taken[1])
    return out, plan


def _paged_readable(q, kp, vp, k_scales, v_scales):
    """The operands as the kernel reads them: q contiguous, in fp32 unless
    it is fp32, bf16 or fp16; dense pages in one of those dtypes (their
    promoted one), both with the same strides and their last three dims
    contiguous; scales fp32 with their last dims contiguous. What the
    kernel reads as it is stays as it is; anything else is copied."""
    if q.dtype not in _PAGED_Q_DTYPES:
        q = q.float()
    q = q.contiguous()
    if k_scales is None:
        dt = torch.promote_types(kp.dtype, vp.dtype)
        if dt not in (torch.float32, torch.bfloat16, torch.float16):
            dt = torch.float32
        kp, vp = kp.to(dt), vp.to(dt)
    else:
        k_scales, v_scales = (s.float() for s in (k_scales, v_scales))
        bs = kp.shape[2]
        if k_scales.stride()[1:3] != (bs, 1) or v_scales.stride()[1:3] \
                != (bs, 1) or k_scales.stride(0) != v_scales.stride(0):
            k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
    NB, H, bs, hd = kp.shape
    if kp.stride()[1:] != (bs * hd, hd, 1) or vp.stride() != kp.stride():
        kp, vp = kp.contiguous(), vp.contiguous()
    return q, kp, vp, k_scales, v_scales


def paged_attention(q, kp, vp, tables, lengths, k_scales=None,
                    v_scales=None):
    """Block-table decode attention (one layer, one query a row).

    ``q`` [B, H, hd]; ``kp``/``vp`` [NB, H, bs, hd] frames of the KV pool
    (on the card, a view with the last three dims contiguous, such as one
    layer ``pool.kp[:, l]`` of the serving pool, goes in without a copy;
    any other view is copied first); ``tables`` int [B, maxb] frame
    indices; ``lengths`` int [B]: row b attends columns
    ``0..lengths[b]-1`` of its logical cache, column ``j * bs + r`` living
    at ``[tables[b, j], :, r]``. With ``k_scales`` / ``v_scales`` (float32
    [NB, H, bs, 1]) the frames hold int8 pages of the row codec
    (distributed/compress.py) and dequantize on load. Dense pages may have
    another floating dtype than q. f32 accumulation; the output takes q's
    dtype; a row of length 0 gives zeros. On the card, head dims or frames
    above 256 and more than 131,072 frames a row take the stream route
    (column splits, tiles through a ring of bulk copies; one element a
    load for pages off 16 bytes or rows above 8 KB)."""
    B, H, hd = q.shape
    NB, Hk, bs, hd_k = kp.shape
    if Hk != H or hd_k != hd:
        raise ValueError(
            f"paged_attention serves H == KVh (got q heads {H}, kv heads "
            f"{Hk}) and matching head dim (got {hd} vs {hd_k}) — grouped "
            "queries reshape outside the kernel")
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if not q.is_cuda:
        return paged_attention_ref(q, kp, vp, tables, lengths, k_scales,
                                   v_scales)
    qk, kp, vp, k_scales, v_scales = _paged_readable(q, kp, vp, k_scales,
                                                     v_scales)
    route = "stream" if _paged_stream_route(hd, bs, tables.shape[1]) \
        else "split"
    return _launch_paged_attention(qk, kp, vp, tables, lengths, k_scales,
                                   v_scales, route=route).to(q.dtype)


def gather_pages(pool, tables, scales=None):
    """One layer's frames ``pool`` [NB, H, bs, hd] read through ``tables``
    int [B, maxb] into the dense layout [B, H, maxb * bs, hd], in f32 (int8
    pages times their ``scales`` [NB, H, bs, 1])."""
    tables = tables.long()
    g = pool[tables].float()                      # [B, maxb, H, bs, hd]
    if scales is not None:
        g = g * scales[tables].float()
    B, maxb, H, bs, hd = g.shape
    return g.transpose(1, 2).reshape(B, H, maxb * bs, hd)


def paged_attention_ref(q, kp, vp, tables, lengths, k_scales=None,
                        v_scales=None):
    """Plain version of :func:`paged_attention`: gather the pool through
    the tables into the dense layout, then masked softmax attention in
    f32 (a row with no column gives zeros), cast to q's dtype."""
    hd = q.shape[-1]
    with _autocast_off():
        k = gather_pages(kp, tables, k_scales)
        v = gather_pages(vp, tables, v_scales)
        s = torch.einsum("bhd,bhTd->bhT", q.float(), k) * (1.0 / (hd ** 0.5))
        cols = torch.arange(k.shape[2], device=q.device)[None, None, :]
        s = s.masked_fill(cols >= lengths.long()[:, None, None], -torch.inf)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        denom = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(denom == 0.0, 1.0, denom)
        return torch.einsum("bhT,bhTd->bhd", p, v).to(q.dtype)
