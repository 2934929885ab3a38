"""TPP micro-kernels: the blocked matmul with the autograd Functions
around it and the GPT block hook, and the row primitives; each CUDA
kernel beside its plain PyTorch version.

Ports paddle_tpu/ops/tpp.py: ``pick_block``, ``supported_2d``,
``ln_matmul_supported``, ``matmul``, ``ln_matmul``, ``fused_mlp``,
``_fused_tail``, ``gpt_block_mlp``, ``bias_act``, ``softmax_rows`` and
``masked_reduce``. The Pallas ``_matmul_kernel`` becomes
``csrc/tpp_matmul.cu`` (the design notes are there): one kernel computes
``act(in_act(LN?(x)) @ w + bias)`` with an fp32 accumulator, the
LayerNorm prologue (``ln_matmul``) and the gelu-on-load + bias variant
(``_fused_tail``) being two of its modes. The row primitives'
``_bias_act_kernel``, ``_softmax_kernel`` and ``_masked_reduce_kernel``
become the three kernels of ``csrc/tpp_rowwise.cu``. None of the three has
a backward in the reference, so none has one here. The reference module's
paged attention kernel is still to be ported.

``ln_matmul``, ``fused_mlp`` and ``_fused_tail`` are
``torch.autograd.Function``s, the counterparts of the reference's
custom_vjps: the forward runs the kernel, the backward is plain PyTorch —
autograd of the op's fp32 reference math (``_matmul_ref`` with the LN
prologue or the gelu on its input, and ``_mlp_ref``), as the reference's
backward is ``jax.vjp`` of its ``_ln_matmul_ref`` / ``_mlp_ref`` /
``_fused_tail_ref``, with grads cast back to the input dtypes.
Both run with autocast off, so an enclosing bf16 autocast never turns
that fp32 math into bf16 products. ``matmul`` alone has no backward, as
in the reference.

A tensor on a CUDA device launches the kernel or raises; a tensor on the
CPU takes the plain version (``_matmul_ref``, ``_bias_act_ref``,
``_softmax_rows_ref``, ``_masked_reduce_ref``). ``launches`` counts kernel
launches by ``"tpp_matmul.<variant>:<dtype>"`` (variant ``plain``, ``ln``
or ``in_act``), ``"tpp_bias_act:<act>:<dtype>"``,
``"tpp_softmax_rows:<dtype>"`` and ``"tpp_masked_reduce:<kind>:<dtype>"``,
where each kernel is launched and nowhere else.
"""
import collections
import ctypes

import torch
import torch.nn.functional as F

from ..amp.auto_cast import disabled as _autocast_off
from . import _build

_LN_EPS = 1e-5   # nn.LayerNorm's default epsilon (the only one GPT uses)

#: kernel launches by "tpp_matmul.<variant>:<dtype>"
launches = collections.Counter()

#: candidate block edges of the reference registry; the CUDA kernel tiles
#: by 64 x 64 and masks ragged edges, so these only gate which shapes the
#: hook sends to it, exactly as the reference gates its own kernel
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
    if not _FN:
        lib = _build.load("tpp_matmul")
        fn = lib.tpp_matmul
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN.append((lib, fn))
    return _FN[0]


def _launch(x, w, bias, in_act, act, gamma=None, beta=None):
    """Run the kernel: x a contiguous [m, k] array, w [k, n] with either
    dimension contiguous (a [k, n] array, or an nn.Linear weight [n, k]
    seen through .t()), bias [n], gamma/beta [k]."""
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
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib, fn = _kernel()
    swk, swn = w.stride()
    err = fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(),
             None if gamma is None else gamma.data_ptr(),
             None if beta is None else beta.data_ptr(), out.data_ptr(),
             m, n, k, swk, swn, _ACTS.index(in_act), _ACTS.index(act),
             int(gamma is not None), 0 if dtype == "float32" else 1,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "tpp_matmul", err)
    variant = "ln" if gamma is not None else \
        "in_act" if in_act != "none" else "plain"
    launches[f"tpp_matmul.{variant}:{dtype}"] += 1
    return out


def _run(x, w, bias, in_act, act, gamma=None, beta=None):
    if x.is_cuda:
        return _launch(x, w, bias, in_act, act, gamma, beta)
    return _matmul_ref(x, w, bias, in_act, act, gamma, beta)


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
    if x.is_cuda and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
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
        with _autocast_off():
            return _run(x, w, bias, "none", "none", gamma, beta)

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
        with _autocast_off():
            # leg 1: x @ w1 + b1, the one intermediate in device memory;
            # leg 2: gelu on the second matmul's loads, + b2 on the way out
            h = _run(x, w1, b1, "none", "none")
            return _run(h, w2, b2, act, "none")

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
        with _autocast_off():
            return _run(pre, w2, b2, "gelu_tanh" if approx else "gelu",
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
            "tpp_softmax_rows": [vp, vp, i, i, i, vp],
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
             torch.cuda.current_stream(x.device).cuda_stream)
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
        return _launch_bias_act(x, bias, act)
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
    err = fn(x.data_ptr(), out.data_ptr(), m, n,
             0 if dtype == "float32" else 1,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "tpp_rowwise", err)
    launches[f"tpp_softmax_rows:{dtype}"] += 1
    return out


def softmax_rows(x):
    """Stable row softmax (fp32 max and sum over each full row). x [m, n];
    raises where the reference's registry could not tile m."""
    m, n = x.shape
    if pick_block(m) is None:
        raise ValueError(f"tpp.softmax_rows cannot tile {m} rows")
    if x.is_cuda:
        return _launch_softmax_rows(x)
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
             torch.cuda.current_stream(x.device).cuda_stream)
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
        return _launch_masked_reduce(x, mask, kind)
    return _masked_reduce_ref(x, mask, kind)
