"""The port's flash-attention backward (paddle_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas `_flash_bwd`, run in
interpret mode on the CPU as tests/test_flash_attention.py runs it.

Inputs come from a numpy seed and go to both packages; at s 384 the
reference's `_block_for` picks 128, so its 3 x 3 block grid exercises the
causal and window skips. Tolerance: atol 2e-5 on dq, dk and dv in fp32 —
the same function, with the Pallas kernels summing block by block and the
port's plain version over whole rows. Tests marked ``cuda`` hold the CUDA
kernels against the plain version on a card, and skip without one.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import flash_attention as jfa

import tf32_variants
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.testing import flash_stream as st
from paddle_tpu_torch.testing.tf32 import tf32 as _tf32, \
    tf32x1 as _tf32x1, tf32x3 as _tf32x3

ATOL = 2e-5
MODES = [(False, None), (True, None), (True, 100)]
MODE_IDS = ["full", "causal", "window100"]


def _arrays(*shape, n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(n)]


def _fwd_residuals(q, k, v, causal, scale, window):
    """o and lse from the reference's forward, fed to both backwards."""
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, scale, True, window=window)
    return np.array(o), np.array(lse)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_plain_backward_matches_jax(causal, window):
    q, k, v, do = _arrays(2, 384, 64, seed=1)
    scale = 1.0 / math.sqrt(64)
    o, lse = _fwd_residuals(q, k, v, causal, scale, window)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o, lse, do)),
                          causal, scale, True, window=window)
    got = tfa._flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, o, lse,
                                                         do)),
                         causal, scale, window=window)
    _close(got, want)


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_external_delta_matches_jax(causal, window):
    """ring attention hands _flash_bwd its delta (long_context.py): any
    given delta is used as it is, not recomputed from o and dO."""
    q, k, v, do = _arrays(2, 384, 64, seed=2)
    scale = 1.0 / math.sqrt(64)
    o, lse = _fwd_residuals(q, k, v, causal, scale, window)
    delta = (np.random.RandomState(3).randn(2, 384) * 0.1).astype(np.float32)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o, lse, do)),
                          causal, scale, True, delta=jnp.asarray(delta),
                          window=window)
    got = tfa._flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, o, lse,
                                                         do)),
                         causal, scale, delta=torch.from_numpy(delta),
                         window=window)
    _close(got, want)
    # and the default delta is rowsum(dO * o)
    same = tfa._flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, o, lse,
                                                          do)),
                          causal, scale, window=window,
                          delta=torch.from_numpy((do * o).sum(-1)))
    _close(same, tfa._flash_bwd(*(torch.from_numpy(a) for a in (
        q, k, v, o, lse, do)), causal, scale, window=window))


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_autograd_grads_match_jax_grad(causal, window):
    q, k, v, g = _arrays(1, 384, 2, 64, seed=4)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True,
                                  window=window)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(g)).sum().backward()
    _close((tq.grad, tk.grad, tv.grad), want)


def test_grads_flow_through_strided_views_of_a_packed_qkv():
    """GPT's q, k, v are views of one packed projection: the grads land in
    the packed tensor's three column blocks."""
    (packed,) = _arrays(1, 256, 3 * 2 * 64, n=1, seed=5)
    tp = torch.from_numpy(packed).requires_grad_()
    q, k, v = (t.reshape(1, 256, 2, 64) for t in tp.split(128, dim=-1))
    tfa.flash_attention(q, k, v, causal=True).square().sum().backward()
    ref = torch.from_numpy(packed).requires_grad_()
    rq, rk, rv = (t.reshape(1, 256, 2, 64).contiguous()
                  for t in ref.split(128, dim=-1))
    tfa.flash_attention(rq, rk, rv, causal=True).square().sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), ref.grad.numpy(), atol=1e-6,
                               rtol=0)


def test_backward_validation():
    t = torch.zeros((2, 128, 64))
    lse = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="window requires causal"):
        tfa._flash_bwd(t, t, t, t, lse, t, False, 1.0, window=8)
    x = torch.zeros((1, 1024, 1, 64))
    rows = torch.zeros((1, 1024))
    with pytest.raises(ValueError, match="must lie on"):
        tfa._launch_dq(x, x, x, x, rows, rows, True, 0.125, None)
    with pytest.raises(ValueError, match="must lie on"):
        tfa._launch_dkv(x, x, x, x, rows, rows, True, 0.125, None)


@pytest.mark.parametrize("d", [560, 576])
def test_backward_kernels_raise_for_head_dims_they_cannot_tile(d):
    """560 is no multiple of 64 and raises; 576 takes the streaming route
    (here the CPU tensors are refused after the shape is taken)."""
    x = torch.zeros((1, 1024, 1, d))
    rows = torch.zeros((1, 1024))
    match = "head_dim a multiple of 64" if d % 64 else "must lie on"
    with pytest.raises(ValueError, match=match):
        tfa._launch_dq(x, x, x, x, rows, rows, True, 0.125, None)
    with pytest.raises(ValueError, match=match):
        tfa._launch_dkv(x, x, x, x, rows, rows, True, 0.125, None)


def _stream_bwd(q3, k3, v3, o3, lse, do3, causal, scale, window=None,
                dtype="float32"):
    """The streaming route's backward (csrc/flash_bwd.cu,
    flash_dq_stream_kernel and flash_dkv_stream_kernel) in plain torch,
    with the kernels' tiling for `dtype` (the arithmetic in q3's type):
    each output's columns in `st.groups` groups. dQ: for each group
    and 64-row query tile, one pass over the kv tiles it sees, S = q k^T
    and dP = dO v^T summed over the head dim one chunk tile at a time, P =
    exp(S scale - lse) (0 where masked), dS = P (dP - delta), dq[:, group]
    += dS k[:, group], times scale at the end. dK/dV: for each group and
    64-row kv tile, one pass over the query tiles that see it, S^T = k q^T
    and dP^T = v dO^T likewise, dv[:, group] += P^T dO[:, group] and
    dk[:, group] += dS^T q[:, group], dk times scale at the end."""
    bh, s, d = q3.shape
    rows, chunk = st.ROWS, st.CHUNK[dtype]
    delta = (do3 * o3).sum(-1)
    keep = tfa._keep_mask(s, s, window, q3.device) if causal else None

    def chunked(a, b):
        return sum(a[..., c:c + chunk] @ b[..., c:c + chunk].transpose(-1, -2)
                   for c in range(0, d, chunk))

    def p_ds(qs, ks, transposed):
        """P and dS of query rows qs and key rows ks (transposed: [keys,
        queries] from k q^T and v dO^T)."""
        if transposed:
            sc = chunked(k3[:, ks], q3[:, qs])
            dp = chunked(v3[:, ks], do3[:, qs])
            lse_, dl_ = lse[:, None, qs], delta[:, None, qs]
        else:
            sc = chunked(q3[:, qs], k3[:, ks])
            dp = chunked(do3[:, qs], v3[:, ks])
            lse_, dl_ = lse[:, qs, None], delta[:, qs, None]
        p = torch.exp(sc * scale - lse_)
        if keep is not None:
            mask = keep[qs, ks]
            p = p.masked_fill(~(mask.T if transposed else mask), 0.0)
        return p, p * (dp - dl_)

    dq, dk, dv = (torch.empty_like(q3) for _ in range(3))
    wmax, step = st.TILING["dq"][dtype]
    n_groups, width = st.groups(d, wmax)
    for g in range(n_groups):
        cols = slice(g * width, min(d, (g + 1) * width))
        for q0 in range(0, s, rows):
            qs = slice(q0, q0 + rows)
            acc = 0.0
            for k0 in st.kv_tiles(q0, step, s, causal, window):
                ks = slice(k0, k0 + step)
                _, ds = p_ds(qs, ks, False)
                acc = acc + ds @ k3[:, ks, cols]
            dq[:, qs, cols] = acc * scale
    wmax, step = st.TILING["dkv"][dtype]
    n_groups, width = st.groups(d, wmax)
    for g in range(n_groups):
        cols = slice(g * width, min(d, (g + 1) * width))
        for k0 in range(0, s, rows):
            ks = slice(k0, k0 + rows)
            dka = dva = 0.0
            for q0 in st.q_tiles(k0, step, s, causal, window):
                qs = slice(q0, q0 + step)
                pt, dst = p_ds(qs, ks, True)
                dva = dva + pt @ do3[:, qs, cols]
                dka = dka + dst @ q3[:, qs, cols]
            dk[:, ks, cols] = dka * scale
            dv[:, ks, cols] = dva
    return dq, dk, dv


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_streaming_route_backward_matches_jax_grad_at_head_dim_576(causal,
                                                                  window):
    """At head_dim 576, one head, seq 256: the streaming algorithm's dq,
    dk, dv (from the reference's o and lse) and the port's plain backward
    against the JAX gradient through the reference's Pallas kernels
    (interpreted)."""
    q, k, v, g = _arrays(1, 256, 576, seed=12)
    scale = 1.0 / math.sqrt(576)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_[:, :, None], k_[:, :, None],
                                  v_[:, :, None], causal=causal,
                                  interpret=True, window=window)
        return jnp.sum(out[:, :, 0] * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = _fwd_residuals(q, k, v, causal, scale, window)
    args = [torch.from_numpy(a) for a in (q, k, v, o, lse, g)]
    _close(_stream_bwd(*args, causal, scale, window), want)
    _close(tfa._flash_bwd(*args, causal, scale, window=window), want)


@pytest.mark.parametrize("d", [576, 640])
@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_streaming_backward_plan_matches_jax_flash_bwd(d, causal, window):
    """One head, seq 256: the streaming kernels' dQ and dK/dV plan with
    the bf16 and the fp32 tiling (column groups of the outputs, S and dP
    over the whole head once a tile a block visits, 16- and 32-row steps)
    against the reference's Pallas backward (interpreted) on the
    reference's o and lse; at 640 the dQ groups are ragged (192 x 3 + 64,
    256 x 2 + 128)."""
    q, k, v, g = _arrays(1, 256, d, seed=13)
    scale = 1.0 / math.sqrt(d)
    o, lse = _fwd_residuals(q, k, v, causal, scale, window)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o, lse, g)),
                          causal, scale, True, window=window)
    args = [torch.from_numpy(np.asarray(a)) for a in (q, k, v, o, lse, g)]
    for dtype in ("float32", "bfloat16"):
        _close(_stream_bwd(*args, causal, scale, window, dtype), want)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_kernels_under_autograd_match_plain_on_card(cuda, d, dtype, tol,
                                                    causal, window):
    """flash_attention's autograd runs the forward, the delta pre-pass and
    both backward kernels, at head_dim 64 and 128 on the tensor cores (bf16
    on mma, fp32 on the TF32 kernels' three passes); its grads match
    autograd through the plain forward."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(2, 1024, 2, d, generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    dname = str(dtype).replace("torch.", "")
    route = "simt"
    if d in (64, 128):
        route = "mma" if dname == "bfloat16" else "tf32x3"
    kinds = ("dq", "dkv", "delta")
    n = {kind: tfa.launches[f"flash_{kind}:{dname}"] for kind in kinds}
    r = {kind: tfa.routes[f"flash_{kind}:{dname}:{route}"]
         for kind in ("dq", "dkv")}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for kind in kinds:
        assert tfa.launches[f"flash_{kind}:{dname}"] == n[kind] + 1
    for kind in ("dq", "dkv"):
        assert tfa.routes[f"flash_{kind}:{dname}:{route}"] == r[kind] + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    ro, _ = tfa.flash_attention_ref(*(tfa._heads(t) for t in ref), causal,
                                    1.0 / math.sqrt(d), window)
    want = torch.autograd.grad(tfa._unheads(ro, 2, 2), ref, do)
    for a, b in zip(got, want):
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_delta_prepass_and_bit_equal_grads_on_card(cuda, dtype):
    """The backward's pre-pass gives rowsum(dO o) as the torch expression
    does (fp32 sums in another order: 1e-5 x max(1, max|want|)); two
    backward calls on the same inputs, q, k and v slices of one packed
    qkv, give the same bits on the tensor-core route (every block writes
    only its own tile: no atomics), and so does a dO that is not 16-byte
    aligned (the wrapper copies it)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, s, h, d = 2, 1024, 3, 64
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
    o, lse = tfa._launch(q, k, v, True, 0.125, None)
    delta = tfa._launch_delta(o, do)
    want = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, s)
    torch.cuda.synchronize()
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (delta - want).abs().max().item() <= tol
    dname = str(dtype).replace("torch.", "")
    route = "mma" if dname == "bfloat16" else "tf32x3"
    n = [tfa.routes[f"flash_{kind}:{dname}:{route}"] for kind in ("dq", "dkv")]
    first = tfa._launch_bwd(q, k, v, o, lse, do, True, 0.125, None)
    again = tfa._launch_bwd(q, k, v, o, lse, do, True, 0.125, None)
    torch.cuda.synchronize()
    assert [tfa.routes[f"flash_{kind}:{dname}:{route}"]
            for kind in ("dq", "dkv")] == [c + 2 for c in n]
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    mis = torch.empty(do.numel() + 1, dtype=dtype, device=cuda)[1:]
    mis = mis.view(do.shape).copy_(do)            # one element off 16 bytes
    assert not tfa._aligned(mis)
    assert torch.equal(tfa._launch_delta(o, mis), delta)
    shifted = tfa._launch_bwd(q, k, v, o, lse, mis, True, 0.125, None)
    assert all(torch.equal(x, y) for x, y in zip(first, shifted))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_aligned_copy_copies_only_views_off_16_bytes(dtype):
    """The backward's wrapper hands the pre-pass and the tensor-core kernels
    dO and o as they are where they are 16-byte aligned, and else a
    contiguous copy with the same values that is aligned, also for a
    contiguous view one element off its allocation."""
    t = torch.randn(2, 64, 3, 64).to(dtype)
    assert tfa._aligned_copy(t) is t
    qkv = torch.randn(2, 64, 9 * 64).to(dtype)
    packed = qkv[..., 3 * 64:6 * 64].reshape(2, 64, 3, 64)  # a packed slice
    assert tfa._aligned_copy(packed) is packed
    off = torch.empty(t.numel() + 1, dtype=dtype)[1:].view(t.shape).copy_(t)
    strided = torch.randn(2, 64, 3, 128).to(dtype)[..., ::2]
    for view in (off, strided):
        got = tfa._aligned_copy(view)
        assert got is not view and tfa._aligned(got)
        assert got.stride(-1) == 1 and torch.equal(got, view)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [None, 17], ids=["causal", "window17"])
def test_bf16_mma_kernels_on_packed_views_with_a_ragged_tile_on_card(
        cuda, d, window):
    """The tensor-core kernels read q, k, v as slices of one packed qkv and
    take seq 1088, whose last 128-row tile is half empty; a window of 17
    lies inside every tile. Against the plain backward within
    chip_smoke.py's bf16 band (2e-2 x max(1, max|plain|))."""
    g = torch.Generator(device=cuda).manual_seed(6)
    b, s, h = 2, 1088, 3
    qkv = torch.randn(b, s, 3 * h * d, generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa._launch(q, k, v, True, scale, window)
    got = tfa._launch_bwd(q, k, v, o, lse, do, True, scale, window)
    heads = [tfa._heads(t) for t in (q, k, v, o, do)]
    want = tfa.flash_attention_bwd_ref(*heads[:4], lse, heads[4], True,
                                       scale, window=window)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        band = BF16_BWD_TOL * max(1.0, w.float().abs().max().item())
        assert (tfa._heads(a).float() - w.float()).abs().max().item() <= band


def _bwd_band_check(q, k, v, do, causal, scale, window, band_of):
    """The backward kernels on [B, S, H, D] views against the plain
    backward (from the forward kernel's o and lse), each grad within
    band_of x max(1, max|plain|)."""
    o, lse = tfa._launch(q, k, v, causal, scale, window)
    got = tfa._launch_bwd(q, k, v, o, lse, do, causal, scale, window)
    heads = [tfa._heads(t) for t in (q, k, v, o, do)]
    want = tfa.flash_attention_bwd_ref(*heads[:4], lse, heads[4], causal,
                                       scale, window=window)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        band = band_of * max(1.0, w.float().abs().max().item())
        assert (tfa._heads(a).float() - w.float()).abs().max().item() <= band


@pytest.mark.cuda
def test_fp32_views_off_16_bytes_take_the_scalar_route_on_card(cuda):
    """fp32 q, k, v whose sequence step is not a multiple of 16 bytes (a
    packed qkv one column wider than the three heads' blocks) are left to
    the scalar kernels before any launch (route simt, not tf32x3), and
    their grads match the plain backward within the fp32 band."""
    g = torch.Generator(device=cuda).manual_seed(7)
    b, s, h, d = 2, 1024, 3, 64
    wide = torch.randn(b, s, 3 * h * d + 1, generator=g, device=cuda)
    q, k, v = (t.reshape(b, s, h, d)
               for t in wide[..., :3 * h * d].split(h * d, dim=-1))
    assert not any(tfa._aligned(t) for t in (q, k, v))
    do = torch.randn(b, s, h, d, generator=g, device=cuda)
    keys = [f"flash_{kind}:float32:{route}" for kind in ("dq", "dkv")
            for route in ("simt", "tf32x3")]
    n = [tfa.routes[key] for key in keys]
    _bwd_band_check(q, k, v, do, True, 0.125, None, FP32_BWD_TOL)
    assert [tfa.routes[key] for key in keys] == [n[0] + 1, n[1],
                                                 n[2] + 1, n[3]]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1024, 1088])
def test_fp32_tf32_kernels_ragged_window_at_head_dim_128_on_card(cuda, s):
    """At head_dim 128 a window of 100 crosses the 128-row tiles and the
    32-row steps at no multiple of either; at seq 1088 the last 128-row
    tile is half empty. q, k, v slices of one packed qkv, on the TF32
    route; the grads within the fp32 band of the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b, h, d = 2, 3, 128
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn(b, s, h, d, generator=g, device=cuda)
    n = tfa.routes["flash_dkv:float32:tf32x3"]
    _bwd_band_check(q, k, v, do, True, 1.0 / math.sqrt(d), 100, FP32_BWD_TOL)
    assert tfa.routes["flash_dkv:float32:tf32x3"] == n + 1


# ---- the bf16 tensor-core kernels' rounding ---------------------------------

#: chip_smoke.py's band for the bf16 backward kernels against the
#: fp32-math plain backward (FLASH_BWD_TOL["bfloat16"] there), scaled by
#: max(1, max|plain|)
BF16_BWD_TOL = 2e-2


def _tensor_core_rounding_bwd(q3, k3, v3, o3, lse, do3, causal, scale,
                              window=None):
    """Where the bf16 mma.sync kernels round, in plain torch: S = Q K^T and
    dP = dO V^T of the bf16 inputs accumulated in fp32, P = exp(S * scale -
    lse) and dS = P (dP - delta) in fp32, then P and dS rounded to bf16
    before the fp32-accumulated dV = P^T dO, dK = dS^T Q (times scale) and
    dQ = dS K (times scale); the outputs rounded to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q3, k3, v3, do3))
    delta = (dof * o3.float()).sum(-1)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[..., None])
    if causal:
        p = p.masked_fill(~tfa._keep_mask(*p.shape[-2:], window, p.device),
                          0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = (dsb @ kf) * scale
    dk = (dsb.transpose(-1, -2) @ qf) * scale
    dv = pb.transpose(-1, -2) @ dof
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("d,window", [(64, None), (64, 100), (128, None)],
                         ids=["d64", "d64_window100", "d128"])
def test_bf16_tensor_core_rounding_within_band_of_plain(d, window):
    """At s 1024, causal, d 64 / 128 and d 64 with window 100: rounding P
    and dS to bf16 before their fp32-accumulated products, as the mma.sync
    kernels must, stays within the bf16 band of the fp32-math plain
    backward; and on the same inputs the plain backward matches the JAX
    package's Pallas backward (interpret mode)."""
    rng = np.random.RandomState(17)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 1024, d).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa.flash_attention_ref(q, k, v, True, scale, window)
    plain = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, True, scale,
                                        window=window)
    emulated = _tensor_core_rounding_bwd(q, k, v, o, lse, do, True, scale,
                                         window)
    for e, p in zip(emulated, plain):
        band = BF16_BWD_TOL * max(1.0, p.float().abs().max().item())
        assert (e.float() - p.float()).abs().max().item() <= band

    # the plain backward against the JAX package, fp32 on the same values
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    want = jfa._flash_bwd(*(jnp.asarray(t.numpy())
                            for t in (qf, kf, vf, of, lse, dof)),
                          True, scale, True, window=window)
    got = tfa._flash_bwd(qf, kf, vf, of, lse, dof, True, scale,
                         window=window)
    _close(got, want)


# ---- the fp32 TF32 tensor-core kernels' three passes ------------------------

#: chip_smoke.py's band for the fp32 backward kernels against the plain
#: backward (FLASH_BWD_TOL["float32"] there), scaled by max(1, max|plain|)
FP32_BWD_TOL = 2e-4


def _tf32_bwd(q3, k3, v3, o3, lse, do3, causal, scale, window, mm):
    """The fp32 tensor-core kernels' backward in plain torch, every
    product through `mm`: S = Q K^T and dP = dO V^T, P = exp(S * scale -
    lse) and dS = P (dP - delta) in fp32, dQ = dS K, dK = dS^T Q (both
    times scale) and dV = P^T dO."""
    delta = (do3 * o3).sum(-1)
    p = torch.exp(mm(q3, k3.transpose(-1, -2)) * scale - lse[..., None])
    if causal:
        p = p.masked_fill(~tfa._keep_mask(*p.shape[-2:], window, p.device),
                          0.0)
    ds = p * (mm(do3, v3.transpose(-1, -2)) - delta[..., None])
    return (mm(ds, k3) * scale, mm(ds.transpose(-1, -2), q3) * scale,
            mm(p.transpose(-1, -2), do3))


def test_tf32_rounding_follows_cvt_rna():
    """The emulation's rounding: to the nearest TF32 value, a tie away
    from zero, and a value with 10 mantissa bits kept as it is."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp * 0.5, -(1.0 + ulp * 0.5), 1.0 + ulp * 0.49,
                      1.0 + ulp * 1.5, 3.0 + 2 * ulp, 0.0])
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp,
                         3.0 + 2 * ulp, 0.0])
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("d,window", [(64, None), (64, 100), (128, None)],
                         ids=["d64", "d64_window100", "d128"])
def test_fp32_three_pass_tf32_within_band_of_plain(d, window):
    """At s 1024, causal, b 1, h 2: every product of the backward formed
    in three TF32 passes, as the fp32 tensor-core kernels form it, stays
    within the fp32 band of the plain backward; one TF32 pass lands
    outside it in every output (the control, ~5e-4 to 1e-3); and on the
    same inputs the plain backward matches the JAX package's Pallas
    backward (interpret mode)."""
    rng = np.random.RandomState(17)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 1024, d).astype(np.float32))
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa.flash_attention_ref(q, k, v, True, scale, window)
    plain = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, True, scale,
                                        window=window)
    args = (q, k, v, o, lse, do, True, scale, window)
    three = _tf32_bwd(*args, _tf32x3)
    one = _tf32_bwd(*args, _tf32x1)
    for e3, e1, p in zip(three, one, plain):
        band = FP32_BWD_TOL * max(1.0, p.abs().max().item())
        assert (e3 - p).abs().max().item() <= band
        assert (e1 - p).abs().max().item() > band

    want = jfa._flash_bwd(*(jnp.asarray(t.numpy())
                            for t in (q, k, v, o, lse, do)),
                          True, scale, True, window=window)
    _close(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [576, 640, 1024])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)],
                         ids=["causal", "window100", "full"])
def test_streaming_route_under_autograd_matches_plain_on_card(
        cuda, d, dtype, tol, causal, window):
    """Above head_dim 512 the forward, dQ and dK/dV all take the streaming
    route; o and the grads match autograd through the plain forward."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(1, 1024, 2, d, generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    dname = str(dtype).replace("torch.", "")
    keys = [f"flash_{kind}:{dname}:stream" for kind in ("fwd", "dq", "dkv")]
    n = [tfa.routes[key] for key in keys]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [tfa.routes[key] for key in keys] == [c + 1 for c in n]
    ref = [t.clone().float().requires_grad_() for t in (q, k, v)]
    ro = tfa._unheads(tfa.flash_attention_ref(
        *(tfa._heads(t) for t in ref), causal, 1.0 / math.sqrt(d),
        window)[0], 1, 2)
    want = torch.autograd.grad(ro, ref, do.float())
    assert (out.float() - ro).abs().max().item() <= tol
    for gt, w in zip(got, want):
        err = (gt.float() - w).abs().max().item()
        assert err <= tol * max(1.0, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_streaming_route_grads_bit_equal_and_views_off_16_bytes_on_card(
        cuda, dtype):
    """The streaming kernels write each output tile from one block, with
    no atomics: two backward calls give the same bits. They copy 16-byte
    chunks, so a view off 16 bytes raises on the kernel's entry, while
    flash_attention copies it first and matches the aligned call."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, s, h, d = 2, 1024, 2, 576
    wide = torch.randn(b, s, 3 * h * d + 8, generator=g, device=cuda) \
        .to(dtype)
    q, k, v = (t.reshape(b, s, h, d)
               for t in wide[..., 1:3 * h * d + 1].split(h * d, dim=-1))
    assert not any(tfa._aligned(t) for t in (q, k, v))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._launch(q, k, v, True, 1.0 / math.sqrt(d), None)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    do = torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
    o, lse = tfa._launch(qc, kc, vc, True, 1.0 / math.sqrt(d), None)
    first = tfa._launch_bwd(qc, kc, vc, o, lse, do, True,
                            1.0 / math.sqrt(d), None)
    again = tfa._launch_bwd(qc, kc, vc, o, lse, do, True,
                            1.0 / math.sqrt(d), None)
    with torch.no_grad():
        copied = tfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert torch.equal(copied, o)


@pytest.mark.parametrize("name", sorted(tf32_variants.STREAM_VARIANTS))
def test_stream_variant_edits_apply_to_the_sources(name, tmp_path):
    """Each streaming tiling variant of tf32_variants.py finds every line
    it replaces once in the sources as they stand, and its copies include
    its own header."""
    for src in ("flash_fwd.cu", "flash_bwd.cu", "flash_stream.cuh"):
        (tmp_path / src).write_text((_build.CSRC / src).read_text())
    written = []
    libs = tf32_variants.write_stream_variant(tmp_path, name, written)
    assert sorted(libs) == ["flash_bwd", "flash_fwd"]
    edits = tf32_variants.STREAM_VARIANTS[name]
    header = (f"flash_stream_{name}.cuh" if "flash_stream" in edits
              else "flash_stream.cuh")
    for src, lib in libs.items():
        text = (tmp_path / f"{lib}.cu").read_text()
        assert f'#include "{header}"' in text
        assert all(new in text for _, new in edits.get(src, []))
    if "flash_stream" in edits:
        text = (tmp_path / header).read_text()
        assert all(old not in text for old, _ in edits["flash_stream"])
    assert len(written) == len(libs) + ("flash_stream" in edits)
