"""The port's flash-attention forward (paddle_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU as tests/test_flash_attention.py runs it.

Inputs come from a numpy seed and go to both packages. Tolerance: atol
2e-5 on o and on lse in fp32 — the same function, with the Pallas kernel
summing online over kv blocks and the port's plain version over the whole
row. Tests marked ``cuda`` hold the CUDA kernel against the plain version
on a card, and skip without one.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import flash_attention as jfa

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.testing import flash_stream as st
from paddle_tpu_torch.testing.tf32 import tf32x1, tf32x3

ATOL = 2e-5
MODES = [(False, None), (True, None), (True, 100)]
MODE_IDS = ["full", "causal", "window100"]


@pytest.fixture(autouse=True)
def _block_flag_off():
    yield
    paddle.set_flags({"flash_attention_block": 0})
    pt.set_flags({"flash_attention_block": 0})


def _arrays(*shape, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_flash_fwd_o_and_lse_match_jax(causal, window):
    q, k, v = _arrays(4, 256, 64, seed=1)
    scale = 1.0 / math.sqrt(64)
    jo, jlse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, scale, True, window=window)
    to, tlse = tfa._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, scale, window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_flash_attention_bshd_matches_jax(causal, window):
    q, k, v = _arrays(2, 256, 2, 64, seed=2)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, interpret=True,
                               window=window)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert got.shape == (2, 256, 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("blk", [128, 256])
def test_block_flag_matches_jax(blk):
    paddle.set_flags({"flash_attention_block": blk})
    pt.set_flags({"flash_attention_block": blk})
    assert tfa._block_for(256) == jfa._block_for(256) == blk
    q, k, v = _arrays(2, 256, 64, seed=3)
    scale = 0.125
    jo, jlse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              True, scale, True, window=100)
    to, tlse = tfa._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), True, scale, 100)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("s", [128, 256, 384, 512, 640, 1024, 1536, 4096])
def test_block_for_matches_reference(s):
    assert tfa._block_for(s) == jfa._block_for(s)


@pytest.mark.parametrize("s,forced", [(100, 0), (256, 512), (384, 256),
                                      (256, 64)])
def test_block_for_errors_match_reference(s, forced):
    paddle.set_flags({"flash_attention_block": forced})
    pt.set_flags({"flash_attention_block": forced})
    with pytest.raises(ValueError):
        jfa._block_for(s)
    with pytest.raises(ValueError):
        tfa._block_for(s)


@pytest.mark.parametrize("shape,dtype,device,want", [
    ((2, 1024, 12, 64), "float32", "cuda", True),
    ((2, 1024, 12, 64), torch.bfloat16, "cuda", True),
    ((1, 2048, 4, 128), "bfloat16", "cuda", True),
    ((2, 1024, 12, 192), "float32", "cuda", True),
    ((1, 1024, 4, 256), "bfloat16", "cuda", True),
    ((1, 1024, 4, 320), "float32", "cuda", True),   # a 32-row tiling
    ((1, 1024, 4, 576), "float32", "cuda", True),   # the streaming route
    ((2, 1024, 12, 64), "float32", "cpu", False),    # not on a CUDA device
    ((2, 1024, 12, 48), "float32", "cuda", False),   # head_dim % 64
    ((2, 1000, 12, 64), "float32", "cuda", False),   # seq % 128
    ((2, 512, 12, 64), "float32", "cuda", False),    # seq < 1024
    ((2, 1024, 12, 64), torch.float16, "cuda", False),
    ((1024, 12, 64), "float32", "cuda", False),      # not 4-D
])
def test_supported_gate(shape, dtype, device, want):
    assert tfa.supported(shape, dtype, device) is want
    # the shape rules are the reference's (which is False off a TPU)
    if want is False and device == "cuda" and len(shape) == 4:
        assert jfa.supported(shape, str(dtype).replace("torch.", "")) is False


@pytest.mark.parametrize("d", [560, 576, 640])
def test_kernel_raises_for_head_dims_it_has_no_tiling_for(d):
    """Every head dim that is a multiple of 64 has a tiling (above 512 the
    streaming route); 560 has none and raises."""
    q = torch.zeros((1, 1024, 1, d))
    if d % 64:
        with pytest.raises(ValueError, match="head_dim a multiple of 64"):
            tfa._launch(q, q, q, True, 0.125, None)
    else:
        assert tfa._check_shape(q) == "float32"
        with pytest.raises(ValueError, match="must lie on"):  # CPU tensors
            tfa._launch(q, q, q, True, 0.125, None)


def test_check_shape_takes_b_h_above_the_grid_y_limit():
    """b*h rides on gridDim.x, so 65,536 (b 4096, h 16) passes; a
    zero-stride view allocates nothing of that size."""
    q = torch.zeros((1, 64, 1, 64)).expand(4096, 64, 16, 64)
    assert tfa._check_shape(q) == "float32"
    with pytest.raises(ValueError, match="must lie on"):      # CPU tensors
        tfa._launch(q, q, q, True, 0.125, None)


def _stream_fwd(q3, k3, v3, causal, scale, window=None, dtype="float32",
                split=False):
    """The streaming route's forward (csrc/flash_fwd.cu,
    flash_fwd_stream_kernel) in plain torch, with the kernel's tiling for
    `dtype` (the arithmetic in q3's type): o's columns in `st.groups`
    groups, the last one narrower where the head dim is no multiple of
    the group; for each group and 64-row query tile one pass over the kv
    tiles the tile sees: S = q k^T summed over the head dim one chunk tile
    at a time (with `split`, design (b) where `st.warpgroups` allows it: two
    groups a block, S split between its two warpgroups), times scale, the reference's _NEG where masked, the online
    softmax (running max m and sum l, the group's accumulator rescaled by
    exp(m_prev - m)) and O[:, group] += P v[:, group]; o = O / l and lse =
    m + log l, which every group forms alike."""
    bh, s, d = q3.shape
    rows, chunk = st.ROWS, st.CHUNK[dtype]
    step = st.TILING["fwd"][dtype][1]
    wgs = st.warpgroups("fwd", dtype, d) if split else 1
    n_groups, width = st.plan("fwd", dtype, d, wgs)
    keep = tfa._keep_mask(s, s, window, q3.device) if causal else None
    o = torch.empty_like(q3)
    lses = []
    for g in range(n_groups):
        cols = slice(g * width, min(d, (g + 1) * width))
        lse = torch.empty(bh, s)
        for q0 in range(0, s, rows):
            qt = q3[:, q0:q0 + rows]
            m = torch.full((bh, rows), tfa._NEG)
            l = torch.zeros(bh, rows)
            acc = torch.zeros(bh, rows, cols.stop - cols.start)
            for k0 in st.kv_tiles(q0, step, s, causal, window):
                kt, vt = k3[:, k0:k0 + step], v3[:, k0:k0 + step]
                sc = st.chunked(qt, kt, chunk, wgs) * scale
                if causal:
                    sc = sc.masked_fill(
                        ~keep[q0:q0 + rows, k0:k0 + step], tfa._NEG)
                mx = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - mx[..., None])
                alpha = torch.exp(m - mx)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ vt[..., cols]
                m = mx
            o[:, q0:q0 + rows, cols] = acc / l[..., None]
            lse[:, q0:q0 + rows] = m + torch.log(l)
        lses.append(lse)
    assert all(torch.equal(lses[0], x) for x in lses[1:])
    return o, lses[0]


def _check_stream_fwd(d, causal, window):
    """The streaming forward's algorithm, with the bf16 and the fp32
    kernel's tiling in both designs, and the port's plain forward against
    the reference's Pallas forward (interpreted), one head, seq 256."""
    q, k, v = _arrays(1, 256, d, seed=11)
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, scale, True, window=window)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    runs = [_stream_fwd(*args, causal, scale, window, dtype, split)
            for dtype in ("float32", "bfloat16") for split in (False, True)
            if not split or st.warpgroups("fwd", dtype, d) == 2]
    for to, tlse in (*runs, tfa._flash_fwd(*args, causal, scale, window)):
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_streaming_route_algorithm_matches_jax_at_head_dim_576(causal,
                                                               window):
    """At head_dim 576 (above every whole-head tiling; three groups of 192
    columns in both tilings)."""
    _check_stream_fwd(576, causal, window)


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_streaming_route_ragged_group_matches_jax_at_head_dim_640(causal,
                                                                  window):
    """At head_dim 640 the last column group is narrower than the rest:
    192 x 3 + 64 in the fp32 tiling, 256 x 2 + 128 in the bf16 one."""
    assert [st.groups(640, st.TILING["fwd"][t][0])
            for t in ("float32", "bfloat16")] == [(4, 192), (3, 256)]
    _check_stream_fwd(640, causal, window)


@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_wide_head_route_algorithm_matches_jax(d, causal, window):
    """At head_dim 256 and 512, where the fp32 forward (from 192) and the
    bf16 one (from 320) take the streaming route: one fp32 group of 192
    columns and one of 64 at 256 (bf16: the whole head), 192 x 2 + 128 at
    512 (bf16: 256 x 2)."""
    _check_stream_fwd(d, causal, window)


def test_wide_head_column_groups_and_work():
    """The streaming kernels' column groups at the head dims 192-512 they
    took over from the scalar kernels, in design (a) (a group a block) and
    (b) (two groups a block, its two warpgroups sharing S and dP, each
    over its share of the chunks; fp32 forward and dQ groups of 128
    columns), where (b) may run, and the FLOPs a visible (q, k) pair that
    forming S (and dP) once a block costs against the function's 4 d
    forward and 10 d backward: (2 B + 2) d forward, (4 B_dq + 2) d + (4
    B_dkv + 4) d backward, B = ceil(G / warpgroups) blocks a tile."""
    assert [st.plan("fwd", "float32", d, 1) for d in (192, 256, 320, 512)] \
        == [(1, 192), (2, 128), (2, 192), (3, 192)]
    assert [st.plan("fwd", "float32", d, 2) for d in (256, 320, 512)] == \
        [(2, 128), (3, 128), (4, 128)]
    assert [st.plan("fwd", "bfloat16", d, 2) for d in (320, 384, 512)] == \
        [(2, 192), (2, 192), (2, 256)]
    assert [st.plan("dq", "bfloat16", d, 1) for d in (192, 256, 512)] == \
        [(1, 192), (1, 256), (2, 256)]
    assert [st.plan("dkv", t, d, 1) for t in ("float32", "bfloat16")
            for d in (192, 256, 512)] == [(2, 128), (2, 128), (4, 128)] * 2
    assert [st.warpgroups(kern, dtype, d) for kern, dtype, d in (
        ("fwd", "float32", 192), ("fwd", "float32", 256),
        ("dq", "bfloat16", 256), ("dq", "bfloat16", 512),
        ("dkv", "float32", 320), ("dkv", "float32", 384),
        ("dkv", "bfloat16", 512), ("fwd", "bfloat16", 576))] == \
        [1, 2, 1, 2, 2, 1, 2, 1]
    # bf16 at 320: five 64-column chunks, 3 + 2; fp32 at 512: 8 + 8
    assert st.split(5, 2) == [(0, 3), (3, 2)]
    assert st.split(16, 2) == [(0, 8), (8, 8)]
    assert st.split(16, 1) == [(0, 16)]
    work = {}
    for dtype in ("float32", "bfloat16"):
        for d in (256, 512):
            for design in ("a", "b"):
                blocks = []
                for kern in ("fwd", "dq", "dkv"):
                    wgs = 1 if design == "a" \
                        else st.warpgroups(kern, dtype, d)
                    blocks.append(-(-st.plan(kern, dtype, d, wgs)[0] // wgs))
                work[dtype, d, design] = (
                    (2 * blocks[0] + 2) / 4,
                    ((4 * blocks[1] + 2) + (4 * blocks[2] + 4)) / 10)
    assert work == {
        ("float32", 256, "a"): (1.5, 2.2), ("float32", 256, "b"): (1.0, 1.4),
        ("float32", 512, "a"): (2.0, 3.4), ("float32", 512, "b"): (1.5, 3.0),
        ("bfloat16", 256, "a"): (1.0, 1.8), ("bfloat16", 256, "b"): (1.0, 1.4),
        ("bfloat16", 512, "a"): (1.5, 3.0), ("bfloat16", 512, "b"): (1.0, 1.8)}
    q, k = (torch.randn(2, 64, 320, dtype=torch.float64) for _ in range(2))
    want = q @ k.transpose(-1, -2)
    for wgs in (1, 2):
        assert torch.allclose(st.chunked(q, k, 64, wgs), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_views_copy_views_off_16_bytes_in_both_types(dtype):
    """flash_attention hands the kernels q, k and v through `_kernel_views`:
    fp32 views whose (b, s, h) steps are off 16 bytes (slices of a packed
    qkv one column wider) are copied as bf16 ones are, into aligned
    contiguous tensors with the same values; aligned packed slices pass as
    they are."""
    b, s, h, d = 2, 64, 3, 64
    wide = torch.randn(b, s, 3 * h * d + 1).to(dtype)
    views = [t.reshape(b, s, h, d)
             for t in wide[..., :3 * h * d].split(h * d, dim=-1)]
    assert not any(tfa._aligned(t) for t in views)
    for got, view in zip(tfa._kernel_views(*views), views):
        assert got is not view and tfa._aligned(got)
        assert got.is_contiguous() and torch.equal(got, view)
    packed = torch.randn(b, s, 3 * h * d).to(dtype)
    views = [t.reshape(b, s, h, d) for t in packed.split(h * d, dim=-1)]
    assert all(got is view
               for got, view in zip(tfa._kernel_views(*views), views))


@pytest.mark.parametrize("d", [64, 192, 256])
def test_sdpa_routes_every_supported_shape_to_the_kernel(monkeypatch, d):
    """SDPA hands a shape that supported() passes to flash_attention, with
    no width of its own in the way (on the card flash_attention launches
    the kernel or raises)."""
    calls = []
    monkeypatch.setattr(tfa, "supported", lambda *a: True)
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v, causal, window: calls.append(
                            (tuple(q.shape), causal, window)) or q)
    q = torch.zeros((1, 128, 2, d))
    scaled_dot_product_attention(q, q, q, is_causal=True, window=7)
    assert calls == [((1, 128, 2, d), True, 7)]


@pytest.mark.parametrize("window", [0, -3, True, 2.5, "4"],
                         ids=["zero", "negative", "bool", "float", "str"])
def test_window_value_errors_match_reference(window):
    q, k, v = (jnp.zeros((1, 128, 1, 64)),) * 3
    with pytest.raises(ValueError, match="window must be a positive int"):
        jfa.flash_attention(q, k, v, causal=True, interpret=True,
                            window=window)
    tq = torch.zeros((1, 128, 1, 64))
    with pytest.raises(ValueError, match="window must be a positive int"):
        tfa.flash_attention(tq, tq, tq, causal=True, window=window)


def test_window_requires_causal():
    tq = torch.zeros((1, 128, 1, 64))
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(tq, tq, tq, causal=False, window=8)
    with pytest.raises(ValueError, match="window requires causal"):
        tfa._flash_fwd(tq[:, :, 0], tq[:, :, 0], tq[:, :, 0], False, 1.0, 8)
    with pytest.raises(ValueError, match="window requires is_causal"):
        scaled_dot_product_attention(tq, tq, tq, window=8)


def test_numpy_int_window_accepted():
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 128, 1, 64, seed=4))
    a = tfa.flash_attention(q, k, v, causal=True, window=np.int64(7))
    b = tfa.flash_attention(q, k, v, causal=True, window=7)
    assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version():
    tfa.launches.clear()
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 128, 2, 64, seed=5))
    tfa.flash_attention(q, k, v, causal=True)
    assert sum(tfa.launches.values()) == 0
    with pytest.raises(ValueError, match="must lie on"):
        tfa._launch(q, k, v, True, 0.125, None)


@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5)],
                         ids=["full", "causal", "window5"])
def test_sdpa_naive_path_matches_jax(mask_kind, causal, window):
    q, k, v = _arrays(2, 16, 2, 64, seed=6)
    rng = np.random.RandomState(7)
    mask = None
    if mask_kind == "bool":
        mask = rng.rand(2, 2, 16, 16) > 0.3
        mask[..., 0] = True
    elif mask_kind == "additive":
        mask = (rng.randn(2, 2, 16, 16) * 0.5).astype(np.float32)
    jmask = None if mask is None else paddle.to_tensor(mask)
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=jmask, is_causal=causal, window=window, training=False)
    got = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal, window=window, training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=ATOL, rtol=0)


def test_sdpa_naive_path_runs_with_autocast_off(monkeypatch):
    """The naive branch computes inside auto_cast's `disabled()`: the
    reference's auto_cast reaches only linear and matmul, so its scores,
    softmax and probabilities keep q's dtype. (On the CPU torch's autocast
    leaves softmax alone, so only the card shows the values move; the
    cuda test below holds them.)"""
    from paddle_tpu_torch.nn.functional import transformer

    entered = []
    real = transformer._autocast_off

    @contextlib.contextmanager
    def recording():
        with real():
            entered.append(torch.is_autocast_enabled("cpu"))
            yield

    monkeypatch.setattr(transformer, "_autocast_off", recording)
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 16, 2, 64, seed=8))
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert entered == [False]
    assert out.dtype == torch.float32


# ---- on the card -----------------------------------------------------------

#: chip_smoke.py's bands for the kernels' o against the plain version
#: (FLASH_TOL there; fp32 scaled by max(1, max|plain|)), and for lse in
#: both types
FP32_TOL, BF16_TOL, LSE_TOL = 2e-4, 2e-2, 2e-4
#: chip_smoke.py's TF32X3_FWD_TOL: the fp32 forward on the tf32x3 route, o
#: (scaled by max(1, max|plain|)) and lse; one TF32 pass lands outside it
TF32X3_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernel has no CPU mode)")
    return torch.device("cuda")


def fwd_route(dname, d):
    """The forward's route by type and head dim: mma for bf16 up to 256,
    tf32x3 for fp32 at 64 and 128, else stream."""
    if dname == "bfloat16" and d <= 256:
        return "mma"
    return "tf32x3" if d in (64, 128) else "stream"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_kernel_matches_plain_on_card(cuda, d, dtype, tol, causal, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(4, 1024, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    dname = str(dtype).replace("torch.", "")
    route = fwd_route(dname, d)
    n = tfa.routes[f"flash_fwd:{dname}:{route}"]
    o, lse = tfa._flash_fwd(q, k, v, causal, scale, window)
    torch.cuda.synchronize()
    assert tfa.routes[f"flash_fwd:{dname}:{route}"] == n + 1
    ro, rlse = tfa.flash_attention_ref(q, k, v, causal, scale, window)
    err = (o.float() - ro.float()).abs().max().item()
    assert err <= tol and (lse - rlse).abs().max().item() <= LSE_TOL
    if dname == "float32":   # three TF32 passes on every fp32 route
        assert err <= TF32X3_TOL * max(1.0, ro.abs().max().item())
        assert (lse - rlse).abs().max().item() <= TF32X3_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
def test_packed_qkv_views_with_a_small_window_on_card(cuda, d, dtype, tol):
    """q, k, v as strided slices of one packed qkv tensor (row stride
    3 * h * d), read without a copy, at every head dim, with a window (17)
    below every kv and query tile."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, s, h = 2, 1024, 3
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    with torch.no_grad():
        o = tfa.flash_attention(q, k, v, causal=True, window=17)
    ro, _ = tfa.flash_attention_ref(*(tfa._heads(t) for t in (q, k, v)),
                                    True, 1.0 / math.sqrt(d), 17)
    torch.cuda.synchronize()
    err = (o.float() - tfa._unheads(ro, b, h).float()).abs().max().item()
    assert err <= tol


def _fwd_band_check(q, k, v, causal, scale, window, tol=FP32_TOL,
                    lse_tol=LSE_TOL):
    """The forward kernel on [B, S, H, D] views against the plain version:
    o within tol x max(1, max|plain|), lse within lse_tol. Returns
    (o, lse)."""
    b, _, h, _ = q.shape
    o, lse = tfa._launch(q, k, v, causal, scale, window)
    ro, rlse = tfa.flash_attention_ref(*(tfa._heads(t) for t in (q, k, v)),
                                       causal, scale, window)
    ro = tfa._unheads(ro, b, h)
    torch.cuda.synchronize()
    band = tol * max(1.0, ro.abs().max().item())
    assert (o - ro).abs().max().item() <= band
    assert (lse - rlse).abs().max().item() <= lse_tol
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1024, 1088])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [None, 100, 17],
                         ids=["causal", "window100", "window17"])
def test_fp32_tf32_forward_on_packed_views_on_card(cuda, s, d, window):
    """fp32 q, k, v slices of one packed qkv (16-byte aligned) take the
    TF32 three-pass kernel (route tf32x3, counted); at seq 1088 the last
    query tile is half empty, and windows of 100 and 17 cross the query
    and kv tiles at no multiple of either; o and lse within the three-pass
    band (TF32X3_TOL) of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(10)
    b, h = 2, 3
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    n = sum(tfa.routes.values())
    key = "flash_fwd:float32:tf32x3"
    n_tf32 = tfa.routes[key]
    _fwd_band_check(q, k, v, True, 1.0 / math.sqrt(d), window, TF32X3_TOL,
                    TF32X3_TOL)
    assert tfa.routes[key] == n_tf32 + 1 and sum(tfa.routes.values()) == n + 1


@pytest.mark.cuda
def test_fp32_views_off_16_bytes_are_copied_or_refused_on_card(cuda):
    """fp32 q, k, v whose sequence step is not a multiple of 16 bytes (a
    packed qkv one column wider than the three heads' blocks): the forward
    kernel's entry refuses them before any launch and names the operand;
    flash_attention copies them (`_aligned_copy`) and launches the TF32
    kernel once, within the three-pass band of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(11)
    b, s, h, d = 2, 1024, 3, 64
    wide = torch.randn(b, s, 3 * h * d + 1, generator=g, device=cuda)
    q, k, v = (t.reshape(b, s, h, d)
               for t in wide[..., :3 * h * d].split(h * d, dim=-1))
    assert not any(tfa._aligned(t) for t in (q, k, v))
    n = sum(tfa.routes.values())
    with pytest.raises(ValueError, match="float32 q must be 16-byte aligned"):
        tfa._launch(q, k, v, True, 0.125, None)
    assert sum(tfa.routes.values()) == n
    n_tf32 = tfa.routes["flash_fwd:float32:tf32x3"]
    with torch.no_grad():
        o = tfa.flash_attention(q, k, v, causal=True)
    ro, _ = tfa.flash_attention_ref(*(tfa._heads(t) for t in (q, k, v)),
                                    True, 0.125)
    ro = tfa._unheads(ro, b, h)
    torch.cuda.synchronize()
    assert tfa.routes["flash_fwd:float32:tf32x3"] == n_tf32 + 1
    assert sum(tfa.routes.values()) == n + 1
    band = TF32X3_TOL * max(1.0, ro.abs().max().item())
    assert (o - ro).abs().max().item() <= band


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fp32_tf32_forward_two_calls_bit_equal_on_card(cuda, d, dtype):
    """Every block writes only its own rows of o and lse: two calls on
    the same inputs give the same bits, on every route (at 512 the
    streaming one, whose column groups' blocks form S alike)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(4, 1024, 6, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    first = tfa._launch(q, k, v, True, 1.0 / math.sqrt(d), None)
    again = tfa._launch(q, k, v, True, 1.0 / math.sqrt(d), None)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
def test_bf16_kernel_raises_on_a_misaligned_view_on_card(cuda):
    """The bf16 kernel copies 16-byte chunks: a view whose rows start off
    a 16-byte boundary raises rather than falling back."""
    qkv = torch.randn(1, 1024, 2 * 64 + 1, device=cuda).to(torch.bfloat16)
    q = qkv[..., 1:65].reshape(1, 1024, 1, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._launch(q, q, q, True, 0.125, None)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [192, 256, 320, 512])
def test_sdpa_launches_wide_heads_on_card(cuda, d):
    q = torch.randn(1, 1024, 2, d, device=cuda)
    n = sum(tfa.launches.values())
    with torch.no_grad():
        scaled_dot_product_attention(q, q, q, is_causal=True)
    assert sum(tfa.launches.values()) == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["eval", "dropout"])
def test_naive_sdpa_keeps_bf16_under_auto_cast_on_card(cuda, dropout_p):
    """At seq 512 (the naive path) under auto_cast(bf16), SDPA on bf16 q,
    k, v gives the plain bf16 math bit for bit: bf16 scores, a bf16
    softmax, dropout on bf16 probabilities (the same mask, from a
    reseeded generator). torch's autocast would have made the CUDA
    softmax's probabilities fp32, and the dropout's rescale fp32 with
    them."""
    from paddle_tpu_torch.core import generator

    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(2, 512, 4, 64, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    pt.seed(3)
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        got = scaled_dot_product_attention(q, k, v, dropout_p=dropout_p,
                                           is_causal=True, training=True)
    pt.seed(3)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * 0.125
    keep = torch.ones(512, 512, dtype=torch.bool, device=cuda).tril()
    probs = torch.softmax(scores.masked_fill(~keep, -1e30), dim=-1)
    if dropout_p:
        mask = torch.rand(probs.shape, device=cuda,
                          generator=generator.default_generator(cuda)) \
            >= dropout_p
        probs = torch.where(mask, probs / (1 - dropout_p),
                            torch.zeros_like(probs))
    want = torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2)
    assert probs.dtype == got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sdpa_raises_for_a_head_the_kernel_cannot_tile_on_card(cuda):
    """Head dim 576 has no whole-head tiling: SDPA launches the streaming
    route, which matches the plain version (nothing raises where the
    reference computes)."""
    q, k, v = (torch.randn(1, 1024, 2, 576, device=cuda) for _ in range(3))
    n = tfa.routes["flash_fwd:float32:stream"]
    with torch.no_grad():
        o = scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.cuda.synchronize()
    assert tfa.routes["flash_fwd:float32:stream"] == n + 1
    ro, _ = tfa.flash_attention_ref(*(tfa._heads(t) for t in (q, k, v)),
                                    True, 1.0 / math.sqrt(576))
    assert (o - tfa._unheads(ro, 1, 2)).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_forward_at_b_h_above_the_grid_y_limit_on_card(cuda):
    """b*h = 65,600 (seq 64, head_dim 64, fp32) on gridDim.x: the forward
    matches its plain version."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(65600, 64, 1, 64, generator=g, device=cuda)
               for _ in range(3))
    o, lse = tfa._launch(q, k, v, True, 0.125, None)
    torch.cuda.synchronize()
    ro, rlse = tfa.flash_attention_ref(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                       True, 0.125)
    assert (o[:, :, 0] - ro).abs().max().item() <= 2e-4
    assert (lse - rlse).abs().max().item() <= LSE_TOL


# ---- the bf16 tensor-core kernel's rounding ---------------------------------




def _tensor_core_rounding(q3, k3, v3, causal, scale, window=None):
    """Where the bf16 mma.sync kernel rounds, in plain torch: S = Q K^T of
    the bf16 inputs accumulated in fp32, the scale applied to S in fp32,
    the softmax's max and sum in fp32, P rounded to bf16 before an
    fp32-accumulated P V, o / l rounded to bf16."""
    s = (q3.float() @ k3.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~tfa._keep_mask(*s.shape[-2:], window, s.device),
                          float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p.to(torch.bfloat16).float() @ v3.float()) / l
    return o.to(torch.bfloat16), (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize("d,window", [(64, None), (64, 100), (128, None),
                                      (256, None)],
                         ids=["d64", "d64_window100", "d128", "d256"])
def test_bf16_tensor_core_rounding_within_band_of_plain(d, window):
    """At s 1024, causal, d 64 / 128 / 256: rounding P to bf16 before P V,
    with the scale applied to S in fp32, as the mma.sync kernel must,
    stays within the bf16 band of the fp32-math plain version; and on the
    same inputs the plain version matches the JAX package."""
    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(2, 1024, d).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    po, plse = tfa.flash_attention_ref(q, k, v, True, scale, window)
    ro, rlse = _tensor_core_rounding(q, k, v, True, scale, window)
    assert (ro.float() - po.float()).abs().max().item() <= BF16_TOL
    assert (rlse - plse).abs().max().item() <= LSE_TOL

    # the plain version against the JAX package, fp32 on the same values
    qf, kf, vf = (t.float() for t in (q, k, v))
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(t.numpy()) for t in (qf, kf, vf)),
                              True, scale, True, window=window)
    to, tlse = tfa._flash_fwd(qf, kf, vf, True, scale, window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)


# ---- the fp32 TF32 tensor-core kernel's three passes ------------------------

def _tf32_fwd(q3, k3, v3, causal, scale, window, mm):
    """The fp32 tensor-core kernel's forward in plain torch, every product
    through `mm`: S = (Q * scale) K^T (the scale on q in fp32, where the
    reference applies it), the reference's _NEG on masked scores, P =
    exp(S - m) in fp32, o = (P V) / l, lse = m + log l."""
    s = mm(q3 * scale, k3.transpose(-1, -2))
    if causal:
        s = s.masked_fill(~tfa._keep_mask(*s.shape[-2:], window, s.device),
                          tfa._NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v3) / l, (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize("d,window", [(64, None), (64, 100), (128, None)],
                         ids=["d64", "d64_window100", "d128"])
def test_fp32_three_pass_tf32_forward_within_band_of_plain(d, window):
    """At s 1024, causal, b 1, h 2: both products of the forward formed in
    three TF32 passes, as the fp32 tensor-core kernel forms them, keep o
    and lse within the three-pass band (TF32X3_TOL; ~3e-7 and ~1e-6 here),
    itself inside the fp32 band of the plain version; one TF32 pass lands
    outside the fp32 band (the control: o ~3.4e-4 x max(1, max|plain|),
    lse ~4.6e-4 to 4.7e-4); and on the same inputs
    the plain version matches the JAX package's Pallas forward
    (interpret mode)."""
    rng = np.random.RandomState(17)
    q, k, v = (torch.from_numpy(rng.randn(2, 1024, d).astype(np.float32))
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    po, plse = tfa.flash_attention_ref(q, k, v, True, scale, window)
    top = max(1.0, po.abs().max().item())
    o3, lse3 = _tf32_fwd(q, k, v, True, scale, window, tf32x3)
    o1, lse1 = _tf32_fwd(q, k, v, True, scale, window, tf32x1)
    assert (o3 - po).abs().max().item() <= TF32X3_TOL * top
    assert (lse3 - plse).abs().max().item() <= TF32X3_TOL
    assert (o1 - po).abs().max().item() > FP32_TOL * top
    assert (lse1 - plse).abs().max().item() > LSE_TOL

    jo, jlse = jfa._flash_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              True, scale, True, window=window)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)
