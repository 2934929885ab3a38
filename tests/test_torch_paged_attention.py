"""The port's paged attention (paddle_tpu_torch/ops/tpp.py
``paged_attention`` and ``paged_attention_ref``, the kernel in
ops/csrc/paged_attention.cu) and the int8 row codec
(paddle_tpu_torch/distributed/compress.py) against the JAX package on the
CPU, on the same numpy inputs. The JAX ``paged_attention`` runs its Pallas
kernel in interpret mode, as the JAX package's own tests run it.

Tolerances: 2e-5 (the band the reference holds its kernel to against its
plain version: fp32 summation order); bf16 outputs within one bf16 step
(2^-7 relative) of the JAX plain version; the codec bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.distributed import compress as jcompress
from paddle_tpu.ops import tpp as jtpp

import paged_variants
from paddle_tpu_torch.distributed import compress
from paddle_tpu_torch.ops import _build, tpp

TOL = 2e-5


def _case(quantized, seed=0, B=None):
    """tests/test_paging.py's inputs at the reference's audit shape: random
    frames per row (distinct, frame 0 unused), random lengths."""
    B0, H, hd, bs, maxb = jtpp._PAGED_AUDIT_SHAPES[0]
    B = B or B0
    NB = B0 + 3
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    tables = np.zeros((B, maxb), np.int32)
    lengths = rng.randint(1, maxb * bs, (B,)).astype(np.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)
        tables[b, :n] = rng.choice(np.arange(1, NB), n, replace=False)
    if quantized:
        kp = rng.randint(-127, 128, (NB, H, bs, hd)).astype(np.int8)
        vp = rng.randint(-127, 128, (NB, H, bs, hd)).astype(np.int8)
        ks = rng.rand(NB, H, bs, 1).astype(np.float32) * 0.02
        vs = rng.rand(NB, H, bs, 1).astype(np.float32) * 0.02
        return [q, kp, vp, tables, lengths, ks, vs]
    kp = rng.randn(NB, H, bs, hd).astype(np.float32)
    vp = rng.randn(NB, H, bs, hd).astype(np.float32)
    return [q, kp, vp, tables, lengths, None, None]


def _jax(fn, args):
    return np.asarray(fn(*[None if a is None else jnp.asarray(a)
                           for a in args]).astype(jnp.float32))


def _torch(args, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in args]


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX kernel (interpreted) and its plain version, dense and int8."""
    out = {}
    for quantized in (False, True):
        args = _case(quantized)
        out[quantized] = (_jax(jtpp.paged_attention, args),
                          _jax(jtpp.paged_attention_ref, args))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_matches_the_jax_kernel_and_its_reference(jax_outputs, quantized):
    got = tpp.paged_attention(*_torch(_case(quantized)))
    assert got.dtype == torch.float32 and got.shape == (16, 8, 128)
    kernel, ref = jax_outputs[quantized]
    np.testing.assert_allclose(got.numpy(), kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_bf16_q_within_one_bf16_step_of_jax(quantized):
    args = _case(quantized, seed=1, B=4)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = _torch(args)
    jargs[0], targs[0] = jargs[0].astype(jnp.bfloat16), targs[0].bfloat16()
    if not quantized:
        jargs[1:3] = [a.astype(jnp.bfloat16) for a in jargs[1:3]]
        targs[1:3] = [a.bfloat16() for a in targs[1:3]]
    want = np.asarray(jtpp.paged_attention_ref(*jargs).astype(jnp.float32))
    got = tpp.paged_attention(*targs)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), diff.max()


def test_zero_length_row_gives_zeros_and_shared_frames_agree():
    q, kp, vp, tables, lengths, _, _ = _case(False, seed=2, B=4)
    lengths[0] = 0
    tables[0] = 0
    # rows 2 and 3 read the same frames (a shared prefix) to one length
    tables[3], lengths[3] = tables[2], lengths[2]
    q[3] = q[2]
    args = [q, kp, vp, tables, lengths, None, None]
    got = tpp.paged_attention(*_torch(args)).numpy()
    assert (got[0] == 0).all()
    np.testing.assert_array_equal(got[3], got[2])
    np.testing.assert_allclose(got, _jax(jtpp.paged_attention_ref, args),
                               rtol=TOL, atol=TOL)


def test_argument_errors_match_the_reference():
    q, kp, vp, tables, lengths, ks, vs = _torch(_case(True, B=2))
    with pytest.raises(ValueError, match="H == KVh"):
        tpp.paged_attention(q[:, :4], kp, vp, tables, lengths, ks, vs)
    with pytest.raises(ValueError, match="matching head dim"):
        tpp.paged_attention(q[..., :64], kp, vp, tables, lengths, ks, vs)
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        tpp.paged_attention(q, kp, vp, tables, lengths, ks, None)
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        tpp.paged_attention(q, kp, vp, tables, lengths, None, vs)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    q, kp, vp, tables, lengths, ks, vs = _torch(_case(True, B=2))
    launch = tpp._launch_paged_attention
    with pytest.raises(ValueError, match="int8 pages"):
        launch(q, kp.float(), vp.float(), tables, lengths, ks, vs)
    with pytest.raises(ValueError, match="last three dims contiguous"):
        launch(q, kp.transpose(2, 3), vp.transpose(2, 3), tables, lengths,
               ks, vs)
    bad = tables.clone()
    bad[0, 0] = kp.shape[0]
    with pytest.raises(ValueError, match="table entry"):
        launch(q, kp, vp, bad, lengths, ks, vs)
    # more frames a row than 128 a split times 1,024 splits
    wide = torch.zeros((2, 128 * 1024 + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="maxb up to"):
        launch(q, kp, vp, wide, lengths, ks, vs)
    with pytest.raises(ValueError, match="lie on"):   # a CPU tensor
        launch(q, kp, vp, tables, lengths, ks, vs)
    # one layer of a [NB, L, H, bs, hd] pool goes in as a strided view
    pool = torch.zeros((kp.shape[0], 3) + tuple(kp.shape[1:]),
                       dtype=torch.int8)
    with pytest.raises(ValueError, match="lie on"):
        launch(q, pool[:, 1], pool[:, 1], tables, lengths, ks, vs)


# ---- the kernel's split-and-combine, in plain torch -------------------------

def _split_combine(q, kp, vp, tables, lengths, k_scales, v_scales, nsplit):
    """What csrc/paged_attention.cu computes, in plain torch: each row's
    columns cut into `nsplit` splits of ceil(maxb * bs / nsplit) columns,
    whose ends may fall inside a frame (the stream route's column splits;
    the split route's frame splits are those whose size is a multiple of
    bs); each split's partial softmax state over its columns below the
    length (m, l and acc in fp32; a split past the length m = -inf, l = 0),
    then the splits merged in order (a max of -inf subtracts 0; l == 0
    divides by 1)."""
    B, H, hd = q.shape
    bs, maxb = kp.shape[2], tables.shape[1]
    span = -(-maxb * bs // nsplit)
    k = tpp.gather_pages(kp, tables, k_scales)       # [B, H, maxb*bs, hd]
    v = tpp.gather_pages(vp, tables, v_scales)
    s = torch.einsum("bhd,bhTd->bhT", q.float(), k) / hd ** 0.5
    parts = []
    for i in range(nsplit):
        c0, c1 = i * span, min((i + 1) * span, maxb * bs)
        m = torch.full((B, H, 1), -torch.inf)
        l, acc = torch.zeros(B, H, 1), torch.zeros(B, H, hd)
        for b in range(B):
            end = min(c1, int(lengths[b]))
            if c0 >= end:
                continue
            sb = s[b, :, c0:end]
            m[b] = sb.amax(-1, keepdim=True)
            p = torch.exp(sb - m[b])
            l[b] = p.sum(-1, keepdim=True)
            acc[b] = torch.einsum("hT,hTd->hd", p, v[b, :, c0:end])
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    ms = torch.where(torch.isfinite(M), M, 0.0)
    L, A = torch.zeros(B, H, 1), torch.zeros(B, H, hd)
    for m, l, acc in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - ms), 0.0)
        L = L + l * w
        A = A + acc * w
    return (A / torch.where(L == 0.0, 1.0, L)).to(q.dtype)


def _boundary_case(quantized, nsplit):
    """The audit shape with the lengths at the edges: 0, 1, bs - 1, bs,
    the first split boundary - 1, + 0 and + 1, maxb * bs, and the last
    split boundary that falls inside a frame - 1, + 0 and + 1 (where the
    splits have one); the rest random."""
    args = _case(quantized, seed=6)
    _, _, _, bs, maxb = jtpp._PAGED_AUDIT_SHAPES[0]
    span = -(-maxb * bs // nsplit)
    edge = min(span, maxb * bs)
    lens = [0, 1, bs - 1, bs, edge - 1, edge, min(edge + 1, maxb * bs),
            maxb * bs]
    inner = [i * span for i in range(1, nsplit) if (i * span) % bs
             and i * span < maxb * bs]
    if inner:
        lens += [inner[-1] - 1, inner[-1], inner[-1] + 1]
    rng = np.random.RandomState(7)
    tables, lengths = args[3], args[4]
    lengths[:len(lens)] = lens
    for b in range(len(lens)):
        n = -(-lens[b] // bs)
        tables[b] = 0
        tables[b, :n] = rng.choice(np.arange(1, args[1].shape[0]), n,
                                   replace=False)
    return args


@pytest.fixture(scope="module")
def jax_boundary_outputs():
    """The JAX kernel (interpreted) and its plain version on the boundary
    lengths of each split count, dense and int8."""
    out = {}
    for quantized in (False, True):
        for nsplit in SPLITS:
            args = _boundary_case(quantized, nsplit)
            out[quantized, nsplit] = (args, _jax(jtpp.paged_attention, args),
                                      _jax(jtpp.paged_attention_ref, args))
    return out


#: split counts of the plain model: one; two and four (boundaries on
#: frame edges, as the split route cuts); seven and twenty (boundaries
#: inside the audit shape's 32-column frames, as the stream route may cut;
#: twenty splits of 26 columns, fewer than a frame's)
SPLITS = (1, 2, 4, 7, 20)


@pytest.mark.parametrize("nsplit", SPLITS)
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_split_and_combine_matches_the_jax_kernel(jax_boundary_outputs,
                                                  quantized, nsplit):
    args, kernel, ref = jax_boundary_outputs[quantized, nsplit]
    got = _split_combine(*_torch(args), nsplit).numpy()
    np.testing.assert_allclose(got, kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert (got[0] == 0).all()                      # the length-0 row


@pytest.mark.parametrize("route,B,H,bs,maxb,want", [
    # the split route: frames a split (shown as columns), ~128 columns
    ("split", 8, 12, 16, 64, (128, 8)),     # GPT-2 small's engine, full
    ("split", 16, 8, 32, 16, (128, 4)),     # the reference's audit shape
    ("split", 1, 1, 16, 64, (16, 64)),      # one row: a frame a split
    ("split", 2, 2, 256, 2, (256, 2)),      # frames wider than a split
    ("split", 64, 16, 16, 64, (128, 8)),    # a wide batch keeps ~128
    # the stream route: columns a split, ends inside frames
    ("stream", 8, 4, 512, 4, (128, 16)),    # chip_smoke's timed shape
    ("stream", 8, 4, 16, 64, (64, 16)),     # hd 512 on 16-column frames
    ("stream", 8, 4, 320, 5, (128, 13)),    # boundaries inside frames
    ("stream", 64, 16, 512, 1, (256, 2)),   # a wide batch keeps 256
    ("stream", 1, 1, 512, 1, (32, 16)),     # one row: down to 32 columns
    ("stream", 1, 1, 1, 131073, (256, 513)),   # past 131,072 frames
    ("stream", 1, 1, 16, 65536, (1024, 1024)),  # at most 1,024 splits
])
def test_split_count_fills_two_waves_from_the_shapes_alone(route, B, H, bs,
                                                           maxb, want):
    if route == "split":
        fps, nsplit = tpp._paged_splits(B, H, bs, maxb)
        assert 1 <= fps <= 128
        got, least = (fps * bs, nsplit), bs
    else:
        got = tpp._paged_stream_splits(B, H, bs, maxb)
        least = tpp._PAGED_STREAM_MIN_COLS
    assert got == want
    span, nsplit = got
    assert span * nsplit >= maxb * bs and nsplit <= 1024
    assert B * H * nsplit >= tpp._PAGED_MIN_BLOCKS or span <= least


@pytest.mark.parametrize("hd,item,want", [
    (512, 2, 16), (512, 4, 8), (512, 1, 32),  # the timed hd
    (64, 2, 64), (64, 1, 64),              # short rows: at most 64 a tile
    (384, 2, 16),                          # a power of two under 32 KB
    (4096, 2, 2), (2048, 4, 2),            # 8 KB rows: two columns a slot
])
def test_ring_tiles_fill_a_slot_from_the_row_alone(hd, item, want):
    """The RING path's columns a tile: a slot's K and V within 32 KB; the
    kernel's ring of two slots (STAGES in csrc/paged_attention.cu) then
    fits the C entry's shared-memory layout."""
    tc = tpp._paged_ring(hd, item)
    assert tc == want
    assert 2 * tc * hd * item <= tpp._PAGED_SLOT_BYTES or tc == 1
    stages = 2
    assert stages * 2 * tc * hd * item + 4 * hd + 8 * stages * tc + 8 \
        * stages <= 232448


@pytest.mark.parametrize("name", sorted(
    n for n, (stages, _, _) in paged_variants.VARIANTS.items() if stages))
def test_ring_depth_variant_edits_the_source_once(name):
    """paged_variants.py's deeper rings replace the source's STAGES (2)
    and nothing else."""
    stages = paged_variants.VARIANTS[name][0]
    text = (_build.CSRC / "paged_attention.cu").read_text()
    assert "constexpr int STAGES = 2;" in text
    new = paged_variants.variant_source(text, stages)
    assert new == text.replace("constexpr int STAGES = 2;",
                               f"constexpr int STAGES = {stages};")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal_to_jax(dtype):
    x = np.random.RandomState(3).randn(5, 4, 64).astype(np.float32) * 3
    x[1, 2] = 0.0                                  # a zero row
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jcompress.quantize_rows(jx)
    tq, ts = compress.quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (5, 4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq[1, 2] == 0).all() and ts[1, 2, 0] == 0
    back = compress.dequantize_rows(tq, ts, getattr(torch, dtype))
    jback = jcompress.dequantize_rows(jq, js, jx.dtype)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback.astype(jnp.float32)))
    # the declared band: |err| <= absmax / 254 a row
    band = tx.float().abs().amax(-1, keepdim=True) / 254 + 1e-7
    err = (compress.dequantize_rows(tq, ts) - tx.float()).abs()
    assert (err <= band).all()


def test_non_finite_value_poisons_its_rows_scale():
    x = torch.ones(3, 8)
    x[1, 4] = float("nan")
    x[2, 0] = float("inf")
    q, s = compress.quantize_rows(x)
    assert torch.isfinite(s[0]).all() and not torch.isfinite(s[1:]).any()
    back = compress.dequantize_rows(q, s)
    assert torch.isfinite(back[0]).all()
    assert not torch.isfinite(back[1]).any()


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the paged-attention kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,dtype", [(False, "float32"),
                                             (False, "bfloat16"),
                                             (True, "float32"),
                                             (True, "bfloat16")])
def test_kernel_matches_plain_on_card(cuda, quantized, dtype):
    args = _torch(_case(quantized, seed=5), cuda)
    dt = getattr(torch, dtype)
    args[0] = args[0].to(dt)
    if not quantized:
        args[1:3] = [a.to(dt) for a in args[1:3]]
    args[4][0] = 0
    args[3][0] = 0
    key = f"tpp_paged_attention.{'int8' if quantized else 'dense'}:{dtype}"
    count = tpp.launches[key]
    got = tpp.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpp.launches[key] == count + 1
    want = tpp.paged_attention_ref(*args)
    diff = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert diff.max().item() <= TOL
    else:
        assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
    assert bool((got[0] == 0).all())


def _full_length_case(quantized, seed=8):
    """GPT-2 small's engine at full length: 8 rows of 1024 columns, 12
    heads of 64, 16-column frames from a pool of 513."""
    B, H, hd, bs, maxb, NB = 8, 12, 64, 16, 64, 513
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    tables = np.stack([rng.choice(np.arange(1, NB), maxb, replace=False)
                       for _ in range(B)]).astype(np.int32)
    lengths = np.full((B,), maxb * bs, np.int32)
    if quantized:
        kp, vp = (rng.randint(-127, 128, (NB, H, bs, hd)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.rand(NB, H, bs, 1).astype(np.float32) * 0.02
                  for _ in range(2))
        return [q, kp, vp, tables, lengths, ks, vs]
    kp, vp = (rng.randn(NB, H, bs, hd).astype(np.float32) for _ in range(2))
    return [q, kp, vp, tables, lengths, None, None]


def _odd_width_case(quantized, seed=9):
    """Rows whose bytes are no multiple of 16 in bf16 and int8 (head dim
    100), 7-column frames, nine splits of one frame: the kernel's
    one-element loads and its combine pass."""
    B, H, hd, bs, maxb, NB = 3, 2, 100, 7, 9, 30
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    tables = np.stack([rng.choice(np.arange(1, NB), maxb, replace=False)
                       for _ in range(B)]).astype(np.int32)
    lengths = np.array([0, 20, maxb * bs], np.int32)
    if quantized:
        kp, vp = (rng.randint(-127, 128, (NB, H, bs, hd)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.rand(NB, H, bs, 1).astype(np.float32) * 0.02
                  for _ in range(2))
        return [q, kp, vp, tables, lengths, ks, vs]
    kp, vp = (rng.randn(NB, H, bs, hd).astype(np.float32) for _ in range(2))
    return [q, kp, vp, tables, lengths, None, None]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_length", "boundary", "odd_widths"])
@pytest.mark.parametrize("quantized,dtype", [(False, "float32"),
                                             (False, "bfloat16"),
                                             (True, "float32"),
                                             (True, "bfloat16")])
def test_split_kernel_matches_plain_and_repeats_its_bits_on_card(
        cuda, case, quantized, dtype):
    """The split kernel and its combine pass at the engine's full length,
    at the audit shape's boundary lengths (0, 1, bs - 1, bs, the kernel's
    own split boundary - 1 / + 0 / + 1, maxb * bs) and at odd widths:
    within the file's bands of the plain version, and two calls give the
    same bits."""
    if case == "full_length":
        args = _full_length_case(quantized)
    elif case == "odd_widths":
        args = _odd_width_case(quantized)
    else:
        B, H, _, bs, maxb = jtpp._PAGED_AUDIT_SHAPES[0]
        args = _boundary_case(quantized, tpp._paged_splits(B, H, bs,
                                                           maxb)[1])
    args = _torch(args, cuda)
    dt = getattr(torch, dtype)
    args[0] = args[0].to(dt)
    if not quantized:
        args[1:3] = [a.to(dt) for a in args[1:3]]
    got = tpp.paged_attention(*args)
    again = tpp.paged_attention(*args)
    torch.cuda.synchronize()
    want = tpp.paged_attention_ref(*args)
    diff = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert diff.max().item() <= TOL
    else:
        assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
    assert torch.equal(got, again)
    if case != "full_length":
        assert bool((got[0] == 0).all())


#: the stream route's cases on the card: B, H, hd, bs, maxb, NB and how
#: the pages go in: chip_smoke.py's three stream shapes; one layer of a
#: [NB, 3, H, bs, hd] pool with split boundaries inside 320-column frames;
#: pages one element off 16 bytes and a head dim whose bf16 rows are off
#: 16 bytes (the one-element-a-load path, two head-dim slices at 1,100);
#: rows of 4,096 bf16 (the accumulator in shared memory)
STREAM_CASES = {
    "hd512_bs512": ((8, 4, 512, 512, 4, 40), "as_is"),
    "hd512_bs16": ((4, 4, 512, 16, 64, 260), "as_is"),
    "hd64_bs512": ((8, 4, 64, 512, 4, 40), "as_is"),
    "pool_layer": ((8, 4, 384, 320, 5, 44), "pool_layer"),
    "off16": ((4, 2, 512, 512, 2, 12), "off16"),
    "odd_hd": ((3, 2, 1100, 300, 3, 10), "as_is"),
    "hd4096": ((2, 2, 4096, 16, 4, 10), "as_is"),
}


def _stream_case(shape, quantized, seed=10):
    """Random pages, distinct random frames a row, random lengths with
    row 0 empty and row 1 at the full maxb * bs."""
    B, H, hd, bs, maxb, NB = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    lengths = rng.randint(1, maxb * bs + 1, (B,)).astype(np.int32)
    lengths[0], lengths[1] = 0, maxb * bs
    tables = np.zeros((B, maxb), np.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)
        tables[b, :n] = rng.choice(np.arange(1, NB), n, replace=False)
    if quantized:
        kp, vp = (rng.randint(-127, 128, (NB, H, bs, hd)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.rand(NB, H, bs, 1).astype(np.float32) * 0.02
                  for _ in range(2))
        return [q, kp, vp, tables, lengths, ks, vs]
    kp, vp = (rng.randn(NB, H, bs, hd).astype(np.float32) for _ in range(2))
    return [q, kp, vp, tables, lengths, None, None]


def _pages_as(t, how):
    """The same page values as a pool layer's view or one element off 16
    bytes (scales stay as they are off 16 bytes)."""
    if how == "pool_layer":
        pool = torch.zeros((t.shape[0], 3) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device)
        pool[:, 1] = t
        return pool[:, 1]
    if how == "off16" and t.shape[-1] != 1:
        flat = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
        view = flat[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
@pytest.mark.parametrize("quantized,dtype", [(False, "float32"),
                                             (False, "bfloat16"),
                                             (False, "float16"),
                                             (True, "float32"),
                                             (True, "bfloat16")])
def test_stream_kernel_matches_plain_and_repeats_its_bits_on_card(
        cuda, case, quantized, dtype):
    """The stream route (head dim or frame above 256): within the file's
    bands of the plain version (fp16 one fp16 step), two calls give the
    same bits, the length-0 row gives zeros, and each launch is counted on
    the route its view takes."""
    shape, how = STREAM_CASES[case]
    args = _torch(_stream_case(shape, quantized), cuda)
    dt = getattr(torch, dtype)
    args[0] = args[0].to(dt)
    if not quantized:
        args[1:3] = [a.to(dt) for a in args[1:3]]
    for i in (1, 2, 5, 6):
        if args[i] is not None:
            args[i] = _pages_as(args[i], how)
    # the C entry's RING path takes rows of at most 8 KB on 16 bytes
    row = args[1].element_size() * shape[2]
    route = "stream_direct" if how == "off16" or row % 16 or row > 8192 \
        else "stream"
    key = f"tpp_paged_attention.{'int8' if quantized else 'dense'}:" \
          f"{dtype}:{route}"
    count = tpp.routes[key]
    got = tpp.paged_attention(*args)
    again = tpp.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpp.routes[key] == count + 2
    want = tpp.paged_attention_ref(*args)
    diff = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert diff.max().item() <= TOL
    else:
        rel = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -10
        assert bool((diff <= rel * want.float().abs() + 1e-6).all())
    assert torch.equal(got, again)
    assert bool((got[0] == 0).all())
