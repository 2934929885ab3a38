"""The public kernel entries take every input the reference computes: what
a kernel cannot read as it is (a strided or misaligned view, another
dtype, a paged-attention shape past the split kernel's registers and
shared memory) is copied, cast or sent to the paged stream route, never
refused, while the private launchers keep their refusals.

On the CPU: which operands the entries copy, and a plain-torch emulation
of the paged stream route's tiles and lane groups (each with its own
online softmax, merged in group order) against ``paged_attention_ref``. On the card (``cuda`` marker): each case through
its public entry, against the same call on a contiguous copy (bit-equal:
the same kernel on the same values) or against the plain version within
its band: fp32 2e-5 (PAGED_TOL_F32 / the row kernels' 1e-5), bf16 and
fp16 one step of their type (2^-7, 2^-10) of the plain value.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import nms_pallas, tpp

F32_TOL = 2e-5
STEP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
        torch.float32: 0.0}


def _pool(B, H, hd, bs, maxb, NB, dtype=torch.float32, seed=0,
          quantized=False, device="cpu"):
    """Random frames a row (frame 0 unused), random lengths, one length
    full and one zero where B > 2."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g)
    tables = torch.stack([torch.randperm(NB - 1, generator=g)[:maxb] + 1
                          if NB - 1 >= maxb else
                          torch.randint(1, NB, (maxb,), generator=g)
                          for _ in range(B)]).int()
    lengths = torch.randint(1, maxb * bs + 1, (B,), generator=g).int()
    if B > 2:
        lengths[1], lengths[2] = maxb * bs, 0
    if quantized:
        kp = torch.randint(-127, 128, (NB, H, bs, hd), generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (NB, H, bs, hd), generator=g,
                           dtype=torch.int8)
        ks = torch.rand(NB, H, bs, 1, generator=g) * 0.02
        vs = torch.rand(NB, H, bs, 1, generator=g) * 0.02
    else:
        kp = torch.randn(NB, H, bs, hd, generator=g).to(dtype)
        vp = torch.randn(NB, H, bs, hd, generator=g).to(dtype)
        ks = vs = None
    return [t if t is None else t.to(device)
            for t in (q.to(dtype), kp, vp, tables, lengths, ks, vs)]


def _stream_emulation(q, kp, vp, tables, lengths, k_scales=None,
                      v_scales=None):
    """csrc/paged_attention.cu's stream route (its RING path) in plain
    torch, one split a row: the columns in tiles of at most tc columns
    (``tpp._paged_ring``) that never cross a frame; lane group g of G
    takes a tile's columns g, g + G, ..., 4 at a time, with its own
    running max and sum rescaled by exp(m_old - m_new) and its own fp32
    accumulator; the groups merged in group order; out = acc / l (l == 0
    gives zeros)."""
    B, H, hd = q.shape
    bs = kp.shape[2]
    tc = tpp._paged_ring(hd, kp.element_size())
    nch = hd * kp.element_size() // 16
    G = 4 * (32 // min(32, 1 << (nch - 1).bit_length()))
    k = tpp.gather_pages(kp, tables, k_scales)
    v = tpp.gather_pages(vp, tables, v_scales)
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = int(lengths[b])
        m = torch.full((G, H, 1), -math.inf)
        l, acc = torch.zeros(G, H, 1), torch.zeros(G, H, hd)
        t = 0
        while t < n:
            nt = min(tc, n - t, bs - t % bs)
            for base in range(0, nt, G * 4):
                for g in range(G):
                    cols = [t + base + g + u * G for u in range(4)
                            if base + g + u * G < nt]
                    if not cols:
                        continue
                    s = torch.einsum("hd,hTd->hT", q[b].float(),
                                     k[b, :, cols]) / hd ** 0.5
                    mx = torch.maximum(m[g], s.amax(-1, keepdim=True))
                    alpha = torch.exp(m[g] - mx)
                    p = torch.exp(s - mx)
                    l[g] = l[g] * alpha + p.sum(-1, keepdim=True)
                    acc[g] = acc[g] * alpha + torch.einsum(
                        "hT,hTd->hd", p, v[b, :, cols])
                    m[g] = mx
            t += nt
        M = m.amax(0)
        w = torch.where(torch.isfinite(m),
                        torch.exp(m - torch.where(torch.isfinite(M), M, 0.0)),
                        0.0)
        L, A = (l * w).sum(0), (acc * w).sum(0)
        out[b] = A / torch.where(L == 0, 1.0, L)
    return out.to(q.dtype)


@pytest.mark.parametrize("hd, bs, quantized", [(512, 16, False),
                                               (64, 512, False),
                                               (512, 512, True)])
def test_stream_route_emulation_matches_plain(hd, bs, quantized):
    args = _pool(3, 2, hd, bs, 3, 6, quantized=quantized, seed=hd + bs)
    assert tpp._paged_stream_route(hd, bs, 3)
    got = _stream_emulation(*args)
    want = tpp.paged_attention_ref(*args)
    assert float((got - want).abs().max()) <= F32_TOL
    assert bool((got[2] == 0).all())


def test_stream_route_is_taken_past_the_split_kernels_caps():
    assert not tpp._paged_stream_route(256, 256, 128 * 1024)
    assert tpp._paged_stream_route(257, 16, 64)
    assert tpp._paged_stream_route(64, 257, 64)
    assert tpp._paged_stream_route(64, 16, 128 * 1024 + 1)
    # the stream route's split count keeps the combine pass within its
    # 1,024 splits
    maxb = 128 * 1024 + 1
    span, nsplit = tpp._paged_stream_splits(1, 2, 1, maxb)
    assert nsplit <= tpp._PAGED_MAX_SPLITS and span * nsplit >= maxb


def test_paged_readable_copies_only_what_the_kernel_cannot_read():
    q, kp, vp, _, _, _, _ = _pool(2, 2, 64, 16, 4, 9)
    same = tpp._paged_readable(q, kp, vp, None, None)
    assert all(a is b for a, b in zip(same[:3], (q, kp, vp)))
    layer = torch.zeros(9, 3, 2, 16, 64)[:, 1]    # one layer of a pool
    assert tpp._paged_readable(q, layer, layer, None, None)[1] is layer
    tr = kp.transpose(1, 2).contiguous().transpose(1, 2)   # [NB, bs, H, hd]
    got = tpp._paged_readable(q.half(), tr, vp.bfloat16(), None, None)
    assert got[0].dtype == torch.float16
    assert got[1].is_contiguous() and got[2].is_contiguous()
    assert got[1].dtype == got[2].dtype == torch.float32
    assert torch.equal(got[1], kp)
    got = tpp._paged_readable(q.double()[:, ::1], kp.bfloat16(),
                              vp.bfloat16(), None, None)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    qi, kpi, vpi, _, _, ks, vs = _pool(2, 2, 64, 16, 4, 9, quantized=True)
    wide = torch.zeros(9, 2, 16, 2)[..., :1]     # strided scales
    got = tpp._paged_readable(qi, kpi, vpi, wide, wide)
    assert got[3].stride()[1:3] == (16, 1)
    assert tpp._paged_readable(qi, kpi, vpi, ks, vs)[3] is ks


def test_rows_readable():
    x = torch.randn(8, 16)
    assert tpp._rows_readable(x)[0] is x
    xs, want = tpp._rows_readable(x.half()[:, ::2])
    assert xs.dtype == torch.float32 and xs.is_contiguous()
    assert want == torch.float16


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _within(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(diff.max()) <= F32_TOL
    return bool((diff <= STEP[dtype] * want.float().abs() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hd, bs, quantized, dtype", [
    (512, 16, False, torch.float32), (512, 16, False, torch.bfloat16),
    (64, 512, False, torch.bfloat16), (512, 512, False, torch.float32),
    (512, 512, True, torch.float32), (320, 272, True, torch.bfloat16)])
def test_paged_stream_route_on_card(cuda, hd, bs, quantized, dtype):
    args = _pool(8, 4, hd, bs, 6, 40, dtype=dtype, quantized=quantized,
                 seed=hd * bs, device=cuda)
    kind = f"{'int8' if quantized else 'dense'}:{str(dtype)[6:]}"
    n = tpp.routes[f"tpp_paged_attention.{kind}:stream"]
    got = tpp.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpp.routes[f"tpp_paged_attention.{kind}:stream"] == n + 1
    assert got.dtype == dtype
    assert _within(got, tpp.paged_attention_ref(*args), dtype)
    assert bool((got[2] == 0).all())
    again = tpp.paged_attention(*args)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_paged_more_than_131072_frames_a_row_on_card(cuda):
    maxb = 128 * 1024 + 5
    args = _pool(1, 2, 64, 1, maxb, 64, seed=3, device=cuda)
    args[4][0] = maxb
    got = tpp.paged_attention(*args)
    torch.cuda.synchronize()
    assert _within(got, tpp.paged_attention_ref(*args), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype, page_dtype", [
    (torch.float16, torch.float16), (torch.float16, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float16)])
def test_paged_dtype_pairs_on_card(cuda, q_dtype, page_dtype):
    q, kp, vp, tables, lengths, _, _ = _pool(8, 12, 64, 16, 32, 300,
                                             seed=11, device=cuda)
    q, kp, vp = q.to(q_dtype), kp.to(page_dtype), vp.to(page_dtype)
    n = tpp.routes[f"tpp_paged_attention.dense:{str(q_dtype)[6:]}:split"]
    got = tpp.paged_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert tpp.routes[
        f"tpp_paged_attention.dense:{str(q_dtype)[6:]}:split"] == n + 1
    assert got.dtype == q_dtype
    assert _within(got, tpp.paged_attention_ref(q, kp, vp, tables, lengths),
                   q_dtype)


@pytest.mark.cuda
def test_paged_views_on_card(cuda):
    """A transposed-page view ([NB, bs, H, hd] seen as [NB, H, bs, hd]), a
    strided q and strided scales give the contiguous operands' bits."""
    q, kp, vp, tables, lengths, ks, vs = _pool(8, 12, 64, 16, 32, 300,
                                               seed=12, quantized=True,
                                               device=cuda)
    want = tpp.paged_attention(q, kp, vp, tables, lengths, ks, vs)
    tk = kp.transpose(1, 2).contiguous().transpose(1, 2)
    tv = vp.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros(q.shape[0], q.shape[1], 2 * q.shape[2],
                       device=cuda)[..., ::2]
    wide.copy_(q)
    sk = torch.zeros(ks.shape[:3] + (3,), device=cuda)[..., 1:2]
    sk.copy_(ks)
    got = tpp.paged_attention(wide, tk, tv, tables, lengths, sk, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    qd, kd, vd = q.bfloat16(), kp.float().bfloat16(), vp.float().bfloat16()
    want = tpp.paged_attention(qd, kd, vd, tables, lengths)
    got = tpp.paged_attention(qd, kd.transpose(1, 2).contiguous()
                              .transpose(1, 2), vd, tables, lengths)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tpp_matmul_strided_operands_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    big = torch.randn(256, 512, device=cuda, generator=g).to(dtype)
    x = big[:, ::2]                               # [256, 256], strided
    wbig = (0.05 * torch.randn(512, 512, device=cuda, generator=g)).to(dtype)
    w = wbig[::2, ::2]                            # [256, 256], no contiguous
    #                                               dimension
    bias = torch.randn(256, device=cuda, generator=g).to(dtype)
    bias_s = torch.zeros(512, device=cuda, dtype=dtype)[::2]
    bias_s.copy_(bias)
    with torch.no_grad():
        got = tpp.matmul(x, w, bias_s, act="gelu")
        want = tpp.matmul(x.contiguous(), w.contiguous(), bias, act="gelu")
        gamma = 1.0 + 0.1 * big[0, ::2]
        beta = 0.1 * big[1, ::2]
        ln = tpp.ln_matmul(x, gamma, beta, w, bias)
        ln_want = tpp.ln_matmul(x.contiguous(), gamma.contiguous(),
                                beta.contiguous(), w.contiguous(), bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ln, ln_want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_row_primitives_strided_and_fp16_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    big = torch.randn(256, 1024, device=cuda, generator=g).to(dtype)
    x = big[:, ::2]
    bias = torch.randn(512, device=cuda, generator=g)
    mask = (torch.rand(256, 1024, device=cuda, generator=g) > 0.3)[:, ::2]
    for got, want in (
            (tpp.softmax_rows(x), tpp._softmax_rows_ref(x)),
            (tpp.bias_act(x, bias, "gelu"), tpp._bias_act_ref(x, bias,
                                                               "gelu")),
            (tpp.masked_reduce(x, mask, "sum"),
             tpp._masked_reduce_ref(x, mask, "sum")),
            (tpp.masked_reduce(x, mask, "max"),
             tpp._masked_reduce_ref(x, mask, "max"))):
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5 * max(
                1.0, float(want.abs().max()))
        else:
            assert _within(got, want, dtype)
    if dtype != torch.float16:
        assert torch.equal(tpp.softmax_rows(x),
                           tpp.softmax_rows(x.contiguous()))


@pytest.mark.cuda
def test_nms_misaligned_view_on_card(cuda):
    n = 300
    g = torch.Generator(device=cuda).manual_seed(2)
    xy = torch.rand(n, 2, device=cuda, generator=g) * 100
    boxes = torch.cat([xy, xy + 5 + torch.rand(n, 2, device=cuda,
                                               generator=g) * 30], -1)
    flat = torch.empty(4 * n + 1, device=cuda)
    flat[1:] = boxes.reshape(-1)
    view = flat[1:].view(n, 4)                 # contiguous, 4 bytes off 16
    assert view.data_ptr() % 16 and view.is_contiguous()
    got = nms_pallas.nms_keep_mask(view, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_pallas.nms_keep_mask(boxes, 0.5))
    assert torch.equal(got.cpu(), nms_pallas.nms_keep_mask_ref(
        boxes.cpu(), 0.5))


@pytest.mark.cuda
def test_flash_misaligned_and_strided_views_on_card(cuda):
    b, s, h, d = 2, 128, 2, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(b, s, h, d, device=cuda, generator=g)
               .bfloat16() for _ in range(3))
    want = fa.flash_attention(q, k, v, causal=True)
    buf = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    buf[1:] = q.reshape(-1)
    qm = buf[1:].view(b, s, h, d)              # 2 bytes off 16
    wide = torch.empty(b, s, h, 2 * d, device=cuda,
                       dtype=torch.bfloat16)[..., ::2]
    wide.copy_(k)                              # strided head dim
    got = fa.flash_attention(qm, wide, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    q32 = q.float()
    w32 = torch.empty(b, s, h, 2 * d, device=cuda)[..., ::2]
    w32.copy_(q32)
    assert torch.equal(fa.flash_attention(w32, k.float(), v.float()),
                       fa.flash_attention(q32, k.float(), v.float()))
