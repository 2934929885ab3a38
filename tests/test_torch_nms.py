"""The port's NMS (paddle_tpu_torch/ops/nms_pallas.py and
paddle_tpu_torch/vision/ops.py) against the JAX package's.

The reference's Pallas kernel runs in interpret mode on the CPU
(``nms_keep_mask_pallas(..., interpret=True)``), and its ``nms_mask``
takes its scan over the IoU matrix there. Inputs come from a numpy seed
and go to both packages. Every comparison is exact: NMS decides by
comparing IoUs and scores, and the port rounds each IoU as the reference
does (the same operations in the same order), so any difference is a
flipped decision, not a rounding one. Tests marked ``cuda`` hold the CUDA
kernel against the plain version on a card, and skip without one.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import nms_pallas as jnms
from paddle_tpu.vision import ops as jops

from paddle_tpu_torch.ops import nms_pallas
from paddle_tpu_torch.vision import ops


def _boxes(n, seed, size=60.0, max_wh=30.0):
    """[n, 4] xyxy float32 boxes, clustered enough that NMS suppresses."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * max_wh + 1.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _greedy_numpy(boxes, thr):
    """Textbook greedy NMS over score-sorted boxes, in float32 numpy with
    the reference's operations and order."""
    b = np.asarray(boxes, np.float32)
    area = np.maximum(b[:, 2] - b[:, 0], np.float32(0)) \
        * np.maximum(b[:, 3] - b[:, 1], np.float32(0))
    keep = np.ones(len(b), bool)
    for i in range(len(b)):
        if not keep[i]:
            continue
        iw = np.maximum(np.minimum(b[:, 2], b[i, 2])
                        - np.maximum(b[:, 0], b[i, 0]), np.float32(0))
        ih = np.maximum(np.minimum(b[:, 3], b[i, 3])
                        - np.maximum(b[:, 1], b[i, 1]), np.float32(0))
        inter = iw * ih
        iou = inter / np.maximum(area + area[i] - inter, np.float32(1e-9))
        keep &= ~((iou > np.float32(thr)) & (np.arange(len(b)) > i))
    return keep


WORD = nms_pallas.WORD


def _tile_of(t):
    """(rt, ct) of tile pair t as csrc/nms.cu's nms_mask_kernel numbers
    them: column tile ct, row tile rt <= ct, t = ct (ct + 1) / 2 + rt."""
    ct = int((math.sqrt(8.0 * t + 1.0) - 1.0) / 2.0)
    while ct * (ct + 1) // 2 > t:
        ct -= 1
    while (ct + 1) * (ct + 2) // 2 <= t:
        ct += 1
    return t - ct * (ct + 1) // 2, ct


def _tile_columns(n, rt, ct):
    """[64, 64] bool: the columns each row of tile (rt, ct) evaluates, as
    csrc/nms.cu's tile_word bounds them: up to the valid columns rounded
    up to 8, and on the diagonal the upper 32 rows from column 32 on."""
    c = torch.arange(WORD)
    end = min(WORD, -(-(n - ct * WORD) // 8) * 8)
    begin = torch.where((rt == ct) & (c >= 32), 32, 0)       # by row
    return (c[None, :] >= begin[:, None]) & (c[None, :] < end)


def _mask_ious(n):
    """The IoUs nms.cu's mask stage computes for one problem of n boxes:
    each valid row of every tile pair (rt <= ct) over its _tile_columns."""
    words = -(-n // WORD)
    return sum(int(_tile_columns(n, rt, ct)[:min(WORD, n - rt * WORD)].sum())
               for rt in range(words) for ct in range(rt, words))


def _two_stage_keep(boxes, thr, smem_max_n=nms_pallas.SMEM_MAX_N):
    """Plain-torch emulation of csrc/nms.cu on [P, n, 4] boxes: the mask
    stage's 64 x 64 tiles (in the smem kernel's order up to smem_max_n
    boxes, else nms_mask_kernel's numbering) into word-major words, each
    row over its _tile_columns, with zero boxes past n and only bits j > i
    on the diagonal; then the sweep, 64-row blocks in order, the chain
    inside a block, the kept rows' later words ORed into `removed`.
    Returns (bool [P, n], the IoUs a problem's mask stage evaluated)."""
    b = torch.as_tensor(boxes, dtype=torch.float32).reshape(-1, *np.shape(
        boxes)[-2:])
    p, n = b.shape[:2]
    words = -(-n // WORD)
    pad = torch.zeros(p, words * WORD, 4)
    pad[:, :n] = b
    x1, y1, x2, y2 = pad.unbind(-1)
    area = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    bit = torch.ones(WORD, dtype=torch.int64) << torch.arange(WORD)
    if n <= smem_max_n:
        tiles = [(rt, ct) for rt in range(words) for ct in range(rt, words)]
    else:
        tiles = [_tile_of(t) for t in range(words * (words + 1) // 2)]
    assert sorted(tiles) == [(rt, ct) for rt in range(words)
                             for ct in range(rt, words)]
    mask = torch.zeros(p, words, n, dtype=torch.int64)       # [w][i]
    n_ious = 0
    for rt, ct in tiles:
        i = torch.arange(rt * WORD, min(n, rt * WORD + WORD))
        j = torch.arange(ct * WORD, ct * WORD + WORD)
        iw = torch.clamp_min(torch.minimum(x2[:, j][:, None], x2[:, i][:, :, None])
                             - torch.maximum(x1[:, j][:, None],
                                             x1[:, i][:, :, None]), 0.0)
        ih = torch.clamp_min(torch.minimum(y2[:, j][:, None], y2[:, i][:, :, None])
                             - torch.maximum(y1[:, j][:, None],
                                             y1[:, i][:, :, None]), 0.0)
        inter = iw * ih
        iou = inter / torch.clamp_min(area[:, j][:, None]
                                      + area[:, i][:, :, None] - inter, 1e-9)
        cols = _tile_columns(n, rt, ct)[:len(i)]
        n_ious += int(cols.sum())
        hit = (iou > thr) & (j[None, :] > i[:, None]) & cols
        mask[:, ct, i] = (hit.long() * bit).sum(-1)    # distinct bits: OR
    removed = torch.zeros(p, words, dtype=torch.int64)
    for blk in range(words):
        rows = min(WORD, n - blk * WORD)
        diag = mask[:, blk, blk * WORD:blk * WORD + rows]
        rem = removed[:, blk].clone()
        for r in range(rows):
            rem = torch.where(((rem >> r) & 1) == 0, rem | diag[:, r], rem)
        removed[:, blk] = rem
        kept = ((rem[:, None] >> torch.arange(rows)) & 1) == 0    # [P, rows]
        for r in range(rows if blk + 1 < words else 0):
            later = mask[:, blk + 1:, blk * WORD + r]
            removed[:, blk + 1:] |= torch.where(kept[:, r:r + 1], later, 0)
    i = torch.arange(n)
    return ((removed[:, i // WORD] >> (i % WORD)) & 1) == 0, n_ious


def _nms_cases():
    """Score-sorted [n, 4] problems and their thresholds: random boxes at
    the word edges, and the shapes greedy NMS gets wrong first."""
    cases = {f"random{n}": (_boxes(n, seed=n), 0.5)
             for n in (1, 63, 64, 65, 127, 128, 129, 400, 401)}
    k = np.arange(130, dtype=np.float32)[:, None]       # IoU 5/11, then 2/14
    cases["chain"] = (np.concatenate([3 * k, 0 * k, 3 * k + 8, 0 * k + 1], 1),
                      0.4)
    cases["identical"] = (np.tile(np.float32([[2, 3, 9, 7]]), (100, 1)), 0.5)
    odd = _boxes(70, seed=70)
    odd[0::3, 2] = odd[0::3, 0]                          # zero width
    odd[1::5, 2:] = odd[1::5, :2] - 1.0                  # inverted
    cases["degenerate"] = (odd, 0.3)
    pairs = np.float32([[[10 * q, 0, 10 * q + 2, 1], [10 * q, 0, 10 * q + 1, 1]]
                        for q in range(33)]).reshape(66, 4)  # IoU exactly 0.5
    cases["at_threshold"] = (pairs, 0.5)
    rng = np.random.RandomState(12)
    bx = _boxes(200, seed=13)
    cat = rng.randint(0, 4, 200).astype(np.float32)
    shifted = bx + cat[:, None] * (bx.max() + np.float32(1.0))  # as nms()
    order = np.argsort(-rng.rand(200), kind="stable")
    cases["category_shifted"] = (shifted[order], 0.3)
    return cases


_CASES = _nms_cases()


@pytest.mark.parametrize("smem_max_n", [nms_pallas.SMEM_MAX_N, 0],
                         ids=["smem_tiling", "global_tiling"])
@pytest.mark.parametrize("case", list(_CASES))
def test_two_stage_emulation_equals_the_plain_sweep(case, smem_max_n):
    """The kernel's algorithm (bitmask words, then the 64-row block sweep)
    bit for bit against the plain version and numpy's greedy loop."""
    bx, thr = _CASES[case]
    got, n_ious = _two_stage_keep(bx[None], thr, smem_max_n)
    got = got[0].numpy()
    assert n_ious == _mask_ious(len(bx))
    np.testing.assert_array_equal(
        got, nms_pallas.nms_keep_mask_ref(torch.from_numpy(bx), thr).numpy())
    np.testing.assert_array_equal(got, _greedy_numpy(bx, thr))
    if case == "random129" and smem_max_n == 0:    # interpret mode: seconds
        pallas = np.asarray(jnms.nms_keep_mask_pallas(jnp.asarray(bx), thr,
                                                      interpret=True))
        np.testing.assert_array_equal(got, pallas)
    if case == "chain":
        np.testing.assert_array_equal(got, np.arange(130) % 2 == 0)
    if case == "identical":
        assert got.sum() == 1 and got[0]


@pytest.mark.parametrize("n,ious", [(400, 86_272), (8192, 33_685_504)])
def test_mask_stage_iou_counts(n, ious):
    """The IoUs nms.cu's mask stage computes a problem at the serving
    shape's n and at one problem of 8192 boxes, against the 79,800 and
    33,550,336 pairs j > i (the diagonal tiles' lower rows and the ragged
    last tile's columns up to a multiple of 8 add the rest)."""
    assert _mask_ious(n) == ious >= n * (n - 1) // 2


@pytest.mark.parametrize("n", [1, 3, 100, 400, 401])
@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_plain_keep_mask_equals_the_pallas_kernel_the_scan_and_numpy(n, thr):
    bx = _boxes(n, seed=n)
    scores = np.linspace(1.0, 0.0, n, endpoint=False).astype(np.float32)
    got = nms_pallas.nms_keep_mask(torch.from_numpy(bx), thr).numpy()
    pallas = np.asarray(jnms.nms_keep_mask_pallas(jnp.asarray(bx), thr,
                                                  interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _greedy_numpy(bx, thr))
    if thr == 0.5 and n in (100, 401):   # the scan recompiles every call
        scan = np.asarray(jops.nms_mask(jnp.asarray(bx), jnp.asarray(scores),
                                        thr, use_pallas=False))
        np.testing.assert_array_equal(got, scan)
    if n >= 100:
        assert 0 < got.sum() < n        # the sweep suppressed something


def test_plain_keep_mask_at_the_kernel_cap():
    """n = 8192 (supported()'s cap): against the interpreted Pallas kernel
    and numpy (the scan's 8192 x 8192 IoU matrix is left out)."""
    bx = _boxes(8192, seed=8, size=400.0)
    got = nms_pallas.nms_keep_mask(torch.from_numpy(bx), 0.5).numpy()
    pallas = np.asarray(jnms.nms_keep_mask_pallas(jnp.asarray(bx), 0.5,
                                                  interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _greedy_numpy(bx, 0.5))


def test_batched_call_equals_single_calls():
    probs = np.stack([_boxes(57, seed=s) for s in range(6)])
    got = nms_pallas.nms_keep_mask(torch.from_numpy(probs), 0.4)
    assert got.shape == (6, 57) and got.dtype == torch.bool
    for p in range(6):
        single = nms_pallas.nms_keep_mask(torch.from_numpy(probs[p]), 0.4)
        assert single.shape == (57,)
        assert torch.equal(got[p], single)


@pytest.mark.parametrize("thr,suppressed", [(0.5, False), (0.49, True)])
def test_iou_exactly_at_the_threshold_is_kept(thr, suppressed):
    """[0, 0, 2, 1] and [0, 0, 1, 1]: inter 1, union 2, IoU exactly 0.5,
    and the comparison is strict."""
    bx = np.array([[0, 0, 2, 1], [0, 0, 1, 1]], np.float32)
    want = np.array([True, not suppressed])
    got = nms_pallas.nms_keep_mask(torch.from_numpy(bx), thr).numpy()
    pallas = np.asarray(jnms.nms_keep_mask_pallas(jnp.asarray(bx), thr,
                                                  interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pallas, want)


def test_zero_area_and_inverted_boxes_never_suppress():
    bx = np.array([[5, 5, 5, 9], [0, 0, 10, 10], [3, 3, 3, 3],
                   [9, 9, 1, 1], [0, 0, 10, 10.5], [2, 2, 8, 8]], np.float32)
    got = nms_pallas.nms_keep_mask(torch.from_numpy(bx), 0.4).numpy()
    pallas = np.asarray(jnms.nms_keep_mask_pallas(jnp.asarray(bx), 0.4,
                                                  interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, [True, True, True, True, False,
                                        True])


def test_tied_scores_rank_the_lower_index_first():
    """Equal scores: jnp.argsort (stable) and jax.lax.top_k put the lower
    index first; so does the port's stable sort (torch.topk would not
    promise it). Two identical boxes with equal scores keep the first."""
    bx = np.array([[0, 0, 4, 4], [0, 0, 4, 4], [10, 10, 14, 14],
                   [10, 10, 14, 14], [0, 0, 4, 4.5]], np.float32)
    scores = np.array([0.7, 0.7, 0.9, 0.9, 0.7], np.float32)
    got = ops.nms_mask(torch.from_numpy(bx), torch.from_numpy(scores), 0.5)
    want = np.asarray(jops.nms_mask(jnp.asarray(bx), jnp.asarray(scores),
                                    0.5, use_pallas=False))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [True, False, True, False, False])


@pytest.mark.parametrize("score_threshold,top_k", [(None, None), (0.4, None),
                                                   (None, 5), (0.2, 7)])
def test_nms_mask_filters_match_jax(score_threshold, top_k):
    bx = _boxes(40, seed=3)
    scores = np.random.RandomState(4).rand(40).astype(np.float32)
    got = ops.nms_mask(torch.from_numpy(bx), torch.from_numpy(scores), 0.3,
                       score_threshold, top_k)
    want = jops.nms_mask(jnp.asarray(bx), jnp.asarray(scores), 0.3,
                         score_threshold, top_k, use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mc_inputs(n_img, n_cls, m, seed, tie=False):
    rng = np.random.RandomState(seed)
    bx = np.stack([_boxes(m, seed=seed * 10 + i) for i in range(n_img)])
    sc = rng.rand(n_img, n_cls, m).astype(np.float32)
    if tie:
        sc[:, :, 1::3] = sc[:, :, 0::3][:, :, :sc[:, :, 1::3].shape[2]]
    return bx, sc


# every multiclass case has 2 images, 3 classes and 24 anchors: the
# reference's eager vmap retraces its per-class scan on each call, and one
# shape keeps that compile to a few sizes
@pytest.mark.parametrize("background_label", [0, -1])
@pytest.mark.parametrize("case", [
    dict(nms_top_k=16, keep_top_k=20),
    dict(nms_top_k=400, keep_top_k=100),                       # padding
    dict(nms_top_k=16, keep_top_k=8, tie=True)],
    ids=["topk_cut", "padded", "tied_scores"])
def test_multiclass_nms_equals_jax(background_label, case):
    case = dict(case)
    bx, sc = _mc_inputs(2, 3, 24, seed=5, tie=case.pop("tie", False))
    kw = dict(score_threshold=0.2, nms_threshold=0.4,
              background_label=background_label, **case)
    got, gvalid = ops.multiclass_nms(torch.from_numpy(bx),
                                     torch.from_numpy(sc), **kw)
    want, wvalid = jops.multiclass_nms(jnp.asarray(bx), jnp.asarray(sc), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid._data))
    assert got.dtype == torch.float32 and gvalid.dtype == torch.int32


def test_multiclass_nms_score_at_the_threshold_is_dropped():
    """A score equal to score_threshold (as fp32) fails the strict
    comparison in both packages, as the reference compares in the scores'
    dtype."""
    bx, sc = _mc_inputs(2, 3, 24, seed=6)
    sc[0, 1, 2] = np.float32(0.3)
    sc[0, 0, 4] = np.nextafter(np.float32(0.3), np.float32(1))
    kw = dict(score_threshold=0.3, nms_threshold=0.9, background_label=-1)
    got, gvalid = ops.multiclass_nms(torch.from_numpy(bx),
                                     torch.from_numpy(sc), **kw)
    want, wvalid = jops.multiclass_nms(jnp.asarray(bx), jnp.asarray(sc), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid._data))
    kept = got.numpy()[0, :, 1]
    assert np.float32(0.3) not in kept
    assert np.nextafter(np.float32(0.3), np.float32(1)) in kept


def test_multiclass_nms_bf16_scores_compare_in_bf16():
    """bf16 scores: the threshold is compared in bf16 in both packages."""
    bx, sc = _mc_inputs(2, 3, 24, seed=7)
    sc[0, 0, :4] = [0.30078125, 0.298828125, 0.3, 0.5]
    kw = dict(score_threshold=0.3, nms_threshold=0.9, background_label=-1)
    got, gvalid = ops.multiclass_nms(torch.from_numpy(bx),
                                     torch.from_numpy(sc).to(torch.bfloat16),
                                     **kw)
    want, wvalid = jops.multiclass_nms(jnp.asarray(bx),
                                       jnp.asarray(sc, jnp.bfloat16), **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want._data, np.float32))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid._data))


def test_multiclass_nms_only_background():
    bx, sc = _mc_inputs(2, 1, 5, seed=8)
    got, valid = ops.multiclass_nms(torch.from_numpy(bx),
                                    torch.from_numpy(sc), keep_top_k=4)
    want, wvalid = jops.multiclass_nms(jnp.asarray(bx), jnp.asarray(sc),
                                       keep_top_k=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid._data))


@pytest.mark.parametrize("with_scores,categories,top_k", [
    (True, False, None), (True, True, None), (True, True, 3),
    (False, False, None)])
def test_nms_matches_jax(with_scores, categories, top_k):
    bx = _boxes(30, seed=9)
    rng = np.random.RandomState(10)
    scores = rng.permutation(30).astype(np.float32) / 30 if with_scores \
        else None
    cats = rng.randint(0, 3, 30).astype(np.int64) if categories else None
    got = ops.nms(torch.from_numpy(bx), 0.3,
                  None if scores is None else torch.from_numpy(scores),
                  None if cats is None else torch.from_numpy(cats),
                  top_k=top_k)
    want = jops.nms(jnp.asarray(bx), 0.3,
                    None if scores is None else jnp.asarray(scores),
                    None if cats is None else jnp.asarray(cats), top_k=top_k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


def test_cpu_tensors_take_the_plain_version():
    nms_pallas.launches.clear()
    bx, sc = _mc_inputs(1, 3, 20, seed=11)
    ops.multiclass_nms(torch.from_numpy(bx), torch.from_numpy(sc))
    assert sum(nms_pallas.launches.values()) == 0
    assert sum(nms_pallas.routes.values()) == 0
    assert not nms_pallas.supported(10, "cpu")
    assert nms_pallas.supported(8192, "cuda")
    # the reference's 8192 is its TPU VMEM cap; the global route has none
    assert nms_pallas.supported(8193, "cuda")
    assert nms_pallas.supported(1 << 20, "cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        nms_pallas._launch(torch.from_numpy(bx), 0.5)


def test_bad_box_shapes_raise():
    with pytest.raises(ValueError, match=r"\[n, 4\]"):
        nms_pallas.nms_keep_mask(torch.zeros(3, 5), 0.5)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NMS kernel has no CPU mode)")
    return torch.device("cuda")


def _route_on_card(p, n):
    """The route the wrapper picks for [p, n]: smem up to SMEM_MAX_N boxes
    once the problems fill the SMs, else global."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return "smem" if n <= nms_pallas.SMEM_MAX_N and p >= sms else "global"


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", [
    (640, 400), (3, 100), (2, 401), (1, 8192), (5, 1), (4, 3),
    (640, 63), (640, 64), (640, 65), (640, 129), (3, 129),
    (132, 512), (132, 513), (1, 512), (1, 8193), (2, 12000)])
def test_kernel_matches_plain_on_card(cuda, p, n):
    probs = np.stack([_boxes(n, seed=s, size=40.0 + n / 20)
                      for s in range(p)])
    b = torch.from_numpy(probs).to(cuda)
    count = nms_pallas.launches["nms:float32"]
    nms_pallas.routes.clear()
    got = nms_pallas.nms_keep_mask(b, 0.5)
    torch.cuda.synchronize()
    assert nms_pallas.launches["nms:float32"] == count + 1
    assert dict(nms_pallas.routes) == {
        f"nms:float32:{_route_on_card(p, n)}": 1}
    assert torch.equal(got.cpu(), nms_pallas.nms_keep_mask_ref(b, 0.5).cpu())
    if (p, n) == (640, 400):
        assert _route_on_card(p, n) == "smem"      # the serving shape


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", [(640, 400), (1, 8193)])
def test_kernel_calls_are_bit_equal_on_card(cuda, p, n):
    b = torch.from_numpy(np.stack([_boxes(n, seed=s) for s in range(p)]))
    b = b.to(cuda)
    first = nms_pallas.nms_keep_mask(b, 0.5)
    assert torch.equal(first, nms_pallas.nms_keep_mask(b, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [400, 1000])
def test_kernel_matches_plain_far_from_unit_scale_on_card(cuda, n):
    """Boxes scaled from 1e-22 to 1e17: areas past 2^59 and overlaps below
    2^-60 take __fdiv_rn, the rest the fast quotient; all bit-equal."""
    scales = (1e-22, 1e-12, 1.0, 1e12, 1e17)
    b = torch.from_numpy(np.stack([_boxes(n, seed=s) * np.float32(f)
                                   for s, f in enumerate(scales)])).to(cuda)
    for thr in (0.5, 1e-12, 0.0):
        got = nms_pallas.nms_keep_mask(b, thr)
        assert torch.equal(got.cpu(),
                           nms_pallas.nms_keep_mask_ref(b, thr).cpu())


@pytest.mark.cuda
def test_nms_with_categories_on_card_equals_cpu_at_9000_boxes(cuda):
    """paddle.vision.ops.nms past the reference's 8192-box TPU cap: one
    problem on the global route, equal to the CPU's plain sweep."""
    bx = _boxes(9000, seed=14, size=600.0)
    rng = np.random.RandomState(15)
    scores = rng.rand(9000).astype(np.float32)
    cats = rng.randint(0, 5, 9000).astype(np.int64)
    nms_pallas.routes.clear()
    got = ops.nms(torch.from_numpy(bx).to(cuda), 0.4,
                  torch.from_numpy(scores).to(cuda),
                  torch.from_numpy(cats).to(cuda))
    assert dict(nms_pallas.routes) == {"nms:float32:global": 1}
    want = ops.nms(torch.from_numpy(bx), 0.4, torch.from_numpy(scores),
                   torch.from_numpy(cats))
    assert torch.equal(got.cpu(), want) and 0 < len(want) < 9000


@pytest.mark.cuda
def test_kernel_iou_at_the_threshold_on_card(cuda):
    bx = torch.tensor([[0, 0, 2, 1], [0, 0, 1, 1]], dtype=torch.float32,
                      device=cuda)
    assert nms_pallas.nms_keep_mask(bx, 0.5).tolist() == [True, True]
    assert nms_pallas.nms_keep_mask(bx, 0.49).tolist() == [True, False]


@pytest.mark.cuda
def test_multiclass_nms_one_launch_on_card(cuda):
    bx, sc = _mc_inputs(2, 5, 60, seed=12)
    count = nms_pallas.launches["nms:float32"]
    got, valid = ops.multiclass_nms(torch.from_numpy(bx).to(cuda),
                                    torch.from_numpy(sc).to(cuda),
                                    score_threshold=0.2, nms_threshold=0.4)
    assert nms_pallas.launches["nms:float32"] == count + 1
    want, wvalid = ops.multiclass_nms(torch.from_numpy(bx),
                                      torch.from_numpy(sc),
                                      score_threshold=0.2, nms_threshold=0.4)
    assert torch.equal(got.cpu(), want) and torch.equal(valid.cpu(), wvalid)
