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
    assert not nms_pallas.supported(10, "cpu")
    assert nms_pallas.supported(8192, "cuda")
    assert not nms_pallas.supported(8193, "cuda")
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


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", [(640, 400), (3, 100), (2, 401), (1, 8192),
                                 (5, 1), (4, 3)])
def test_kernel_matches_plain_on_card(cuda, p, n):
    probs = np.stack([_boxes(n, seed=s, size=40.0 + n / 20)
                      for s in range(p)])
    b = torch.from_numpy(probs).to(cuda)
    count = nms_pallas.launches["nms:float32"]
    got = nms_pallas.nms_keep_mask(b, 0.5)
    torch.cuda.synchronize()
    assert nms_pallas.launches["nms:float32"] == count + 1
    assert torch.equal(got.cpu(), nms_pallas.nms_keep_mask_ref(b, 0.5).cpu())


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
