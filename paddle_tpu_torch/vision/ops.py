"""Detection ops: NMS and multiclass NMS.

Ports ``nms_mask`` (:32), ``_nms_mask_filters`` (:69), ``nms`` (:78)
and ``multiclass_nms`` (:102) of paddle_tpu/vision/ops.py, with the
reference's static-shape outputs (``multiclass_nms`` pads to
``keep_top_k`` rows with -1).

The reference's ``multiclass_nms`` vmaps a per-image function over the
batch and loops over classes in Python, one NMS per (image, class). Here
both loops are batch dimensions: the top ``nms_top_k`` boxes of every
(image, class) are gathered into [B*C, k, 4] and one call of
``ops.nms_pallas.nms_keep_mask`` (one C call on the card) sweeps
them all. Ties rank as ``jax.lax.top_k`` ranks them, the lower index
first: a stable descending sort stands in for ``top_k``. The reference's
scan over the IoU matrix (``_iou_matrix`` :21, taken when
``use_pallas`` is false or the kernel fails to build, :52-53) is not
ported: every sweep goes through ``nms_keep_mask``, and on the card the
kernel runs or raises.
"""
import torch

from ..ops import nms_pallas as _kernel


def _sorted_desc(x):
    """(values, indices) of x sorted descending along the last axis, ties
    lower index first (``jax.lax.top_k``'s order; ``jnp.argsort`` of the
    negated scores is stable too)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def nms_mask(boxes, scores, iou_threshold=0.3, score_threshold=None,
             top_k=None):
    """Static-shape NMS of one problem: keep mask [n] in the boxes'
    original order. The sweep is ``nms_keep_mask`` on the score-sorted
    boxes: the kernel on the card, its plain version on the CPU."""
    n = boxes.shape[0]
    order = _sorted_desc(scores)[1]
    keep_sorted = _kernel.nms_keep_mask(boxes[order], iou_threshold)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted
    return _nms_mask_filters(keep, scores, score_threshold, top_k, order, n)


def _nms_mask_filters(keep, scores, score_threshold, top_k, order, n):
    if score_threshold is not None:
        keep = keep & (scores > score_threshold)
    if top_k is not None:
        rank = torch.zeros(n, dtype=torch.int32, device=keep.device)
        rank[order] = torch.arange(n, dtype=torch.int32, device=keep.device)
        keep = keep & (rank < top_k)
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """paddle.vision.ops.nms: the kept indices (int64), by descending
    score. With category_idxs, boxes of different categories never
    suppress each other (each category is shifted clear of the others)."""
    b = torch.as_tensor(boxes)
    s = torch.ones(b.shape[0], dtype=b.dtype, device=b.device) \
        if scores is None else torch.as_tensor(scores, device=b.device)
    if category_idxs is not None:
        c = torch.as_tensor(category_idxs, device=b.device).to(b.dtype)
        mask = nms_mask(b + c[:, None] * (b.max() + 1.0), s, iou_threshold)
    else:
        mask = nms_mask(b, s, iou_threshold)
    idxs = torch.nonzero(mask).reshape(-1)
    idxs = idxs[_sorted_desc(s[idxs])[1]]
    if top_k is not None:
        idxs = idxs[:top_k]
    return idxs.to(torch.int64)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   background_label=0, name=None):
    """bboxes [N, M, 4], scores [N, C, M]. Returns (out [N, keep_top_k, 6]
    rows of (label, score, x1, y1, x2, y2), -1 padded; valid [N] int32,
    the count of rows whose score is > 0)."""
    bboxes, scores = torch.as_tensor(bboxes), torch.as_tensor(scores)
    n_img, n_cls, m = scores.shape
    dev = bboxes.device
    out_dtype = torch.promote_types(bboxes.dtype, scores.dtype)
    classes = [c for c in range(n_cls) if c != background_label]
    if not classes:
        return (torch.full((n_img, keep_top_k, 6), -1.0, dtype=bboxes.dtype,
                           device=dev),
                torch.zeros(n_img, dtype=torch.int32, device=dev))
    cf = len(classes)
    k = min(nms_top_k, m)
    sc = scores if cf == n_cls else scores[:, classes]          # [N, Cf, M]
    top_s, top_i = (t[..., :k] for t in _sorted_desc(sc))       # [N, Cf, k]
    bx = torch.gather(bboxes[:, None].expand(n_img, cf, m, 4), 2,
                      top_i[..., None].expand(n_img, cf, k, 4))
    keep = _kernel.nms_keep_mask(bx.reshape(n_img * cf, k, 4),
                                 nms_threshold).reshape(n_img, cf, k)
    # nms_mask's filter; the top_k slice keeps scores in their dtype
    keep = keep & (top_s > score_threshold)
    label = torch.tensor(classes, dtype=bboxes.dtype, device=dev)
    entry = torch.cat([label[None, :, None, None].expand(n_img, cf, k, 1),
                       top_s[..., None], bx], dim=-1).to(out_dtype)
    entry = torch.where(keep[..., None], entry,
                        torch.full_like(entry, -1.0))
    cat = entry.reshape(n_img, cf * k, 6)           # class-major, as concat
    k2 = min(keep_top_k, cat.shape[1])
    order = _sorted_desc(cat[:, :, 1])[1][:, :k2]
    out = torch.gather(cat, 1, order[..., None].expand(n_img, k2, 6))
    valid = (out[:, :, 1] > 0).sum(dim=1).to(torch.int32)
    if k2 < keep_top_k:
        out = torch.cat([out, torch.full((n_img, keep_top_k - k2, 6), -1.0,
                                         dtype=out.dtype, device=dev)], dim=1)
    return out, valid
