"""Greedy NMS keep mask: the CUDA kernel and its plain PyTorch version.

Ports paddle_tpu/ops/nms_pallas.py. The Pallas ``_nms_kernel`` behind
``nms_keep_mask_pallas`` becomes ``csrc/nms.cu`` (the design notes are
there): one thread block per problem, its boxes and keep flags in shared
memory, the greedy sweep run in order inside the block. It takes P
problems at once, so ``multiclass_nms`` makes one launch for all its
images and classes.

``nms_keep_mask(boxes, thr)``: boxes [P, n, 4] (or one problem [n, 4]),
each problem sorted by descending score, cast to fp32 as the reference
casts them; keep[p, i] is true unless a kept box j < i of the same
problem has IoU(i, j) > thr. A tensor on a CUDA device launches the
kernel or raises; a tensor on the CPU takes the plain version,
``nms_keep_mask_ref``. ``launches`` counts kernel launches by
``"nms:float32"``, where the kernel is launched and nowhere else.
``supported`` is the reference's gate: n <= 8192, on the card.
"""
import collections
import ctypes

import torch

from . import _build

MAX_BOXES = 8192   # the reference's supported() cap; csrc/nms.cu's MAX_N

#: kernel launches by "nms:float32"
launches = collections.Counter()


def supported(n_boxes, device):
    """Whether the kernel takes a problem of n_boxes boxes on `device`."""
    return torch.device(device).type == "cuda" and n_boxes <= MAX_BOXES


def _as_problems(boxes):
    if boxes.ndim not in (2, 3) or boxes.shape[-1] != 4:
        raise ValueError(f"nms boxes must be [n, 4] or [P, n, 4], got "
                         f"{tuple(boxes.shape)}")
    return boxes.float().reshape(-1, boxes.shape[-2], 4)


def nms_keep_mask_ref(boxes, iou_threshold):
    """Plain version of the kernel: the reference's sweep, a loop over i
    vectorised over the problems and over j > i, rounding as the kernel
    and the reference do. Returns bool [P, n] (or [n] for [n, 4])."""
    b = _as_problems(boxes)
    x1, y1, x2, y2 = b.unbind(-1)                        # [P, n] each
    area = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    keep = torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
    for i in range(b.shape[1] - 1):
        s = slice(i, i + 1)
        t = slice(i + 1, None)
        iw = torch.clamp_min(torch.minimum(x2[:, t], x2[:, s])
                             - torch.maximum(x1[:, t], x1[:, s]), 0.0)
        ih = torch.clamp_min(torch.minimum(y2[:, t], y2[:, s])
                             - torch.maximum(y1[:, t], y1[:, s]), 0.0)
        inter = iw * ih
        iou = inter / torch.clamp_min(area[:, t] + area[:, s] - inter, 1e-9)
        keep[:, t] &= ~((iou > iou_threshold) & keep[:, s])
    return keep.reshape(boxes.shape[:-1])


_FN = []


def _kernel():
    if not _FN:
        lib = _build.load("nms")
        fn = lib.nms_keep_mask
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append((lib, fn))
    return _FN[0]


def _launch(b, iou_threshold):
    """Run the kernel on b, a contiguous fp32 [P, n, 4] CUDA array."""
    p, n = b.shape[:2]
    if not b.is_cuda:
        raise ValueError(f"nms kernel: boxes must lie on a CUDA device, got "
                         f"{b.device}")
    if n > MAX_BOXES:
        raise ValueError(f"nms kernel takes at most {MAX_BOXES} boxes a "
                         f"problem, got {n} (gate on supported())")
    if b.data_ptr() % 16:
        raise ValueError("nms kernel: boxes must be 16-byte aligned")
    keep = torch.empty((p, n), dtype=torch.bool, device=b.device)
    lib, fn = _kernel()
    err = fn(b.data_ptr(), keep.data_ptr(), p, n, float(iou_threshold),
             _build.stream(b))
    _build.check(lib, "nms_keep_mask", err)
    launches["nms:float32"] += 1
    return keep


def nms_keep_mask(boxes, iou_threshold):
    """Greedy keep mask of score-sorted boxes [P, n, 4] (or [n, 4]):
    bool [P, n] (or [n])."""
    if not boxes.is_cuda:
        return nms_keep_mask_ref(boxes, iou_threshold)
    b = _as_problems(boxes).contiguous()
    if b.numel() == 0:
        return torch.ones(boxes.shape[:-1], dtype=torch.bool,
                          device=boxes.device)
    return _launch(b, iou_threshold).reshape(boxes.shape[:-1])
