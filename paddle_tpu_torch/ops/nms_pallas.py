"""Greedy NMS keep mask: the CUDA kernel and its plain PyTorch version.

Ports paddle_tpu/ops/nms_pallas.py. The Pallas ``_nms_kernel`` behind
``nms_keep_mask_pallas`` becomes ``csrc/nms.cu`` (the design notes are
there): a bitmask of the pairwise IoUs above the threshold, built in
parallel over 64 x 64 tiles, then a sweep that resolves 64 rows at a time
in registers. It takes P problems at once, so ``multiclass_nms`` makes
one C call for all its images and classes. With up to ``SMEM_MAX_N``
boxes a problem and at least one problem an SM, the mask stays in shared
memory (route ``smem``: one block a problem, one launch); otherwise it
goes to a workspace of [P, ceil(n / 64), n] words that the wrapper
allocates (route ``global``: a mask kernel over every tile, then a sweep
kernel). There is no cap on n but device memory; running out raises
torch's own out-of-memory error.

``nms_keep_mask(boxes, thr)``: boxes [P, n, 4] (or one problem [n, 4]),
each problem sorted by descending score, cast to fp32 as the reference
casts them; keep[p, i] is true unless a kept box j < i of the same
problem has IoU(i, j) > thr. A tensor on a CUDA device launches the
kernel or raises; a tensor on the CPU takes the plain version,
``nms_keep_mask_ref``. ``launches`` counts calls of the C entry by
``"nms:float32"``, where it is called and nowhere else; ``routes``
splits them by the route it took (``"nms:float32:smem"`` /
``"nms:float32:global"``).
"""
import collections
import ctypes
import functools

import torch

from . import _build

SMEM_MAX_N = 512   # csrc/nms.cu's SMEM_MAX_N: the smem route's cap
WORD = 64          # boxes a mask word covers

#: C-entry calls by "nms:float32"
launches = collections.Counter()
#: the same calls by "nms:float32:<route>"
routes = collections.Counter()


def supported(n_boxes, device):
    """Whether the kernel takes a problem of n_boxes boxes on `device`:
    any n on the card. The reference's cap of 8192 boxes is its TPU VMEM
    budget; past it the reference computes the same mask with its scan
    over the IoU matrix, and here the global route has no cap."""
    return torch.device(device).type == "cuda"


def _smem_route(p, n, device):
    """Whether [p, n] takes the smem route: one block a problem with its
    mask in shared memory (n <= SMEM_MAX_N), which pays once the problems
    fill the card's SMs. Fewer problems take the global route, which
    spreads the mask stage over every SM."""
    return n <= SMEM_MAX_N and p >= _sm_count(device)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _bind(lib):
    """lib's C entry nms_keep_mask(boxes, keep, workspace, P, n, thr,
    stream) with its ctypes signature."""
    fn = lib.nms_keep_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    if not _FN:
        lib = _build.load("nms")
        _FN.append((lib, _bind(lib)))
    return _FN[0]


def _launch(b, iou_threshold):
    """Run the kernel on b, a contiguous fp32 [P, n, 4] CUDA array."""
    p, n = b.shape[:2]
    if not b.is_cuda:
        raise ValueError(f"nms kernel: boxes must lie on a CUDA device, got "
                         f"{b.device}")
    if b.data_ptr() % 16:
        raise ValueError("nms kernel: boxes must be 16-byte aligned")
    keep = torch.empty((p, n), dtype=torch.bool, device=b.device)
    # the global route's mask words; torch raises if the card lacks room
    work = None if _smem_route(p, n, b.device) else torch.empty(
        (p, -(-n // WORD), n), dtype=torch.int64, device=b.device)
    lib, fn = _kernel()
    err = fn(b.data_ptr(), keep.data_ptr(),
             None if work is None else work.data_ptr(), p, n,
             float(iou_threshold), _build.stream(b))
    _build.check(lib, "nms_keep_mask", err)
    launches["nms:float32"] += 1
    routes[f"nms:float32:{'smem' if work is None else 'global'}"] += 1
    return keep


def nms_keep_mask(boxes, iou_threshold):
    """Greedy keep mask of score-sorted boxes [P, n, 4] (or [n, 4]):
    bool [P, n] (or [n])."""
    if not boxes.is_cuda:
        return nms_keep_mask_ref(boxes, iou_threshold)
    b = _as_problems(boxes).contiguous()
    if b.data_ptr() % 16:
        # a contiguous view that starts off 16 bytes (the kernel reads a
        # box as one float4): a fresh copy, as the reference copies its
        # boxes into a padded array
        b = b.clone()
    if b.numel() == 0:
        return torch.ones(boxes.shape[:-1], dtype=torch.bool,
                          device=boxes.device)
    return _launch(b, iou_threshold).reshape(boxes.shape[:-1])
