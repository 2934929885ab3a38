#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GPT-2 serving and training paths, its
PP-YOLOE detection serving path, the TPP row primitives and the
continuous-batching ServingEngine (dense and paged) on one GPU.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from paddle_tpu_torch/ops/csrc/, holds
each kernel (flash-attention forward, its dQ and dK/dV backward kernels,
the TPP matmul, the greedy-NMS kernel, the TPP bias_act, softmax_rows and
masked_reduce kernels, the paged-attention kernel) against its plain
PyTorch version, checks a narrow
GPT's eval forward, greedy ``generate`` and three AdamW training steps and
a narrow PP-YOLOE's head outputs and detections against the JAX package's
committed outputs, drives GPT-2 small (vocab 50304, hidden 768, 12
layers, 12 heads, random weights from a seed) through the serving path
(eval forward at 4 x 1024 and greedy ``generate``) and the training path
(SpmdTrainer + AdamW at 16 x 1024, bf16 auto_cast with FLAGS_tpp_kernels
off and on, and fp32), drives PP-YOLOE (80 classes, width 64, depth 2:
bench.py's config) through forward, decode and multiclass-NMS
postprocess at 8 x 640 x 640 in fp32 and under bf16 auto_cast, calls the
TPP row primitives at GPT-2 small's shapes, serves GPT-2 small through
the ServingEngine as bench.py's run_serve and run_serve_mixed do (the
greedy drain on the dense and the paged engine, whose outputs must be
equal; the mixed drain; a paged run on a shared 512-token prefix with
cold pages) and runs the paged-attention kernel on the paged engine's
live pool, profiles each configuration once for the device time by
kernel and the device's idle share, and times every kernel. Each phase prints one JSON line; then a ``kernels``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; it also exits nonzero at once when
torch.cuda.is_available() is false. It imports neither jax nor the JAX
package.
"""
import copy
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                                # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}      # dense, no TF32
# Kernel vs plain version, both fp32 math on the same inputs: fp32 output
# differs only by summation order; a bf16 output may also round to the
# neighbouring bf16 value (2^-7 at |x| in [1, 2)), so 2e-2 allows ~2 ulps.
# lse is fp32 in both dtypes. TPP tolerances scale with max(1, max|plain|).
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
LSE_TOL = 2e-4
TPP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The narrow model against the JAX package's fp32 outputs: summation order.
NARROW_TOL = 1e-4
# GPT-2 small fp32 logits, FLAGS_tpp_kernels on vs off: only the order of
# sums changes.
TPP_ON_OFF_TOL = 1e-3
# GPT-2 small bf16 logits (flag off and on) against the fp32-math forward
# of the same bf16-rounded weights (logits of max |x| 0.91): bf16 rounding
# of activations over 12 layers gave 0.0086 (off) and 0.0083 (on) on an
# H100; this allows about 2.3x that.
BF16_VS_FP32_MATH_TOL = 0.02
# Cached greedy decode vs the argmax of the cache-free forward (fp32): a
# token may differ only where the two top logits are this close.
TIE_GAP = 1e-4
# Flash backward kernels vs the plain backward (and vs autograd through
# the plain forward), both fp32 math on the same inputs, scaled by
# max(1, max|plain|): fp32 differs only by summation order over up to
# 2048 terms; bf16 outputs may also round to the neighbouring bf16 value
# (2^-7 relative), so 2e-2 allows ~2 ulps.
FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# The narrow model's 3 training steps against the JAX package's. fp32:
# summation order only. bf16: both packages round the loss to bf16, whose
# step is 2^-5 at the losses' magnitude (4-8), so a loss may land one step
# away; the kept parameter rows are held by golden.update_rel_err, their
# update against the JAX package's, within golden.TRAIN_BF16_UPDATE_RTOL
# (the reasons are there). Two control runs zero the dQ or the dK/dV
# kernel's output and must land outside that limit.
TRAIN_FP32_TOL = 1e-4
TRAIN_BF16_LOSS_TOL = 2.0 ** -5
# GPT-2 small training (bench.py's headline workload): batch 16, seq 1024,
# AdamW lr 1e-4; 1 warm-up step, then this many timed steps per cell.
TRAIN_BATCH, TRAIN_STEPS = 16, 5
# PP-YOLOE serving as bench.py runs it (bench.py:475-491, :548-580, batch
# 8 at :1200): forward + decode + multiclass-NMS postprocess, 1 warm-up
# call, then this many timed calls.
DET_CONFIG = dict(num_classes=80, width=64, depth=2)
DET_BATCH, DET_SIZE, DET_CALLS = 8, 640, 5
# The TPP row primitives at GPT-2 small's shapes: bias_act on the fc1
# output of a 16 x 1024 training batch, softmax_rows and masked_reduce on
# the attention-score rows of b4 h12 s1024. fp32 math in both dtypes;
# sums in another order, and a bf16 output may land one bf16 step away.
ROWS_BIAS_ACT = (16384, 3072)
ROWS_SCORES = (49152, 1024)
ROW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the NMS kernel against its plain version on random, overlapping
# [problems, boxes]; (640, 400) is the full-width serving call's shape
NMS_RANDOM = ((640, 400), (8, 100), (4, 401), (1, 8192))
# operations per element beyond the add, for bias_act's bound
ACT_OPS = {"none": 0, "relu": 1, "gelu": 6, "gelu_tanh": 9}
# operations of one NMS IoU evaluation (two boxes' overlap, union and
# quotient, the areas computed once per box: 5 each)
IOU_OPS, AREA_OPS = 14, 5
# GPT-2 small through the continuous-batching ServingEngine, as bench.py
# runs it (run_serve :680, run_serve_mixed :730, dispatch :1112-1150): 8
# slots, 24 requests with prompts of 32-127 tokens, 128 new tokens each,
# bf16 params and cache, greedy; the paged engine with 16-column frames.
SERVE_SLOTS, SERVE_NEW, PAGE_BLOCK = 8, 128, 16
SERVE_REQUESTS = 3 * SERVE_SLOTS
SERVE_CHUNK = 128                     # run_serve_mixed's prefill_chunk
# the paged-attention kernel runs on the paged engine's live pool after
# this many decode steps of the drain
PAGED_STEPS = 64
# a 512-token shared prefix, 8 requests with 32-token suffixes and 64 new
# tokens each, prefix frames compressed after this many idle steps
PREFIX_LEN, PREFIX_SUFFIX, PREFIX_NEW, PREFIX_COLD_STEPS = 512, 32, 64, 4
# first-token logits of a suffix prefilled on the pool's shared prefix
# frames against the whole prompt's: bf16 K/V of a 512-token prefill and
# of a 544-token one differ in rounding (other GEMM shapes)
PREFIX_LOGIT_TOL = 0.05
# paged attention kernel vs plain, same inputs: fp32 differs by summation
# order; a bf16 output may round to the neighbouring bf16 value
PAGED_TOL_F32 = 2e-5
PAGED_BF16_REL, PAGED_BF16_ABS = 2.0 ** -7, 1e-6
# the reference's paged_attention audit shape (ops/tpp.py:248): B, H, hd,
# bs, maxb, and its test's pool of B + 3 frames
AUDIT_SHAPES = ((16, 8, 128, 32, 16, 19),)


def torch_dtypes():
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def det_group(name):
    """The detection serving path's kernel groups."""
    n = name.lower()
    if "nms_kernel" in n:
        return "nms_kernel"
    if any(t in n for t in ("conv", "fprop", "implicit", "winograd", "cudnn",
                            "xmma", "gemm", "nchwtonhwc", "nhwctonchw",
                            "cutlass", "nvjet")):
        return "convolution"
    if any(t in n for t in ("sort", "radix", "topk", "gather", "scatter",
                            "index", "cub::")):
        return "sort_topk_gather"
    if any(t in n for t in ("elementwise", "vectorized", "unrolled")):
        return "bn_elementwise"
    return "rest"


def kernel_group(name):
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash_fwd"
    if "flash_dq_kernel" in n:
        return "flash_dq"
    if "flash_dkv_kernel" in n:
        return "flash_dkv"
    if "tpp_matmul_kernel" in n:
        return "tpp_matmul"
    if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "library_gemm"
    return "other"


def device_breakdown(fn, group=kernel_group):
    """Run fn() once under torch.profiler. Returns (its result, {host wall
    ms under the profiler, device kernel ms by group, the device's busy ms
    (the union of kernel intervals), its span (first kernel start to last
    kernel end), the idle shares 1 - busy/span and 1 - busy/wall of this
    one call, the three costliest other kernels}). A profiler that records
    no device event gives kernels 0 and no busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    groups, other = {}, {}
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, name in spans:
        g = group(name)
        groups[g] = groups.get(g, 0.0) + (end - start) / 1e3
        if g == "other":
            other[name[:60]] = other.get(name[:60], 0.0) + (end - start) / 1e3
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if not spans:
        return out, {"profiled_wall_ms": wall_ms, "kernels": 0,
                     "device_busy_ms": None}
    busy += cur_end - cur_start
    span = (max(e for _, e, _ in spans) - spans[0][0]) / 1e3
    return out, {
        "profiled_wall_ms": wall_ms, "kernels": len(spans),
        "kernel_ms": groups, "device_busy_ms": busy / 1e3,
        "device_span_ms": span,
        "idle_share_of_span": 1.0 - busy / 1e3 / span,
        "idle_share_of_profiled_wall": 1.0 - busy / 1e3 / wall_ms,
        "top_other": sorted(other.items(), key=lambda kv: -kv[1])[:3]}


def row_err(got, want, dname):
    """Max-abs error of a row kernel against its plain version, checked
    against ROW_TOL x max(1, max|plain|) over the finite entries (a fully
    masked max row reads -inf in both)."""
    import torch

    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)) and got.dtype == want.dtype,
          f"row kernel {dname}: same dtype and non-finite entries")
    err = (got.float() - want.float())[fin].abs().max().item()
    scale = max(1.0, want.float()[fin].abs().max().item())
    check(err <= ROW_TOL[dname] * scale, f"row kernel {dname}: err {err}")
    return err


def causal_rows(shape, device):
    """A bool [rows, s] mask whose row r keeps columns j <= r % s: the
    causal mask of attention-score rows laid out as [b*h*s, s]."""
    import torch

    rows, s = shape
    r = torch.arange(rows, device=device)[:, None] % s
    return torch.arange(s, device=device)[None, :] <= r


def nms_iou_evaluations(boxes, keep, thr):
    """The IoU evaluations greedy NMS needs on these problems: for each
    kept box i, the later boxes j still kept when i's step comes (j is
    dropped at the step of the first kept box that suppresses it)."""
    import torch

    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    iw = torch.clamp_min(torch.minimum(x2[:, :, None], x2[:, None])
                         - torch.maximum(x1[:, :, None], x1[:, None]), 0.0)
    ih = torch.clamp_min(torch.minimum(y2[:, :, None], y2[:, None])
                         - torch.maximum(y1[:, :, None], y1[:, None]), 0.0)
    inter = iw * ih
    iou = inter / torch.clamp_min(area[:, None] + area[:, :, None] - inter,
                                  1e-9)                    # [P, i, j]
    n = keep.shape[1]
    ar = torch.arange(n, device=boxes.device)
    later = ar[None, :] > ar[:, None]                      # [i, j]: j > i
    supp = keep[:, :, None] & (iou > thr) & later
    first = torch.where(supp, ar[None, :, None], n).amin(dim=1)   # [P, j]
    alive = (first[:, None, :] >= ar[None, :, None]) & later
    return int((alive & keep[:, :, None]).sum())


def serve_detector(dev, gen):
    """The detection phases: the NMS kernel against its plain version on
    random problems, the narrow detector against the JAX fixture, and
    PP-YOLOE serving at full width (fp32 and under bf16 auto_cast, timed
    and profiled), whose NMS launches are counted from zero. Returns
    {"counts": the serving path's launches, "problems": the full-width
    call's NMS problems, "evals": the IoU evaluations they need,
    "mismatches": keep entries where the kernel and the plain version
    differ over every problem compared, "launches_per_call": NMS
    launches per serving call}."""
    import numpy as np
    import torch

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import ppyoloe_params_from_jax
    from paddle_tpu_torch.ops import nms_pallas
    from paddle_tpu_torch.testing import golden
    from paddle_tpu_torch.vision.models import PPYOLOE, ppyoloe_tiny
    from paddle_tpu_torch.vision.ops import _sorted_desc, multiclass_nms

    post = dict(score_threshold=golden.DET_SCORE_THRESHOLD,
                keep_top_k=golden.DET_KEEP_TOP_K)
    thr = golden.DET_NMS_THRESHOLD
    torch.backends.cudnn.allow_tf32 = False

    # the NMS kernel against its plain version: random problems, ragged n
    # up to the cap, and an IoU exactly at the threshold; masks bit-equal
    nms_checked, mismatches = [], 0
    for p_, n_ in NMS_RANDOM:
        size = 40.0 + n_ / 20
        xy = torch.rand(p_, n_, 2, generator=gen, device=dev) * size
        wh = torch.rand(p_, n_, 2, generator=gen, device=dev) * 30.0 + 1.0
        b = torch.cat([xy, xy + wh], dim=-1)
        keep = nms_pallas.nms_keep_mask(b, thr)
        torch.cuda.synchronize()
        ref = nms_pallas.nms_keep_mask_ref(b, thr)
        mismatches += int((keep != ref).sum())
        check(torch.equal(keep, ref), f"nms kernel vs plain [{p_}, {n_}]")
        nms_checked.append({"shape": [p_, n_], "kept": int(keep.sum())})
    pair = torch.tensor([[0, 0, 2, 1], [0, 0, 1, 1]], dtype=torch.float32,
                        device=dev)                       # IoU exactly 0.5
    check(nms_pallas.nms_keep_mask(pair, 0.5).tolist() == [True, True]
          and nms_pallas.nms_keep_mask(pair, 0.49).tolist() == [True, False],
          "nms kernel: an IoU equal to the threshold does not suppress")

    # the narrow detector against the JAX package's committed outputs
    dfix = np.load(golden.DET_FIXTURE)
    det = ppyoloe_tiny(num_classes=golden.DET_CLASSES, device=dev)
    det.load_state_dict(ppyoloe_params_from_jax(golden.detector_state()))
    det.eval()
    n0 = nms_pallas.launches["nms:float32"]
    with torch.no_grad():
        outs = det(torch.as_tensor(golden.detector_images(), device=dev))
        boxes, scores = det.decode(outs)
        out, valid = det.postprocess(outs, **post)
    check(nms_pallas.launches["nms:float32"] - n0 == 1,
          "narrow detector postprocess: one NMS launch")
    head_err = max(float(np.abs(t.cpu().numpy()
                                - dfix[f"{kind}_{i}"]).max())
                   for i, level in enumerate(outs)
                   for kind, t in zip(("cls", "reg"), level))
    check(head_err <= golden.DET_HEAD_TOL,
          f"narrow detector head outputs vs JAX: err {head_err}")
    margins = golden.detection_margins(boxes.cpu(), scores.cpu(), out.cpu())
    golden.check_well_posed(margins)
    same, det_err = golden.same_detections(out.cpu(), dfix["out"],
                                           golden.DET_OUT_TOL)
    check(same and np.array_equal(valid.cpu().numpy(), dfix["valid"]),
          f"narrow detector detections vs JAX: err {det_err}")
    # given the JAX package's decoded boxes and scores, the kernel's
    # multiclass NMS gives the JAX output bit for bit
    jout, jvalid = multiclass_nms(
        torch.as_tensor(dfix["boxes"], device=dev),
        torch.as_tensor(dfix["scores"], device=dev), nms_threshold=thr,
        background_label=-1, **post)
    check(np.array_equal(jout.cpu().numpy(), dfix["out"])
          and np.array_equal(jvalid.cpu().numpy(), dfix["valid"]),
          "multiclass_nms on the JAX decode == the JAX output, exactly")
    emit({"phase": "ppyoloe_narrow_vs_jax_fixture",
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "head_max_abs_err": head_err, "head_tol": golden.DET_HEAD_TOL,
          "detections_max_abs_err": det_err, "out_tol": golden.DET_OUT_TOL,
          "valid": valid.tolist(), "margins": margins,
          "nms_on_jax_decode_exact": True,
          "nms_kernel_vs_plain": nms_checked,
          "nms_iou_at_threshold_kept": True})
    del det, outs, boxes, scores, out, valid, jout, jvalid

    # the full-width serving path: bench.py's model, batch and images
    model = PPYOLOE(**DET_CONFIG, device=dev,
                    generator=torch.Generator().manual_seed(0)).eval()
    images = torch.as_tensor(np.random.RandomState(0).rand(
        DET_BATCH, 3, DET_SIZE, DET_SIZE).astype(np.float32), device=dev)

    def serve():
        with torch.no_grad():
            return model.postprocess(model(images), **post)

    nms_pallas.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    out32, valid32 = serve()                                # warm-up
    times = []
    for _ in range(DET_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, valid = serve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(torch.equal(out, out32) and torch.equal(valid, valid32),
              "detection serving is deterministic from call to call")
    with auto_cast(True, dtype="bfloat16"):                 # as bench.py
        out_amp, valid_amp = serve()
    check(out_amp.dtype == torch.float32 and torch.equal(out_amp, out32)
          and torch.equal(valid_amp, valid32),
          "detections under bf16 auto_cast == the fp32 run's")
    _, trace = device_breakdown(serve, det_group)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = dict(nms_pallas.launches)
    n_calls = DET_CALLS + 3
    check(counts == {"nms:float32": n_calls},
          f"detection serving: one NMS launch per call, got {counts} over "
          f"{n_calls} calls")
    check(tuple(out32.shape) == (DET_BATCH, golden.DET_KEEP_TOP_K, 6)
          and bool(torch.isfinite(out32).all())
          and bool(((valid32 >= 0) & (valid32 <= golden.DET_KEEP_TOP_K))
                   .all())
          and bool(((out32[..., 0] >= -1)
                    & (out32[..., 0] < DET_CONFIG["num_classes"])).all()),
          "detections: finite [8, 100, 6], labels in range, valid counts")
    # the call's NMS problems ([images x classes, nms_top_k]), kernel vs
    # plain, and the IoU evaluations this data needs (for the bound)
    with torch.no_grad():
        boxes, scores = model.decode(model(images))
    k = min(400, scores.shape[-1])
    top_i = _sorted_desc(scores)[1][..., :k]
    problems = torch.gather(
        boxes[:, None].expand(-1, scores.shape[1], -1, -1), 2,
        top_i[..., None].expand(-1, -1, -1, 4)).reshape(-1, k, 4).contiguous()
    keep = nms_pallas.nms_keep_mask(problems, thr)
    torch.cuda.synchronize()
    keep_ref = nms_pallas.nms_keep_mask_ref(problems, thr)
    mismatches += int((keep != keep_ref).sum())
    check(torch.equal(keep, keep_ref),
          f"nms kernel vs plain on the full-width call's "
          f"{list(problems.shape[:2])} problems")
    evals = nms_iou_evaluations(problems, keep_ref, thr)
    ms = statistics.median(times)
    emit({"phase": "ppyoloe_serving", "config": DET_CONFIG,
          "batch": DET_BATCH, "size": DET_SIZE, "dtype": "float32",
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "score_threshold": post["score_threshold"],
          "keep_top_k": post["keep_top_k"], "call_ms": ms,
          "call_ms_all": times, "imgs_per_s": DET_BATCH / (ms / 1e3),
          "bf16_auto_cast_identical": True, "profiled": trace,
          "max_memory_allocated_gb": peak,
          "nms_launches_per_call": counts["nms:float32"] / n_calls,
          "valid": valid32.tolist(),
          "nms_problems": list(problems.shape[:2]),
          "nms_kept": int(keep.sum()), "nms_iou_evaluations": evals,
          "nms_kernel_equals_plain": True})
    del model, images, boxes, scores
    torch.cuda.empty_cache()
    return {"counts": counts, "problems": problems, "evals": evals,
            "mismatches": mismatches,
            "launches_per_call": counts["nms:float32"] / n_calls}


def call_row_primitives(randn):
    """The TPP row primitives' path: each entry point called once at its
    main shape in each dtype, counted from zero, its output held against
    the plain version. Returns {"counts": launches, "errs": max-abs
    errors by kernel}."""
    from paddle_tpu_torch.ops import tpp

    tpp.launches.clear()
    errs = {}
    for dname, dt in torch_dtypes().items():
        x = randn(*ROWS_BIAS_ACT, dtype=dt)
        b = randn(ROWS_BIAS_ACT[1], dtype=dt, std=0.02)
        for act in tpp._ACTS:
            errs[f"bias_act.{act}[{dname}]"] = row_err(
                tpp.bias_act(x, b, act), tpp._bias_act_ref(x, b, act), dname)
        sc = randn(*ROWS_SCORES, dtype=dt, std=3.0)
        errs[f"softmax_rows[{dname}]"] = row_err(
            tpp.softmax_rows(sc), tpp._softmax_rows_ref(sc), dname)
        mask = causal_rows(ROWS_SCORES, sc.device)
        for kind in ("sum", "max"):
            errs[f"masked_reduce.{kind}[{dname}]"] = row_err(
                tpp.masked_reduce(sc, mask, kind),
                tpp._masked_reduce_ref(sc, mask, kind), dname)
        del x, b, sc, mask
    counts = dict(tpp.launches)
    want = {f"tpp_bias_act:{act}:{d}": 1 for act in tpp._ACTS
            for d in torch_dtypes()}
    want.update({f"tpp_softmax_rows:{d}": 1 for d in torch_dtypes()})
    want.update({f"tpp_masked_reduce:{kind}:{d}": 1
                 for kind in ("sum", "max") for d in torch_dtypes()})
    check(counts == want, f"TPP row primitives: one launch per entry point "
          f"call, got {counts}")
    emit({"phase": "kernels_vs_plain", "kernel": "tpp_rowwise",
          "shapes": {"bias_act": ROWS_BIAS_ACT, "softmax_rows": ROWS_SCORES,
                     "masked_reduce": ROWS_SCORES},
          "max_abs_err": errs, "tol_x_max(1,max|plain|)": ROW_TOL,
          "main_path_launches": counts})
    return {"counts": counts, "errs": errs}


def time_new_kernels(det, rows, randn, time_ms, bound, launch_counts):
    """The `kernels` entries of the NMS kernel (on the full-width call's
    problems) and the three row kernels (at their main shapes)."""
    import torch

    from paddle_tpu_torch.ops import nms_pallas, tpp
    from paddle_tpu_torch.testing import golden

    masked_library = {"sum": torch.masked.sum, "max": torch.masked.amax}
    thr = golden.DET_NMS_THRESHOLD
    problems = det["problems"]
    p_, n_ = problems.shape[:2]
    bms, by = bound(IOU_OPS * det["evals"] + AREA_OPS * p_ * n_,
                    p_ * n_ * 16 + p_ * n_, "float32")
    kernels = [{
        "name": "nms[float32]", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/nms.cu",
        "replaces": "paddle_tpu/ops/nms_pallas.py:21",
        **launch_counts("nms:float32"), "max_abs_err": det["mismatches"],
        "max_abs_err_is": "keep entries that differ from the plain "
                          "version's, over every problem compared",
        "ms": time_ms(lambda: nms_pallas.nms_keep_mask(problems, thr)),
        "plain_ms": time_ms(lambda: nms_pallas.nms_keep_mask_ref(
            problems, thr), reps=5, warmup=1),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library_covers": "none: PyTorch has no NMS call",
        "shape": [p_, n_], "iou_evaluations": det["evals"],
        "launches_per_serving_call": det["launches_per_call"]}]

    errs = rows["errs"]
    m_b, n_b = ROWS_BIAS_ACT
    m_s, n_s = ROWS_SCORES
    for dname, dt in torch_dtypes().items():
        item = torch.finfo(dt).bits // 8
        x = randn(m_b, n_b, dtype=dt)
        b = randn(n_b, dtype=dt, std=0.02)
        acts = {}
        for act in tpp._ACTS:
            bms, by = bound(m_b * n_b * (1 + ACT_OPS[act]),
                            (2 * m_b * n_b + n_b) * item, "float32")
            acts[act] = {
                "max_abs_err": errs[f"bias_act.{act}[{dname}]"],
                "ms": time_ms(lambda: tpp.bias_act(x, b, act)),
                "plain_ms": time_ms(lambda: tpp._bias_act_ref(x, b, act)),
                "bound_ms": bms, "bound_by": by,
                "library_ms": time_ms(lambda: x + b) if act == "none"
                else None}
        kernels.append({
            "name": f"tpp_bias_act[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/tpp_rowwise.cu",
            "replaces": "paddle_tpu/ops/tpp.py:580",
            **launch_counts("tpp_bias_act:", dname), **acts["none"],
            "act": "none", "library_covers": "x + b",
            "other_acts": {a: acts[a] for a in tpp._ACTS if a != "none"},
            "shape": [m_b, n_b]})
        del x, b
        sc = randn(m_s, n_s, dtype=dt, std=3.0)
        bms, by = bound(5 * m_s * n_s, 2 * m_s * n_s * item, "float32")
        kernels.append({
            "name": f"tpp_softmax_rows[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/tpp_rowwise.cu",
            "replaces": "paddle_tpu/ops/tpp.py:625",
            **launch_counts(f"tpp_softmax_rows:{dname}"),
            "max_abs_err": errs[f"softmax_rows[{dname}]"],
            "ms": time_ms(lambda: tpp.softmax_rows(sc)),
            "plain_ms": time_ms(lambda: tpp._softmax_rows_ref(sc)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: torch.softmax(sc, -1)),
            "library_covers": "torch.softmax(x, -1)", "shape": [m_s, n_s]})
        mask = causal_rows(ROWS_SCORES, sc.device)
        kinds = {}
        for kind in ("sum", "max"):
            bms, by = bound(m_s * n_s, m_s * n_s * (item + 1) + m_s * item,
                            "float32")
            lib = masked_library[kind]
            kinds[kind] = {
                "max_abs_err": errs[f"masked_reduce.{kind}[{dname}]"],
                "ms": time_ms(lambda: tpp.masked_reduce(sc, mask, kind)),
                "plain_ms": time_ms(lambda: tpp._masked_reduce_ref(
                    sc, mask, kind)),
                "bound_ms": bms, "bound_by": by,
                "library_ms": time_ms(lambda: lib(sc, -1, keepdim=True,
                                                  mask=mask)),
                "library_covers": f"torch.masked.{lib.__name__}(x, -1, "
                                  f"keepdim=True, mask=mask)",
                "library_max_abs_diff": (lib(sc, -1, keepdim=True, mask=mask)
                                         .float() - tpp._masked_reduce_ref(
                                             sc, mask, kind).float())
                .nan_to_num(0.0).abs().max().item()}
        kernels.append({
            "name": f"tpp_masked_reduce[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/tpp_rowwise.cu",
            "replaces": "paddle_tpu/ops/tpp.py:672",
            **launch_counts("tpp_masked_reduce:", dname), **kinds["sum"],
            "kind": "sum",
            "other_kinds": {"max": kinds["max"]},
            "mask": "bool, causal", "shape": [m_s, n_s]})
        del sc, mask
    return kernels


def gpt2_serving_engines(dev):
    """bench.py's serving workloads on GPT-2 small at full width, through
    the port's ServingEngine: the greedy drain on the dense and the paged
    engine (their outputs must be equal), the mixed drain (staggered
    arrivals, a third sampling, chunked prefill), and a paged run on a
    shared prefix with cold pages. After PAGED_STEPS decode steps of the
    paged drain, the paged-attention kernel runs once a layer on the live
    pool (bf16 and fp32 q, and int8 pages from the row codec): that is its
    main path, counted from zero. Returns {"counts", "live" (the inputs of
    those calls), "errs"}."""
    import numpy as np
    import torch

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.distributed import compress
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import tpp
    from paddle_tpu_torch.serving import paging

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0)).eval()
    L, H = cfg.num_layers, cfg.num_heads
    hd = cfg.hidden_size // H
    rng = np.random.RandomState(0)
    lens = [int(rng.randint(32, 128)) for _ in range(SERVE_REQUESTS)]
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]

    def engine(paged, **kw):
        set_flags({"paged_kv": paged})
        return ServingEngine(model, max_batch=SERVE_SLOTS, dtype="bfloat16",
                             **kw)

    def warm(eng):
        # bench.py's warm-up: one 2-token request per prompt bucket
        seen = set()
        for p in prompts:
            if eng._bucket(len(p)) not in seen:
                seen.add(eng._bucket(len(p)))
                eng.submit(p, max_new_tokens=2)
        eng.run_until_complete()

    def drain(eng, at_step=None):
        """The timed greedy drain: host clock around each step (a step
        ends in its tokens' copy to the host). Runs at_step(eng) once
        after PAGED_STEPS decode steps, off the clock."""
        torch.cuda.reset_peak_memory_stats()
        rids = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
        step_ms, trace, n = [], None, 0
        while eng.has_work():
            if n == 32:              # all slots decoding: one profiled step
                _, trace = device_breakdown(eng.step)
                profiled_ms = trace["profiled_wall_ms"]
            else:
                t = time.perf_counter()
                eng.step()
                step_ms.append((time.perf_counter() - t) * 1e3)
            n += 1
            if n == PAGED_STEPS and at_step is not None:
                at_step(eng)
        res = {r: eng.get_request(r) for r in rids}
        check(all(res[r].finish_reason == "length"
                  and len(res[r].output_ids) == SERVE_NEW for r in rids),
              "serving drain: every request ends at max_new_tokens")
        out = [list(res[r].output_ids) for r in rids]
        check(all(0 <= t < cfg.vocab_size for o in out for t in o),
              "serving drain: tokens in the vocabulary")
        total_s = (sum(step_ms) + profiled_ms) / 1e3
        return out, {
            "new_tok_per_s": SERVE_REQUESTS * SERVE_NEW / total_s,
            "new_tok_per_s_is": "all new tokens over the steps' host time "
                                "(the profiled step's included)",
            "steps": n, "timed_s": total_s,
            "step_ms_median": statistics.median(step_ms),
            "step_ms_range": [min(step_ms), max(step_ms)],
            "profiled_step_32": trace,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "stats_steps": eng.stats()["steps"]}

    # ---- the greedy drain: dense, then paged ---------------------------
    eng = engine(False)
    warm(eng)
    dense_out, dense = drain(eng)
    del eng
    torch.cuda.empty_cache()

    live = {}
    gen = torch.Generator(device=dev).manual_seed(4)

    def paged_kernel_path(eng):
        """The kernel on the live pool, one call a layer (bf16 q on the
        bf16 pool; fp32 q on an fp32 copy; fp32 q on int8 pages made by
        the row codec), counted from zero."""
        pool = eng._pool
        active = [s for s in range(SERVE_SLOTS) if eng._slot_req[s]]
        check(len(active) == SERVE_SLOTS,
              f"{SERVE_SLOTS} live sessions after {PAGED_STEPS} steps")
        lengths = torch.tensor(eng._pos, device=dev)     # int32 [B]
        kp16, vp16 = pool.kp.clone(), pool.vp.clone()
        kq, ks = compress.quantize_rows(kp16)
        vq, vs = compress.quantize_rows(vp16)
        live.update(tables=pool.tables_device(), lengths=lengths,
                    pages={"bfloat16": (kp16, vp16),
                           "float32": (kp16.float(), vp16.float()),
                           "int8": (kq, vq, ks, vs)},
                    q={d: torch.randn(SERVE_SLOTS, H, hd, generator=gen,
                                      device=dev).to(dt)
                       for d, dt in torch_dtypes().items()},
                    stats=eng.stats()["paging"], out={})
        for l in range(L):
            for variant, dname in (("dense", "bfloat16"),
                                   ("dense", "float32"), ("int8", "float32")):
                if variant == "dense":
                    kp, vp = live["pages"][dname]
                    scales = (None, None)
                else:
                    kp, vp, ks_, vs_ = live["pages"]["int8"]
                    scales = (ks_[:, l], vs_[:, l])
                live["out"][variant, dname, l] = tpp.paged_attention(
                    live["q"][dname], kp[:, l], vp[:, l], live["tables"],
                    lengths, *scales)
        torch.cuda.synchronize()

    eng = engine(True, page_block=PAGE_BLOCK)
    warm(eng)
    tpp.launches.clear()                 # the paged serving path: from 0
    paged_out, paged = drain(eng, at_step=paged_kernel_path)
    live["counts"] = dict(tpp.launches)
    check(set(live["counts"]) == {
        f"tpp_paged_attention.{v}:{d}" for v, d in (
            ("dense", "bfloat16"), ("dense", "float32"), ("int8", "float32"))},
        f"paged serving path: paged-attention launches only, got "
        f"{live['counts']}")
    paged["pool"] = eng.stats()["paging"]
    check(paged_out == dense_out,
          f"paged engine: all {SERVE_REQUESTS} outputs equal the dense "
          "engine's, token for token")
    del eng
    torch.cuda.empty_cache()
    emit({"phase": "gpt2_small_serve", "config": "bench.py run_serve",
          "slots": SERVE_SLOTS, "requests": SERVE_REQUESTS,
          "prompt_lens": lens, "new_tokens": SERVE_NEW, "dtype": "bfloat16",
          "dense": dense, "paged": paged, "page_block": PAGE_BLOCK,
          "paged_live_pool_after_64_steps": live["stats"],
          "paged_outputs_equal_dense": True})

    # ---- the mixed drain: staggered arrivals, sampling, chunked prefill --
    rng = np.random.RandomState(1)
    mlens = [int(rng.randint(32, 128)) for _ in range(SERVE_REQUESTS)]
    mprompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
                for n in mlens]
    kwargs = [({"temperature": 0.8, "top_k": 50, "seed": i}
               if i % 3 == 0 else {}) for i in range(SERVE_REQUESTS)]
    eng = engine(False, prefill_chunk=SERVE_CHUNK)
    eng.submit(mprompts[0], max_new_tokens=2)
    eng.submit(mprompts[-1], max_new_tokens=2, temperature=0.8, top_k=50,
               seed=0)
    eng.run_until_complete()
    tracked, counts, last_emit, inter_ms, ttft_ms = {}, {}, {}, [], []
    pending = list(zip(mprompts, kwargs))
    step_i = 0
    t0 = time.perf_counter()
    while pending or eng.has_work():
        if step_i % 3 == 0:    # 2 arrivals every 3 steps
            for _ in range(2):
                if pending:
                    p, kw = pending.pop(0)
                    rid = eng.submit(p, max_new_tokens=SERVE_NEW, **kw)
                    tracked[rid] = (eng.get_request(rid),
                                    time.perf_counter())
                    counts[rid] = 0
        eng.step()
        now = time.perf_counter()
        for rid, (req, t_submit) in tracked.items():
            n = len(req.output_ids)
            if n > counts[rid]:
                if counts[rid] == 0:
                    ttft_ms.append((now - t_submit) * 1e3)
                else:
                    inter_ms.append((now - last_emit[rid]) * 1e3)
                last_emit[rid] = now
                counts[rid] = n
        step_i += 1
    mixed_s = time.perf_counter() - t0
    reqs = [tracked[r][0] for r in sorted(tracked)]
    check(all(r.finish_reason == "length"
              and len(r.output_ids) == SERVE_NEW for r in reqs),
          "mixed drain: every request ends at max_new_tokens")
    mixed_stats = eng.stats()
    # greedy rows do not depend on arrival times or sampling neighbours:
    # the same greedy requests submitted at once give the same tokens
    greedy = [i for i in range(SERVE_REQUESTS) if not kwargs[i]]
    grids = [eng.submit(mprompts[i], max_new_tokens=SERVE_NEW)
             for i in greedy]
    eng.run_until_complete()
    check(all(list(eng.get_request(g).output_ids) == reqs[i].output_ids
              for g, i in zip(grids, greedy)),
          "mixed drain: greedy rows equal a greedy-only drain's")
    del eng
    emit({"phase": "gpt2_small_serve_mixed",
          "config": "bench.py run_serve_mixed", "prefill_chunk": SERVE_CHUNK,
          "sampling": "every 3rd request: temperature 0.8, top_k 50",
          "new_tok_per_s": sum(counts.values()) / mixed_s,
          "inter_token_ms_p50": float(np.percentile(inter_ms, 50)),
          "inter_token_ms_p99": float(np.percentile(inter_ms, 99)),
          "ttft_ms_p50": float(np.percentile(ttft_ms, 50)),
          "ttft_ms_p99": float(np.percentile(ttft_ms, 99)),
          "steps": mixed_stats["steps"],
          "greedy_rows_equal_greedy_only_drain": True})

    # ---- paged, a shared prefix with cold pages -------------------------
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, cfg.vocab_size, (PREFIX_LEN,)).astype(np.int32)
    sufs = [rng.randint(0, cfg.vocab_size, (PREFIX_SUFFIX,)).astype(np.int32)
            for _ in range(SERVE_SLOTS)]
    eng = engine(True, page_block=PAGE_BLOCK,
                 page_cold_steps=PREFIX_COLD_STEPS)
    pid = eng.register_prefix(prefix)
    pool = eng._pool
    frames = pool.prefix_frames(pid)
    table = torch.zeros((1, pool.maxb), dtype=torch.int32, device=dev)
    table[0, :len(frames)] = torch.as_tensor(frames)
    kc_p, vc_p = paging.gather_dense(pool.kp, pool.vp, table)
    logit_err = 0.0
    with torch.no_grad():
        for s in sufs:
            kc, vc = kc_p.clone(), vc_p.clone()
            got = eng._logits1(eng._prefill_cols(s, PREFIX_LEN, kc, vc))
            kc, vc = eng._cache_row()
            want = eng._logits1(eng._prefill_cols(
                np.concatenate([prefix, s]), 0, kc, vc))
            logit_err = max(logit_err, (got - want).abs().max().item())
    check(logit_err <= PREFIX_LOGIT_TOL,
          f"first-token logits on the shared prefix frames vs the whole "
          f"prompt: {logit_err}")

    def prefix_round(use_prefix):
        rids = [eng.submit(s, max_new_tokens=PREFIX_NEW, prefix_id=pid)
                if use_prefix else
                eng.submit(np.concatenate([prefix, s]),
                           max_new_tokens=PREFIX_NEW) for s in sufs]
        eng.step()
        live_pg = eng.stats()["paging"]
        eng.run_until_complete()
        check(all(eng.get_request(r).finish_reason == "length"
                  for r in rids), "prefix run: requests end at length")
        return [eng.get_request(r).output_ids for r in rids], live_pg

    hot, hot_pg = prefix_round(True)
    for _ in range(PREFIX_COLD_STEPS + 1):
        eng.step()                   # idle steps: the sweep runs
    cold_pg = eng.stats()["paging"]
    check(cold_pg["cold_pages"] == PREFIX_LEN // PAGE_BLOCK,
          f"every prefix frame compressed after {PREFIX_COLD_STEPS} idle "
          f"sweeps: {cold_pg}")
    cold, _ = prefix_round(True)
    full, full_pg = prefix_round(False)

    def agree(a, b):
        return sum(x == y for u, v in zip(a, b) for x, y in zip(u, v)) \
            / sum(len(u) for u in a)

    emit({"phase": "gpt2_small_serve_prefix", "paged": True,
          "prefix": PREFIX_LEN, "suffix": PREFIX_SUFFIX,
          "requests": SERVE_SLOTS, "new_tokens": PREFIX_NEW,
          "page_cold_steps": PREFIX_COLD_STEPS,
          "first_token_logits_max_abs_err": logit_err,
          "logits_tol": PREFIX_LOGIT_TOL,
          "kv_bytes_per_session": hot_pg["kv_bytes_per_session"],
          "dense_bytes_per_session": hot_pg["dense_bytes_per_session"],
          "full_prompt_kv_bytes_per_session": full_pg["kv_bytes_per_session"],
          "pool_live_on_prefix": hot_pg, "pool_after_idle_sweeps": cold_pg,
          "token_agreement_prefix_vs_full_prompt": agree(hot, full),
          "token_agreement_cold_prefix_vs_full_prompt": agree(cold, full),
          "prefix_cache": eng.stats()["prefix_cache"]})
    set_flags({"paged_kv": False})
    del eng, model, kc_p, vc_p
    torch.cuda.empty_cache()

    # ---- the kernel's main-path calls against the plain version ---------
    errs = {}
    tables, lengths = live["tables"], live["lengths"]
    for (variant, dname, l), got in live["out"].items():
        q = live["q"][dname]
        if variant == "dense":
            kp, vp = live["pages"][dname]
            want = tpp.paged_attention_ref(q, kp[:, l], vp[:, l], tables,
                                           lengths)
        else:
            kq, vq, ks, vs = live["pages"]["int8"]
            want = tpp.paged_attention_ref(q, kq[:, l], vq[:, l], tables,
                                           lengths, ks[:, l], vs[:, l])
        key = f"{variant}[{dname}]"
        errs[key] = max(errs.get(key, 0.0), paged_err(got, want, dname))
    return {"counts": live["counts"], "live": live, "errs": errs,
            "int8_vs_dense": int8_vs_dense(live)}


def paged_err(got, want, dname):
    """Max-abs error of the paged-attention kernel against its plain
    version, checked against PAGED_TOL_F32 (fp32 out) or one bf16 step,
    |got - want| <= 2^-7 |want| + 1e-6 (bf16 out)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          "paged attention: same dtype and shape as plain")
    diff = (got.float() - want.float()).abs()
    if dname == "float32":
        ok = diff.max().item() <= PAGED_TOL_F32
    else:
        ok = bool((diff <= PAGED_BF16_REL * want.float().abs()
                   + PAGED_BF16_ABS).all())
    check(ok, f"paged attention {dname} vs plain: err {diff.max().item()}")
    return diff.max().item()


def int8_vs_dense(live):
    """The int8-page kernel outputs against exact (f64) attention on the
    unquantized fp32 pool, element by element, within a band derived from
    the row codec. The codec puts each element of a K or V row within half
    its row's step, a / 254 (a the row's absmax; checked here). Each score
    s_c then moves by d_c = |q . dK_c| / sqrt(hd), so each weight p_c moves
    by a factor within e^(+-R_c), R_c = d_c + log sum_j p_j e^(d_j), and
    each output element o_i by at most
    sum_c p_c (e^R_c - 1) |V_ci| + sum_c p_c e^R_c |dV_ci|,
    plus PAGED_TOL_F32 for the kernel's fp32 arithmetic. Returns the
    largest error, band and error / band."""
    import torch

    from paddle_tpu_torch.ops import tpp

    tables, lengths = live["tables"], live["lengths"]
    kp, vp = live["pages"]["float32"]
    kq, vq, ks, vs = live["pages"]["int8"]
    q = live["q"]["float32"].double()
    T = tables.shape[1] * kp.shape[3]
    dead = (torch.arange(T, device=q.device)[None, :]
            >= lengths.long()[:, None])[:, None, :]         # [B, 1, T]
    err = band_max = ratio = 0.0
    for (variant, _, l), got in live["out"].items():
        if variant != "int8":
            continue
        k, v, dk, dv = (tpp.gather_pages(x, tables).double()
                        for x in (kp[:, l], vp[:, l], kq[:, l], vq[:, l]))
        for x, d, sc in ((k, dk, ks[:, l]), (v, dv, vs[:, l])):
            step = tpp.gather_pages(sc, tables).double()    # [B, H, T, 1]
            d.mul_(step).sub_(x)                 # the codec's error
            check(bool((d.abs() <= step * (0.5 + 1e-4)).all()),
                  "row codec: every element within a / 254 of its value")
        scale = q.shape[-1] ** -0.5
        s = torch.einsum("bhd,bhTd->bhT", q, k).mul_(scale) \
            .masked_fill_(dead, -math.inf)
        p = torch.softmax(s, dim=-1)
        d = torch.einsum("bhd,bhTd->bhT", q, dk).abs_().mul_(scale) \
            .masked_fill_(dead, 0.0)
        R = d + (p * d.exp()).sum(-1, keepdim=True).log()
        band = (torch.einsum("bhT,bhTd->bhd", p * R.expm1(), v.abs())
                + torch.einsum("bhT,bhTd->bhd", p * R.exp(), dv.abs())
                + PAGED_TOL_F32)
        diff = (got.double() - torch.einsum("bhT,bhTd->bhd", p, v)).abs()
        check(bool((diff <= band).all()),
              f"int8 pages vs dense, layer {l}: err / band "
              f"{(diff / band).max().item()} > 1")
        err = max(err, diff.max().item())
        band_max = max(band_max, band.max().item())
        ratio = max(ratio, (diff / band).max().item())
    return {"max_abs_err": err, "band_max": band_max,
            "max_err_over_band": ratio,
            "band_is": "per element: the codec's a/254 step through each "
                       "score's own |q.dK| and each output's own weights"}


def paged_cases(B, H, hd, bs, maxb, NB, gen, full=False):
    """Random pages (fp32 and their int8 codes), tables of distinct random
    frames per row (frame 0 never used) and lengths: every row at maxb*bs
    (full), else random in [1, maxb*bs] but row 0's, which is 0."""
    import torch

    from paddle_tpu_torch.distributed import compress

    dev = gen.device
    kp = torch.randn(NB, H, bs, hd, generator=gen, device=dev)
    vp = torch.randn(NB, H, bs, hd, generator=gen, device=dev)
    lengths = torch.randint(1, maxb * bs + 1, (B,), generator=gen,
                            device=dev).int()
    if full:
        lengths[:] = maxb * bs
    else:
        lengths[0] = 0
    tables = torch.zeros(B, maxb, dtype=torch.int32, device=dev)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)
        tables[b, :n] = torch.randperm(NB - 1, generator=gen,
                                       device=dev)[:n].int() + 1
    (kq, ks), (vq, vs) = compress.quantize_rows(kp), compress.quantize_rows(vp)
    return {"kp": kp, "vp": vp, "int8": (kq, vq, ks, vs), "tables": tables,
            "lengths": lengths}


def check_paged_sources(gen):
    """The paged-attention kernel against its plain version off the main
    path: a full-length case (8 rows x 1024 columns over a 513-frame pool)
    and the reference's audit shape with a zero-length row, bf16 and fp32
    q, dense and int8 pages. Returns {case: max-abs error} and the
    full-length inputs (for timing)."""
    import torch

    from paddle_tpu_torch.ops import tpp

    errs = {}
    full = paged_cases(SERVE_SLOTS, 12, 64, PAGE_BLOCK, 1024 // PAGE_BLOCK,
                       513, gen, full=True)        # the engine's full length
    audit = paged_cases(*next(iter(AUDIT_SHAPES)), gen)
    for name, c in (("full_length", full), ("audit", audit)):
        for dname, dt in torch_dtypes().items():
            q = torch.randn(c["tables"].shape[0], c["kp"].shape[1],
                            c["kp"].shape[3], generator=gen,
                            device=gen.device).to(dt)
            for variant in ("dense", "int8"):
                if variant == "dense":
                    args = (c["kp"].to(dt), c["vp"].to(dt), c["tables"],
                            c["lengths"])
                else:
                    kq, vq, ks, vs = c["int8"]
                    args = (kq, vq, c["tables"], c["lengths"], ks, vs)
                got = tpp.paged_attention(q, *args)
                torch.cuda.synchronize()
                want = tpp.paged_attention_ref(q, *args)
                errs[f"{name}.{variant}[{dname}]"] = paged_err(got, want,
                                                               dname)
                if name == "audit":
                    check(bool((got[0] == 0).all()),
                          "paged attention: a zero-length row gives zeros")
    emit({"phase": "kernels_vs_plain", "kernel": "paged_attention",
          "full_length": [SERVE_SLOTS, 12, 64, PAGE_BLOCK, 1024 // PAGE_BLOCK,
                          513], "audit_shape_B_H_hd_bs_maxb": AUDIT_SHAPES[0],
          "zero_length_row_zeros": True, "max_abs_err": errs,
          "tol": {"float32": PAGED_TOL_F32,
                  "bfloat16": f"|d| <= {PAGED_BF16_REL} |plain| + "
                              f"{PAGED_BF16_ABS}"}})
    return errs, full


def time_paged_attention(serve, full, full_errs, time_ms, bound,
                         launch_counts):
    """The `kernels` entries of the paged-attention kernel: one layer of
    the live pool (the main path's call), and the full-length case. ms
    times the launch alone, wrapper_ms the entry point with its checks;
    the bound counts what the function needs: the K and V rows (and their
    scales) of the columns below each length, the table entries of the
    frames those columns lie in, q, out and lengths. library_ms: SDPA on
    the pre-gathered dense layout with the length mask (the gather
    excluded)."""
    import torch

    from paddle_tpu_torch.ops import tpp

    def entry(q, kp, vp, tables, lengths, scales, dname):
        B, H, hd = q.shape
        bs, maxb = kp.shape[2], tables.shape[1]
        cols = int(lengths.long().sum())
        nblk = int(((lengths.long() + bs - 1) // bs).sum())
        item = q.element_size()
        nbytes = (2 * H * hd * kp.element_size() * cols
                  + (2 * H * 4 * cols if scales[0] is not None else 0)
                  + 2 * B * H * hd * item + 4 * nblk + 4 * B)
        bms, by = bound(4.0 * H * hd * cols, nbytes, "float32")
        k = tpp.gather_pages(kp, tables, scales[0]).to(q.dtype)
        v = tpp.gather_pages(vp, tables, scales[1]).to(q.dtype)
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        tables, lengths = tables.int().contiguous(), lengths.int()
        return {
            "ms": time_ms(lambda: tpp._paged_kernel_call(
                q, kp, vp, tables, lengths, *scales)),
            "wrapper_ms": time_ms(lambda: tpp.paged_attention(
                q, kp, vp, tables, lengths, *scales)),
            "wrapper_is": "paged_attention(): the launch after its checks, "
                          "whose table-range check waits for the device",
            "plain_ms": time_ms(lambda: tpp.paged_attention_ref(
                q, kp, vp, tables, lengths, *scales)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask)),
            "library_covers": "scaled_dot_product_attention on the "
                              "pre-gathered dense layout with the length "
                              "mask (gather excluded)",
            "bytes": nbytes, "shape_B_H_hd_bs_maxb": [B, H, hd, bs, maxb],
            "lengths": lengths.tolist()}

    live = serve["live"]
    kernels = []
    for variant, dname in (("dense", "bfloat16"), ("dense", "float32"),
                           ("int8", "float32")):
        q = live["q"][dname]
        if variant == "dense":
            kp, vp = live["pages"][dname]
            scales, fscales = (None, None), (None, None)
            fk, fv = full["kp"].to(q.dtype), full["vp"].to(q.dtype)
        else:
            kq, vq, ks, vs = live["pages"]["int8"]
            kp, vp, scales = kq, vq, (ks[:, 0], vs[:, 0])
            fk, fv, fks, fvs = full["int8"]
            fscales = (fks, fvs)
        fq = torch.randn(full["tables"].shape[0], full["kp"].shape[1],
                         full["kp"].shape[3], device=q.device).to(q.dtype)
        kernels.append({
            "name": f"paged_attention.{variant}[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/tpp.py:251",
            **launch_counts(f"tpp_paged_attention.{variant}:{dname}"),
            "max_abs_err": serve["errs"][f"{variant}[{dname}]"],
            **entry(q, kp[:, 0], vp[:, 0], live["tables"], live["lengths"],
                    scales, dname),
            "call": "one layer of the paged engine's live pool after "
                    f"{PAGED_STEPS} decode steps",
            "full_length": {
                **entry(fq, fk, fv, full["tables"], full["lengths"], fscales,
                        dname),
                "max_abs_err": full_errs[f"full_length.{variant}[{dname}]"]}})
    return kernels


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script needs a CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
        GPTPretrainLoss, params_from_jax
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops import _build, tpp
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.testing import golden

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    dev = torch.device("cuda")
    dtypes = torch_dtypes()

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln]
             for name in _build.sources()}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "nvcc_s": seconds, "ptxas": ptxas})

    # ---- 2. every kernel against its plain version ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    flash_err = {}
    n_flash = 0
    shapes = [(s, d) for s in (1024, 2048) for d in (64, 128)] \
        + [(1024, 192), (1024, 256)]
    for s, d in shapes:
        for dname, dt in dtypes.items():
            for causal, window in ((False, None), (True, None),
                                   (True, 100)):
                q, k, v = (randn(8, s, d, dtype=dt) for _ in range(3))
                scale = 1.0 / math.sqrt(d)
                o, lse = fa._flash_fwd(q, k, v, causal, scale, window)
                torch.cuda.synchronize()
                ro, rlse = fa.flash_attention_ref(q, k, v, causal, scale,
                                                  window)
                eo = (o.float() - ro.float()).abs().max().item()
                el = (lse - rlse).abs().max().item()
                check(eo <= FLASH_TOL[dname] and el <= LSE_TOL,
                      f"flash s={s} d={d} {dname} causal={causal} "
                      f"window={window}: o err {eo}, lse err {el}")
                n_flash += 1
    # the main paths' calls: strided q/k/v views of one packed qkv tensor,
    # at the serving batch (4) and the training batch
    s, h, d = 1024, 12, 64
    for dname, dt in dtypes.items():
        flash_err[dname] = {}
        for b in (4, TRAIN_BATCH):
            qkv = randn(b, s, 3 * h * d, dtype=dt)
            q, k, v = (t.reshape(b, s, h, d)
                       for t in qkv.split(h * d, dim=-1))
            with torch.no_grad():
                o = fa.flash_attention(q, k, v, causal=True)
                torch.cuda.synchronize()
                ro, _ = fa.flash_attention_ref(
                    *(fa._heads(t) for t in (q, k, v)), True,
                    1.0 / math.sqrt(d))
            ro = fa._unheads(ro, b, h)
            err = (o.float() - ro.float()).abs().max().item()
            flash_err[dname][b] = err
            check(err <= FLASH_TOL[dname],
                  f"flash main shape b={b} {dname}: err {err}")
            del qkv, q, k, v, o, ro
    # SDPA sends every shape its gate passes to the kernel: the wide heads
    # launch it, and a head it has no tiling for raises
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    for d in (192, 256):
        q, k, v = (randn(1, 1024, 2, d) for _ in range(3))
        n = sum(fa.launches.values())
        with torch.no_grad():
            o = scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
        check(sum(fa.launches.values()) == n + 1,
              f"SDPA head_dim {d}: one flash launch")
        heads = [t.transpose(1, 2).reshape(2, 1024, d) for t in (q, k, v)]
        ro, _ = fa.flash_attention_ref(*heads, True, 1.0 / math.sqrt(d))
        err = (o - ro.reshape(1, 2, 1024, d).transpose(1, 2)).abs().max()
        check(err.item() <= FLASH_TOL["float32"],
              f"SDPA head_dim {d} vs plain: err {err.item()}")
    q = randn(1, 1024, 2, 320)
    try:
        scaled_dot_product_attention(q, q, q, is_causal=True)
        raised = False
    except ValueError:
        raised = True
    check(raised, "SDPA head_dim 320 on the card raises")
    emit({"phase": "kernels_vs_plain", "kernel": "flash_fwd",
          "configs": n_flash + 4, "shapes_s_d": shapes,
          "main_shape_s_h_d": [1024, 12, 64],
          "main_shape_max_abs_err_by_batch": flash_err,
          "sdpa_head_dim_192_256_launched": True,
          "sdpa_head_dim_320_raises": True,
          "tol": {"o": FLASH_TOL, "lse": LSE_TOL}})

    def tpp_err(got, want, dname, what):
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        tol = TPP_TOL[dname] * scale
        check(err <= tol, f"tpp {what} {dname}: err {err} > {tol}")
        return err

    M, H, I = 4096, 768, 3072
    M_TRAIN = TRAIN_BATCH * 1024      # the training step's rows (b x s)
    tpp_errs = {}
    for dname, dt in dtypes.items():
        x = randn(M, H, dtype=dt)
        pre = randn(M, I, dtype=dt)
        fc1 = randn(I, H, dtype=dt, std=0.02)       # nn.Linear [out, in]
        fc2 = randn(H, I, dtype=dt, std=0.02)
        b1 = randn(I, dtype=dt, std=0.02)
        b2 = randn(H, dtype=dt, std=0.02)
        gamma = 1.0 + randn(H, dtype=dt, std=0.1)
        beta = randn(H, dtype=dt, std=0.1)
        errs = {
            "plain": tpp_err(tpp.matmul(x, fc1.t(), b1),
                             tpp._matmul_ref(x, fc1.t(), b1), dname, "plain"),
            "plain_kn": tpp_err(
                tpp.matmul(x, fc1.t().contiguous(), b1),
                tpp._matmul_ref(x, fc1.t(), b1), dname, "plain [k,n]"),
        }
        # the two variants on the main paths, at the serving and the
        # training row counts
        for m_rows in (M, M_TRAIN):
            xm, prem = (x, pre) if m_rows == M else \
                (randn(m_rows, H, dtype=dt), randn(m_rows, I, dtype=dt))
            with torch.no_grad():
                errs[f"ln@{m_rows}"] = tpp_err(
                    tpp.ln_matmul(xm, gamma, beta, fc1.t(), b1),
                    tpp._matmul_ref(xm, fc1.t(), b1, gamma=gamma, beta=beta),
                    dname, f"ln m={m_rows}")
                errs[f"gelu_in@{m_rows}"] = tpp_err(
                    tpp._fused_tail(prem, fc2.t(), b2, False),
                    tpp._matmul_ref(prem, fc2.t(), b2, "gelu"),
                    dname, f"gelu_in m={m_rows}")
            del xm, prem
        # every input activation and epilogue, at a ragged shape
        xs, ws, bs = randn(200, 72, dtype=dt), randn(72, 136, dtype=dt,
                                                     std=0.1), \
            randn(136, dtype=dt, std=0.1)
        for in_act in tpp._ACTS:
            for act in tpp._ACTS:
                got = tpp._launch(xs, ws, bs, in_act, act)
                tpp_err(got, tpp._matmul_ref(xs, ws, bs, in_act, act), dname,
                        f"ragged in_act={in_act} act={act}")
        torch.cuda.synchronize()
        tpp_errs[dname] = errs
    emit({"phase": "kernels_vs_plain", "kernel": "tpp_matmul",
          "shapes": [[M, H, I], [M, I, H], [M_TRAIN, H, I], [M_TRAIN, I, H],
                     [200, 72, 136]],
          "max_abs_err": tpp_errs,
          "tol_x_max(1,max|plain|)": TPP_TOL})

    # the backward kernels against the plain backward, and against autograd
    # through the plain forward, on the same inputs
    def bwd_err(got, want, dname):
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        scale = max(1.0, max(w.float().abs().max().item() for w in want))
        return err, err <= FLASH_BWD_TOL[dname] * scale

    n_bwd = 0
    for s, d in shapes:
        for dname, dt in dtypes.items():
            for causal, window in ((False, None), (True, None),
                                   (True, 100)):
                q, k, v, do = (randn(8, s, d, dtype=dt) for _ in range(4))
                scale = 1.0 / math.sqrt(d)
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                o, lse = fa.flash_attention_ref(*leaves, causal, scale,
                                                window)
                autograd = torch.autograd.grad(o, leaves, do)
                o, lse = o.detach(), lse.detach()
                got = fa._flash_bwd(q, k, v, o, lse, do, causal, scale,
                                    window=window)
                torch.cuda.synchronize()
                plain = fa.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                   causal, scale,
                                                   window=window)
                for what, want in (("plain", plain), ("autograd", autograd)):
                    err, ok = bwd_err(got, want, dname)
                    check(ok, f"flash bwd s={s} d={d} {dname} causal="
                          f"{causal} window={window} vs {what}: err {err}")
                if causal and window is None:
                    # an external delta (ring attention's) is used as given
                    delta = torch.randn(8, s, generator=gen, device=dev)
                    got = fa._flash_bwd(q, k, v, o, lse, do, causal, scale,
                                        delta=delta)
                    want = fa.flash_attention_bwd_ref(
                        q, k, v, o, lse, do, causal, scale, delta=delta)
                    err, ok = bwd_err(got, want, dname)
                    check(ok, f"flash bwd external delta s={s} d={d} "
                          f"{dname}: err {err}")
                n_bwd += 1
    # the training path's call, at its shape: grads of strided q/k/v views
    # of one packed qkv through the autograd Function, against autograd
    # through the plain forward
    bwd_errs = {}
    b, s, h, d = TRAIN_BATCH, 1024, 12, 64
    for dname, dt in dtypes.items():
        qkv = randn(b, s, 3 * h * d, dtype=dt)
        do = randn(b, s, h, d, dtype=dt)
        grads = []
        for use_kernel in (True, False):
            packed = qkv.clone().requires_grad_()
            q, k, v = (t.reshape(b, s, h, d)
                       for t in packed.split(h * d, dim=-1))
            if use_kernel:
                o = fa.flash_attention(q, k, v, causal=True)
            else:
                o3, _ = fa.flash_attention_ref(
                    *(fa._heads(t) for t in (q, k, v)), True,
                    1.0 / math.sqrt(d))
                o = fa._unheads(o3, b, h)
            grads.append(torch.autograd.grad(o, packed, do)[0])
        torch.cuda.synchronize()
        got, want = (g.split(h * d, dim=-1) for g in grads)
        bwd_errs[dname] = {
            "dq": bwd_err(got[:1], want[:1], dname)[0],
            "dkv": bwd_err(got[1:], want[1:], dname)[0]}
        check(bwd_err(got, want, dname)[1],
              f"flash bwd main shape {dname}: err {bwd_errs[dname]}")
        del qkv, do, grads, got, want, packed, q, k, v, o
    emit({"phase": "kernels_vs_plain", "kernel": "flash_dq+flash_dkv",
          "configs": n_bwd + 2, "shapes_s_d": shapes,
          "against": ["flash_attention_bwd_ref", "autograd through "
                      "flash_attention_ref"],
          "external_delta_checked": True,
          "main_shape": [b, s, h, d],
          "main_shape_max_abs_err": bwd_errs,
          "tol_x_max(1,max|plain|)": FLASH_BWD_TOL})

    # ---- 3. narrow model at seq 1024 against the JAX fixture --------------
    fix = np.load(golden.FIXTURE)
    narrow = GPTForCausalLM(GPTConfig(**golden.NARROW), device=dev)
    narrow.load_state_dict(params_from_jax(golden.jax_layout_params()))
    narrow.eval()
    ids = torch.as_tensor(golden.input_ids(), device=dev).long()
    narrow_out = {}
    for on in (False, True):
        set_flags({"tpp_kernels": on})
        f0, t0_ = sum(fa.launches.values()), sum(tpp.launches.values())
        with torch.no_grad():
            rows = narrow(ids)[0, -golden.LOGIT_ROWS:].cpu().numpy()
        check(sum(fa.launches.values()) - f0 == 2,
              "narrow forward: 2 flash launches (one per layer)")
        check(sum(tpp.launches.values()) - t0_ == (4 if on else 0),
              "narrow forward: 4 TPP launches with the flag on, 0 off")
        err = float(np.abs(rows - fix["logits_rows"]).max())
        check(err <= NARROW_TOL,
              f"narrow logits vs JAX (tpp={on}): err {err}")
        narrow_out[f"logits_err_tpp_{'on' if on else 'off'}"] = err
    set_flags({"tpp_kernels": False})
    toks = narrow.generate(ids[:, :golden.PROMPT],
                           max_new_tokens=golden.NEW_TOKENS,
                           temperature=0.0).cpu().numpy()
    check(np.array_equal(toks, fix["greedy"]),
          "narrow greedy generate tokens == the JAX package's")
    emit({"phase": "narrow_vs_jax_fixture", **narrow_out,
          "logits_tol": NARROW_TOL, "greedy_tokens_equal": True,
          "greedy_shape": list(toks.shape)})
    del narrow

    # the narrow model trains like the JAX package: the same numpy
    # weights, fresh AdamW state, golden.TRAIN_STEPS steps, fp32 and bf16
    # auto_cast, FLAGS_tpp_kernels off and on
    tfix = np.load(golden.TRAIN_FIXTURE)
    train_ids = torch.as_tensor(golden.input_ids(), device=dev).long()
    train_labels = torch.as_tensor(golden.train_labels(), device=dev).long()

    def train_narrow(amp, zero=None):
        """golden.TRAIN_STEPS steps of the narrow model; `zero` ("dq" or
        "dkv") zeroes that backward kernel's output (a control run).
        Returns (losses, kept rows, dQ and dK/dV launches)."""
        dname = "bfloat16" if amp else "float32"
        m = GPTForCausalLM(GPTConfig(**golden.NARROW), device=dev)
        m.load_state_dict(params_from_jax(golden.jax_layout_params()))
        tr = SpmdTrainer(m, AdamW(learning_rate=golden.TRAIN_LR,
                                  parameters=m.parameters()),
                         loss_fn=GPTPretrainLoss())
        real_bwd = fa._launch_bwd

        def zeroed(*args, **kwargs):
            dq, dk, dv = real_bwd(*args, **kwargs)
            if zero == "dq":
                return torch.zeros_like(dq), dk, dv
            return dq, torch.zeros_like(dk), torch.zeros_like(dv)

        n0 = (fa.launches[f"flash_dq:{dname}"],
              fa.launches[f"flash_dkv:{dname}"])
        losses = []
        if zero:
            fa._launch_bwd = zeroed
        try:
            for _ in range(golden.TRAIN_STEPS):
                with auto_cast(amp, dtype="bfloat16"):
                    losses.append(float(tr.train_step(train_ids,
                                                      train_labels)))
        finally:
            fa._launch_bwd = real_bwd
        n = (fa.launches[f"flash_dq:{dname}"] - n0[0],
             fa.launches[f"flash_dkv:{dname}"] - n0[1])
        return losses, golden.port_kept_rows(dict(m.named_parameters())), n

    narrow_train = {}
    for tag, amp in (("fp32", False), ("bf16", True)):
        want_rows = {n: tfix[f"rows_{tag}__{n}"] for n in golden.KEPT_PARAMS}
        for on in (False, True):
            set_flags({"tpp_kernels": on})
            losses, rows, n_launch = train_narrow(amp)
            n_bwd = 2 * golden.TRAIN_STEPS        # one per layer and step
            check(n_launch == (n_bwd, n_bwd), f"narrow {tag} training: "
                  f"{n_bwd} dQ and {n_bwd} dK/dV launches, got {n_launch}")
            loss_err = float(np.abs(np.asarray(losses)
                                    - tfix[f"loss_{tag}"]).max())
            row_err = max(float(np.abs(rows[n] - want_rows[n]).max())
                          for n in rows)
            update_err = golden.update_rel_err(rows, want_rows)
            key = f"{tag}_tpp_{'on' if on else 'off'}"
            narrow_train[key] = {"losses": losses, "loss_err": loss_err,
                                 "row_max_abs_err": row_err,
                                 "update_rel_err": update_err}
            if amp:
                ok = loss_err <= TRAIN_BF16_LOSS_TOL \
                    and update_err <= golden.TRAIN_BF16_UPDATE_RTOL
            else:
                ok = loss_err <= TRAIN_FP32_TOL and row_err <= TRAIN_FP32_TOL
            check(ok, f"narrow training {key} vs JAX: {narrow_train[key]}")
    set_flags({"tpp_kernels": False})
    # the controls: a bf16 backward whose dQ or dK/dV is zero must fail
    # the bf16 row check
    controls = {}
    for zero in ("dq", "dkv"):
        _, rows, _ = train_narrow(True, zero)
        controls[f"bf16_{zero}_zeroed_update_rel_err"] = golden.update_rel_err(
            rows, want_rows)
        check(controls[f"bf16_{zero}_zeroed_update_rel_err"]
              > golden.TRAIN_BF16_UPDATE_RTOL,
              f"a zeroed {zero} fails the bf16 row check: {controls}")
    emit({"phase": "narrow_train_vs_jax_fixture", "steps": golden.TRAIN_STEPS,
          "lr": golden.TRAIN_LR, **narrow_train, **controls,
          "jax_losses": {t: tfix[f"loss_{t}"].tolist()
                         for t in ("fp32", "bf16")},
          "tol": {"fp32_loss_and_rows": TRAIN_FP32_TOL,
                  "bf16_loss": TRAIN_BF16_LOSS_TOL,
                  "bf16_update_rel_err": golden.TRAIN_BF16_UPDATE_RTOL}})

    # ---- 4. GPT-2 small, full width: the main path ------------------------
    cfg = GPTConfig.small()
    model = GPTForCausalLM(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0)).eval()
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024),
                        generator=torch.Generator().manual_seed(1)).to(dev)

    # the fp32-math forward of the bf16 model's weights: the reference for
    # its logits (flag off; a reference, so before the counts are zeroed)
    set_flags({"tpp_kernels": False})
    with torch.no_grad():
        bf16_ref = copy.deepcopy(model_bf16).float()(ids).float()
    bf16_ref_max = bf16_ref.abs().max().item()

    fa.launches.clear()
    tpp.launches.clear()
    fwd = {}
    logits_ref = None
    for dname, m in (("float32", model), ("bfloat16", model_bf16)):
        for on in (False, True):
            set_flags({"tpp_kernels": on})

            def forward():
                f0 = fa.launches[f"flash_fwd:{dname}"]
                l0 = tpp.launches[f"tpp_matmul.ln:{dname}"]
                g0 = tpp.launches[f"tpp_matmul.in_act:{dname}"]
                with torch.no_grad():
                    out = m(ids)
                check(fa.launches[f"flash_fwd:{dname}"] - f0 == 12,
                      f"{dname} forward: 12 flash launches")
                n_tpp = 12 if on else 0
                check(tpp.launches[f"tpp_matmul.ln:{dname}"] - l0 == n_tpp
                      and tpp.launches[f"tpp_matmul.in_act:{dname}"] - g0
                      == n_tpp, f"{dname} forward: {2 * n_tpp} TPP launches")
                return out

            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits = forward()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            del logits
            logits, trace = device_breakdown(forward)
            check(tuple(logits.shape) == (4, 1024, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  f"{dname} logits finite, [4, 1024, {cfg.vocab_size}]")
            key = f"{dname}_tpp_{'on' if on else 'off'}"
            fwd[key] = {"ms": statistics.median(times), "ms_all": times,
                        "profiled": trace}
            if dname == "bfloat16":
                diff = (logits.float() - bf16_ref).abs().max().item()
                fwd[key]["max_abs_diff_vs_fp32_math"] = diff
                check(diff <= BF16_VS_FP32_MATH_TOL,
                      f"bf16 logits (tpp {on}) vs fp32 math: {diff}")
            elif on:
                diff = (logits.float() - logits_ref).abs().max().item()
                fwd[key]["max_abs_diff_vs_tpp_off"] = diff
                check(diff <= TPP_ON_OFF_TOL,
                      f"fp32 logits with tpp on vs off: {diff}")
            else:
                logits_ref = logits.float()
            del logits
    set_flags({"tpp_kernels": False})
    del logits_ref, bf16_ref
    emit({"phase": "gpt2_small_forward", "batch": 4, "seq": 1024,
          "forward": fwd, "fp32_tol_tpp_on_vs_off": TPP_ON_OFF_TOL,
          "bf16_fp32_math_ref_max_abs": bf16_ref_max,
          "bf16_tol_vs_fp32_math": BF16_VS_FP32_MATH_TOL})

    prompt = ids[:, :128]
    n_new = 128
    model.generate(prompt, max_new_tokens=4, temperature=0.0,
                   dtype="bfloat16")                          # warm-up
    gen_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks_bf16 = model.generate(prompt, max_new_tokens=n_new,
                                   temperature=0.0, dtype="bfloat16")
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t)
    toks = model.generate(prompt, max_new_tokens=n_new, temperature=0.0)
    with torch.no_grad():
        full = model(toks[:, :-1])[:, 127:].float()           # [4, 128, V]
    want = full.argmax(-1)
    got = toks[:, 128:]
    gap = (full.max(-1).values
           - full.gather(-1, got[..., None]).squeeze(-1))
    mismatch = (got != want)
    check(bool((gap[mismatch] <= TIE_GAP).all()),
          "fp32 greedy generate == argmax of the eval forward")
    check(toks_bf16.shape == (4, 256)
          and bool(((toks_bf16 >= 0) & (toks_bf16 < cfg.vocab_size)).all()),
          "bf16 generate: [4, 256] ids in the vocabulary")
    counts_serve = {**fa.launches, **tpp.launches}
    emit({"phase": "gpt2_small_generate", "batch": 4, "prompt": 128,
          "new_tokens": n_new, "dtype": "bfloat16",
          "seconds_all": gen_s,
          "new_tok_per_s": 4 * n_new / statistics.median(gen_s),
          "fp32_tokens_equal_forward_argmax": int((~mismatch).sum()),
          "fp32_near_tie_mismatches": int(mismatch.sum()),
          "main_path_launches": counts_serve})
    del model, model_bf16
    torch.cuda.empty_cache()

    # ---- 4b. GPT-2 small training, full width: the training main path -----
    # bench.py's headline workload (bench.py:282-354): SpmdTrainer +
    # AdamW(lr 1e-4) + GPTPretrainLoss at 16 x 1024, dropout 0, ids and
    # labels drawn as bench.py draws them, under bf16 auto_cast with
    # FLAGS_tpp_kernels off and on; and once in fp32 (flag off), which runs
    # the fp32 variants of the flash kernels on this path. Dropout 0 as in
    # bench.py (GPTConfig.small()'s 0.1 would route attention to the
    # naive path, in both packages).
    cfg = GPTConfig(hidden_size=768, num_layers=12, num_heads=12,
                    dropout=0.0)
    rng = np.random.RandomState(0)
    t_ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (
        TRAIN_BATCH, 1024)).astype(np.int32)).long().to(dev)
    t_labels = torch.as_tensor(rng.randint(0, cfg.vocab_size, (
        TRAIN_BATCH, 1024)).astype(np.int32)).long().to(dev)
    L, hdim, V, S = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, 1024
    # bench.py:246-253: 6 N (N counts the embedding and the tied head
    # once each) plus the attention matmuls, per token
    flops_per_token = 6 * (V * hdim + L * 12 * hdim * hdim + hdim * V) \
        + L * 12 * S * hdim
    fa.launches.clear()
    tpp.launches.clear()
    train = {}
    for dname, amp, on, n_steps in (("bfloat16", True, False, TRAIN_STEPS),
                                    ("bfloat16", True, True, TRAIN_STEPS),
                                    ("float32", False, False, 2)):
        set_flags({"tpp_kernels": on})
        torch.cuda.reset_peak_memory_stats()
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(0))
        trainer = SpmdTrainer(model, AdamW(learning_rate=1e-4,
                                           parameters=model.parameters()),
                              loss_fn=GPTPretrainLoss())
        losses = []

        def step():
            before = {**fa.launches, **tpp.launches}
            with auto_cast(amp, dtype="bfloat16"):
                loss = trainer.train_step(t_ids, t_labels)
            after = {**fa.launches, **tpp.launches}
            delta = {key: after[key] - before.get(key, 0) for key in after
                     if after[key] != before.get(key, 0)}
            want = {f"flash_{kind}:{dname}": L
                    for kind in ("fwd", "dq", "dkv")}
            if on:
                want.update({"tpp_matmul.ln:float32": L,
                             "tpp_matmul.in_act:float32": L})
            check(delta == want, f"training step {dname} tpp={on}: "
                  f"launches {delta}, expected {want}")
            losses.append(loss.item())
            return loss

        times = []
        for i in range(1 + n_steps):                 # one warm-up step
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t) * 1e3)
        _, trace = device_breakdown(step)
        check(all(math.isfinite(x) for x in losses),
              f"training {dname} tpp={on}: finite losses {losses}")
        check(losses[-1] < losses[0],
              f"training {dname} tpp={on}: loss falls on the memorised "
              f"batch {losses}")
        ms = statistics.median(times)
        tok_s = TRAIN_BATCH * S / (ms / 1e3)
        peak = PEAK_FLOPS[dname]
        key = f"{dname}{'_amp' if amp else ''}_tpp_{'on' if on else 'off'}"
        train[key] = {
            "step_ms": ms, "step_ms_all": times, "tokens_per_s": tok_s,
            "mfu": tok_s * flops_per_token / peak,
            "mfu_peak": f"{peak / 1e12:.0f} TFLOP/s {dname} dense",
            "losses": losses, "profiled": trace,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "trainer_stats": trainer.stats()}
        del model, trainer
        torch.cuda.empty_cache()
    set_flags({"tpp_kernels": False})
    counts_train = {**fa.launches, **tpp.launches}
    emit({"phase": "gpt2_small_train", "batch": TRAIN_BATCH, "seq": S,
          "optimizer": "AdamW lr 1e-4", "flops_per_token": flops_per_token,
          "warmup_steps": 1, "train": train,
          "main_path_launches": counts_train})

    # ---- 4c. PP-YOLOE detection serving; 4d. the TPP row primitives -----
    det_path = serve_detector(dev, gen)
    rows_path = call_row_primitives(randn)
    counts_detect, counts_rows = det_path["counts"], rows_path["counts"]

    # ---- 4e. GPT-2 small through the ServingEngine, dense and paged -------
    serve = gpt2_serving_engines(dev)
    counts_paged = serve["counts"]
    emit({"phase": "kernels_vs_plain", "kernel": "paged_attention",
          "source": "the paged engine's live pool, 12 layers",
          "max_abs_err": serve["errs"], "int8_vs_dense": serve["int8_vs_dense"],
          "main_path_launches": counts_paged})
    paged_errs, paged_full = check_paged_sources(gen)

    # ---- 5. times at the main path's shapes -------------------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2

    def time_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bound(flops, nbytes, dname):
        t_ops = flops / PEAK_FLOPS[dname]
        t_mem = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_mem) * 1e3, \
            "operations" if t_ops >= t_mem else "bytes"

    def launch_counts(key, dname=None):
        """Launches of `key` on each main path (counts zeroed just before
        the path, read just after), and their sum. With `dname`, every key
        that starts with `key` and ends with that dtype."""
        def count(counts):
            if dname is None:
                return counts.get(key, 0)
            return sum(n for k, n in counts.items()
                       if k.startswith(key) and k.endswith(":" + dname))

        by_path = {"gpt_serve": count(counts_serve),
                   "gpt_train": count(counts_train),
                   "detect_serve": count(counts_detect),
                   "tpp_rows": count(counts_rows),
                   "gpt_paged_serving": count(counts_paged)}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    kernels = []
    s, h, d = 1024, 12, 64
    scale = 1.0 / math.sqrt(d)
    pairs = s * (s + 1) // 2                        # causal (q, k) pairs
    for dname, dt in dtypes.items():
        item = torch.finfo(dt).bits // 8
        fwd_rows = {}
        for b in (4, TRAIN_BATCH):       # serving and training shapes
            qkv = randn(b, s, 3 * h * d, dtype=dt)
            q, k, v = (t.reshape(b, s, h, d)
                       for t in qkv.split(h * d, dim=-1))
            heads = [fa._heads(t).contiguous() for t in (q, k, v)]
            bhsd = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
            bms, by = bound(4.0 * b * h * pairs * d,
                            4 * b * h * s * d * item + b * h * s * 4, dname)
            with torch.no_grad():
                fwd_rows[b] = {
                    "ms": time_ms(lambda: fa.flash_attention(q, k, v,
                                                             causal=True)),
                    "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                        *heads, True, scale)),
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": time_ms(
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(*bhsd, is_causal=True)),
                    "shape": [b, s, h, d]}
            del qkv, q, k, v, heads, bhsd
        kernels.append({
            "name": f"flash_fwd[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "paddle_tpu/ops/flash_attention.py:196",
            **launch_counts(f"flash_fwd:{dname}"),
            "max_abs_err": flash_err[dname][4], **fwd_rows[4], "causal": True,
            "train_shape": {**fwd_rows[TRAIN_BATCH],
                            "max_abs_err": flash_err[dname][TRAIN_BATCH]}})

        # the backward pair at the training shape, from the forward
        # kernel's o and lse; delta computed once, as the wrapper does
        b = TRAIN_BATCH
        qkv = randn(b, s, 3 * h * d, dtype=dt)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = randn(b, s, h, d, dtype=dt)
        with torch.no_grad():
            o, lse = fa._launch(q, k, v, True, scale, None)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
                .reshape(b * h, s).contiguous()
            heads = [fa._heads(t).contiguous() for t in (q, k, v, o, do)]
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(
                *heads[:4], lse, heads[4], True, scale))
        del heads
        bq, bk, bv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            bq, bk, bv, is_causal=True)
        bdo = do.transpose(1, 2).contiguous()
        library_ms = time_ms(lambda: torch.autograd.grad(
            out, (bq, bk, bv), bdo, retain_graph=True))
        del out, bq, bk, bv, bdo
        for kind, line, flops_per_pair, n_out, fn in (
                ("dq", 282, 6, 1, lambda: fa._launch_dq(
                    q, k, v, do, lse, delta, True, scale, None)),
                ("dkv", 319, 8, 2, lambda: fa._launch_dkv(
                    q, k, v, do, lse, delta, True, scale, None))):
            bms, by = bound(float(flops_per_pair) * d * b * h * pairs,
                            (4 + n_out) * b * h * s * d * item
                            + 2 * b * h * s * 4, dname)
            kernels.append({
                "name": f"flash_{kind}[{dname}]", "route": "cuda",
                "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
                "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
                **launch_counts(f"flash_{kind}:{dname}"),
                "max_abs_err": bwd_errs[dname][kind], "ms": time_ms(fn),
                "plain_ms": plain_ms,
                "plain_covers": "dq, dk and dv: one plain backward",
                "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
                "library_covers": "dq, dk and dv: one backward of "
                                  "scaled_dot_product_attention",
                "shape": [b, s, h, d], "causal": True})
        del qkv, q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()

    tpp_plain = {}
    for dname, dt in dtypes.items():
        item = torch.finfo(dt).bits // 8
        rows = {"ln": {}, "gelu": {}}
        for m_rows in (M, M_TRAIN):             # serving, training shapes
            x = randn(m_rows, H, dtype=dt)
            pre = randn(m_rows, I, dtype=dt)
            fc1 = randn(I, H, dtype=dt, std=0.02)
            fc2 = randn(H, I, dtype=dt, std=0.02)
            b1 = randn(I, dtype=dt, std=0.02)
            b2 = randn(H, dtype=dt, std=0.02)
            gamma = 1.0 + randn(H, dtype=dt, std=0.1)
            beta = randn(H, dtype=dt, std=0.1)
            flops = 2.0 * m_rows * H * I  # the multiply-adds; LN and gelu
            #                               add under 0.2% at these widths
            with torch.no_grad():
                bms, by = bound(flops, (m_rows * H + H * I + m_rows * I + I
                                        + 2 * H) * item, dname)
                rows["ln"][m_rows] = {
                    "ms": time_ms(lambda: tpp.ln_matmul(x, gamma, beta,
                                                        fc1.t(), b1)),
                    "plain_ms": time_ms(lambda: tpp._matmul_ref(
                        x, fc1.t(), b1, gamma=gamma, beta=beta)),
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "shape": [m_rows, H, I]}
                bms, by = bound(flops, (m_rows * I + I * H + m_rows * H
                                        + H) * item, dname)
                rows["gelu"][m_rows] = {
                    "ms": time_ms(lambda: tpp._fused_tail(pre, fc2.t(), b2,
                                                          False)),
                    "plain_ms": time_ms(lambda: tpp._matmul_ref(
                        pre, fc2.t(), b2, "gelu")),
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "shape": [m_rows, I, H]}
                if m_rows == M:
                    # the plain variant (not on a main path) beside addmm
                    bms, by = bound(flops, (M * H + H * I + M * I + I)
                                    * item, dname)
                    tpp_plain[dname] = {
                        "ms": time_ms(lambda: tpp.matmul(x, fc1.t(), b1)),
                        "plain_ms": time_ms(lambda: tpp._matmul_ref(
                            x, fc1.t(), b1)),
                        "library_ms": time_ms(lambda: torch.addmm(
                            b1, x, fc1.t())),
                        "bound_ms": bms, "bound_by": by, "shape": [M, H, I]}
            del x, pre
        for variant, key, err in (("ln_prologue", "ln", "ln"),
                                  ("gelu_in_bias", "in_act", "gelu_in")):
            part = rows["ln" if key == "ln" else "gelu"]
            kernels.append({
                "name": f"tpp_matmul.{variant}[{dname}]", "route": "cuda",
                "source": "paddle_tpu_torch/ops/csrc/tpp_matmul.cu",
                "replaces": "paddle_tpu/ops/tpp.py:458",
                **launch_counts(f"tpp_matmul.{key}:{dname}"),
                "max_abs_err": tpp_errs[dname][f"{err}@{M}"], **part[M],
                "train_shape": {**part[M_TRAIN],
                                "max_abs_err":
                                    tpp_errs[dname][f"{err}@{M_TRAIN}"]}})
    kernels += time_new_kernels(det_path, rows_path, randn, time_ms, bound,
                                launch_counts)
    kernels += time_paged_attention(serve, paged_full, paged_errs, time_ms,
                                    bound, launch_counts)
    emit({"phase": "times", "method": "CUDA events, 3 warm-up, median of "
          "20 (the plain NMS: 1 warm-up, median of 5), 64 MB written "
          "between launches to flush L2",
          "tpp_matmul.plain": tpp_plain})
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} ran on a main path")
    for name in ("flash_fwd[bfloat16]", "flash_dq[bfloat16]",
                 "flash_dkv[bfloat16]", "flash_dq[float32]",
                 "flash_dkv[float32]", "tpp_matmul.ln_prologue[float32]",
                 "tpp_matmul.gelu_in_bias[float32]"):
        kern = next(k for k in kernels if k["name"] == name)
        check(kern["launches_by_path"]["gpt_train"] > 0,
              f"{name} ran on the training path")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    emit({"kernels": kernels})
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
