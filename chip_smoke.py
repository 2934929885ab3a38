#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GPT-2 serving, decoding and training
paths (GPT-2 small and medium, recompute, gradient merge, loss scaling),
its PP-YOLOE detection serving and training paths, ResNet-50, LeNet and
BERT-base training, the TPP row primitives and the continuous-batching
ServingEngine (dense and paged) on one GPU.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from paddle_tpu_torch/ops/csrc/
(printing ptxas's registers and spills and the tensor-core instructions
in each library's SASS, and failing if the bf16 TPP, flash forward or
flash backward has none or spills, or the fp32 flash forward or backward
pair has no TF32 ones), holds
each kernel (flash-attention forward, its dQ and dK/dV backward kernels
and their delta pre-pass, the TPP matmul and its LN row-statistics
pre-pass, the greedy-NMS kernel, the TPP bias_act, softmax_rows and
masked_reduce kernels, the paged-attention kernel) against its plain
PyTorch version (the backward also for bit-equal grads over two calls
and, on the GPT paths, every bf16 launch on the tensor cores; SDPA at
head dims 576, 640 and 1024, forward and backward, on the streaming route,
and its forward at b4 h16 d1024 with the query tiles streamed, causal and
full;
the paged kernel also for bit-equal output over two calls, and through
its public entry on the stream route at head dims and frames of 512, on
one layer of a pool with split boundaries inside frames (the contiguous
pages' bits) and on pages off 16 bytes (its one-element-a-load route),
on fp16 q and mixed q / page dtypes, and on a transposed-page view), checks a
narrow GPT's eval forward, greedy ``generate`` and three AdamW training steps and
a narrow PP-YOLOE's head outputs and detections against the JAX package's
committed outputs, drives GPT-2 small (vocab 50304, hidden 768, 12
layers, 12 heads, random weights from a seed) through the serving path
(eval forward at 4 x 1024 and greedy ``generate``; auto_cast enters no
torch.autocast) and the training path
(SpmdTrainer + AdamW at 16 x 1024, bf16 auto_cast with FLAGS_tpp_kernels
off and on, and fp32), drives PP-YOLOE (80 classes, width 64, depth 2:
bench.py's config) through forward, decode and multiclass-NMS
postprocess at 8 x 640 x 640 in fp32 and under bf16 auto_cast (the NMS
kernel's smem route) and ``paddle.vision.ops.nms`` over one image's
anchor boxes (its global route; some boxes suppressed), calls the
TPP row primitives at GPT-2 small's shapes, serves GPT-2 small through
the ServingEngine as bench.py's run_serve and run_serve_mixed do (the
greedy drain on the dense and the paged engine, whose outputs must be
equal; the dense drain on an int8 cache, each token generate's greedy
pick; the mixed drain; a paged run on a shared 512-token prefix with
cold pages) and runs the paged-attention kernel on the paged engine's
live pool, decodes GPT-2 small as bench.py's gpt2s_decode does on a
bf16, an int8 and an fp8 cache (new tok/s, MBU at 3.35 TB/s, cache
bytes; the narrow model's quantized generate against the CPU's), trains
PP-YOLOE as bench.py's ppyolo train half does (the narrow detector's
three Momentum steps against the JAX package's committed run first; then
8 x 640 x 640 under bf16 auto_cast: imgs/s, step ms, peak memory, idle
share), trains ResNet-50 (64 x 224 x 224, Momentum, bf16 auto_cast:
imgs/s), LeNet through ``Model.train_batch`` (batch 64, Adam: steps/s)
and BERT-base (16 x 512, AdamW, bf16 auto_cast: tokens/s, every
attention call on SDPA's naive route) as bench.py does, each after its
narrow model's three steps against the JAX package's committed run,
then the rest of GPT training: the narrow model's pretraining recipe
(warmup plus cosine LR, global-norm clipping, two micro-batches of
gradient merge and recompute; fp32 and bf16, FLAGS_tpp_kernels off and
on) against the JAX package's committed run, with a no-clip control
that must fail it, bench.py's gpt2m (GPT-2 medium, 8 x 1024) and
gpt2s_16k (GPT-2 small, 1 x 16,384) and gpt2m under the recipe (tokens/s,
MFU, peak memory, flash launches a step), and GPT-2 small's fp16 eager
loop under ``amp.GradScaler`` with an overflowing 2^40 control, and the
rest of serving: the narrow model's ragged generate, beam search and
speculative decoding against the port's CPU run, then GPT-2 small's ragged
batch and beam search and speculative decoding with a GPT-2 medium target
(a GPT-2 small draft, and the target as its own fp32 draft, every
proposal accepted), each token the target's greedy pick within the tie
band and each beam score near the fp32 log-prob of its sequence, and the
engine on GPT-2 small: speculative (the medium target), multi-LoRA under
adapter eviction (base requests bit-equal a plain engine's), hot swap to
a seed-1 model (later requests bit-equal a fresh engine's), the
disaggregated pool and the async step (each bit-equal the plain drain),
all with no kernel launch, and the runtime services on GPT-2 small: a
checkpoint resume bit-equal the uninterrupted run, the cost registry's
FLOP count of a step against bench.py's analytic count and its MFU,
failed and torn checkpoints, the Chrome trace, Prometheus text and
goodput buckets, the engine's breakdown, spans and one failed slot, and
the overhead of the monitor, trace and goodput flags on a training step
and on the engine; it profiles each configuration once for the
device time by kernel and the device's idle share, and times every
kernel. Each phase prints one JSON
line; then a ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; it also exits nonzero at once when
torch.cuda.is_available() is false. It imports neither jax nor the JAX
package.
"""
import collections
import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                                # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}      # dense, no TF32
# dense TF32 on the tensor cores: the fp32 backward pair's products run
# there in three passes, so its tensor-core bound is 3 x its FLOPs over this
PEAK_TF32_FLOPS = 494.7e12
# Kernel vs plain version, both fp32 math on the same inputs: fp32 output
# differs only by summation order; a bf16 output may also round to the
# neighbouring bf16 value (2^-7 at |x| in [1, 2)), so 2e-2 allows ~2 ulps.
# lse is fp32 in both dtypes. TPP tolerances scale with max(1, max|plain|).
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
LSE_TOL = 2e-4
# The fp32 forward on the tf32x3 route, o x max(1, max|plain|) and lse:
# three TF32 passes land near 4e-6 and one pass at 1.5e-4 and above
# (tf32_variants.py), so a kernel that drops passes fails this band even
# where it would pass FLASH_TOL.
TF32X3_FWD_TOL = 2e-5
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
# The backward's delta pre-pass (rowsum(dO o) in fp32) against the torch
# expression on the same inputs: fp32 sums of 64 terms in another order.
DELTA_TOL = 1e-5
# The narrow model's 3 training steps against the JAX package's. fp32:
# summation order only. bf16: both packages round the loss to bf16, whose
# step is 2^-5 at the losses' magnitude (4-8), so a loss may land one step
# away; the kept parameter rows are held by golden.update_rel_err, their
# update against the JAX package's, within golden.TRAIN_BF16_UPDATE_RTOL
# (the reasons are there). Control runs zero the dQ or the dK/dV kernel's
# output, in fp32 and in bf16, and must land outside the row limit.
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
# [problems, boxes]; (640, 400) is the full-width serving call's shape.
# The word edges (63 / 64 / 65 / 129 boxes), the smem route's cap (512)
# and one past it, and single problems past the reference's 8192-box TPU
# cap, which take the global route.
NMS_RANDOM = ((640, 400), (8, 100), (4, 401), (640, 63), (640, 64),
              (640, 65), (640, 129), (132, 512), (132, 513), (1, 8192),
              (1, 8193), (2, 12000), (1, 16384))
# the global route timed alone: one problem of this many boxes
NMS_SINGLE = 8192
# PP-YOLOE's anchor boxes: squares of this many strides (its ATSS
# assigner's grid_cell_scale)
ANCHOR_SCALE = 5.0
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
# time_ms's device sleep before each timed call with the host's enqueue
# hidden (device_ms; ~0.5 ms at 1.98 GHz)
SLEEP_CYCLES = 1_000_000
# GPT-2 small forwards timed a cell, after one warm-up (the first forward
# after a flag or dtype change pays one-time host costs)
FORWARD_SAMPLES = 5
# head dims above 512 (no whole-head tiling): SDPA's forward and backward
# take the streaming route at b1 s1024 h2, causal; 640 leaves a narrower
# last column group (192 x 3 + 64 in fp32, 256 x 2 + 128 in bf16)
STREAM_HEAD_DIMS = (576, 640, 1024)
# the wide heads up to 512 that the streaming route took over from scalar
# kernels (the bf16 forward from 320, the bf16 backward and fp32 from 192),
# checked in phase 2 at b8 s1024 (the bf16 forward at 192 and 256 on mma)
WIDE_HEAD_DIMS = (192, 256, 320, 384, 448, 512)
# the wide heads timed in phase 5 at STREAM_TIMED's shapes (b1 h2, b4 h16)
WIDE_TIMED_DIMS = (256, 512)
# (b, h, head_dim) of a forward checked where every kernel streams its own
# side's tiles too (a grid over two blocks an SM at head_dim 1024)
STREAM_CHECKED_STREAMED = (4, 16, 1024)
# the streaming route's timed shapes at head_dim 576 (b, h): a grid below
# the card's 132 SMs, and one that fills it many times over
STREAM_TIMED = ((1, 2), (4, 16))
# the reference's paged_attention audit shape (ops/tpp.py:248): B, H, hd,
# bs, maxb, and its test's pool of B + 3 frames
AUDIT_SHAPES = ((16, 8, 128, 32, 16, 19),)
# paged attention past the split kernel's caps (head dim or frame above
# 256: the stream route): B, H, hd, bs, maxb, NB; no model has such heads
PAGED_STREAM_SHAPES = ((8, 4, 512, 16, 64, 520), (8, 4, 64, 512, 4, 40),
                       (8, 4, 512, 512, 4, 40))
# the stream route on one layer of a [NB, L, H, bs, hd] pool whose split
# boundaries (128 columns) fall inside its 320-column frames: B, H, hd, bs,
# maxb, NB, L; and pages one element off 16 bytes (the one-element-a-load
# path): B, H, hd, bs, maxb, NB
PAGED_POOL_SHAPE = (8, 4, 384, 320, 5, 44, 3)
PAGED_OFF16_SHAPE = (4, 4, 512, 512, 2, 12)
# gpt2s_decode as bench.py runs it on the TPU (run_decode :583-631; the
# int8 and fp8 legs :1097-1110): batch, prompt, new tokens, cache dtypes;
# each leg's full and 1-token runs DECODE_REPS times after a warm-up
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, DECODE_REPS = 8, 128, 256, 3
DECODE_LEGS = (None, "int8", "fp8")
# a quantized cache's greedy tokens on the card against the CPU's greedy
# pick along the same tokens (fp32): a step may pick another token only
# where its logit lies this close below the CPU's largest. The two
# devices' fp32 sums differ in the last bits, and a row whose scaled value
# lies at a rounding edge takes the neighbouring int8 or fp8 code, which
# moves the logits by about that code's step through the layers.
QUANT_TIE_F32 = 1e-3
# the engine's bf16 int8-cache drain against generate's greedy pick along
# the engine's tokens (bf16, int8): two bf16 computations of other GEMM
# shapes (8 rows against 1, a cache of 1024 columns against prompt + new)
# each lie within BF16_VS_FP32_MATH_TOL of fp32 math, so a token may be
# another only within twice that below the largest logit
ENGINE_TIE_BF16 = 2 * BF16_VS_FP32_MATH_TOL
# the rest of generate on GPT-2 small (bf16, seed 0): a ragged batch of
# prompts of 64-128 tokens left-padded to 128; beam search at batch 2;
# speculative decoding with a GPT-2 medium target and a GPT-2 small draft
RAGGED_BATCH, RAGGED_PAD_TO, RAGGED_NEW = 8, 128, 128
BEAM_BATCH, BEAM_K, BEAM_PROMPT, BEAM_NEW = 2, 4, 128, 64
SPEC_PROMPT, SPEC_NEW, SPEC_K = 128, 128, 4
# a bf16 beam's score against the fp32 log-prob of its sequence: a token's
# log-softmax moves at most twice its logits' error (BF16_VS_FP32_MATH_TOL),
# summed over the new tokens
BEAM_SCORE_TOL_BF16 = BEAM_NEW * 2 * BF16_VS_FP32_MATH_TOL
# the narrow model's beam scores on the card against the CPU's: fp32 sums
# of its new tokens' log-probs in another order
NARROW_BEAM_TOL = 1e-3
# the engine: multi-LoRA at rank 16, three adapters on all four sites
# (B drawn from N(0, 0.3)), two adapter slots; hot swap after this many
# steps of the drain
LORA_RANK, LORA_SLOTS, LORA_B_STD = 16, 2, 0.3
SWAP_AT_STEP = LORA_LOAD_AT_STEP = 48
# the speculative engine's drain (a random-weight draft: no proposal is
# accepted, so the phase is host-bound) and its dense target's: new
# tokens a request, cut from SERVE_NEW to hold the smoke's clock
ENGINE_SPEC_NEW = 16
# GPT-2 small and medium (bench.py's gpt2s and gpt2m) for those phases
GPT2_SMALL_CFG = dict(vocab_size=50304, hidden_size=768, num_layers=12,
                      num_heads=12, max_seq_len=1024, dropout=0.0)
GPT2_MEDIUM_CFG = dict(GPT2_SMALL_CFG, hidden_size=1024, num_layers=24,
                       num_heads=16)
# PP-YOLOE training (bench.py run_ppyolo_train :493-545): 1 warm-up step,
# then this many timed steps, then one profiled
DET_TRAIN_STEPS_TIMED = 5
# the training paths of ResNet-50, LeNet and BERT-base at bench.py's
# shapes (run_resnet50 :1055-1057 and :1351, run_lenet :1229-1231,
# run_bert :1060-1063): 1 warm-up step, then this many timed, then one
# profiled (LeNet's steps are ~ms, so more of them)
RESNET_BATCH, RESNET_SIZE = 64, 224
LENET_BATCH = 64
BERT_BATCH, BERT_SEQ = 16, 512
MODEL_STEPS_TIMED = 5
LENET_STEPS_TIMED = 50
# GPT-2 small's fp16 eager loop under the loss scaler (the naive SDPA
# route: fp16 takes no flash kernel in either package)
FP16_BATCH = 8


def torch_dtypes():
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def emit(obj):
    print(json.dumps(obj), flush=True)


_MARKS = []   # (section of main, perf_counter at its start)


def _mark(name):
    _MARKS.append((name, time.perf_counter()))


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def det_group(name):
    """The detection serving path's kernel groups."""
    n = name.lower()
    if re.search(r"nms_\w*kernel", n):
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


def tpp_routes_checked(path):
    """The TPP matmul launches since tpp.routes was cleared, by the kernel
    the C entry chose; checks that every bf16 launch ran on the tensor
    cores (wgmma) and every fp32 one on the CUDA cores (simt)."""
    from paddle_tpu_torch.ops import tpp

    want = {"bfloat16": "wgmma", "float32": "simt"}
    routed = {k: n for k, n in tpp.routes.items()
              if n and k.startswith("tpp_matmul.")}
    launched = sum(n for k, n in tpp.launches.items()
                   if k.startswith("tpp_matmul."))
    wrong = {k: n for k, n in routed.items()
             if k.rsplit(":", 1)[1] != want[k.split(":")[1]]}
    check(not wrong and sum(routed.values()) == launched,
          f"{path}: TPP matmul launches by route {routed} ({launched} "
          f"launches), bf16 all on wgmma and fp32 on simt")
    return routed


def paged_routes():
    """The paged-attention launches by route ("split" or "stream") since
    tpp.routes was cleared."""
    from paddle_tpu_torch.ops import tpp

    return {k: n for k, n in tpp.routes.items()
            if n and k.startswith("tpp_paged_attention.")}


def flash_routes_checked(path, stream=False):
    """The flash launches since flash_attention.routes was cleared, by the
    kernel the C entry chose; checks that every bf16 launch (forward, dQ,
    dK/dV; head_dim 64 on the GPT paths) ran on the tensor cores (mma) and
    every fp32 one (forward, dQ, dK/dV) on the TF32 tensor cores
    (tf32x3), or with `stream` (the wide heads it checks) that every launch
    took the streaming route."""
    from paddle_tpu_torch.ops import flash_attention as fa

    def want(kernel, dname):
        if stream:
            return "stream"
        return "mma" if dname == "bfloat16" else "tf32x3"

    routed = {k: n for k, n in fa.routes.items() if n}
    launched = sum(n for k, n in fa.launches.items()
                   if k.split(":")[0] in ("flash_fwd", "flash_dq",
                                          "flash_dkv"))
    wrong = {k: n for k, n in routed.items()
             if k.split(":")[2] != want(*k.split(":")[:2])}
    check(not wrong and sum(routed.values()) == launched,
          f"{path}: flash launches by route {routed} ({launched} launches), "
          f"bf16 on mma and fp32 on tf32x3"
          + (" (all on stream)" if stream else ""))
    return routed


def flash_route(kernel, dname, d):
    """The route the C entries pick for `kernel` ("fwd", "dq" or "dkv"):
    mma for bf16 up to head_dim 256 forward and at 64 and 128 backward,
    tf32x3 for fp32 at 64 and 128, stream elsewhere."""
    if dname == "bfloat16" and d <= (256 if kernel == "fwd" else 128):
        return "mma"
    if dname == "float32" and d in (64, 128):
        return "tf32x3"
    return "stream"


def kernel_group(name):
    n = name.lower()
    if "flash_fwd_" in n:
        return "flash_fwd"
    # the scalar and the tensor-core (flash_*_mma_kernel) backward kernels,
    # and the backward's delta pre-pass
    if "flash_dq_" in n:
        return "flash_dq"
    if "flash_dkv_" in n:
        return "flash_dkv"
    if "flash_delta_kernel" in n:
        return "flash_delta"
    if "tpp_wgmma_kernel" in n or "tpp_simt_kernel" in n:
        return "tpp_matmul"
    if "tpp_row_stats_kernel" in n:
        return "tpp_row_stats"
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


def nms_route(p, n):
    """The route nms_pallas picks for [p, n] on device 0."""
    import torch

    from paddle_tpu_torch.ops import nms_pallas

    return "smem" if nms_pallas._smem_route(p, n, torch.device("cuda", 0)) \
        else "global"


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
    and profiled), whose NMS launches are counted from zero, and
    paddle.vision.ops.nms over the anchor boxes, scored by one served
    image (one problem on the global route, some boxes suppressed),
    counted from zero too. Returns {"counts": the
    serving path's launches and routes, "counts_anchors": the anchors
    path's, "problems": the full-width call's NMS problems, "evals": the
    IoU evaluations they need, "mismatches": keep entries where the kernel
    and the plain version differ over every problem compared,
    "launches_per_call": NMS launches per serving call}."""
    import numpy as np
    import torch

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import ppyoloe_params_from_jax
    from paddle_tpu_torch.ops import nms_pallas, tpp
    from paddle_tpu_torch.testing import golden
    from paddle_tpu_torch.vision.models import PPYOLOE, ppyoloe_tiny
    from paddle_tpu_torch.vision.ops import _sorted_desc, multiclass_nms, \
        nms

    post = dict(score_threshold=golden.DET_SCORE_THRESHOLD,
                keep_top_k=golden.DET_KEEP_TOP_K)
    thr = golden.DET_NMS_THRESHOLD
    torch.backends.cudnn.allow_tf32 = False

    # the NMS kernel against its plain version: random problems, ragged n
    # across the word edges and both routes, and an IoU exactly at the
    # threshold; masks bit-equal, each on the route its shape picks
    nms_checked, mismatches = [], 0
    for p_, n_ in NMS_RANDOM:
        size = 40.0 + n_ / 20
        xy = torch.rand(p_, n_, 2, generator=gen, device=dev) * size
        wh = torch.rand(p_, n_, 2, generator=gen, device=dev) * 30.0 + 1.0
        b = torch.cat([xy, xy + wh], dim=-1)
        nms_pallas.routes.clear()
        keep = nms_pallas.nms_keep_mask(b, thr)
        torch.cuda.synchronize()
        route = nms_route(p_, n_)
        check(dict(nms_pallas.routes) == {f"nms:float32:{route}": 1},
              f"nms kernel [{p_}, {n_}]: one call on the {route} route, "
              f"got {dict(nms_pallas.routes)}")
        ref = nms_pallas.nms_keep_mask_ref(b, thr)
        mismatches += int((keep != ref).sum())
        check(torch.equal(keep, ref), f"nms kernel vs plain [{p_}, {n_}]")
        nms_checked.append({"shape": [p_, n_], "route": route,
                            "kept": int(keep.sum())})
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
    nms_pallas.routes.clear()
    tpp.routes.clear()
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
    counts = {**nms_pallas.launches, **nms_pallas.routes}
    n_calls = DET_CALLS + 3
    check(counts == {"nms:float32": n_calls, "nms:float32:smem": n_calls},
          f"detection serving: one NMS call per serving call, on the smem "
          f"route, got {counts} over {n_calls} calls")
    counts.update(paged_routes())
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
    # paddle.vision.ops.nms over the image's anchor boxes (PP-YOLOE's
    # anchor grid: a square of ANCHOR_SCALE strides at each cell centre of
    # the three levels, as its ATSS assigner draws them), each scored by
    # image 0's best class and kept apart by category: one problem on the
    # global route, equal to the CPU's plain sweep. Neighbours of a level
    # overlap with IoU 2/3, so boxes of one class suppress each other.
    anchors = []
    for stride in model.strides:
        c = (torch.arange(DET_SIZE // stride, dtype=torch.float32,
                          device=dev) + 0.5) * stride
        cy, cx = torch.meshgrid(c, c, indexing="ij")
        half = ANCHOR_SCALE * stride / 2
        anchors.append(torch.stack([cx - half, cy - half, cx + half,
                                    cy + half], dim=-1).reshape(-1, 4))
    anchors = torch.cat(anchors)
    check(anchors.shape[0] == boxes.shape[1], "one anchor box per anchor")
    score, label = scores[0].max(dim=0)
    nms_pallas.launches.clear()
    nms_pallas.routes.clear()
    tpp.routes.clear()
    kept_idx = nms(anchors, thr, score, label)
    counts_anchors = {**nms_pallas.launches, **nms_pallas.routes}
    check(counts_anchors == {"nms:float32": 1, "nms:float32:global": 1},
          f"paddle.vision.ops.nms over {anchors.shape[0]} anchors: one call "
          f"on the global route, got {counts_anchors}")
    counts_anchors.update(paged_routes())
    check(0 < len(kept_idx) < anchors.shape[0],
          f"paddle.vision.ops.nms over the anchors suppresses some boxes: "
          f"kept {len(kept_idx)} of {anchors.shape[0]}")
    check(torch.equal(kept_idx.cpu(), nms(anchors.cpu(), thr, score.cpu(),
                                          label.cpu())),
          "paddle.vision.ops.nms over the anchors == the CPU's plain sweep")
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
          "nms_kernel_equals_plain": True,
          "anchors_nms": {"boxes": anchors.shape[0], "kept": len(kept_idx),
                          "anchor_scale": ANCHOR_SCALE,
                          "launches": counts_anchors,
                          "equals_cpu": True}})
    del model, images, boxes, scores, anchors
    torch.cuda.empty_cache()
    return {"counts": counts, "counts_anchors": counts_anchors,
            "problems": problems, "evals": evals, "mismatches": mismatches,
            "launches_per_call": counts["nms:float32"] / n_calls}


def call_row_primitives(randn):
    """The TPP row primitives' path: each entry point called once at its
    main shape in each dtype, counted from zero, its output held against
    the plain version; softmax_rows on its register route (the rows are
    16-byte aligned, 1,024 long). Returns {"counts": launches, "routes":
    softmax_rows launches by route, "errs": max-abs errors by kernel}."""
    from paddle_tpu_torch.ops import tpp

    tpp.launches.clear()
    tpp.routes.clear()
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
    routes = {k: n for k, n in tpp.routes.items() if n}
    check(routes == {f"tpp_softmax_rows:{d}:register": 1
                     for d in torch_dtypes()},
          f"softmax_rows at {ROWS_SCORES}: one launch a dtype on the "
          f"register route, got {routes}")
    counts.update(paged_routes())
    emit({"phase": "kernels_vs_plain", "kernel": "tpp_rowwise",
          "shapes": {"bias_act": ROWS_BIAS_ACT, "softmax_rows": ROWS_SCORES,
                     "masked_reduce": ROWS_SCORES},
          "max_abs_err": errs, "tol_x_max(1,max|plain|)": ROW_TOL,
          "main_path_launches": counts, "softmax_routes": routes})
    return {"counts": counts, "routes": routes, "errs": errs}


def time_new_kernels(det, rows, randn, time_ms, bound, launch_counts):
    """The `kernels` entries of the NMS kernel (the smem route on the
    full-width call's problems, the global route on one random problem of
    NMS_SINGLE boxes) and the three row kernels (at their main shapes)."""
    import torch

    from paddle_tpu_torch.ops import nms_pallas, tpp
    from paddle_tpu_torch.testing import golden

    masked_library = {"sum": torch.masked.sum, "max": torch.masked.amax}
    thr = golden.DET_NMS_THRESHOLD
    problems = det["problems"]
    p_, n_ = problems.shape[:2]
    bms, by = bound(IOU_OPS * det["evals"] + AREA_OPS * p_ * n_,
                    p_ * n_ * 16 + p_ * n_, "float32")
    nms_call = lambda: nms_pallas.nms_keep_mask(problems, thr)  # noqa: E731
    kernels = [{
        "name": "nms[float32]", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/nms.cu",
        "replaces": "paddle_tpu/ops/nms_pallas.py:21",
        **launch_counts("nms:float32:smem"), "max_abs_err": det["mismatches"],
        "max_abs_err_is": "keep entries that differ from the plain "
                          "version's, over every problem compared",
        "ms": time_ms(nms_call),
        "device_ms": time_ms(nms_call, hide_enqueue=True),
        "plain_ms": time_ms(lambda: nms_pallas.nms_keep_mask_ref(
            problems, thr), reps=5, warmup=1),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library_covers": "none: PyTorch has no NMS call",
        "shape": [p_, n_], "kernel_route": nms_route(p_, n_),
        "iou_evaluations": det["evals"],
        "launches_per_serving_call": det["launches_per_call"]}]
    # the global route at one large problem (nms_mask, paddle.vision.ops.nms)
    gen = torch.Generator(device=problems.device).manual_seed(NMS_SINGLE)
    xy = torch.rand(1, NMS_SINGLE, 2, generator=gen,
                    device=problems.device) * (40.0 + NMS_SINGLE / 20)
    single = torch.cat([xy, xy + torch.rand(
        1, NMS_SINGLE, 2, generator=gen, device=problems.device) * 30.0
        + 1.0], dim=-1)
    keep = nms_pallas.nms_keep_mask(single, thr)
    keep_ref = nms_pallas.nms_keep_mask_ref(single, thr)
    check(torch.equal(keep, keep_ref),
          f"nms kernel vs plain at [1, {NMS_SINGLE}]")
    evals = nms_iou_evaluations(single, keep_ref, thr)
    bms, by = bound(IOU_OPS * evals + AREA_OPS * NMS_SINGLE,
                    NMS_SINGLE * 17, "float32")
    single_call = lambda: nms_pallas.nms_keep_mask(single, thr)  # noqa: E731
    kernels.append({
        "name": "nms_global[float32]", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/nms.cu",
        "replaces": "paddle_tpu/ops/nms_pallas.py:21",
        **launch_counts("nms:float32:global"),
        "max_abs_err": int((keep != keep_ref).sum()),
        "max_abs_err_is": "keep entries that differ from the plain version's",
        "ms": time_ms(single_call),
        "device_ms": time_ms(single_call, hide_enqueue=True),
        "plain_ms": time_ms(lambda: nms_pallas.nms_keep_mask_ref(
            single, thr), reps=5, warmup=1),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library_covers": "none: PyTorch has no NMS call",
        "shape": [1, NMS_SINGLE], "kernel_route": nms_route(1, NMS_SINGLE),
        "iou_evaluations": evals})
    del single, keep, keep_ref

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
                "device_ms": time_ms(lambda: tpp.bias_act(x, b, act),
                                     hide_enqueue=True),
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
            "device_ms": time_ms(lambda: tpp.softmax_rows(sc),
                                 hide_enqueue=True),
            "plain_ms": time_ms(lambda: tpp._softmax_rows_ref(sc)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: torch.softmax(sc, -1)),
            "library_device_ms": time_ms(lambda: torch.softmax(sc, -1),
                                         hide_enqueue=True),
            "library_covers": "torch.softmax(x, -1)", "shape": [m_s, n_s],
            "kernel_route": "register",
            "routes_on_path": {k: n for k, n in rows["routes"].items()
                               if k.startswith(f"tpp_softmax_rows:{dname}:")}})
        mask = causal_rows(ROWS_SCORES, sc.device)
        kinds = {}
        for kind in ("sum", "max"):
            bms, by = bound(m_s * n_s, m_s * n_s * (item + 1) + m_s * item,
                            "float32")
            lib = masked_library[kind]
            kinds[kind] = {
                "max_abs_err": errs[f"masked_reduce.{kind}[{dname}]"],
                "ms": time_ms(lambda: tpp.masked_reduce(sc, mask, kind)),
                "device_ms": time_ms(lambda: tpp.masked_reduce(
                    sc, mask, kind), hide_enqueue=True),
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
    engine (their outputs must be equal), the dense drain on an int8 cache
    (each token generate's greedy pick on the same prompt and cache dtype,
    along the drain's own tokens, within ENGINE_TIE_BF16), the mixed drain
    (staggered
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
    from paddle_tpu_torch.serving.decode_model import cache_row_bytes

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
    dense["cache_bytes"] = cache_row_bytes((eng._kc, eng._vc))
    del eng
    torch.cuda.empty_cache()

    # ---- the dense drain on an int8 cache ------------------------------
    eng = engine(False, cache_dtype="int8")
    warm(eng)
    int8_out, int8 = drain(eng)
    int8["cache_bytes"] = cache_row_bytes((eng._kc, eng._vc))
    del eng
    torch.cuda.empty_cache()
    gaps = torch.cat([teacher_forced_gaps(model, p, o, dtype="bfloat16",
                                          cache_dtype="int8")
                      for p, o in zip(prompts, int8_out)])
    check(float(gaps.max()) <= ENGINE_TIE_BF16,
          f"int8-cache engine: every token generate's greedy pick on the "
          f"same prompt and cache dtype within {ENGINE_TIE_BF16} (max gap "
          f"{float(gaps.max())})")
    int8["vs_generate"] = {
        "tokens": int(gaps.numel()), "generate_greedy": int(
            (gaps == 0).sum()), "max_gap": float(gaps.max()),
        "tie": ENGINE_TIE_BF16,
        "tokens_equal_bf16_cache_drain": sum(
            a == b for o8, o in zip(int8_out, dense_out)
            for a, b in zip(o8, o))}

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
    tpp.routes.clear()
    paged_out, paged = drain(eng, at_step=paged_kernel_path)
    live["counts"] = dict(tpp.launches)
    live["routes"] = paged_routes()
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
          "dense_int8_cache": int8,
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
    return {"counts": {**live["counts"], **live["routes"]}, "live": live,
            "errs": errs,
            "int8_vs_dense": int8_vs_dense(live)}


def paged_err(got, want, dname):
    """Max-abs error of the paged-attention kernel against its plain
    version, checked against PAGED_TOL_F32 (fp32 out) or one step of the
    output's type, |got - want| <= 2^-7 |want| + 1e-6 (bf16 out; 2^-10
    for fp16)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          "paged attention: same dtype and shape as plain")
    diff = (got.float() - want.float()).abs()
    if dname == "float32":
        ok = diff.max().item() <= PAGED_TOL_F32
    else:
        rel = PAGED_BF16_REL if dname == "bfloat16" else 2.0 ** -10
        ok = bool((diff <= rel * want.float().abs()
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
    q, dense and int8 pages; two calls must give the same bits. Then
    through the public entry what the split kernel cannot read as it is:
    PAGED_STREAM_SHAPES (head dim or frame above 256) on the stream route,
    the same cases with fp16 q too, then PAGED_POOL_SHAPE as one layer of
    a pool (split boundaries inside frames; the contiguous pages' bits)
    and PAGED_OFF16_SHAPE's pages one element off 16 bytes (the
    `stream_direct` route), each launch counted by route; fp16 q (on fp16
    and fp32 pages) and bf16 q on fp32 pages; a transposed-page view,
    which must give the contiguous pages' bits. Returns {case: max-abs
    error}, the full-length inputs and the stream route's timed case, hd
    512 and bs 512 (for timing)."""
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
                again = tpp.paged_attention(q, *args)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"paged attention {name} {variant} {dname}: two calls, "
                      f"the same bits")
                want = tpp.paged_attention_ref(q, *args)
                errs[f"{name}.{variant}[{dname}]"] = paged_err(got, want,
                                                               dname)
                if name == "audit":
                    check(bool((got[0] == 0).all()),
                          "paged attention: a zero-length row gives zeros")
    stream = None
    n_stream = collections.Counter()
    all_types = {**torch_dtypes(), "float16": torch.float16}

    def stream_checks(tag, c, B, H, hd, pages=lambda t: t, route="stream"):
        """Every q type on dense and int8 pages through `pages` (a view
        maker): two calls on `route`, the same bits, zeros for the
        zero-length row, within the bands of the plain version. Returns
        {(variant, dtype): output}."""
        outs = {}
        for dname, dt in all_types.items():
            q = torch.randn(B, H, hd, generator=gen,
                            device=gen.device).to(dt)
            for variant in ("dense", "int8"):
                if variant == "dense":
                    args = (pages(c["kp"].to(dt)), pages(c["vp"].to(dt)),
                            c["tables"], c["lengths"])
                else:
                    kq, vq, ks, vs = c["int8"]
                    args = (pages(kq), pages(vq), c["tables"], c["lengths"],
                            pages(ks), pages(vs))
                key = f"tpp_paged_attention.{variant}:{dname}:{route}"
                n0 = tpp.routes[key]
                got = tpp.paged_attention(q, *args)
                again = tpp.paged_attention(q, *args)
                torch.cuda.synchronize()
                check(tpp.routes[key] - n0 == 2, f"paged attention {tag} "
                      f"{variant} {dname}: both calls on the {route} route")
                n_stream[route] += 2
                check(torch.equal(got, again),
                      f"paged attention {tag} {variant} {dname}: two calls, "
                      f"the same bits")
                check(bool((got[0] == 0).all()),
                      f"paged attention {tag}: a zero-length row gives zeros")
                errs[f"{tag}.{variant}[{dname}]"] = paged_err(
                    got, tpp.paged_attention_ref(q, *args), dname)
                outs[variant, dname] = (q, got)
        return outs

    t_stream = time.perf_counter()
    for shape in PAGED_STREAM_SHAPES:
        c = paged_cases(*shape, gen)
        B, H, hd, bs = shape[:4]
        stream_checks(f"stream_hd{hd}_bs{bs}", c, B, H, hd)
        if hd == 512 and bs == 512:
            stream = c
    # one layer of a [NB, L, H, bs, hd] pool: split boundaries inside
    # frames, the same bits as the contiguous pages
    *shape, L = PAGED_POOL_SHAPE
    c = paged_cases(*shape, gen)
    B, H, hd = shape[:3]

    def layer(t):
        pool = torch.zeros((t.shape[0], L) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device)
        pool[:, L // 2] = t
        return pool[:, L // 2]

    span, nsplit = tpp._paged_stream_splits(B, H, shape[3], shape[4])
    check(span % shape[3] != 0, "the pool case's splits end inside frames")
    pooled = stream_checks(f"stream_pool_layer_hd{hd}_bs{shape[3]}", c, B, H,
                           hd, pages=layer)
    for (variant, dname), (q, got) in pooled.items():
        if variant == "dense":
            dt = all_types[dname]
            args = (c["kp"].to(dt), c["vp"].to(dt), c["tables"], c["lengths"])
        else:
            kq, vq, ks, vs = c["int8"]
            args = (kq, vq, c["tables"], c["lengths"], ks, vs)
        check(torch.equal(got, tpp.paged_attention(q, *args)),
              f"paged attention stream: a pool layer's view gives the "
              f"contiguous pages' bits ({variant} {dname})")

    def off16(t):       # the same values one element past 16 bytes
        if t.dtype == torch.float32 and t.shape[-1] == 1:
            return t    # the int8 pages' scales stay as they are
        flat = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
        v = flat[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    c = paged_cases(*PAGED_OFF16_SHAPE, gen)
    B, H, hd, bs = PAGED_OFF16_SHAPE[:4]
    stream_checks(f"stream_off16_hd{hd}_bs{bs}", c, B, H, hd, pages=off16,
                  route="stream_direct")
    stream_wall = time.perf_counter() - t_stream
    # dtype pairs and a transposed-page view, on the split route
    c = full
    B, H, hd = c["tables"].shape[0], c["kp"].shape[1], c["kp"].shape[3]
    for q_dt, p_dt in ((torch.float16, torch.float16),
                       (torch.float16, torch.float32),
                       (torch.bfloat16, torch.float32)):
        q = torch.randn(B, H, hd, generator=gen, device=gen.device).to(q_dt)
        args = (c["kp"].to(p_dt), c["vp"].to(p_dt), c["tables"],
                c["lengths"])
        dname = str(q_dt).replace("torch.", "")
        errs[f"full_length.q_{dname}_pages_"
             f"{str(p_dt).replace('torch.', '')}"] = paged_err(
            tpp.paged_attention(q, *args), tpp.paged_attention_ref(q, *args),
            dname)
    q = torch.randn(B, H, hd, generator=gen, device=gen.device)
    tk, tv = (t.transpose(1, 2).contiguous().transpose(1, 2)
              for t in (c["kp"], c["vp"]))
    check(torch.equal(tpp.paged_attention(q, tk, tv, c["tables"],
                                          c["lengths"]),
                      tpp.paged_attention(q, c["kp"], c["vp"], c["tables"],
                                          c["lengths"])),
          "paged attention: a transposed-page view gives the contiguous "
          "pages' bits")
    emit({"phase": "kernels_vs_plain", "kernel": "paged_attention",
          "full_length": [SERVE_SLOTS, 12, 64, PAGE_BLOCK, 1024 // PAGE_BLOCK,
                          513], "audit_shape_B_H_hd_bs_maxb": AUDIT_SHAPES[0],
          "stream_shapes_B_H_hd_bs_maxb_NB": PAGED_STREAM_SHAPES,
          "stream_pool_layer_B_H_hd_bs_maxb_NB_L": PAGED_POOL_SHAPE,
          "stream_pool_layer_splits": [span, nsplit],
          "stream_off16_B_H_hd_bs_maxb_NB": PAGED_OFF16_SHAPE,
          "stream_route_launches": dict(n_stream),
          "stream_checks_wall_s": stream_wall,
          "pool_layer_view_bit_equal": True,
          "zero_length_row_zeros": True, "two_calls_bit_equal": True,
          "transposed_page_view_bit_equal": True,
          "max_abs_err": errs,
          "tol": {"float32": PAGED_TOL_F32,
                  "bfloat16": f"|d| <= {PAGED_BF16_REL} |plain| + "
                              f"{PAGED_BF16_ABS}",
                  "float16": f"|d| <= {2.0 ** -10} |plain| + "
                             f"{PAGED_BF16_ABS}"}})
    return errs, full, stream


def time_paged_attention(serve, full, full_errs, stream, time_ms, bound,
                         launch_counts):
    """The `kernels` entries of the paged-attention kernel: one layer of
    the live pool (the main path's call), the full-length case, and the
    stream route at head dim 512 and frames of 512 (`stream`; no path
    launches it: no model has such heads). ms
    times the launch alone, wrapper_ms the entry point with its checks;
    `splits` is the launch's grid (the plan tpp._paged_kernel_call
    returns: the route the C entry took, columns a split, splits a row
    and, on the stream kernel's ring, columns a tile and ring depth);
    the bound counts what the function needs: the K and V rows (and their
    scales) of the columns below each length, the table entries of the
    frames those columns lie in, q, out and lengths. library_ms: SDPA on
    the pre-gathered dense layout with the length mask (the gather
    excluded)."""
    import torch

    from paddle_tpu_torch.ops import tpp

    def entry(q, kp, vp, tables, lengths, scales, dname, route="split"):
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
        plan = tpp._paged_kernel_call(q, kp, vp, tables, lengths, *scales,
                                      route=route)[1]

        def kern():
            return tpp._paged_kernel_call(q, kp, vp, tables, lengths,
                                          *scales, route=route)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask)

        row = {
            "ms": time_ms(kern), "device_ms": time_ms(kern,
                                                      hide_enqueue=True),
            "wrapper_ms": time_ms(lambda: tpp.paged_attention(
                q, kp, vp, tables, lengths, *scales)),
            "wrapper_is": "paged_attention(): the launch after its checks, "
                          "whose table-range check waits for the device",
            "plain_ms": time_ms(lambda: tpp.paged_attention_ref(
                q, kp, vp, tables, lengths, *scales)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(sdpa),
            "library_device_ms": time_ms(sdpa, hide_enqueue=True),
            "library_covers": "scaled_dot_product_attention on the "
                              "pre-gathered dense layout with the length "
                              "mask (gather excluded)",
            "route": plan["route"],
            "splits": plan,
            "bytes": nbytes, "shape_B_H_hd_bs_maxb": [B, H, hd, bs, maxb],
            "lengths": lengths.tolist()}
        row["share_of_bound"] = bms / row["ms"]
        row["device_share_of_bound"] = bms / row["device_ms"]
        row["device_ms_over_library_device_ms"] = \
            row["device_ms"] / row["library_device_ms"]
        return row

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
        sq = torch.randn(stream["tables"].shape[0], stream["kp"].shape[1],
                         stream["kp"].shape[3], device=q.device).to(q.dtype)
        if variant == "dense":
            sk, sv = stream["kp"].to(q.dtype), stream["vp"].to(q.dtype)
            sscales = (None, None)
        else:
            sk, sv, sks, svs = stream["int8"]
            sscales = (sks, svs)
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
                "max_abs_err": full_errs[f"full_length.{variant}[{dname}]"]},
            "stream_route_hd512_bs512": {
                **entry(sq, sk, sv, stream["tables"], stream["lengths"],
                        sscales, dname, route="stream"),
                **launch_counts(
                    f"tpp_paged_attention.{variant}:{dname}:stream"),
                "max_abs_err": full_errs[
                    f"stream_hd512_bs512.{variant}[{dname}]"]}})
    return kernels


def auto_cast_enters_no_autocast():
    """auto_cast(bf16) only sets the amp state that linear and matmul
    read: torch's own CUDA autocast stays off inside it, so no other op
    (SDPA's naive branch, conv2d, the decode math) is cast."""
    import torch

    from paddle_tpu_torch.amp import amp_dtype, auto_cast

    with auto_cast(True, dtype="bfloat16"):
        state = {"amp_dtype": str(amp_dtype()),
                 "torch_cuda_autocast": torch.is_autocast_enabled("cuda")}
    check(state == {"amp_dtype": "torch.bfloat16",
                    "torch_cuda_autocast": False},
          f"auto_cast sets the amp dtype and enters no torch.autocast, got "
          f"{state}")
    return state


def teacher_forced_gaps(model, prompt, toks, dtype=None, cache_dtype=None):
    """generate's decode math (models/gpt.py ``_decode_fns``, one row at
    its own length, the cache of prompt + new columns) fed the prompt and
    then `toks` [n] one at a time, as generate feeds its own picks. Returns
    the gap of each step's token below that step's largest logit
    (0 where generate's greedy pick is the token), as a float64 [n]."""
    import torch

    from paddle_tpu_torch.models import gpt as pgpt

    dev = model.device
    fwd, logits_of, cache_init = pgpt._decode_fns(model.cfg, cache_dtype)
    compute = pgpt._decode_compute_dtype(dtype)
    p = {n: (t.detach().to(compute) if compute is not None
             and t.is_floating_point() else t.detach())
         for n, t in model.named_parameters()}
    toks = torch.as_tensor(toks, device=dev).long()
    ids = torch.as_tensor(prompt, device=dev).long()[None]
    s0, n = ids.shape[1], toks.shape[0]
    rows = []
    with torch.no_grad():
        kc, vc = cache_init(1, s0 + n, p["gpt.wte.weight"].dtype, dev)
        x = fwd(p, ids, 0, kc, vc)[:, -1]
        for i in range(n):
            rows.append(logits_of(p, x).float()[0])
            if i + 1 < n:
                x = fwd(p, toks[i].reshape(1, 1), s0 + i, kc, vc)[:, 0]
    lg = torch.stack(rows)
    gaps = lg.max(-1).values - lg.gather(-1, toks[:, None].to(
        lg.device)).squeeze(-1)
    return gaps.double().cpu()


def narrow_quantized_decode(dev):
    """The narrow model's greedy generate on int8 and fp8 caches (the JAX
    fixture's prompt, fp32 params) on the card, held against the port's
    CPU run of the same weights, which tests/test_torch_kv_quant.py holds
    to the JAX package's tokens: every card token is the CPU's greedy
    pick along the card's own tokens, or within QUANT_TIE_F32 of it."""
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
        params_from_jax
    from paddle_tpu_torch.testing import golden

    state = params_from_jax(golden.jax_layout_params())
    cpu = GPTForCausalLM(GPTConfig(**golden.NARROW), device="cpu")
    cpu.load_state_dict(state)
    card = GPTForCausalLM(GPTConfig(**golden.NARROW), device=dev)
    card.load_state_dict(state)
    prompt = golden.input_ids()[:, :golden.PROMPT]
    out = {}
    for leg in ("int8", "fp8"):
        toks = card.generate(torch.as_tensor(prompt, device=dev).long(),
                             max_new_tokens=golden.NEW_TOKENS,
                             temperature=0.0, cache_dtype=leg)
        new = toks[0, golden.PROMPT:].cpu()
        want = cpu.generate(torch.as_tensor(prompt).long(),
                            max_new_tokens=golden.NEW_TOKENS,
                            temperature=0.0, cache_dtype=leg)
        gaps = teacher_forced_gaps(cpu, prompt[0], new, cache_dtype=leg)
        check(float(gaps.max()) <= QUANT_TIE_F32,
              f"narrow {leg} generate on the card: every token the CPU's "
              f"greedy pick within {QUANT_TIE_F32} (max gap "
              f"{float(gaps.max())})")
        out[leg] = {"tokens_equal_cpu": int((new == want[0, golden.PROMPT:])
                                            .sum()),
                    "of": golden.NEW_TOKENS,
                    "steps_off_cpu_greedy": int((gaps > 0).sum()),
                    "max_gap": float(gaps.max())}
    return out


def gpt2_decode_legs(dev):
    """bench.py's gpt2s_decode as it runs on the TPU (run_decode :583-631,
    the int8 and fp8 legs :1097-1110): GPT-2 small (random weights from
    seed 0), bf16 params, batch 8, prompt 128 (RandomState(0)), 256 new
    tokens, greedy, on a bf16, an int8 and an fp8 cache. New tok/s with
    prefill excluded by differencing a 1-token run, DECODE_REPS runs each
    after a warm-up; MBU by bench.py's byte count (_decode_mbu :633-660)
    over the H100's 3.35 TB/s; the cache's allocated bytes. Returns the
    phase's dict, with the kernel launches of the decode (none: the
    reference's decode runs no kernel either)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models import gpt as pgpt
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import nms_pallas, tpp
    from paddle_tpu_torch.serving.decode_model import cache_row_bytes

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0)).eval()
    B, P, N = DECODE_BATCH, DECODE_PROMPT, DECODE_NEW
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32)).long().to(dev)
    h, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    hd, KVh = h // cfg.num_heads, cfg.num_kv_heads
    streamed = L * 12 * h * h + h * V   # bench.py's _n_params - the gathered
    #                                     embedding: every block and the head
    for counter in (fa.launches, tpp.launches, tpp.routes,
                    nms_pallas.launches):
        counter.clear()
    legs, toks = {}, {}
    for leg in DECODE_LEGS:
        def run(n):
            return model.generate(ids, max_new_tokens=n, temperature=0.0,
                                  dtype="bfloat16", cache_dtype=leg)

        def timed(n):
            run(n)                                   # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(DECODE_REPS):
                out = run(n)
            torch.cuda.synchronize()
            return time.perf_counter() - t, out

        torch.cuda.reset_peak_memory_stats()
        dt_full, out = timed(N)
        dt_prefill, _ = timed(1)
        decode_s = max(dt_full - dt_prefill, 1e-9)
        tps = B * (N - 1) * DECODE_REPS / decode_s
        check(tuple(out.shape) == (B, P + N) and bool(
            ((out >= 0) & (out < V)).all()),
              f"decode leg {leg}: [{B}, {P + N}] ids in the vocabulary")
        quant = leg is not None
        row_bytes = hd * (1 if quant else 2) + (4 if quant else 0)
        mbu_cache = B * 2 * L * (P + N / 2) * KVh * row_bytes
        bytes_per_token = (2 * streamed + mbu_cache) / B
        kc, vc = pgpt._decode_fns(cfg, leg)[2](B, P + N, torch.bfloat16,
                                              "meta")
        legs[leg or "bfloat16"] = {
            "new_tok_per_s": tps,
            "mbu": tps * bytes_per_token / HBM_BYTES_PER_S,
            "mbu_bytes_per_token": bytes_per_token,
            "mbu_cache_bytes_avg_len": mbu_cache,
            "cache_bytes": cache_row_bytes((kc, vc)),
            "full_s": dt_full, "prefill_and_one_step_s": dt_prefill,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30}
        toks[leg] = out[:, P:]
    for leg in ("int8", "fp8"):
        legs[leg]["new_tokens_equal_bf16_leg"] = int(
            (toks[leg] == toks[None]).sum())
    counts = {k: n for c in (fa.launches, tpp.launches, tpp.routes,
                             nms_pallas.launches)
              for k, n in c.items() if n}
    check(not counts, f"decode legs: no kernel launch (the reference's "
          f"decode runs none), got {counts}")
    del model
    torch.cuda.empty_cache()
    return {"legs": legs, "counts": counts}


_GPT2_MODELS = {}


def gpt2_model(cfg, seed, dev):
    """GPT-2 small or medium (GPT2_SMALL_CFG / GPT2_MEDIUM_CFG) with
    random weights from `seed`, built once for the generate and engine
    phases (drop_gpt2_models frees them)."""
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    key = (tuple(sorted(cfg.items())), seed)
    if key not in _GPT2_MODELS:
        _GPT2_MODELS[key] = GPTForCausalLM(
            GPTConfig(**cfg), device=dev,
            generator=torch.Generator().manual_seed(seed)).eval()
    return _GPT2_MODELS[key]


def drop_gpt2_models():
    import torch

    _GPT2_MODELS.clear()
    torch.cuda.empty_cache()


def teacher_forced_rows(model, prompts, toks, dtype=None):
    """teacher_forced_gaps for many rows at once: each prompt prefilled
    into its own row of one cache, then the rows' tokens fed together at
    per-row positions (the engine's decode math, one batched step a
    token). prompts: int arrays; toks: token lists of one length n.
    Returns the gaps as a float64 [rows, n]."""
    import torch

    from paddle_tpu_torch.models import gpt as pgpt
    from paddle_tpu_torch.serving.decode_model import cast_params

    dev = model.device
    fwd, logits_of, cache_init = pgpt._decode_fns(model.cfg)
    compute = pgpt._decode_compute_dtype(dtype)
    p = cast_params({n: t.detach() for n, t in model.named_parameters()},
                    compute)
    R, n = len(prompts), len(toks[0])
    T = max(len(q) for q in prompts) + n
    tk = torch.as_tensor([list(t) for t in toks], device=dev).long()
    gaps = []
    with torch.no_grad():
        kc, vc = cache_init(R, T, p["gpt.wte.weight"].dtype, dev)
        x = torch.cat([fwd(p, torch.as_tensor(q, device=dev).long()[None],
                           0, kc[:, r:r + 1], vc[:, r:r + 1])[:, -1]
                       for r, q in enumerate(prompts)])
        pos = torch.as_tensor([len(q) for q in prompts], device=dev).long()
        for i in range(n):
            lg = logits_of(p, x).float()
            gaps.append(lg.max(-1).values
                        - lg.gather(-1, tk[:, i:i + 1]).squeeze(-1))
            if i + 1 < n:
                x = fwd(p, tk[:, i:i + 1], pos + i, kc, vc)[:, 0]
    return torch.stack(gaps, 1).double().cpu()


def beam_logprob_fp32(model, prompts, seqs):
    """The fp32 joint log-prob of each sequence's new tokens after its
    prompt (teacher forced through the decode math): [rows] float64."""
    import torch

    from paddle_tpu_torch.models import gpt as pgpt

    dev = model.device
    fwd, logits_of, cache_init = pgpt._decode_fns(model.cfg)
    p = {n: t.detach() for n, t in model.named_parameters()}
    out = []
    with torch.no_grad():
        for q, s in zip(prompts, seqs):
            ids = torch.as_tensor(s, device=dev).long()[None]
            kc, vc = cache_init(1, ids.shape[1], torch.float32, dev)
            x = fwd(p, ids, 0, kc, vc)
            lp = torch.log_softmax(logits_of(p, x[0, len(q) - 1:-1]).float(),
                                   -1)
            out.append(float(lp.gather(-1, ids[0, len(q):, None]).sum()))
    return torch.tensor(out, dtype=torch.float64)


def narrow_generate_ext(dev):
    """The narrow model's ragged generate, beam search and speculative
    decoding on the card (fp32) against the port's CPU run of the same
    weights (which tests/test_torch_ragged_beam.py and
    test_torch_speculative.py hold to the JAX package): every card token
    the CPU's greedy pick along the card's tokens within TIE_GAP; beam
    scores within NARROW_BEAM_TOL of the CPU's."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
        params_from_jax
    from paddle_tpu_torch.testing import golden

    state = params_from_jax(golden.jax_layout_params())
    cpu = GPTForCausalLM(GPTConfig(**golden.NARROW), device="cpu").eval()
    cpu.load_state_dict(state)
    card = GPTForCausalLM(GPTConfig(**golden.NARROW), device=dev).eval()
    card.load_state_dict(state)
    draft_cfg = dict(golden.NARROW, num_layers=1)
    draft = GPTForCausalLM(GPTConfig(**draft_cfg), device=dev,
                           generator=torch.Generator().manual_seed(1)).eval()
    ids = golden.input_ids()[0, :golden.PROMPT]
    pads = (0, 9, 30, 17)
    batch = np.stack([ids] * len(pads))
    mask = np.ones_like(batch)
    for r, n in enumerate(pads):
        mask[r, :n] = 0
        batch[r, :n] = 0
    out = {}
    new = golden.NEW_TOKENS
    got = card.generate(torch.as_tensor(batch, device=dev).long(),
                        max_new_tokens=new, temperature=0.0,
                        attention_mask=torch.as_tensor(mask, device=dev))
    want = cpu.generate(torch.as_tensor(batch).long(), max_new_tokens=new,
                        temperature=0.0, attention_mask=torch.as_tensor(mask))
    toks = got[:, golden.PROMPT:].cpu()
    gaps = torch.cat([teacher_forced_gaps(cpu, ids[n:], toks[r])
                      for r, n in enumerate(pads)])
    check(float(gaps.max()) <= TIE_GAP,
          f"narrow ragged generate on the card: every token the CPU's "
          f"greedy pick of its unpadded prompt within {TIE_GAP} (max gap "
          f"{float(gaps.max())})")
    out["ragged"] = {"rows": len(pads), "left_pad": list(pads),
                     "tokens_equal_cpu": int((toks == want[:, golden.PROMPT:])
                                             .sum()),
                     "of": int(toks.numel()), "max_gap": float(gaps.max())}
    kw = dict(max_new_tokens=16, num_beams=3, eos_token_id=None,
              length_penalty=0.8)
    seq, score = card.generate(torch.as_tensor(batch[:2], device=dev).long(),
                               attention_mask=torch.as_tensor(
                                   mask[:2], device=dev), **kw)
    wseq, wscore = cpu.generate(torch.as_tensor(batch[:2]).long(),
                                attention_mask=torch.as_tensor(mask[:2]),
                                **kw)
    err = float((score.cpu() - wscore).abs().max())
    check(err <= NARROW_BEAM_TOL,
          f"narrow beam search on the card: scores within "
          f"{NARROW_BEAM_TOL} of the CPU's (err {err})")
    out["beam"] = {"batch": 2, "num_beams": 3, "new_tokens": 16,
                   "sequences_equal_cpu": bool(torch.equal(seq.cpu(), wseq)),
                   "score_max_abs_err": err}
    spec = {}
    for name, d in (("random_draft", draft), ("self_draft", card)):
        seq, rounds = card.generate_speculative(
            d, torch.as_tensor(ids[None], device=dev).long(),
            max_new_tokens=new, k=4)
        cpu_d = cpu if d is card else None
        if cpu_d is None:
            cpu_d = GPTForCausalLM(GPTConfig(**draft_cfg), device="cpu")
            cpu_d.load_state_dict({k: v.cpu() for k, v in
                                   d.state_dict().items()})
        wseq, wrounds = cpu.generate_speculative(
            cpu_d.eval(), torch.as_tensor(ids[None]).long(),
            max_new_tokens=new, k=4)
        toks = seq[0, golden.PROMPT:].cpu()
        gaps = teacher_forced_gaps(cpu, ids, toks)
        check(float(gaps.max()) <= TIE_GAP,
              f"narrow speculative ({name}) on the card: every token the "
              f"CPU's greedy pick within {TIE_GAP} (max gap "
              f"{float(gaps.max())})")
        spec[name] = {"rounds": rounds, "cpu_rounds": wrounds,
                      "tokens_equal_cpu": int((toks == wseq[0,
                                                            golden.PROMPT:])
                                              .sum()),
                      "of": new, "max_gap": float(gaps.max())}
    check(spec["self_draft"]["rounds"] == -(-new // 5),
          f"narrow self-draft: every proposal accepted, "
          f"{spec['self_draft']['rounds']} rounds")
    out["speculative"] = spec
    return out


def gpt2_generate_ext(dev):
    """The rest of generate at full width, bf16, seed 0: GPT-2 small on a
    ragged batch (RAGGED_BATCH prompts of 64-128 tokens left-padded to
    RAGGED_PAD_TO, RAGGED_NEW new), beam search (BEAM_BATCH x BEAM_K beams,
    prompt BEAM_PROMPT, BEAM_NEW new) and speculative decoding with a
    GPT-2 medium target and a GPT-2 small draft (prompt SPEC_PROMPT,
    SPEC_NEW new, k SPEC_K), plus the target as its own draft in fp32,
    where every proposal is accepted. Every greedy token is the target's
    pick along the returned tokens within ENGINE_TIE_BF16 (TIE_GAP in
    fp32); every beam score within BEAM_SCORE_TOL_BF16 of the fp32
    log-prob of its sequence. Returns the phase's dict."""
    import numpy as np
    import torch

    model = gpt2_model(GPT2_SMALL_CFG, 0, dev)
    rng = np.random.RandomState(0)
    V = model.cfg.vocab_size

    def timed(fn, warm):
        warm()                 # a short run of the same path first
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # ---- ragged ----------------------------------------------------------
    lens = [int(rng.randint(64, RAGGED_PAD_TO + 1))
            for _ in range(RAGGED_BATCH)]
    prompts = [rng.randint(0, V, (n,)).astype(np.int32) for n in lens]
    batch = np.zeros((RAGGED_BATCH, RAGGED_PAD_TO), np.int32)
    mask = np.zeros_like(batch)
    for r, q in enumerate(prompts):
        batch[r, RAGGED_PAD_TO - len(q):] = q
        mask[r, RAGGED_PAD_TO - len(q):] = 1
    ids = torch.as_tensor(batch, device=dev).long()
    am = torch.as_tensor(mask, device=dev)
    def ragged_run(n):
        return model.generate(ids, max_new_tokens=n, temperature=0.0,
                              dtype="bfloat16", attention_mask=am)

    out, dt = timed(lambda: ragged_run(RAGGED_NEW), lambda: ragged_run(2))
    toks = out[:, RAGGED_PAD_TO:].tolist()
    gaps = teacher_forced_rows(model, prompts, toks, dtype="bfloat16")
    check(float(gaps.max()) <= ENGINE_TIE_BF16,
          f"ragged generate: every token the greedy pick of its unpadded "
          f"prompt within {ENGINE_TIE_BF16} (max gap {float(gaps.max())})")
    ragged = {"batch": RAGGED_BATCH, "prompt_lens": lens,
              "padded_to": RAGGED_PAD_TO, "new_tokens": RAGGED_NEW,
              "new_tok_per_s": RAGGED_BATCH * RAGGED_NEW / dt, "wall_s": dt,
              "max_gap": float(gaps.max()),
              "steps_off_greedy": int((gaps > 0).sum()), "tie":
              ENGINE_TIE_BF16}

    # ---- beam search -----------------------------------------------------
    bprompts = [rng.randint(0, V, (BEAM_PROMPT,)).astype(np.int32)
                for _ in range(BEAM_BATCH)]
    bids = torch.as_tensor(np.stack(bprompts), device=dev).long()
    def beam_run(n):
        return model.generate(bids, max_new_tokens=n, num_beams=BEAM_K,
                              dtype="bfloat16", length_penalty=1.0)

    (seq, score), dt = timed(lambda: beam_run(BEAM_NEW),
                             lambda: beam_run(2))
    check(tuple(seq.shape) == (BEAM_BATCH, BEAM_PROMPT + BEAM_NEW)
          and bool(torch.isfinite(score).all()),
          f"beam search: [{BEAM_BATCH}, {BEAM_PROMPT + BEAM_NEW}] ids, "
          f"finite scores")
    want = beam_logprob_fp32(model, bprompts, seq.tolist())
    err = float((score.double().cpu() - want).abs().max())
    check(err <= BEAM_SCORE_TOL_BF16,
          f"beam search: each score within {BEAM_SCORE_TOL_BF16} of the "
          f"fp32 teacher-forced log-prob of its sequence (err {err})")
    beam = {"batch": BEAM_BATCH, "num_beams": BEAM_K, "prompt": BEAM_PROMPT,
            "new_tokens": BEAM_NEW, "scores": score.tolist(),
            "fp32_log_probs": want.tolist(), "score_max_abs_err": err,
            "tol": BEAM_SCORE_TOL_BF16,
            "new_tok_per_s": BEAM_BATCH * BEAM_NEW / dt, "wall_s": dt}
    del seq, score

    # ---- speculative: GPT-2 medium target, GPT-2 small draft -------------
    target = gpt2_model(GPT2_MEDIUM_CFG, 0, dev)
    sprompt = rng.randint(0, V, (SPEC_PROMPT,)).astype(np.int32)
    sids = torch.as_tensor(sprompt[None], device=dev).long()
    spec = {}
    for name, d, dtype in (("small_draft", model, "bfloat16"),
                           ("self_draft_fp32", target, None)):
        def spec_run(n):
            return target.generate_speculative(d, sids, max_new_tokens=n,
                                               k=SPEC_K, dtype=dtype)

        (seq, rounds), dt = timed(lambda: spec_run(SPEC_NEW),
                                  lambda: spec_run(8))
        toks = seq[0, SPEC_PROMPT:].tolist()
        gaps = teacher_forced_rows(target, [sprompt], [toks], dtype=dtype)
        tie = ENGINE_TIE_BF16 if dtype else TIE_GAP
        check(float(gaps.max()) <= tie,
              f"speculative ({name}): every token the target's greedy pick "
              f"within {tie} (max gap {float(gaps.max())})")
        spec[name] = {"rounds": rounds, "tokens_per_round": SPEC_NEW / rounds,
                      "new_tok_per_s": SPEC_NEW / dt, "wall_s": dt,
                      "max_gap": float(gaps.max()), "tie": tie,
                      "dtype": dtype or "float32"}
    check(spec["self_draft_fp32"]["rounds"] == -(-SPEC_NEW // (SPEC_K + 1)),
          f"self-draft control: every proposal accepted, "
          f"{spec['self_draft_fp32']['rounds']} rounds, expected "
          f"{-(-SPEC_NEW // (SPEC_K + 1))}")
    def greedy_run(n):
        return target.generate(sids, max_new_tokens=n, temperature=0.0,
                               dtype="bfloat16")

    _, dt = timed(lambda: greedy_run(SPEC_NEW), lambda: greedy_run(2))
    spec["target_generate_bf16_new_tok_per_s"] = SPEC_NEW / dt
    return {"ragged": ragged, "beam": beam, "speculative": spec,
            "target": "GPT-2 medium (24 x 1024, 16 heads)",
            "draft": "GPT-2 small", "spec_k": SPEC_K}


def gpt2_engine_ext(dev):
    """The rest of the engine on GPT-2 small, bf16, SERVE_SLOTS slots,
    SERVE_REQUESTS requests of SERVE_NEW new tokens (prompts of 32-127
    tokens, RandomState(5)): the plain dense drain first (the reference of
    the bit-equal checks); the speculative engine (GPT-2 medium target,
    GPT-2 small draft, spec_k SPEC_K, ENGINE_SPEC_NEW new tokens a
    request), each token the target's greedy pick within ENGINE_TIE_BF16; the multi-LoRA paged engine (three rank-16
    adapters on all four sites, LORA_SLOTS slots, so that adapters are
    evicted under load and their sessions restart), its base requests
    bit-equal the plain drain's; hot_swap to a seed-1 model after
    SWAP_AT_STEP steps, the requests submitted after it bit-equal a fresh
    seed-1 engine's; the disaggregated pool (1 worker, 2 engines) and the
    async step, each bit-equal the plain drain. Returns the phase's
    dict."""
    import numpy as np
    import torch

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.incubate import lora
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.serving.disagg import DisaggregatedPool

    model = gpt2_model(GPT2_SMALL_CFG, 0, dev)
    small = model.cfg
    rng = np.random.RandomState(5)
    lens = [int(rng.randint(32, 128)) for _ in range(SERVE_REQUESTS)]
    prompts = [rng.randint(0, small.vocab_size, (n,)).astype(np.int32)
               for n in lens]

    def engine(m, **kw):
        """An engine warmed by one 2-token request (bench.py's warm-up)."""
        eng = ServingEngine(m, max_batch=SERVE_SLOTS, dtype="bfloat16", **kw)
        eng.submit(prompts[0], max_new_tokens=2)
        eng.run_until_complete()
        return eng

    def drain(eng, kws=None, hook=None, profile_at=32, new=SERVE_NEW):
        """Submit every prompt, step to the end (hook(eng, n) after step
        n), one step profiled; returns (tokens, stats, host s, trace)."""
        rids = [eng.submit(q, max_new_tokens=new,
                           **(kws[i] if kws else {}))
                for i, q in enumerate(prompts)]
        n, trace = 0, None
        torch.cuda.synchronize()
        t = time.perf_counter()
        while eng.has_work():
            if n == profile_at:
                _, trace = device_breakdown(eng.step)
            else:
                eng.step()
            n += 1
            if hook is not None:
                hook(eng, n)
        dt = time.perf_counter() - t
        res = [eng.get_request(r) for r in rids]
        check(all(r.finish_reason == "length"
                  and len(r.output_ids) == new for r in res),
              "engine drain: every request ends at max_new_tokens")
        return [list(r.output_ids) for r in res], eng.stats(), dt, trace

    def row(stats, dt, trace, new=SERVE_NEW):
        return {"new_tok_per_s": SERVE_REQUESTS * new / dt,
                "timed_s": dt, "steps": stats["steps"],
                "profiled_step_32": trace}

    out = {}
    plain, stats, dt, trace = drain(engine(model))
    out["plain"] = row(stats, dt, trace)
    # the async step against the sync one, in turns (sync, async, async,
    # sync): every drain bit-equal the first
    rates = {"sync": [out["plain"]["new_tok_per_s"]], "async": []}
    for mode in ("async", "async", "sync"):
        set_flags({"async_dispatch": mode == "async"})
        toks, stats, dt, trace = drain(engine(model))
        check(toks == plain, f"{mode} step: the drain bit-equal the first "
              "sync drain")
        rates[mode].append(SERVE_REQUESTS * SERVE_NEW / dt)
        if mode == "async":
            out["async"] = {**row(stats, dt, trace), "bit_equal_sync": True}
    set_flags({"async_dispatch": False})
    out["async"].update(new_tok_per_s_runs=rates["async"],
                        sync_new_tok_per_s_runs=rates["sync"],
                        order="sync, async, async, sync")

    # ---- speculative continuous batching -------------------------------
    target = gpt2_model(GPT2_MEDIUM_CFG, 0, dev)
    toks, stats, dt, trace = drain(engine(target, draft_model=model,
                                          spec_k=SPEC_K), profile_at=8,
                                   new=ENGINE_SPEC_NEW)
    gaps = teacher_forced_rows(target, prompts, toks, dtype="bfloat16")
    check(float(gaps.max()) <= ENGINE_TIE_BF16,
          f"speculative engine: every token the target's greedy pick "
          f"within {ENGINE_TIE_BF16} (max gap {float(gaps.max())})")
    out["speculative"] = {**row(stats, dt, trace, ENGINE_SPEC_NEW),
                          "new_tokens": ENGINE_SPEC_NEW,
                          "speculative": stats["speculative"],
                          # a slot's round emits its accepted proposals
                          # and the target's fix-up token
                          "tokens_per_slot_round": 1 + SPEC_K
                          * stats["speculative"]["accepted"]
                          / max(1, stats["speculative"]["proposed"]),
                          "max_gap": float(gaps.max()),
                          "steps_off_greedy": int((gaps > 0).sum())}
    dense_t, stats_t, dt, _ = drain(engine(target), profile_at=-1,
                                    new=ENGINE_SPEC_NEW)
    out["speculative"]["dense_target_new_tok_per_s"] = \
        SERVE_REQUESTS * ENGINE_SPEC_NEW / dt
    out["speculative"]["tokens_equal_dense_target"] = sum(
        a == b for x, y in zip(toks, dense_t) for a, b in zip(x, y))
    del target
    drop_gpt2_models()

    # ---- multi-LoRA under eviction -------------------------------------
    names = ("a", "b", "c")
    wrapped = GPTForCausalLM(small, device=dev)
    wrapped.load_state_dict(model.state_dict())
    lora.apply_lora(wrapped, r=LORA_RANK, alpha=LORA_RANK,
                    generator=torch.Generator().manual_seed(7))
    exps = {}
    gen = torch.Generator(device=dev)
    for i, name in enumerate(names):
        gen.manual_seed(10 + i)
        with torch.no_grad():
            for n, p in wrapped.named_parameters():
                if "lora_" in n:
                    p.normal_(0.0, LORA_B_STD if "lora_B" in n else 0.02,
                              generator=gen)
        exps[name] = lora.export_lora(wrapped)
    del wrapped
    # 18 requests on a (pinned), b and the base first; after
    # LORA_LOAD_AT_STEP steps c is loaded (evicting b while its sessions run)
    # and 6 requests on c follow
    kinds = [("a", "b", None)[i % 3] if i < 18 else "c"
             for i in range(SERVE_REQUESTS)]
    loads = {"forced": 0, "restarted": 0, "loads": 2}

    def lora_step(eng, n):
        """After step n: at LORA_LOAD_AT_STEP load c and submit its requests;
        later, load the adapter the queue head waits for once the
        adapter it evicts has no session in flight."""
        if n == LORA_LOAD_AT_STEP:
            busy = sum(1 for r in eng._slot_req
                       if r is not None and r.adapter == "b")
            eng.load_adapter("c", exps["c"])
            loads["forced"] += 1
            loads["restarted"] += busy
            loads["loads"] += 1
            rids.extend(eng.submit(prompts[i], max_new_tokens=SERVE_NEW,
                                   adapter="c")
                        for i in range(18, SERVE_REQUESTS))
            return
        if not eng._queue or eng._queue[0].adapter is None:
            return
        want = eng._queue[0].adapter
        if eng._adapters.peek(want) is not None:
            return
        victim = next(v for v in eng._adapters._lru
                      if v not in eng._adapters._pinned)
        if any(r is not None and r.adapter == victim
               for r in eng._slot_req):
            return
        eng.load_adapter(want, exps[want])
        loads["loads"] += 1

    set_flags({"paged_kv": True})
    eng = engine(model, max_adapters=LORA_SLOTS, lora_rank=LORA_RANK)
    eng.load_adapter("a", exps["a"], pin=True)
    eng.load_adapter("b", exps["b"])
    rids = [eng.submit(prompts[i], max_new_tokens=SERVE_NEW,
                       adapter=kinds[i]) for i in range(18)]
    n, trace = 0, None
    torch.cuda.synchronize()
    t = time.perf_counter()
    while eng.has_work():
        if n == 32:
            _, trace = device_breakdown(eng.step)
        else:
            eng.step()
        n += 1
        lora_step(eng, n)
    dt = time.perf_counter() - t
    stats = eng.stats()
    set_flags({"paged_kv": False})
    res = [eng.get_request(r) for r in rids]
    check(all(r.finish_reason == "length"
              and len(r.output_ids) == SERVE_NEW for r in res),
          "multi-LoRA drain: every request ends at max_new_tokens")
    toks = [list(r.output_ids) for r in res]
    base = [i for i, k in enumerate(kinds) if k is None]
    check(all(toks[i] == plain[i] for i in base),
          "multi-LoRA engine: base requests bit-equal the plain engine's")
    differ = sum(toks[i] != plain[i] for i, k in enumerate(kinds) if k)
    n_ad = len(kinds) - len(base)
    check(2 * differ > n_ad, f"multi-LoRA engine: adapter tokens differ "
          f"from the base model's on most requests ({differ} of {n_ad})")
    check(loads["restarted"] > 0,
          "multi-LoRA engine: loading c evicted b under load and restarted "
          "its sessions")
    out["multi_lora"] = {**row(stats, dt, trace), "rank": LORA_RANK,
                         "adapters": len(names), "slots": LORA_SLOTS,
                         "adapter_loads": loads["loads"],
                         "sessions_restarted": loads["restarted"],
                         "adapter_requests_differing_from_base": differ,
                         "of": n_ad, "base_requests_bit_equal_plain": True,
                         "adapters_state": stats["paging"]["adapters"]}
    del eng
    torch.cuda.empty_cache()

    # ---- hot swap mid-drain --------------------------------------------
    model1 = GPTForCausalLM(small, device=dev,
                            generator=torch.Generator().manual_seed(1)).eval()
    half = SERVE_REQUESTS // 2
    eng = engine(model)
    rids = [eng.submit(q, max_new_tokens=SERVE_NEW) for q in prompts[:half]]
    for _ in range(SWAP_AT_STEP):
        eng.step()
    t = time.perf_counter()
    version = eng.hot_swap(model1)
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t) * 1e3
    rids += [eng.submit(q, max_new_tokens=SERVE_NEW) for q in prompts[half:]]
    eng.run_until_complete()
    after = [list(eng.get_request(r).output_ids) for r in rids[half:]]
    stamps = sorted({str(eng.get_request(r).weight_version).split(":", 1)[1]
                     for r in rids})
    fresh = engine(model1)
    frids = [fresh.submit(q, max_new_tokens=SERVE_NEW)
             for q in prompts[half:]]
    fresh.run_until_complete()
    check(after == [list(fresh.get_request(r).output_ids) for r in frids],
          "hot_swap: requests after the swap bit-equal a fresh seed-1 "
          "engine's")
    out["hot_swap"] = {"at_step": SWAP_AT_STEP, "swap_ms": swap_ms,
                       "version": str(version).split(":", 1)[1],
                       "request_stamps": stamps,
                       "after_swap_bit_equal_fresh_engine": True}
    del eng, fresh, model1
    torch.cuda.empty_cache()

    # ---- disaggregated pool --------------------------------------------
    pool = DisaggregatedPool(model, prefill_workers=1, decode_engines=2,
                             max_batch=SERVE_SLOTS, dtype="bfloat16")
    prids = [pool.submit(q, max_new_tokens=SERVE_NEW) for q in prompts]
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = pool.run_until_complete()
    dt = time.perf_counter() - t
    check([list(res[r].output_ids) for r in prids] == plain,
          "disaggregated pool: completions bit-equal the plain engine's")
    pst = pool.stats()["pool"]
    out["disaggregated"] = {"workers": 1, "engines": 2,
                            "new_tok_per_s": SERVE_REQUESTS * SERVE_NEW / dt,
                            "timed_s": dt, "handoffs": pst["handoffs"],
                            "handoff_bytes": pst["handoff_bytes"],
                            "per_engine": pst["per_engine"],
                            "bit_equal_plain": True}
    del pool
    torch.cuda.empty_cache()

    del model
    torch.cuda.empty_cache()
    return out


def train_detector(dev):
    """PP-YOLOE training as bench.py runs it (run_ppyolo_train :493-545):
    loss(decode(model(x))) through SpmdTrainer(loss_fn=None) with Momentum
    (lr 0.01, momentum 0.9) under bf16 auto_cast, TF32 off. First the
    narrow detector's golden.DET_TRAIN_STEPS steps against the JAX
    package's committed run; then the full width (80 classes, width 64,
    depth 2; batch 8 at 640 x 640 from RandomState(0), targets over the
    8,400 anchors from RandomState(1), as bench.py draws them): one warm-up
    step, DET_TRAIN_STEPS_TIMED timed steps (host clock around a
    synchronised step) and one profiled. Returns the full-width path's
    kernel launches (none of the port's kernels: no NMS in training)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.models import ppyoloe_params_from_jax
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.testing import golden
    from paddle_tpu_torch.vision.models import PPYOLOE, PPYOLOELoss, \
        ppyoloe_tiny

    torch.backends.cudnn.allow_tf32 = False

    def trainer_for(det, classes):
        layer = golden.detector_train_step(det, PPYOLOELoss(classes))
        return SpmdTrainer(layer, Momentum(
            learning_rate=golden.DET_TRAIN_LR,
            momentum=golden.DET_TRAIN_MOMENTUM,
            parameters=layer.parameters()), loss_fn=None)

    # the narrow detector against the JAX package's three steps
    fix = dict(np.load(golden.DET_TRAIN_FIXTURE))
    det = ppyoloe_tiny(num_classes=golden.DET_CLASSES, device=dev)
    det.load_state_dict(ppyoloe_params_from_jax(golden.detector_state()))
    tr = trainer_for(det, golden.DET_CLASSES)
    init = {n: p.detach().cpu().numpy().copy()
            for n, p in tr.params.items()}
    batch = [torch.as_tensor(a, device=dev) for a in (
        golden.detector_images(), *golden.detector_targets())]
    with auto_cast(True, dtype="bfloat16"):
        losses = [float(tr.train_step(*batch))
                  for _ in range(golden.DET_TRAIN_STEPS)]
    summary = golden.detector_train_summary(
        losses, {n: p.detach().cpu().numpy() for n, p in tr.params.items()},
        {n: tr.opt_state[n]["velocity"].cpu().numpy() for n in tr.params},
        {n: b.cpu().numpy() for n, b in tr.buffers.items()}, init)
    err = golden.detector_train_errors(summary, fix)
    check(max(err["loss"], err["values"]) <= golden.DET_TRAIN_RTOL
          and err["norms"] <= golden.DET_TRAIN_NORM_RTOL,
          f"narrow detector training vs JAX: {err}")
    emit({"phase": "ppyoloe_narrow_train_vs_jax_fixture",
          "steps": golden.DET_TRAIN_STEPS, "losses": losses,
          "jax_losses": fix["loss"].tolist(), "rel_err": err,
          "tol": {"loss_and_values": golden.DET_TRAIN_RTOL,
                  "norms": golden.DET_TRAIN_NORM_RTOL},
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    del det, tr, batch

    # the full width, bench.py's config
    det = PPYOLOE(**DET_CONFIG, device=dev,
                  generator=torch.Generator().manual_seed(0))
    tr = trainer_for(det, DET_CONFIG["num_classes"])
    A = sum((DET_SIZE // s) ** 2 for s in det.strides)
    images = torch.as_tensor(np.random.RandomState(0).rand(
        DET_BATCH, 3, DET_SIZE, DET_SIZE).astype(np.float32), device=dev)
    rng = np.random.RandomState(1)
    gt_boxes = torch.as_tensor((rng.rand(DET_BATCH, A, 4) * DET_SIZE)
                               .astype(np.float32), device=dev)
    gt_labels = torch.as_tensor(rng.randint(
        0, DET_CONFIG["num_classes"] + 1, (DET_BATCH, A)).astype(np.int64),
        device=dev)
    losses = []

    def step():
        with auto_cast(True, dtype="bfloat16"):
            loss = tr.train_step(images, gt_boxes, gt_labels)
        losses.append(loss.item())
        return loss

    _zero_counters()
    row, trace = _timed_training(step, DET_TRAIN_STEPS_TIMED, det_group)
    counts = _read_kernel_counts()
    check(all(math.isfinite(x) for x in losses),
          f"PP-YOLOE training: finite losses {losses}")
    check(trace.get("kernels", 0) > 0, "PP-YOLOE training: the profiled "
          "step ran on the device")
    emit({"phase": "ppyoloe_train", "config": DET_CONFIG,
          "batch": DET_BATCH, "size": DET_SIZE, "anchors": A,
          "optimizer": f"Momentum lr {golden.DET_TRAIN_LR} momentum "
                       f"{golden.DET_TRAIN_MOMENTUM}",
          "auto_cast": "bfloat16 (casts nothing on the detector)",
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32, **row,
          "imgs_per_s": DET_BATCH / (row["step_ms"] / 1e3),
          "losses": losses, "loss_falls": losses[-1] < losses[0],
          "profiled": trace, "main_path_launches": counts})
    del det, tr, images, gt_boxes, gt_labels
    torch.cuda.empty_cache()
    return counts


def model_group(name):
    """The training paths' kernel groups (ResNet, LeNet, BERT)."""
    n = name.lower()
    if any(t in n for t in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                            "winograd", "nchwtonhwc", "nhwctonchw")):
        return "convolution"
    if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "softmax" in n:
        return "softmax"
    if "norm" in n or "welford" in n:
        return "norm"
    if "pool" in n:
        return "pool"
    if "reduce" in n:
        return "reduce"
    if any(t in n for t in ("elementwise", "vectorized", "unrolled")):
        return "elementwise"
    return "rest"


def _path_counters():
    """Every kernel launch and route counter of the port, and SDPA's count
    of its routes."""
    from paddle_tpu_torch.nn.functional import transformer as sdpa
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import nms_pallas, tpp

    return (fa.launches, fa.routes, tpp.launches, tpp.routes,
            nms_pallas.launches, nms_pallas.routes, sdpa.routes)


def _zero_counters():
    for counter in _path_counters():
        counter.clear()


def _read_kernel_counts():
    """The kernel launches and routes counted since _zero_counters (SDPA's
    route count apart)."""
    return {k: n for c in _path_counters()[:-1] for k, n in c.items() if n}


def _timed_training(step, steps, group=None):
    """One warm-up step, `steps` timed ones (host clock around a
    synchronised step), then one profiled (device ms by `group`, default
    model_group). Returns (timing row, the profile)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1 + steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t) * 1e3)
    _, trace = device_breakdown(step, group or model_group)
    return {"step_ms": statistics.median(times), "step_ms_min": min(times),
            "step_ms_max": max(times), "step_ms_all": times,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30}, trace


def _narrow_vs_fixture(phase, kind, fixture, summary, losses):
    """Hold a narrow model's three steps against its JAX fixture."""
    import numpy as np

    from paddle_tpu_torch.testing import golden

    fix = dict(np.load(fixture))
    err = golden.model_train_errors(summary, fix)
    tol = golden.MODEL_TRAIN_TOL[kind]
    check(golden.within(err, tol), f"{phase}: {err} within {tol}")
    emit({"phase": phase, "steps": golden.MODEL_TRAIN_STEPS,
          "losses": losses, "jax_losses": fix["loss"].tolist(),
          "rel_err": err, "tol": tol})


def train_models(dev):
    """ResNet-50, LeNet and BERT-base training as bench.py runs them
    (run_resnet50 :357-392, run_lenet :446-470, run_bert :397-443), each
    at the bench's full width and depth after its narrow model's three
    steps against the JAX package's committed run. TF32 stays off (the
    reference's fp32 is fp32). Returns each full-size path's kernel
    launches (counted from zero just before it)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import Model
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertPretrainLoss, state_from_jax)
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.nn.functional import transformer as sdpa
    from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
    from paddle_tpu_torch.testing import golden
    from paddle_tpu_torch.vision.models import LeNet, resnet50

    tf32 = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    counts = {}

    def bf16_steps(trainer, batch, n):
        with auto_cast(True, dtype="bfloat16"):
            return [float(trainer.train_step(*batch)) for _ in range(n)]

    # ---- ResNet: the narrow model, then resnet50 at 64 x 224 x 224 -------
    m = golden.resnet_narrow(device=dev)
    m.load_state_dict(state_from_jax(golden.resnet_state(m), m))
    tr = SpmdTrainer(m, Momentum(learning_rate=golden.RESNET_LR,
                                 momentum=golden.RESNET_MOMENTUM,
                                 parameters=m.parameters()),
                     loss_fn=CrossEntropyLoss())
    init = golden.jax_layout(tr.params, m)
    losses = bf16_steps(tr, [torch.as_tensor(a, device=dev)
                             for a in golden.resnet_batch()],
                        golden.MODEL_TRAIN_STEPS)
    _narrow_vs_fixture("resnet_narrow_train_vs_jax_fixture", "resnet",
                       golden.RESNET_FIXTURE, golden.port_train_summary(
                           tr, m, init, losses, ["velocity"]), losses)
    del m, tr
    m = resnet50(num_classes=1000, device=dev,
                 generator=torch.Generator().manual_seed(0))
    tr = SpmdTrainer(m, Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=m.parameters()),
                     loss_fn=CrossEntropyLoss())
    rng = np.random.RandomState(0)
    images = rng.rand(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE)
    labels = rng.randint(0, 1000, (RESNET_BATCH,))
    batch = [torch.as_tensor(images.astype(np.float32), device=dev),
             torch.as_tensor(labels.astype(np.int32), device=dev)]
    losses = []
    _zero_counters()
    row, trace = _timed_training(
        lambda: losses.extend(bf16_steps(tr, batch, 1)), MODEL_STEPS_TIMED)
    counts["resnet_train"] = _read_kernel_counts()
    check(all(math.isfinite(x) for x in losses),
          f"resnet50 training: finite losses {losses}")
    check(trace.get("kernels", 0) > 0, "resnet50: the profiled step ran "
          "on the device")
    emit({"phase": "resnet50_train", "config": "bench.py run_resnet50",
          "batch": RESNET_BATCH, "size": RESNET_SIZE, "num_classes": 1000,
          "optimizer": "Momentum lr 0.1 momentum 0.9",
          "auto_cast": "bfloat16 (casts fc only)", **tf32, **row,
          "imgs_per_s": RESNET_BATCH / (row["step_ms"] / 1e3),
          "losses": losses, "profiled": trace,
          "main_path_launches": counts["resnet_train"]})
    del m, tr, batch
    torch.cuda.empty_cache()

    # ---- LeNet through Model.train_batch: the narrow run, then batch 64 --
    state = golden.jax_state(golden.jax_shapes(LeNet(device=dev)),
                             golden.LENET_SEED)
    net = LeNet(device=dev)
    net.load_state_dict(state_from_jax(state, net))
    model = Model(net).prepare(Adam(learning_rate=golden.LENET_LR,
                                    parameters=net.parameters()),
                               CrossEntropyLoss())
    images, labels = golden.lenet_batch()
    losses = [model.train_batch([images], [labels])[0]
              for _ in range(golden.MODEL_TRAIN_STEPS)]
    _narrow_vs_fixture("lenet_narrow_train_batch_vs_jax_fixture", "lenet",
                       golden.LENET_FIXTURE, golden.model_train_summary(
                           losses, golden.jax_layout(
                               dict(net.named_parameters()), net), state),
                       losses)
    net = LeNet(device=dev, generator=torch.Generator().manual_seed(0))
    model = Model(net).prepare(Adam(learning_rate=1e-3,
                                    parameters=net.parameters()),
                               CrossEntropyLoss())
    rng = np.random.RandomState(0)
    images = rng.rand(LENET_BATCH, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, (LENET_BATCH, 1)).astype(np.int64)
    losses = []
    _zero_counters()
    row, trace = _timed_training(
        lambda: losses.extend(model.train_batch([images], [labels])),
        LENET_STEPS_TIMED)
    counts["lenet_train"] = _read_kernel_counts()
    check(all(math.isfinite(x) for x in losses),
          f"LeNet training: finite losses {losses}")
    check(trace.get("kernels", 0) > 0, "LeNet: the profiled step ran on "
          "the device")
    emit({"phase": "lenet_train_batch", "config": "bench.py run_lenet",
          "batch": LENET_BATCH, "optimizer": "Adam lr 1e-3",
          "inputs": "numpy images and labels each step, as bench.py "
                    "passes them", **tf32, **row,
          "steps_per_s": 1e3 / row["step_ms"],
          "loss_first_last": [losses[0], losses[-1]], "profiled": trace,
          "main_path_launches": counts["lenet_train"]})
    del net, model

    # ---- BERT: tiny against the fixture, then base at 16 x 512 -----------
    m = BertForPretraining(BertConfig.tiny(), device=dev)
    m.load_state_dict(state_from_jax(golden.jax_state(
        golden.jax_shapes(m), golden.BERT_SEED, std_2d=0.02,
        bias_std=0.02), m))
    tr = SpmdTrainer(m, AdamW(learning_rate=golden.BERT_LR,
                              parameters=m.parameters()),
                     loss_fn=BertPretrainLoss())
    init = golden.jax_layout(tr.params, m)
    losses = bf16_steps(tr, [torch.as_tensor(a, device=dev)
                             for a in golden.bert_batch()],
                        golden.MODEL_TRAIN_STEPS)
    _narrow_vs_fixture("bert_tiny_pretrain_vs_jax_fixture", "bert",
                       golden.BERT_FIXTURE, golden.port_train_summary(
                           tr, m, init, losses, ["moment1", "moment2"]),
                       losses)
    del m, tr
    cfg = BertConfig(dropout=0.0)
    m = BertForPretraining(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
    tr = SpmdTrainer(m, AdamW(learning_rate=1e-4, parameters=m.parameters()),
                     loss_fn=BertPretrainLoss())
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ))
    mlm = rng.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ))
    batch = [torch.as_tensor(a.astype(np.int32), device=dev)
             for a in (ids, np.zeros_like(ids), mlm)]
    losses = []
    _zero_counters()
    row, trace = _timed_training(
        lambda: losses.extend(bf16_steps(tr, batch, 1)), MODEL_STEPS_TIMED)
    counts["bert_train"] = _read_kernel_counts()
    routes = dict(sdpa.routes)
    steps = MODEL_STEPS_TIMED + 2
    check(routes.get("flash", 0) == 0
          and routes.get("naive", 0) == cfg.num_layers * steps,
          f"BERT-base: every attention call on the naive route ({routes} "
          f"over {steps} steps of {cfg.num_layers} layers)")
    check(all(math.isfinite(x) for x in losses),
          f"BERT-base training: finite losses {losses}")
    check(trace.get("kernels", 0) > 0, "BERT-base: the profiled step ran "
          "on the device")
    emit({"phase": "bert_base_pretrain", "config": "bench.py run_bert",
          "batch": BERT_BATCH, "seq": BERT_SEQ, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "heads": cfg.num_heads,
          "optimizer": "AdamW lr 1e-4",
          "auto_cast": "bfloat16 (Linear layers and the tied head)", **tf32,
          **row, "tokens_per_s": BERT_BATCH * BERT_SEQ
          / (row["step_ms"] / 1e3), "losses": losses,
          "sdpa_routes": routes, "profiled": trace,
          "main_path_launches": counts["bert_train"]})
    del m, tr, batch
    torch.cuda.empty_cache()
    return counts


def _gpt_flops_per_token(cfg, seq):
    """bench.py's _model_flops_per_token (:246-253): 6 N (N counts the
    embedding and the tied head once each) plus the attention matmuls."""
    h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    return 6 * (v * h + L * 12 * h * h + h * v) + L * 12 * seq * h


def _gpt_bench_batch(cfg, batch, seq, dev):
    """bench.py's _gpt2s_setup batch: ids, then labels, from
    RandomState(0)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    return [torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq))
                            .astype(np.int32)).long().to(dev)
            for _ in range(2)]


def _flash_step_counts(delta):
    """The flash launches of one step from the counter deltas."""
    return {k: n for k, n in delta.items() if k.startswith("flash_")}


# the runtime services phase: GPT-2 small training at bench.py's shapes
# (RUNTIME_BATCH x RUNTIME_SEQ, bf16 auto_cast, AdamW lr 1e-4, seed 0), 3
# steps, a checkpoint, 3 more; the overhead legs step the modes in turns
# so that the host's drift falls on all of them alike. A training step at
# these shapes wanders ~7% (sd) from one step to the next on an H100, flat
# rather than bell-shaped (95-125 ms in one process, modes in turns), so
# the medians of 150 steps a mode still put their ratio ~1% (sd) either
# way. The defaults' training cost is read instead from ABBA quads (off,
# defaults, defaults, off, then the mirror): each quad's defaults ms over
# its off ms, RUNTIME_OVERHEAD_TRIM trimmed from each end, the rest
# averaged (sd of a quad's ratio ~6.5%: ~0.55% over RUNTIME_OVERHEAD_
# QUADS). Trace + goodput, which no limit holds, gets a step every
# RUNTIME_OVERHEAD_TG_EVERY quads
RUNTIME_BATCH, RUNTIME_SEQ = TRAIN_BATCH, 1024
RUNTIME_OVERHEAD_QUADS = 150
RUNTIME_OVERHEAD_TG_EVERY = 5
RUNTIME_OVERHEAD_TRIM = 0.1
# the cost registry's FLOP count of a step against bench.py's analytic
# count, once the two are put on the same footing (see runtime_services)
RUNTIME_FLOPS_REL = 0.05
# what the defaults (the monitor on) may cost against every flag off: a
# training step's ms (the quads' trimmed mean) and the engine's median
# step ms
RUNTIME_OVERHEAD_MAX = 0.02
# the modes of the overhead legs: (monitor, trace, goodput)
RUNTIME_MODES = {"off": (False, False, False), "defaults": (True, False, False),
                 "trace_goodput": (True, True, True)}


def runtime_services(dev):
    """The runtime services of the port (monitor/, trace/, trace/costs.py,
    profiler/, testing/failpoints.py, framework/io.py, incubate/checkpoint,
    monitor/goodput.py) in SpmdTrainer and the ServingEngine on GPT-2
    small:

    (a) resume: FLAGS_trace, FLAGS_goodput and the monitor armed, 3 steps,
        a CheckpointSaver save, 3 more; a fresh trainer loads the
        checkpoint and runs the same 3 steps: losses and final parameters
        bit-equal the uninterrupted run's;
    (b) MFU: stats()'s flops_per_step (the FLOP counter over the first
        step) against bench.py's analytic count, and stats()'s mfu beside
        the MFU from tokens/s;
    (c) durability: a save under ckpt/write=error raises, leaves the
        previous checkpoint loadable with its footer verified and no tmp
        file; a torn newest checkpoint falls back to the older one;
    (d) exports: the Chrome trace's train_step and checkpoint spans, the
        Prometheus text parsed back, the goodput buckets against wall time;
    (e) the engine (bf16, SERVE_SLOTS slots, SERVE_REQUESTS requests of
        SERVE_NEW new tokens): breakdown with FLOPs, a span tree and a
        trace_id a request, serving/slot=error:1 ending one request while
        the others keep the plain tokens;
    (f) overhead: training step ms and engine new tok/s with every flag
        off, the defaults, and trace + goodput, stepped in turns (off and
        the defaults on one trainer, an engine a mode); the defaults' cost
        from the median steps.

    Returns the kernel launches and routes of the phase (counted from
    zero)."""
    import os
    import tempfile
    import warnings

    import numpy as np
    import torch

    from paddle_tpu_torch import monitor, set_flags, trace
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.framework import io
    from paddle_tpu_torch.incubate.checkpoint import CheckpointSaver
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainLoss)
    from paddle_tpu_torch.monitor import goodput
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing import failpoints
    from paddle_tpu_torch.trace import costs

    t_phase = time.perf_counter()
    cfg = GPTConfig(**GPT2_SMALL_CFG)
    B, S = RUNTIME_BATCH, RUNTIME_SEQ
    L, h, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    rng = np.random.RandomState(0)
    batches = [[torch.as_tensor(rng.randint(0, V, (B, S)).astype(np.int32))
                .long().to(dev) for _ in range(2)] for _ in range(6)]

    def set_mode(mon, tr, gp):
        (monitor.enable if mon else monitor.disable)()
        (trace.enable if tr else trace.disable)()
        set_flags({"goodput": gp})

    def trainer():
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(0))
        return model, SpmdTrainer(model, AdamW(
            learning_rate=1e-4, parameters=model.parameters()),
            loss_fn=GPTPretrainLoss())

    def step(tr, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with auto_cast(True, dtype="bfloat16"):
            loss = tr.train_step(*batch)
        loss.item()
        return loss, (time.perf_counter() - t) * 1e3

    _zero_counters()
    set_mode(True, True, True)
    trace.clear()
    costs.reset()
    run = goodput.start_run("runtime_services")
    tmp = tempfile.TemporaryDirectory()
    saver = CheckpointSaver(os.path.join(tmp.name, "ck"), max_num=3,
                            device=dev)
    out = {}

    # (a) resume -------------------------------------------------------
    model_a, tr_a = trainer()
    losses_a, ms_a = [], []
    for i, batch in enumerate(batches):
        if i == 3:
            t = time.perf_counter()
            saver.save_checkpoint(tr_a.state_dict(), meta={"step": 3})
            save_ms = [(time.perf_counter() - t) * 1e3]
        loss, ms = step(tr_a, batch)
        losses_a.append(loss)
        ms_a.append(ms)
    st_a = tr_a.stats()
    final_a = {n: p.detach().clone() for n, p in model_a.named_parameters()}
    state_final = tr_a.state_dict()
    del model_a, tr_a
    torch.cuda.empty_cache()
    model_b, tr_b = trainer()
    t = time.perf_counter()
    state, meta = saver.load_checkpoint(0)
    tr_b.set_state_dict(state)
    load_ms = [(time.perf_counter() - t) * 1e3]
    del state
    losses_b = [step(tr_b, batch)[0] for batch in batches[3:]]
    loss_equal = all(torch.equal(a, b) for a, b in zip(losses_a[3:],
                                                        losses_b))
    differ = [n for n, p in model_b.named_parameters()
              if not torch.equal(p, final_a[n])]
    check(meta["step"] == 3 and loss_equal and not differ,
          f"runtime_services (a): a resumed run is bit-equal the "
          f"uninterrupted one (losses {[x.item() for x in losses_a[3:]]} "
          f"vs {[x.item() for x in losses_b]}; parameters that differ: "
          f"{differ[:5]})")
    out["resume"] = {
        "losses": [x.item() for x in losses_a],
        "resumed_losses": [x.item() for x in losses_b],
        "bit_equal": True, "weight_version": str(tr_b.weight_version)}
    del model_b, tr_b, final_a
    torch.cuda.empty_cache()

    # (b) MFU ------------------------------------------------------------
    tokens = B * S
    analytic = _gpt_flops_per_token(cfg, S) * tokens
    # bench.py's count puts 6 V h a token on the embedding lookup (6 N
    # with N counting the table) and 12 L S h on attention (every q-k pair
    # of both products, forward and backward). What runs: no matmul reads
    # the embedding (a gather; its grad a scatter), and the flash kernels
    # compute the causal pairs only, S (S + 1) / 2 a head, at 4 d
    # forward, 6 d dQ and 8 d dK/dV (each backward kernel recomputes the
    # scores)
    embedding = 6 * V * h * tokens
    attention_bench = L * 12 * S * h * tokens
    attention_flash = 18 * h * L * B * S * (S + 1) // 2
    same_footing = analytic - embedding - attention_bench + attention_flash
    counted = st_a["flops_per_step"]
    rel = abs(counted - same_footing) / same_footing
    check(counted is not None and rel <= RUNTIME_FLOPS_REL,
          f"runtime_services (b): the counted FLOPs a step {counted} "
          f"within {RUNTIME_FLOPS_REL:.0%} of the analytic count on the "
          f"same footing {same_footing} (bench.py's {analytic})")
    tok_s = tokens / (statistics.median(ms_a[1:]) / 1e3)
    out["mfu"] = {
        "flops_per_step": counted, "bench_analytic_flops": analytic,
        "embedding_term": embedding, "attention_bench_term":
            attention_bench, "attention_flash_term": attention_flash,
        "analytic_same_footing": same_footing,
        "rel_diff_same_footing": rel,
        "counted_over_bench": counted / analytic,
        "stats_mfu": st_a["mfu"], "peak_flops": st_a["peak_flops"],
        "stats_step_ms_avg": st_a["step_ms_avg"],
        "step_ms": ms_a, "tokens_per_s": tok_s,
        "mfu_from_tokens_per_s": tok_s * _gpt_flops_per_token(cfg, S)
        / PEAK_FLOPS["bfloat16"],
        "hbm": st_a["hbm"]}

    # (c) durability -----------------------------------------------------
    ck_dir = saver.directory
    with failpoints.scoped("ckpt/write=error:1"):
        try:
            saver.save_checkpoint(state_final, meta={"step": 6})
            raised = False
        except failpoints.FailpointError:
            raised = True
    leftovers = [f for _, _, fs in os.walk(ck_dir) for f in fs
                 if ".tmp." in f]
    swept = saver.sweep_tmp()
    f0 = os.path.join(saver._ckpt_dir(0), "state.pdparams")
    with open(f0, "rb") as f:
        _, verified = io._verify_footer(f, f0)
    check(raised and not leftovers and swept == 1 and verified
          and saver.get_checkpoint_numbers() == [0],
          f"runtime_services (c): the failed save raised ({raised}), left "
          f"no tmp file ({leftovers}), its staging directory swept "
          f"({swept}), checkpoint 0 verified ({verified})")
    t = time.perf_counter()
    saver.save_checkpoint(state_final, meta={"step": 6})
    save_ms.append((time.perf_counter() - t) * 1e3)
    ck_bytes = os.path.getsize(os.path.join(saver._ckpt_dir(1),
                                            "state.pdparams"))
    newest = os.path.join(saver._ckpt_dir(1), "state.pdparams")
    os.truncate(newest, ck_bytes // 2)
    recover = monitor.counter("checkpoint_recover_total",
                              labelnames=("reason",)).labels(reason="corrupt")
    n0 = recover.value
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, meta = saver.load_checkpoint()
    load_ms.append((time.perf_counter() - t) * 1e3)
    check(meta["step"] == 3 and recover.value == n0 + 1
          and saver.get_checkpoint_numbers() == [0],
          f"runtime_services (c): a torn newest checkpoint falls back to "
          f"the older one (meta {meta})")
    del state_final
    out["checkpoint"] = {"bytes": ck_bytes, "save_ms": save_ms,
                         "load_ms": load_ms,
                         "load_ms_is": "clean load of checkpoint 0; then "
                         "the fall-back load (the torn file's footer check "
                         "first)"}
    tmp.cleanup()

    # (d) exports ----------------------------------------------------------
    row = goodput.end_run()
    wall = row["wall_s"]
    booked = sum(row["buckets"].values())
    check(abs(booked - wall) <= 0.01 * wall and row["buckets"]["step"] > 0
          and row["buckets"]["ckpt_save"] > 0
          and row["buckets"]["ckpt_restore"] > 0,
          f"runtime_services (d): goodput buckets {row['buckets']} sum to "
          f"the run's wall time {wall}")
    doc = trace.export_chrome(None, include_host_events=False)
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    n_steps = sum(e["name"] == "train_step" for e in spans)
    saves = [e for e in spans if e["name"] == "checkpoint/save"]
    loads = [e for e in spans if e["name"] == "checkpoint/load"]
    check(n_steps == 9 and len(saves) == 3 and len(loads) >= 2
          and sum(bool(e["args"].get("error")) for e in saves) == 1,
          f"runtime_services (d): the Chrome trace holds one train_step "
          f"span a step (9: {n_steps}) and the checkpoint spans "
          f"({len(saves)} saves, {len(loads)} loads)")
    text = monitor.to_prometheus(monitor.snapshot())
    parsed = monitor.parse_prometheus(text)
    n_saves = parsed.get(("checkpoint_total", frozenset({("op", "save")})))
    check(n_saves is not None and n_saves >= 2,
          f"runtime_services (d): checkpoint_total{{op=save}} parses back "
          f"from the Prometheus text ({n_saves})")
    out["exports"] = {
        "chrome_events": len(doc["traceEvents"]), "train_step_spans":
            n_steps, "checkpoint_save_spans": len(saves),
        "checkpoint_load_spans": len(loads), "prometheus_bytes": len(text),
        "prometheus_samples": len(parsed),
        "checkpoint_total_save": n_saves,
        "goodput": {"wall_s": wall, "buckets": row["buckets"],
                    "booked_over_wall": booked / wall,
                    "goodput": row["goodput"]}}

    # (f) training overhead. Off and the defaults differ only in the
    # monitor, which a step reads as it runs: one trainer steps both, in
    # ABBA quads, so that neither its memory nor the host's drift falls on
    # one mode. Goodput is read at construction: trace + goodput steps a
    # trainer of its own, once every RUNTIME_OVERHEAD_TG_EVERY quads
    set_mode(*RUNTIME_MODES["off"])
    plain = trainer()[1]
    step(plain, batches[0])                  # warm-up
    set_mode(*RUNTIME_MODES["trace_goodput"])
    traced_tr = trainer()[1]
    step(traced_tr, batches[0])              # warm-up (trace: counted)
    train_ms = {mode: [] for mode in RUNTIME_MODES}
    quad_ratios = []
    for q in range(RUNTIME_OVERHEAD_QUADS):
        pair = ("off", "defaults") if q % 2 == 0 else ("defaults", "off")
        quad = {"off": 0.0, "defaults": 0.0}
        for i, mode in enumerate(pair + pair[::-1]):
            set_mode(*RUNTIME_MODES[mode])
            ms = step(plain, batches[(4 * q + i) % 6])[1]
            train_ms[mode].append(ms)
            quad[mode] += ms
        quad_ratios.append(quad["defaults"] / quad["off"] - 1)
        if q % RUNTIME_OVERHEAD_TG_EVERY == 0:
            set_mode(*RUNTIME_MODES["trace_goodput"])
            train_ms["trace_goodput"].append(
                step(traced_tr, batches[q % 6])[1])
    del plain, traced_tr
    torch.cuda.empty_cache()
    # what the defaults add to a training step, on the host's clock: the
    # monitor's check and one histogram observation (a registry of its
    # own, the step's histogram's shape)
    from paddle_tpu_torch.monitor.registry import StatRegistry
    set_mode(*RUNTIME_MODES["defaults"])
    hist = StatRegistry(enabled=True).histogram(
        "step_latency_ms", labelnames=("site",))
    n_hook = 100000
    t = time.perf_counter()
    for _ in range(n_hook):
        if monitor.is_enabled():
            hist.labels(site="trainer").observe(100.0)
    hook_us = (time.perf_counter() - t) / n_hook * 1e6

    # (e) + (f) the engine: three engines, one a mode, stepped in turns ---
    model = gpt2_model(GPT2_SMALL_CFG, 0, dev)
    prng = np.random.RandomState(0)
    lens = [int(prng.randint(32, 128)) for _ in range(SERVE_REQUESTS)]
    prompts = [prng.randint(0, V, (n,)).astype(np.int32) for n in lens]
    engines, rids, eng_ms = {}, {}, {}
    order = list(RUNTIME_MODES)
    for mode, flags in RUNTIME_MODES.items():
        set_mode(*flags)
        engines[mode] = ServingEngine(model, max_batch=SERVE_SLOTS,
                                      dtype="bfloat16")
        # a warm-up request first: the process's first calls at these
        # shapes pay one-time costs (one step of ~0.5 s on an H100)
        engines[mode].submit(prompts[0], max_new_tokens=2)
        engines[mode].run_until_complete()
    trace.clear()
    for mode, flags in RUNTIME_MODES.items():
        set_mode(*flags)
        rids[mode] = [engines[mode].submit(p, max_new_tokens=SERVE_NEW)
                      for p in prompts]
        eng_ms[mode] = []
    n = 0
    while any(e.has_work() for e in engines.values()):
        for mode in (order if n % 2 == 0 else order[::-1]):
            eng = engines[mode]
            if not eng.has_work():
                continue
            set_mode(*RUNTIME_MODES[mode])
            t = time.perf_counter()
            eng.step()
            eng_ms[mode].append((time.perf_counter() - t) * 1e3)
        n += 1
    toks = {mode: [list(engines[mode].get_request(r).output_ids)
                   for r in rids[mode]] for mode in RUNTIME_MODES}
    check(toks["off"] == toks["defaults"] == toks["trace_goodput"],
          "runtime_services (e): the engine's tokens are bit-equal with "
          "every flag off, the defaults and trace + goodput")
    on = engines["trace_goodput"]
    bd = on.stats()["breakdown"]
    kinds = bd["kinds"]
    decode = [k for k in kinds if k.startswith("decode")]
    check("prefill" in kinds and decode and all(
        kinds[k].get("device_flops_total", 0) > 0
        for k in ["prefill"] + decode),
          f"runtime_services (e): breakdown holds prefill and decode with "
          f"device_flops_total ({kinds})")
    traced = [on.get_request(r) for r in rids["trace_goodput"]]
    by_trace = {}
    for sp in trace.spans():
        by_trace.setdefault(sp.trace_id, set()).add(sp.name)
    check(all(r.stats()["trace_id"] and {"request", "queue_wait",
                                         "prefill", "decode"}
              <= by_trace.get(r.trace_id, set()) for r in traced),
          "runtime_services (e): every request has its trace_id and its "
          "request, queue_wait, prefill and decode spans")
    new_tokens = SERVE_REQUESTS * SERVE_NEW
    overhead = {
        "train_step_ms": {m: {"median": statistics.median(v),
                              "min": min(v), "max": max(v),
                              "sd": statistics.stdev(v), "steps": len(v),
                              "all": v}
                          for m, v in train_ms.items()},
        "train_quad_ratios": quad_ratios,
        "train_hook_us": hook_us,
        "engine_new_tok_per_s": {
            m: {"all_steps": new_tokens / (sum(v) / 1e3),
                "step_ms_median": statistics.median(v),
                "step_ms_min": min(v), "step_ms_max": max(v),
                "steps": len(v)}
            for m, v in eng_ms.items()}}
    # training: the quads' trimmed mean (see RUNTIME_OVERHEAD_QUADS);
    # the engine: the median steps (381 a mode; a mode's total carries its
    # prefills' outliers)
    ranked = sorted(quad_ratios)
    cut = int(len(ranked) * RUNTIME_OVERHEAD_TRIM)
    kept = ranked[cut:len(ranked) - cut]
    o_train = statistics.fmean(kept)
    o_train_median = (overhead["train_step_ms"]["defaults"]["median"]
                      / overhead["train_step_ms"]["off"]["median"] - 1)
    o_engine = (overhead["engine_new_tok_per_s"]["defaults"]["step_ms_median"]
                / overhead["engine_new_tok_per_s"]["off"]["step_ms_median"]
                - 1)
    overhead["defaults_cost"] = {
        "train_step_ms_quads_trimmed_mean": o_train,
        "train_quad_ratio_sd": statistics.stdev(quad_ratios),
        # the trimmed mean's standard error: the winsorized sample's sd
        # over (1 - 2 trim) sqrt(n)
        "train_quads_trimmed_mean_se": statistics.stdev(
            [ranked[cut]] * cut + kept + [ranked[len(ranked) - cut - 1]]
            * cut) / ((1 - 2 * RUNTIME_OVERHEAD_TRIM)
                      * len(ranked) ** 0.5),
        "train_step_ms_median": o_train_median,
        "engine_step_ms_median": o_engine}
    out["overhead"] = overhead
    out["engine"] = {"breakdown": bd, "spans": len(trace.spans()),
                     "requests_traced": len(traced)}
    del engines, on

    # (e) serving/slot=error:1 ends one request; the others keep the plain
    # tokens
    set_mode(True, True, False)
    eng = ServingEngine(model, max_batch=SERVE_SLOTS, dtype="bfloat16")
    rs = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    for _ in range(SERVE_NEW // 2):     # the first wave mid-decode
        eng.step()
    with failpoints.scoped("serving/slot=error:1"):
        eng.step()
    eng.run_until_complete()
    got = [eng.get_request(r) for r in rs]
    errs = [i for i, r in enumerate(got) if r.finish_reason == "error"]
    check(len(errs) == 1 and all(
        list(r.output_ids) == toks["off"][i]
        for i, r in enumerate(got) if i not in errs),
          f"runtime_services (e): serving/slot=error:1 ends one request "
          f"({errs}) and the other {len(got) - len(errs)} keep the plain "
          f"drain's tokens")
    out["engine"]["slot_error"] = {"errored": errs,
                                   "tokens_equal_plain": len(got) - 1}
    set_mode(True, False, False)            # the defaults again
    trace.clear()
    drop_gpt2_models()
    counts = _read_kernel_counts()
    for kind in ("fwd", "dq", "dkv", "delta"):
        check(counts.get(f"flash_{kind}:bfloat16", 0) > 0,
              f"runtime_services: flash_{kind} launched on the phase's "
              f"training path ({counts})")
    out["wall_s"] = time.perf_counter() - t_phase
    emit({"phase": "runtime_services", "batch": B, "seq": S,
          "dtype": "bfloat16 auto_cast", "optimizer": "AdamW lr 1e-4",
          "modes": {m: dict(zip(("monitor", "trace", "goodput"), f))
                    for m, f in RUNTIME_MODES.items()}, **out,
          "main_path_launches": counts})
    # (f)'s verdict after the phase's record, which carries its steps
    check(o_train <= RUNTIME_OVERHEAD_MAX and o_engine <= RUNTIME_OVERHEAD_MAX,
          f"runtime_services (f): the defaults cost at most "
          f"{RUNTIME_OVERHEAD_MAX:.0%} (training {o_train:+.2%}, engine "
          f"{o_engine:+.2%})")
    return counts


# the runtime services of the nineteenth slice on GPT-2 small (bench.py's
# training shapes, bf16 auto_cast, AdamW lr 1e-4, seed 0): (g) the
# numerics telescope, (h) the flight recorder, (i) the perf ledger, (j)
# the router. The armed/disarmed step ms are read from ABBA quads, as in
# runtime_services (f); RUNTIME_EXT_QUADS quads a pair of modes
RUNTIME_EXT_QUADS = 10
# (g): stats fetched every NUMERICS_INTERVAL armed steps in the sync check
# (the steps between fetches must sync no more often than the disarmed
# ones, which sync 2-3 times a step of their own); the
# fetched norms against a float64 recomputation from the same gradients and
# parameters within NUMERICS_F64_REL (fp32 sums over up to 38.6M elements,
# in another order), the max, absmax, counts and quantiles (selections of
# fp32 values, the quantiles' interpolation in fp32) within
# NUMERICS_F64_EXACT
NUMERICS_INTERVAL = 4
NUMERICS_F64_REL = 1e-4
NUMERICS_F64_EXACT = 1e-6
# (h): the sentinel's timeout and poll, the host stall (a serving/step
# delay) and the device stall (a spin enqueued on the engine's stream)
STALL_TIMEOUT_S, STALL_POLL_S = 0.5, 0.05
STALL_HOST_MS, STALL_DEVICE_S = 2000, 2.0
STALL_KINDS = ("host", "device")
STALL_NEW = 16
# (i): the engine's delay after its baseline, and the ledger's rows
LEDGER_DELAY_MS = 500
LEDGER_ENGINE_INTERVAL = 16
# (j): two engines, ROUTER_REQUESTS requests over ROUTER_SESSIONS sessions
# of ROUTER_NEW new tokens; the engine that fails raises at this step
ROUTER_REQUESTS, ROUTER_SESSIONS, ROUTER_NEW = 24, 6, 32
ROUTER_FAIL_AT = 3


def runtime_services_ext(dev):
    """The rest of the runtime services (monitor/numerics.py with
    testing/parity.py, monitor/blackbox.py, monitor/perfledger.py,
    serving/router.py) in SpmdTrainer and the ServingEngine on GPT-2
    small:

    (g) numerics: a disarmed and an armed trainer (fetching every
        NUMERICS_INTERVAL steps) over the same 5 batches give bit-equal
        losses and parameters; the steps between fetches sync no more than
        the disarmed ones (torch.cuda.set_sync_debug_mode("warn")); the
        fetch at step 4 against a float64 recomputation from the gradients
        and parameters of that step; peak GiB of each run alone; step ms
        armed (the default interval, 1) against disarmed in ABBA quads,
        and the recorder's cost on a trainer the same way;
    (h) the recorder: a GPT-2 small engine with the sentinel armed writes
        exactly one ``serving/step`` bundle for a host stall (a
        serving/step delay) and one for a device stall (a spin on the
        engine's stream before a step: the token read waits with the GIL
        released), each holding every in-flight request; the armed
        engine's step ms against disarmed, steps in ABBA turns;
    (i) the ledger: the trainer's rows (FLAGS_trace on: step ms, mfu and
        FLOPs from the cost registry), the engine's rows, and a
        serving/step delay after the baseline firing
        perf_regression_total{site=serving,metric=step_ms} exactly once;
    (j) the router: two engines, ROUTER_REQUESTS requests over
        ROUTER_SESSIONS sessions (affinity: a miss for each session's
        first request, hits after), then the same requests with engine
        "a" raising at its ROUTER_FAIL_AT-th step: its requests fail over
        to "b"; both runs' tokens against a plain engine's (equal, or
        each the greedy pick within ENGINE_TIE_BF16 along its own tokens).

    Returns the kernel launches and routes of the phase (counted from
    zero)."""
    import glob
    import os
    import tempfile
    import warnings

    import numpy as np
    import torch

    from paddle_tpu_torch import monitor, set_flags, trace
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainLoss)
    from paddle_tpu_torch.models.convert import linear_weights
    from paddle_tpu_torch.monitor import blackbox, numerics, perfledger
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import Router
    from paddle_tpu_torch.testing import failpoints

    t_phase = time.perf_counter()
    cfg = GPTConfig(**GPT2_SMALL_CFG)
    B, S, V = RUNTIME_BATCH, RUNTIME_SEQ, cfg.vocab_size
    rng = np.random.RandomState(0)
    batches = [[torch.as_tensor(rng.randint(0, V, (B, S)).astype(np.int32))
                .long().to(dev) for _ in range(2)] for _ in range(5)]
    monitor.enable()
    trace.disable()
    set_flags({"goodput": False, "numerics": False, "blackbox": False,
               "perf_ledger": False})
    tmp = tempfile.TemporaryDirectory()
    out = {}

    def trainer():
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(0))
        return model, SpmdTrainer(model, AdamW(
            learning_rate=1e-4, parameters=model.parameters()),
            loss_fn=GPTPretrainLoss())

    def step(tr, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with auto_cast(True, dtype="bfloat16"):
            loss = tr.train_step(*batch)
        loss.item()
        return loss, (time.perf_counter() - t) * 1e3

    def synced(tr, batch):
        """One step with every synchronizing CUDA call counted."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with auto_cast(True, dtype="bfloat16"):
                    loss = tr.train_step(*batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return loss, sum("synchroniz" in str(w.message) for w in seen)

    def abba(pair, run, quads):
        """run(mode) -> ms, in ABBA quads; the quads' ratios of the second
        mode's ms over the first's, trimmed mean as in (f)."""
        ms = {m: [] for m in pair}
        ratios = []
        for q in range(quads):
            order = pair if q % 2 == 0 else pair[::-1]
            quad = {m: 0.0 for m in pair}
            for mode in order + order[::-1]:
                t = run(mode)
                ms[mode].append(t)
                quad[mode] += t
            ratios.append(quad[pair[1]] / quad[pair[0]] - 1)
        ranked = sorted(ratios)
        cut = int(len(ranked) * RUNTIME_OVERHEAD_TRIM)
        return {"ms": {m: {"median": statistics.median(v), "all": v}
                       for m, v in ms.items()},
                "quad_ratios": ratios,
                "cost_trimmed_mean": statistics.fmean(
                    ranked[cut:len(ranked) - cut])}

    def bundles():
        return sorted(glob.glob(os.path.join(tmp.name, "bb",
                                             "blackbox-*.json")))

    _zero_counters()

    # (g) numerics ---------------------------------------------------------
    runs = {}
    for armed in (False, True):
        set_flags({"numerics": armed, "numerics_interval": NUMERICS_INTERVAL})
        model, tr = trainer()
        captured, want = {}, [False]
        if armed:
            real = tr._numerics_grad_leg

            def spy(grads, real=real):
                if want[0]:
                    captured.update({n: g.detach().clone()
                                     for n, g in grads.items()})
                return real(grads)

            tr._numerics_grad_leg = spy
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, syncs, f64 = [], [], None
        for i, batch in enumerate(batches):
            if i in (1, 2):                   # between fetches
                loss, n = synced(tr, batch)
                syncs.append(n)
            else:
                if i == 3:
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    want[0] = armed
                with auto_cast(True, dtype="bfloat16"):
                    loss = tr.train_step(*batch)
            losses.append(loss)
            if armed and i == 3:              # the fetch step
                want[0] = False
                f64 = _numerics_f64(tr, captured, tr._numerics_last_host,
                                    linear_weights(model), numerics)
                captured.clear()
        runs[armed] = {"losses": losses, "syncs": syncs, "peak_gib": peak,
                       "params": {n: p.detach().clone()
                                  for n, p in model.named_parameters()},
                       "fetches": tr._numerics.fetches if armed else 0,
                       "old_copy_gib": (tr._numerics_old[0].numel() * 4
                                        / 2 ** 30 if armed else 0.0)}
        del model, tr, captured
    set_flags({"numerics": False, "numerics_interval": 1})
    off, on = runs[False], runs[True]
    loss_equal = all(torch.equal(a, b) for a, b in zip(off["losses"],
                                                         on["losses"]))
    differ = [n for n in off["params"]
              if not torch.equal(off["params"][n], on["params"][n])]
    check(loss_equal and not differ,
          f"runtime_services_ext (g): armed and disarmed runs bit-equal "
          f"(losses {[x.item() for x in off['losses']]} vs "
          f"{[x.item() for x in on['losses']]}; parameters that differ: "
          f"{differ[:5]})")
    check(all(a <= d for a, d in zip(on["syncs"], off["syncs"]))
          and on["fetches"] == 1,
          f"runtime_services_ext (g): the armed steps between fetches sync "
          f"no more than the disarmed ones ({on['syncs']} vs "
          f"{off['syncs']}; fetches {on['fetches']})")
    check(f64["max_rel"]["norms"] <= NUMERICS_F64_REL
          and f64["max_rel"]["selections"] <= NUMERICS_F64_EXACT,
          f"runtime_services_ext (g): the fetched stats against float64 "
          f"({f64['max_rel']}, limits {NUMERICS_F64_REL} / "
          f"{NUMERICS_F64_EXACT})")
    del runs
    torch.cuda.empty_cache()
    # armed (the default interval) against disarmed, and the recorder's
    # trainer cost, each in ABBA quads over two resident trainers
    set_flags({"blackbox_dir": os.path.join(tmp.name, "bb"),
               "stall_timeout_s": 0.0})
    _, tr_off = trainer()
    set_flags({"numerics": True})
    _, tr_on = trainer()
    for tr in (tr_off, tr_on):
        step(tr, batches[0])                  # warm-up
    n_step = [0]

    def numerics_mode(mode):
        n_step[0] += 1
        set_flags({"numerics": mode == "armed"})
        tr = tr_on if mode == "armed" else tr_off
        return step(tr, batches[n_step[0] % 5])[1]

    numerics_cost = abba(("disarmed", "armed"), numerics_mode,
                         RUNTIME_EXT_QUADS)
    set_flags({"numerics_interval": NUMERICS_INTERVAL})
    numerics_cost_n = abba(("disarmed", "armed"), numerics_mode,
                           RUNTIME_EXT_QUADS)
    set_flags({"numerics": False, "numerics_interval": 1})
    del tr_on
    torch.cuda.empty_cache()

    def recorder_mode(mode):
        n_step[0] += 1
        set_flags({"blackbox": mode == "armed"})
        blackbox.sync_from_flag()
        return step(tr_off, batches[n_step[0] % 5])[1]

    recorder_train_cost = abba(("disarmed", "armed"), recorder_mode,
                               RUNTIME_EXT_QUADS)
    set_flags({"blackbox": False})
    blackbox.sync_from_flag()
    del tr_off
    torch.cuda.empty_cache()
    out["numerics"] = {
        "interval_in_sync_check": NUMERICS_INTERVAL,
        "bit_equal_losses_and_params": True,
        "losses": [x.item() for x in on["losses"]],
        "syncs_between_fetches": {"armed": on["syncs"],
                                  "disarmed": off["syncs"]},
        "peak_gib": {"armed": on["peak_gib"], "disarmed": off["peak_gib"]},
        "old_param_copy_gib": on["old_copy_gib"],
        "vs_float64": f64,
        "step_ms_abba_interval_1": numerics_cost,
        f"step_ms_abba_interval_{NUMERICS_INTERVAL}": numerics_cost_n}
    out["blackbox"] = {"trainer_step_ms_abba": recorder_train_cost}

    # (h) the recorder -------------------------------------------------------
    model = gpt2_model(GPT2_SMALL_CFG, 0, dev)
    prng = np.random.RandomState(0)
    prompts = [prng.randint(0, V, (int(prng.randint(32, 128)),))
               .astype(np.int32) for _ in range(ROUTER_REQUESTS)]
    set_flags({"blackbox": True})
    blackbox.sync_from_flag()
    eng = ServingEngine(model, max_batch=SERVE_SLOTS, dtype="bfloat16")
    eng.submit(prompts[0], max_new_tokens=2)          # warm-up
    eng.run_until_complete()
    blackbox.start_sentinel(timeout_s=STALL_TIMEOUT_S, poll_s=STALL_POLL_S)
    rids = [eng.submit(p, max_new_tokens=STALL_NEW) for p in prompts]
    for _ in range(3):
        eng.step()
    # the device's spin rate, for the device stall
    t0e, t1e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0e.record()
    torch.cuda._sleep(100 * SLEEP_CYCLES)
    t1e.record()
    t1e.synchronize()
    cycles_per_ms = 100 * SLEEP_CYCLES / t0e.elapsed_time(t1e)
    stalls = {}
    for kind in STALL_KINDS:
        in_flight = sorted(
            r for r in rids if not eng.get_request(r).finished)
        n0 = len(bundles())
        t = time.perf_counter()
        if kind == "host":
            with failpoints.scoped(f"serving/step=delay:{STALL_HOST_MS}"):
                eng.step()
        else:
            torch.cuda._sleep(int(STALL_DEVICE_S * 1e3 * cycles_per_ms))
            eng.step()
        step_s = time.perf_counter() - t
        new = bundles()[n0:]
        tables = []
        for path in new:
            with open(path) as f:
                b = json.load(f)
            tables.append((b["site"], b["reason"], [
                tb["table"]["in_flight"] for tb in b["requests"]
                if tb["kind"] == "serving_engine"
                and tb["table"]["slots"] == SERVE_SLOTS]))
        check(len(new) == 1 and tables[0][0] == "serving/step"
              and tables[0][1] == "stall" and in_flight in tables[0][2],
              f"runtime_services_ext (h): the {kind} stall ({step_s:.2f} s "
              f"in one step) wrote exactly one serving/step bundle holding "
              f"every in-flight request {in_flight} ({tables})")
        stalls[kind] = {"step_s": step_s, "bundles": len(new),
                        "in_flight": len(in_flight),
                        "bytes": os.path.getsize(new[0])}
    eng.run_until_complete()
    blackbox.stop_sentinel()
    # the armed engine's cost: one engine, steps in ABBA turns (the
    # sentinel runs throughout, with a 60 s timeout; disarmed, it idles)
    blackbox.start_sentinel(timeout_s=60.0)
    rids = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    eng_ms = {"disarmed": [], "armed": []}
    order = ("disarmed", "armed", "armed", "disarmed")
    n = 0
    while eng.has_work():
        mode = order[n % 4] if (n // 4) % 2 == 0 else order[::-1][n % 4]
        set_flags({"blackbox": mode == "armed"})
        blackbox.sync_from_flag()
        t = time.perf_counter()
        eng.step()
        eng_ms[mode].append((time.perf_counter() - t) * 1e3)
        n += 1
    blackbox.stop_sentinel()
    set_flags({"blackbox": False})
    blackbox.sync_from_flag()
    blackbox.uninstall_hooks()
    out["blackbox"].update({
        "stall_timeout_s": STALL_TIMEOUT_S, "stalls": stalls,
        "device_spin_cycles_per_ms": cycles_per_ms,
        "engine_step_ms": {m: {"median": statistics.median(v),
                               "steps": len(v)} for m, v in eng_ms.items()},
        "engine_cost_median": statistics.median(eng_ms["armed"])
        / statistics.median(eng_ms["disarmed"]) - 1})
    del eng

    # (i) the ledger -------------------------------------------------------
    path = os.path.join(tmp.name, "ledger.jsonl")
    set_flags({"perf_ledger": True, "perf_ledger_path": path,
               "perf_ledger_interval": 1})
    perfledger.reset_ledger()
    trace.enable()
    _, tr = trainer()
    for batch in batches[:4]:
        step(tr, batch)
    trace.disable()
    st = tr.stats()
    del tr
    torch.cuda.empty_cache()
    # the engine's rows every LEDGER_ENGINE_INTERVAL steps: a ledger on
    # the same file that reads the new interval
    set_flags({"perf_ledger_interval": LEDGER_ENGINE_INTERVAL})
    perfledger.reset_ledger()
    led = perfledger.get_ledger()
    eng = ServingEngine(model, max_batch=SERVE_SLOTS, dtype="bfloat16")
    for p in prompts[:SERVE_SLOTS]:
        eng.submit(p, max_new_tokens=SERVE_NEW)
    for _ in range(24):
        eng.step()
    while ("serving", "step_ms") in led._episode and eng.has_work():
        eng.step()
    fam = monitor.counter("perf_regression_total",
                          labelnames=("site", "metric"))
    before = fam.labels(site="serving", metric="step_ms").value
    with failpoints.scoped(f"serving/step=delay:{LEDGER_DELAY_MS}"):
        for _ in range(3):
            eng.step()
    fired = fam.labels(site="serving", metric="step_ms").value - before
    eng.run_until_complete()
    rows = perfledger.load_rows(path)
    train_rows = [r for r in rows if r["site"] == "trainer"]
    eng_rows = [r for r in rows if r["site"] == "serving"]
    steady = [r["metrics"] for r in train_rows if "cold" not in r["metrics"]]
    check(len(train_rows) == 4 and len(steady) == 3
          and all(m.get("mfu", 0) > 0
                  and m.get("flops_per_step") == st["flops_per_step"]
                  and m["step_ms"] > 0 for m in steady),
          f"runtime_services_ext (i): the trainer's rows carry step ms, mfu "
          f"and the cost registry's FLOPs ({train_rows})")
    check(eng_rows and all("decode_greedy_step_ms" in r["metrics"]
                           for r in eng_rows),
          f"runtime_services_ext (i): the engine's rows carry the per-kind "
          f"step ms ({[sorted(r['metrics']) for r in eng_rows]})")
    check(fired == 1, f"runtime_services_ext (i): a {LEDGER_DELAY_MS} ms "
          f"serving/step delay after the baseline fired "
          f"perf_regression_total{{site=serving,metric=step_ms}} {fired} "
          f"times, expected once")
    out["perf_ledger"] = {
        "trainer_rows": [r["metrics"] for r in train_rows],
        "engine_rows": len(eng_rows),
        "engine_row_metrics": eng_rows[-1]["metrics"],
        "env": rows[0]["env"],
        "delay_ms": LEDGER_DELAY_MS, "regressions_fired": fired,
        "regressions": list(led.regressions)}
    set_flags({"perf_ledger": False, "perf_ledger_path": "",
               "perf_ledger_interval": 1})
    perfledger.reset_ledger()
    del eng

    # (j) the router -------------------------------------------------------
    def engine():
        e = ServingEngine(model, max_batch=SERVE_SLOTS, dtype="bfloat16")
        e.submit(prompts[0], max_new_tokens=2)
        e.run_until_complete()
        return e

    plain_eng = engine()
    prids = [plain_eng.submit(p, max_new_tokens=ROUTER_NEW)
             for p in prompts]
    plain_eng.run_until_complete()
    plain = [list(plain_eng.get_request(r).output_ids) for r in prids]
    del plain_eng
    engines = {"a": engine(), "b": engine()}
    routed = {}
    for kind in ("affinity", "engine_error"):
        router = Router(engines)
        if kind == "engine_error":
            eng_a, calls = engines["a"], [0]

            def flaky(real=eng_a.step):
                calls[0] += 1
                if calls[0] == ROUTER_FAIL_AT:
                    raise RuntimeError("injected engine fault")
                return real()

            eng_a.step = flaky
        t = time.perf_counter()
        rrids = [router.submit(p, max_new_tokens=ROUTER_NEW,
                               session_id=f"s{i % ROUTER_SESSIONS}")
                 for i, p in enumerate(prompts)]
        res = router.run_until_complete()
        wall = time.perf_counter() - t
        if kind == "engine_error":
            del eng_a.step
        toks = [list(res[r].output_ids) for r in rrids]
        equal = sum(a == b for a, b in zip(toks, plain))
        gaps = None
        if equal < len(plain):
            gaps = teacher_forced_rows(model, prompts, toks,
                                       dtype="bfloat16")
        st = router.stats()["router"]
        routed[kind] = {"stats": st, "wall_s": wall,
                        "new_tok_per_s": ROUTER_REQUESTS * ROUTER_NEW / wall,
                        "requests_equal_plain": equal,
                        "max_gap": None if gaps is None
                        else float(gaps.max())}
        check(gaps is None or float(gaps.max()) <= ENGINE_TIE_BF16,
              f"runtime_services_ext (j) {kind}: every routed token the "
              f"plain engine's or the greedy pick within {ENGINE_TIE_BF16} "
              f"along its own tokens ({routed[kind]})")
    aff = routed["affinity"]["stats"]
    err = routed["engine_error"]["stats"]
    check(aff["affinity"]["hit"] == ROUTER_REQUESTS - ROUTER_SESSIONS
          and aff["affinity"]["miss"] == ROUTER_SESSIONS
          and set(aff["requests"]) == {"a", "b"},
          f"runtime_services_ext (j): a miss for each session's first "
          f"request, hits after, both engines used ({aff})")
    check(err["dead"] == ["a"] and err["failover"].get("engine_error", 0) > 0,
          f"runtime_services_ext (j): engine a's fault failed its requests "
          f"over to b ({err})")
    out["router"] = routed
    del engines, router
    drop_gpt2_models()
    tmp.cleanup()
    counts = _read_kernel_counts()
    for kind in ("fwd", "dq", "dkv", "delta"):
        check(counts.get(f"flash_{kind}:bfloat16", 0) > 0,
              f"runtime_services_ext: flash_{kind} launched on the phase's "
              f"training path ({counts})")
    out["wall_s"] = time.perf_counter() - t_phase
    emit({"phase": "runtime_services_ext", "batch": B, "seq": S,
          "dtype": "bfloat16 auto_cast", "optimizer": "AdamW lr 1e-4",
          **out, "main_path_launches": counts})
    return counts


def _numerics_f64(tr, grads, host, linear, numerics):
    """The fetched stats of one step against a float64 recomputation from
    the step's gradients (captured as the stats read them), its parameters
    after the update and the trainer's pre-update copy: the largest
    relative error over the norms (grad, param, update, rms, ratio) and
    over the selections (max, absmax, non-finite counts, quantiles)."""
    import torch

    names = sorted(tr.params)
    errs = {"norms": 0.0, "selections": 0.0}
    worst = {}

    def note(kind, key, got, want):
        got = torch.as_tensor(got, dtype=torch.float64)
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        if rel > errs[kind]:
            errs[kind] = rel
            worst[kind] = key
    want = {k: [] for k in ("grad_norm", "grad_rms", "grad_absmax",
                            "grad_max", "nonfinite", "param_norm",
                            "update_norm", "update_ratio", "quantiles")}
    qs32 = torch.tensor(numerics.QUANTILES, dtype=torch.float32)
    for i, n in enumerate(names):
        g = grads[n].double().reshape(-1)
        p = tr.params[n].detach().double().reshape(-1)
        old = tr._numerics_old[1][i].double().reshape(-1)
        gn = g.norm()
        want["grad_norm"].append(gn)
        want["grad_rms"].append(gn / g.numel() ** 0.5)
        want["grad_absmax"].append(g.abs().max())
        want["grad_max"].append(g.max())
        want["nonfinite"].append((~torch.isfinite(g)).sum().double())
        pn = p.norm()
        un = (p - old).norm()
        want["param_norm"].append(pn)
        want["update_norm"].append(un)
        want["update_ratio"].append(un / (pn + 1e-12))
        pos = torch.as_tensor(numerics._digest_positions(g.numel()),
                              device=g.device)
        if n in linear:                 # the reference's [in, out] order
            a, b = tr.params[n].shape
            pos = (pos % a) * b + pos // a
        # jnp.quantile's positions in fp32 (q (n - 1), its floor, ceil and
        # weight), the interpolation of the sorted values in float64
        srt = g[pos].abs().sort().values.cpu()
        at = qs32 * torch.tensor(float(len(srt) - 1), dtype=torch.float32)
        lo, hi = at.floor(), at.ceil()
        w = (at - lo).double()
        want["quantiles"].append(srt[lo.long()] * (1 - w)
                                 + srt[hi.long()] * w)
    for key, rows in want.items():
        w = torch.stack([r.cpu() for r in rows])
        kind = "norms" if key in ("grad_norm", "grad_rms", "param_norm",
                                  "update_norm", "update_ratio") \
            else "selections"
        note(kind, key, host[key], w)
    return {"max_rel": errs, "worst": worst, "layers": len(names)}


def train_recipes(dev):
    """The rest of GPT training (optimizer.lr, nn.clip, SpmdTrainer's
    recompute and gradient merge, amp.GradScaler): the narrow recipe against
    the JAX package's committed run, bench.py's gpt2m and gpt2s_16k as
    run_config builds them (:1156-1199), gpt2m under the recipe, and GPT-2
    small's fp16 eager loop under the loss scaler with its overflow
    control. Returns each full-size path's kernel launches (counted from
    zero just before it)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.amp import GradScaler, auto_cast
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainLoss, params_from_jax)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.functional import transformer as sdpa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import tpp
    from paddle_tpu_torch.testing import golden

    counts = {}

    def launches_now():
        return {**fa.launches, **tpp.launches}

    def delta_of(before):
        after = launches_now()
        return {k: n - before.get(k, 0) for k, n in after.items()
                if n != before.get(k, 0)}

    # ---- the narrow recipe against the JAX package's committed run ------
    fix = np.load(golden.RECIPE_FIXTURE)
    ids, labels = (torch.as_tensor(a, device=dev).long()
                   for a in golden.recipe_batch())
    L = golden.NARROW["num_layers"]
    runs = L * golden.RECIPE_ACCUM          # layer forwards a step

    def recipe(amp, clip=True):
        m = GPTForCausalLM(GPTConfig(**golden.NARROW), device=dev)
        m.load_state_dict(params_from_jax(golden.jax_layout_params()))
        sched = golden.recipe_schedule()
        opt = AdamW(learning_rate=sched, parameters=m.parameters(),
                    grad_clip=ClipGradByGlobalNorm(golden.RECIPE_CLIP)
                    if clip else None)
        tr = SpmdTrainer(m, opt, loss_fn=GPTPretrainLoss(),
                         accumulate_steps=golden.RECIPE_ACCUM,
                         recompute=True)
        out = {"losses": [], "lrs": [], "norms": [], "launches": []}
        for _ in range(golden.RECIPE_STEPS):
            out["lrs"].append(opt.get_lr())
            before = launches_now()
            with auto_cast(amp, dtype="bfloat16"):
                out["losses"].append(float(tr.train_step(ids, labels)))
            out["launches"].append(delta_of(before))
            if clip:
                out["norms"].append(float(opt._global_norm))
            sched.step()
        out["rows"] = golden.port_kept_rows(dict(m.named_parameters()))
        return out

    narrow = {}
    for tag, amp in (("fp32", False), ("bf16", True)):
        dname = "bfloat16" if amp else "float32"
        want_rows = {n: fix[f"rows_{tag}__{n}"] for n in golden.KEPT_PARAMS}
        for on in (False, True):
            set_flags({"tpp_kernels": on})
            r = recipe(amp)
            # the forward and its recompute launch the flash forward (and
            # the TPP kernels); the backward launches once a layer and
            # micro-batch
            want = {f"flash_fwd:{dname}": 2 * runs,
                    **{f"flash_{k}:{dname}": runs
                       for k in ("delta", "dq", "dkv")}}
            if on:
                want.update({k: 2 * runs for k in (
                    "tpp_matmul.ln:float32", "tpp_matmul.in_act:float32",
                    "tpp_row_stats:float32")})
            check(all(d == want for d in r["launches"]),
                  f"narrow recipe {tag} tpp={on}: launches a step "
                  f"{r['launches']}, expected {want}")
            check(r["lrs"] == fix["lr"].tolist(),
                  f"narrow recipe: the schedule's rates {r['lrs']}")
            check(all(n > golden.RECIPE_CLIP for n in r["norms"]),
                  f"narrow recipe: the clip binds at every step "
                  f"({r['norms']} > {golden.RECIPE_CLIP})")
            norm_err = float(np.max(np.abs(np.asarray(r["norms"])
                                           / fix[f"norm_{tag}"] - 1)))
            loss_err = float(np.abs(np.asarray(r["losses"])
                                    - fix[f"loss_{tag}"]).max())
            row_err = max(float(np.abs(r["rows"][n] - want_rows[n]).max())
                          for n in want_rows)
            update_err = golden.update_rel_err(r["rows"], want_rows)
            key = f"{tag}_tpp_{'on' if on else 'off'}"
            narrow[key] = {"losses": r["losses"], "lrs": r["lrs"],
                           "norms": r["norms"], "loss_err": loss_err,
                           "norm_rel_err": norm_err,
                           "row_max_abs_err": row_err,
                           "update_rel_err": update_err,
                           "kept_rows_head": {
                               n: np.ravel(r["rows"][n])[:4].tolist()
                               for n in want_rows},
                           "launches_per_step": r["launches"][0]}
            if amp:
                ok = loss_err <= TRAIN_BF16_LOSS_TOL and norm_err <= 0.02 \
                    and update_err <= golden.TRAIN_BF16_UPDATE_RTOL
            else:
                ok = loss_err <= TRAIN_FP32_TOL and norm_err <= 1e-4 \
                    and row_err <= TRAIN_FP32_TOL
            check(ok, f"narrow recipe {key} vs JAX: {narrow[key]}")
    set_flags({"tpp_kernels": False})
    # the control: the same run without the clip fails the row check
    r = recipe(False, clip=False)
    control = max(float(np.abs(r["rows"][n] - fix[f"rows_fp32__{n}"]).max())
                  for n in golden.KEPT_PARAMS)
    check(control > TRAIN_FP32_TOL,
          f"the recipe without its clip fails the fp32 row check: {control}")
    emit({"phase": "gpt_narrow_recipe_vs_jax_fixture",
          "recipe": "AdamW under LinearWarmup(CosineAnnealingDecay("
                    f"{golden.RECIPE_LR}, T_max={golden.RECIPE_STEPS}), "
                    f"warmup_steps={golden.RECIPE_WARMUP}, 0 -> "
                    f"{golden.RECIPE_LR}), ClipGradByGlobalNorm("
                    f"{golden.RECIPE_CLIP}), accumulate_steps="
                    f"{golden.RECIPE_ACCUM}, recompute=True",
          "batch": golden.RECIPE_BATCH, "seq": golden.SEQ, **narrow,
          "no_clip_control_row_max_abs_err": control,
          "jax_losses": {t: fix[f"loss_{t}"].tolist() for t in
                         ("fp32", "bf16")},
          "jax_norms": {t: fix[f"norm_{t}"].tolist() for t in
                        ("fp32", "bf16")},
          "tol": {"fp32_loss_and_rows": TRAIN_FP32_TOL,
                  "fp32_norm_rel": 1e-4, "bf16_loss": TRAIN_BF16_LOSS_TOL,
                  "bf16_norm_rel": 0.02,
                  "bf16_update_rel_err": golden.TRAIN_BF16_UPDATE_RTOL}})

    # ---- gpt2m, gpt2s_16k and gpt2m under the recipe ---------------------
    gpt2m = GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                      num_heads=16, max_seq_len=1024, dropout=0.0)
    gpt2s_16k = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                          num_heads=12, max_seq_len=16384, dropout=0.0)
    peaks = {}

    def bench_train(phase, cfg, batch, seq, config, recipe_on=False):
        torch.cuda.empty_cache()
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(0))
        kwargs, sched, opt_kw = {}, None, {}
        if recipe_on:
            sched = golden.recipe_schedule()
            opt_kw = dict(grad_clip=ClipGradByGlobalNorm(golden.RECIPE_CLIP))
            kwargs = dict(accumulate_steps=golden.RECIPE_ACCUM,
                          recompute=True)
        opt = AdamW(learning_rate=sched if recipe_on else 1e-4,
                    parameters=model.parameters(), **opt_kw)
        trainer = SpmdTrainer(model, opt, loss_fn=GPTPretrainLoss(),
                              **kwargs)
        batch_t = _gpt_bench_batch(cfg, batch, seq, dev)
        losses, lrs, norms, per_step = [], [], [], []

        def step():
            before = launches_now()
            lrs.append(opt.get_lr())
            with auto_cast(True, dtype="bfloat16"):
                loss = trainer.train_step(*batch_t)
            per_step.append(_flash_step_counts(delta_of(before)))
            if sched is not None:
                norms.append(opt._global_norm)      # read after the run
                sched.step()
            return loss

        _zero_counters()
        losses_t = []
        row, trace = _timed_training(
            lambda: losses_t.append(step()), MODEL_STEPS_TIMED,
            group=kernel_group)
        counts[phase] = _read_kernel_counts()
        losses = [float(x) for x in losses_t]
        norms = [float(x) for x in norms]
        runs = cfg.num_layers * (golden.RECIPE_ACCUM if recipe_on else 1)
        want = {"flash_fwd:bfloat16": (2 if recipe_on else 1) * runs,
                **{f"flash_{k}:bfloat16": runs
                   for k in ("delta", "dq", "dkv")}}
        check(all(d == want for d in per_step),
              f"{phase}: flash launches a step {per_step[0]}, expected "
              f"{want}")
        check(all(math.isfinite(x) for x in losses),
              f"{phase}: finite losses {losses}")
        check(trace.get("kernels", 0) > 0,
              f"{phase}: the profiled step ran on the device")
        tok_s = batch * seq / (row["step_ms"] / 1e3)
        flops = _gpt_flops_per_token(cfg, seq)
        peaks[phase] = row["max_memory_allocated_gb"]
        out = {"phase": phase, "config": config, "batch": batch, "seq": seq,
               "layers": cfg.num_layers, "hidden": cfg.hidden_size,
               "heads": cfg.num_heads, "auto_cast": "bfloat16", **row,
               "tokens_per_s": tok_s, "flops_per_token": flops,
               "mfu": tok_s * flops / PEAK_FLOPS["bfloat16"],
               "mfu_peak": "989 TFLOP/s bfloat16 dense", "losses": losses,
               "flash_launches_per_step": per_step[0], "profiled": trace,
               "main_path_launches": counts[phase]}
        if recipe_on:
            out.update({"optimizer": "AdamW under the narrow recipe's "
                        "schedule and ClipGradByGlobalNorm("
                        f"{golden.RECIPE_CLIP}), accumulate_steps="
                        f"{golden.RECIPE_ACCUM}, recompute=True",
                        "lrs": lrs, "global_norms": norms})
        else:
            out["optimizer"] = "AdamW lr 1e-4"
        del model, trainer, opt, batch_t
        torch.cuda.empty_cache()
        return out

    emit(bench_train("gpt2m_train", gpt2m, 8, 1024,
                     "bench.py gpt2m (_gpt2m_cfg :268)"))
    emit(bench_train("gpt2s_16k_train", gpt2s_16k, 1, 16384,
                     "bench.py gpt2s_16k (_gpt2s_cfg, seq 16384)"))
    row = bench_train("gpt2m_recipe", gpt2m, 8, 1024,
                      "bench.py gpt2m under the recipe", recipe_on=True)
    row["peak_gb_vs_gpt2m_train"] = [peaks["gpt2m_recipe"],
                                     peaks["gpt2m_train"]]
    check(peaks["gpt2m_recipe"] < peaks["gpt2m_train"],
          f"recompute lowers gpt2m's peak memory: "
          f"{row['peak_gb_vs_gpt2m_train']}")
    emit(row)

    # ---- GPT-2 small, fp16 eager loop under the loss scaler --------------
    cfg = GPTConfig(hidden_size=768, num_layers=12, num_heads=12,
                    dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = GradScaler()
    ids, labels = _gpt_bench_batch(cfg, FP16_BATCH, 1024, dev)
    losses, scales, found = [], [], []

    def fp16_step():
        with auto_cast(True, dtype="float16"):
            loss = model.loss(ids, labels)
        scaler.minimize(opt, scaler.scale(loss))
        losses.append(loss)
        scales.append(scaler._scale)

    w0 = model.gpt.wte.weight.detach().clone()
    _zero_counters()
    row, trace = _timed_training(fp16_step, MODEL_STEPS_TIMED,
                                 group=kernel_group)
    counts["gpt2_fp16_scaler"] = _read_kernel_counts()
    routes = dict(sdpa.routes)
    losses = [float(x) for x in losses]
    steps = MODEL_STEPS_TIMED + 2     # the warm-up and the profiled step
    check(not any(k.startswith("flash_")
                  for k in counts["gpt2_fp16_scaler"]),
          f"fp16: no flash launch ({counts['gpt2_fp16_scaler']})")
    check(routes.get("naive", 0) == cfg.num_layers * steps
          and not routes.get("flash"),
          f"fp16: every attention call on SDPA's naive route ({routes})")
    check(all(math.isfinite(x) for x in losses),
          f"fp16: finite losses {losses}")
    check(not torch.equal(model.gpt.wte.weight, w0),
          "fp16: the scaled steps moved the weights")
    # the control: at 2^40 the fp16 scaled loss overflows, every step is
    # skipped (parameters and moments bit-equal) and the scale halves
    # after decr_every_n_nan_or_inf bad steps
    params0 = [p.detach().clone() for p in model.parameters()]
    state0 = {k: v.clone() for k, v in opt.state_dict().items()
              if isinstance(v, torch.Tensor)}
    big = GradScaler(init_loss_scaling=2.0 ** 40)
    big_scales = []
    for _ in range(big._decr_every):
        with auto_cast(True, dtype="float16"):
            loss = model.loss(ids, labels)
        scaled = big.scale(loss)
        scaled.backward()
        big.unscale_(opt)
        found.append(big._found_inf)
        big.update()
        opt.clear_grad()
        big_scales.append(big._scale)
    state = opt.state_dict()
    check(all(found) and big_scales[-1] == 2.0 ** 39
          and all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                    params0))
          and all(torch.equal(state[k], v) for k, v in state0.items()),
          f"fp16 overflow control: skipped ({found}), parameters and "
          f"moments bit-equal, scale {big_scales}")
    tok_s = FP16_BATCH * 1024 / (row["step_ms"] / 1e3)
    emit({"phase": "gpt2_small_fp16_grad_scaler",
          "batch": FP16_BATCH, "seq": 1024,
          "loop": "auto_cast(float16); loss = model.loss(ids, labels); "
                  "scaler.minimize(opt, scaler.scale(loss))",
          "optimizer": "AdamW lr 1e-4", **row, "tokens_per_s": tok_s,
          "mfu": tok_s * _gpt_flops_per_token(cfg, 1024)
          / PEAK_FLOPS["bfloat16"],
          "mfu_peak": "989 TFLOP/s (fp16 dense = bf16 dense)",
          "losses": losses, "scales": scales,
          "inf_steps": steps - opt._step_count,
          "sdpa_routes": routes, "profiled": trace,
          "overflow_control": {"init_loss_scaling": 2.0 ** 40,
                               "found_inf": found, "scales": big_scales,
                               "params_and_moments_bit_equal": True},
          "main_path_launches": counts["gpt2_fp16_scaler"]})
    del model, opt
    torch.cuda.empty_cache()
    return counts


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
    _mark("1 build")
    t0 = time.perf_counter()
    seconds = _build.build()
    wall = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_report(name) for name in _build.sources()}
    sass = {name: _build.sass_counts(name) for name in _build.sources()}
    emit({"phase": "build", "wall_s": wall, "nvcc_s": seconds,
          "ptxas": ptxas, "sass_tensor_core_instructions": sass})
    # the redesigned kernels run on the tensor cores (wgmma in the bf16
    # TPP, mma.sync in the bf16 flash forward and backward pair, mma.sync
    # on TF32 operands in the fp32 forward and backward pair) and no kernel
    # spills; every flash kernel is one of the tensor-core ones (the scalar
    # kernels are gone)
    for name, op in (("tpp_matmul", "HGMMA"), ("flash_fwd", "HMMA"),
                     ("flash_fwd", "HMMA.TF32"), ("flash_bwd", "HMMA"),
                     ("flash_bwd", "HMMA.TF32")):
        check(sass[name][op] > 0, f"{name}: {op} instructions in its SASS")
        spills = {k: r for k, r in ptxas[name].items() if r["spill_bytes"]}
        check(not spills, f"{name}: no register spills ({spills})")
    scalar = [k for name in ("flash_fwd", "flash_bwd") for k in ptxas[name]
              if not re.search(r"_(mma|tf32|stream)_kernel|flash_delta_kernel",
                               k)]
    check(not scalar, f"flash_fwd and flash_bwd: only tensor-core kernels and "
          f"the delta pre-pass ({scalar})")
    nms_kernels = {k: r for k, r in ptxas["nms"].items()}
    check(len(nms_kernels) == 3 and all(
        re.search(r"nms_(smem|mask|sweep)_kernel", k) for k in nms_kernels)
        and not any(r["spill_bytes"] for r in nms_kernels.values()),
          f"nms: the smem, mask and sweep kernels built without spills "
          f"({nms_kernels})")
    tf32_kernels = {k: r for name in ("flash_fwd", "flash_bwd")
                    for k, r in ptxas[name].items() if "_tf32_kernel" in k}
    check(len(tf32_kernels) == 6 and not any(
        r["spill_bytes"] for r in tf32_kernels.values()),
          f"flash_fwd and flash_bwd: the TF32 forward, dQ and dK/dV kernels "
          f"at head_dim 64 and 128 built without spills ({tf32_kernels})")
    # the streaming route (the bf16 forward from head_dim 320, the bf16
    # backward and fp32 from 192, everything above 512): the forward, dQ and
    # dK/dV kernels in both types, a column group a block (12: their own
    # tiles resident or streamed) or two (7: the tiles resident where they
    # fit at head dims up to 512, streamed in the fp32 forward and dQ),
    # each on the tensor cores (HMMA in bf16, TF32 HMMA in fp32) without
    # spills
    stream_kernels = {}
    for name in ("flash_fwd", "flash_bwd"):
        by_kernel = _build.kernel_sass_counts(name)
        for k, r in ptxas[name].items():
            m = re.search(r"(flash_(?:fwd|dq|dkv)_stream_kernel)I(f|13__nv_"
                          r"bfloat16)Lb([01])ELi(\d)E", k)
            if m is None:
                continue
            op = "HMMA.TF32" if m[2] == "f" else "HMMA"
            stream_kernels[f"{m[1]}[{'float32' if m[2] == 'f' else 'bfloat16'}"
                           f"{', resident' if m[3] == '1' else ''}, "
                           f"{m[4]} warpgroups]"] = {
                **r, op: by_kernel.get(k, {}).get(op, 0)}
    check(len(stream_kernels) == 19 and all(
        not r["spill_bytes"] and r.get("HMMA", r.get("HMMA.TF32")) > 0
        for r in stream_kernels.values()),
          f"the 19 streaming kernels on the tensor cores without spills "
          f"({stream_kernels})")
    emit({"phase": "build_stream_kernels", "kernels": stream_kernels})

    # ---- 2. every kernel against its plain version ------------------------
    _mark("2 every kernel against its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    flash_err = {}
    n_flash = 0
    tf32_err = 0.0
    # the streaming kernels' largest error at the wide heads (o; dq; dk
    # and dv), by dtype
    wide_errs = {dname: {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
                 for dname in dtypes}
    shapes = [(s, d) for s in (1024, 2048) for d in (64, 128)] \
        + [(1024, d) for d in WIDE_HEAD_DIMS]
    fa.routes.clear()
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
                if flash_route("fwd", dname, d) == "stream":
                    wide_errs[dname]["fwd"] = max(wide_errs[dname]["fwd"], eo)
                check(eo <= FLASH_TOL[dname] and el <= LSE_TOL,
                      f"flash s={s} d={d} {dname} causal={causal} "
                      f"window={window}: o err {eo}, lse err {el}")
                if dname == "float32":  # three TF32 passes on every route
                    eo /= max(1.0, ro.abs().max().item())
                    tf32_err = max(tf32_err, eo, el)
                    check(eo <= TF32X3_FWD_TOL and el <= TF32X3_FWD_TOL,
                          f"flash s={s} d={d} fp32 on "
                          f"{flash_route('fwd', dname, d)} causal={causal} "
                          f"window={window}: o err / max(1, max|plain|) "
                          f"{eo}, lse err {el} > {TF32X3_FWD_TOL}")
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
                if b == TRAIN_BATCH:   # every block writes only its rows
                    check(torch.equal(o, fa.flash_attention(
                        q, k, v, causal=True)),
                          f"flash main shape b={b} {dname}: two calls, "
                          f"the same bits")
            ro = fa._unheads(ro, b, h)
            err = (o.float() - ro.float()).abs().max().item()
            flash_err[dname][b] = err
            check(err <= FLASH_TOL[dname],
                  f"flash main shape b={b} {dname}: err {err}")
            if dname == "float32":
                err /= max(1.0, ro.abs().max().item())
                tf32_err = max(tf32_err, err)
                check(err <= TF32X3_FWD_TOL, f"flash main shape b={b} fp32 "
                      f"on tf32x3: err / max(1, max|plain|) {err}")
            del qkv, q, k, v, o, ro
    # the configs' forward launches by route: bf16 on mma up to head_dim
    # 256, fp32 on the TF32 kernel at 64 and 128, the streaming kernels
    # elsewhere; the main shape's three calls a dtype on the tensor cores
    fwd_routes = {k: n for k, n in fa.routes.items() if n}
    want_routes = {}
    for _, d in shapes:
        for dname in dtypes:
            key = f"flash_fwd:{dname}:{flash_route('fwd', dname, d)}"
            want_routes[key] = want_routes.get(key, 0) + 3
    for dname, route in (("bfloat16", "mma"), ("float32", "tf32x3")):
        want_routes[f"flash_fwd:{dname}:{route}"] += 3
    check(fwd_routes == want_routes, f"flash forward launches by route "
          f"{fwd_routes}, expected {want_routes}")
    # SDPA sends every shape its gate passes to the kernel: the wide heads
    # launch it
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    for d in (192, 256, 320, 512):
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
    # above 512 no whole-head tiling fits, and at 320 and 512 the head is
    # wider than the other routes take: SDPA's forward and backward take
    # the streaming route (at b1 h2 and 320 a column group a block, its
    # grid under one wave of the SMs; at 512 two groups a block), held
    # against the plain forward and autograd through it; two backward
    # calls give the same bits (no atomics)
    fa.routes.clear()
    fa.launches.clear()
    stream_err = {}
    t_stream = time.perf_counter()
    for d in (320, 512, *STREAM_HEAD_DIMS):
        for dname, dt in dtypes.items():
            q, k, v, do = (randn(1, 1024, 2, d, dtype=dt) for _ in range(4))
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = scaled_dot_product_attention(*leaves, is_causal=True)
            got = torch.autograd.grad(o, leaves, do, retain_graph=True)
            again = torch.autograd.grad(o, leaves, do)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"SDPA head_dim {d} {dname}: two streaming backward "
                  f"calls, the same bits")
            ref = [t.clone().float().requires_grad_() for t in (q, k, v)]
            ro = fa._unheads(fa.flash_attention_ref(
                *(fa._heads(t) for t in ref), True, 1.0 / math.sqrt(d))[0],
                1, 2)
            want = torch.autograd.grad(ro, ref, do.float())
            eo = (o.float() - ro).abs().max().item()
            eg = max((g.float() - w).abs().max().item()
                     / max(1.0, w.abs().max().item())
                     for g, w in zip(got, want))
            stream_err[f"d{d}[{dname}]"] = {"o": eo, "grads_rel": eg}
            check(eo <= FLASH_TOL[dname] and eg <= FLASH_TOL[dname],
                  f"SDPA head_dim {d} {dname} vs plain: o err {eo}, grads "
                  f"err / max(1, max|plain|) {eg}")
            del q, k, v, do, leaves, o, got, again, ref, ro, want
    # the forward with its query tiles streamed too: at b4 h16 d1024 the
    # grid (4,096 bf16 blocks) is over two blocks an SM and two resident
    # blocks do not fit one, so flash_stream.cuh's `resident` streams them
    # (fp32 at d1024 always does); causal and full attention
    sb, sh, sd = STREAM_CHECKED_STREAMED
    streamed_err = {}
    for dname, dt in dtypes.items():
        q, k, v = (randn(sb, 1024, sh, sd, dtype=dt) for _ in range(3))
        for causal in (True, False):
            with torch.no_grad():
                o = scaled_dot_product_attention(q, k, v, is_causal=causal)
                ro = fa._unheads(fa.flash_attention_ref(
                    *(fa._heads(t).float() for t in (q, k, v)), causal,
                    1.0 / math.sqrt(sd))[0], sb, sh)
            eo = (o.float() - ro).abs().max().item()
            streamed_err[f"{'causal' if causal else 'full'}[{dname}]"] = eo
            check(eo <= FLASH_TOL[dname],
                  f"SDPA b{sb} h{sh} head_dim {sd} {dname} causal={causal} "
                  f"(query tiles streamed) vs plain: o err {eo}")
            del o, ro
        del q, k, v
    stream_routes = flash_routes_checked(
        f"SDPA head_dim 320, 512, {', '.join(map(str, STREAM_HEAD_DIMS))}",
        stream=True)
    stream_s = time.perf_counter() - t_stream
    emit({"phase": "kernels_vs_plain", "kernel": "flash_fwd",
          "configs": n_flash + 4, "shapes_s_d": shapes,
          "main_shape_s_h_d": [1024, 12, 64],
          "main_shape_max_abs_err_by_batch": flash_err,
          "sdpa_head_dim_192_256_320_512_launched": True,
          "sdpa_stream_route_b1_s1024_h2_causal": stream_err,
          f"sdpa_stream_route_b{sb}_s1024_h{sh}_d{sd}_fwd_o_err": streamed_err,
          "stream_grads_two_calls_bit_equal": True,
          "stream_checks_wall_s": stream_s,
          "routes_of_the_configs": fwd_routes,
          "main_shape_two_calls_bit_equal": True,
          "stream_routes": stream_routes,
          "fp32_tf32x3_max_err": tf32_err,
          "tol": {"o": FLASH_TOL, "lse": LSE_TOL,
                  "fp32_tf32x3_o_x_max(1,max|plain|)_and_lse": TF32X3_FWD_TOL,
                  "stream_grads": "FLASH_TOL x max(1, max|plain|)"}})

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
        # the new tiles' edges: M not a multiple of 128, N not one of the
        # column tile, K a multiple of 8 (TMA in bf16) or not (the CUDA-core
        # path), w k-major and n-major, the LN prologue on each
        for m_e, k_e, n_e in ((300, 776, 1000), (130, 100, 300)):
            xe = randn(m_e, k_e, dtype=dt)
            lin = randn(n_e, k_e, dtype=dt, std=0.05)
            be = randn(n_e, dtype=dt, std=0.05)
            ge, bte = 1.0 + randn(k_e, dtype=dt, std=0.1), \
                randn(k_e, dtype=dt, std=0.1)
            for w_e in (lin.t(), lin.t().contiguous()):
                got = tpp._launch(xe, w_e, be, "gelu", "none", ge, bte)
                tpp_err(got, tpp._matmul_ref(xe, w_e, be, "gelu", "none", ge,
                                             bte), dname,
                        f"edges [{m_e},{k_e}]@[{k_e},{n_e}] strides "
                        f"{w_e.stride()}")
        # the LN pre-pass against its plain version
        stats, want = tpp._row_stats(x), tpp._row_stats_ref(x)
        errs["row_stats"] = max(
            (stats[0] - want[0]).abs().max().item(),
            ((stats[1] - want[1]) / want[1]).abs().max().item())
        check(errs["row_stats"] <= 1e-5, f"tpp row stats {dname}: "
              f"{errs['row_stats']}")
        torch.cuda.synchronize()
        tpp_errs[dname] = errs
    emit({"phase": "kernels_vs_plain", "kernel": "tpp_matmul",
          "shapes": [[M, H, I], [M, I, H], [M_TRAIN, H, I], [M_TRAIN, I, H],
                     [200, 72, 136], [300, 776, 1000], [130, 100, 300]],
          "row_stats_tol": "1e-5 (mean abs, rstd relative)",
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
    want_bwd = {}   # dQ and dK/dV launches by route
    wide_bits = {}  # two backward calls at the wide heads: the same bits
    fa.routes.clear()
    for s, d in shapes:
        for dname, dt in dtypes.items():
            for causal, window in ((False, None), (True, None),
                                   (True, 100)):
                for kind in ("dq", "dkv"):
                    key = f"flash_{kind}:{dname}:{flash_route(kind, dname, d)}"
                    want_bwd[key] = want_bwd.get(key, 0) + (
                        2 if causal and window is None else 1)
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
                if flash_route("dq", dname, d) == "stream":
                    for kind, part in (("dq", slice(0, 1)),
                                       ("dkv", slice(1, 3))):
                        wide_errs[dname][kind] = max(
                            wide_errs[dname][kind],
                            bwd_err(got[part], plain[part], dname)[0])
                if d in WIDE_TIMED_DIMS and window is not None:
                    # every block writes only its own tile: no atomics
                    again = fa._flash_bwd(q, k, v, o, lse, do, causal, scale,
                                          window=window)
                    want_bwd[f"flash_dq:{dname}:stream"] += 1
                    want_bwd[f"flash_dkv:{dname}:stream"] += 1
                    wide_bits[f"d{d}[{dname}]"] = all(
                        torch.equal(x, y) for x, y in zip(got, again))
                    check(wide_bits[f"d{d}[{dname}]"], f"flash bwd d={d} "
                          f"{dname}: two calls, the same bits")
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
    # every call on the tensor cores: at head_dim 64 and 128 bf16 on mma,
    # fp32 on the TF32 kernels, from 192 both on the streaming kernels
    bwd_routes = {k: n for k, n in fa.routes.items() if n}
    check(bwd_routes == want_bwd, f"flash bwd launches by route "
          f"{bwd_routes}, expected {want_bwd}")
    # the training path's call, at its shape: grads of strided q/k/v views
    # of one packed qkv through the autograd Function, against autograd
    # through the plain forward
    # (twice through the kernels: the grads must be bit-equal), and the
    # delta pre-pass against the torch expression on the forward's o
    bwd_errs, delta_errs = {}, {}
    b, s, h, d = TRAIN_BATCH, 1024, 12, 64
    for dname, dt in dtypes.items():
        qkv = randn(b, s, 3 * h * d, dtype=dt)
        do = randn(b, s, h, d, dtype=dt)
        grads = []
        for use_kernel in (True, True, False):
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
        check(torch.equal(grads[0], grads[1]),
              f"flash bwd main shape {dname}: two calls, the same bits")
        got, want = (g.split(h * d, dim=-1) for g in (grads[0], grads[2]))
        bwd_errs[dname] = {
            "dq": bwd_err(got[:1], want[:1], dname)[0],
            "dkv": bwd_err(got[1:], want[1:], dname)[0]}
        check(bwd_err(got, want, dname)[1],
              f"flash bwd main shape {dname}: err {bwd_errs[dname]}")
        with torch.no_grad():
            o = fa.flash_attention(q, k, v, causal=True)
            delta = fa._launch_delta(o, do)
            want = (do.float() * o.float()).sum(-1).transpose(1, 2) \
                .reshape(b * h, s)
        torch.cuda.synchronize()
        delta_errs[dname] = (delta - want).abs().max().item()
        check(delta_errs[dname] <= DELTA_TOL * max(
            1.0, want.abs().max().item()),
              f"flash delta pre-pass {dname}: err {delta_errs[dname]}")
        del qkv, do, grads, got, want, packed, q, k, v, o, delta
    emit({"phase": "kernels_vs_plain", "kernel": "flash_dq+flash_dkv",
          "configs": n_bwd + 2, "shapes_s_d": shapes,
          "against": ["flash_attention_bwd_ref", "autograd through "
                      "flash_attention_ref"],
          "external_delta_checked": True,
          "main_shape": [b, s, h, d],
          "main_shape_max_abs_err": bwd_errs,
          "main_shape_two_calls_bit_equal": True,
          "routes_of_the_configs": bwd_routes,
          "wide_heads_two_calls_bit_equal": wide_bits,
          "wide_heads_stream_max_abs_err": wide_errs,
          "delta_prepass_max_abs_err": delta_errs,
          "tol_x_max(1,max|plain|)": FLASH_BWD_TOL,
          "delta_tol_x_max(1,max|torch|)": DELTA_TOL})

    # ---- 3. narrow model at seq 1024 against the JAX fixture --------------
    _mark("3 narrow model at seq 1024 against the JAX fixture")
    fix = np.load(golden.FIXTURE)
    narrow = GPTForCausalLM(GPTConfig(**golden.NARROW), device=dev)
    narrow.load_state_dict(params_from_jax(golden.jax_layout_params()))
    narrow.eval()
    ids = torch.as_tensor(golden.input_ids(), device=dev).long()
    narrow_out = {}

    def tpp_counts():
        """(TPP matmul launches, LN pre-pass launches) so far."""
        return (sum(n for k, n in tpp.launches.items()
                    if k.startswith("tpp_matmul.")),
                sum(n for k, n in tpp.launches.items()
                    if k.startswith("tpp_row_stats:")))

    for on in (False, True):
        set_flags({"tpp_kernels": on})
        f0, t0_ = sum(fa.launches.values()), tpp_counts()
        with torch.no_grad():
            rows = narrow(ids)[0, -golden.LOGIT_ROWS:].cpu().numpy()
        check(sum(fa.launches.values()) - f0 == 2,
              "narrow forward: 2 flash launches (one per layer)")
        t1_ = tpp_counts()
        check(t1_[0] - t0_[0] == (4 if on else 0),
              "narrow forward: 4 TPP launches with the flag on, 0 off")
        check(t1_[1] - t0_[1] == (2 if on else 0),
              "narrow forward: 2 LN pre-pass launches with the flag on")
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
    # the controls: a backward whose dQ or dK/dV is zero must fail the row
    # check, fp32 (the TF32 kernels) and bf16
    controls = {}
    for zero in ("dq", "dkv"):
        _, rows, _ = train_narrow(False, zero)
        want32 = {n: tfix[f"rows_fp32__{n}"] for n in golden.KEPT_PARAMS}
        key = f"fp32_{zero}_zeroed_row_max_abs_err"
        controls[key] = max(float(np.abs(rows[n] - want32[n]).max())
                            for n in rows)
        check(controls[key] > TRAIN_FP32_TOL,
              f"a zeroed {zero} fails the fp32 row check: {controls}")
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
    _mark("4 GPT-2 small, full width: the main path")
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
    fa.routes.clear()
    tpp.launches.clear()
    tpp.routes.clear()
    fwd = {}
    logits_ref = None
    for dname, m in (("float32", model), ("bfloat16", model_bf16)):
        for on in (False, True):
            set_flags({"tpp_kernels": on})

            def forward():
                f0 = fa.launches[f"flash_fwd:{dname}"]
                l0 = tpp.launches[f"tpp_matmul.ln:{dname}"]
                g0 = tpp.launches[f"tpp_matmul.in_act:{dname}"]
                r0 = tpp.launches[f"tpp_row_stats:{dname}"]
                with torch.no_grad():
                    out = m(ids)
                check(fa.launches[f"flash_fwd:{dname}"] - f0 == 12,
                      f"{dname} forward: 12 flash launches")
                n_tpp = 12 if on else 0
                check(tpp.launches[f"tpp_matmul.ln:{dname}"] - l0 == n_tpp
                      and tpp.launches[f"tpp_matmul.in_act:{dname}"] - g0
                      == n_tpp and tpp.launches[f"tpp_row_stats:{dname}"]
                      - r0 == n_tpp, f"{dname} forward: {2 * n_tpp} TPP "
                      f"launches and {n_tpp} of the LN pre-pass")
                return out

            times = []
            for i in range(1 + FORWARD_SAMPLES):     # one warm-up forward
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits = forward()
                torch.cuda.synchronize()
                if i:
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
    counts_serve = {**fa.launches, **tpp.launches, **fa.routes,
                    **paged_routes()}
    emit({"phase": "gpt2_small_generate", "batch": 4, "prompt": 128,
          "new_tokens": n_new, "dtype": "bfloat16",
          "seconds_all": gen_s,
          "new_tok_per_s": 4 * n_new / statistics.median(gen_s),
          "fp32_tokens_equal_forward_argmax": int((~mismatch).sum()),
          "fp32_near_tie_mismatches": int(mismatch.sum()),
          "main_path_launches": counts_serve,
          "flash_routes": flash_routes_checked("serving path"),
          "tpp_routes": tpp_routes_checked("serving path")})
    emit({"phase": "auto_cast_enters_no_torch_autocast",
          **auto_cast_enters_no_autocast()})
    del model, model_bf16
    torch.cuda.empty_cache()

    # ---- 4b. GPT-2 small training, full width: the training main path -----
    _mark("4b GPT-2 small training, full width: the training main path")
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
    fa.routes.clear()
    tpp.launches.clear()
    tpp.routes.clear()
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
                    for kind in ("fwd", "dq", "dkv", "delta")}
            if on:
                want.update({"tpp_matmul.ln:float32": L,
                             "tpp_matmul.in_act:float32": L,
                             "tpp_row_stats:float32": L})
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
    counts_train = {**fa.launches, **tpp.launches, **fa.routes,
                    **paged_routes()}
    emit({"phase": "gpt2_small_train", "batch": TRAIN_BATCH, "seq": S,
          "optimizer": "AdamW lr 1e-4", "flops_per_token": flops_per_token,
          "warmup_steps": 1, "train": train,
          "main_path_launches": counts_train,
          "flash_routes": flash_routes_checked("training path"),
          "tpp_routes": tpp_routes_checked("training path")})

    # ---- 4b2. runtime services in the trainer and the engine --------------
    _mark("4b2 runtime services in the trainer and the engine")
    counts_runtime = runtime_services(dev)
    _mark("4b3 runtime_services_ext")
    counts_runtime_ext = runtime_services_ext(dev)

    # ---- 4c. PP-YOLOE detection serving; 4d. the TPP row primitives -----
    _mark("4c PP-YOLOE detection serving; 4d. the TPP row primitives")
    det_path = serve_detector(dev, gen)
    rows_path = call_row_primitives(randn)
    counts_detect, counts_rows = det_path["counts"], rows_path["counts"]
    counts_anchors = det_path["counts_anchors"]

    # ---- 4e. GPT-2 small through the ServingEngine, dense and paged -------
    _mark("4e GPT-2 small through the ServingEngine, dense and paged")
    serve = gpt2_serving_engines(dev)
    counts_paged = serve["counts"]
    emit({"phase": "kernels_vs_plain", "kernel": "paged_attention",
          "source": "the paged engine's live pool, 12 layers",
          "max_abs_err": serve["errs"], "int8_vs_dense": serve["int8_vs_dense"],
          "main_path_launches": counts_paged})
    paged_errs, paged_full, paged_stream = check_paged_sources(gen)

    # ---- 4f. gpt2s_decode: the bf16, int8 and fp8 caches ------------------
    _mark("4f gpt2s_decode: the bf16, int8 and fp8 caches")
    narrow_q = narrow_quantized_decode(dev)
    decode = gpt2_decode_legs(dev)
    counts_decode = decode["counts"]
    emit({"phase": "gpt2_small_decode", "config": "bench.py run_decode",
          "batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
          "new_tokens": DECODE_NEW, "reps": DECODE_REPS,
          "dtype": "bfloat16", "legs": decode["legs"],
          "mbu_is": "new tok/s x bench.py _decode_mbu's bytes a token "
                    "(bf16 params but the gathered embedding, the cache at "
                    "its average length with 4-byte row scales) / "
                    f"{HBM_BYTES_PER_S / 1e12} TB/s",
          "narrow_quantized_vs_cpu": narrow_q,
          "narrow_tie": QUANT_TIE_F32, "main_path_launches": counts_decode})

    # ---- 4f2. the rest of generate and the engine --------------------------
    _mark("4f2 the rest of generate and the engine")
    _zero_counters()
    narrow_ext = narrow_generate_ext(dev)
    emit({"phase": "narrow_generate_ext", **narrow_ext, "tie": TIE_GAP,
          "beam_tol": NARROW_BEAM_TOL})
    t0 = time.perf_counter()
    gen_ext = gpt2_generate_ext(dev)
    counts_gen_ext = _read_kernel_counts()
    check(not counts_gen_ext, f"generate (ragged, beam, speculative): no "
          f"kernel launch (the reference's decode runs none), got "
          f"{counts_gen_ext}")
    emit({"phase": "gpt2_generate_ext", "dtype": "bfloat16", **gen_ext,
          "wall_s": time.perf_counter() - t0,
          "main_path_launches": counts_gen_ext})
    _zero_counters()
    t0 = time.perf_counter()
    engine_ext = gpt2_engine_ext(dev)
    counts_engine_ext = _read_kernel_counts()
    check(not counts_engine_ext, f"the engine's speculative, multi-LoRA, "
          f"hot-swap, disaggregated and async paths: no kernel launch, got "
          f"{counts_engine_ext}")
    emit({"phase": "gpt2_engine_ext", "dtype": "bfloat16",
          "slots": SERVE_SLOTS, "requests": SERVE_REQUESTS,
          "new_tokens": SERVE_NEW, **engine_ext,
          "wall_s": time.perf_counter() - t0,
          "main_path_launches": counts_engine_ext})

    # ---- 4g. PP-YOLOE training -------------------------------------------
    _mark("4g PP-YOLOE training")
    counts_det_train = train_detector(dev)

    # ---- 4h. ResNet-50, LeNet and BERT-base training -----------------------
    _mark("4h ResNet-50, LeNet and BERT-base training")
    counts_models = train_models(dev)

    # ---- 4i. the rest of GPT training: the recipe, gpt2m, gpt2s_16k, fp16 -
    _mark("4i the rest of GPT training: the recipe, gpt2m, gpt2s_16k, fp16")
    counts_recipes = train_recipes(dev)

    # ---- 5. times at the main path's shapes -------------------------------
    _mark("5 times at the main path's shapes")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2

    def time_ms(fn, reps=20, warmup=3, hide_enqueue=False):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if hide_enqueue:
                # the device spins ~0.5 ms first, so the host's enqueue of
                # fn (Python, ctypes) overlaps it and stays out of the window
                torch.cuda._sleep(SLEEP_CYCLES)
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

    def rates(row, flops, fn, library=None):
        """row, plus fn's time with the host's enqueue hidden (device_ms;
        library_device_ms for `library`), and the achieved TFLOP/s and the
        share of the bound from ms and from device_ms."""
        row = {**row, "device_ms": time_ms(fn, hide_enqueue=True)}
        if library is not None:
            row["library_device_ms"] = time_ms(library, hide_enqueue=True)
        for t, pre in (("ms", ""), ("device_ms", "device_")):
            row[f"{pre}tflops"] = flops / (row[t] * 1e-3) / 1e12
            row[f"{pre}share_of_bound"] = row["bound_ms"] / row[t]
        return row

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
                   "runtime_services": count(counts_runtime),
                   "runtime_services_ext": count(counts_runtime_ext),
                   "detect_serve": count(counts_detect),
                   "detect_anchors_nms": count(counts_anchors),
                   "tpp_rows": count(counts_rows),
                   "gpt_paged_serving": count(counts_paged),
                   "gpt_decode": count(counts_decode),
                   "gpt_generate_ext": count(counts_gen_ext),
                   "gpt_engine_ext": count(counts_engine_ext),
                   "detect_train": count(counts_det_train),
                   **{path: count(c) for path, c in counts_models.items()},
                   **{path: count(c) for path, c in counts_recipes.items()}}
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
            def kern():
                return fa.flash_attention(q, k, v, causal=True)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    *bhsd, is_causal=True)

            with torch.no_grad():
                fwd_rows[b] = rates({
                    "ms": time_ms(kern),
                    "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                        *heads, True, scale)),
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": time_ms(sdpa),
                    "shape": [b, s, h, d]}, 4.0 * b * h * pairs * d, kern,
                    sdpa)
            row = fwd_rows[b]
            row["device_ms_over_library_device_ms"] = \
                row["device_ms"] / row["library_device_ms"]
            if dname == "float32":
                # the TF32 kernel's own bound: three tensor-core passes a
                # product (bound_ms stays the fp32 FMA bound, 67 TFLOP/s)
                t_ops = 3 * 4.0 * b * h * pairs * d / PEAK_TF32_FLOPS
                t_mem = (4 * b * h * s * d * item + b * h * s * 4) \
                    / HBM_BYTES_PER_S
                row["bound_tc_ms"] = max(t_ops, t_mem) * 1e3
                row["bound_tc_by"] = "operations: 3 x FLOPs over 494.7 " \
                    "TFLOP/s TF32" if t_ops >= t_mem else "bytes"
                row["device_share_of_tc_bound"] = \
                    row["bound_tc_ms"] / row["device_ms"]
            del qkv, q, k, v, heads, bhsd
        # the streaming route at head_dim 576 and the wide heads 256 and 512
        # (s1024, causal) at b1 h2 and b4 h16 (STREAM_TIMED): the forward
        # (at 256 in bf16 the mma kernel), the backward (pre-pass, dQ,
        # dK/dV: one C call) and dQ and dK/dV alone, against SDPA's; the
        # bound counts the function's work, not the column groups'
        # recomputation of S
        stream_timed = {}
        for ds, (sb, sh) in ((ds, shape) for ds in (STREAM_HEAD_DIMS[0],
                                                    *WIDE_TIMED_DIMS)
                             for shape in STREAM_TIMED):
            sscale = 1.0 / math.sqrt(ds)
            t_rows = time.perf_counter()
            q, k, v, do = (randn(sb, s, sh, ds, dtype=dt) for _ in range(4))
            bhsd = [t.transpose(1, 2).contiguous().requires_grad_()
                    for t in (q, k, v)]
            n_pairs = sb * sh * pairs
            with torch.no_grad():
                o, lse = fa._launch(q, k, v, True, sscale, None)

                def stream_fwd():
                    return fa._launch(q, k, v, True, sscale, None)

                def sdpa_fwd():
                    return torch.nn.functional.scaled_dot_product_attention(
                        *bhsd, is_causal=True)

                bms, by = bound(4.0 * n_pairs * ds,
                                4 * sb * sh * s * ds * item
                                + sb * sh * s * 4, dname)
                heads_s = [fa._heads(t).contiguous()
                           for t in (q, k, v, o, do)]
                rows = {"forward": rates({
                    "ms": time_ms(stream_fwd, reps=5),
                    "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                        *heads_s[:3], True, sscale), reps=5),
                    "bound_ms": bms,
                    "bound_by": by, "library_ms": time_ms(sdpa_fwd, reps=5),
                    "route": flash_route("fwd", dname, ds),
                    "shape": [sb, s, sh, ds]}, 4.0 * n_pairs * ds,
                    stream_fwd, sdpa_fwd)}
                bwd_plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(
                    *heads_s[:4], lse, heads_s[4], True, sscale), reps=5)
                delta = fa._launch_delta(o, do)
                for kind, flops_a_pair, n_out, fn in (
                        ("dq", 6, 1, lambda: fa._launch_dq(
                            q, k, v, do, lse, delta, True, sscale, None)),
                        ("dkv", 8, 2, lambda: fa._launch_dkv(
                            q, k, v, do, lse, delta, True, sscale, None))):
                    bms, by = bound(flops_a_pair * n_pairs * ds,
                                    (4 + n_out) * sb * sh * s * ds * item
                                    + 2 * sb * sh * s * 4, dname)
                    rows[kind] = rates({
                        "ms": time_ms(fn, reps=5), "plain_ms": bwd_plain_ms,
                        "plain_covers": "dq, dk and dv: one plain backward",
                        "bound_ms": bms, "bound_by": by,
                        "route": flash_route(kind, dname, ds),
                        "shape": [sb, s, sh, ds]}, flops_a_pair * n_pairs * ds,
                        fn)
            out = torch.nn.functional.scaled_dot_product_attention(
                *bhsd, is_causal=True)
            bdo = do.transpose(1, 2).contiguous()

            def sdpa_bwd_stream():
                return torch.autograd.grad(out, bhsd, bdo, retain_graph=True)

            def stream_bwd():
                return fa._launch_bwd(q, k, v, o, lse, do, True, sscale, None)

            bms, by = bound(10.0 * n_pairs * ds,
                            8 * sb * sh * s * ds * item
                            + 2 * sb * sh * s * 4, dname)
            rows["backward"] = rates({
                "ms": time_ms(stream_bwd, reps=5), "plain_ms": bwd_plain_ms,
                "bound_ms": bms,
                "bound_by": by,
                "library_ms": time_ms(sdpa_bwd_stream, reps=5),
                "covers": "delta pre-pass + dQ + dK/dV (one C call) against "
                          "SDPA's backward", "shape": [sb, s, sh, ds]},
                10.0 * n_pairs * ds, stream_bwd, sdpa_bwd_stream)
            for kind in ("dq", "dkv"):
                rows[kind]["library_ms"] = rows["backward"]["library_ms"]
                rows[kind]["library_covers"] = "dq, dk and dv: one backward " \
                    "of scaled_dot_product_attention"
            rows["wall_s"] = time.perf_counter() - t_rows
            stream_timed[f"d{ds}_b{sb}_h{sh}"] = rows
            del q, k, v, do, o, lse, delta, bhsd, out, bdo, heads_s
            torch.cuda.empty_cache()
        # bf16: flash_fwd_mma_kernel; fp32: flash_fwd_tf32_kernel (three
        # TF32 passes a product), counted by that route
        route, tag = ("mma", "") if dname == "bfloat16" \
            else ("tf32x3", "_tf32")
        kernels.append({
            "name": f"flash_fwd{tag}[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
            "kernel": f"flash_fwd{tag or '_mma'}_kernel",
            "replaces": "paddle_tpu/ops/flash_attention.py:196",
            **launch_counts(f"flash_fwd:{dname}:{route}"),
            "max_abs_err": flash_err[dname][4], **fwd_rows[4], "causal": True,
            "train_shape": {**fwd_rows[TRAIN_BATCH],
                            "max_abs_err": flash_err[dname][TRAIN_BATCH]},
            "stream_route_d576": stream_timed["d576_b1_h2"],
            "stream_route_d576_b4_h16": stream_timed["d576_b4_h16"],
            # the streaming kernels at the head dims the scalar ones served
            # (0 launches on every main path, as above 512)
            "wide_heads": {key: rows for key, rows in stream_timed.items()
                           if not key.startswith("d576")}})
        # the backward pair at the serving and the training batch, from
        # the forward kernel's o and lse and the pre-pass's delta; `pair`
        # is one backward as the autograd Function runs it (pre-pass, dQ,
        # dK/dV: one call of the C entry)
        bwd_rows = {}
        for b in (4, TRAIN_BATCH):
            qkv = randn(b, s, 3 * h * d, dtype=dt)
            q, k, v = (t.reshape(b, s, h, d)
                       for t in qkv.split(h * d, dim=-1))
            do = randn(b, s, h, d, dtype=dt)
            with torch.no_grad():
                o, lse = fa._launch(q, k, v, True, scale, None)
                delta = fa._launch_delta(o, do)
                heads = [fa._heads(t).contiguous() for t in (q, k, v, o, do)]
                plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(
                    *heads[:4], lse, heads[4], True, scale))
                delta_plain_ms = time_ms(lambda: (
                    do.float() * o.float()).sum(-1).transpose(1, 2)
                    .reshape(b * h, s).contiguous())
            del heads
            bq, bk, bv = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                bq, bk, bv, is_causal=True)
            bdo = do.transpose(1, 2).contiguous()

            def sdpa_bwd():
                return torch.autograd.grad(out, (bq, bk, bv), bdo,
                                           retain_graph=True)

            library = {"library_ms": time_ms(sdpa_bwd),
                       "library_device_ms": time_ms(sdpa_bwd,
                                                    hide_enqueue=True)}
            del out, bq, bk, bv, bdo

            def pair():
                return fa._launch_bwd(q, k, v, o, lse, do, True, scale, None)

            pair_flops = 14.0 * d * b * h * pairs
            pair_bytes = 10 * b * h * s * d * item + 2 * b * h * s * 4
            bms, by = bound(pair_flops, pair_bytes, dname)
            rows = {"pair": {"ms": time_ms(pair),
                             "device_ms": time_ms(pair, hide_enqueue=True),
                             "bound_ms": bms, "bound_by": by,
                             "covers": "delta pre-pass + dQ + dK/dV, one "
                                       "call of the C entry", **library}}
            rows["pair"]["device_ms_over_library_device_ms"] = \
                rows["pair"]["device_ms"] / library["library_device_ms"]
            tc_bounds = {"pair": (pair_flops, pair_bytes)}
            for kind, flops_per_pair, n_out, fn in (
                    ("dq", 6, 1, lambda: fa._launch_dq(
                        q, k, v, do, lse, delta, True, scale, None)),
                    ("dkv", 8, 2, lambda: fa._launch_dkv(
                        q, k, v, do, lse, delta, True, scale, None))):
                flops = float(flops_per_pair) * d * b * h * pairs
                nbytes = (4 + n_out) * b * h * s * d * item \
                    + 2 * b * h * s * 4
                bms, by = bound(flops, nbytes, dname)
                rows[kind] = rates({
                    "ms": time_ms(fn), "plain_ms": plain_ms,
                    "plain_covers": "dq, dk and dv: one plain backward",
                    "bound_ms": bms, "bound_by": by, **library,
                    "library_covers": "dq, dk and dv: one backward of "
                                      "scaled_dot_product_attention",
                    "shape": [b, s, h, d], "causal": True}, flops, fn)
                tc_bounds[kind] = (flops, nbytes)
            if dname == "float32":
                # the TF32 kernels' own bound: three tensor-core passes a
                # product (bound_ms stays the fp32 FMA bound, 67 TFLOP/s)
                for kind, (flops, nbytes) in tc_bounds.items():
                    t_ops = 3 * flops / PEAK_TF32_FLOPS
                    t_mem = nbytes / HBM_BYTES_PER_S
                    row = rows[kind]
                    row["bound_tc_ms"] = max(t_ops, t_mem) * 1e3
                    row["bound_tc_by"] = "operations: 3 x FLOPs over " \
                        "494.7 TFLOP/s TF32" if t_ops >= t_mem else "bytes"
                    row["device_share_of_tc_bound"] = \
                        row["bound_tc_ms"] / row["device_ms"]
            # the pre-pass: read o and dO once, write delta (bytes bind it)
            flops = 2.0 * b * s * h * d
            bms, by = bound(flops, 2 * b * s * h * d * item + b * h * s * 4,
                            "float32")

            def delta_lib():
                # one library call, [B, H, S] (a view of [B*H, S]); in bf16
                # on fp32 copies, as the kernel's math is fp32
                if dt == torch.float32:
                    return torch.einsum("bshd,bshd->bhs", o, do)
                return torch.einsum("bshd,bshd->bhs", o.float(), do.float())

            rows["delta"] = rates({
                "ms": time_ms(lambda: fa._launch_delta(o, do)),
                "plain_ms": delta_plain_ms,
                "plain_covers": "(dO.float() * o.float()).sum(-1) as "
                                "[B*H, S]",
                "bound_ms": bms, "bound_by": by,
                "library_ms": time_ms(delta_lib),
                "library_covers": "torch.einsum('bshd,bshd->bhs', o, dO) "
                                  "(in bf16 on .float() copies, the casts "
                                  "included)",
                "shape": [b, s, h, d]}, flops,
                lambda: fa._launch_delta(o, do), delta_lib)
            bwd_rows[b] = rows
            del qkv, q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
        # bf16: flash_{dq,dkv}_mma_kernel; fp32: flash_{dq,dkv}_tf32_kernel
        # (three TF32 passes a product), counted by that route
        for kind, line in (("dq", 282), ("dkv", 319)):
            route, tag = ("mma", "") if dname == "bfloat16" \
                else ("tf32x3", "_tf32")
            kernels.append({
                "name": f"flash_{kind}{tag}[{dname}]", "route": "cuda",
                "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
                "kernel": f"flash_{kind}{tag or '_mma'}_kernel",
                "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
                **launch_counts(f"flash_{kind}:{dname}:{route}"),
                "max_abs_err": bwd_errs[dname][kind],
                **bwd_rows[TRAIN_BATCH][kind],
                "pair": bwd_rows[TRAIN_BATCH]["pair"],
                "serve_shape": {**bwd_rows[4][kind],
                                "pair": bwd_rows[4]["pair"]}})
        kernels.append({
            "name": f"flash_delta[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": "paddle_tpu/ops/flash_attention.py:370",
            "replaces_part": "_flash_bwd's delta = rowsum(dO o), which "
                             "the reference computes outside Pallas",
            **launch_counts(f"flash_delta:{dname}"),
            "max_abs_err": delta_errs[dname],
            **bwd_rows[TRAIN_BATCH]["delta"],
            "serve_shape": bwd_rows[4]["delta"]})

    tpp_plain = {}
    for dname, dt in dtypes.items():
        item = torch.finfo(dt).bits // 8
        rows = {"ln": {}, "gelu": {}, "stats": {}}
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
            def ln_mm():
                return tpp.ln_matmul(x, gamma, beta, fc1.t(), b1)

            def gelu_mm():
                return tpp._fused_tail(pre, fc2.t(), b2, False)

            def stats():
                return tpp._row_stats(x)

            def var_mean():
                return torch.var_mean(x.float(), -1, correction=0)

            with torch.no_grad():
                bms, by = bound(flops, (m_rows * H + H * I + m_rows * I + I
                                        + 2 * H) * item, dname)
                # the LN mode's time covers both of its launches: the row
                # statistics pre-pass and the matmul
                rows["ln"][m_rows] = rates({
                    "ms": time_ms(ln_mm),
                    "plain_ms": time_ms(lambda: tpp._matmul_ref(
                        x, fc1.t(), b1, gamma=gamma, beta=beta)),
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "shape": [m_rows, H, I]}, flops, ln_mm)
                bms, by = bound(flops, (m_rows * I + I * H + m_rows * H
                                        + H) * item, dname)
                rows["gelu"][m_rows] = rates({
                    "ms": time_ms(gelu_mm),
                    "plain_ms": time_ms(lambda: tpp._matmul_ref(
                        pre, fc2.t(), b2, "gelu")),
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "shape": [m_rows, I, H]}, flops, gelu_mm)
                # the pre-pass alone: two fp32 passes over x (bytes bind it)
                bms, by = bound(4.0 * m_rows * H, m_rows * H * item
                                + 2 * m_rows * 4, "float32")
                rows["stats"][m_rows] = rates({
                    "ms": time_ms(stats),
                    "plain_ms": time_ms(lambda: tpp._row_stats_ref(x)),
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": time_ms(var_mean),
                    "library_covers": "torch.var_mean(x.float(), -1, "
                                      "correction=0): the variance, not "
                                      "rstd (in bf16 the cast included)",
                    "shape": [m_rows, H]}, 4.0 * m_rows * H, stats,
                    var_mean)
                if m_rows == M:
                    # the plain variant (not on a main path) beside addmm
                    bms, by = bound(flops, (M * H + H * I + M * I + I)
                                    * item, dname)

                    def plain_mm():
                        return tpp.matmul(x, fc1.t(), b1)

                    def addmm():
                        return torch.addmm(b1, x, fc1.t())

                    tpp_plain[dname] = rates({
                        "ms": time_ms(plain_mm),
                        "plain_ms": time_ms(lambda: tpp._matmul_ref(
                            x, fc1.t(), b1)),
                        "library_ms": time_ms(addmm),
                        "bound_ms": bms, "bound_by": by, "shape": [M, H, I]},
                        flops, plain_mm, addmm)
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
        kernels.append({
            "name": f"tpp_row_stats[{dname}]", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/tpp_matmul.cu",
            "replaces": "paddle_tpu/ops/tpp.py:458",
            "replaces_part": "the LN prologue's row statistics",
            **launch_counts(f"tpp_row_stats:{dname}"),
            "max_abs_err": tpp_errs[dname]["row_stats"],
            **rows["stats"][M], "train_shape": rows["stats"][M_TRAIN]})
    kernels += time_new_kernels(det_path, rows_path, randn, time_ms, bound,
                                launch_counts)
    kernels += time_paged_attention(serve, paged_full, paged_errs,
                                    paged_stream, time_ms, bound,
                                    launch_counts)
    emit({"phase": "times", "method": "CUDA events, 3 warm-up, median of "
          "20 (the plain NMS: 1 warm-up, median of 5), 64 MB written "
          "between launches to flush L2; device_ms (flash, TPP, paged "
          "attention, the row kernels, NMS): "
          "the same with a ~0.5 ms device sleep before the start event, "
          "so the host's enqueue of the call is not timed",
          "tpp_matmul.plain": tpp_plain})
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} ran on a main path")
    for name in ("flash_fwd[bfloat16]", "flash_fwd_tf32[float32]",
                 "flash_dq[bfloat16]",
                 "flash_dkv[bfloat16]", "flash_dq_tf32[float32]",
                 "flash_dkv_tf32[float32]", "flash_delta[bfloat16]",
                 "flash_delta[float32]", "tpp_matmul.ln_prologue[float32]",
                 "tpp_matmul.gelu_in_bias[float32]",
                 "tpp_row_stats[float32]"):
        kern = next(k for k in kernels if k["name"] == name)
        check(kern["launches_by_path"]["gpt_train"] > 0,
              f"{name} ran on the training path")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    _mark(None)
    emit({"phase": "phase_seconds", "seconds": {
        name: t1 - t0 for (name, t0), (_, t1) in zip(_MARKS, _MARKS[1:])}})
    emit({"kernels": kernels})
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
