#!/usr/bin/env python3
"""Time design variants of paged attention's stream kernel on one CUDA
device: the RING path of `paged_ring_kernel`
(paddle_tpu_torch/ops/csrc/paged_attention.cu) at ab_kernels.py's
PAGED_STREAM_SHAPES[2] (B 8, H 4, head dim 512, frames of 512 columns, 4
frames a row; random lengths, row 0 empty, the same draw as ab_kernels.py
--cases paged_stream), bf16 q and pages, fp32 q and pages, fp32 q on int8
pages with their row scales.

    python3 paged_variants.py [VARIANT ...]     # default: every one

Each variant calls the C entry ``paged_attention`` with its own columns a
split (and splits a row), columns a tile and ring depth. "chosen" is the
plan ``tpp._paged_kernel_call`` launches (``tpp._paged_stream_splits``,
``tpp._paged_ring``, the source's STAGES); "stages3" and "stages4" deepen
the ring to three and four slots (a copy of the source with STAGES
replaced, built under its own name in ops/csrc/ and removed again at the
end); "tile_half" and "tile_twice" give half and twice the columns a tile,
"tile_half_stages4" half of them four slots deep; "split_half" and
"split_twice" half and twice the columns a split.

For each variant and type: the route the C entry reports, the largest
error against the plain version (``tpp.paged_attention_ref``), whether two
calls give the same bits as each other and as "chosen", and the device ms
(CUDA events after a ~0.5 ms device sleep, median of 20 after 3 warm-ups,
64 MB written between calls), every variant timed in order and again in
reverse order (its median is that of both passes). Prints one JSON line,
then the card's name and power limit. It imports neither jax nor the JAX
package.
"""
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ab_kernels import PAGED_STREAM_SHAPES, SLEEP_CYCLES  # noqa: E402

SOURCE = "paged_attention"
#: {variant: (ring depth or None for the source's, columns a tile as a
#: factor of the chosen one, columns a split as such a factor)}
VARIANTS = {
    "chosen": (None, 1, 1),
    "stages3": (3, 1, 1),
    "stages4": (4, 1, 1),
    "tile_half": (None, 0.5, 1),
    "tile_twice": (None, 2, 1),
    "tile_half_stages4": (4, 0.5, 1),
    "split_half": (None, 1, 0.5),
    "split_twice": (None, 1, 2),
}
STAGES = re.compile(r"^constexpr int STAGES = \d+;", re.M)


def variant_source(text, stages):
    """The source with its ring `stages` slots deep."""
    new, n = STAGES.subn(f"constexpr int STAGES = {stages};", text)
    if n != 1:
        raise RuntimeError("STAGES not found once in the source")
    return new


def cases(torch, dev):
    """{type: (q, kp, vp, k_scales, v_scales, tables, lengths)} at
    PAGED_STREAM_SHAPES[2], drawn as ab_kernels.py's paged_stream table
    draws it (the generator walks the two shapes before it first)."""
    from paddle_tpu_torch.distributed import compress

    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, hd, bs, maxb, NB in PAGED_STREAM_SHAPES:
        kp = torch.randn(NB, H, bs, hd, generator=gen, device=dev)
        vp = torch.randn(NB, H, bs, hd, generator=gen, device=dev)
        (kq, ks), (vq, vs) = (compress.quantize_rows(kp),
                              compress.quantize_rows(vp))
        lengths = torch.randint(1, maxb * bs + 1, (B,), generator=gen,
                                device=dev).int()
        lengths[0] = 0
        tables = torch.zeros(B, maxb, dtype=torch.int32, device=dev)
        for b in range(B):
            n = -(-int(lengths[b]) // bs)
            tables[b, :n] = torch.randperm(NB - 1, generator=gen,
                                           device=dev)[:n].int() + 1
        q32 = torch.randn(B, H, hd, generator=gen, device=dev)
    return {"dense[bfloat16]": (q32.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                                None, None, tables, lengths),
            "dense[float32]": (q32, kp, vp, None, None, tables, lengths),
            "int8[float32]": (q32, kq, vq, ks, vs, tables, lengths)}


def main():
    import torch

    from paddle_tpu_torch.ops import _build, tpp

    if not torch.cuda.is_available():
        raise SystemExit("paged_variants.py needs a CUDA device")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    argtypes = tpp._paged_kernel()[1].argtypes
    text = (_build.CSRC / f"{SOURCE}.cu").read_text()
    written, libs = [], {}
    try:
        for n in names:
            stages = VARIANTS[n][0]
            if stages is None:
                libs[n] = SOURCE
                continue
            libs[n] = f"{SOURCE}_stages{stages}"
            path = _build.CSRC / f"{libs[n]}.cu"
            if path not in written:
                path.write_text(variant_source(text, stages))
                written.append(path)
        build_s = _build.build(sorted(set(libs.values())))
        entries = {}
        for n in names:
            lib = _build.load(libs[n])
            fn = lib.paged_attention
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            entries[n] = lib, fn
    finally:
        for path in written:
            path.unlink(missing_ok=True)

    def call(n, q, kp, vp, ks, vs, tables, lengths):
        B, H, hd = q.shape
        bs, maxb = kp.shape[2], tables.shape[1]
        _, tile, split = VARIANTS[n]
        cols, _ = tpp._paged_stream_splits(B, H, bs, maxb)
        cols = max(1, int(cols * split))
        nsplit = -(-maxb * bs // cols)
        tc = max(1, int(tpp._paged_ring(hd, kp.element_size()) * tile))
        out = torch.empty_like(q)
        part = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32,
                           device=dev) if nsplit > 1 else None
        taken = (ctypes.c_int * 2)()
        lib, fn = entries[n]
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                 None if ks is None else ks.data_ptr(),
                 None if vs is None else vs.data_ptr(), tables.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), B, H, hd, bs,
                 maxb, cols, nsplit, tc, kp.stride(0),
                 0 if ks is None else ks.stride(0), 1.0 / hd ** 0.5,
                 tpp._PAGED_Q_DTYPES[q.dtype],
                 tpp._PAGED_PAGE_DTYPES[kp.dtype], 1, _build.stream(q), taken)
        _build.check(lib, SOURCE, err)
        plan = {"route": tpp._PAGED_ROUTES[taken[0]],
                "columns_a_split": cols, "splits_a_row": nsplit, "columns_a_tile": tc,
                "ring_stages": taken[1], "blocks": B * H * nsplit}
        return out, plan

    def device_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    result = {"build_s": build_s, "shape_B_H_hd_bs_maxb_NB":
              PAGED_STREAM_SHAPES[2]}
    for tname, args in cases(torch, dev).items():
        want = tpp.paged_attention_ref(*args[:3], *args[5:], *args[3:5])
        chosen = call("chosen", *args)[0] if "chosen" in names else None
        rows, times = {}, {n: [] for n in names}
        for n in names:
            got, plan = call(n, *args)
            again = call(n, *args)[0]
            torch.cuda.synchronize()
            rows[n] = {"plan": plan,
                       "max_abs_err": float((got.float() - want.float())
                                            .abs().max()),
                       "two_calls_bit_equal": torch.equal(got, again),
                       "bits_of_chosen": None if chosen is None
                       else torch.equal(got, chosen)}
        for order in (names, names[::-1]):
            for n in order:
                times[n] += device_ms(lambda n=n: call(n, *args))
        for n in names:
            rows[n]["device_ms"] = statistics.median(times[n])
        result[tname] = rows
    print(json.dumps(result), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout
          else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
