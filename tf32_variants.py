#!/usr/bin/env python3
"""Build variants of the flash kernels side by side on one CUDA device, and
compare them: the fp32 kernels on the TF32 tensor cores
(paddle_tpu_torch/ops/csrc/flash_fwd.cu: flash_fwd_tf32_kernel;
flash_bwd.cu: flash_dq_tf32_kernel and flash_dkv_tf32_kernel; VARIANTS)
and the streaming route's kernels (the wide heads, from head_dim 192:
flash_fwd_stream_kernel, flash_dq_stream_kernel and
flash_dkv_stream_kernel, their tiles and ring in flash_stream.cuh;
STREAM_VARIANTS).

    python3 tf32_variants.py [VARIANT ...]     # default: every TF32 one

Each variant is a copy of flash_fwd.cu or flash_bwd.cu (or both) with some
of its tiling functions returning other values (fwd_tf_rows, fwd_tf_bkv,
fwd_tf_blocks, fwd_tf_unroll in the forward; dq_tf_rows,
dq_tf_blocks, dkv_tf_rows, dkv_tf_bq, dkv_tf_blocks, dkv_tf_unroll in the
backward), built under its own name in ops/csrc/ and removed again at the
end; "chosen" builds both sources as they are, and "one_pass" both with
every product formed from the operands' big TF32 parts alone (one TF32
pass: the accuracy control), through a copy of flash_tf32.cuh. For each it
prints ptxas's registers and spills of the TF32 kernels; for a forward:
the largest error of o over max(1, max|plain|) and of lse against the
plain forward (and against an fp64 one) on randn inputs (b4, s 1024 and
1088, head_dim 64 and 128, full, causal, windows 100 and 17), whether two
calls give the same bits, and the device ms at b4 and b16 (s 1024,
causal, q/k/v slices of one packed qkv; h 12 at head_dim 64, 6 at 128);
for a backward the same of dQ, dK and dV and the device ms of the pair
(delta pre-pass + dQ + dK/dV, one call of the C entry), dQ and dK/dV.
Device ms: CUDA events after a ~0.5 ms device sleep, median of 20, 64 MB
written between calls. Then SDPA's forward and backward on the same
inputs.

A streaming variant (named stream_*) is a copy of flash_fwd.cu and
flash_bwd.cu, and of flash_stream.cuh where it changes the header, with a
few lines replaced; "stream_chosen" builds the sources as they are.
"stream_resident" keeps every kernel's own chunk tiles resident wherever
they fit beside the ring, "stream_streamed" never, where the sources
decide by the grid (`resident` in flash_stream.cuh); "stream_stages4"
deepens the ring from three chunk items to four; "stream_dkv_rows32"
gives the fp32 dK/dV kernel 32-row query steps (the bf16 one's) instead
of 16. For each it prints ptxas's registers and spills of the streaming
kernels; the largest error of o (over max(1, max|plain|)), of lse and of
dq, dk and dv (over max(1, max|plain|)) against the plain forward and
backward (b1 h2 s1024, head_dim 576, 640 and 1024, causal, randn inputs)
and whether two backward calls give the same bits; and the device ms of
the forward, dQ and dK/dV at head_dim 576 (causal, s1024) at b1 h2 and b4
h16, every variant timed in order and again in reverse order (A B B A for
two); device ms as above, median of 10.

The wide_* variants do the same at the head dims the streaming route took
over from scalar kernels (errors at 192 to 512, times at 256 and 512, b1
h2 and b4 h16): "wide_chosen" builds the sources as they are;
"wide_split" runs two column groups a block (two warpgroups sharing S and
dP, design (b)) wherever an output has more than one group at head dims
up to 512, "wide_groups" one group a grid step everywhere (design (a)),
"wide_mma_off" the bf16 forward at head dims 192 and 256 on the streaming
route instead of the mma one.

Last, the card's name and power limit. It imports neither jax nor the JAX
package.
"""
import json
import math
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: {variant: {tiling function: the expression it returns instead}}; the
#: fwd_* functions are flash_fwd.cu's, the others flash_bwd.cu's
VARIANTS = {
    "chosen": {},
    "one_pass": {},
    "rows128": {"dq_tf_rows": "128", "dq_tf_blocks": "1",
                "dkv_tf_rows": "128", "dkv_tf_blocks": "1"},
    "dkv_no_unroll": {"dkv_tf_unroll": "false"},
    "fwd_rows128": {"fwd_tf_rows": "128", "fwd_tf_blocks": "1"},
    "fwd_bkv32": {"fwd_tf_bkv": "32", "fwd_tf_blocks": "D == 64 ? 3 : 2"},
    "fwd_bkv64": {"fwd_tf_bkv": "64", "fwd_tf_blocks": "1"},
    "fwd_no_unroll": {"fwd_tf_unroll": "false"},
}
# one TF32 pass: the big parts' product alone, in mma_tf32x3's place
ONE_PASS = """
__device__ __forceinline__ void mma_tf32x1(
    float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&)[4],
    uint32_t b0_big, uint32_t b1_big, uint32_t, uint32_t) {
  hopper::mma_tf32(d, a_big, b0_big, b1_big);
}
"""
ONE_PASS_HEADER = "flash_tf32_one_pass.cuh"
SLEEP_CYCLES = 1_000_000

_RESIDENT_TEST = ("(2 * (res_bytes + BLOCK_RESERVED) <= SM_SMEM ||\n"
                  "          blocks <= 2LL * sm_count())")
# the choice of warpgroups a block (`warpgroups` in flash_stream.cuh)
_WGS_RULE = ("return G > 1 && D <= 512 && (D > 320 || blocks > sm_count()) "
             "? 2 : 1;")
#: {variant: {source ("flash_fwd", "flash_bwd" or "flash_stream" for the
#: header): [(text, replacement), ...]}}
STREAM_VARIANTS = {
    "stream_chosen": {},
    "stream_resident": {"flash_stream": [(_RESIDENT_TEST, "true")]},
    "stream_streamed": {"flash_stream": [(_RESIDENT_TEST, "false")]},
    "stream_stages4": {"flash_stream": [("ST_STAGES = 3;",
                                         "ST_STAGES = 4;")]},
    "stream_dkv_rows32": {"flash_bwd": [(
        "return sizeof(T) == 2 ? 32 : 16;", "return 32;")]},
    "wide_chosen": {},
    "wide_split": {"flash_stream": [(_WGS_RULE,
                                     "return G > 1 && D <= 512 ? 2 : 1;")]},
    "wide_groups": {"flash_stream": [(_WGS_RULE, "return 1;")]},
    "wide_mma_off": {"flash_fwd": [("if (dtype == 1 && D <= 256) return 1;",
                                    "if (dtype == 1 && D <= 128) return 1;")]},
}
#: head dims whose errors the streaming variants print, and (b, h, d) shapes
#: they time: above 512 for stream_*, the wide heads up to 512 for wide_*
STREAM_CHECKED = {"stream": ((576, 640, 1024), ((1, 2, 576), (4, 16, 576))),
                  "wide": ((192, 256, 320, 384, 448, 512),
                           ((1, 2, 256), (1, 2, 512), (4, 16, 256),
                            (4, 16, 512)))}
SOURCES = ("flash_fwd", "flash_bwd")


def variant_sources(name):
    """The sources variant `name` builds: both for "chosen" and
    "one_pass", else those whose tiling functions it changes."""
    fns = VARIANTS[name]
    if not fns:
        return ("flash_fwd", "flash_bwd")
    return tuple(sorted({"flash_fwd" if fn.startswith("fwd_")
                         else "flash_bwd" for fn in fns}))


def one_pass(text, n_calls, what):
    """`text` with its mma_tf32x3 calls on accumulators x swapped for
    mma_tf32x1 (there must be n_calls)."""
    text, n = re.subn(r"mma_tf32x3\(x", "mma_tf32x1(x", text)
    if n != n_calls:
        raise RuntimeError(f"{n} mma_tf32x3 calls in {what}, expected "
                           f"{n_calls}")
    return text


def one_pass_header(src):
    """flash_tf32.cuh's text with both products in one TF32 pass."""
    src = src.replace("namespace flash {\n", "namespace flash {\n" + ONE_PASS,
                      1)
    return one_pass(src, 2, "flash_tf32.cuh")


def variant_source(src, source, name):
    """`source` (flash_fwd or flash_bwd)'s text with `name`'s changes."""
    for fn, expr in VARIANTS[name].items():
        src, n = re.subn(
            rf"(constexpr (?:int|bool) {fn}\(\) \{{\n  return )[^;]*;",
            rf"\g<1>{expr};", src)
        if n != 1 and (fn.startswith("fwd_")) == (source == "flash_fwd"):
            raise RuntimeError(f"{fn} not found once in {source}.cu")
    if name == "one_pass":
        src = src.replace('#include "flash_tf32.cuh"\n',
                          f'#include "{ONE_PASS_HEADER}"\n', 1)
        # every product is the header's: none may call mma_tf32x3 itself
        src = one_pass(src, 0, f"{source}.cu")
    return src


def replaced(text, edits, what):
    """`text` with each (old, new) of `edits` replaced; every old must be
    there once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{what}: {old!r} not once")
        text = text.replace(old, new)
    return text


def write_stream_variant(csrc, name, written):
    """Write streaming variant `name`'s sources into csrc/ under their own
    names (appended to `written`); returns {source: library}."""
    edits = STREAM_VARIANTS[name]
    header = "flash_stream.cuh"
    if "flash_stream" in edits:
        text = replaced((csrc / header).read_text(), edits["flash_stream"],
                        f"{name}: {header}")
        header = f"flash_stream_{name}.cuh"
        (csrc / header).write_text(text)
        written.append(csrc / header)
    libs = {}
    for src in SOURCES:
        text = replaced((csrc / f"{src}.cu").read_text(),
                        edits.get(src, []), f"{name}: {src}.cu")
        libs[src] = f"{src}_{name}"
        path = csrc / f"{libs[src]}.cu"
        path.write_text(text.replace('"flash_stream.cuh"', f'"{header}"'))
        written.append(path)
    return libs


def main(names):
    import torch

    from paddle_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("tf32_variants.py needs a CUDA device")
    tf32 = [n for n in names if n in VARIANTS]
    stream = [n for n in names if n in STREAM_VARIANTS]
    written = []
    libs = {n: {} for n in tf32}
    stream_libs = {}
    try:
        if "one_pass" in tf32:
            path = _build.CSRC / ONE_PASS_HEADER
            path.write_text(one_pass_header(
                (_build.CSRC / "flash_tf32.cuh").read_text()))
            written.append(path)
        for n in tf32:
            for source in variant_sources(n):
                lib = f"{source}_{n}"
                path = _build.CSRC / f"{lib}.cu"
                path.write_text(variant_source(
                    (_build.CSRC / f"{source}.cu").read_text(), source, n))
                written.append(path)
                libs[n][source] = lib
        for n in stream:
            stream_libs[n] = write_stream_variant(_build.CSRC, n, written)
        print(json.dumps({"build_s": _build.build(
            [lib for by in (*libs.values(), *stream_libs.values())
             for lib in by.values()])}), flush=True)
        if tf32:
            compare(libs)
        for kind, (dims, shapes) in STREAM_CHECKED.items():
            chosen = {n: by for n, by in stream_libs.items()
                      if n.startswith(kind + "_")}
            if chosen:
                compare_stream(chosen, dims, shapes)
    finally:
        for path in written:       # the build finds a library by its source
            path.unlink(missing_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else
          "nvidia-smi: no output", flush=True)
    return 0


def compare(libs):
    """Hold every built variant against the plain forward or backward and
    time it."""
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

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
        return statistics.median(times)

    def keep(p, causal, window):
        return p if not causal else p.masked_fill(
            ~fa._keep_mask(*p.shape[-2:], window, dev), 0)

    def fwd_fp64(q, k, v, causal, scale, window):
        q, k, v = (t.double() for t in (q, k, v))
        sc = q @ k.transpose(-1, -2) * scale
        if causal:
            sc = sc.masked_fill(~fa._keep_mask(*sc.shape[-2:], window, dev),
                                -math.inf)
        lse = torch.logsumexp(sc, -1)
        return torch.exp(sc - lse[..., None]) @ v, lse

    def bwd_fp64(q, k, v, o, lse, do, causal, scale, window):
        q, k, v, o, lse, do = (t.double() for t in (q, k, v, o, lse, do))
        delta = (do * o).sum(-1)
        p = keep(torch.exp(q @ k.transpose(-1, -2) * scale - lse[..., None]),
                 causal, window)
        ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
        return ((ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale,
                p.transpose(-1, -2) @ do)

    def rel_err(got, want):
        err = max((g.double() - w.double()).abs().max().item()
                  for g, w in zip(got, want))
        return err / max(1.0, max(w.abs().max().item() for w in want))

    def lse_err(got, want):
        return (got.double() - want.double()).abs().max().item()

    cases = []
    for s in (1024, 1088):
        for d in (64, 128):
            for causal, window in ((False, None), (True, None), (True, 100),
                                   (True, 17)):
                q, k, v, do = (torch.randn(4, s, d, generator=gen,
                                           device=dev) for _ in range(4))
                scale = 1.0 / math.sqrt(d)
                o, lse = fa.flash_attention_ref(q, k, v, causal, scale,
                                                window)
                args = (q, k, v, o, lse, do, causal, scale, window)
                cases.append((args, (o, lse),
                              fwd_fp64(q, k, v, causal, scale, window),
                              fa.flash_attention_bwd_ref(
                                  *args[:-1], window=window),
                              bwd_fp64(*args)))
    timed = {}
    for b in (4, 16):
        for d in (64, 128):
            h = 12 if d == 64 else 6
            qkv = torch.randn(b, 1024, 3 * h * d, generator=gen, device=dev)
            q, k, v = (t.reshape(b, 1024, h, d)
                       for t in qkv.split(h * d, dim=-1))
            do = torch.randn(b, 1024, h, d, generator=gen, device=dev)
            o3, lse = fa.flash_attention_ref(
                *(fa._heads(t) for t in (q, k, v)), True, d ** -0.5)
            timed[(b, d)] = (q, k, v, fa._unheads(o3, b, h).contiguous(),
                             lse, do)
            del o3

    def fwd_rows():
        out = {}
        errs = []
        for (q, k, v, *_, causal, scale, window), plain, fp64, _, _ in cases:
            o, lse = fa._launch(*(t.unsqueeze(2) for t in (q, k, v)),
                                causal, scale, window)
            o = o.squeeze(2)
            errs.append((rel_err([o], [plain[0]]), lse_err(lse, plain[1]),
                         rel_err([o], [fp64[0]]), lse_err(lse, fp64[1])))
        for i, key in enumerate(("o_max_err_vs_plain", "lse_max_err_vs_plain",
                                 "o_max_err_vs_fp64",
                                 "lse_max_err_vs_fp64")):
            out[key] = max(e[i] for e in errs)
        out["o_min_err_vs_plain"] = min(e[0] for e in errs)
        for (b, d), (q, k, v, *_) in timed.items():
            scale = d ** -0.5
            first = fa._launch(q, k, v, True, scale, None)
            again = fa._launch(q, k, v, True, scale, None)
            out[f"b{b}_d{d}"] = {
                "bit_equal": all(torch.equal(x, y)
                                 for x, y in zip(first, again)),
                "forward": device_ms(lambda: fa._launch(
                    q, k, v, True, scale, None))}
        return out

    def bwd_rows():
        out = {}
        errs = []
        for ((q, k, v, o, lse, do, causal, scale, window), _, _, plain,
             fp64) in cases:
            got = [t.squeeze(2) for t in fa._launch_bwd(
                *(t.unsqueeze(2) for t in (q, k, v, o)), lse,
                do.unsqueeze(2), causal, scale, window)]
            errs.append((rel_err(got, plain), rel_err(got, fp64)))
        out["max_err_vs_plain"] = max(e[0] for e in errs)
        out["min_err_vs_plain"] = min(e[0] for e in errs)
        out["max_err_vs_fp64"] = max(e[1] for e in errs)
        for (b, d), (q, k, v, o, lse, do) in timed.items():
            scale = d ** -0.5
            first = fa._launch_bwd(q, k, v, o, lse, do, True, scale, None)
            again = fa._launch_bwd(q, k, v, o, lse, do, True, scale, None)
            delta = fa._launch_delta(o, do)
            out[f"b{b}_d{d}"] = {
                "bit_equal": all(torch.equal(x, y)
                                 for x, y in zip(first, again)),
                "pair": device_ms(lambda: fa._launch_bwd(
                    q, k, v, o, lse, do, True, scale, None)),
                "dq": device_ms(lambda: fa._launch_dq(
                    q, k, v, do, lse, delta, True, scale, None)),
                "dkv": device_ms(lambda: fa._launch_dkv(
                    q, k, v, do, lse, delta, True, scale, None))}
        return out

    real_load = _build.load
    for n, by_source in libs.items():
        for source, lib in by_source.items():
            fa._FN.pop(source, None)
            _build.load = lambda name, lib=lib, source=source: real_load(
                lib if name == source else name)
            regs = {k.split("flash_")[-1].split("ILi")[0] + "<"
                    + k.split("ILi")[1].split("E")[0] + ">": r
                    for k, r in _build.ptxas_report(lib).items()
                    if "tf32" in k}
            out = {"variant": n, "source": source, "ptxas": regs}
            out.update(fwd_rows() if source == "flash_fwd" else bwd_rows())
            print(json.dumps(out), flush=True)
            fa._FN.pop(source, None)
            _build.load = real_load
    sdpa = {}
    for (b, d), (q, k, v, o, lse, do) in timed.items():
        bq, bk, bv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        with torch.no_grad():
            fwd = device_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(bq, bk, bv,
                                                          is_causal=True))
        out = torch.nn.functional.scaled_dot_product_attention(
            bq, bk, bv, is_causal=True)
        bdo = do.transpose(1, 2).contiguous()
        sdpa[f"b{b}_d{d}"] = {"forward": fwd, "backward": device_ms(
            lambda: torch.autograd.grad(out, (bq, bk, bv), bdo,
                                        retain_graph=True))}
    print(json.dumps({"sdpa_device_ms": sdpa}), flush=True)


def compare_stream(libs, head_dims, shapes):
    """Hold every built streaming variant ({variant: {source: library}})
    against the plain forward and backward at `head_dims` (b1 h2 s1024),
    and time them at `shapes` ((b, h, d), s1024) in A B .. B A order."""
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    names = list(libs)
    fa._kernel("flash_fwd")
    fa._kernel("flash_bwd")
    sigs = {src: fa._FN[src][1] for src in SOURCES}
    fns = {}
    for name, by_source in libs.items():
        fns[name] = {}
        report = {}
        for src, lib_name in by_source.items():
            lib = _build.load(lib_name)
            fn = getattr(lib, src)
            fn.argtypes, fn.restype = sigs[src].argtypes, sigs[src].restype
            fns[name][src] = (lib, fn)
            for k, r in _build.ptxas_report(lib_name).items():
                m = re.search(r"(flash_\w+_stream_kernel)I(f|13__nv_"
                              r"bfloat16)Lb([01])ELi(\d)E", k)
                if m:
                    report[f"{m[1]}[{'fp32' if m[2] == 'f' else 'bf16'}"
                           f"{', resident' if m[3] == '1' else ''}, "
                           f"{m[4]} warpgroups]"] = r
        print(json.dumps({"variant": name, "ptxas": report}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def device_ms(fn, reps=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    for name in names:
        fa._FN.update(fns[name])
        errs, same = {}, True
        for d in head_dims:
            for dname, dt in dtypes:
                q, k, v, do = (torch.randn(1, 1024, 2, d, generator=gen,
                                           device=dev).to(dt)
                               for _ in range(4))
                scale = 1.0 / math.sqrt(d)
                o, lse = fa._launch(q, k, v, True, scale, None)
                grads = fa._launch_bwd(q, k, v, o, lse, do, True, scale,
                                       None)
                again = fa._launch_bwd(q, k, v, o, lse, do, True, scale,
                                       None)
                same &= all(torch.equal(x, y) for x, y in zip(grads, again))
                heads = [fa._heads(t) for t in (q, k, v, o, do)]
                ro, rlse = fa.flash_attention_ref(*heads[:3], True, scale)
                rgrads = fa.flash_attention_bwd_ref(
                    *(t.float() for t in heads[:4]), lse, heads[4].float(),
                    True, scale)

                def rel(got, want):
                    want = fa._unheads(want, 1, 2).float()
                    return (got.float() - want).abs().max().item() \
                        / max(1.0, want.abs().max().item())

                errs[f"d{d}.{dname}"] = {
                    "o": rel(o, ro), "lse": (lse - rlse).abs().max().item(),
                    "grads": max(rel(g, r) for g, r in zip(grads, rgrads))}
        print(json.dumps({"variant": name, "errors": errs,
                          "backward_two_calls_bit_equal": same}), flush=True)
    order = names + names[::-1]
    for b, h, d in shapes:
        for dname, dt in dtypes:
            q, k, v, do = (torch.randn(b, 1024, h, d, generator=gen,
                                       device=dev).to(dt) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            times = {}
            for name in order:
                fa._FN.update(fns[name])
                o, lse = fa._launch(q, k, v, True, scale, None)
                delta = fa._launch_delta(o, do)
                row = times.setdefault(name, {"fwd": [], "dq": [],
                                              "dkv": []})
                row["fwd"].append(device_ms(
                    lambda: fa._launch(q, k, v, True, scale, None)))
                row["dq"].append(device_ms(lambda: fa._launch_dq(
                    q, k, v, do, lse, delta, True, scale, None)))
                row["dkv"].append(device_ms(lambda: fa._launch_dkv(
                    q, k, v, do, lse, delta, True, scale, None)))
            print(json.dumps({"shape": [b, 1024, h, d], "dtype": dname,
                              "device_ms": times}), flush=True)
            del q, k, v, do
            torch.cuda.empty_cache()
    for src in SOURCES:            # the sources' own libraries again
        fa._FN.pop(src, None)


if __name__ == "__main__":
    chosen = sys.argv[1:] or list(VARIANTS)
    known = [*VARIANTS, *STREAM_VARIANTS]
    unknown = [n for n in chosen if n not in known]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {known}")
    sys.exit(main(chosen))
