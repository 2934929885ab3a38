"""Time the port's kernels for two or more checkouts of the repository in
alternation, on one CUDA device.

    python3 ab_kernels.py [--rounds 2] [--cases main|wide_heads|paged_stream]
                          DIR [DIR ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). In
round r the checkouts run in order, reversed on every other round (A B B A
for two checkouts and two rounds), each in a process of its own that
imports the port from its DIR, builds its kernels and times one table of
cases (``CASES``). ``main`` (the default):

- paged attention (``ops.tpp._paged_kernel_call``) at GPT-2 small's
  engine widths (8 rows, 12 heads, head dim 64, 16-column frames, 64
  frames a row, a pool of 513 frames): at full length (every row 1024
  columns) and at the live pool's lengths after 64 decode steps as
  chip_smoke.py found them (105-179 columns), bf16 q and pages, fp32 q
  and pages, fp32 q on int8 pages with their row scales;
- the flash forward (``ops.flash_attention._launch``) in fp32 at b4 and
  b16 and in bf16 at b4 (s 1024, h 12, d 64, causal), and the fp32
  backward (``_launch_bwd``: delta pre-pass, dQ, dK/dV) at b4 and b16;
  with a sha256 of the fp32 backward's dq, dk and dv at b4 from the
  plain forward's o and lse, which two checkouts whose backward kernels
  give the same bits share;
- ``ops.tpp.softmax_rows`` in fp32 and bf16 at [49152, 1024] (the
  attention-score rows of b4 h12 s1024, std 3);
- GPT-2 small (vocab 50304, hidden 768, 12 layers, 12 heads, dropout 0,
  random weights from seed 0) with FLAGS_tpp_kernels off: the fp32 eval
  forward at 4 x 1024 and the training step at 16 x 1024 (SpmdTrainer +
  AdamW lr 1e-4, ids and labels as chip_smoke.py draws them) in fp32 and
  under bf16 ``amp.auto_cast`` (bench.py's headline step); ``wall_ms``,
  the host clock around a synchronised call, median of 10 forwards after
  2 warm-ups and of 5 steps after 1.

``wide_heads``: the flash kernels at the wide head dims, causal, seq
1024, in fp32 and bf16, at b1 h2 (a grid under the card's 132 SMs) and
b4 h16 (one that fills it many times over): head_dim 576 (``STREAM_
SHAPES``, above every whole-head tiling) and 256 and 512 (``WIDE_SHAPES``,
the head dims whose scalar kernels the streaming route replaced; the bf16
forward at 256 takes the mma kernel and is timed as what it is):

- the forward (``ops.flash_attention._launch``), the backward as
  autograd runs it (``_launch_bwd``: delta pre-pass, dQ, dK/dV in one C
  call) and the dQ and dK/dV kernels alone (``_launch_dq``,
  ``_launch_dkv``), each with the routes its launches took, and a sha256
  of the backward's dq, dk and dv over two calls (one digest where the
  two calls give the same bits);
- beside each: the plain version (``flash_attention_ref``,
  ``flash_attention_bwd_ref`` on [B*H, S, D] copies), and
  ``torch.nn.functional.scaled_dot_product_attention`` on the same values
  in [B, H, S, D], forward, and its backward through autograd (the three
  grads), and the bound: the larger of the FLOPs (4 d a visible (q, k)
  pair forward, 10 d backward) over 989 (bf16) or 67 (fp32) TFLOP/s and
  each input and output once over 3.35 TB/s; every launch's route
  (``flash_attention.routes``).

``paged_stream``: paged attention past the split kernel's caps (the
stream route, ``ops.tpp._paged_kernel_call(..., route="stream")``) at
chip_smoke.py's three ``PAGED_STREAM_SHAPES`` (B 8, H 4: hd 512 on
16-column frames, hd 64 on 512-column frames, hd 512 on 512-column
frames; random lengths, row 0 empty), bf16 q and pages, fp32 q and
pages, fp32 q on int8 pages with their row scales: the kernel's ms and
device_ms beside SDPA's on the pre-gathered dense layout with the length
mask (gather excluded), the bytes bound (each valid column's K and V row
and scales once, q, out, the table entries and lengths, at 3.35 TB/s),
the launch's plan where the checkout's ``_paged_kernel_call`` returns one
(the route the C entry took, columns a split, splits a row, columns a
tile, ring depth), and a sha256 of the outputs of two calls (one digest
where they give the same bits); and the device µs of each paged kernel of
one call (``torch.profiler``, the median of 10 calls, L2 flushed between
them: the stream kernel and its combine pass).

Every input comes from seeded generators, the same in every process.
Times as chip_smoke.py takes them: CUDA events around one call, median of
20 after 3 warm-ups, 64 MB written between calls to flush L2; ``ms`` with
the host's enqueue inside the window, ``device_ms`` after a ~0.5 ms
device sleep that hides it. Prints one JSON line per process, then a
summary line (median, min and max of every checkout's times, pooled over
rounds, the set of each checkout's digests, and the bounds and routes of
its first round), and the card's name and power limit. It imports neither
jax nor the JAX package.
"""
import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

SLEEP_CYCLES = 1_000_000
LIVE_LENGTHS = (140, 143, 160, 163, 163, 105, 179, 117)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
WIDE_SEQ = 1024
STREAM_SHAPES = ((1, 2, 576), (4, 16, 576))     # (b, h, d)
WIDE_SHAPES = ((1, 2, 256), (1, 2, 512), (4, 16, 256), (4, 16, 512))


def bound(flops, nbytes, dname):
    """(ms, what binds): the larger of flops over the dtype's peak and
    bytes over the memory rate."""
    t_ops, t_mem = flops / PEAK_FLOPS[dname], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem \
        else "bytes"


def worker(root, cases):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)

    def time_ms(fn, hide_enqueue=False, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if hide_enqueue:
                torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    out = {"root": root}
    CASES[cases](torch, dev, time_ms, out)
    print(json.dumps(out), flush=True)


def main_cases(torch, dev, time_ms, out):
    """The ``main`` table: paged attention, the d 64 flash kernels,
    softmax_rows and GPT-2 small's forward and steps."""
    from paddle_tpu_torch.distributed import compress
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import tpp

    def both(fn):
        return {"ms": time_ms(fn), "device_ms": time_ms(fn, True)}

    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, hd, bs, maxb, NB = 8, 12, 64, 16, 64, 513
    kp = torch.randn(NB, H, bs, hd, generator=gen, device=dev)
    vp = torch.randn(NB, H, bs, hd, generator=gen, device=dev)
    (kq, ks), (vq, vs) = compress.quantize_rows(kp), compress.quantize_rows(vp)
    tables = torch.stack([torch.randperm(NB - 1, generator=gen, device=dev)
                          [:maxb] + 1 for _ in range(B)]).int()
    lengths = {"full_length": torch.full((B,), maxb * bs, dtype=torch.int32,
                                         device=dev),
               "live_pool": torch.tensor(LIVE_LENGTHS, dtype=torch.int32,
                                         device=dev)}
    q32 = torch.randn(B, H, hd, generator=gen, device=dev)
    cases = {"dense[bfloat16]": (q32.bfloat16(), kp.bfloat16(),
                                 vp.bfloat16(), None, None),
             "dense[float32]": (q32, kp, vp, None, None),
             "int8[float32]": (q32, kq, vq, ks, vs)}
    for name, (q, k, v, sk, sv) in cases.items():
        for case, lens in lengths.items():
            out[f"paged_attention.{name}.{case}"] = both(
                lambda: tpp._paged_kernel_call(q, k, v, tables, lens, sk, sv))
    s, h, d = 1024, 12, 64
    for dname, dt, batches in (("float32", torch.float32, (4, 16)),
                               ("bfloat16", torch.bfloat16, (4,))):
        for b in batches:
            q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev)
                           .to(dt) for _ in range(4))
            with torch.no_grad():
                out[f"flash_fwd[{dname}].b{b}"] = both(
                    lambda: fa._launch(q, k, v, True, d ** -0.5, None))
                if dname == "float32":
                    o, lse = fa._launch(q, k, v, True, d ** -0.5, None)
                    out[f"flash_bwd_pair[{dname}].b{b}"] = both(
                        lambda: fa._launch_bwd(q, k, v, o, lse, do, True,
                                               d ** -0.5, None))
                    if b == 4:
                        o3, lse = fa.flash_attention_ref(
                            *(fa._heads(t) for t in (q, k, v)), True,
                            d ** -0.5)
                        o = fa._unheads(o3, b, h).contiguous()
                        digest = hashlib.sha256()
                        for g in fa._launch_bwd(q, k, v, o, lse, do, True,
                                                d ** -0.5, None):
                            digest.update(g.cpu().numpy().tobytes())
                        out[f"flash_bwd_pair[{dname}].b{b}.sha256"] = \
                            digest.hexdigest()
            del q, k, v, do
            torch.cuda.empty_cache()
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        x = (torch.randn(49152, 1024, generator=gen, device=dev) * 3.0) \
            .to(dt)
        out[f"softmax_rows[{dname}]"] = both(lambda: tpp.softmax_rows(x))
        del x
    out.update(gpt2_steps(dev))


def wide_head_cases(torch, dev, time_ms, out):
    """The ``wide_heads`` table: head_dim 576, 256 and 512, each beside its
    plain version, SDPA and its bound."""
    from paddle_tpu_torch.ops import flash_attention as fa

    def timed(fn):
        """ms, device_ms and the routes of one call of fn."""
        fa.routes.clear()
        fn()
        torch.cuda.synchronize()
        routes = sorted(k for k, n in fa.routes.items() if n)
        return {"ms": time_ms(fn), "device_ms": time_ms(fn, True),
                "routes": routes}

    gen = torch.Generator(device=dev).manual_seed(0)
    S = WIDE_SEQ
    pairs = S * (S + 1) // 2
    for kind, shapes in (("stream", STREAM_SHAPES), ("wide", WIDE_SHAPES)):
        for b, h, d in shapes:
            for dname, dt in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
                item = torch.finfo(dt).bits // 8
                q, k, v, do = (torch.randn(b, S, h, d, generator=gen,
                                           device=dev).to(dt)
                               for _ in range(4))
                scale = 1.0 / math.sqrt(d)
                with torch.no_grad():
                    o, lse = fa._launch(q, k, v, True, scale, None)
                    delta = fa._launch_delta(o, do)
                tag = f"{kind}.b{b}h{h}d{d}.{dname}"

                def fwd():
                    return fa._launch(q, k, v, True, scale, None)

                def bwd():
                    return fa._launch_bwd(q, k, v, o, lse, do, True, scale,
                                          None)

                with torch.no_grad():
                    out[f"{tag}.fwd"] = timed(fwd)
                    out[f"{tag}.bwd"] = timed(bwd)
                    out[f"{tag}.dq"] = timed(lambda: fa._launch_dq(
                        q, k, v, do, lse, delta, True, scale, None))
                    out[f"{tag}.dkv"] = timed(lambda: fa._launch_dkv(
                        q, k, v, do, lse, delta, True, scale, None))
                    grads = [bwd() for _ in range(2)]
                    digests = {hashlib.sha256(b"".join(
                        t.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes() for t in g)).hexdigest()
                        for g in grads}
                    out[f"{tag}.bwd.sha256"] = "|".join(sorted(digests))
                heads = [fa._heads(t).contiguous()
                         for t in (q, k, v, o, do)]
                with torch.no_grad():
                    out[f"{tag}.plain_fwd"] = timed(
                        lambda: fa.flash_attention_ref(*heads[:3], True,
                                                       scale))
                    out[f"{tag}.plain_bwd"] = timed(
                        lambda: fa.flash_attention_bwd_ref(
                            *heads[:4], lse, heads[4], True, scale))
                bhsd = [t.transpose(1, 2).contiguous().requires_grad_()
                        for t in (q, k, v)]
                with torch.no_grad():
                    out[f"{tag}.sdpa_fwd"] = timed(
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(*bhsd, is_causal=True))
                sdpa_o = torch.nn.functional.scaled_dot_product_attention(
                    *bhsd, is_causal=True)
                bdo = do.transpose(1, 2).contiguous()
                out[f"{tag}.sdpa_bwd"] = timed(lambda: torch.autograd.grad(
                    sdpa_o, bhsd, bdo, retain_graph=True))
                for part, flops_a_pair, n_tensors, n_rows in (
                        ("fwd", 4, 4, 1), ("bwd", 10, 8, 2), ("dq", 6, 5, 2),
                        ("dkv", 8, 6, 2)):
                    ms, by = bound(flops_a_pair * d * b * h * pairs,
                                   n_tensors * b * h * S * d * item
                                   + n_rows * b * h * S * 4, dname)
                    out[f"{tag}.{part}"].update(bound_ms=ms, bound_by=by)
                del q, k, v, do, o, lse, delta, heads, bhsd, sdpa_o, bdo
                torch.cuda.empty_cache()


PAGED_STREAM_SHAPES = ((8, 4, 512, 16, 64, 520), (8, 4, 64, 512, 4, 40),
                       (8, 4, 512, 512, 4, 40))   # B, H, hd, bs, maxb, NB


def kernel_us(torch, fn, flush, calls=10):
    """{kernel name: device µs a call, the median over `calls` calls with
    L2 flushed before each} of the paged kernels fn launches, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    per = {}
    for _ in range(calls):
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "paged" in e.key and e.device_time_total > 0:
                per.setdefault(e.key[:90], []).append(e.device_time_total
                                                      / e.count)
    return {k: statistics.median(v) for k, v in per.items()}


def paged_stream_cases(torch, dev, time_ms, out):
    """The ``paged_stream`` table: the stream route beside SDPA and its
    bound."""
    from paddle_tpu_torch.distributed import compress
    from paddle_tpu_torch.ops import tpp

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
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
        cols = int(lengths.long().sum())
        nblk = int(((lengths.long() + bs - 1) // bs).sum())
        for name, (q, k, v, sk, sv) in {
                "dense[bfloat16]": (q32.bfloat16(), kp.bfloat16(),
                                    vp.bfloat16(), None, None),
                "dense[float32]": (q32, kp, vp, None, None),
                "int8[float32]": (q32, kq, vq, ks, vs)}.items():
            def launch():   # (out, plan), or out in a checkout without a plan
                return tpp._paged_kernel_call(q, k, v, tables, lengths, sk,
                                              sv, route="stream")

            def kern():
                r = launch()
                return r[0] if isinstance(r, tuple) else r

            kg = tpp.gather_pages(k, tables, sk).to(q.dtype)
            vg = tpp.gather_pages(v, tables, sv).to(q.dtype)
            mask = (torch.arange(kg.shape[2], device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], kg, vg, attn_mask=mask)

            nbytes = (2 * H * hd * k.element_size() * cols
                      + (2 * H * 4 * cols if sk is not None else 0)
                      + 2 * B * H * hd * q.element_size() + 4 * nblk + 4 * B)
            ms, by = bound(4.0 * H * hd * cols, nbytes, "float32")
            tag = f"paged_stream.hd{hd}_bs{bs}.{name}"
            outs = {hashlib.sha256(kern().view(torch.uint8).cpu().numpy()
                                   .tobytes()).hexdigest() for _ in range(2)}
            out[tag] = {"ms": time_ms(kern), "device_ms": time_ms(kern, True),
                        "bound_ms": ms, "bound_by": by}
            r = launch()
            if isinstance(r, tuple):
                out[tag]["plan"] = r[1]
            out[f"{tag}.sdpa"] = {"ms": time_ms(sdpa),
                                  "device_ms": time_ms(sdpa, True)}
            out[f"{tag}.sha256"] = "|".join(sorted(outs))
            out[f"{tag}.profile_us"] = kernel_us(torch, kern, flush)
            del kg, vg
        torch.cuda.empty_cache()


def gpt2_steps(dev):
    """{cell: {"wall_ms": median}} of GPT-2 small's fp32 eval forward at
    4 x 1024 and its training step at 16 x 1024, fp32 and bf16 auto_cast
    (each from the same weights and fresh AdamW state)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
        GPTPretrainLoss
    from paddle_tpu_torch.optimizer import AdamW

    def wall_ms(fn, n, warmup):
        times = []
        for i in range(warmup + n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= warmup:
                times.append((time.perf_counter() - t) * 1e3)
        return {"wall_ms": statistics.median(times)}

    cfg = GPTConfig(hidden_size=768, num_layers=12, num_heads=12,
                    dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    ids, labels = (torch.as_tensor(rng.randint(0, cfg.vocab_size, (
        16, 1024)).astype(np.int32)).long().to(dev) for _ in range(2))
    out = {}
    model.eval()
    with torch.no_grad():
        out["gpt2_small_forward[float32].b4"] = wall_ms(
            lambda: model(ids[:4]), 10, 2)
    for dname, amp in (("float32", False), ("bf16_auto_cast", True)):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(0))
        trainer = SpmdTrainer(model, AdamW(learning_rate=1e-4,
                                           parameters=model.parameters()),
                              loss_fn=GPTPretrainLoss())

        def step():
            with auto_cast(amp, dtype="bfloat16"):
                return trainer.train_step(ids, labels).item()

        out[f"gpt2_small_train_step[{dname}].b16"] = wall_ms(step, 5, 1)
        del model, trainer
        torch.cuda.empty_cache()
    return out


CASES = {"main": main_cases, "wide_heads": wide_head_cases,
         "paged_stream": paged_stream_cases}
TIMED = ("ms", "device_ms", "wall_ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", choices=sorted(CASES), default="main")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.cases)
        return 0
    if not args.dirs:
        ap.error("give one or more checkout directories")
    runs = {d: [] for d in args.dirs}
    for r in range(args.rounds):
        for d in (args.dirs if r % 2 == 0 else args.dirs[::-1]):
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--cases", args.cases, "--worker", d],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
                return res.returncode
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[d].append(json.loads(line))
    summary = {}
    for d, rows in runs.items():
        summary[d] = {}
        for key, first in rows[0].items():
            if key == "root":
                continue
            if key.endswith(".sha256"):
                summary[d][key] = sorted({row[key] for row in rows})
                continue
            if key.endswith(".profile_us"):    # {kernel: µs}: the median
                summary[d][key] = {k: statistics.median(
                    row[key][k] for row in rows if k in row[key])
                    for k in first}
                continue
            for t, val in first.items():
                if t not in TIMED:     # a bound or the routes: round 1's
                    summary[d][f"{key}.{t}"] = val
                    continue
                vals = [row[key][t] for row in rows]
                summary[d][f"{key}.{t}"] = {
                    "median": statistics.median(vals), "min": min(vals),
                    "max": max(vals)}
    print(json.dumps({"summary": summary}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: "
          "no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
