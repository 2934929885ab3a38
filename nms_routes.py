"""Time the port's NMS kernel on one CUDA device: its entry point in two
or more checkouts of the repository in alternation, then each of its
routes in this checkout.

    python3 nms_routes.py [--rounds 2] [DIR ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). In
round r the checkouts run in order, reversed on every other round (A B B
A for two), each in a process of its own that imports the port from its
DIR and times ``ops.nms_pallas.nms_keep_mask`` (on the route its wrapper
picks, threshold 0.5) on

- PP-YOLOE's serving call's problems, [640, 400] (80 classes, width 64,
  depth 2, random weights from seed 0, 8 x 640 x 640 images as
  chip_smoke.py draws them; each (image, class)'s top 400 boxes);
- one random problem of 8192 boxes (chip_smoke.py's NMS_SINGLE draw),

with a sha256 of both keep masks, which checkouts that compute the same
masks share. Then one more process times this checkout's C entry on each
route and from two builds, at SHAPES, on random boxes drawn as
chip_smoke.py's NMS_RANDOM draws them:

- ``smem``: the smem route (no workspace; n <= 512 only);
- ``global``: the global route (the C entry takes it whenever it is
  given a workspace, at any n);
- ``smem_exact`` / ``global_exact``: the same routes built from a copy of
  the source whose IoUs all take ``__fdiv_rn`` (the fast quotient's gate
  forced false), i.e. the division the kernel used before ``div_fast``.

On the global route the profiler also splits one call's device time
between its mask and sweep kernels (``global_kernels_device_ms``, median
of 5 calls). Every keep mask of that process is checked against the
plain version.
Times as chip_smoke.py takes them: CUDA events around one call, median
of 20 after 3 warm-ups, 64 MB written between calls to flush L2; ``ms``
with the host's enqueue inside the window, ``device_ms`` after a ~0.5 ms
device sleep that hides it. Prints one JSON line per process, a summary
line (median, min and max of every checkout's times, pooled over rounds,
and the set of each checkout's digests), and the card's name and power
limit. It imports neither jax nor the JAX package.
"""
import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

SHAPES = ((640, 400), (132, 512), (32, 512), (1, 400), (640, 128),
          (1, 2048), (1, 8192))
SLEEP_CYCLES = 1_000_000
GATE = "fast && area_safe(ai)"
THR = 0.5


def time_ms(fn, flush, hide_enqueue=False, reps=20, warmup=3):
    import torch

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


def kernel_split(call, flush, reps=5):
    """{kernel: median device ms} of the kernels one call launches, read
    by torch.profiler over reps calls (L2 flushed before each); {} if the
    profiler records no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        name = re.search(r"nms_\w*kernel", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            ms.setdefault(name.group(0), []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {k: statistics.median(v) for k, v in ms.items()}


def random_boxes(p, n, gen, dev):
    """[p, n, 4] overlapping boxes, as chip_smoke.py's NMS_RANDOM."""
    import torch

    xy = torch.rand(p, n, 2, generator=gen, device=dev) * (40.0 + n / 20)
    wh = torch.rand(p, n, 2, generator=gen, device=dev) * 30.0 + 1.0
    return torch.cat([xy, xy + wh], dim=-1).contiguous()


def checkout_worker(root):
    """{entry: times or digest} of DIR's nms_keep_mask at [640, 400] (the
    PP-YOLOE serving call's problems) and [1, 8192] (random boxes)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import nms_pallas
    from paddle_tpu_torch.vision.models import PPYOLOE
    from paddle_tpu_torch.vision.ops import _sorted_desc

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    model = PPYOLOE(num_classes=80, width=64, depth=2, device=dev,
                    generator=torch.Generator().manual_seed(0)).eval()
    images = torch.as_tensor(np.random.RandomState(0).rand(
        8, 3, 640, 640).astype(np.float32), device=dev)
    with torch.no_grad():
        boxes, scores = model.decode(model(images))
    top_i = _sorted_desc(scores)[1][..., :400]
    problems = {"serving": torch.gather(
        boxes[:, None].expand(-1, scores.shape[1], -1, -1), 2,
        top_i[..., None].expand(-1, -1, -1, 4)).reshape(-1, 400, 4)
        .contiguous()}
    del model, images, boxes, scores
    problems["single"] = random_boxes(
        1, 8192, torch.Generator(device=dev).manual_seed(8192), dev)
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"root": root}
    for name, b in problems.items():
        key = f"nms[float32].{name}.{'x'.join(map(str, b.shape[:2]))}"
        keep = nms_pallas.nms_keep_mask(b, THR)

        def call():
            return nms_pallas.nms_keep_mask(b, THR)

        out[key] = {"ms": time_ms(call, flush),
                    "device_ms": time_ms(call, flush, hide_enqueue=True)}
        out[f"{key}.sha256"] = hashlib.sha256(
            keep.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(out), flush=True)


def routes_worker():
    """This checkout's C entry on each route, from the source and from its
    exact-division copy, at SHAPES: one JSON line per shape."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ctypes

    import torch

    from paddle_tpu_torch.ops import _build, nms_pallas

    dev = torch.device("cuda")
    text = (_build.CSRC / "nms.cu").read_text()
    if text.count(GATE) != 1:
        raise SystemExit(f"nms.cu: the fast quotient's gate {GATE!r} moved")
    exact = _build.BUILD_DIR / "nms_exact.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exact.write_text(text.replace(GATE, "false"))
    so = exact.with_suffix(".so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(exact)], check=True, capture_output=True)
    fns = {"": nms_pallas._kernel()[1],
           "_exact": nms_pallas._bind(ctypes.CDLL(str(so)))}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for p, n in SHAPES:
        b = random_boxes(p, n, gen, dev)
        want = nms_pallas.nms_keep_mask_ref(b, THR)
        keep = torch.empty((p, n), dtype=torch.bool, device=dev)
        work = torch.empty((p, -(-n // nms_pallas.WORD), n),
                           dtype=torch.int64, device=dev)
        row = {"shape": [p, n]}
        for tag, fn in fns.items():
            for route, ws in (("smem", None), ("global", work.data_ptr())):
                if ws is None and n > nms_pallas.SMEM_MAX_N:
                    continue

                def call():
                    err = fn(b.data_ptr(), keep.data_ptr(), ws, p, n, THR,
                             _build.stream(b))
                    if err:
                        raise RuntimeError(f"nms_keep_mask: CUDA error {err}")

                keep.zero_()
                call()
                if not torch.equal(keep, want):
                    raise SystemExit(f"[{p}, {n}] {route}{tag}: the keep "
                                     f"mask differs from the plain version")
                row[f"{route}{tag}_device_ms"] = time_ms(call, flush,
                                                         hide_enqueue=True)
                if route == "global" and not tag:
                    row["global_kernels_device_ms"] = kernel_split(call,
                                                                   flush)
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--routes", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args()
    if args.worker:
        checkout_worker(args.worker)
        return 0
    if args.routes:
        routes_worker()
        return 0

    def run(*argv):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *argv], capture_output=True, text=True,
                             check=True)
        lines = res.stdout.strip().splitlines()
        print("\n".join(lines), flush=True)
        return lines

    runs = {d: [] for d in args.dirs}
    for r in range(args.rounds if args.dirs else 0):
        for d in (args.dirs if r % 2 == 0 else args.dirs[::-1]):
            runs[d].append(json.loads(run("--worker", d)[-1]))
    summary = {}
    for d, rows in runs.items():
        summary[d] = {}
        for key in rows[0]:
            if key.endswith(".sha256"):
                summary[d][key] = sorted({row[key] for row in rows})
            elif key != "root":
                for t in ("ms", "device_ms"):
                    vals = [row[key][t] for row in rows]
                    summary[d][f"{key}.{t}"] = {
                        "median": statistics.median(vals), "min": min(vals),
                        "max": max(vals)}
    print(json.dumps({"summary": summary}), flush=True)
    run("--routes")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else
          "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
