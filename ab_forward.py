"""Time GPT-2 small's eval forward through the PyTorch/CUDA port, for two
or more checkouts of the repository in alternation, on one CUDA device.

    python3 ab_forward.py [--samples 20] [--rounds 2] DIR [DIR ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). In
round r the checkouts run in order, reversed on every other round (A B B A
for two checkouts and two rounds), each in a process of its own that
imports the port from its DIR, builds GPT-2 small (vocab 50304, hidden
768, 12 layers, 12 heads, random weights from seed 0) in bf16 and runs
the forward at 4 x 1024 with FLAGS_tpp_kernels off and then on: 2
warm-ups, then `--samples` timed calls. A call's ``wall_ms`` is the host
clock around a synchronised forward, as chip_smoke.py times it;
``enqueue_ms`` is the host clock until the forward returns, before the
synchronise: where it is close to ``wall_ms`` the host, not the device,
sets the pace. Prints one JSON line per process, then a summary line
(median, min and max of every checkout's samples, pooled over rounds).
It imports neither jax nor the JAX package.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def worker(root, samples):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = GPTConfig.small()
    model = GPTForCausalLM(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
    model = model.eval().to(torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    out = {"root": root}
    for on in (False, True):
        set_flags({"tpp_kernels": on})
        wall, enqueue = [], []
        with torch.no_grad():
            for i in range(2 + samples):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits = model(ids)
                t_enq = time.perf_counter()
                torch.cuda.synchronize()
                t_end = time.perf_counter()
                if i >= 2:
                    wall.append((t_end - t) * 1e3)
                    enqueue.append((t_enq - t) * 1e3)
                del logits
        out[f"tpp_{'on' if on else 'off'}"] = {"wall_ms": wall,
                                              "enqueue_ms": enqueue}
    set_flags({"tpp_kernels": False})
    print(json.dumps(out), flush=True)


def summary(runs):
    """{root: {cell: {metric: {median, min, max, n}}}} over every run of
    each root."""
    pooled = {}
    for run in runs:
        for cell in ("tpp_off", "tpp_on"):
            for metric, vals in run[cell].items():
                pooled.setdefault(run["root"], {}).setdefault(
                    cell, {}).setdefault(metric, []).extend(vals)
    return {root: {cell: {m: {"median": statistics.median(v), "min": min(v),
                              "max": max(v), "n": len(v)}
                          for m, v in metrics.items()}
                   for cell, metrics in cells.items()}
            for root, cells in pooled.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.roots[0], args.samples)
        return
    runs = []
    for r in range(args.rounds):
        order = args.roots if r % 2 == 0 else args.roots[::-1]
        for root in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "--samples", str(args.samples), root],
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr)
                raise SystemExit(f"{root}: exit {proc.returncode}")
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    print(json.dumps({"summary": summary(runs)}))


if __name__ == "__main__":
    main()
