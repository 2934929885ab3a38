"""Build and load the port's CUDA kernels (no counterpart in paddle_tpu/).

Each source ``ops/csrc/<name>.cu`` is compiled on first use by nvcc into
its own shared library with a plain C interface, and loaded with ctypes::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``paddle_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, every header under csrc/ it includes (``#include
"x.cuh"``, followed through the headers' own includes) and the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
``build()`` starts one nvcc per source, all together, and waits for all of
them. A missing nvcc or a failed compile
raises: nothing falls back to a kernel's plain version. ptxas's register
and shared-memory report for each build is kept beside the library
(``build_log``), and ``sass_counts`` reads the built library's machine
code (``cuobjdump --dump-sass``) for its tensor-core instructions,
``kernel_sass_counts`` kernel by kernel.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}
_LOCK = threading.Lock()


def sources():
    """Names of every kernel source under csrc/ (without the .cu)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path():
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else the one on PATH,
    else /usr/local/cuda/bin/nvcc. Raises RuntimeError when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _local_headers(src):
    """Every file under csrc/ that `src` includes with quotes, directly or
    through another such header, in the order first reached."""
    seen, todo = [], [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_text()):
            path = (CSRC / inc).resolve()
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def _target(name):
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for header in _local_headers(src):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None):
    """Compile the named sources (default: all) that are not built yet,
    one nvcc process each, all started together. Returns {name: seconds
    spent building} (0.0 for a library that was already there). Raises
    RuntimeError naming every source that failed, with nvcc's output."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    seconds = {}
    for name in names:
        src, so = _target(name)
        if so.is_file():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in running.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name):
    """nvcc's output (ptxas's per-kernel register and shared-memory
    report) from the build of `name`, or "" if it was built elsewhere."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def ptxas_report(name):
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} from
    ptxas's report in `name`'s build log, kernels by their mangled names
    ({} if it was built elsewhere)."""
    report, kernel = {}, None
    for line in build_log(name).splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernel = entry.group(1)
            report[kernel] = {"registers": None, "spill_bytes": 0}
            continue
        if kernel is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            report[kernel]["spill_bytes"] = int(spill.group(1)) \
                + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report[kernel]["registers"] = int(used.group(1))
    return report


#: tensor-core instructions in SASS: Hopper's warpgroup MMA, and mma.sync
TENSOR_CORE_OPS = ("HGMMA", "HMMA")
#: the TF32 form of mma.sync (m16n8k8, e.g. HMMA.1688.F32.TF32)
_TF32_HMMA = re.compile(r"\bHMMA\.[0-9A-Z.]*TF32\b")


def _dump_sass(name):
    """The machine code of kernel source `name`'s built library, as the
    cuobjdump beside nvcc prints it. Raises RuntimeError if it cannot
    run."""
    so = _target(name)[1]
    if not so.is_file():
        raise RuntimeError(f"{name} is not built")
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(so)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump on {so.name} failed: {out.stderr}")
    return out.stdout


def _tensor_core_counts(sass):
    counts = {op: len(re.findall(rf"\b{op}\.", sass))
              for op in TENSOR_CORE_OPS}
    counts["HMMA.TF32"] = len(_TF32_HMMA.findall(sass))
    return counts


def sass_counts(name):
    """{opcode: count} of the tensor-core instructions (TENSOR_CORE_OPS) in
    the machine code of kernel source `name`'s built library, read with
    the cuobjdump beside nvcc, and under "HMMA.TF32" those HMMA that take
    TF32 operands. Raises RuntimeError if it cannot run."""
    return _tensor_core_counts(_dump_sass(name))


def kernel_sass_counts(name):
    """sass_counts for each kernel of source `name`'s built library:
    {kernel by its mangled name, as ptxas_report names it: {opcode:
    count}}."""
    blocks = re.split(r"\n\s*Function : ", _dump_sass(name))[1:]
    return {block.split("\n", 1)[0].strip(): _tensor_core_counts(block)
            for block in blocks}


def load(name):
    """The ctypes library of kernel source `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)[1]))
        return lib


def stream(t):
    """The raw handle of the current CUDA stream on tensor t's device, as
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives it, without
    building a Stream object on every launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(lib, name, err):
    """Raise if kernel `name`'s C entry returned a nonzero cudaError_t,
    with CUDA's own text for it (``<name>_error_string``)."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({fn(err).decode(errors='replace')})")
