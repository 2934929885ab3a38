"""Device cost registry: per-call-signature FLOPs, bytes and memory.

Ports paddle_tpu/trace/costs.py. The reference captures XLA's
``cost_analysis()`` / ``memory_analysis()`` of every compiled executable
into a table keyed ``(site, sig)``. PyTorch runs eagerly, so the port has
no executable to ask: :class:`count` runs ONE call of the work under
``torch.utils.flop_counter.FlopCounterMode`` and a byte-counting dispatch
mode, and reads the peak-memory delta from
``torch.cuda.reset_peak_memory_stats`` / ``max_memory_allocated``;
:func:`record` files the result under ``(site, sig)``. The call runs the
same ops and kernels as an uncounted one, so its results are bit-equal.

- ``flops``: the counter's total. It sees aten ops only; the port's kernel
  launches are ``torch.library`` custom ops with flop formulas registered
  where they are defined (``paddle_tpu_torch::flash_fwd`` /
  ``::flash_bwd`` in ops/flash_attention.py: 4·d a key-query pair
  forward, 6·d for dQ and 8·d for dK/dV; ``::tpp_matmul`` in ops/tpp.py:
  2·M·N·K). Elementwise ops, norms, softmax and the optimizer count 0,
  as in XLA's count of a matmul-bound program they are a small part.
- ``bytes_accessed``: each op's input and output bytes, summed over the
  ops (the sum XLA's "bytes accessed" makes per instruction).
- ``argument_bytes``, ``temp_bytes``, ``peak_bytes`` (CUDA only): the
  memory allocated before the call, the peak above it during the call,
  and their sum. Counting resets the device's peak-memory statistic.

Gauges, as in the reference: ``program_flops{site,sig}``,
``program_hbm_bytes{site,kind}`` (kind in ``peak|argument|temp``) and
``device_hbm_used_bytes{device}`` (:func:`sample_device_memory`, from
``torch.cuda.memory_stats()``).

Joined with measured step wall time this is the MFU layer:
``SpmdTrainer.stats()["mfu"]`` and ``ServingEngine.stats()["breakdown"]``.
:func:`peak_flops` and :func:`peak_hbm_bandwidth` take the NVIDIA kinds
the port runs on from their datasheets (dense bf16); unknown kinds and the
CPU get the reference's nominal 1e12 FLOP/s and 1e11 B/s, so MFU stays
finite but means nothing there.
"""
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .. import flags as _flags
from .. import monitor as _monitor

__all__ = ["record", "record_manual", "get", "table", "reset", "count",
           "sample_device_memory", "peak_flops", "peak_hbm_bandwidth"]

_flags.define_flag(
    "device_peak_flops", 0.0,
    "peak device FLOP/s used as the MFU denominator; 0 = auto from the "
    "device kind table (unknown kinds fall back to a nominal 1e12 so "
    "MFU stays finite — absolute values are only meaningful on known "
    "hardware)")

_LOCK = threading.Lock()
_TABLE = {}   # (site, sig) -> entry dict

_FLOPS_G = None
_HBM_G = None
_DEV_G = None

_HBM_KINDS = ("peak", "argument", "temp")

#: (name substring, unless substring, dense bf16 FLOP/s, HBM B/s) by
#: ``torch.cuda.get_device_name()``, lower-cased, first hit wins. NVIDIA
#: datasheet values (H100 SXM5: 989.4 TFLOP/s bf16 dense, 3.35 TB/s;
#: H100 PCIe: 756 TFLOP/s, 2.0 TB/s), not measured here.
_PEAKS_BY_KIND = (
    ("h100", "pcie", 989e12, 3.35e12),
    ("h100", None, 756e12, 2.0e12),
)
_NOMINAL_PEAK = 1e12
_NOMINAL_HBM_BW = 1e11


def _gauges():
    global _FLOPS_G, _HBM_G, _DEV_G
    if _FLOPS_G is None:
        _FLOPS_G = _monitor.gauge(
            "program_flops",
            "per-call FLOPs of a counted call signature (FlopCounterMode "
            "over one call)", labelnames=("site", "sig"))
        _HBM_G = _monitor.gauge(
            "program_hbm_bytes",
            "device memory of the site's most recently counted call by "
            "kind (per-sig detail in trace.costs.table())",
            labelnames=("site", "kind"))
        _DEV_G = _monitor.gauge(
            "device_hbm_used_bytes",
            "live device memory in use (torch.cuda.memory_stats())",
            labelnames=("device",))
    return _FLOPS_G, _HBM_G, _DEV_G


class _BytesMode(TorchDispatchMode):
    """Sums every op's input and output tensor bytes; a view op moves
    nothing and counts nothing."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False):
            return out
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.nbytes += t.numel() * t.element_size()
        return out


class count:
    """``with count(device) as c: <one call>`` — the call's FLOPs
    (``c.flops``), bytes accessed (``c.bytes_accessed``) and, on a CUDA
    device, ``c.memory``: {"argument_bytes", "temp_bytes",
    "peak_bytes"}. Resets the device's peak-memory statistic."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        self.flops = 0
        self.bytes_accessed = 0
        self.memory = {}

    def __enter__(self):
        if self._cuda is not None:
            self._base = torch.cuda.memory_allocated(self._cuda)
            torch.cuda.reset_peak_memory_stats(self._cuda)
        self._flop = FlopCounterMode(display=False)
        self._bytes = _BytesMode()
        self._flop.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flop.__exit__(*exc)
        self.flops = int(self._flop.get_total_flops())
        self.bytes_accessed = int(self._bytes.nbytes)
        if self._cuda is not None:
            peak = torch.cuda.max_memory_allocated(self._cuda)
            self.memory = {"argument_bytes": int(self._base),
                           "temp_bytes": int(peak - self._base),
                           "peak_bytes": int(peak)}
        return False


def record(site, sig, flops, bytes_accessed=0.0, memory=None):
    """File one call signature's cost under (site, sig): its FLOPs, bytes
    accessed and (optional) memory dict (``argument_bytes``,
    ``temp_bytes``, ``peak_bytes``). Returns the entry dict."""
    entry = {"site": str(site), "sig": str(sig), "flops": float(flops),
             "bytes_accessed": float(bytes_accessed)}
    entry.update(memory or {})
    with _LOCK:
        _TABLE[(str(site), str(sig))] = entry
    if _monitor.is_enabled():
        flops_g, hbm_g, _ = _gauges()
        flops_g.labels(site=site, sig=sig).set(entry["flops"])
        for kind in _HBM_KINDS:
            v = entry.get(f"{kind}_bytes")
            if v is not None:
                hbm_g.labels(site=site, kind=kind).set(v)
    return dict(entry)


def record_manual(site, sig, flops=0.0, bytes_accessed=0.0):
    """Capture an ANALYTIC cost entry under (site, sig). Repeated calls
    ACCUMULATE (a kernel invoked N times reports N times its per-call
    cost) and bump a ``calls`` field; the same flops gauge as
    :func:`record` is updated. Never raises."""
    try:
        with _LOCK:
            entry = _TABLE.get((str(site), str(sig)))
            if entry is None:
                entry = {"site": str(site), "sig": str(sig),
                         "flops": 0.0, "bytes_accessed": 0.0, "calls": 0}
                _TABLE[(str(site), str(sig))] = entry
            entry["flops"] += float(flops)
            entry["bytes_accessed"] += float(bytes_accessed)
            entry["calls"] += 1
            snap = dict(entry)
        if _monitor.is_enabled():
            flops_g, _, _ = _gauges()
            flops_g.labels(site=site, sig=sig).set(snap["flops"])
        return snap
    except Exception:
        return None


def get(site, sig):
    """The captured entry for (site, sig), or None."""
    with _LOCK:
        return _TABLE.get((str(site), str(sig)))


def table():
    """Snapshot of every captured entry (list of dicts)."""
    with _LOCK:
        return [dict(v) for v in _TABLE.values()]


def reset():
    with _LOCK:
        _TABLE.clear()


def sample_device_memory():
    """Set device_hbm_used_bytes{device} from torch.cuda.memory_stats()
    for every CUDA device; returns {device_str: bytes_in_use}. Without a
    CUDA device nothing is reported — the gauge stays absent."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_stats(i).get("allocated_bytes.all.current")
        if used is None:
            continue
        name = f"cuda:{i}"
        out[name] = int(used)
        if _monitor.is_enabled():
            _gauges()[2].labels(device=name).set(int(used))
    return out


def _kind(device):
    """The lower-cased device kind: ``torch.cuda.get_device_name`` of a
    CUDA device, "cpu" for the host. `device`: None (the current CUDA
    device, or the host without one), a torch.device or device string, or
    any other string, taken as the kind itself."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            return device.lower()
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).lower()
    return device.type


def _peaks(device):
    kind = _kind(device)
    for needle, unless, flops, bw in _PEAKS_BY_KIND:
        if needle in kind and (unless is None or unless not in kind):
            return flops, bw
    return _NOMINAL_PEAK, _NOMINAL_HBM_BW


def peak_flops(device=None):
    """The MFU denominator: FLAGS_device_peak_flops when set, else the
    device-kind table (dense bf16), else a nominal 1e12."""
    override = float(_flags.get_flag("device_peak_flops", 0.0) or 0.0)
    if override > 0:
        return override
    return _peaks(device)[0]


def peak_hbm_bandwidth(device=None):
    """Peak device-memory bytes/s from the device-kind table, else a
    nominal 1e11."""
    return _peaks(device)[1]
