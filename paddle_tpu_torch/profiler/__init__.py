"""Profiler.

Ports paddle_tpu/profiler/__init__.py (platform/profiler.{h,cc}
RecordEvent:127, EnableProfiler/DisableProfiler:210-213, fluid/profiler.py
and tools/timeline.py): host ``RecordEvent`` trees kept in Python,
``start_profiler`` / ``stop_profiler``, ``host_events``, ``summary`` (sort
keys ``total``, ``calls``, ``avg`` / ``ave``, ``max``, ``min``),
``export_chrome_tracing``, the ``profiler`` context manager and the 2.x
``Profiler`` class.

The reference's device trace (``jax.profiler`` into ``log_dir``) becomes a
``torch.profiler.profile`` with the CPU and, where a CUDA device exists,
the CUDA activity; ``stop_profiler`` writes its chrome trace to
``<log_dir>/device_trace.json``. A RecordEvent measures host time only.
"""
import contextlib
import os
import threading
import time

_LOCAL = threading.local()
_ENABLED = [False]
_EVENTS = []  # (name, start_ns, end_ns, thread_id, depth)
_LOCK = threading.Lock()
# the device trace is PROCESS state (one per process), so it lives in
# module state: a stop_profiler from any thread ends it
_DEVICE_TRACE = [None]   # (torch.profiler.profile, log_dir) while running


class RecordEvent:
    """platform/profiler.h:127 RAII RecordEvent parity."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *a):
        self.end()

    def begin(self):
        if not hasattr(_LOCAL, "depth"):
            _LOCAL.depth = 0
        self._start = time.perf_counter_ns()
        _LOCAL.depth += 1

    def end(self):
        if self._start is None or not _ENABLED[0]:
            if hasattr(_LOCAL, "depth") and _LOCAL.depth > 0:
                _LOCAL.depth -= 1
            return
        end = time.perf_counter_ns()
        _LOCAL.depth -= 1
        with _LOCK:
            _EVENTS.append((self.name, self._start, end,
                            threading.get_ident(), _LOCAL.depth))


def start_profiler(state="All", tracer_option="Default", log_dir=None):
    """EnableProfiler parity; also starts the torch.profiler device trace
    when a log_dir is given."""
    _ENABLED[0] = True
    with _LOCK:
        _EVENTS.clear()
    if log_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        with _LOCK:
            prof.__enter__()
            _DEVICE_TRACE[0] = (prof, log_dir)


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    _ENABLED[0] = False
    with _LOCK:
        running, _DEVICE_TRACE[0] = _DEVICE_TRACE[0], None
    if running is not None:
        prof, log_dir = running
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "device_trace.json"))
    return summary(sorted_key)


def host_events():
    """Snapshot of the recorded host events, sorted by start time —
    (name, start_ns, end_ns, thread_id, depth) tuples, read under the
    lock so a concurrent RecordEvent.end is never seen half-way."""
    with _LOCK:
        evts = list(_EVENTS)
    evts.sort(key=lambda e: e[1])
    return evts


def summary(sorted_key=None):
    agg = {}
    for name, s, e, tid, depth in host_events():
        st = agg.setdefault(name, [0, 0.0, float("inf"), 0.0])
        dur = (e - s) / 1e6
        st[0] += 1
        st[1] += dur
        st[2] = min(st[2], dur)
        st[3] = max(st[3], dur)
    rows = [
        {"name": k, "calls": v[0], "total_ms": v[1], "min_ms": v[2],
         "max_ms": v[3], "avg_ms": v[1] / v[0] if v[0] else 0.0}
        for k, v in agg.items()
    ]
    return _sort_rows(rows, sorted_key)


def _sort_rows(rows, sorted_key):
    if sorted_key in ("total", None):
        rows.sort(key=lambda r: -r["total_ms"])
    elif sorted_key == "calls":
        rows.sort(key=lambda r: -r["calls"])
    elif sorted_key in ("avg", "ave"):
        rows.sort(key=lambda r: -r["avg_ms"])
    elif sorted_key == "max":
        rows.sort(key=lambda r: -r["max_ms"])
    elif sorted_key == "min":
        rows.sort(key=lambda r: -r["min_ms"])
    return rows


def export_chrome_tracing(path):
    """tools/timeline.py parity: chrome://tracing JSON through the merged
    exporter (``trace.export_chrome``): host events sorted by start time,
    plus whatever trace spans and counter samples exist."""
    from .. import trace as _trace

    _trace.export_chrome(path)
    return path


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path="/tmp/profile",
             log_dir=None):
    """fluid/profiler.py profiler context-manager parity."""
    start_profiler(state, log_dir=log_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class Profiler:
    """paddle.profiler.Profiler (2.x API shape) — wraps the same
    machinery."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, log_dir=None):
        self._log_dir = log_dir
        self._rows = None

    def start(self):
        start_profiler(log_dir=self._log_dir)

    def stop(self):
        self._rows = stop_profiler()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()

    def summary(self, sorted_by=None, **kw):
        """Rows from the last stop() (or the live buffer), honoring
        sorted_by ("total"|"calls"|"avg"|"max"|"min")."""
        if self._rows is None:
            return summary(sorted_by)
        return _sort_rows(list(self._rows), sorted_by)
