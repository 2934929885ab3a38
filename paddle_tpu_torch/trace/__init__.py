"""Structured tracing: spans with explicit trace/span ids and parent links.

Ports paddle_tpu/trace/__init__.py. Every span carries a ``trace_id`` (one
per logical unit of work: a serving request, a train step), a ``span_id``
and a ``parent_id``, so a single slow request can be followed across
queue-wait, prefill and decode steps even when those slices interleave
with other requests inside the same engine step.

Three ways to produce a span:

- ``with span("name", subsystem="serving", **attrs):`` — nests on a
  thread-local stack (parent/trace ids inherited automatically);
- ``s = start_span(...); ...; s.end(**attrs)`` — explicit lifetime for
  work that crosses function/step boundaries (a request's root span
  lives from ``submit()`` to its finish reason);
- ``emit(name, start_ns=..., end_ns=..., ...)`` — retro-record a slice
  whose window was measured with ``time.perf_counter_ns()`` (the serving
  engine emits one per-slot ``decode`` span per batched step).

**On the card a span measures host time only**: timestamps come from
``time.perf_counter_ns`` and nothing synchronizes with the device, so a
span around a kernel launch ends when the launch is enqueued, not when
the kernel finishes (a span that ends at a host read of a device value —
the engine's token fetch — does include the device work before it). The
device's own timeline is ``torch.profiler``'s (the ``profiler`` module's
``log_dir``).

Spans land in a bounded thread-safe ring buffer (``FLAGS_trace_buffer``
capacity; oldest dropped) and, when ``FLAGS_trace_log_path`` is set, are
appended as JSONL through the monitor event-log writer. Disabled mode
(``FLAGS_trace`` unset, the default) is ONE boolean check per call.
After ``set_flags({"trace": ...})`` call :func:`sync_from_flag` (or
:func:`enable`), as in the reference.

``export_chrome(path)`` merges three sources into one chrome://tracing
JSON: profiler RecordEvent host events, trace spans (one chrome *process*
per subsystem, flow events linking every multi-span trace_id) and
span-boundary counter samples (``add_counter_sample``) as ph="C" tracks.

The sibling :mod:`paddle_tpu_torch.trace.costs` is the device cost
registry (FLOPs and peak memory per call signature), joined with step
times for ``SpmdTrainer.stats()["mfu"]`` and
``ServingEngine.stats()["breakdown"]``.
"""
import collections
import contextlib
import itertools
import json
import threading
import time

from .. import flags as _flags

__all__ = [
    "Span", "span", "start_span", "emit", "current_span", "new_trace_id",
    "enable", "disable", "is_enabled", "sync_from_flag", "clear",
    "spans", "open_spans", "set_capacity", "capacity", "summary",
    "top_spans", "add_counter_sample", "counter_samples", "export_chrome",
    "load_spans", "costs",
]

_flags.define_flag(
    "trace", False,
    "structured span tracing on/off (trace/); off turns every span call "
    "site into one boolean check")
_flags.define_flag(
    "trace_buffer", 4096,
    "span ring-buffer capacity; the oldest spans are dropped past it so "
    "a long-lived traced server cannot OOM the host on span bookkeeping")
_flags.define_flag(
    "trace_log_path", "",
    "JSONL span log path (one 'span' event per finished span via the "
    "monitor event-log writer); empty = ring buffer only")

_ENABLED = [False]          # the ONE read on the disabled fast path
_LOCK = threading.Lock()
_TLS = threading.local()
_SPAN_IDS = itertools.count(1)
_TRACE_IDS = itertools.count(1)
_BUF = collections.deque(maxlen=int(_flags.get_flag("trace_buffer", 4096)))
_SAMPLES = collections.deque(maxlen=4096)   # (ts_ns, name, value)
_OPEN = {}                  # span_id -> OPEN Span (entered/started, not
_OPEN_CAP = 8192            # yet ended) — the live span tree


def is_enabled():
    return _ENABLED[0]


def enable():
    _ENABLED[0] = True


def disable():
    _ENABLED[0] = False


def sync_from_flag():
    """Re-read FLAGS_trace/FLAGS_trace_buffer (after paddle.set_flags)."""
    _ENABLED[0] = bool(_flags.get_flag("trace", False))
    set_capacity(int(_flags.get_flag("trace_buffer", 4096)))


def new_trace_id():
    """A process-unique trace id (one per logical unit of work)."""
    return f"t{next(_TRACE_IDS):08x}"


def set_capacity(n):
    """Resize the ring buffer (keeps the newest spans)."""
    global _BUF
    n = max(1, int(n))
    if n == _BUF.maxlen:
        return
    with _LOCK:
        _BUF = collections.deque(_BUF, maxlen=n)


def capacity():
    return _BUF.maxlen


def clear():
    with _LOCK:
        _BUF.clear()
        _SAMPLES.clear()
        _OPEN.clear()


def spans():
    """Snapshot of the ring buffer (oldest first)."""
    with _LOCK:
        return list(_BUF)


def open_spans():
    """Every span currently OPEN (entered or started, not yet ended) as
    dicts with end_ns=None — the live span tree, so a wedge shows WHICH
    requests/steps were mid-flight."""
    with _LOCK:
        return [sp.to_dict() for sp in _OPEN.values()]


def _track_open(sp):
    with _LOCK:
        if len(_OPEN) >= _OPEN_CAP:   # leaked never-ended spans must not
            _OPEN.pop(next(iter(_OPEN)))   # grow the table without bound
        _OPEN[sp.span_id] = sp
    # flight-recorder OPEN digest (one boolean check when the recorder
    # is off): a span that never closes is exactly the wedge evidence
    _blackbox.note("span_open", name=sp.name, subsystem=sp.subsystem,
                   trace_id=sp.trace_id)


def counter_samples():
    with _LOCK:
        return list(_SAMPLES)


def add_counter_sample(name, value):
    """Record one (ts, name, value) counter sample — rendered as a ph='C'
    track by export_chrome. Call sites sample at span boundaries (the
    serving step samples batch occupancy, the trainer step latency)."""
    if not _ENABLED[0]:
        return
    with _LOCK:
        _SAMPLES.append((time.perf_counter_ns(), str(name), float(value)))


def _stack():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_span():
    """The innermost OPEN context-manager span on this thread, or None —
    the attribute-attachment hook: current_span().set(k=v)."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


class _NoopSpan:
    """Returned by span()/start_span() when tracing is off: every method
    is a no-op so call sites need no second flag check."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        return self


_NOOP = _NoopSpan()


class Span:
    """One timed slice with identity and a parent link."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "subsystem",
                 "attrs", "start_ns", "end_ns", "tid", "_pushed")

    def __init__(self, name, trace_id=None, parent_id=None, subsystem=None,
                 attrs=None, start_ns=None):
        self.name = str(name)
        self.trace_id = trace_id
        self.span_id = next(_SPAN_IDS)
        self.parent_id = parent_id
        self.subsystem = subsystem
        self.attrs = dict(attrs) if attrs else {}
        self.start_ns = (time.perf_counter_ns() if start_ns is None
                         else int(start_ns))
        self.end_ns = None
        self.tid = threading.get_ident()
        self._pushed = False

    # -- context-manager form (thread-local nesting) ----------------------
    def __enter__(self):
        st = _stack()
        if self.parent_id is None and st:
            self.parent_id = st[-1].span_id
            if self.trace_id is None:
                self.trace_id = st[-1].trace_id
        if self.trace_id is None:
            self.trace_id = new_trace_id()
        self.start_ns = time.perf_counter_ns()   # exclude setup time
        st.append(self)
        self._pushed = True
        _track_open(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._pushed:
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            else:                       # tolerate unbalanced exits
                try:
                    st.remove(self)
                except ValueError:
                    pass
            self._pushed = False
        if exc_type is not None:
            # a failing with-block still records its span, marked — the
            # failing step is exactly what a trace gets pulled for
            self.attrs.setdefault("error", True)
        self.end()
        return False

    # -- explicit form ----------------------------------------------------
    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def end(self, **attrs):
        """Stamp the end time and record the span (idempotent)."""
        if self.end_ns is not None:
            return self
        with _LOCK:
            _OPEN.pop(self.span_id, None)
        if attrs:
            self.attrs.update(attrs)
        if self.trace_id is None:
            self.trace_id = new_trace_id()
        self.end_ns = time.perf_counter_ns()
        _record(self)
        return self

    @property
    def duration_ms(self):
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    def to_dict(self):
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "subsystem": self.subsystem, "tid": self.tid,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": dict(self.attrs)}


def _json_safe(v):
    """Coerce one attribute value for the JSON writers: primitives pass
    through, numpy scalars unwrap via .item(), anything else stringifies
    — a traced workload must never crash inside span.end() because a
    caller attached an array."""
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    item = getattr(v, "item", None)
    if item is not None:
        try:
            got = item()
            if isinstance(got, (int, float, str, bool)):
                return got
        except Exception:
            pass
    return str(v)


def _record(sp):
    with _LOCK:
        _BUF.append(sp)
    _blackbox.note_span(sp)   # flight-recorder close digest (one boolean
    #                           check when the recorder is off)
    path = _flags.get_flag("trace_log_path", "")
    if path:
        from .. import monitor as _monitor

        rec = sp.to_dict()
        rec["attrs"] = {k: _json_safe(v) for k, v in rec["attrs"].items()}
        _monitor.log_event("span", _path=path, **rec)


def _resolve_parent(parent, trace_id):
    """Normalize a parent= argument (Span | span_id int | _NoopSpan from
    a disabled window | None) into (parent_id, trace_id): an explicit
    Span parent donates its trace_id when the caller gave none."""
    if parent is not None and isinstance(parent, Span):
        if trace_id is None:
            trace_id = parent.trace_id
        return parent.span_id, trace_id
    if isinstance(parent, int):
        return parent, trace_id
    return None, trace_id


def span(name, subsystem=None, trace_id=None, parent=None, **attrs):
    """Context-manager span: nests on the thread-local stack, inheriting
    trace/parent ids from the enclosing span (root spans mint a fresh
    trace id); an explicit parent= overrides the stack and the child
    joins ITS trace. Returns a no-op when tracing is disabled."""
    if not _ENABLED[0]:
        return _NOOP
    parent, trace_id = _resolve_parent(parent, trace_id)
    return Span(name, trace_id=trace_id, parent_id=parent,
                subsystem=subsystem, attrs=attrs)


def start_span(name, subsystem=None, trace_id=None, parent=None, **attrs):
    """Begin a span NOW without touching the nesting stack — for work
    that crosses call boundaries; finish it with ``.end(**attrs)``."""
    if not _ENABLED[0]:
        return _NOOP
    parent, trace_id = _resolve_parent(parent, trace_id)
    if trace_id is None:
        # a root started explicitly IS a new trace: mint the id now so
        # children created before .end() inherit it
        trace_id = new_trace_id()
    sp = Span(name, trace_id=trace_id, parent_id=parent,
              subsystem=subsystem, attrs=attrs)
    _track_open(sp)
    return sp


def emit(name, start_ns, end_ns, subsystem=None, trace_id=None, parent=None,
         **attrs):
    """Retro-record one span whose window was already measured (e.g. a
    batched device step attributed to each active slot's request)."""
    if not _ENABLED[0]:
        return _NOOP
    parent, trace_id = _resolve_parent(parent, trace_id)
    sp = Span(name, trace_id=trace_id, parent_id=parent,
              subsystem=subsystem, attrs=attrs, start_ns=start_ns)
    sp.end_ns = int(end_ns)
    if sp.trace_id is None:
        sp.trace_id = new_trace_id()
    _record(sp)
    return sp


@contextlib.contextmanager
def scoped_enabled(on=True):
    """Test helper: flip tracing on/off for a with-block."""
    old = _ENABLED[0]
    _ENABLED[0] = bool(on)
    try:
        yield
    finally:
        _ENABLED[0] = old


# -- summaries ----------------------------------------------------------------

def summary():
    """Aggregate {name: {"count", "total_ms"}} over the ring buffer."""
    agg = {}
    for sp in spans():
        if sp.end_ns is None:
            continue
        st = agg.setdefault(sp.name, {"count": 0, "total_ms": 0.0})
        st["count"] += 1
        st["total_ms"] += (sp.end_ns - sp.start_ns) / 1e6
    return agg


def top_spans(n=3):
    """[(name, total_ms, count)] of the n largest span totals."""
    rows = [(name, st["total_ms"], st["count"])
            for name, st in summary().items()]
    rows.sort(key=lambda r: -r[1])
    return [(name, round(ms, 3), c) for name, ms, c in rows[:n]]


def snapshot_summary(n=3):
    """The compact trace view: span count + top-n span totals."""
    return {"spans": len(spans()),
            "top": [list(r) for r in top_spans(n)]}


# -- chrome://tracing export ---------------------------------------------------

def export_chrome(path=None, include_host_events=True):
    """Merged chrome://tracing JSON: host RecordEvents + trace spans
    (pid = subsystem, flow events linking each multi-span trace_id) +
    counter samples. Returns the trace dict; writes it when `path` given
    (the chrome://tracing form, extended with span identity)."""
    events = []
    pids = {"host": 1}

    def pid_of(subsystem):
        key = subsystem or "trace"
        if key not in pids:
            pids[key] = len(pids) + 1
        return pids[key]

    if include_host_events:
        from .. import profiler as _profiler

        for name, s, e, tid, depth in _profiler.host_events():
            events.append({"name": name, "ph": "X", "ts": s / 1e3,
                           "dur": (e - s) / 1e3, "pid": pids["host"],
                           "tid": tid, "cat": "host",
                           "args": {"depth": depth}})

    by_trace = {}
    for sp in sorted(spans(), key=lambda s: s.start_ns):
        if sp.end_ns is None:
            continue
        pid = pid_of(sp.subsystem)
        args = {"trace_id": sp.trace_id, "span_id": sp.span_id}
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        for k, v in sp.attrs.items():
            args[k] = _json_safe(v)
        events.append({"name": sp.name, "ph": "X", "ts": sp.start_ns / 1e3,
                       "dur": (sp.end_ns - sp.start_ns) / 1e3, "pid": pid,
                       "tid": sp.tid, "cat": "span", "args": args})
        if sp.trace_id is not None:
            by_trace.setdefault(sp.trace_id, []).append((sp, pid))

    # flow events: one chain per trace_id that spans >1 slice, so chrome
    # draws arrows following a request across threads/subsystems
    for tid_, members in by_trace.items():
        if len(members) < 2:
            continue
        flow_id = abs(hash(tid_)) % (1 << 31)
        for i, (sp, pid) in enumerate(members):
            ph = "s" if i == 0 else ("f" if i == len(members) - 1 else "t")
            ev = {"name": "trace", "cat": "flow", "ph": ph, "id": flow_id,
                  "pid": pid, "tid": sp.tid, "ts": sp.start_ns / 1e3}
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)

    for ts_ns, name, value in counter_samples():
        events.append({"name": name, "ph": "C", "pid": pid_of("counters"),
                       "ts": ts_ns / 1e3, "args": {name: value}})

    for name, pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": name}})

    trace_doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as f:
            json.dump(trace_doc, f)
    return trace_doc


def load_spans(path):
    """Read a FLAGS_trace_log_path JSONL span log back into span dicts
    (the 'span' events only)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("event") == "span":
                out.append(rec)
    return out


# the import-free recorder facade: an unrecorded process never imports
# monitor/blackbox.py
from ..monitor import blackbox_lazy as _blackbox  # noqa: E402

# seed from the environment (FLAGS_trace=1 python serve.py)
sync_from_flag()

from . import costs  # noqa: E402,F401


# ``trace`` is also the matrix-trace op (tensor/math.py), as in the
# reference: importing this submodule sets the package attribute to the
# module, so the module is made CALLABLE, delegating to the op. Both
# ``trace(x, offset=1)`` and ``trace.span("...")`` keep working.
import sys as _sys  # noqa: E402


class _CallableTraceModule(type(_sys.modules[__name__])):
    def __call__(self, x, offset=0, axis1=0, axis2=1, name=None):
        from ..tensor.math import trace as _op

        return _op(x, offset=offset, axis1=axis1, axis2=axis2, name=name)


_sys.modules[__name__].__class__ = _CallableTraceModule
