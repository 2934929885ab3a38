"""Runtime telemetry: the framework's metrics registry and exporters.

Ports paddle_tpu/monitor/__init__.py: the default ``StatRegistry``
(platform/monitor.h StatRegistry + STAT_ADD/STAT_SUB), ``counter`` /
``gauge`` / ``histogram``, ``snapshot``, ``reset``, ``enable`` /
``disable``, ``timed``, ``record_collective`` and ``tensor_nbytes`` (on
torch tensors and numpy arrays). Counters, gauges and latency histograms
cheap enough to leave on in serving; the profiler and ``trace`` answer
"where did this step's time go", this module "what has the process done
and how fast, cumulatively".

Instrumented paths of the port (each records into the DEFAULT registry):
``distributed.SpmdTrainer.train_step`` (``step_latency_ms{site=trainer}``,
``train_step_skipped_total``), ``inference.ServingEngine`` (the request
lifecycle: queue wait, TTFT, inter-token latency, occupancy, steps by
kind, prefix and speculative counters, shedding and deadlines),
``serving.paging`` (page blocks, copy-on-write, adapters),
``serving.disagg`` (KV hand-offs), ``framework.io.save/load``
(``checkpoint_*``), ``incubate.checkpoint`` (``checkpoint_recover_total``)
and ``trace.costs`` (``program_flops`` and the memory gauges).

Three exporters, one schema: ``snapshot()`` JSON dict -> ``to_json`` /
``to_prometheus`` text / ``log_event`` + ``log_snapshot`` JSONL
(``FLAGS_monitor_log_path``).

``FLAGS_monitor=0`` (or ``disable()``) turns every recording call into a
single boolean check.

The ``bb_*`` flight-recorder facade keeps every instrumented path one
boolean check without importing the recorder: monitor/blackbox.py adopts
this module's on/off latch (``_BB_ON``), provider list and its lock at
import. ``monitor.numerics``, ``monitor.blackbox``, ``monitor.perfledger``
and ``monitor.goodput`` load lazily, as in the reference: a process that
arms none of their flags imports none of them; the environment's
``FLAGS_blackbox``, ``FLAGS_perf_ledger`` and ``FLAGS_goodput`` import
theirs at this module's import.
"""
import contextlib
import time

from .. import flags as _flags
from .exporters import (flatten, log_event, log_snapshot, parse_prometheus,
                        to_json, to_prometheus)
from .registry import (DEFAULT_BUCKETS, LABEL_CARDINALITY_CAP,
                       OVERFLOW_LABEL, Counter, Gauge, Histogram,
                       StatRegistry)

__all__ = [
    "StatRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "LABEL_CARDINALITY_CAP", "OVERFLOW_LABEL",
    "default_registry", "counter", "gauge", "histogram", "snapshot",
    "reset", "enable", "disable", "is_enabled", "timed",
    "to_json", "to_prometheus", "parse_prometheus", "flatten",
    "log_event", "log_snapshot", "record_collective", "tensor_nbytes",
    "STAT_ADD", "STAT_SUB", "STAT_RESET",
    "blackbox_on", "bb_note", "bb_note_span", "bb_beacon", "bb_progress",
    "bb_register_provider", "bb_dump", "blackbox_lazy",
]


def __getattr__(name):   # PEP 562
    # the numerics telescope, the flight recorder, the perf ledger and the
    # goodput accountant load lazily: a process whose flags arm none of
    # them never imports any. Deliberately NOT in __all__ (a star-import
    # would resolve them)
    if name in ("numerics", "blackbox", "perfledger", "goodput"):
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_flags.define_flag("monitor", True,
                   "runtime telemetry registry on/off; off turns every "
                   "instrumented call site into one boolean check")
_flags.define_flag("monitor_log_path", "",
                   "JSONL structured-event log path for "
                   "monitor.log_event/log_snapshot (empty = disabled)")

_DEFAULT = StatRegistry(enabled=bool(_flags.get_flag("monitor", True)))


def default_registry():
    return _DEFAULT


def counter(name, help="", labelnames=()):
    return _DEFAULT.counter(name, help=help, labelnames=labelnames)


def gauge(name, help="", labelnames=()):
    return _DEFAULT.gauge(name, help=help, labelnames=labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return _DEFAULT.histogram(name, help=help, labelnames=labelnames,
                              buckets=buckets)


def snapshot():
    return _DEFAULT.snapshot()


def reset():
    _DEFAULT.reset()


def enable():
    _DEFAULT.enable()


def disable():
    _DEFAULT.disable()


def is_enabled():
    return _DEFAULT.is_enabled()


@contextlib.contextmanager
def timed(hist_or_bound):
    """Observe a with-block's wall time in MILLISECONDS on a histogram
    (or a .labels(...) handle). Skips the clock reads when disabled."""
    if not _DEFAULT.is_enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        hist_or_bound.observe((time.perf_counter() - t0) * 1e3)


# ---- monitor.h macro parity --------------------------------------------------
# STAT_ADD/STAT_SUB mutate one named int stat; monitor.h stats can go both
# ways, so they map onto gauges in the default registry.

def STAT_ADD(name, value=1):
    gauge(name).inc(value)


def STAT_SUB(name, value=1):
    gauge(name).dec(value)


def STAT_RESET(name):
    gauge(name).set(0)


# ---- shared instrumentation helpers ------------------------------------------

_COLL_CALLS = None
_COLL_BYTES = None
_COLL_SAVED = None


def tensor_nbytes(x):
    """Payload bytes of a torch tensor or numpy array (shape and dtype
    only: nothing is read from the device); 0 when undeterminable."""
    try:
        nbytes = getattr(x, "nbytes", None)   # torch.Tensor and np.ndarray
        if nbytes is not None:
            return int(nbytes)
        shape, dtype = x.shape, x.dtype
        n = 1
        for s in shape:
            n *= int(s)
        return n * dtype.itemsize
    except Exception:
        return 0


def record_collective(kind, nbytes=0, saved_bytes=0):
    """Count one collective API call by family (all-reduce, all-gather,
    reduce-scatter, all-to-all, collective-permute). `nbytes` is what
    crosses the interconnect; for wire-compressed ops the caller passes the
    encoded bytes and the fp32 bytes the encoding displaced as
    `saved_bytes` (``collective_bytes_saved_total{op}``, lazy). The port
    runs on one device, so no ported path calls this yet."""
    global _COLL_CALLS, _COLL_BYTES, _COLL_SAVED
    bb_note("collective", op=kind, bytes=int(nbytes))
    if not _DEFAULT.is_enabled():
        return
    if _COLL_CALLS is None:
        _COLL_CALLS = counter(
            "collective_calls_total",
            "collective API calls by HLO family (trace-time accounting; "
            "exact per-execution counts live in the perf-budget HLO gate)",
            labelnames=("op",))
        _COLL_BYTES = counter(
            "collective_bytes_total",
            "bytes a collective API call puts on the wire, by HLO family "
            "(== the logical payload except for wire-compressed ops, "
            "whose fp32 displacement is collective_bytes_saved_total)",
            labelnames=("op",))
    _COLL_CALLS.labels(op=kind).inc()
    if nbytes:
        _COLL_BYTES.labels(op=kind).inc(nbytes)
    if saved_bytes:
        if _COLL_SAVED is None:
            _COLL_SAVED = counter(
                "collective_bytes_saved_total",
                "fp32 bytes a wire-compressed collective (quantized "
                "reduce family) did NOT move: logical payload minus the "
                "int8+scales wire encoding counted in "
                "collective_bytes_total (lazy — no series until a "
                "compressed op runs)",
                labelnames=("op",))
        _COLL_SAVED.labels(op=kind).inc(saved_bytes)


# ---- flight-recorder indirection ---------------------------------------------
# monitor/blackbox.py is lazy: a plain process never imports it. Its on/off
# latch and the provider registry live HERE so every instrumented hot path
# stays one boolean check without pulling the recorder in; blackbox adopts
# these objects as its own at import (the latch list is shared, not copied).

import threading as _threading  # noqa: E402  (for the pre-import lock)

_BB_ON = [False]          # flipped by blackbox.enable()/disable()
_BB_PROVIDERS = []        # (kind, weakref(obj), fn) — shared with blackbox
_BB_PROVIDER_CAP = 64     # one cap, adopted by blackbox.register_provider
_BB_PROVIDERS_LOCK = _threading.Lock()   # the ONE lock for the provider
#                          list — blackbox.register_provider adopts it
#                          too, so pre- and post-import registrations
#                          can never interleave under different locks
_BB_NULL_CM = contextlib.nullcontext()


def blackbox_on():
    """Is the flight recorder enabled? One list read — safe to call on
    any hot path without importing the recorder."""
    return _BB_ON[0]


def _bb():
    from . import blackbox

    return blackbox


def bb_note(kind, **fields):
    """Forward one flight-recorder ring event iff the recorder is on
    (disabled: one boolean check, no blackbox import)."""
    if _BB_ON[0]:
        _bb().note(kind, **fields)


def bb_note_span(sp):
    if _BB_ON[0]:
        _bb().note_span(sp)


def bb_beacon(site):
    if _BB_ON[0]:
        _bb().beacon(site)


def bb_progress(site):
    """`with bb_progress(site):` — a blackbox progress window when the
    recorder is on, a no-op context otherwise."""
    if not _BB_ON[0]:
        return _BB_NULL_CM
    return _bb().progress(site)


def bb_dump(reason, **kw):
    """Write a dump bundle (imports the recorder; a disabled recorder
    writes nothing and returns None). Keywords pass through to
    blackbox.dump (site=, extra=, dir_=)."""
    if not _BB_ON[0]:
        return None
    return _bb().dump(reason, **kw)


def bb_register_provider(kind, obj, fn):
    """Register a live-state dump provider WITHOUT importing the
    recorder: entries land in the shared list blackbox adopts at import
    (same weakref shape + cap as blackbox.register_provider)."""
    import sys as _sys
    import weakref

    # delegate only to a FULLY-initialized module: mid-import the
    # half-built module already sits in sys.modules without
    # register_provider — fall through to the shared list, which blackbox
    # mutates under the SAME _BB_PROVIDERS_LOCK, so nothing is lost
    mod = _sys.modules.get(__name__ + ".blackbox")
    reg = getattr(mod, "register_provider", None)
    if reg is not None:
        reg(kind, obj, fn)
        return
    with _BB_PROVIDERS_LOCK:
        _BB_PROVIDERS[:] = [(k, r, f) for (k, r, f) in _BB_PROVIDERS
                            if r() is not None][-(_BB_PROVIDER_CAP - 1):]
        _BB_PROVIDERS.append((str(kind), weakref.ref(obj), fn))


class _BlackboxLazy:
    """The recorder API surface the instrumented hot paths consume,
    import-free: ``from ..monitor import blackbox_lazy as _blackbox``
    keeps every call site spelled as in the reference while the heavy
    module (ring, sentinel, bundle writer) loads only once the recorder
    is actually enabled."""

    is_enabled = staticmethod(blackbox_on)
    note = staticmethod(bb_note)
    note_span = staticmethod(bb_note_span)
    beacon = staticmethod(bb_beacon)
    progress = staticmethod(bb_progress)
    register_provider = staticmethod(bb_register_provider)
    dump = staticmethod(bb_dump)


blackbox_lazy = _BlackboxLazy()


# env-armed opt-in (FLAGS_blackbox=1 python serve.py): load the recorder
# eagerly so its sync_from_flag() enables it at import. The flag itself is
# defined in flags.py so this check never touches the lazy module.
if _flags.get_flag("blackbox", False):
    from . import blackbox  # noqa: E402,F401

# same opt-in for the perf ledger (FLAGS_perf_ledger=1 python ...): create
# the process ledger eagerly so its dump provider and environment
# fingerprint exist before the first recording site runs.
if _flags.get_flag("perf_ledger", False):
    from . import perfledger  # noqa: E402,F401

    perfledger.get_ledger()

# same opt-in for the goodput accountant (FLAGS_goodput=1 python ...):
# import it eagerly so hook sites resolve it without paying the import
# inside a step loop. No run is opened here.
if _flags.get_flag("goodput", False):
    from . import goodput  # noqa: E402,F401
