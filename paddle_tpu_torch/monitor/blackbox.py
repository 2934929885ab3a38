"""Black-box flight recorder: progress beacons, stall sentinel, dump bundles.

Ports paddle_tpu/monitor/blackbox.py. It explains runs that do not
finish: a wedged ``run_until_complete``, a step that never returns, a
process killed by an external watchdog. Three pieces, all inert behind
``FLAGS_blackbox`` (one boolean check per call site, through the facade in
``monitor/__init__.py``; this module is never imported while the flag is
off):

**Flight recorder** — ``note(kind, **fields)`` appends one event to a
bounded thread-safe ring (``FLAGS_blackbox_ring`` capacity, oldest
dropped). Wired feeds: span open and close digests (trace), checkpoint
byte tags (framework/io), the engine's ``hot_swap``, numerics anomalies,
perf regressions, goodput runs, metric-counter deltas (sampled by the
sentinel), and every dump itself.

**Progress beacons** — ``beacon(site)`` stamps (site, monotonic ns,
count += 1) in a per-site registry. *Window* beacons wrap one operation
via ``with progress(site):`` (``serving/step``, ``trainer/step``,
``router/step``, ``disagg/handoff`` around each step or hand-off sweep;
``serving/admit``, ``disagg/prefill`` around one-shot operations). A site
is *active* only while at least one window is open (overlap refcounted).
*Raw* beacons just beat and stay active until ``quiesce(site)``.

**Stall sentinel** — a daemon thread (``start_sentinel()``, or started on
the first beacon when ``FLAGS_blackbox`` and ``FLAGS_stall_timeout_s`` are
both set) polls the registry; when an ACTIVE site stops advancing for
longer than the timeout it writes ONE dump bundle per stall episode
(re-armed when the site advances again), named after the most recently
advancing stalled site. A step blocked in a device read (``.cpu()``,
``.item()``) waits with the GIL released, so the sentinel runs while the
card is busy.

**Dump bundles** — ``dump(reason)`` writes one JSON bundle to
``FLAGS_blackbox_dir`` (default: <tmp>/paddle_tpu_torch_blackbox): every
thread's python stack (``sys._current_frames`` and a ``faulthandler``
rendering), the ring, the beacon table, a metrics snapshot, the open-span
tree, every registered provider's table (each live serving engine's
in-flight requests, the router's placements, the numerics and perf
snapshots, the goodput run) and the ambient context.
``blackbox_dump_total{reason=stall|signal|crash}`` counts them and a
``blackbox_dump`` span records each write. SIGUSR1 triggers a dump, an
uncaught exception dumps through ``sys.excepthook`` /
``threading.excepthook`` (with an atexit backstop), and
``ServingEngine.run_until_complete``'s ``engine_stalled`` error and the
Router's no-live-engine error name the bundle they just wrote.

Beyond the reference: ``uninstall_hooks()`` puts back the excepthooks and
the SIGUSR1 handler and unregisters the atexit backstop, so that a test
leaves the process as it found it.
"""
import atexit
import collections
import contextlib
import itertools
import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
import weakref

from .. import flags as _flags

__all__ = [
    "is_enabled", "enable", "disable", "sync_from_flag",
    "beacon", "progress", "quiesce", "beacons",
    "note", "note_span", "ring", "ring_summary", "set_capacity",
    "capacity", "set_context", "context",
    "register_provider",
    "start_sentinel", "stop_sentinel", "sentinel_running",
    "dump", "default_dir", "load_bundle", "validate_bundle",
    "install_hooks", "uninstall_hooks", "reset", "BUNDLE_KEYS",
]

# FLAGS_blackbox itself is defined in flags.py: the monitor package
# gates its env-armed eager import on it, and this module is lazy —
# defining the switch here would mean importing the module to learn
# whether to import it
_flags.define_flag(
    "blackbox_dir", "",
    "directory dump bundles are written to; empty = "
    "<system tmp>/paddle_tpu_torch_blackbox")
_flags.define_flag(
    "blackbox_ring", 512,
    "flight-recorder ring capacity (events); oldest dropped past it so "
    "a long-lived instrumented server cannot OOM on event bookkeeping")
_flags.define_flag(
    "stall_timeout_s", 0.0,
    "stall-sentinel threshold: an ACTIVE beacon site that stops "
    "advancing for this many seconds produces a dump bundle. 0 = the "
    "sentinel never auto-starts (start_sentinel() can still arm it "
    "explicitly with its own timeout)")
_flags.define_flag(
    "blackbox_max_bundles", 32,
    "keep-newest cap on dump bundles in FLAGS_blackbox_dir (oldest "
    "pruned after each write): an oscillating stall or crash storm "
    "must never fill the disk of the host it is diagnosing")

# this module is lazy: the enabled latch and the
# provider list are OWNED by the parent package (monitor/__init__.py
# _BB_ON/_BB_PROVIDERS) so instrumented hot paths can check/queue
# without importing the recorder; we adopt the SAME objects — flipping
# _ENABLED[0] here is what monitor.blackbox_on() reads out there
from .. import monitor as _parent  # noqa: E402  (fully imported first)

_ENABLED = _parent._BB_ON     # the ONE read on every disabled fast path
_AUTO_SENTINEL = [False]      # beacon() auto-starts the sentinel thread
_LOCK = threading.RLock()
_RING = collections.deque(maxlen=int(_flags.get_flag("blackbox_ring", 512)))
_BEACONS = {}                 # site -> _Beacon
_CONTEXT = {}                 # ambient key/value carried in every bundle
_PROVIDERS = _parent._BB_PROVIDERS   # (kind, weakref(obj), fn(obj)->table)
_SENTINEL = None              # the live _Sentinel thread, or None
_HOOKS = [False]              # excepthook/atexit installation latch
_SIGNAL_HOOK = [False]        # SIGUSR1 latch (separate: only the main
#                               thread can install it — retried until
#                               an enable() runs there)
_SIGNAL_PREV = [signal.SIG_DFL]   # the SIGUSR1 handler install replaced
_CRASH = [False, False]       # [uncaught exception seen, dump written]

SENTINEL_THREAD_NAME = "paddle-tpu-torch-stall-sentinel"

_DUMP_SEQ = itertools.count()   # collision-proofs same-ms bundle names

#: keys every well-formed dump bundle must carry (the CLI validates them)
BUNDLE_KEYS = ("format", "reason", "ts", "pid", "beacons", "ring",
               "stacks", "metrics", "requests", "context")

# dump accounting, created lazily so a disabled process never grows the
# registry (no blackbox_* series while the flag is unset)
_DUMP_TOTAL = None
_RING_TOTAL = None


class _Beacon:
    """One progress site: a monotonically increasing count plus the last
    beat's monotonic timestamp. `active` gates the sentinel; `dumped_at`
    dedups stall dumps to one per episode (re-armed on the next beat);
    `windows` counts OPEN progress() windows so overlapping windows on
    one site (two engines admitting on two threads) only deactivate it
    when the LAST one closes."""

    __slots__ = ("count", "last_ns", "active", "dumped_at", "windows")

    def __init__(self):
        self.count = 0
        self.last_ns = time.monotonic_ns()
        self.active = True
        self.dumped_at = -1
        self.windows = 0


# -- enable/disable -----------------------------------------------------------

def is_enabled():
    return _ENABLED[0]


def enable(install=True):
    """Turn the recorder on (and, by default, install the SIGUSR1 /
    excepthook dump hooks — idempotent)."""
    _ENABLED[0] = True
    _AUTO_SENTINEL[0] = float(_flags.get_flag("stall_timeout_s", 0.0)) > 0
    if install:
        install_hooks()


def disable():
    _ENABLED[0] = False
    _AUTO_SENTINEL[0] = False


def sync_from_flag():
    """Re-read FLAGS_blackbox/FLAGS_blackbox_ring/FLAGS_stall_timeout_s
    (after paddle.set_flags)."""
    set_capacity(int(_flags.get_flag("blackbox_ring", 512)))
    if bool(_flags.get_flag("blackbox", False)):
        enable()
    else:
        disable()


# -- flight recorder ring -----------------------------------------------------

def set_capacity(n):
    global _RING
    n = max(1, int(n))
    if n == _RING.maxlen:
        return
    with _LOCK:
        _RING = collections.deque(_RING, maxlen=n)


def capacity():
    return _RING.maxlen


def note(kind, **fields):
    """Append one event to the flight-recorder ring. One boolean check
    when disabled; thread-safe; never raises on unserializable fields
    (the bundle writer stringifies them)."""
    if not _ENABLED[0]:
        return
    rec = {"ts": round(time.time(), 6), "kind": str(kind)}
    rec.update(fields)
    with _LOCK:
        _RING.append(rec)
    _count_ring_event()


def note_span(sp):
    """Span-close digest (called by trace._record): name + duration +
    trace identity only — the ring holds digests, not full spans."""
    if not _ENABLED[0]:
        return
    dur = None if sp.end_ns is None else \
        round((sp.end_ns - sp.start_ns) / 1e6, 3)
    note("span", name=sp.name, subsystem=sp.subsystem,
         trace_id=sp.trace_id, dur_ms=dur)


def ring():
    """Snapshot of the ring (oldest first)."""
    with _LOCK:
        return [dict(r) for r in _RING]


def ring_summary(n=5):
    """Compact ring view (count + last-n events) — what trace_dump and
    bench heartbeats attach."""
    with _LOCK:
        tail = [dict(r) for r in list(_RING)[-int(n):]]
        return {"events": len(_RING), "tail": tail}


def _count_ring_event():
    global _RING_TOTAL
    from .. import monitor as _monitor

    if not _monitor.is_enabled():
        return
    if _RING_TOTAL is None:
        # double-checked publish of the cached handle (the metric itself
        # is get-or-create under the registry's own lock either way)
        with _LOCK:
            if _RING_TOTAL is None:
                _RING_TOTAL = _monitor.counter(
                    "blackbox_ring_events_total",
                    "events appended to the flight-recorder ring (only "
                    "exists once FLAGS_blackbox is on)")
    _RING_TOTAL.inc()


# -- ambient context ----------------------------------------------------------

def set_context(key, value):
    """Attach one ambient key/value to every future bundle (e.g. bench
    stamps the current phase here)."""
    if not _ENABLED[0]:
        return
    with _LOCK:
        _CONTEXT[str(key)] = value


def context():
    with _LOCK:
        return dict(_CONTEXT)


# -- progress beacons ---------------------------------------------------------

def _beat(site, open_window=False):
    """One locked beat: count/timestamp/active move together (and the
    window opens atomically with its beat, so a sibling window closing
    concurrently can never leave an OPEN window deactivated — the
    sentinel-blindness race). Returns the site's _Beacon."""
    with _LOCK:
        b = _BEACONS.get(site)
        if b is None:
            b = _BEACONS[site] = _Beacon()
        b.count += 1
        b.last_ns = time.monotonic_ns()
        b.active = True
        if open_window:
            b.windows += 1
    if _AUTO_SENTINEL[0] and _SENTINEL is None:
        start_sentinel()
    return b


def beacon(site):
    """Record one unit of progress at `site`. Disabled: one boolean check.
    Enabled: one locked beat; also
    (re)activates the site for the sentinel and, when
    FLAGS_stall_timeout_s is set, lazily starts the sentinel thread."""
    if not _ENABLED[0]:
        return
    _beat(site)


@contextlib.contextmanager
def progress(site):
    """Window beacon: active only while the with-block runs — the shape
    for every instrumented operation ("stopped advancing" is only
    meaningful INSIDE the work: a hot-loop step, a compile, an
    admission prefill). Overlap-safe: with two concurrent windows on
    one site (two engines stepping on two threads), the site stays
    active until the LAST one closes — a window closing must not hide
    its still-running sibling from the sentinel."""
    if not _ENABLED[0]:
        yield
        return
    b = _beat(site, open_window=True)
    try:
        yield
    finally:
        # a concurrent reset() may have swept the registry; the held
        # _Beacon still closes consistently (it is simply unreachable)
        with _LOCK:
            b.windows -= 1
            if b.windows <= 0:
                b.active = False


def quiesce(site=None):
    """Mark a site (or all sites) legitimately idle: the sentinel stops
    watching it until its next beacon. Owners of RAW beacon sites call
    this when their loop legitimately completes; progress() windows
    deactivate themselves."""
    if site is None:
        with _LOCK:
            for b in _BEACONS.values():
                b.active = False
        return
    b = _BEACONS.get(site)
    if b is not None:
        b.active = False


def beacons():
    """{site: {"count", "age_s", "active"}} — the bundle's beacon table."""
    now = time.monotonic_ns()
    with _LOCK:
        return {site: {"count": b.count,
                       "age_s": round((now - b.last_ns) / 1e9, 3),
                       "active": bool(b.active)}
                for site, b in _BEACONS.items()}


# -- in-flight state providers ------------------------------------------------

# the cap AND the list lock are owned by the parent package:
# monitor.bb_register_provider mutates the same list pre-import, so both
# sides must serialize on the same lock against the same bound
_PROVIDER_CAP = _parent._BB_PROVIDER_CAP
_PROVIDERS_LOCK = _parent._BB_PROVIDERS_LOCK


def register_provider(kind, obj, fn):
    """Register a live-state provider for dump bundles: ``fn(obj)`` must
    return a JSON-able table (e.g. a serving engine's in-flight request
    table). `obj` is held weakly — dead providers are pruned, the list is
    capped so short-lived engines cannot grow it without bound."""
    with _PROVIDERS_LOCK:
        _PROVIDERS[:] = [(k, r, f) for (k, r, f) in _PROVIDERS
                         if r() is not None][-(_PROVIDER_CAP - 1):]
        _PROVIDERS.append((str(kind), weakref.ref(obj), fn))


def _provider_tables():
    out = []
    with _PROVIDERS_LOCK:
        providers = list(_PROVIDERS)
    for kind, ref, fn in providers:
        obj = ref()
        if obj is None:
            continue
        try:
            out.append({"kind": kind, "table": fn(obj)})
        except Exception as e:   # a broken provider must not kill a dump
            out.append({"kind": kind, "error": f"{type(e).__name__}: {e}"})
    return out


# -- dump bundles -------------------------------------------------------------

def default_dir():
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_blackbox")


def _prune_bundles(d):
    """Keep the newest FLAGS_blackbox_max_bundles bundles in `d` — an
    oscillating stall (a new episode per slow loop iteration) writes one
    bundle per episode forever; the recorder must bound its own disk
    footprint instead of exhausting the host it is diagnosing."""
    keep = int(_flags.get_flag("blackbox_max_bundles", 32))
    if keep < 1:
        return
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith("blackbox-") and n.endswith(".json")]
        if len(names) <= keep:
            return
        paths = sorted((os.path.join(d, n) for n in names),
                       key=os.path.getmtime)
        for p in paths[:-keep]:
            os.remove(p)
    except OSError:
        pass


def _thread_stacks():
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        name, daemon = names.get(tid, ("?", None))
        out.append({"thread_id": tid, "name": name, "daemon": daemon,
                    "stack": traceback.format_stack(frame)})
    return out


def _faulthandler_text():
    try:
        import faulthandler

        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception as e:
        return f"faulthandler unavailable: {e}"


def _count_dump(reason):
    global _DUMP_TOTAL
    from .. import monitor as _monitor

    if not _monitor.is_enabled():
        return
    if _DUMP_TOTAL is None:
        with _LOCK:   # double-checked publish of the cached handle
            if _DUMP_TOTAL is None:
                _DUMP_TOTAL = _monitor.counter(
                    "blackbox_dump_total",
                    "dump bundles written, by trigger "
                    "(stall = sentinel/non-convergence, signal = SIGUSR1/"
                    "on-demand, crash = excepthook/abnormal exit)",
                    labelnames=("reason",))
    _DUMP_TOTAL.labels(reason=reason).inc()


def dump(reason, site=None, extra=None, dir_=None):
    """Write one dump bundle; returns its path, or None if the write
    failed (a dump must never take the host down with it). `reason` is
    one of stall|signal|crash; `site` names the stalled beacon when the
    sentinel (or a loop's own non-convergence path) is the trigger."""
    t0_ns = time.perf_counter_ns()
    try:
        d = dir_ or _flags.get_flag("blackbox_dir", "") or default_dir()
        os.makedirs(d, exist_ok=True)
        ts = time.time()
        bundle = {
            "format": 1,
            "reason": str(reason),
            "site": site,
            "ts": round(ts, 6),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "beacons": beacons(),
            "context": context(),
            "ring": ring(),
            "stacks": _thread_stacks(),
            "faulthandler": _faulthandler_text(),
        }
        try:
            from .. import monitor as _monitor

            bundle["metrics"] = _monitor.snapshot()
        except Exception as e:
            bundle["metrics"] = {"error": f"{type(e).__name__}: {e}"}
        try:
            from .. import trace as _trace

            bundle["open_spans"] = _trace.open_spans()
            bundle["span_summary"] = _trace.snapshot_summary(5)
        except Exception:
            bundle["open_spans"] = []
        bundle["requests"] = _provider_tables()
        if extra:
            bundle["extra"] = extra
        # per-process sequence in the name: two same-reason dumps in the
        # same millisecond (thread fan-out crashes) must not clobber
        # each other through the atomic replace
        path = os.path.join(
            d, f"blackbox-{os.getpid()}-{int(ts * 1e3)}-"
               f"{next(_DUMP_SEQ):04d}-{reason}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=str)
        os.replace(tmp, path)   # readers never see a torn bundle
        _prune_bundles(d)
    except Exception:
        return None
    note("dump", reason=reason, site=site, path=path)
    try:
        _count_dump(str(reason))
    except Exception:
        pass
    try:
        from .. import trace as _trace

        _trace.emit("blackbox_dump", t0_ns, time.perf_counter_ns(),
                    subsystem="blackbox", reason=str(reason), site=site,
                    path=path)
    except Exception:
        pass
    return path


def load_bundle(path):
    """Read a bundle back; raises ValueError on a missing/malformed file
    or one missing required keys (the CLI's exit-1 contract)."""
    try:
        with open(path) as f:
            bundle = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read bundle {path!r}: {e}")
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed bundle {path!r}: {e}")
    missing = validate_bundle(bundle)
    if missing:
        raise ValueError(
            f"bundle {path!r} is missing required keys: {missing}")
    return bundle


def validate_bundle(bundle):
    """Missing required keys of a bundle dict (empty = well-formed)."""
    if not isinstance(bundle, dict):
        return list(BUNDLE_KEYS)
    return [k for k in BUNDLE_KEYS if k not in bundle]


# -- stall sentinel -----------------------------------------------------------

class _Sentinel(threading.Thread):
    """Background watcher: every poll it samples counter-family deltas
    into the ring and checks active beacons for stalls. One bundle per
    stall episode, named after the most recently advancing stalled site
    (the loop that was running right up to the wedge; longer-stale sites
    ride along in extra["stalled"])."""

    def __init__(self, timeout_s, poll_s=None):
        super().__init__(name=SENTINEL_THREAD_NAME, daemon=True)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(0.05, min(1.0, self.timeout_s / 4.0))
        self._stop_ev = threading.Event()
        self._counter_totals = {}

    def stop(self):
        self._stop_ev.set()

    def run(self):
        while not self._stop_ev.wait(self.poll_s):
            try:
                self._poll()
            except Exception:
                pass   # the watcher must outlive anything it watches

    def _poll(self):
        if not _ENABLED[0]:
            return
        self._sample_metric_deltas()
        now = time.monotonic_ns()
        timeout_ns = int(self.timeout_s * 1e9)
        stalled = []
        fresh = False
        with _LOCK:
            items = list(_BEACONS.items())
        for site, b in items:
            if not b.active:
                continue
            age_ns = now - b.last_ns
            if age_ns > timeout_ns:
                stalled.append((age_ns, site, b))
                if b.dumped_at != b.count:
                    fresh = True
        if not stalled or not fresh:
            return
        # the wedged loop is the one that was advancing most recently
        stalled.sort(key=lambda t: t[0])
        _, wedged_site, _ = stalled[0]
        for _, _, b in stalled:
            b.dumped_at = b.count   # one bundle per episode per site
        dump("stall", site=wedged_site,
             extra={"stall_timeout_s": self.timeout_s,
                    "stalled": [{"site": s, "age_s": round(a / 1e9, 3)}
                                for a, s, _ in stalled]})

    def _sample_metric_deltas(self):
        """Ring feed: which counter families moved since the last poll —
        the 'what was it doing' trail next to the beacon timestamps."""
        from .. import monitor as _monitor

        try:
            for metric in _monitor.default_registry().metrics():
                if metric.kind != "counter" \
                        or metric.name.startswith("blackbox_"):
                    continue
                total = sum(s.value for s in metric.series())
                prev = self._counter_totals.get(metric.name)
                if prev is not None and total != prev:
                    note("metric_delta", name=metric.name,
                         delta=total - prev, total=total)
                self._counter_totals[metric.name] = total
        except Exception:
            pass


def start_sentinel(timeout_s=None, poll_s=None):
    """Start (or return) the stall-sentinel thread. `timeout_s` defaults
    to FLAGS_stall_timeout_s (or 60s when that flag is unset). Implicitly
    enables the recorder — a sentinel without beacons watches nothing."""
    global _SENTINEL
    with _LOCK:
        if _SENTINEL is not None and _SENTINEL.is_alive():
            return _SENTINEL
        if not _ENABLED[0]:
            enable()
        if timeout_s is None:
            timeout_s = float(_flags.get_flag("stall_timeout_s", 0.0)) \
                or 60.0
        _SENTINEL = _Sentinel(timeout_s, poll_s=poll_s)
        _SENTINEL.start()
        return _SENTINEL


def stop_sentinel():
    global _SENTINEL
    with _LOCK:
        s, _SENTINEL = _SENTINEL, None
    if s is not None:
        s.stop()
        s.join(timeout=2.0)


def sentinel_running():
    s = _SENTINEL
    return s is not None and s.is_alive()


# -- crash / on-demand hooks --------------------------------------------------

def _on_signal(signum, frame):
    # the handler outlives disable() (hooks are never uninstalled):
    # honor the flag so a disabled recorder stays side-effect-free
    if not _ENABLED[0]:
        return
    # dump on a helper thread, not inside the handler: the signal may
    # have interrupted the main thread while it holds a non-reentrant
    # lock (trace ring, metric series) that the bundle writer needs —
    # inline dumping could deadlock the very process being debugged
    threading.Thread(target=dump, args=("signal",),
                     kwargs={"site": "SIGUSR1"},
                     name="paddle-tpu-torch-blackbox-dump", daemon=True).start()


def _on_excepthook(exc_type, exc, tb):
    _CRASH[0] = True
    try:
        if _ENABLED[0]:
            path = dump(
                "crash", site="excepthook",
                extra={"exception": "".join(traceback.format_exception_only(
                    exc_type, exc)).strip()})
            if path is not None:   # a failed write leaves the atexit
                _CRASH[1] = True   # backstop armed to retry
    except Exception:
        pass
    _ORIG_EXCEPTHOOK(exc_type, exc, tb)


def _on_thread_excepthook(args):
    _CRASH[0] = True
    try:
        if _ENABLED[0]:
            path = dump(
                "crash", site="threading.excepthook",
                extra={"exception": "".join(traceback.format_exception_only(
                    args.exc_type, args.exc_value)).strip(),
                       "thread": getattr(args.thread, "name", None)})
            if path is not None:
                _CRASH[1] = True
    except Exception:
        pass
    _ORIG_THREAD_EXCEPTHOOK(args)


def _on_exit():
    # backstop only: an uncaught exception whose excepthook dump failed
    # (or was bypassed) still leaves a bundle behind
    if _ENABLED[0] and _CRASH[0] and not _CRASH[1]:
        dump("crash", site="atexit")


_ORIG_EXCEPTHOOK = sys.__excepthook__
_ORIG_THREAD_EXCEPTHOOK = threading.__excepthook__


def install_hooks():
    """Install the SIGUSR1 handler + sys/threading excepthooks + atexit
    backstop (idempotent; the dumps themselves still honor the enabled
    flag, so installing is side-effect-free while disabled)."""
    global _ORIG_EXCEPTHOOK, _ORIG_THREAD_EXCEPTHOOK
    if not _SIGNAL_HOOK[0]:
        # the signal half latches only on SUCCESS: a first call from a
        # worker thread (signal.signal raises there) must not burn the
        # one chance to install — the next enable() from the main
        # thread retries
        try:
            if hasattr(signal, "SIGUSR1"):
                _SIGNAL_PREV[0] = signal.signal(signal.SIGUSR1, _on_signal)
            _SIGNAL_HOOK[0] = True
        except (ValueError, OSError):
            pass
    if _HOOKS[0]:
        return
    _HOOKS[0] = True
    if sys.excepthook is not _on_excepthook:
        _ORIG_EXCEPTHOOK = sys.excepthook
        sys.excepthook = _on_excepthook
    if threading.excepthook is not _on_thread_excepthook:
        _ORIG_THREAD_EXCEPTHOOK = threading.excepthook
        threading.excepthook = _on_thread_excepthook
    atexit.register(_on_exit)


def uninstall_hooks():
    """Undo install_hooks(): put back the excepthooks it replaced and the
    SIGUSR1 handler it displaced, unregister the atexit backstop, and
    clear the latches so a later enable() installs afresh."""
    global _ORIG_EXCEPTHOOK, _ORIG_THREAD_EXCEPTHOOK
    if _SIGNAL_HOOK[0]:
        try:
            signal.signal(signal.SIGUSR1, _SIGNAL_PREV[0])
            _SIGNAL_HOOK[0] = False
        except (ValueError, OSError, TypeError):
            pass
    if not _HOOKS[0]:
        return
    _HOOKS[0] = False
    if sys.excepthook is _on_excepthook:
        sys.excepthook = _ORIG_EXCEPTHOOK
    if threading.excepthook is _on_thread_excepthook:
        threading.excepthook = _ORIG_THREAD_EXCEPTHOOK
    _ORIG_EXCEPTHOOK = sys.__excepthook__
    _ORIG_THREAD_EXCEPTHOOK = threading.__excepthook__
    atexit.unregister(_on_exit)


# -- test/tooling lifecycle ---------------------------------------------------

def reset():
    """Clear the ring, beacon registry, and ambient context (providers
    are kept — live engines remain dump-visible). Stops nothing: pair
    with stop_sentinel()/disable() as needed."""
    with _LOCK:
        _RING.clear()
        _BEACONS.clear()
        _CONTEXT.clear()


# seed from the environment (FLAGS_blackbox=1 python serve.py)
sync_from_flag()
