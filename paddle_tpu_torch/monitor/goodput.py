"""Goodput ledger: account every wall-second of a run (FLAGS_goodput).

Ports paddle_tpu/monitor/goodput.py: one :class:`GoodputRun` classifies
every second between ``start_run`` and ``end_run`` into EXCLUSIVE buckets —

========================  ====================================================
bucket                    meaning
========================  ====================================================
``step``                  productive train-step time (the goodput)
``compile``               compile wall time (the port compiles nothing)
``ckpt_save``             checkpoint save (framework/io + CheckpointSaver)
``ckpt_restore``          checkpoint load + same-topology restore
``reshard``               cross-topology restore (not ported: one device)
``resume_backoff``        elastic recovery (not ported)
``stall``                 an unattributed gap >= FLAGS_goodput_stall_s
``edge_wait``             MPMD stage-edge backpressure (not ported)
``other``                 every remaining (short) unattributed gap
========================  ====================================================

Attribution is a BUCKET STACK: ``begin(b)``/``end(b)`` push/pop, and
every transition books the elapsed wall time to the bucket that was on
top — nesting *pauses* the outer bucket, so buckets are exclusive and sum
to wall time BY CONSTRUCTION. Hook sites: ``SpmdTrainer.train_step``
(step), ``framework/io.py`` and ``CheckpointSaver`` (ckpt_save,
ckpt_restore) and ``SpmdTrainer.set_state_dict`` (ckpt_restore) — each
one flag read when disarmed.

A finalized run publishes ``goodput_seconds_total{bucket}`` + the
``goodput_fraction`` gauge (``step`` seconds / wall), notes the
flight-recorder ring, and with ``FLAGS_perf_ledger`` also armed appends a
``site=run/goodput`` perf-ledger row through the regression sentinel
(``goodput`` is LOW_IS_BAD). Each open run is a flight-recorder dump
provider, so a crash or stall bundle names the active bucket. This
module also owns the serving-side lineage metric families
(``serving_weight_version`` gauge, ``serving_stale_sessions_total``
counter) so they share the one flag gate.

Inert by default: ``FLAGS_goodput`` is defined in flags.py so every hook
site is one flag read, the disarmed path never imports this module, no
``goodput_*`` / ``serving_weight_*`` series exists until armed, and armed
and disarmed runs train bit-identically.
"""
import contextlib
import threading
import time

from .. import flags as _flags
from . import blackbox_lazy as _blackbox  # import-free recorder facade

__all__ = [
    "BUCKETS", "is_armed", "GoodputRun", "start_run", "ensure_run",
    "current_run", "end_run", "reset", "bucket", "count",
    "note_serving_version", "note_stale_session",
]

#: the exclusive wall-time buckets, in reporting order. ``step`` is the
#: goodput; everything else is overhead the ledger exists to expose.
BUCKETS = ("step", "compile", "ckpt_save", "ckpt_restore", "reshard",
           "resume_backoff", "stall", "edge_wait", "other")


def is_armed():
    """The one master switch (FLAGS_goodput). Hook sites read the flag
    (or their construction-consumed handle) directly so the disarmed
    path never imports this module; this helper is for code that
    already did."""
    return bool(_flags.get_flag("goodput", False))


# -- metric families (lazy: no goodput_*/serving_* series until armed) ---------

_M = None


def _metrics():
    global _M
    if _M is None:
        from .. import monitor as _monitor

        _M = {
            "seconds": _monitor.counter(
                "goodput_seconds_total",
                "wall seconds of the current goodput run by exclusive "
                "bucket (lazy — no series until FLAGS_goodput opens a "
                "run); buckets sum to run wall time by construction",
                labelnames=("bucket",)),
            "fraction": _monitor.gauge(
                "goodput_fraction",
                "step-bucket seconds / wall seconds of the last "
                "finalized goodput run (lazy; FLAGS_goodput)"),
            "version": _monitor.gauge(
                "serving_weight_version",
                "weight-version counter the serving engine currently "
                "decodes under (last engine to bump wins; lazy — no "
                "series unless FLAGS_goodput)"),
            "stale": _monitor.counter(
                "serving_stale_sessions_total",
                "served sessions that FINISHED under a weight version "
                "older than the engine's current one (a hot-swap or "
                "adapter load landed mid-session); fires exactly once "
                "per stale finish (lazy; FLAGS_goodput)"),
        }
    return _M


def note_serving_version(counter_value):
    """Publish the serving engine's current weight-version counter on
    the ``serving_weight_version`` gauge (armed call sites only)."""
    from .. import monitor as _monitor

    if _monitor.is_enabled():
        _metrics()["version"].set(int(counter_value))


def note_stale_session():
    """Count one session that finished under a stale weight version."""
    from .. import monitor as _monitor

    if _monitor.is_enabled():
        _metrics()["stale"].inc()


# -- the accountant ------------------------------------------------------------

class GoodputRun:
    """One run's wall-clock accountant: a bucket stack + per-bucket
    totals. Thread-safe (stage graphs tick from the driving thread but
    checkpoint savers may not); every transition — begin, end,
    finalize — books the elapsed time to the bucket that was active."""

    def __init__(self, run_id, stall_threshold_s=None):
        self.run_id = str(run_id)
        self.stall_s = float(
            stall_threshold_s if stall_threshold_s is not None
            else _flags.get_flag("goodput_stall_s", 2.0))
        self.t_start = time.perf_counter()
        self.wall_s = None            # set at finalize
        self.finalized = False
        self.buckets = {b: 0.0 for b in BUCKETS}
        self.counts = {}              # resume/reshard/... event tallies
        self.last_bucket = None       # most recently BOOKED bucket: the
        #                               "what was it doing" answer when a
        #                               crash dump lands after the active
        #                               bucket unwound with the exception
        self._stack = []
        self._last = self.t_start
        self._lock = threading.RLock()
        # crash/stall bundles carry the breakdown + the active bucket at
        # dump time (weakly held; read only when a bundle is written)
        _blackbox.register_provider("goodput", self,
                                    lambda run: run.snapshot())

    # -- attribution -------------------------------------------------------
    def _book(self, now):
        """Book the time since the last transition to the active bucket
        (stack top); an idle gap books ``stall`` past the threshold,
        ``other`` under it. Caller holds the lock."""
        elapsed = now - self._last
        self._last = now
        if elapsed <= 0.0:
            return
        if self._stack:
            b = self._stack[-1]
        else:
            b = "stall" if elapsed >= self.stall_s else "other"
        self.buckets[b] += elapsed
        self.last_bucket = b
        from .. import monitor as _monitor

        if _monitor.is_enabled():
            _metrics()["seconds"].labels(bucket=b).inc(elapsed)

    def begin(self, bucket_name):
        """Enter a bucket: time booked to the PREVIOUS top (or gap)
        first, then this bucket becomes active. Nest freely — the outer
        bucket pauses."""
        if bucket_name not in BUCKETS:
            raise ValueError(
                f"unknown goodput bucket {bucket_name!r} — one of "
                f"{BUCKETS}")
        with self._lock:
            if self.finalized:
                return
            self._book(time.perf_counter())
            self._stack.append(bucket_name)

    def end(self, bucket_name):
        """Leave a bucket: its time is booked and the enclosing bucket
        (if any) resumes. A mismatched end pops the DEEPEST matching
        entry (best effort — an exception may have skipped inner ends);
        an end with no matching begin is a no-op."""
        with self._lock:
            if self.finalized:
                return
            self._book(time.perf_counter())
            if self._stack and self._stack[-1] == bucket_name:
                self._stack.pop()
                return
            for i in range(len(self._stack) - 1, -1, -1):
                if self._stack[i] == bucket_name:
                    del self._stack[i]
                    return

    @contextlib.contextmanager
    def bucket(self, bucket_name):
        self.begin(bucket_name)
        try:
            yield
        finally:
            self.end(bucket_name)

    def count(self, name, n=1):
        """Tally one run-level event (``resume``, ``reshard``, ...) —
        the ``n_resumes``/``n_reshards`` columns of the ledger row."""
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + int(n)

    # -- surfacing ---------------------------------------------------------
    def active(self):
        """The bucket currently on top of the stack, or None (idle)."""
        with self._lock:
            return self._stack[-1] if self._stack else None

    def wall(self):
        if self.wall_s is not None:
            return self.wall_s
        return time.perf_counter() - self.t_start

    def goodput(self):
        """step seconds / wall seconds so far (0.0 on an empty run)."""
        w = self.wall()
        return (self.buckets["step"] / w) if w > 0 else 0.0

    def snapshot(self):
        """JSON-able breakdown: the buckets, the active bucket and the
        goodput so far."""
        with self._lock:
            return {
                "run_id": self.run_id,
                "active_bucket": self._stack[-1] if self._stack else None,
                "last_bucket": self.last_bucket,
                "stack": list(self._stack),
                "wall_s": self.wall(),
                "buckets": dict(self.buckets),
                "counts": dict(self.counts),
                "goodput": self.goodput(),
                "finalized": self.finalized,
            }

    def finalize(self):
        """Close the run: book the trailing gap, freeze wall time, set
        the ``goodput_fraction`` gauge. Idempotent; returns the per-run
        row dict."""
        with self._lock:
            if not self.finalized:
                now = time.perf_counter()
                self._book(now)
                self._stack.clear()
                self.wall_s = now - self.t_start
                self.finalized = True
                from .. import monitor as _monitor

                if _monitor.is_enabled():
                    _metrics()["fraction"].set(self.goodput())
            return {
                "run_id": self.run_id,
                "goodput": self.goodput(),
                "wall_s": self.wall_s,
                "n_resumes": self.counts.get("resume", 0),
                "n_reshards": self.counts.get("reshard", 0),
                "buckets": dict(self.buckets),
            }


# -- the process-current run ---------------------------------------------------

_RUN = None
_RUN_LOCK = threading.Lock()


def start_run(run_id):
    """Open THE process goodput run (hook sites feed whichever run is
    current — one accountant per process). An unfinalized prior run is
    finalized first, so per-leg callers just call start_run at each leg
    head."""
    global _RUN
    with _RUN_LOCK:
        prior, _RUN = _RUN, None
    if prior is not None and not prior.finalized:
        _close(prior)
    run = GoodputRun(run_id)
    with _RUN_LOCK:
        _RUN = run
    return run


def ensure_run(run_id):
    """The current run, or a fresh one under ``run_id`` if none is open
    — how armed trainers/supervisors self-open attribution without
    clobbering a run a tool or bench leg already started."""
    with _RUN_LOCK:
        if _RUN is not None and not _RUN.finalized:
            return _RUN
    return start_run(run_id)


def current_run():
    return _RUN


def end_run():
    """Finalize + detach the current run; publishes the fraction gauge.
    With ``FLAGS_perf_ledger`` also armed, appends the per-run ledger
    row at ``site=run/goodput`` THROUGH the regression sentinel —
    ``goodput`` is LOW_IS_BAD, so a run under its baseline fires
    ``perf_regression_total{site=run/goodput}``. Returns the row dict or
    None when no run was open."""
    global _RUN
    with _RUN_LOCK:
        run, _RUN = _RUN, None
    if run is None:
        return None
    return _close(run)


def _close(run):
    row = run.finalize()
    _blackbox.note("goodput_run", run_id=run.run_id,
                   goodput=row["goodput"], wall_s=row["wall_s"],
                   n_resumes=row["n_resumes"],
                   n_reshards=row["n_reshards"])
    if _flags.get_flag("perf_ledger", False):
        from . import perfledger as _perfledger

        # force=True: every run lands a row; check=True: the sentinel
        # watches goodput itself (direction-aware — LOW_IS_BAD)
        _perfledger.get_ledger().on_step(
            "run/goodput",
            {"goodput": row["goodput"], "wall_s": row["wall_s"],
             "n_resumes": row["n_resumes"],
             "n_reshards": row["n_reshards"],
             "run_id": row["run_id"], "buckets": row["buckets"]},
            sig=row["run_id"], force=True, check=True)
    return row


def reset():
    """Drop the current run WITHOUT finalizing/ledgering it (tests)."""
    global _RUN
    with _RUN_LOCK:
        _RUN = None


# -- hook-site helpers ---------------------------------------------------------

@contextlib.contextmanager
def bucket(bucket_name):
    """``with goodput.bucket("step"):`` against whichever run is
    current — a no-op (beyond one global read) when none is open, so
    armed hook sites never have to know whether a run started."""
    run = _RUN
    if run is None:
        yield
        return
    run.begin(bucket_name)
    try:
        yield
    finally:
        run.end(bucket_name)


def count(name, n=1):
    """Tally one event on the current run (no-op when none is open)."""
    run = _RUN
    if run is not None:
        run.count(name, n=n)
