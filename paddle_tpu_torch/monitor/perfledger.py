"""Perf ledger: persistent cross-run performance telemetry + regression sentinel.

Ports paddle_tpu/monitor/perfledger.py.

**Ledger** — when ``FLAGS_perf_ledger`` is armed, the trainer, serving
engines and goodput runs append one JSON row per observation window to
``FLAGS_perf_ledger_path``: an append-only JSONL file (one write, flush
and fsync a row; readers tolerate a torn tail). Each row carries the
site, the batch signature, the device, an environment fingerprint and a
flat metrics dict — step wall ms, MFU, FLOPs and bytes from the cost
registry (trace/costs.py), and p50/p90/p99 latency digests from the
registry histograms' ``summary()``.

**Regression sentinel** — per-(site, metric) EMA mean/variance baselines
watch every observation; a value more than ``FLAGS_perf_ledger_sigma``
deviations on the *bad* side of its baseline (direction per
:data:`HIGH_IS_BAD` / :data:`LOW_IS_BAD`) fires
``perf_regression_total{site,metric}``, notes the flight-recorder ring,
and latches per episode so a sustained regression counts once. The
ledger registers itself as a flight-recorder dump provider.

The one translation: the environment fingerprint. :data:`CORE_FINGERPRINT`
is torch, CUDA, python, machine and CPU count, and the device platform,
kind and count come from ``torch.cuda`` (read only when CUDA is already
initialised, so a row never initialises it), so that rows of the port and
of the JAX package never share a baseline. Metrics the port cannot
produce stay absent, as the reference leaves a missing source absent: the
compile-cache sources (nothing compiles ahead of time: framework/aot.py is
not ported), collective bytes (one device), and the trainer's dispatch
fraction (an eager step has no separate dispatch window).
``record_stage_runner`` raises NotImplementedError (distributed/stage.py
is not ported); ``record_leg`` is kept for a benchmark harness's legs.

Inert by default: ``FLAGS_perf_ledger`` is defined in flags.py so every
hook site is one boolean check, the disarmed path never imports this
module, no ``perf_*`` series exists until armed, and armed and disarmed
runs train bit-identically (the ledger only reads host timings).
"""
import collections
import json
import math
import os
import platform
import threading
import time

from .. import flags as _flags
from . import blackbox_lazy as _blackbox  # import-free recorder facade

__all__ = [
    "SCHEMA_VERSION", "CORE_FINGERPRINT", "HIGH_IS_BAD", "LOW_IS_BAD",
    "is_armed", "env_fingerprint", "fingerprint_key", "append_row",
    "load_rows", "tail", "Ema", "PerfLedger", "get_ledger",
    "reset_ledger", "baselines", "check_value", "record_trainer",
    "record_engine", "record_stage_runner", "record_leg",
]

#: ledger row schema version; readers skip rows of any other version
SCHEMA_VERSION = 1

#: fingerprint fields that KEY baseline grouping — the software env.
#: Device fields (platform/device_kind/device_count) ride along in rows
#: for humans but do not gate matching.
CORE_FINGERPRINT = ("torch", "cuda", "python", "machine", "cpu_count")

#: metrics where LARGER observations are regressions (wall times)
HIGH_IS_BAD = ("step_ms", "exec_ms", "sync_ms", "compile_ms",
               "queue_wait_ms", "ttft_ms", "inter_token_ms", "tick_ms",
               "run_ms", "fetch_ms", "kv_bytes_per_session")

#: metrics where SMALLER observations are regressions (throughputs).
#: ``dispatch_fraction`` is deliberately in NEITHER list: the budget
#: tests treat a HIGH fraction (host-bound step) as the failure, so it
#: is recorded in rows but never sentinel-fired.
LOW_IS_BAD = ("mfu", "tokens_per_s", "prefix_hit_rate", "accept_rate",
              "goodput")   # run/goodput rows (monitor/goodput.py): a
#                            goodput fraction BELOW its baseline is the
#                            regression


def is_armed():
    """The one master switch (FLAGS_perf_ledger). Hook sites read the
    flag directly so the disarmed path never imports this module; this
    helper is for code that already did."""
    return bool(_flags.get_flag("perf_ledger", False))


# -- environment fingerprint ---------------------------------------------------

def env_fingerprint():
    """The env a measurement is only comparable within: torch / CUDA /
    python versions, machine, cpu count — plus the device platform, kind
    and count when CUDA is already initialised (never forces it up: a
    ledger row must not initialise the card)."""
    import torch

    fp = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "machine": platform.machine(),
        "cpu_count": os.cpu_count() or 1,
    }
    try:
        if torch.cuda.is_initialized():
            fp["platform"] = "gpu"
            fp["device_kind"] = torch.cuda.get_device_name(0)
            fp["device_count"] = torch.cuda.device_count()
        else:
            fp["platform"] = "cpu"
    except Exception:
        pass
    return fp


def fingerprint_key(fp):
    """Stable string key over :data:`CORE_FINGERPRINT` — what baseline
    grouping matches on."""
    return "|".join(f"{k}={fp.get(k)}" for k in CORE_FINGERPRINT)


# -- JSONL persistence (the --banked discipline) -------------------------------

def _jsonable(v):
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if v is None or isinstance(v, (bool, str, int)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    try:
        f = float(v)  # numpy scalars
        return f if math.isfinite(f) else None
    except Exception:
        return str(v)


def append_row(path, row):
    """Append ONE row as one line: a single buffered write, flushed and
    fsynced, so a concurrent reader (or a crash) sees whole lines plus
    at most one torn tail — which :func:`load_rows` skips."""
    line = json.dumps(_jsonable(row), sort_keys=True) + "\n"
    with open(path, "a", encoding="utf-8") as f:
        f.write(line)
        f.flush()
        os.fsync(f.fileno())


def load_rows(path):
    """Every well-formed current-schema row in the ledger; a torn tail
    (partial last line from a killed writer), blank lines, and rows of a
    foreign schema version are skipped, never raised on."""
    rows = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue  # torn tail / partial write
                if isinstance(row, dict) \
                        and row.get("v") == SCHEMA_VERSION:
                    rows.append(row)
    except OSError:
        return []
    return rows


def tail(path, n=20):
    """The last ``n`` rows — crash-bundle and --explain fodder."""
    return load_rows(path)[-n:] if path else []


# -- metric families (lazy: no perf_* series until armed) ----------------------

_M = None


def _metrics():
    global _M
    if _M is None:
        from .. import monitor as _monitor

        _M = {
            "rows": _monitor.counter(
                "perf_ledger_rows_total",
                "perf-ledger rows appended, by site (lazy — no series "
                "until FLAGS_perf_ledger arms a recording site)",
                labelnames=("site",)),
            "regression": _monitor.counter(
                "perf_regression_total",
                "perf-regression sentinel fires: an observation "
                "FLAGS_perf_ledger_sigma EMA deviations on the bad side "
                "of its per-(site,metric) baseline (one fire per "
                "episode, not per step)",
                labelnames=("site", "metric")),
        }
    return _M


class Ema:
    """EMA mean/variance baseline for one (site, metric) series — the
    numerics-telescope estimator."""

    __slots__ = ("mean", "var", "n")

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x, alpha=0.25):
        if self.n == 0:
            self.mean = x
            self.var = 0.0
        else:
            diff = x - self.mean
            incr = alpha * diff
            self.mean += incr
            self.var = (1.0 - alpha) * (self.var + diff * incr)
        self.n += 1

    def std(self):
        return math.sqrt(max(self.var, 0.0))


def baselines(rows, env=None):
    """Fold ledger rows into per-(site, metric) :class:`Ema` baselines,
    keeping only rows whose :func:`fingerprint_key` matches ``env``
    (default: this process) and only sentinel-directed metrics — a
    cross-machine row must never tighten this machine's floors."""
    key = fingerprint_key(env if env is not None else env_fingerprint())
    out = {}
    for row in rows:
        if fingerprint_key(row.get("env") or {}) != key:
            continue
        if (row.get("metrics") or {}).get("cold"):
            continue  # compile-resolving window: not the steady state
        site = row.get("site")
        for name, v in (row.get("metrics") or {}).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            v = float(v)
            if not math.isfinite(v):
                continue
            if name not in HIGH_IS_BAD and name not in LOW_IS_BAD:
                continue
            ema = out.get((site, name))
            if ema is None:
                ema = out[(site, name)] = Ema()
            ema.update(v)
    return out


def check_value(ema, metric, value, sigma):
    """One fresh measurement against one baseline: (regressed?, excess
    in floored sigmas). The deviation floor (5% of the mean) keeps a
    near-constant series from declaring noise a regression."""
    sign = 1.0 if metric in HIGH_IS_BAD else -1.0
    floor = max(ema.std(), 0.05 * abs(ema.mean), 1e-9)
    excess = sign * (float(value) - ema.mean) / floor
    return excess > float(sigma), excess


# -- the ledger ----------------------------------------------------------------

class PerfLedger:
    """One per process (see :func:`get_ledger`): the JSONL appender, the
    per-(site, metric) sentinel, and the blackbox dump provider. Flag
    knobs (path/sigma/warmup/interval) are consumed at construction."""

    def __init__(self, path=None):
        self.path = str(path if path is not None
                        else _flags.get_flag("perf_ledger_path", ""))
        self.sigma = float(_flags.get_flag("perf_ledger_sigma", 4.0))
        self.warmup = max(2, int(_flags.get_flag("perf_ledger_warmup", 5)))
        self.interval = max(1, int(_flags.get_flag("perf_ledger_interval",
                                                   1)))
        self.env = env_fingerprint()
        self.rows_written = 0
        self.regressions = collections.deque(maxlen=64)
        self._ema = {}        # (site, metric) -> Ema
        self._counts = {}     # site -> observations so far
        self._episode = set()  # (site, metric) latched while out of band
        self._last_row = {}   # site -> last row (bundle fodder)
        self._lock = threading.Lock()
        _blackbox.register_provider("perf_ledger", self,
                                    lambda led: led.snapshot())

    # -- sentinel ----------------------------------------------------------
    def _check(self, site, metric, value):
        """Baseline one observation; returns the fired regression record
        or None. Out-of-band values do NOT update the EMA — a sustained
        regression must not drag its own baseline up to meet it."""
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return None
        value = float(value)
        if not math.isfinite(value):
            return None
        if metric in HIGH_IS_BAD:
            sign = 1.0
        elif metric in LOW_IS_BAD:
            sign = -1.0
        else:
            return None  # recorded in rows, never fired on
        key = (site, metric)
        ema = self._ema.get(key)
        if ema is None:
            ema = self._ema[key] = Ema()
        if ema.n >= self.warmup:
            floor = max(ema.std(), 0.05 * abs(ema.mean), 1e-9)
            if sign * (value - ema.mean) > self.sigma * floor:
                if key in self._episode:
                    return None
                self._episode.add(key)
                return self._fire(site, metric, value, ema)
            self._episode.discard(key)
        ema.update(value)
        return None

    def _fire(self, site, metric, value, ema):
        rec = {"site": site, "metric": metric, "value": float(value),
               "mean": float(ema.mean), "std": float(ema.std())}
        self.regressions.append(rec)
        from .. import monitor as _monitor

        if _monitor.is_enabled():
            _metrics()["regression"].labels(site=site, metric=metric).inc()
        _blackbox.note("perf_regression", site=site, metric=metric,
                       value=rec["value"], mean=rec["mean"],
                       std=rec["std"])
        return rec

    # -- recording ---------------------------------------------------------
    def observe(self, site, metrics):
        """Sentinel-only pass: baseline every numeric metric, fire on
        the out-of-band ones, append NO row and advance NO interval
        counter (per-round feeds whose rows come from a richer stats()
        fold — the serving engine's step hook)."""
        site = str(site)
        fired = []
        with self._lock:
            for name in sorted(metrics):
                rec = self._check(site, name, metrics[name])
                if rec is not None:
                    fired.append(rec)
        return fired

    def on_step(self, site, metrics, sig=None, mesh=None, force=False,
                check=True):
        """Ingest one observation window for ``site``: every numeric
        metric goes through the sentinel; every
        ``FLAGS_perf_ledger_interval``-th call per site (or ``force``)
        appends a ledger row. ``check=False`` records the row but skips
        the sentinel — for out-of-distribution windows (a step that
        resolved a compile) that must not poison the steady-state
        baseline. Returns the list of fired regressions."""
        site = str(site)
        fired = []
        with self._lock:
            if check:
                for name in sorted(metrics):
                    rec = self._check(site, name, metrics[name])
                    if rec is not None:
                        fired.append(rec)
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            if force or n % self.interval == 0:
                self._append(site, metrics, sig=sig, mesh=mesh)
        return fired

    def _append(self, site, metrics, sig=None, mesh=None):
        row = {"v": SCHEMA_VERSION, "ts": time.time(), "site": site,
               "sig": None if sig is None else str(sig),
               "mesh": None if mesh is None else str(mesh),
               "env": self.env, "metrics": _jsonable(metrics)}
        self._last_row[site] = row
        if self.path:
            try:
                append_row(self.path, row)
            except OSError:
                # a full disk / revoked path drops telemetry, never the
                # step it was observing
                return row
        self.rows_written += 1
        from .. import monitor as _monitor

        if _monitor.is_enabled():
            _metrics()["rows"].labels(site=site).inc()
        return row

    # -- surfacing ---------------------------------------------------------
    def snapshot(self):
        """JSON-able perf snapshot: the blackbox dump-provider table, so
        crash/stall bundles carry the last rows + recent regressions +
        the on-disk tail."""
        return {
            "path": self.path or None,
            "env": self.env,
            "rows_written": self.rows_written,
            "sites": dict(sorted(self._counts.items())),
            "regressions": list(self.regressions)[-10:],
            "last_rows": {s: r for s, r in sorted(self._last_row.items())},
            "tail": tail(self.path, 5),
        }


_LEDGER = None
_LEDGER_LOCK = threading.Lock()


def get_ledger():
    """The process ledger (created on first armed use — flag knobs are
    read then). All sites share it: one file, one env fingerprint, one
    sentinel namespace."""
    global _LEDGER
    with _LEDGER_LOCK:
        if _LEDGER is None:
            _LEDGER = PerfLedger()
        return _LEDGER


def reset_ledger():
    """Drop the process ledger so the next :func:`get_ledger` re-reads
    the flag knobs (tests re-pointing FLAGS_perf_ledger_path)."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = None


# -- site recorders ------------------------------------------------------------
# Each folds one subsystem's stats() into a flat metrics dict and hands
# it to the ledger. They live HERE (not on the subsystems) so the hook
# in each subsystem stays one boolean + one call.

def _registry_collectives():
    """Per-op collective tallies from the default registry: wire bytes,
    displaced (saved) bytes, call counts — cumulative process totals."""
    from .. import monitor as _monitor

    out = {}
    reg = _monitor.default_registry()
    for fam, key in (("collective_bytes_total", "bytes"),
                     ("collective_bytes_saved_total", "saved"),
                     ("collective_calls_total", "calls")):
        met = reg.get(fam)
        if met is None:
            continue
        for s in met.series():
            op = s.labels.get("op", "")
            out.setdefault(op, {})[key] = s.value
    return out


def _hist_summary(name, **labels):
    from .. import monitor as _monitor

    met = _monitor.default_registry().get(name)
    if met is None or met.kind != "histogram":
        return None
    try:
        bound = met.labels(**labels) if labels else met
        d = bound.summary()
    except (TypeError, ValueError):
        return None
    return d if d.get("count") else None


def record_trainer(trainer, ledger=None, site="trainer"):
    """One ledger row + sentinel pass from ``SpmdTrainer.stats()``:
    averaged step/sync wall ms, MFU, cost-registry flops/HBM bytes, the
    dispatch fraction where the breakdown has one, per-op collective
    bytes where any were recorded, and the step-latency digest."""
    led = ledger if ledger is not None else get_ledger()
    st = trainer.stats()
    br = st.get("breakdown") or {}
    steps = max(1, int(st.get("steps") or 0))
    tot = float(st.get("step_ms_total") or 0.0)
    m = {
        "steps": st.get("steps"),
        "step_ms": st.get("step_ms_avg"),
        "sync_ms": float(br.get("sync_ms_total") or 0.0) / steps,
        "mfu": st.get("mfu"),
        "flops_per_step": st.get("flops_per_step"),
        "peak_flops": st.get("peak_flops"),
    }
    hbm = st.get("hbm") or {}
    for k, v in hbm.items():
        m["hbm_" + str(k)] = v
    if tot > 0 and br.get("dispatch_ms_total") is not None:
        m["dispatch_fraction"] = float(br["dispatch_ms_total"]) / tot
    coll = _registry_collectives()
    if coll:
        m["collectives"] = coll
    dig = _hist_summary("step_latency_ms", site=site)
    if dig:
        m["step_latency"] = dig
    mesh = None
    dev = getattr(trainer, "_device", None)
    if dev is not None:
        mesh = f"device={dev}"
    return led.on_step(site, m, sig=st.get("batch_sig"), mesh=mesh,
                       force=True)


def record_engine(engine, ledger=None, site="serving"):
    """One ledger row + sentinel pass from
    ``ServingEngine.stats()["breakdown"]`` (per-kind step wall ms +
    executed device flops) + the request-lifecycle latency digests
    (queue wait, TTFT, inter-token: the engine's own accumulators plus
    the registry histograms' p50/p90/p99 summary())."""
    led = ledger if ledger is not None else get_ledger()
    st = engine.stats()
    br = st.get("breakdown") or {}
    m = {
        "tokens_generated": st.get("tokens_generated"),
        "batch_occupancy_avg": st.get("batch_occupancy_avg"),
        "wall_ms_total": br.get("wall_ms_total"),
    }
    hit_rate = (st.get("prefix_cache") or {}).get("hit_rate")
    if hit_rate is not None:
        m["prefix_hit_rate"] = hit_rate
    accept = (st.get("speculative") or {}).get("accept_rate")
    if accept is not None:
        m["accept_rate"] = accept
    for kind, row in (br.get("kinds") or {}).items():
        count = int(row.get("count") or 0)
        if count:
            m[str(kind) + "_step_ms"] = \
                float(row.get("wall_ms") or 0.0) / count
        if row.get("device_flops_total") is not None:
            m[str(kind) + "_flops_total"] = row["device_flops_total"]
    for key in ("queue_wait_ms", "ttft_ms", "inter_token_ms"):
        acc = st.get(key)
        if isinstance(acc, dict) and acc.get("count"):
            m[key] = acc.get("avg_ms", 0.0)
        dig = _hist_summary("serving_" + key)
        if dig:
            m[key[:-3] + "digest"] = dig
    out = led.on_step(site, m, force=True)
    pg = st.get("paging")
    if isinstance(pg, dict):
        # paged engines (FLAGS_paged_kv) append a second row under
        # site/paged_step: pool occupancy + the per-session KV footprint
        # the block tables exist to shrink. kv_bytes_per_session is
        # sentinel-watched HIGH_IS_BAD — a sharing regression (lost
        # prefix dedup, leaked frames) fires perf_regression_total
        # before it becomes an OOM
        mp = {k: v for k, v in pg.items()
              if isinstance(v, (int, float)) and not isinstance(v, bool)}
        ad = pg.get("adapters")
        if isinstance(ad, dict):
            for k, v in ad.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    mp["adapter_" + str(k)] = v
        led.on_step(site + "/paged_step", mp, force=True)
    return out


def record_stage_runner(runner, ledger=None, site="stage"):
    """A StageGraph / MpmdPipelineRunner row: not ported (the port has no
    distributed/stage.py)."""
    raise NotImplementedError(
        "perfledger.record_stage_runner is not ported yet (it needs "
        "distributed/stage.py, the stage graph)")


def record_leg(leg, data, ledger=None):
    """One ledger row per benchmark leg: the leg's numeric fields
    (tokens/s, MFU, wall s, ...) under ``site="bench/<leg>"``. No port
    path calls it: it is kept for a benchmark harness's legs."""
    led = ledger if ledger is not None else get_ledger()
    m = {k: v for k, v in dict(data).items()
         if isinstance(v, (int, float)) and not isinstance(v, bool)}
    for k in ("collectives", "hbm"):
        v = dict(data).get(k)
        if isinstance(v, dict):
            m[k] = v
    return led.on_step("bench/" + str(leg), m, force=True)
