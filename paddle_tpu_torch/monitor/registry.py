"""StatRegistry: named counters, gauges, and bucketed histograms with labels.

Ports paddle_tpu/monitor/registry.py unchanged (it is pure Python): the
StatRegistry of paddle/fluid/platform/monitor.h with three metric kinds,
prometheus-style labels and an enabled / disabled switch, so that
instrumentation left in a hot loop costs one attribute read when
monitoring is off.

Contract (tests/test_torch_monitor.py holds it against the reference):

- get-or-create by name: ``counter("x")`` twice returns the SAME metric;
  re-declaring a name as a different kind (or different labelnames)
  raises — a silent second registry entry would split the stat;
- thread-safe: series creation and every mutation take the metric lock
  (observations are read-modify-write; the GIL alone does not make
  ``+=`` atomic);
- label cardinality is CAPPED per metric (``LABEL_CARDINALITY_CAP``):
  past the cap, new label combinations collapse into one
  ``__overflow__`` series instead of growing without bound;
- ``reset()`` zeroes values IN PLACE and drops labeled children but keeps
  every metric object registered — instrumentation call sites cache
  metric handles, so reset must never detach them;
- disabled mode: every mutator returns after one attribute check; nothing
  is recorded, nothing allocates.
"""
import bisect
import threading

__all__ = ["StatRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS", "LABEL_CARDINALITY_CAP", "OVERFLOW_LABEL"]

# latency-in-ms oriented (the framework's histograms are all wall-time);
# a metric that wants different resolution passes buckets= explicitly
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0)

LABEL_CARDINALITY_CAP = 64
OVERFLOW_LABEL = "__overflow__"


class _CounterSeries:
    __slots__ = ("labels", "value")
    kind = "counter"

    def __init__(self, labels):
        self.labels = labels
        self.value = 0.0

    def _zero(self):
        self.value = 0.0

    def to_dict(self):
        return {"labels": dict(self.labels), "value": self.value}


class _GaugeSeries(_CounterSeries):
    __slots__ = ()
    kind = "gauge"


class _HistogramSeries:
    __slots__ = ("labels", "buckets", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, labels, buckets):
        self.labels = labels
        self.buckets = buckets          # ascending upper bounds; +Inf implicit
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def _zero(self):
        self.counts = [0] * len(self.counts)
        self.sum = 0.0
        self.count = 0

    def to_dict(self):
        # cumulative bucket counts, prometheus-style: [le, count<=le]
        cum, out = 0, []
        for le, n in zip(self.buckets, self.counts):
            cum += n
            out.append([le, cum])
        out.append(["+Inf", self.count])
        return {"labels": dict(self.labels), "count": self.count,
                "sum": self.sum, "buckets": out}

    def _quantile(self, q):
        """Estimate the q-quantile from the bucket layout: linear
        interpolation inside the winning bucket (prometheus
        histogram_quantile discipline); observations that landed past
        the last finite bound clamp to it — the layout cannot resolve
        further."""
        if self.count <= 0:
            return 0.0
        target = q * self.count
        cum, lo = 0, 0.0
        for le, n in zip(self.buckets, self.counts):
            if n and cum + n >= target:
                frac = (target - cum) / n
                return lo + (le - lo) * min(max(frac, 0.0), 1.0)
            cum += n
            lo = le
        return self.buckets[-1]

    def summary(self, quantiles=(0.5, 0.9, 0.99)):
        """Quantile digest of this series: {"count", "sum", "p50",
        "p90", "p99"} (keys follow the requested quantiles). Estimates,
        not exact order statistics — the raw observations are gone; only
        the bucket layout remains. An empty series digests to zeros."""
        out = {"count": self.count, "sum": self.sum}
        for q in quantiles:
            out["p" + format(q * 100, "g").replace(".", "_")] = \
                self._quantile(q)
        return out


class _Bound:
    """A metric bound to one label combination — the mutation handle the
    instrumentation call sites hold. Mutators re-resolve the series on
    every call (one dict hit) so ``reset()`` can drop children without
    invalidating cached handles."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    # counter / gauge ------------------------------------------------------
    def inc(self, n=1.0):
        m = self._metric
        if not m._registry._enabled:
            return
        if m.kind == "counter" and n < 0:
            raise ValueError(f"counter {m.name!r} cannot decrease")
        with m._lock:
            m._series_for(self._key).value += n

    add = inc

    def dec(self, n=1.0):
        m = self._metric
        if m.kind != "gauge":
            raise TypeError(f"{m.kind} {m.name!r} has no dec()")
        if not m._registry._enabled:
            return
        with m._lock:
            m._series_for(self._key).value -= n

    def set(self, v):
        m = self._metric
        if m.kind != "gauge":
            raise TypeError(f"{m.kind} {m.name!r} has no set()")
        if not m._registry._enabled:
            return
        with m._lock:
            m._series_for(self._key).value = float(v)

    # histogram ------------------------------------------------------------
    def observe(self, v):
        m = self._metric
        if m.kind != "histogram":
            raise TypeError(f"{m.kind} {m.name!r} has no observe()")
        if not m._registry._enabled:
            return
        v = float(v)
        with m._lock:
            s = m._series_for(self._key)
            s.counts[bisect.bisect_left(s.buckets, v)] += 1
            s.sum += v
            s.count += 1

    def summary(self, quantiles=(0.5, 0.9, 0.99)):
        """Quantile digest of the bound series (histogram only); an
        unobserved label combination digests to zeros."""
        m = self._metric
        if m.kind != "histogram":
            raise TypeError(f"{m.kind} {m.name!r} has no summary()")
        with m._lock:
            s = m._peek(self._key)
            if s is None:
                s = m._new_series(self._key)  # zeros; NOT registered
            return s.summary(quantiles)

    # reads (tests / stats()) ----------------------------------------------
    @property
    def value(self):
        s = self._metric._peek(self._key)
        return 0.0 if s is None else s.value

    @property
    def count(self):
        s = self._metric._peek(self._key)
        return 0 if s is None else s.count

    @property
    def sum(self):
        s = self._metric._peek(self._key)
        return 0.0 if s is None else s.sum


class Metric:
    """One named metric: a family of label-keyed series."""

    kind = None
    _series_cls = None

    def __init__(self, registry, name, help="", labelnames=(), buckets=None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._registry = registry
        self._lock = threading.Lock()
        self._series = {}
        self._buckets = None
        if self.kind == "histogram":
            bks = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
            if not bks:
                raise ValueError(f"histogram {name!r}: empty buckets")
            self._buckets = bks
        self._default = _Bound(self, ()) if not self.labelnames else None

    # series management ----------------------------------------------------
    def _new_series(self, key):
        labels = dict(zip(self.labelnames, key))
        if self.kind == "histogram":
            return _HistogramSeries(labels, self._buckets)
        return self._series_cls(labels)

    def _series_for(self, key):
        """Resolve (creating if needed) under self._lock — callers hold it."""
        s = self._series.get(key)
        if s is None:
            if key != () and len(self._series) >= LABEL_CARDINALITY_CAP:
                key = (OVERFLOW_LABEL,) * len(self.labelnames)
                s = self._series.get(key)
                if s is not None:
                    return s
            s = self._series[key] = self._new_series(key)
        return s

    def _peek(self, key):
        s = self._series.get(key)
        if s is None and key != () \
                and len(self._series) >= LABEL_CARDINALITY_CAP:
            s = self._series.get((OVERFLOW_LABEL,) * len(self.labelnames))
        return s

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.kind} {self.name!r} takes labels "
                f"{self.labelnames}, got {tuple(sorted(kv))}")
        return _Bound(self, tuple(str(kv[k]) for k in self.labelnames))

    def _require_unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.kind} {self.name!r} declares labels "
                f"{self.labelnames}; use .labels(...)")
        return self._default

    # unlabeled convenience (delegates to the default series)
    def inc(self, n=1.0):
        self._require_unlabeled().inc(n)

    add = inc

    def dec(self, n=1.0):
        self._require_unlabeled().dec(n)

    def set(self, v):
        self._require_unlabeled().set(v)

    def observe(self, v):
        self._require_unlabeled().observe(v)

    def summary(self, quantiles=(0.5, 0.9, 0.99)):
        return self._require_unlabeled().summary(quantiles)

    @property
    def value(self):
        return self._require_unlabeled().value

    @property
    def count(self):
        return self._require_unlabeled().count

    @property
    def sum(self):
        return self._require_unlabeled().sum

    def series(self):
        with self._lock:
            return [self._series[k] for k in sorted(self._series)]

    def to_dict(self):
        d = {"name": self.name, "type": self.kind, "help": self.help,
             "labelnames": list(self.labelnames),
             "series": [s.to_dict() for s in self.series()]}
        return d

    def _reset(self):
        with self._lock:
            self._series = {k: s for k, s in self._series.items() if k == ()}
            for s in self._series.values():
                s._zero()


class Counter(Metric):
    kind = "counter"
    _series_cls = _CounterSeries


class Gauge(Metric):
    kind = "gauge"
    _series_cls = _GaugeSeries


class Histogram(Metric):
    kind = "histogram"


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class StatRegistry:
    """platform/monitor.h StatRegistry parity: the named-stat singleton
    (module-level ``default_registry()``), get-or-create by name."""

    def __init__(self, enabled=True):
        self._metrics = {}
        self._lock = threading.Lock()
        self._enabled = bool(enabled)

    # enable/disable -------------------------------------------------------
    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def is_enabled(self):
        return self._enabled

    # metric creation ------------------------------------------------------
    def _get_or_create(self, kind, name, help="", labelnames=(),
                       buckets=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"cannot re-register as {kind}")
                if tuple(labelnames) != m.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{m.labelnames}, got {tuple(labelnames)}")
                if kind == "histogram":
                    want = tuple(sorted(float(b) for b in
                                        (buckets or DEFAULT_BUCKETS)))
                    if want != m._buckets:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {m._buckets}, got {want} — a second "
                            "layout would silently mis-bucket observations")
                return m
            m = _KINDS[kind](self, name, help=help, labelnames=labelnames,
                             buckets=buckets)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self):
        """Zero every series in place; labeled children are dropped (their
        call sites re-create them), metric objects stay registered."""
        for m in self.metrics():
            m._reset()

    def snapshot(self):
        """The one schema all three exporters share:
        {"version", "enabled", "metrics": [metric.to_dict()...]}."""
        return {"version": 1, "enabled": self._enabled,
                "metrics": [m.to_dict() for m in self.metrics()]}
