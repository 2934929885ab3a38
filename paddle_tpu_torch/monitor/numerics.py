"""Numerics telescope: batched on-device tensor-health stats + drift detectors.

Ports paddle_tpu/monitor/numerics.py. The non-finite guard fires only
after a step is already ruined; this module watches the numbers
themselves.

**Batched stats** — when ``FLAGS_numerics`` is armed, ``SpmdTrainer``
runs :func:`device_stats` inside each step: per layer, the gradient L2
norm / rms / absmax / max, the non-finite element count, the post-update
param norm, the update norm and update/param ratio, and a small
abs-gradient quantile digest (p50/p90/p99 over a deterministic strided
subsample of at most :data:`DIGEST_CAP` elements). Where the reference's
XLA fuses a per-layer loop into its step, eager PyTorch would pay a launch
for each reduction of each layer (about 1,500 on GPT-2 small), so the
port batches across layers: ``torch._foreach_norm`` (L2 and inf) and
``torch._foreach_max`` over the layer lists, one ``torch.cat`` of the
gradients into a flat buffer for the non-finite counts (one cumulative
sum of ``isnan(x - x)`` read at the layer bounds) and for the digest (one gather of every
layer's subsample into a NaN-padded ``[layers, DIGEST_CAP]`` block, one
row sort, and ``jnp.quantile``'s linear interpolation at each row's own
length). The result stays on the device and is fetched to the host only
every ``FLAGS_numerics_interval`` steps under a ``numerics/fetch`` span.

The subsample picks the elements the reference picks: ``transposed``
names the tensors the port stores transposed against the reference (the
``[out, in]`` Linear weights), and their subsample is read in the
reference's ``[in, out]`` order.

**Drift detectors** — :class:`NumericsMonitor` keeps bounded per-series
history rings with EMA mean/variance baselines and runs the reference's
anomaly rules on every fetch: ``grad_spike``, ``dead_layer``,
``update_ratio``, ``nonfinite`` and ``loss_plateau``. Each anomaly
increments ``numerics_anomaly_total{kind,layer}`` and lands in the flight
recorder's ring (``numerics_anomaly``); the monitor registers itself as a
dump provider so a bundle carries the last model-health snapshot.

Inert by default: ``FLAGS_numerics`` is defined in flags.py so the
disarmed trainer never imports this module, the disarmed step is
bit-identical, and no ``numerics_*`` series exists until armed. The
lockstep A/B harness over these stats is :mod:`paddle_tpu_torch.testing.
parity`. The reference's ``stat_shardings`` has no counterpart (one
device).
"""
import collections
import math

import numpy as np
import torch

from .. import flags as _flags
from . import blackbox_lazy as _blackbox  # import-free recorder facade

__all__ = [
    "STAT_KEYS", "QUANTILES", "DIGEST_CAP", "MIN_BASELINE_POINTS",
    "is_armed", "device_stats", "NumericsMonitor",
]

_flags.define_flag(
    "numerics_history", 64,
    "per-series history-ring capacity of the numerics drift detectors "
    "(oldest observations dropped past it)")
_flags.define_flag(
    "numerics_spike_sigma", 6.0,
    "grad-norm spike rule: fire numerics_anomaly_total{kind=grad_spike} "
    "when a layer's grad norm exceeds its EMA baseline by this many "
    "(floored) standard deviations")
_flags.define_flag(
    "numerics_dead_steps", 3,
    "dead-layer rule: fire after this many CONSECUTIVE observations of "
    "an exactly-zero gradient for one layer")
_flags.define_flag(
    "numerics_ratio_max", 0.25,
    "update-ratio band rule: fire when ||update||/||param|| exceeds "
    "this (the step is rewriting the layer, not nudging it)")
_flags.define_flag(
    "numerics_plateau_window", 8,
    "loss-plateau rule: the loss ring length inspected; a full ring "
    "whose spread is below numerics_plateau_eps fires once per episode")
_flags.define_flag(
    "numerics_plateau_eps", 1e-4,
    "loss-plateau rule: relative spread (max-min over the window, "
    "scaled by |mean|) under which the loss counts as flat")

#: keys of the device_stats output dict
STAT_KEYS = ("grad_norm", "grad_rms", "grad_absmax", "grad_max",
             "nonfinite", "param_norm", "update_norm", "update_ratio",
             "quantiles", "loss")

#: abs-gradient quantile digest points (p50/p90/p99)
QUANTILES = (0.5, 0.9, 0.99)

#: quantile digests over tensors larger than this use a deterministic
#: strided subsample — a full sort of an embedding-table gradient would
#: dominate the step it is meant to observe
DIGEST_CAP = 4096

#: EMA baselines need this many observations before the spike rule arms
#: (a 2-point "baseline" would fire on ordinary early-training motion)
MIN_BASELINE_POINTS = 3

#: the update-ratio rule skips layers whose param norm is below this —
#: against a ~zero denominator (a fresh zero-init bias) the ratio is
#: meaningless and would fire on every ordinary step
RATIO_PARAM_FLOOR = 1e-2


def is_armed():
    """The one master switch (FLAGS_numerics). The trainer reads the
    flag directly so the disarmed path never imports this module; this
    helper is for code that already did."""
    return bool(_flags.get_flag("numerics", False))


# -- batched on-device aggregation ---------------------------------------------

def _digest_positions(n):
    """The reference's ``_digest_source`` as positions into a flat tensor
    of `n` elements: all of them up to the cap, else a ceil-division
    stride (a floor stride would sample only a prefix for sizes just past
    the cap)."""
    if n <= DIGEST_CAP:
        return np.arange(n, dtype=np.int64)
    stride = -(-n // DIGEST_CAP)
    return np.arange(0, n, stride, dtype=np.int64)[:DIGEST_CAP]


_LAYOUTS = {}   # (shapes, transposed flags, device) -> _Layout


class _Layout:
    """Per-layout constants of the batched digest and counts, built once
    on the host and moved to the device: the gather index into the flat
    gradient buffer (padding points at its trailing NaN), each row's
    length, the valid-entry mask and each layer's last flat position."""

    def __init__(self, shapes, transposed, device):
        sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        total = int(starts[-1])
        idx = np.full((len(shapes), DIGEST_CAP), total, np.int64)
        counts = np.zeros(len(shapes), np.float32)
        for row, (shape, n, tr) in enumerate(zip(shapes, sizes, transposed)):
            pos = _digest_positions(n)
            if tr:
                # position k of the reference's [b, a] layout is element
                # (k % a, k // a) of the port's [a, b] tensor
                a, b = shape
                pos = (pos % a) * b + pos // a
            idx[row, :len(pos)] = starts[row] + pos
            counts[row] = len(pos)
        valid = np.arange(DIGEST_CAP)[None, :] < counts[:, None]
        self.index = torch.from_numpy(idx).to(device)
        self.counts = torch.from_numpy(counts).to(device)
        self.valid = torch.from_numpy(valid).to(device)
        self.ends = torch.from_numpy(starts[1:] - 1).to(device)
        self.sizes = torch.tensor(sizes, dtype=torch.float32, device=device)
        self.qs = torch.tensor(QUANTILES, dtype=torch.float32, device=device)


def _layout(shapes, transposed, device):
    key = (tuple(tuple(s) for s in shapes), tuple(transposed), str(device))
    lay = _LAYOUTS.get(key)
    if lay is None:
        if len(_LAYOUTS) >= 16:
            _LAYOUTS.clear()
        lay = _LAYOUTS[key] = _Layout(shapes, transposed, device)
    return lay


def _fp32(ts):
    """The tensors as fp32 (the fp32 ones as they are: no op a tensor on
    the trainer's path, where every gradient and parameter is fp32)."""
    return [t if t.dtype == torch.float32 else t.float() for t in ts]


def _quantile_rows(block, lay):
    """``jnp.quantile(row[:n], QUANTILES)`` of every row of a NaN-padded
    block at its own length n (linear interpolation; a row holding a real
    NaN gives NaN, as jnp's does)."""
    srt = torch.sort(block, dim=1).values          # NaN padding sorts last
    n = lay.counts[:, None]
    pos = lay.qs[None, :] * (n - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    zero = torch.zeros_like(n)
    low = torch.minimum(torch.maximum(low, zero), n - 1.0).long()
    high = torch.minimum(torch.maximum(high, zero), n - 1.0).long()
    out = srt.gather(1, low) * low_w + srt.gather(1, high) * high_w
    has_nan = (torch.isnan(block) & lay.valid).any(dim=1, keepdim=True)
    return torch.where(has_nan, torch.full_like(out, float("nan")), out)


@torch.no_grad()
def _grad_stats(grads, transposed):
    """The gradient half of :func:`device_stats` on a list of gradients:
    stacked [layers] tensors and the [layers, 3] digest, all on the
    gradients' device."""
    gs = _fp32(grads)
    dev = gs[0].device
    lay = _layout([tuple(g.shape) for g in gs], transposed, dev)
    norm = torch.stack(torch._foreach_norm(gs, 2))
    absmax = torch.stack(torch._foreach_norm(gs, float("inf")))
    gmax = torch.stack(torch._foreach_max(gs))
    flat = torch.cat([g.reshape(-1) for g in gs]
                     + [torch.full((1,), float("nan"), device=dev)])
    body = flat[:-1]
    # x - x is NaN exactly where x is NaN or infinite: two passes where
    # isfinite takes four
    bad = torch.cumsum(torch.isnan(body - body), 0, dtype=torch.int32)
    at_end = bad[lay.ends]
    nonfinite = (at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])
                 ).float()
    digest = _quantile_rows(flat[lay.index].abs(), lay)
    return {"grad_norm": norm,
            "grad_rms": norm / torch.sqrt(lay.sizes),
            "grad_absmax": absmax,
            "grad_max": gmax,
            "nonfinite": nonfinite,
            "quantiles": digest}


@torch.no_grad()
def _update_stats(old_params, new_params):
    """The parameter half of :func:`device_stats` on two lists."""
    new = _fp32(new_params)
    upd = torch._foreach_sub(new, _fp32(old_params))
    norms = torch.stack(torch._foreach_norm(new + list(upd), 2))
    pnorm, unorm = norms[:len(new)], norms[len(new):]
    return {"param_norm": pnorm, "update_norm": unorm,
            "update_ratio": unorm / (pnorm + 1e-12)}


def device_stats(names, loss, grads, old_params, new_params,
                 transposed=()):
    """The per-layer health aggregation, on the device. `grads`,
    `old_params`, `new_params`: ``{name: tensor}`` (a missing or None
    gradient reads as zeros); `transposed`: the names stored transposed
    against the reference (their digest subsample follows the reference's
    layout). Returns a dict of float32 tensors, one row per layer in
    ``names`` order, matching :data:`STAT_KEYS`; nothing is read back to
    the host."""
    names = list(names)
    tr = set(transposed)
    gs = [grads.get(n) if grads.get(n) is not None
          else torch.zeros_like(new_params[n]) for n in names]
    out = _grad_stats(gs, [n in tr for n in names])
    out.update(_update_stats([old_params[n] for n in names],
                             [new_params[n] for n in names]))
    return _with_loss(out, loss)


def _with_loss(stats, loss):
    stats["loss"] = torch.as_tensor(loss).detach().float().reshape(())
    return {k: stats[k] for k in STAT_KEYS}


# -- metric families (lazy: no numerics_* series until armed) ------------------

_M = None


def _metrics():
    global _M
    if _M is None:
        from .. import monitor as _monitor

        _M = {
            "grad_norm": _monitor.gauge(
                "numerics_grad_norm",
                "per-layer gradient L2 norm at the last numerics fetch",
                labelnames=("layer",)),
            "param_norm": _monitor.gauge(
                "numerics_param_norm",
                "per-layer post-update parameter L2 norm at the last "
                "numerics fetch", labelnames=("layer",)),
            "update_ratio": _monitor.gauge(
                "numerics_update_ratio",
                "per-layer ||update|| / ||param|| at the last numerics "
                "fetch (federated rounds report the cohort-weighted "
                "aggregate under layer='federated/round')",
                labelnames=("layer",)),
            "grad_rms": _monitor.gauge(
                "numerics_grad_rms",
                "per-layer gradient RMS at the last numerics fetch",
                labelnames=("layer",)),
            "grad_absmax": _monitor.gauge(
                "numerics_grad_absmax",
                "per-layer max |grad| at the last numerics fetch",
                labelnames=("layer",)),
            "loss": _monitor.gauge(
                "numerics_loss",
                "loss at the last numerics fetch (the plateau detector's "
                "input)"),
            "nonfinite": _monitor.counter(
                "numerics_nonfinite_total",
                "non-finite gradient elements seen, by layer (counts "
                "elements, not steps — one poisoned embedding row reads "
                "differently than a fully-NaN tensor)",
                labelnames=("layer",)),
            "anomaly": _monitor.counter(
                "numerics_anomaly_total",
                "drift-detector fires by rule and layer (grad_spike | "
                "dead_layer | update_ratio | nonfinite | loss_plateau)",
                labelnames=("kind", "layer")),
            "fetch_ms": _monitor.histogram(
                "numerics_fetch_ms",
                "wall time of one device->host numerics stats fetch "
                "(every FLAGS_numerics_interval steps)"),
        }
    return _M


class _Ema:
    """EMA mean/variance baseline for one (layer, stat) series."""

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


class NumericsMonitor:
    """Host-side half of the telescope: per-layer history rings, EMA
    baselines, the anomaly rules, and the metric/blackbox surfacing.
    One per SpmdTrainer (created lazily on the first armed fetch);
    registers itself as a blackbox dump provider so every crash/stall
    bundle carries the last model-health snapshot."""

    def __init__(self, layers, source="trainer"):
        self.layers = [str(n) for n in layers]
        self.source = str(source)
        maxlen = max(2, int(_flags.get_flag("numerics_history", 64)))
        self._hist = collections.defaultdict(
            lambda: collections.deque(maxlen=maxlen))   # (layer, stat) ->
        self._ema = {}                                  # (layer, stat) -> _Ema
        self._dead = {}                                 # layer -> zero streak
        self._plateau_active = False
        self.anomalies = collections.deque(maxlen=64)
        self.fetches = 0
        self.last_step = None
        self.last_loss = None
        self._last = {}          # layer -> {stat: float} (latest snapshot)
        self._bound = {}         # (family, layer) -> its labelled handle
        _blackbox.register_provider("numerics", self,
                                    lambda m: m.snapshot())

    def _series(self, m, family, layer):
        """The (family, layer) handle, resolved once: a fetch sets five
        gauges a layer, and a handle re-resolves its series on each use,
        so a registry reset stays safe."""
        key = (family, layer)
        h = self._bound.get(key)
        if h is None:
            h = self._bound[key] = m[family].labels(layer=layer)
        return h

    # -- ring/baseline plumbing -------------------------------------------
    def history(self, layer, stat):
        """The bounded observation ring for one (layer, stat) series."""
        return list(self._hist[(layer, stat)])

    def _push(self, layer, stat, value):
        self._hist[(layer, stat)].append(value)

    def _baseline(self, layer, stat):
        key = (layer, stat)
        ema = self._ema.get(key)
        if ema is None:
            ema = self._ema[key] = _Ema()
        return ema

    def _fire(self, kind, layer, step, value, baseline=None):
        rec = {"kind": kind, "layer": layer, "step": step,
               "value": None if value is None else float(value)}
        if baseline is not None:
            rec["baseline"] = float(baseline)
        self.anomalies.append(rec)
        from .. import monitor as _monitor

        if _monitor.is_enabled():
            _metrics()["anomaly"].labels(kind=kind, layer=layer).inc()
        _blackbox.note("numerics_anomaly", source=self.source, rule=kind,
                       layer=layer, step=step, value=rec["value"])
        return rec

    # -- the fetch entry point --------------------------------------------
    def observe(self, host_stats, step):
        """Ingest one host-fetched stats dict ({stat: np.ndarray row per
        layer in self.layers order}; missing keys tolerated). Updates
        gauges and rings, runs every detector, returns the list of NEW
        anomalies."""
        from .. import monitor as _monitor

        step = int(step)
        self.fetches += 1
        self.last_step = step
        fired = []
        # Python lists: a layer's values are read one at a time, which
        # numpy scalars make several times slower
        per_layer = {k: np.asarray(v).tolist() for k, v in host_stats.items()
                     if k in STAT_KEYS and k != "loss"}
        loss = host_stats.get("loss")
        mon = _monitor.is_enabled()
        m = _metrics() if mon else None
        spike_sigma = float(_flags.get_flag("numerics_spike_sigma", 6.0))
        dead_steps = max(1, int(_flags.get_flag("numerics_dead_steps", 3)))
        ratio_max = float(_flags.get_flag("numerics_ratio_max", 0.25))

        for i, layer in enumerate(self.layers):
            snap = self._last.setdefault(layer, {})
            for stat, arr in per_layer.items():
                if i >= len(arr):
                    continue
                val = arr[i]
                if stat == "quantiles":
                    snap["quantiles"] = [float(q) for q in
                                         np.asarray(val).ravel()]
                    continue
                val = float(val)
                snap[stat] = val
                if mon and stat in ("grad_norm", "param_norm",
                                    "update_ratio", "grad_rms",
                                    "grad_absmax"):
                    self._series(m, stat, layer).set(
                        val if math.isfinite(val) else -1.0)
            # ---- detectors (per layer) --------------------------------
            gn = snap.get("grad_norm")
            if gn is not None:
                base = self._baseline(layer, "grad_norm")
                if base.n >= MIN_BASELINE_POINTS and math.isfinite(gn):
                    floor = max(base.std(), 0.05 * abs(base.mean), 1e-9)
                    if gn > base.mean + spike_sigma * floor:
                        fired.append(self._fire(
                            "grad_spike", layer, step, gn,
                            baseline=base.mean))
                if math.isfinite(gn):
                    base.update(gn)
                self._push(layer, "grad_norm", gn)
                # dead layer: EXACT zero — an optimizer that unhooked a
                # layer produces true zeros, not small floats
                if gn == 0.0:
                    streak = self._dead.get(layer, 0) + 1
                    self._dead[layer] = streak
                    if streak == dead_steps:
                        fired.append(self._fire(
                            "dead_layer", layer, step, 0.0))
                else:
                    self._dead[layer] = 0
            ratio = snap.get("update_ratio")
            if ratio is not None:
                self._push(layer, "update_ratio", ratio)
                base = self._baseline(layer, "update_ratio")
                pnorm = snap.get("param_norm")
                # out of band AND well above the layer's own baseline: a
                # fresh zero-init param legitimately runs ratios of O(1)
                # for its first steps (norm growing from nothing), so the
                # absolute band alone would cry wolf through warmup
                if (base.n >= MIN_BASELINE_POINTS
                        and math.isfinite(ratio) and ratio > ratio_max
                        and ratio > 3.0 * abs(base.mean)
                        and (pnorm is None or pnorm > RATIO_PARAM_FLOOR)):
                    fired.append(self._fire(
                        "update_ratio", layer, step, ratio,
                        baseline=base.mean))
                if math.isfinite(ratio):
                    base.update(ratio)
            nonf = snap.get("nonfinite")
            if nonf:
                if mon:
                    self._series(m, "nonfinite", layer).inc(nonf)
                fired.append(self._fire("nonfinite", layer, step, nonf))

        # ---- loss plateau (whole model) -------------------------------
        if loss is not None:
            loss = float(np.asarray(loss))
            self.last_loss = loss
            if mon:
                m["loss"].set(loss if math.isfinite(loss) else -1.0)
            ring = self._hist[("loss", "loss")]
            ring.append(loss)
            # window clamped to the ring's capacity: a window larger
            # than numerics_history could otherwise never fill and the
            # plateau rule would be silently dead
            window = max(2, min(
                int(_flags.get_flag("numerics_plateau_window", 8)),
                ring.maxlen))
            eps = float(_flags.get_flag("numerics_plateau_eps", 1e-4))
            tail = list(ring)[-window:]
            if len(tail) >= window and all(math.isfinite(v) for v in tail):
                spread = max(tail) - min(tail)
                scale = max(abs(sum(tail) / len(tail)), 1e-6)
                if spread <= eps * scale:
                    if not self._plateau_active:
                        self._plateau_active = True
                        fired.append(self._fire(
                            "loss_plateau", "loss", step, loss,
                            baseline=spread))
                else:
                    self._plateau_active = False
        return fired

    # -- surfacing ---------------------------------------------------------
    def snapshot(self):
        """JSON-able model-health snapshot: the blackbox dump provider
        table and ``SpmdTrainer.stats()["numerics"]``."""
        return {
            "source": self.source,
            "step": self.last_step,
            "loss": self.last_loss,
            "fetches": self.fetches,
            "layers": {layer: dict(stats)
                       for layer, stats in self._last.items()},
            "anomalies": list(self.anomalies)[-10:],
        }
