"""Lockstep A/B loss-parity harness.

Ports paddle_tpu/testing/parity.py over the port's ``SpmdTrainer``. Build
the SAME model twice (identical seed), once under a *reference* flag-set
and once under a *candidate* one, drive both trainers lockstep over
IDENTICAL batches, and check that the per-step loss and per-layer
gradient statistics stay within *declared* tolerances.

The grad stats come from the numerics telescope
(:mod:`paddle_tpu_torch.monitor.numerics`): the harness arms
``FLAGS_numerics`` with ``numerics_interval=1`` around both sides, so
every step's per-layer stats are fetched and compared — a change that
keeps the loss curve but rewrites one layer's gradient flow diverges
here.

    from paddle_tpu_torch.testing import parity

    report = parity.run_parity(
        build,                      # () -> SpmdTrainer, called per side
        batches,                    # [(x, y), ...] — identical for both
        candidate_flags={"check_nan_inf": True},
        loss_rtol=0.0, loss_atol=0.0)      # declared tolerance: exact
    parity.assert_parity(report)           # raises naming step + stat
"""
import contextlib

import numpy as np

from .. import flags as _flags
from ..core.generator import seed as _seed

__all__ = [
    "ParityDivergence", "flag_scope", "run_lockstep", "compare_traces",
    "run_parity", "assert_parity", "STAT_COMPARE_KEYS",
]

#: per-layer stat families compared step-by-step (a subset of
#: monitor/numerics.py STAT_KEYS — the scale-free ones that make
#: cross-config comparison meaningful)
STAT_COMPARE_KEYS = ("grad_norm", "update_ratio", "grad_absmax")


class ParityDivergence(AssertionError):
    """A lockstep A/B left its declared tolerance band. The message (and
    ``.divergence`` attribute) name the first diverging step and stat."""

    def __init__(self, message, divergence=None):
        super().__init__(message)
        self.divergence = divergence


@contextlib.contextmanager
def flag_scope(flags):
    """Set FLAGS_* for the with-block, restoring previous values on
    exit. Flags the block INTRODUCED (not yet defined — e.g. a detector
    knob whose lazily-imported module hasn't loaded) are un-defined
    again, so one side's candidate config can never leak into the other
    side — or the next run_parity — through define_flag's
    existing-value-wins rule."""
    flags = {k[6:] if k.startswith("FLAGS_") else k: v
             for k, v in (flags or {}).items()}
    saved = {k: _flags.get_flag(k) for k in flags
             if k in _flags._REGISTRY}
    introduced = [k for k in flags if k not in _flags._REGISTRY]
    _flags.set_flags(flags)
    try:
        yield
    finally:
        _flags.set_flags(saved)
        for k in introduced:
            _flags._REGISTRY.pop(k, None)


def run_lockstep(build, batches, flags=None, seed=0):
    """Run one side of the A/B: under `flags` (+ the forced numerics
    arming), seed, build a trainer via ``build()``, and drive it over
    `batches` (each a tuple/list of per-step arrays). Returns the trace
    {"loss": [float/step], "stats": [{stat: np.ndarray}/step],
    "layers": [param names]}."""
    merged = dict(flags or {})
    merged.setdefault("numerics", True)
    merged.setdefault("numerics_interval", 1)
    with flag_scope(merged):
        _seed(seed)
        trainer = build()
        # sorted — the row order of the trainer's numerics stats
        trace = {"loss": [], "stats": [], "layers": sorted(trainer.params)}
        for batch in batches:
            loss = trainer.train_step(*batch)
            trace["loss"].append(float(loss))
            host = trainer.numerics_fetch()
            trace["stats"].append(
                {k: np.array(host[k], copy=True)
                 for k in STAT_COMPARE_KEYS} if host else {})
    return trace


def _in_band(ref, cand, rtol, atol):
    if np.isnan(ref) and np.isnan(cand):
        return True
    if not (np.isfinite(ref) and np.isfinite(cand)):
        return ref == cand
    return abs(cand - ref) <= atol + rtol * abs(ref)


def compare_traces(ref, cand, loss_rtol=0.0, loss_atol=0.0,
                   stat_rtol=None, stat_atol=None):
    """Step-by-step comparison of two run_lockstep traces. Returns a
    report dict; ``report["first_divergence"]`` names the earliest
    out-of-band (step, stat, layer) or is None. Stat tolerances default
    to the loss ones (widened ×10 — per-layer norms wobble more than
    their aggregate)."""
    stat_rtol = 10.0 * loss_rtol if stat_rtol is None else stat_rtol
    stat_atol = 10.0 * loss_atol if stat_atol is None else stat_atol
    steps = min(len(ref["loss"]), len(cand["loss"]))
    layers = ref["layers"]
    first = None
    max_loss_diff = 0.0
    for i in range(steps):
        lr_, lc = ref["loss"][i], cand["loss"][i]
        if np.isfinite(lr_) and np.isfinite(lc):
            max_loss_diff = max(max_loss_diff, abs(lc - lr_))
        if not _in_band(lr_, lc, loss_rtol, loss_atol):
            first = {"step": i, "stat": "loss", "layer": None,
                     "reference": lr_, "candidate": lc,
                     "abs_diff": abs(lc - lr_)}
            break
        sr, sc = ref["stats"][i], cand["stats"][i]
        for stat in STAT_COMPARE_KEYS:
            if stat not in sr or stat not in sc:
                continue
            for j, layer in enumerate(layers):
                rv, cv = float(sr[stat][j]), float(sc[stat][j])
                if not _in_band(rv, cv, stat_rtol, stat_atol):
                    first = {"step": i, "stat": stat, "layer": layer,
                             "reference": rv, "candidate": cv,
                             "abs_diff": abs(cv - rv)}
                    break
            if first:
                break
        if first:
            break
    return {
        "steps": steps,
        "diverged": first is not None,
        "first_divergence": first,
        "max_abs_loss_diff": max_loss_diff,
        "tolerances": {"loss_rtol": loss_rtol, "loss_atol": loss_atol,
                       "stat_rtol": stat_rtol, "stat_atol": stat_atol},
    }


def run_parity(build, batches, build_candidate=None, reference_flags=None,
               candidate_flags=None, loss_rtol=0.0, loss_atol=0.0,
               stat_rtol=None, stat_atol=None, seed=0):
    """The whole A/B: reference side (``build`` under
    ``reference_flags``) vs candidate side (``build_candidate`` or the
    same ``build``, under ``candidate_flags``), lockstep over identical
    `batches`, compared within the declared tolerances. Returns the
    compare_traces report, annotated with both flag-sets and both loss
    curves."""
    ref = run_lockstep(build, batches, flags=reference_flags, seed=seed)
    cand = run_lockstep(build_candidate or build, batches,
                        flags=candidate_flags, seed=seed)
    report = compare_traces(ref, cand, loss_rtol=loss_rtol,
                            loss_atol=loss_atol, stat_rtol=stat_rtol,
                            stat_atol=stat_atol)
    report["flags"] = {"reference": dict(reference_flags or {}),
                       "candidate": dict(candidate_flags or {})}
    report["loss"] = {"reference": ref["loss"], "candidate": cand["loss"]}
    return report


def assert_parity(report):
    """Raise :class:`ParityDivergence` naming the first diverging step
    and stat when the report diverged; return the report otherwise."""
    if not report.get("diverged"):
        return report
    d = report["first_divergence"]
    where = d["stat"] + (f"[{d['layer']}]" if d.get("layer") else "")
    raise ParityDivergence(
        f"A/B loss parity diverged at step {d['step']} on {where}: "
        f"reference={d['reference']:.6g} candidate={d['candidate']:.6g} "
        f"(|diff|={d['abs_diff']:.3g}, tolerances "
        f"{report['tolerances']})", divergence=d)
