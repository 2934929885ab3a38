"""Registered fault-injection framework.

Ports paddle_tpu/testing/failpoints.py. Named *failpoint sites* in the
runtime's recovery-critical paths let chaos tests make rare faults happen
on demand::

    from paddle_tpu_torch.testing import failpoints

    with failpoints.scoped("ckpt/write=error:1"):
        framework.io.save(state, path)    # raises FailpointError once

or process-wide via the flag (parsed at import, re-appliable after
``set_flags`` with :func:`arm_from_flag`)::

    FLAGS_failpoints="ckpt/write=error:1,serving/step=delay:5" python train.py

Spec syntax: ``site=action[,site=action...]`` with actions

- ``error`` / ``error:N`` — raise :class:`FailpointError` at the site (N
  times, then the site auto-disarms; no N = every hit);
- ``delay:MS`` — sleep MS milliseconds per hit (latency injection);
- ``kill`` — SIGKILL the process at the site;
- ``scale:F`` / ``scale:nan`` — at a :func:`transform` site, multiply every
  FLOAT tensor or array by F (integer ones pass untouched).

Disabled is one boolean check. Sites are REGISTERED (the whole reference
``SITES`` table below); arming a typo'd name raises with the known list.
The port fires ``ckpt/write``, ``ckpt/read``, ``ckpt/commit``,
``trainer/step``, ``trainer/batch``, ``serving/step``, ``serving/slot`` and
``serving/adapter``. The others (``exe/compile``, ``collective/call``,
``federated/round``, ``stage/edge``, ``stage/run``, ``elastic/resume``)
belong to modules not ported yet: they can be armed but never fire.
"""
import contextlib
import os
import signal
import threading
import time

from .. import flags as _flags
from .. import monitor as _monitor

__all__ = [
    "SITES", "FailpointError", "failpoint", "transform", "arm", "disarm",
    "reset", "armed", "hits", "is_enabled", "scoped", "parse",
    "arm_from_flag",
]

_flags.define_flag(
    "failpoints", "",
    "fault-injection spec 'site=action[,site=action...]' with actions "
    "error[:N] | delay:MS | kill | scale:F; empty = every failpoint site "
    "is a single boolean check (see testing/failpoints.py SITES)")

#: every plantable site, registered centrally so arming a typo fails fast.
SITES = {
    "ckpt/write": "framework.io.save — payload written to the tmp file, "
                  "before the integrity footer + atomic commit",
    "ckpt/read": "framework.io.load — before the checkpoint file is read",
    "ckpt/commit": "CheckpointSaver.save_checkpoint — before the checkpoint "
                   "dir renames into place",
    "exe/compile": "static.Executor._compile — before building/compiling "
                   "the program",
    "collective/call": "distributed.collective — every collective API call",
    "serving/step": "ServingEngine.step — top of the engine step loop",
    "serving/slot": "ServingEngine per-slot host work — isolated: an "
                    "injected error finishes only that slot's request "
                    "(reason='error'), batch-mates continue",
    "trainer/step": "SpmdTrainer.train_step — before the step "
                    "dispatches",
    "trainer/batch": "SpmdTrainer.train_step — the batch arrays on their "
                     "way into the step; a scale:F action "
                     "multiplies every FLOAT array by F (scale:nan "
                     "poisons them) so chaos tests can inject a gradient "
                     "spike or a non-finite step with real data flow "
                     "(integer arrays — token ids — pass untouched)",
    "federated/round": "federated.FederatedAverager — each client's local "
                       "update inside a round; an injected error drops "
                       "that client (federated_client_dropped_total) and "
                       "the round completes with the surviving cohort",
    "stage/edge": "distributed.stage.StageEdge.put — inside the edge's "
                  "blackbox progress window, before the payload is "
                  "validated/encoded onto the queue; a delay here reads "
                  "as a stalled stage to the stall sentinel, an error "
                  "leaves the payload un-enqueued (producer retries)",
    "serving/adapter": "ServingEngine.load_adapter/evict_adapter — before "
                       "the adapter registry or the device factors "
                       "mutate; an injected error leaves both exactly as "
                       "they were (in-flight sessions keep decoding)",
    "stage/run": "distributed.stage.StageProgram.__call__ — before the "
                 "compiled stage dispatches; an injected error reads as "
                 "one stage's slice dying mid-schedule, the trigger for "
                 "MpmdPipelineRunner.replace_stage elasticity "
                 "(tools/chaos_check.py stage_replace)",
    "elastic/resume": "distributed.elastic.ElasticSupervisor — before "
                      "each recovery attempt rebuilds a trainer and "
                      "restores the latest checkpoint; an error here "
                      "consumes one retry from the backoff budget "
                      "(retry-exhaustion tests)",
}


class FailpointError(RuntimeError):
    """The injected fault. Distinct from organic errors so recovery paths
    can be asserted to have handled *this* failure."""


class _Action:
    __slots__ = ("kind", "arg", "remaining")

    def __init__(self, kind, arg=None, remaining=None):
        self.kind = kind            # "error" | "delay" | "kill"
        self.arg = arg              # delay ms
        self.remaining = remaining  # None = unlimited

    def spec(self):
        if self.kind == "delay":
            return f"delay:{self.arg:g}"
        if self.kind == "scale":
            return f"scale:{self.arg:g}"
        if self.kind == "error" and self.remaining is not None:
            return f"error:{self.remaining}"
        return self.kind


_LOCK = threading.RLock()
_ENABLED = False    # the ONE read on the disabled fast path
_ARMED = {}         # site -> _Action
_HITS = {}          # site -> fire count since last reset()
_TRIG = None        # lazy failpoint_trigger_total counter


def _parse_action(site, text):
    kind, _, arg = text.partition(":")
    kind = kind.strip()
    if kind == "error":
        n = None
        if arg:
            n = int(arg)
            if n < 1:
                raise ValueError(f"failpoint {site}: error count must be "
                                 f">= 1, got {n}")
        return _Action("error", remaining=n)
    if kind == "delay":
        if not arg:
            raise ValueError(f"failpoint {site}: delay needs milliseconds "
                             "(delay:MS)")
        ms = float(arg)
        if ms < 0:
            raise ValueError(f"failpoint {site}: delay must be >= 0 ms")
        return _Action("delay", arg=ms)
    if kind == "kill":
        return _Action("kill")
    if kind == "scale":
        if not arg:
            raise ValueError(f"failpoint {site}: scale needs a factor "
                             "(scale:F — float('nan') poisons)")
        return _Action("scale", arg=float(arg))   # float() accepts 'nan'
    raise ValueError(f"failpoint {site}: unknown action {text!r} "
                     "(expected error[:N] | delay:MS | scale:F | kill)")


def parse(spec):
    """Parse a ``site=action,site=action`` spec string into
    {site: _Action}; validates site names against :data:`SITES`."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site, sep, action = part.partition("=")
        site = site.strip()
        if not sep or not action.strip():
            raise ValueError(f"failpoint spec {part!r}: expected "
                             "site=action")
        if site not in SITES:
            raise ValueError(f"unknown failpoint site {site!r}; known "
                             f"sites: {', '.join(sorted(SITES))}")
        out[site] = _parse_action(site, action.strip())
    return out


def _refresh_enabled():
    global _ENABLED
    _ENABLED = bool(_ARMED)


def arm(site, action):
    """Arm one site; `action` is an action spec string (``error``,
    ``error:2``, ``delay:10``, ``kill``)."""
    if site not in SITES:
        raise ValueError(f"unknown failpoint site {site!r}; known sites: "
                         f"{', '.join(sorted(SITES))}")
    with _LOCK:
        _ARMED[site] = _parse_action(site, action)
        _refresh_enabled()


def disarm(site):
    with _LOCK:
        _ARMED.pop(site, None)
        _refresh_enabled()


def reset():
    """Disarm every site and zero the hit counters."""
    with _LOCK:
        _ARMED.clear()
        _HITS.clear()
        _refresh_enabled()


def armed():
    """{site: action-spec-string} for currently armed sites."""
    with _LOCK:
        return {s: a.spec() for s, a in _ARMED.items()}


def hits(site):
    """How many times `site` has fired since the last reset()."""
    with _LOCK:
        return _HITS.get(site, 0)


def is_enabled():
    return _ENABLED


def arm_from_flag():
    """(Re-)apply the FLAGS_failpoints spec — call after paddle.set_flags
    changes the flag at runtime (import-time env values apply
    automatically)."""
    spec = _flags.get_flag("failpoints", "") or ""
    actions = parse(spec)
    with _LOCK:
        _ARMED.clear()
        _ARMED.update(actions)
        _refresh_enabled()


@contextlib.contextmanager
def scoped(spec):
    """Arm a spec for the with-block, restoring the previous arming (and
    enabled state) on exit — the test-side entry point::

        with failpoints.scoped("serving/slot=error:1"):
            engine.step()
    """
    actions = parse(spec)
    with _LOCK:
        saved = dict(_ARMED)
        _ARMED.update(actions)
        _refresh_enabled()
    try:
        yield
    finally:
        with _LOCK:
            _ARMED.clear()
            _ARMED.update(saved)
            _refresh_enabled()


def _note_fire(site, kind):
    global _TRIG
    if not _monitor.is_enabled():
        return
    if _TRIG is None:
        _TRIG = _monitor.counter(
            "failpoint_trigger_total",
            "armed failpoint fires by site and action (always zero in "
            "production: the series only exists once a fault is injected)",
            labelnames=("site", "action"))
    _TRIG.labels(site=site, action=kind).inc()


def failpoint(site):
    """The planted call. Disabled (nothing armed anywhere): one boolean
    check and return."""
    if not _ENABLED:
        return
    _fire(site)


def transform(site, value):
    """Value-transforming failpoint: plant where data flows through a
    site. Disabled (nothing armed anywhere): one boolean check, `value`
    returned untouched. A ``scale:F`` action multiplies every FLOAT
    tensor or array in `value` (a single one, or a list/tuple of them) by
    F, in its own dtype —
    ``scale:nan`` poisons them into a non-finite step — while integer
    arrays pass through unchanged; any other armed action behaves
    exactly as :func:`failpoint` (error raises, delay sleeps) before
    `value` is returned."""
    if not _ENABLED:
        return value
    with _LOCK:
        act = _ARMED.get(site)
        scale = act is not None and act.kind == "scale"
        if scale:
            _HITS[site] = _HITS.get(site, 0) + 1
            factor = act.arg
    if not scale:
        _fire(site)
        return value
    _note_fire(site, "scale")
    import numpy as _np
    import torch as _torch

    def _scaled(a):
        if isinstance(a, _torch.Tensor):
            if not a.is_floating_point():
                return a
            return a * _torch.tensor(factor, dtype=a.dtype, device=a.device)
        dt = getattr(a, "dtype", None)
        if dt is None or not _np.issubdtype(_np.dtype(dt), _np.floating):
            return a
        return a * _np.asarray(factor).astype(dt)

    if isinstance(value, (list, tuple)):
        return type(value)(_scaled(a) for a in value)
    return _scaled(value)


def _fire(site):
    with _LOCK:
        act = _ARMED.get(site)
        if act is None or act.kind == "scale":
            # scale actions only act through transform(); a plain
            # failpoint() at the same site must not consume or crash
            return
        if act.remaining is not None and act.remaining <= 0:
            # an exhausted error:N re-armed by scoped()'s restore (the
            # _Action is shared, its budget already spent) — disarm, don't
            # fire an N+1th time
            del _ARMED[site]
            _refresh_enabled()
            return
        _HITS[site] = _HITS.get(site, 0) + 1
        if act.remaining is not None:
            act.remaining -= 1
            if act.remaining <= 0:
                del _ARMED[site]
                _refresh_enabled()
        kind = act.kind
        delay_ms = act.arg
    _note_fire(site, kind)
    if kind == "error":
        raise FailpointError(f"failpoint {site!r}: injected error")
    if kind == "delay":
        time.sleep(delay_ms / 1e3)
        return
    if kind == "kill":   # crash-mid-operation: no cleanup handlers run
        os.kill(os.getpid(), signal.SIGKILL)


# import-time arming from the environment (FLAGS_failpoints=...)
if _flags.get_flag("failpoints", ""):
    arm_from_flag()
