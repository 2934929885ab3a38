"""Front-door request router over N named ServingEngine instances.

Ports paddle_tpu/serving/router.py. ``Router({"a": eng_a, "b": eng_b})
.submit(...)`` fans requests across engines (engines may serve different
models via the ``models=`` labels) with three placement inputs:

- **health**: each engine's ``health()`` verdict — a draining or dead
  engine never receives new work; a degraded engine is skipped by
  affinity and only used when every candidate is degraded;
- **deadline/priority**: a request carrying ``deadline_ms`` routes to the
  least-loaded candidate (queue depth + active slots, tie-broken by the
  engine's measured per-step decode time from its ``stats()["breakdown"]``
  accumulator) instead of its affinity target;
- **session/prefix affinity**: requests sharing a ``session_id`` (or a
  router-registered prefix, or failing those their first
  ``affinity_tokens`` prompt tokens) hash to the SAME engine (zlib CRC-32
  of the key's repr, so the port places a request where the reference
  would), so that engine's shared-prefix KV cache and warm slots hit.

Failover: an engine whose ``step()`` raises is marked dead; its queued
AND in-flight requests are resubmitted to surviving candidates (a
re-decoded greedy request restarts from its prompt). ``drain(name)`` stops
new placements on that engine and re-routes its still-QUEUED requests
while in-flight work finishes in place. With no live engine left the
error names the flight recorder's dump bundle (FLAGS_blackbox).

Tracing: the router mints one trace_id per request and opens a ``route``
span; the engine's ``request`` root span joins that trace (``submit(...,
trace_id=, parent_span=)``), so one request's spans thread
router -> engine -> slot. Metrics: ``router_requests_total{engine}``,
``router_failover_total{reason}``, ``router_affinity_total{event}``. The
router is a flight-recorder dump provider of its placement table and
steps inside a ``router/step`` window.
"""
import time
import zlib

from .. import monitor as _monitor
from .. import trace as _trace
from ..inference.serving import QueueFullError, _as_ids
from ..monitor import blackbox_lazy as _blackbox  # import-free facade

__all__ = ["Router", "NoLiveEngineError"]


class NoLiveEngineError(RuntimeError):
    """No candidate engine is alive + admitting for the request."""


_ROUTER_REQ = _monitor.counter(
    "router_requests_total",
    "requests placed by the Router, by target engine",
    labelnames=("engine",))
_ROUTER_FAILOVER = _monitor.counter(
    "router_failover_total",
    "requests re-routed off an engine (engine_error = its step() raised "
    "and it was marked dead; drain = still-queued work moved off a "
    "draining engine)",
    labelnames=("reason",))
_ROUTER_AFFINITY = _monitor.counter(
    "router_affinity_total",
    "affinity-hash placements: hit = the key's engine was warm (seen "
    "before / prefix already registered there), miss = first placement "
    "or re-route",
    labelnames=("event",))


class _RouterReq:
    """Router-side record of one accepted request; survives re-routing
    (the engine-side Request is replaced on failover)."""

    __slots__ = ("rid", "ids", "kwargs", "model", "affinity_key",
                 "prefix_id", "engine", "erid", "trace_id", "resubmits",
                 "t0")

    def __init__(self, rid, ids, kwargs, model, affinity_key, prefix_id):
        self.rid = rid
        self.ids = ids
        self.kwargs = kwargs
        self.model = model
        self.affinity_key = affinity_key
        self.prefix_id = prefix_id
        self.engine = None
        self.erid = None
        self.trace_id = None
        self.resubmits = 0
        self.t0 = None   # first router-level submit (deadline anchor)


def _blackbox_router_table(router):
    """Router placement state for a dump bundle: which engines are
    alive/dead, what each one still owes, and what is parked."""
    owed = {}
    for (name, erid), rid in router._by_engine.items():
        owed.setdefault(name, []).append(rid)
    return {"alive": sorted(router._alive),
            "dead": sorted(set(router._engines) - router._alive),
            "outstanding": {n: sorted(rids) for n, rids in owed.items()},
            "parked": [r.rid for r in router._parked],
            "finished": len(router._results)}


class Router:
    def __init__(self, engines, models=None, affinity_tokens=8):
        """engines: ``{name: ServingEngine}`` (order = step order).
        models: optional ``{name: model_label}`` — ``submit(model=...)``
        only considers engines whose label matches (unlabelled engines
        serve any model). affinity_tokens: prompt-prefix length hashed
        for requests with no session_id/prefix."""
        if not engines:
            raise ValueError("Router needs at least one engine")
        self._engines = dict(engines)
        self._models = dict(models or {})
        self._affinity_tokens = int(affinity_tokens)
        self._alive = set(self._engines)
        self._reqs = {}          # rid -> _RouterReq
        self._by_engine = {}     # (engine_name, erid) -> rid
        self._parked = []        # rreqs awaiting capacity (failover hit
                                 # full bounded queues on live survivors)
        self._results = {}       # rid -> finished engine Request
        self._next_rid = 0
        self._prefixes = {}      # router pid -> ids
        self._prefix_sites = {}  # router pid -> {engine_name: engine pid}
        self._next_pid = 0
        self._affinity_seen = {}  # affinity key -> engine_name
        self._m = {"requests": {}, "failover": {}, "affinity_hit": 0,
                   "affinity_miss": 0}
        # one all-dead dump per outage: a front-end retry loop hammering
        # submit() against a dead router must not write a bundle per call
        self._no_live_dumped = False
        # blackbox dump bundles carry the router's placement state next
        # to each engine's own in-flight table (weakly held)
        _blackbox.register_provider("router", self, _blackbox_router_table)

    # -- placement ---------------------------------------------------------
    def _health(self, name):
        return self._engines[name].health()

    def _candidates(self, model):
        out = []
        for name in self._engines:
            if name not in self._alive:
                continue
            if model is not None and name in self._models \
                    and self._models[name] != model:
                continue
            if self._health(name)["state"] == "draining":
                continue
            out.append(name)
        if not out:
            # the all-dead path is the router's terminal wedge: leave a
            # dump bundle behind and name it in the error, so the
            # operator gets stacks + per-engine state, not just a message
            msg = (f"no live admitting engine for model={model!r} "
                   f"(alive: {sorted(self._alive)}, "
                   f"engines: {sorted(self._engines)})")
            if _blackbox.is_enabled() and not self._no_live_dumped:
                self._no_live_dumped = True
                path = _blackbox.dump(
                    "crash", site="router/no_live_engine",
                    extra={"model": repr(model),
                           "alive": sorted(self._alive),
                           "engines": sorted(self._engines)})
                if path:
                    msg += f"; blackbox dump bundle: {path}"
            raise NoLiveEngineError(msg)
        return out

    def _load_score(self, name):
        """Placement load estimate: outstanding work first, the engine's
        measured per-step decode wall time as the tie-break. The two
        components stay separate — multiplying them would make a warmed
        engine (known ms) incomparable with a cold one (no breakdown yet)
        and could route a deadline request INTO the deeper backlog."""
        h = self._health(name)
        load = h["queue_depth"] + h["active_slots"]
        # the engine's raw per-kind [count, wall_ms] accumulator — the
        # source stats()['breakdown'] is built from, without assembling
        # the full snapshot on the routing hot path
        step_ms = self._engines[name]._m["step_ms"]
        ms = 0.0
        for kind in ("decode_greedy", "decode_sample", "speculative"):
            row = step_ms.get(kind)
            if row and row[0]:
                ms = max(ms, row[1] / row[0])
        return (load, ms)

    def _least_loaded(self, candidates):
        return min(candidates, key=lambda n: self._load_score(n))

    def _place(self, model, affinity_key, deadline_ms):
        """Pick the target engine; returns (name, affinity_event)."""
        candidates = self._candidates(model)
        if deadline_ms is not None:
            # deadline-aware: the engine most likely to START the request
            # in time beats cache warmth
            return self._least_loaded(candidates), None
        ranked = sorted(candidates)
        key = (model, affinity_key)
        name = ranked[zlib.crc32(repr(key).encode()) % len(ranked)]
        if self._health(name)["state"] == "degraded":
            healthy = [n for n in candidates
                       if self._health(n)["state"] == "ok"]
            if healthy:   # degraded target only serves as a last resort
                name = self._least_loaded(healthy)
        # hit = the key's traffic actually LANDED here before (the seen
        # table is written by _submit_to on successful placement only —
        # a queue-full divert must not fake warmth on the hash target)
        event = "hit" if self._affinity_seen.get(key) == name else "miss"
        return name, event

    # -- API ---------------------------------------------------------------
    def register_prefix(self, prefix_ids):
        """Register a shared prefix ONCE with the router; returns a router
        prefix id for ``submit(prefix_id=...)``. The prefix's KV is
        materialized LAZILY per engine — affinity hashing sends every
        request sharing it to the same engine, so in steady state exactly
        one engine pays the prefill and every request hits its cache."""
        ids = _as_ids(prefix_ids)
        if len(ids) == 0:
            raise ValueError("empty prefix")
        pid = self._next_pid
        self._next_pid += 1
        self._prefixes[pid] = ids
        self._prefix_sites[pid] = {}
        return pid

    def _engine_prefix(self, name, pid):
        sites = self._prefix_sites[pid]
        if name not in sites:
            sites[name] = self._engines[name].register_prefix(
                self._prefixes[pid])
        return sites[name]

    def submit(self, prompt_ids, max_new_tokens=32, model=None,
               session_id=None, prefix_id=None, **kwargs):
        """Place one request; returns the ROUTER request id. ``kwargs``
        pass through to ``ServingEngine.submit`` (temperature, top_k,
        top_p, seed, deadline_ms, priority). ``prefix_id`` is a router id
        from :meth:`register_prefix`; ``session_id`` pins a conversation
        to one engine's warm cache."""
        ids = _as_ids(prompt_ids)
        if prefix_id is not None and prefix_id not in self._prefixes:
            raise ValueError(f"unknown router prefix_id {prefix_id}")
        if session_id is not None:
            affinity_key = ("session", session_id)
        elif prefix_id is not None:
            affinity_key = ("prefix", prefix_id)
        else:
            affinity_key = ("prompt",
                            tuple(ids[:self._affinity_tokens].tolist()))
        rid = self._next_rid
        self._next_rid += 1
        rreq = _RouterReq(rid, ids, dict(kwargs,
                                         max_new_tokens=max_new_tokens),
                          model, affinity_key, prefix_id)
        rreq.t0 = time.perf_counter()
        # register only AFTER a successful placement: a rejected submit
        # (validation error, every queue full -> QueueFullError) must not
        # leak a phantom record with engine=None
        self._dispatch(rreq, deadline_aware=True)
        self._reqs[rid] = rreq
        return rid

    def _dispatch(self, rreq, deadline_aware=True, exclude=()):
        """(Re)place one router request on an engine; on a full bounded
        queue the remaining candidates are tried by load. Raises
        QueueFullError when every LIVE candidate rejected (transient
        pressure — retryable), NoLiveEngineError when no live admitting
        candidate exists at all."""
        deadline_ms = rreq.kwargs.get("deadline_ms") if deadline_aware \
            else None
        name, event = self._place(rreq.model, rreq.affinity_key,
                                  deadline_ms)
        tried = set(exclude)
        while True:
            if name in tried:
                remaining = [n for n in self._candidates(rreq.model)
                             if n not in tried]
                if not remaining:
                    raise QueueFullError(
                        f"request {rreq.rid}: every live candidate "
                        "engine's bounded queue rejected the submission")
                name, event = self._least_loaded(remaining), None
            try:
                self._submit_to(rreq, name, event)
                return name
            except QueueFullError:
                tried.add(name)

    def _submit_to(self, rreq, name, affinity_event):
        eng = self._engines[name]
        route_sp, tid = None, None
        if _trace.is_enabled():
            tid = rreq.trace_id or _trace.new_trace_id()
            route_sp = _trace.start_span(
                "route", subsystem="router", trace_id=tid, rid=rreq.rid,
                engine=name, resubmits=rreq.resubmits)
        kwargs = dict(rreq.kwargs)
        ids = rreq.ids
        if rreq.prefix_id is not None:
            kwargs["prefix_id"] = self._engine_prefix(name, rreq.prefix_id)
        if kwargs.get("deadline_ms") is not None and rreq.t0 is not None \
                and rreq.resubmits:
            # a re-routed request keeps its ORIGINAL wall-clock budget:
            # hand the engine only what remains (a non-positive remainder
            # still submits with an epsilon budget — the engine expires
            # it through the standard deadline machinery)
            elapsed_ms = (time.perf_counter() - rreq.t0) * 1e3
            kwargs["deadline_ms"] = max(
                1e-3, rreq.kwargs["deadline_ms"] - elapsed_ms)
        try:
            erid = eng.submit(ids, trace_id=tid, parent_span=route_sp,
                              **kwargs)
        except BaseException:
            if route_sp is not None:
                route_sp.end(error=True)
            raise
        if route_sp is not None:
            route_sp.end()
        rreq.engine, rreq.erid, rreq.trace_id = name, erid, tid
        self._by_engine[(name, erid)] = rreq.rid
        if kwargs.get("seed") is None and \
                float(kwargs.get("temperature", 0.0) or 0.0) > 0:
            # pin the engine-resolved seed (defaults to the ENGINE-local
            # rid) so a failover re-decode continues the SAME sampled
            # stream instead of silently switching distributions
            rreq.kwargs["seed"] = eng.get_request(erid).seed
        self._m["requests"][name] = self._m["requests"].get(name, 0) + 1
        _ROUTER_REQ.labels(engine=name).inc()
        if affinity_event is not None:
            self._affinity_seen[(rreq.model, rreq.affinity_key)] = name
            self._m["affinity_%s" % affinity_event] += 1
            _ROUTER_AFFINITY.labels(event=affinity_event).inc()

    def get_request(self, rid):
        """The live engine-side Request for a router id (the CURRENT one
        after any failover), or the finished result."""
        if rid in self._results:
            return self._results[rid]
        rreq = self._reqs.get(rid)
        if rreq is None:
            raise KeyError(f"unknown router request id {rid}")
        return self._engines[rreq.engine].get_request(rreq.erid)

    def cancel(self, rid):
        """Cancel a router request wherever it currently lives — on an
        engine, or parked awaiting failover capacity."""
        if rid in self._results:
            return False
        rreq = self._reqs.get(rid)
        if rreq is None:
            raise KeyError(f"unknown router request id {rid}")
        if rreq in self._parked:
            # parked = waiting for a survivor slot; its last engine-side
            # copy (on the dead/draining engine) supplies the terminal
            # "cancelled" record. Removing it from _parked is the real
            # cancellation — it must never be re-dispatched.
            self._parked.remove(rreq)
            eng = self._engines[rreq.engine]
            try:
                eng.cancel(rreq.erid)
            except Exception:
                pass
            self._results[rid] = eng.get_request(rreq.erid)
            return True
        out = self._engines[rreq.engine].cancel(rreq.erid)
        # the engine's terminal "cancelled" record becomes the result
        self._collect(rreq.engine,
                      self._engines[rreq.engine].get_request(rreq.erid))
        return out

    # -- stepping / failover ----------------------------------------------
    def _collect(self, name, ereq):
        rid = self._by_engine.pop((name, ereq.rid), None)
        if rid is not None:
            self._results[rid] = ereq
        return rid

    def _unfinished_on(self, name):
        return [self._reqs[rid] for (n, erid), rid
                in list(self._by_engine.items()) if n == name]

    def _fail_engine(self, name, exc):
        """Mark an engine dead and re-route EVERYTHING it still owed.
        Greedy requests restart from the prompt on the survivor and
        reproduce their exact tokens (deterministic decode). Survivors
        whose bounded queues are momentarily full are TRANSIENT: those
        requests park and retry at the next step(). With NO surviving
        candidate at all the stranded requests are terminated on the
        dead engine (reason="cancelled", visible to get_request pollers)
        and the NoLiveEngineError still propagates — loud, but
        consistent."""
        self._alive.discard(name)
        eng = self._engines[name]
        stranded = self._unfinished_on(name)
        for idx, rreq in enumerate(stranded):
            del self._by_engine[(name, rreq.erid)]
            # the dead engine's host state is still readable: a request
            # already terminal there (shed/cancelled outside step, before
            # the sweep collected it) must NOT be resurrected on a
            # survivor — its outcome stands
            ereq = eng._finished.get(rreq.erid)
            if ereq is not None:
                self._results[rreq.rid] = ereq
                continue
            _ROUTER_FAILOVER.labels(reason="engine_error").inc()
            self._m["failover"]["engine_error"] = \
                self._m["failover"].get("engine_error", 0) + 1
            rreq.resubmits += 1
            try:
                self._dispatch(rreq, deadline_aware=True, exclude={name})
            except QueueFullError:
                # live survivors exist but are at their bounds right now
                # — transient pressure, not router death: retry at the
                # next step() once their backlogs drain
                self._parked.append(rreq)
            except NoLiveEngineError:
                # nowhere left to go: terminate the stranded requests on
                # the dead engine (reason="cancelled" via its own
                # machinery) so pollers see a terminal state, then let
                # the error propagate
                for rr in stranded[idx:]:
                    self._by_engine.pop((name, rr.erid), None)
                    try:
                        er = eng.get_request(rr.erid)
                        if not er.finished:
                            eng.cancel(rr.erid)
                    except Exception:
                        er = None
                    if er is not None:
                        self._results[rr.rid] = er
                raise

    def drain(self, name):
        """Gracefully drain one engine: it stops receiving placements
        (health -> "draining"), its still-QUEUED requests re-route to
        live candidates, and its in-flight slots finish in place."""
        eng = self._engines[name]
        eng.drain()
        for rreq in self._unfinished_on(name):
            ereq = eng.get_request(rreq.erid)
            if ereq.finished or ereq.admit_time is not None:
                continue   # in-flight (or already done): finish here
            # place on a survivor FIRST, cancel the old copy after — if
            # every candidate rejects (none live, or bounded queues all
            # full) the request stays QUEUED on the draining engine,
            # which still runs queued work to completion
            old_key = (name, rreq.erid)
            del self._by_engine[old_key]
            try:
                rreq.resubmits += 1
                self._dispatch(rreq, deadline_aware=True, exclude={name})
            except (NoLiveEngineError, QueueFullError):
                rreq.resubmits -= 1
                rreq.engine, rreq.erid = old_key
                self._by_engine[old_key] = rreq.rid
                continue
            eng.cancel(old_key[1])
            _ROUTER_FAILOVER.labels(reason="drain").inc()
            self._m["failover"]["drain"] = \
                self._m["failover"].get("drain", 0) + 1

    def step(self):
        """One step across every live engine; an engine that raises is
        failed over. Returns the router requests finished this step as
        {rid: Request}."""
        with _blackbox.progress("router/step"):
            return self._step_inner()

    def _step_inner(self):
        done = {}
        if self._parked:
            # capacity may have freed since the failover that parked
            # these; still-full queues keep them parked (no metric
            # re-count — their failover was recorded once). Bookkeeping
            # is exception-safe: a request leaves _parked ONLY once
            # placed, so a NoLiveEngineError mid-loop cannot leave an
            # already-placed request parked for a duplicate dispatch.
            retry, self._parked = self._parked, []
            for i, rreq in enumerate(retry):
                try:
                    self._dispatch(rreq, deadline_aware=True)
                except QueueFullError:
                    self._parked.append(rreq)
                except NoLiveEngineError:
                    self._parked.extend(retry[i:])
                    raise
        for name in list(self._engines):
            if name not in self._alive:
                continue
            eng = self._engines[name]
            if not eng.has_work():
                continue
            try:
                finished = eng.step()
            except Exception as exc:
                self._fail_engine(name, exc)
                continue
            for ereq in finished:
                rid = self._collect(name, ereq)
                if rid is not None:
                    done[rid] = ereq
        # requests can also finish OUTSIDE an engine's step() — shed by a
        # bounded queue at submit time, or cancelled directly on the
        # engine — sweep outstanding mappings so no terminal request is
        # ever stranded un-collected. O(1) per mapping: finished requests
        # always land in the engine's _finished table
        for (name, erid), rid in list(self._by_engine.items()):
            if name not in self._alive:
                continue
            ereq = self._engines[name]._finished.get(erid)
            if ereq is not None:
                self._collect(name, ereq)
                done[rid] = ereq
        return done

    def has_work(self):
        return bool(self._parked) \
            or any(self._engines[n].has_work() for n in self._alive)

    def run_until_complete(self, max_steps=100_000):
        """Drain every engine; returns {router rid: finished Request}."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                msg = (f"router did not converge within {max_steps} "
                       "steps; outstanding: "
                       f"{sorted(self._by_engine.values())}")
                if _blackbox.is_enabled():
                    path = _blackbox.dump(
                        "stall", site="router/step",
                        extra={"trigger": "run_until_complete",
                               "max_steps": max_steps})
                    if path:
                        msg += f"; blackbox dump bundle: {path}"
                raise RuntimeError(msg)
        return dict(self._results)

    # -- observability -----------------------------------------------------
    def health(self):
        """Per-engine health verdicts; a dead engine reports
        {"state": "dead"}."""
        out = {}
        for name, eng in self._engines.items():
            out[name] = eng.health() if name in self._alive \
                else {"state": "dead"}
        return out

    def stats(self):
        """Router placement/failover/affinity accounting plus each
        engine's own stats() snapshot."""
        aff = self._m["affinity_hit"] + self._m["affinity_miss"]
        return {
            "engines": {n: self._engines[n].stats() for n in self._engines
                        if n in self._alive},
            "router": {
                "requests": dict(self._m["requests"]),
                "failover": dict(self._m["failover"]),
                "affinity": {
                    "hit": self._m["affinity_hit"],
                    "miss": self._m["affinity_miss"],
                    "hit_rate": (self._m["affinity_hit"] / aff
                                 if aff else None)},
                "alive": sorted(self._alive),
                "dead": sorted(set(self._engines) - self._alive),
                "outstanding": len(self._by_engine),
                "parked": len(self._parked),
            },
            "health": self.health(),
        }
