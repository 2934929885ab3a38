"""Prefill/decode disaggregation: prefill workers feed decode engines a
prefilled KV row each.

Ports paddle_tpu/serving/disagg.py: ``HANDOFF_SCHEMA``, ``PrefillWorker``
and ``DisaggregatedPool``, and the part of
paddle_tpu/analysis/handoff_schema.py that checks a payload at runtime
(``HandoffMismatch``, ``validate``).

- ``PrefillWorker`` runs only the whole-prompt prefill of a model's
  ``DecodeModel`` adapter and turns a prompt into ``((kc1, vc1),
  logits)``: one single-row KV cache in the adapter's layout and the
  prompt's last-position logits [V] (fp32);
- ``DisaggregatedPool`` hands each row to the decode engine with the most
  free slots through ``ServingEngine.admit_prefilled``, which checks it
  against ``HANDOFF_SCHEMA`` and picks the first token through the pick
  its own admission uses, so the pool's completions equal one engine's on
  the same prompts, bit for bit.

Workers and engines share adapter, config, dtype and cache_dtype: the pool
builds both sides from one model. Prefill runs at the prompt's own length
(the reference pads to ``prompt_buckets`` and validates them; so does the
port, without the padding), on the model's device. As in the reference,
each hand-off counts ``kv_handoff_total{event}`` (ok, error) and
``kv_handoff_bytes_total`` (monitor) and, with FLAGS_trace, leaves a
``kv_handoff`` span whose trace the engine's request joins. With the
flight recorder on (FLAGS_blackbox) each prefill runs in a
``disagg/prefill`` window and each hand-off sweep in a ``disagg/handoff``
window that beats once a hand-off, and a pool that does not converge
writes a dump bundle its error names. Not ported:
the reference's AOT cache and its MPMD stage edge (``FLAGS_mpmd``,
``compress=``), which raise ``NotImplementedError``.
"""
import time

import numpy as np
import torch

from .. import flags as _flags
from .. import monitor as _monitor
from .. import trace as _trace
from ..monitor import blackbox_lazy as _blackbox  # import-free facade
from . import decode_model as _dm_registry

__all__ = ["PrefillWorker", "DisaggregatedPool", "HANDOFF_SCHEMA",
           "HandoffMismatch", "validate"]

#: The prefill -> decode KV transfer edge. ``ServingEngine.admit_prefilled``
#: checks every incoming row against it. Symbolic dims bind to the
#: consuming engine's config (L = num_layers, KVh = compact kv heads, T =
#: max_seq_len, hd = head dim, V = vocab); ``$cache`` binds to the engine's
#: cache dtype; ``quantizable`` sides accept the int8 / fp8 (values,
#: scales) pair.
HANDOFF_SCHEMA = {
    "edge": "disagg_kv",
    "producer": "paddle_tpu_torch/serving/disagg.py::PrefillWorker.prefill",
    "consumer": ("paddle_tpu_torch/inference/serving.py::"
                 "ServingEngine.admit_prefilled"),
    "runtime_checked": True,
    "doc": "one prefilled single-row KV cache pair + the prompt's "
           "last-position vocab logits, in the DecodeModel adapter's "
           "documented cache layout",
    "payload": {
        "kc": {"shape": ("L", 1, "KVh", "T", "hd"), "dtype": "$cache",
               "layout": "[L, B, KVh, T, hd]", "quantizable": True},
        "vc": {"shape": ("L", 1, "KVh", "T", "hd"), "dtype": "$cache",
               "layout": "[L, B, KVh, T, hd]", "quantizable": True},
        "logits": {"shape": ("V",), "dtype": "float32"},
    },
}


class HandoffMismatch(ValueError):
    """A payload that does not match its edge's schema; the message names
    the edge, the leaf and the field that differs."""


_KV_BYTES = _monitor.counter(
    "kv_handoff_bytes_total",
    "bytes of prefilled KV rows handed from prefill workers to decode "
    "engines (disaggregated serving)")
_KV_HANDOFFS = _monitor.counter(
    "kv_handoff_total",
    "prefill->decode handoffs, by outcome",
    labelnames=("event",))


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _check_shape(edge, leaf, declared, actual, binds):
    if len(declared) != len(actual):
        raise HandoffMismatch(
            f"[{edge}] {leaf}: rank {len(actual)} != declared rank "
            f"{len(declared)} ({tuple(declared)} vs {tuple(actual)})")
    for i, (d, a) in enumerate(zip(declared, actual)):
        if isinstance(d, int):
            if int(a) != d:
                raise HandoffMismatch(
                    f"[{edge}] {leaf}: dim[{i}] is {a}, declared {d}")
        else:
            want = binds.setdefault(str(d), int(a))
            if int(a) != want:
                raise HandoffMismatch(
                    f"[{edge}] {leaf}: dim[{i}] ({d}) is {a}, bound to "
                    f"{want}")


def _check_dtype(edge, leaf, declared, actual, dtypes):
    want = declared
    if want.startswith("$"):
        want = (dtypes or {}).get(want[1:])
        if want is None:
            return   # an unbound dtype symbol: structural check only
    if _dtype_name(actual) != _dtype_name(want):
        raise HandoffMismatch(
            f"[{edge}] {leaf}: dtype {_dtype_name(actual)}, declared "
            f"{_dtype_name(want)}")


def validate(schema, values, dims=None, dtypes=None):
    """Check a payload ({leaf: tensor, or a (values, scales) pair for a
    quantizable leaf}) against its schema. ``dims`` binds symbolic dims
    (unbound ones bind on first use and must then agree across leaves);
    ``dtypes`` binds ``$name`` dtypes. Raises :class:`HandoffMismatch`;
    returns the final bindings."""
    edge = schema.get("edge", "?")
    binds = dict(dims or {})
    for leaf, spec in schema["payload"].items():
        if leaf not in values:
            raise HandoffMismatch(f"[{edge}] payload is missing leaf "
                                  f"'{leaf}'")
        node = values[leaf]
        if spec.get("quantizable") and isinstance(node, tuple):
            if len(node) != 2:
                raise HandoffMismatch(
                    f"[{edge}] {leaf}: quantized side must be a "
                    f"(values, scales) pair, got a {len(node)}-tuple")
            vals, scales = node
            _check_shape(edge, f"{leaf}.values", spec["shape"], vals.shape,
                         binds)
            _check_dtype(edge, f"{leaf}.values", spec["dtype"], vals.dtype,
                         dtypes)
            _check_shape(edge, f"{leaf}.scales",
                         tuple(spec["shape"][:-1]) + (1,), scales.shape,
                         binds)
            _check_dtype(edge, f"{leaf}.scales", "float32", scales.dtype,
                         dtypes)
            continue
        if isinstance(node, tuple):
            raise HandoffMismatch(
                f"[{edge}] {leaf}: got a tuple where a plain tensor is "
                "declared (quantized row handed to a dense-cache engine?)")
        shape = getattr(node, "shape", None)
        if shape is None:
            raise HandoffMismatch(
                f"[{edge}] {leaf}: expected a tensor, got "
                f"{type(node).__name__}")
        _check_shape(edge, leaf, spec["shape"], tuple(shape), binds)
        _check_dtype(edge, leaf, spec["dtype"], node.dtype, dtypes)
    return binds


def _as_ids(ids):
    if torch.is_tensor(ids):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, np.int32).ravel()


class PrefillWorker:
    """The prefill half of a disaggregated pair: the model's params and
    one program, the whole-prompt prefill, built through the DecodeModel
    adapter as ``ServingEngine``'s, so the row it produces is the row the
    engine would have produced itself."""

    def __init__(self, model, dtype=None, cache_dtype=None,
                 prompt_buckets=(32, 64, 128, 256, 512, 1024),
                 decode_model=None):
        dm = _dm_registry.resolve(model, decode_model)
        self._dm = dm
        cfg = model.cfg
        dm.check_config(cfg)
        self.cfg = cfg
        self.T = cfg.max_seq_len
        if not any(b <= self.T for b in prompt_buckets):
            raise ValueError("no prompt bucket fits max_seq_len")
        params, aux = dm.extract_params(model, "the model")
        self._compute_dtype = dm.compute_dtype(dtype)
        self._params = _dm_registry.cast_params(params, self._compute_dtype)
        self._dev = next(iter(self._params.values())).device
        self._fwd, self._logits_of, self._cache_init = dm.decode_fns(
            cfg, aux, cache_dtype=cache_dtype)
        self._cache_dt = self._compute_dtype or torch.float32
        self._m = {"prefills": 0, "prefill_ms": 0.0}

    def prefill(self, prompt_ids):
        """Prefill one prompt; returns ``((kc1, vc1), logits)``, the unit
        ``ServingEngine.admit_prefilled`` takes."""
        ids = _as_ids(prompt_ids)
        if len(ids) == 0:
            raise ValueError("empty prompt")
        if len(ids) + 1 > self.T:
            raise ValueError(
                f"prompt ({len(ids)}) too long for max_seq_len {self.T}")
        t0 = time.perf_counter()
        with _blackbox.progress("disagg/prefill"), torch.no_grad():
            kc1, vc1 = self._cache_init(1, self.T, self._cache_dt, self._dev)
            toks = torch.as_tensor(ids.astype(np.int64)[None],
                                   device=self._dev)
            x_last = self._fwd(self._params, toks, 0, kc1, vc1)[:, -1]
            logits = self._logits_of(self._params, x_last).float()[0]
        self._m["prefills"] += 1
        self._m["prefill_ms"] += (time.perf_counter() - t0) * 1e3
        return (kc1, vc1), logits

    def stats(self):
        return dict(self._m)


class DisaggregatedPool:
    """N prefill workers and M decode engines behind one submit() /
    step() surface with the single engine's semantics (and its outputs,
    bit for bit, on the same prompts)."""

    def __init__(self, model, prefill_workers=1, decode_engines=2,
                 max_batch=4, dtype=None, cache_dtype=None,
                 eos_token_id=None,
                 prompt_buckets=(32, 64, 128, 256, 512, 1024),
                 max_queue=None, decode_model=None, compress=None):
        from ..inference.serving import ServingEngine

        if int(prefill_workers) < 1 or int(decode_engines) < 1:
            raise ValueError("the pool needs >= 1 prefill worker and "
                             ">= 1 decode engine")
        if compress is not None or _flags.get_flag("mpmd", False):
            raise NotImplementedError(
                "the MPMD stage edge of the prefill -> decode hand-off "
                "(FLAGS_mpmd, compress=; distributed/stage.py) is not "
                "ported yet")
        shared = dict(dtype=dtype, cache_dtype=cache_dtype,
                      prompt_buckets=prompt_buckets,
                      decode_model=decode_model)
        self.workers = [PrefillWorker(model, **shared)
                        for _ in range(int(prefill_workers))]
        self.engines = {
            f"decode{i}": ServingEngine(model, max_batch=max_batch,
                                        eos_token_id=eos_token_id,
                                        max_queue=max_queue, **shared)
            for i in range(int(decode_engines))}
        self.T = model.cfg.max_seq_len
        self._pending = []       # (rid, ids, kwargs, t0) awaiting prefill
        self._placed = {}        # rid -> (engine_name, erid)
        self._by_erid = {}       # (engine_name, erid) -> rid, live only
        self._results = {}       # rid -> finished Request
        self._next_rid = 0
        self._next_worker = 0
        self._m = {"submitted": 0, "handoffs": 0, "handoff_bytes": 0,
                   "per_engine": {}}

    def submit(self, prompt_ids, max_new_tokens=32, **kwargs):
        """Queue one prompt; returns the pool request id. kwargs pass
        through to ``ServingEngine.admit_prefilled`` (temperature, top_k,
        top_p, seed, deadline_ms, priority)."""
        ids = _as_ids(prompt_ids)
        if len(ids) == 0:
            raise ValueError("empty prompt")
        if len(ids) + 1 > self.T:
            raise ValueError(
                f"prompt ({len(ids)}) too long for max_seq_len {self.T}")
        # fail fast with the engine's own validation: a bad argument found
        # only at hand-off would re-raise from every step()
        next(iter(self.engines.values()))._validate_decode_args(
            ids, max_new_tokens, kwargs.get("temperature", 0.0),
            kwargs.get("deadline_ms"), kwargs.get("top_k"),
            kwargs.get("top_p"), kwargs.get("seed"))
        rid = self._next_rid
        self._next_rid += 1
        # t0 anchors deadline_ms at the pool's submit: waiting for prefill
        # counts against the budget, as in the single engine
        self._pending.append((rid, ids,
                              dict(kwargs, max_new_tokens=max_new_tokens),
                              time.perf_counter()))
        self._m["submitted"] += 1
        return rid

    def _free_slots(self, name):
        """Admission room on a decode engine: free slots less its hand-off
        backlog, capped by its bounded queue's headroom."""
        eng = self.engines[name]
        h = eng.health()
        free = eng.B - h["active_slots"] - len(eng._handoff)
        if eng._max_queue is not None:
            free = min(free, eng._max_queue - len(eng._queue)
                       - len(eng._handoff))
        return free

    def _target_engine(self):
        """The decode engine with the most free slots (ties by name)."""
        return max(sorted(self.engines), key=lambda n: (self._free_slots(n),))

    def _advance_prefill(self):
        """Prefill pending prompts (round-robin over the workers) while a
        decode engine has room, handing each row off."""
        if not self._pending:
            return
        # window beacon: the site is watched only while hand-offs are in
        # flight (a beat each hand-off keeps the counter advancing)
        with _blackbox.progress("disagg/handoff"):
            self._advance_prefill_inner()

    def _advance_prefill_inner(self):
        from ..inference.serving import QueueFullError

        while self._pending:
            _blackbox.beacon("disagg/handoff")
            name = self._target_engine()
            if self._free_slots(name) <= 0:
                return   # the decode tier is full: backpressure
            rid, ids, kwargs, t0 = self._pending.pop(0)
            eng_kwargs = kwargs
            if kwargs.get("deadline_ms") is not None:
                # the engine gets the REMAINING budget (an exhausted one an
                # epsilon: the engine expires it with reason "deadline")
                elapsed_ms = (time.perf_counter() - t0) * 1e3
                eng_kwargs = dict(kwargs, deadline_ms=max(
                    1e-3, kwargs["deadline_ms"] - elapsed_ms))
            worker = self.workers[self._next_worker % len(self.workers)]
            self._next_worker += 1
            eng = self.engines[name]
            tid = _trace.new_trace_id() if _trace.is_enabled() else None
            sp = None if tid is None else _trace.start_span(
                "kv_handoff", subsystem="serving", trace_id=tid,
                rid=rid, engine=name, prompt_tokens=int(len(ids)))
            try:
                kv_row, logits = worker.prefill(ids)
                nbytes = _dm_registry.cache_row_bytes(kv_row)
                erid = eng.admit_prefilled(ids, kv_row, logits,
                                           trace_id=tid, parent_span=sp,
                                           **eng_kwargs)
            except BaseException as exc:
                # the popped request must not vanish with a failed
                # hand-off: back at the head
                self._pending.insert(0, (rid, ids, kwargs, t0))
                if sp is not None:
                    sp.end(error=True)
                if isinstance(exc, QueueFullError):
                    return   # a bounded engine at capacity: retry later
                _KV_HANDOFFS.labels(event="error").inc()
                raise
            if sp is not None:
                sp.end(bytes=nbytes)
            _KV_BYTES.inc(nbytes)
            _KV_HANDOFFS.labels(event="ok").inc()
            self._m["handoffs"] += 1
            self._m["handoff_bytes"] += nbytes
            self._m["per_engine"][name] = \
                self._m["per_engine"].get(name, 0) + 1
            self._placed[rid] = (name, erid)
            self._by_erid[(name, erid)] = rid

    def step(self):
        """Advance prefill hand-offs, then one decode step per engine.
        Returns the pool requests finished in this step as {rid:
        Request}."""
        self._advance_prefill()
        done = {}
        for name, eng in self.engines.items():
            if not eng.has_work():
                continue
            for ereq in eng.step():
                rid = self._by_erid.pop((name, ereq.rid), None)
                if rid is not None:
                    self._results[rid] = ereq
                    done[rid] = ereq
        return done

    def get_request(self, rid):
        if rid in self._results:
            return self._results[rid]
        if rid in self._placed:
            name, erid = self._placed[rid]
            return self.engines[name].get_request(erid)
        for p_rid, _, _, _ in self._pending:
            if p_rid == rid:
                raise KeyError(
                    f"request {rid} is still awaiting prefill (no Request "
                    "object exists until hand-off)")
        raise KeyError(f"unknown pool request id {rid}")

    def has_work(self):
        return bool(self._pending) or any(e.has_work()
                                          for e in self.engines.values())

    def run_until_complete(self, max_steps=100_000):
        """Drain the pool; returns {rid: finished Request}."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                msg = (f"disaggregated pool did not converge within "
                       f"{max_steps} steps")
                if _blackbox.is_enabled():
                    path = _blackbox.dump(
                        "stall", site="disagg/handoff",
                        extra={"trigger": "run_until_complete",
                               "max_steps": max_steps,
                               "pending": len(self._pending)})
                    if path:
                        msg += f"; blackbox dump bundle: {path}"
                raise RuntimeError(msg)
        return dict(self._results)

    def stats(self):
        """The pool's hand-off accounting and each side's own stats."""
        return {"pool": dict(self._m, pending=len(self._pending)),
                "workers": [w.stats() for w in self.workers],
                "engines": {n: e.stats() for n, e in self.engines.items()}}
