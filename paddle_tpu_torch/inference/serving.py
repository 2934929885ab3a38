"""Continuous-batching serving engine.

Ports paddle_tpu/inference/serving.py: ``ServingEngine``, ``Request`` and
``QueueFullError``. Requests share a batch of ``max_batch`` slots over one
KV cache; each slot sits at its own sequence position, and every step
runs one decode for all slots at once (models/gpt.py ``_decode_fns`` with
a per-row ``pos``). Admission prefills a prompt into a single-row cache
and copies the row into its slot; a finished slot (eos, max_new_tokens,
capacity) frees at once and the next queued request takes it on the
following ``step()``.

- ``temperature=0`` (the default) decodes greedily, token for token as a
  solo ``generate(temperature=0)``; ``temperature > 0`` samples, after
  per-row top-k, temperature and nucleus (top-p) truncation, from a
  ``torch.Generator`` seeded from (request seed, position) on the model's
  device: a stream per request, independent of its batch-mates and its
  slot. The reference draws from JAX's PRNG, so sampled tokens differ
  from its; greedy tokens do not.
- ``prefill_chunk=C``: a prompt is consumed C tokens a ``step()``, with the
  running slots' decodes in between.
- ``register_prefix(ids)``: a shared prefix's KV is prefilled once;
  requests with ``prefix_id=`` prefill only their suffix, from a copy.
- ``deadline_ms``, ``cancel``, ``max_queue`` (a full queue rejects with
  ``QueueFullError`` or sheds a lower-priority request), per-slot failure
  isolation (reason "error"), ``drain``/``health``, and a
  non-converging ``run_until_complete`` failing its requests with reason
  "engine_stalled".
- ``draft_model=`` (speculative continuous batching): a round has the
  draft propose ``spec_k`` tokens a slot and the target verify every slot
  in ONE (spec_k + 1)-token forward at per-slot positions, emitting
  1..spec_k + 1 tokens a slot; the tokens are plain greedy's. Rounds run
  while every active slot is greedy with spec_k + 1 columns of headroom;
  otherwise a single-token step runs, with the fed token mirrored into
  the draft's cache.
- ``FLAGS_paged_kv`` (read at construction): the dense
  ``[max_batch, max_seq]`` cache becomes the block pool of
  serving/paging.py. Each decode step gathers the pool through the block
  tables into the dense layout, runs the same decode math and writes each
  row's new column back, so the paged engine's tokens are the dense
  engine's. The paged engine also serves multi-LoRA adapters
  (``max_adapters``, ``lora_rank``; ``load_adapter``, ``evict_adapter``,
  ``submit(adapter=)``, ``register_prefix(adapter=)``): every loaded
  adapter decodes in the same batched step, slot 0 of the stacked factors
  being the base model's all-zero delta. A step whose rows are all base
  skips the adapter products (they would add exact zeros), so base
  requests give the plain engine's bits.
- ``hot_swap(model)`` replaces the served weights in place and bumps the
  engine's ``WeightVersion`` (framework/lineage.py); each request carries
  the version it was submitted under.
- ``admit_prefilled`` takes a KV row prefilled elsewhere
  (serving/disagg.py), checked against ``HANDOFF_SCHEMA``.
- ``FLAGS_async_dispatch`` (read at construction): a step enqueues the
  round's decode, runs the next round's admissions and chunked-prefill
  advances while the card computes, and only then reads the tokens (not
  with a draft model or paging, as in the reference).

The engine runs on its model's device (``cuda`` unless the model was
built with ``device="cpu"``) and updates its caches in place. The
reference compiles its programs and pads prompts to ``prompt_buckets``;
here prompts and chunks are prefilled at their own length (the junk
columns the padding writes are causally hidden, so the tokens are the
same), and ``prompt_buckets`` is validated as the reference validates it.
``cache_dtype="int8"`` or ``"fp8"`` keeps the dense cache quantized as the
decode model's ``decode_fns`` lays it out (GPT: each side a (values,
scales) pair; ``cache_spec()["quantized"]``); the paged engine refuses it,
as the reference's does.

Runtime services, as in the reference:
- the ``serving_*`` / ``request_*`` metric families of the default
  registry (monitor), every engine in the process sharing them;
- tracing (FLAGS_trace): a ``request`` root span per request from submit
  to its finish reason, with its ``trace_id`` (``Request.stats()
  ["trace_id"]``; ``submit(trace_id=, parent_span=)`` joins a caller's
  trace), a ``queue_wait`` child, ``admit`` / ``prefill`` /
  ``prefill_chunk`` spans, a ``decode`` span a request a step (the batched
  step's window), ``spec_draft`` / ``spec_verify`` and, on the async step,
  ``dispatch/decode`` / ``dispatch/overlap`` / ``dispatch/fetch``. Spans
  time the host: a window closing at the token read includes the device
  work before it;
- the ``serving/step``, ``serving/slot`` (an error finishes only that
  slot's request with ``finish_reason="error"``) and ``serving/adapter``
  failpoints;
- ``stats()["breakdown"]``: each step kind's host wall ms and share of
  the total; with FLAGS_trace on, each kind's FLOPs, counted once per call
  shape under the FLOP counter (trace/costs.py) and kept per engine, so a
  second engine in the process cannot bleed into this one's numbers:
  ``flops_per_call``, ``device_flops_total``, and over all kinds
  ``device_flops_per_sec`` and ``mfu`` against ``costs.peak_flops()``; on
  the async step ``async_overlap``;
- the lineage families ``serving_weight_version`` and
  ``serving_stale_sessions_total`` under FLAGS_goodput.

- the flight recorder (FLAGS_blackbox): every engine is a dump provider
  of its in-flight request table; ``serving/step`` windows around each
  step and ``serving/admit`` windows around each admission; a
  ``hot_swap`` note; ``run_until_complete``'s ``engine_stalled`` error
  names the bundle it wrote;
- the perf ledger (FLAGS_perf_ledger, read at construction): each step's
  wall ms goes through the regression sentinel, and every
  ``FLAGS_perf_ledger_interval``-th step appends the
  ``stats()["breakdown"]`` row (``perfledger.record_engine``).

Not ported, each raising ``NotImplementedError``: ``tp_mesh`` and
``warmup`` (``warmup`` needs framework/aot.py, the AOT cache, which is not
ported either).
"""
import time

import numpy as np
import torch

from .. import flags as _flags
from .. import monitor as _monitor
from .. import trace as _trace
from ..framework import lineage as _lineage
from ..monitor import blackbox_lazy as _blackbox  # import-free facade
from ..serving import decode_model as _dm_registry
from ..serving import paging as _paging
from ..serving.decode_model import cache_leaves, cache_map, cast_params
from ..testing import failpoints as _fp
from ..trace import costs as _costs

__all__ = ["ServingEngine", "Request", "QueueFullError"]


class QueueFullError(RuntimeError):
    """submit() rejected: the bounded admission queue is full and the
    request's priority does not outrank any queued entry."""


class _AdapterUnavailable(RuntimeError):
    """Paged admission found the request's adapter not loaded (evicted
    mid-flight): the request waits at the queue head, as on a full page
    pool, and regenerates its tokens once the adapter is loaded again."""


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet")


def _blackbox_request_table(eng):
    """One engine's in-flight request table for a blackbox dump bundle:
    where every unfinished request lives and how far it got — the
    'which rids were mid-flight when it wedged' evidence."""
    running = [{"rid": r.rid, "slot": s, "pos": int(eng._pos[s]),
                "new_tokens": len(r.output_ids)}
               for s, r in enumerate(eng._slot_req)
               if r is not None and s not in eng._prefilling]
    table = {
        "slots": eng.B,
        "step_no": eng._step_no,
        "draining": eng._draining,
        "queued": [r.rid for r in eng._queue],
        "handoff": [e[0].rid for e in eng._handoff],
        "prefilling": {s: e[0].rid for s, e in eng._prefilling.items()},
        "running": running,
        "finished": len(eng._finished),
    }
    table["in_flight"] = sorted(
        set(table["queued"]) | set(table["handoff"])
        | set(table["prefilling"].values())
        | {r["rid"] for r in running})
    return table


# engine metrics in the default registry (every engine in the process
# shares them; per-engine views live on ServingEngine.stats())
_REQ_SUBMITTED = _monitor.counter(
    "serving_requests_submitted_total", "requests accepted by submit()")
_REQ_FINISHED = _monitor.counter(
    "serving_requests_finished_total",
    "finished requests by reason (eos|length|capacity)",
    labelnames=("reason",))
_TOKENS = _monitor.counter(
    "serving_tokens_total", "generated tokens across all requests")
_QUEUE_WAIT_MS = _monitor.histogram(
    "serving_queue_wait_ms", "submit() -> admission start wait")
_TTFT_MS = _monitor.histogram(
    "serving_ttft_ms", "submit() -> first generated token")
_ITL_MS = _monitor.histogram(
    "serving_inter_token_ms",
    "gap between consecutive generated tokens of one request (a "
    "speculative round lands its accepted run at once: near-zero gaps)")
_STEPS = _monitor.counter(
    "serving_steps_total",
    "engine step slices by kind "
    "(decode_greedy|decode_sample|prefill_chunk|speculative)",
    labelnames=("kind",))
_OCCUPANCY = _monitor.gauge(
    "serving_batch_occupancy", "active decode slots at the last step()")
_PREFIX = _monitor.counter(
    "serving_prefix_cache_total",
    "prefix-reuse admissions: hit = suffix-only prefill from cached KV, "
    "miss = a prefix_id request that fell back to whole-prompt prefill",
    labelnames=("event",))
_SPEC = _monitor.counter(
    "serving_spec_tokens_total",
    "speculative decoding draft tokens (proposed vs accepted)",
    labelnames=("event",))
_SHED = _monitor.counter(
    "request_shed_total",
    "load-shedding on the bounded admission queue (queue_full = incoming "
    "request rejected with QueueFullError; preempted = a lower-priority "
    "queued request was finished with reason='shed' to admit a higher-"
    "priority one)",
    labelnames=("reason",))
_DEADLINE = _monitor.counter(
    "request_deadline_exceeded_total",
    "requests finished with reason='deadline' (per-request deadline_ms "
    "elapsed before completion)")


def _as_ids(ids):
    if torch.is_tensor(ids):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, np.int32).ravel()


_M64 = (1 << 64) - 1


def _stream_seed(seed, pos):
    """The sampling generator's seed for (request seed, position): one
    stream per request, one draw per position. The pair is packed into 64
    bits and mixed (splitmix64's finalizer, a bijection), so every bit of
    both reaches the low 32 bits, which are all a CPU generator keeps."""
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class _MsSummary:
    """O(1) latency accumulator for stats()."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def add(self, v):
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def to_dict(self):
        return {"count": self.count, "sum_ms": self.sum,
                "avg_ms": self.sum / self.count if self.count else 0.0,
                "min_ms": self.min or 0.0, "max_ms": self.max or 0.0}


class Request:
    """One submitted prompt and, when finished, its generated tokens.
    Lifecycle timestamps (perf_counter seconds) are stamped by the engine;
    ``stats()`` is the per-request view."""

    def __init__(self, rid, prompt_ids, max_new_tokens, temperature=0.0,
                 top_k=None, top_p=None, seed=None, prefix_id=None,
                 prefix_len=0, deadline_ms=None, priority=0, adapter=None):
        self.rid = rid
        self.prompt_ids = np.asarray(prompt_ids, np.int32).ravel()
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = rid if seed is None else int(seed)
        self.prefix_id = prefix_id          # registered shared prefix, or
        self.prefix_len = int(prefix_len)   # 0 = no prefix reuse
        self.adapter = adapter    # loaded LoRA adapter name (paged engines)
        self.deadline_ms = deadline_ms      # None = no deadline
        self.priority = int(priority)       # higher outranks on a full queue
        self.output_ids = []                # generated tokens, no prompt
        # tracing (FLAGS_trace): one trace_id per request; the root span
        # lives submit() -> finish reason, queue_wait is its first child
        self.trace_id = None
        self._span = None
        self._qspan = None
        self.finished = False
        # "eos" | "length" | "capacity" | "deadline" | "error" |
        # "cancelled" | "shed" | "engine_stalled"
        self.finish_reason = None
        self.submit_time = None
        self.admit_time = None        # admission start (queue wait ends)
        self.first_token_time = None
        self.last_token_time = None
        self.finish_time = None
        self._inter_token = _MsSummary()
        # the weight (and adapter) version this request decodes under,
        # stamped at submission; a hot_swap mid-stream leaves it as it was
        self.weight_version = None
        self.adapter_version = None

    @property
    def tokens(self):
        return np.asarray(self.output_ids, np.int32)

    def _note_token(self, now):
        """Record one emitted token; returns the inter-token gap in ms
        (None for the first token)."""
        gap = None
        if self.first_token_time is None:
            self.first_token_time = now
        else:
            gap = (now - self.last_token_time) * 1e3
            self._inter_token.add(gap)
        self.last_token_time = now
        return gap

    def stats(self):
        """Per-request latency and throughput (ms), live at any point of
        the lifecycle."""
        out = {"rid": self.rid, "finished": self.finished,
               "trace_id": self.trace_id,   # joins req stats to its spans
               "finish_reason": self.finish_reason,
               "prompt_tokens": int(len(self.prompt_ids)),
               "prefix_tokens": self.prefix_len,
               "new_tokens": len(self.output_ids)}
        if self.weight_version is not None:
            out["weight_version"] = str(self.weight_version)
        if self.adapter_version is not None:
            out["adapter_version"] = str(self.adapter_version)
        if self.submit_time is not None and self.admit_time is not None:
            out["queue_wait_ms"] = (self.admit_time - self.submit_time) * 1e3
        if self.submit_time is not None \
                and self.first_token_time is not None:
            out["ttft_ms"] = (self.first_token_time
                              - self.submit_time) * 1e3
        out["inter_token"] = self._inter_token.to_dict()
        if self.first_token_time is not None \
                and self.last_token_time is not None \
                and len(self.output_ids) > 1:
            dt = self.last_token_time - self.first_token_time
            if dt > 0:
                out["decode_tokens_per_sec"] = \
                    (len(self.output_ids) - 1) / dt
        return out


class ServingEngine:
    def __init__(self, model, max_batch=4, dtype=None, cache_dtype=None,
                 eos_token_id=None, prompt_buckets=(32, 64, 128, 256, 512,
                                                    1024), tp_mesh=None,
                 prefill_chunk=None, draft_model=None, spec_k=4,
                 max_queue=None, decode_model=None, page_block=None,
                 page_blocks=None, max_adapters=None, lora_rank=None,
                 page_cold_steps=None):
        dm = _dm_registry.resolve(model, decode_model)
        self._dm = dm
        cfg = model.cfg
        dm.check_config(cfg)
        self.cfg = cfg
        self.B = int(max_batch)
        self.T = cfg.max_seq_len
        self.eos = eos_token_id
        # argument validation first, before any device allocation
        if prefill_chunk is not None:
            if not 1 <= int(prefill_chunk) <= self.T:
                raise ValueError(
                    f"prefill_chunk must be in [1, max_seq_len={self.T}], "
                    f"got {prefill_chunk}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._max_queue = None if max_queue is None else int(max_queue)
        # FLAGS_paged_kv is structural: read here, and a disarm under a
        # live paged engine raises at its next step (_paged_active)
        paged = bool(_flags.get_flag("paged_kv", False))
        self._paged = paged
        pg_set = sorted(k for k, v in (
            ("page_block", page_block), ("page_blocks", page_blocks),
            ("max_adapters", max_adapters), ("lora_rank", lora_rank),
            ("page_cold_steps", page_cold_steps)) if v is not None)
        if not paged and pg_set:
            raise ValueError(
                f"{', '.join(pg_set)}= need FLAGS_paged_kv=1 — the paged "
                "engine is flag-gated (structural; consumed at engine "
                "construction)")
        if paged:
            if tp_mesh is not None:
                raise ValueError(
                    "FLAGS_paged_kv does not compose with tp_mesh= serving:"
                    " the block pool is single-host state — serve tensor-"
                    "parallel engines dense")
            if draft_model is not None:
                raise ValueError(
                    "FLAGS_paged_kv does not compose with draft_model= "
                    "(speculative rounds write multi-token columns; the "
                    "paged scatter writes one frontier column per step)")
            if cache_dtype is not None:
                raise ValueError(
                    "FLAGS_paged_kv does not compose with cache_dtype=: "
                    "hot pages live at the compute dtype; the cold tier is "
                    "the pool's int8 page codec (page_cold_steps=)")
            if prefill_chunk is not None:
                raise ValueError(
                    "FLAGS_paged_kv does not compose with prefill_chunk= "
                    "(paged admission prefills whole prompts into blocks "
                    "reserved up front)")
        if tp_mesh is not None:
            _not_ported("tensor-parallel serving (tp_mesh=)")
        dm_d = None
        if draft_model is not None:
            dm_d = _dm_registry.resolve(draft_model, None)
            if draft_model.cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if not 1 <= int(spec_k) <= 16:
                raise ValueError(f"spec_k must be in [1, 16], got {spec_k}")
            if draft_model.cfg.max_seq_len < self.T:
                raise ValueError(
                    f"draft max_seq_len ({draft_model.cfg.max_seq_len}) "
                    f"must cover the target's ({self.T})")
            dm_d.check_config(draft_model.cfg)
        self._buckets = tuple(sorted(b for b in prompt_buckets
                                     if b <= self.T))
        if not self._buckets:
            raise ValueError("no prompt bucket fits max_seq_len")
        params, dm_aux = dm.extract_params(model, "the model")
        self._compute_dtype = dm.compute_dtype(dtype)
        params = cast_params(params, self._compute_dtype)
        self._params = params
        # the served tensors may be the model's own parameters (an fp32
        # engine); hot_swap copies into private ones
        self._params_private = False
        self._dev = next(iter(params.values())).device
        self._fwd, self._logits_of, self._cache_init = dm.decode_fns(
            cfg, dm_aux, cache_dtype=cache_dtype)
        self._cache_dt = self._compute_dtype or torch.float32

        self._lora = None
        self._adapters = None
        if paged:
            # no dense [B, T] cache: K/V lives in the block pool
            side = self._cache_init(1, 1, self._cache_dt,
                                    torch.device("meta"))[0]
            L, _, KVh, _, hd = side.shape
            bs_pg = 16 if page_block is None else int(page_block)
            if bs_pg < 1 or self.T % bs_pg:
                raise ValueError(
                    f"page_block must divide max_seq_len={self.T}, "
                    f"got {page_block}")
            maxb = self.T // bs_pg
            # default pool: every slot can hold a full-length session,
            # plus the null frame
            n_blocks = (self.B * maxb + 1 if page_blocks is None
                        else int(page_blocks))
            self._pool = _paging.PagePool(
                (int(L), int(KVh), int(hd)), self._cache_dt, bs_pg, n_blocks,
                self.B, self.T, cold_after=page_cold_steps, device=self._dev)
            self._kc = self._vc = None
            n_ad = 8 if max_adapters is None else int(max_adapters)
            self._lora_rank = 8 if lora_rank is None else int(lora_rank)
            if n_ad > 0:
                try:
                    # slot 0 is the permanent all-zero BASE adapter
                    self._lora = dm.lora_init(cfg, n_ad + 1, self._lora_rank,
                                              dtype=self._compute_dtype,
                                              device=self._dev)
                    self._adapters = _paging.AdapterRegistry(n_ad)
                except NotImplementedError:
                    pass   # the pool serves base only; adapter APIs raise
            self._adapter_slot = np.zeros(self.B, np.int32)
        else:
            self._pool = None
            self._kc, self._vc = self._cache_init(self.B, self.T,
                                                  self._cache_dt, self._dev)

        self._chunk = None if prefill_chunk is None else int(prefill_chunk)
        # slot -> [req, kc1, vc1, consumed_offset, chunk_width, kc1d, vc1d]
        self._prefilling = {}
        # registered shared prefixes: pid -> (ids, kc1, vc1, kc1d, vc1d);
        # paged engines keep the KV in the pool: (ids, "paged", adapter,
        # None, None)
        self._prefixes = {}
        self._next_pid = 0

        # speculative decoding: the draft's params, decode math and its
        # own [B, T] cache (it stays dense)
        self._draft = None
        if draft_model is not None:
            self._spec_k = int(spec_k)
            params_d, dm_d_aux = dm_d.extract_params(draft_model,
                                                     "the draft model")
            self._params_d = cast_params(params_d, self._compute_dtype)
            self._fwd_d, self._logits_d, self._cache_init_d = \
                dm_d.decode_fns(draft_model.cfg, dm_d_aux,
                                cache_dtype=cache_dtype)
            self._kc_d, self._vc_d = self._cache_init_d(
                self.B, self.T, self._cache_dt, self._dev)
            self._draft = draft_model

        # FLAGS_async_dispatch, read at construction: step() enqueues the
        # round's decode first and admits while the card computes
        self._async = bool(_flags.get_flag("async_dispatch", False))
        self._async_ms = ({"dispatch_ms": 0.0, "overlap_ms": 0.0,
                           "fetch_ms": 0.0, "rounds": 0}
                          if self._async else None)

        # engine-local accounting for stats(): step_ms / flops by kind
        # ([count, total]); FLOPs a call by (kind, call shape), counted
        # once per shape while tracing
        self._m = {"submitted": 0, "finished": {}, "tokens": 0,
                   "steps": {}, "step_ms": {}, "flops": {},
                   "spec_proposed": 0, "spec_accepted": 0,
                   "prefix_hit": 0, "prefix_miss": 0,
                   "occupancy_sum": 0, "occupancy_steps": 0,
                   "queue_wait_ms": _MsSummary(), "ttft_ms": _MsSummary(),
                   "inter_token_ms": _MsSummary()}

        # host-side slot state
        self._slot_req = [None] * self.B        # Request or None
        self._pos = np.zeros(self.B, np.int32)  # next write column
        self._last = np.zeros(self.B, np.int32)
        self._temps = np.zeros(self.B, np.float32)   # 0 = greedy
        self._topk = np.full(self.B, self.cfg.vocab_size, np.int32)
        self._topp = np.ones(self.B, np.float32)     # 1.0 = no nucleus
        self._seeds = np.zeros(self.B, np.int32)
        self._queue = []
        # prefilled rows (admit_prefilled) waiting for a slot:
        # [req, kc1, vc1, logits]
        self._handoff = []
        self._next_rid = 0
        self._finished = {}
        self._draining = False
        self._deadline_live = 0   # unfinished requests carrying deadline_ms
        self._step_no = 0
        self._last_error_step = None
        # the version of the weights served now, and each loaded
        # adapter's load-time stamp
        self._weight_version = _lineage.WeightVersion(
            _lineage.new_run_id(), 0, "init")
        self._adapter_versions = {}
        self._flops_by_shape = {}
        # the lineage metric families ride the goodput accountant,
        # consumed here: disarmed costs one `is not None` per finish
        self._goodput = None
        if _flags.get_flag("goodput", False):
            from ..monitor import goodput as _goodput

            self._goodput = _goodput
            _goodput.note_serving_version(self._weight_version.counter)
        # perf ledger (FLAGS_perf_ledger), consumed at construction; host
        # accounting only, disarmed step() pays one `is not None`
        self._perf_ledger = None
        self._perf_rounds = 0
        if _flags.get_flag("perf_ledger", False):
            from ..monitor import perfledger as _perfledger

            self._perf_ledger = _perfledger.get_ledger()
        # blackbox dump bundles carry every live engine's in-flight
        # request table (weakly held; only read at dump time)
        _blackbox.register_provider("serving_engine", self,
                                    _blackbox_request_table)

    # -- the decode math ----------------------------------------------------
    def _cache_row(self):
        return self._cache_init(1, self.T, self._cache_dt, self._dev)

    def _draft_row(self):
        return self._cache_init_d(1, self.T, self._cache_dt, self._dev)

    def _ids_tensor(self, ids):
        return torch.as_tensor(np.asarray(ids, np.int64)[None],
                               device=self._dev)

    def _prefill_cols(self, ids, offset, kc1, vc1, aid=0):
        """Run `ids` at columns offset.. of a single-row cache (written in
        place); returns the hidden state of the last token [1, h]. `aid`:
        the adapter slot whose delta applies (0 = base)."""
        lora = {}
        if aid:
            lora = {"lora": self._lora, "adapter_ids": torch.tensor(
                [aid], device=self._dev)}
        return self._fwd(self._params, self._ids_tensor(ids), int(offset),
                         kc1, vc1, **lora)[:, -1]

    def _draft_feed(self, ids, offset, kc1d, vc1d):
        """The draft's KV of `ids` at columns offset.. of its single-row
        cache (a whole prompt at 0, or one chunk)."""
        self._fwd_d(self._params_d, self._ids_tensor(ids), int(offset),
                    kc1d, vc1d)

    def _logits1(self, x_last):
        return self._logits_of(self._params, x_last).float()[0]

    def _pick(self, logits, rows, temps, kvec, pvec, seeds, pos_vec):
        """Per-row pick over f32 logits [B, V]: the argmax, and for each
        row of `rows` (temperature > 0) a draw after top-k (on the raw
        logits), temperature and nucleus truncation (on the scaled ones;
        the top token always survives), as the reference's ``_pick``."""
        toks = torch.argmax(logits, -1)
        if not rows:
            return toks
        dev, V = logits.device, logits.shape[-1]
        idx = torch.as_tensor(rows, device=dev)
        lg = logits[idx]
        srt = torch.sort(lg, dim=-1, descending=True).values
        k = torch.as_tensor(np.clip(kvec[rows] - 1, 0, V - 1),
                            device=dev).long()
        lg = lg.masked_fill(lg < srt.gather(-1, k[:, None]), -torch.inf)
        lgt = lg / torch.as_tensor(temps[rows], device=dev)[:, None]
        srt_t = torch.sort(lgt, dim=-1, descending=True).values
        probs = torch.softmax(srt_t, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        k_keep = ((cum - probs) < torch.as_tensor(pvec[rows], device=dev)
                  [:, None]).sum(-1)
        cutoff = srt_t.gather(-1, (k_keep - 1).clamp_min(0)[:, None])
        probs = torch.softmax(lgt.masked_fill(lgt < cutoff, -torch.inf),
                              dim=-1)
        for j, r in enumerate(rows):
            gen = torch.Generator(device=dev).manual_seed(
                _stream_seed(seeds[r], pos_vec[r]))
            toks[r] = torch.multinomial(probs[j], 1, generator=gen)[0]
        return toks

    # -- API ----------------------------------------------------------------
    def register_prefix(self, prefix_ids, adapter=None):
        """Prefill a shared prefix (e.g. a system prompt) ONCE and cache
        its KV; returns a prefix id for submit(prefix_id=...). Requests
        using it prefill only their suffix. Paged engines write the
        prefix's full blocks into the pool once and map them into every
        session on it (refcounted; a partial boundary block is copied
        private at admission); ``adapter=`` prefills the prefix under
        that loaded adapter's delta, and sessions share its frames only
        when their adapter matches."""
        if adapter is not None and not self._paged:
            raise ValueError(
                "register_prefix(adapter=) needs FLAGS_paged_kv=1")
        ids = _as_ids(prefix_ids)
        if len(ids) == 0:
            raise ValueError("empty prefix")
        if len(ids) + 2 > self.T:
            raise ValueError(
                f"prefix ({len(ids)}) too long for max_seq_len {self.T}")
        with torch.no_grad():
            kc1, vc1 = self._cache_row()
            if self._paged:
                aid = self._resolve_adapter_slot(adapter)
                self._prefill_cols(ids, 0, kc1, vc1, aid=aid)
                pid = self._next_pid
                # may raise PagePoolFullError: nothing is registered then
                self._pool.put_prefix(pid, kc1[:, 0], vc1[:, 0], len(ids))
                self._next_pid += 1
                self._prefixes[pid] = (ids, "paged", adapter, None, None)
                return pid
            self._prefill_cols(ids, 0, kc1, vc1)
            kc1d = vc1d = None
            if self._draft is not None:   # the draft replays suffixes from
                kc1d, vc1d = self._draft_row()   # its own prefix KV
                self._draft_feed(ids, 0, kc1d, vc1d)
        pid = self._next_pid
        self._next_pid += 1
        self._prefixes[pid] = (ids, kc1, vc1, kc1d, vc1d)
        return pid

    def unregister_prefix(self, prefix_id):
        """Free a registered prefix's cached KV. In-flight requests that
        already use it are unaffected (paged frames still mapped by live
        sessions stay until those finish); later submits with this id
        raise."""
        if prefix_id not in self._prefixes:
            raise ValueError(f"unknown prefix_id {prefix_id}")
        if self._paged:
            self._pool.drop_prefix(prefix_id)
        del self._prefixes[prefix_id]

    def warmup(self, batch_shapes=None, sampling=True):
        _not_ported("warmup() (it needs framework/aot.py, the reference's "
                    "AOT program cache)")

    # -- multi-LoRA adapters (paged engines) --------------------------------
    def _require_adapters(self):
        if not self._paged:
            raise RuntimeError(
                "multi-LoRA adapters need FLAGS_paged_kv=1 — the paged "
                "engine owns the adapter registry")
        if self._adapters is None:
            raise RuntimeError(
                f"decode model {self._dm.name!r} does not support "
                "multi-LoRA serving (no lora_init), or the engine was "
                "built with max_adapters=0")

    def _resolve_adapter_slot(self, name):
        """Loaded adapter name -> its slot of the stacked factors (None ->
        0, the base)."""
        if name is None:
            return 0
        self._require_adapters()
        slot = self._adapters.peek(name)
        if slot is None:
            raise ValueError(
                f"adapter {name!r} is not loaded — load_adapter() it "
                f"first (loaded: {sorted(self._adapters.loaded())})")
        return slot

    def load_adapter(self, name, exported, pin=False):
        """Load one exported LoRA adapter (``incubate.lora.export_lora``)
        into a slot of the stacked factors; returns the slot index.
        Requests select it with submit(adapter=name); every loaded adapter
        decodes in the same batched step. A full registry evicts the least
        recently used unpinned adapter, whose in-flight sessions restart
        from the queue head (greedy and seeded decoding regenerate the
        same tokens once it is back). pin=True exempts this adapter from
        eviction; loading raises RuntimeError while every slot is pinned,
        ValueError for a malformed or duplicate adapter (a bad adapter
        never evicts a healthy one)."""
        self._require_adapters()
        if not isinstance(name, str) or not name:
            raise ValueError(
                f"adapter name must be a non-empty str, got {name!r}")
        if self._adapters.peek(name) is not None:
            raise ValueError(f"adapter {name!r} is already loaded")
        _fp.failpoint("serving/adapter")
        # pack before claiming a slot: a malformed adapter leaves the
        # registry and the factors as they were
        packed = self._dm.lora_pack(self.cfg, exported, self._lora_rank)
        slot, evicted = self._adapters.admit(name, pin=pin)
        if evicted is not None:
            self._restart_adapter_sessions(evicted)
            self._adapter_versions.pop(evicted, None)
        self._write_adapter_slot(slot, packed)
        self._adapter_versions[name] = _lineage.WeightVersion(
            self._weight_version.run_id, self._weight_version.counter,
            "adapter_load")
        return slot

    def evict_adapter(self, name):
        """Evict a loaded adapter: its slot zeroes and its in-flight
        sessions restart from the queue head (they wait there until the
        adapter is loaded again). Returns the freed slot; KeyError for an
        unknown name."""
        self._require_adapters()
        _fp.failpoint("serving/adapter")
        slot = self._adapters.evict(name)
        self._write_adapter_slot(slot, None)
        self._restart_adapter_sessions(name)
        self._adapter_versions.pop(name, None)
        return slot

    def _write_adapter_slot(self, slot, packed):
        """Write (packed) or zero (None) ONE slot of the stacked factors,
        in place."""
        lora = self._lora
        with torch.no_grad():
            lora["scale"][slot] = 0.0 if packed is None \
                else float(packed["scale"])
            for kind, fac in lora.items():
                if kind == "scale":
                    continue
                for side in ("A", "B"):
                    if packed is None:
                        fac[side][slot].zero_()
                    else:
                        fac[side][slot].copy_(torch.as_tensor(
                            packed[kind][side]).to(fac[side].dtype))

    def _restart_adapter_sessions(self, name):
        """An evicted adapter's in-flight sessions cannot keep decoding:
        free each one's blocks, reset it to its state before admission
        and requeue it at the head."""
        for s in range(self.B):
            req = self._slot_req[s]
            if req is None or req.adapter != name:
                continue
            self._pool.free_slot(s)
            self._slot_req[s] = None
            self._prefilling.pop(s, None)
            self._adapter_slot[s] = 0
            req.output_ids.clear()
            req.first_token_time = None
            req.last_token_time = None
            req._inter_token = _MsSummary()
            self._queue.insert(0, req)

    def hot_swap(self, model, decode_model=None):
        """Replace the served weights IN PLACE with `model`'s (same
        architecture, keys, shapes and dtypes) without dropping sessions,
        and bump the engine's weight version (origin ``hot_swap``).
        In-flight sessions finish under the new weights and keep their
        submission-time stamp; later requests carry the new version.
        Returns the new ``WeightVersion``. A replacement whose param tree
        differs in keys, shapes or dtypes raises ValueError before any
        served state changes."""
        dm = _dm_registry.resolve(model, decode_model)
        if type(dm) is not type(self._dm):
            raise ValueError(
                f"hot_swap: replacement model resolves to decode adapter "
                f"{type(dm).__name__}, engine serves "
                f"{type(self._dm).__name__}")
        dm.check_config(model.cfg)
        params, _ = dm.extract_params(model, "the replacement model")
        params = cast_params(params, self._compute_dtype)
        if set(params) != set(self._params):
            missing = sorted(set(self._params) - set(params))
            extra = sorted(set(params) - set(self._params))
            raise ValueError(
                f"hot_swap: param tree mismatch (missing {missing[:3]}, "
                f"unexpected {extra[:3]}) — the replacement must be the "
                "same architecture")
        for k in sorted(params):
            new, cur = params[k], self._params[k]
            if tuple(new.shape) != tuple(cur.shape) \
                    or new.dtype != cur.dtype:
                raise ValueError(
                    f"hot_swap: param {k!r} is {tuple(new.shape)}/"
                    f"{new.dtype}, engine serves {tuple(cur.shape)}/"
                    f"{cur.dtype} — shapes and dtypes must match exactly")
        with torch.no_grad():
            if not self._params_private:
                # never write into the model the engine was built from
                self._params = {k: torch.empty_like(v)
                                for k, v in self._params.items()}
                self._params_private = True
            for k, v in params.items():
                self._params[k].copy_(v)
        self._weight_version = self._weight_version.bump("hot_swap")
        if self._goodput is not None:
            self._goodput.note_serving_version(self._weight_version.counter)
        _blackbox.note("hot_swap", version=str(self._weight_version))
        return self._weight_version

    def _count_step(self, kind):
        self._m["steps"][kind] = self._m["steps"].get(kind, 0) + 1
        _STEPS.labels(kind=kind).inc()

    def _acc_ms(self, kind, t0):
        """Accumulate one step-kind slice's host wall time since `t0` for
        stats()['breakdown']."""
        self._acc_ms_value(kind, (time.perf_counter() - t0) * 1e3)

    def _acc_ms_value(self, kind, ms):
        st = self._m["step_ms"].setdefault(kind, [0, 0.0])
        st[0] += 1
        st[1] += ms

    def _costed(self, kind, shape, fn):
        """Run one device call of `kind` (``fn()``). While tracing, its
        FLOPs are counted under the FLOP counter the first time this
        engine meets the call shape `shape` (filed as ``site="serving"``,
        ``sig="<kind>:<shape>"`` in the cost registry), and every call
        adds its shape's count to this engine's total for the kind."""
        if not _trace._ENABLED[0]:
            return fn()
        key = (kind, shape)
        flops = self._flops_by_shape.get(key)
        if flops is None:
            with _costs.count(self._dev) as c:
                out = fn()
            flops = self._flops_by_shape[key] = c.flops
            _costs.record("serving", f"{kind}:{shape}", c.flops,
                          c.bytes_accessed, c.memory)
        else:
            out = fn()
        st = self._m["flops"].setdefault(kind, [0, 0.0])
        st[0] += 1
        st[1] += flops
        return out

    def _breakdown(self):
        """Step-time breakdown: host wall time per step kind joined with
        THIS engine's FLOPs (FLAGS_trace on while the kind ran). Without
        them the wall-time split stands on its own."""
        total_ms = sum(st[1] for st in self._m["step_ms"].values())
        kinds = {}
        flops_total = 0.0
        flops_known = False
        for kind in sorted(self._m["step_ms"]):
            count, ms = self._m["step_ms"][kind]
            row = {"count": count, "wall_ms": ms,
                   "wall_fraction": (ms / total_ms) if total_ms else 0.0}
            calls, total = self._m["flops"].get(kind, (0, 0.0))
            if calls:
                row["flops_per_call"] = total / calls
                row["device_flops_total"] = total
                flops_total += total
                flops_known = True
            kinds[kind] = row
        out = {"kinds": kinds, "wall_ms_total": total_ms}
        if self._async_ms is not None:
            # how much of the async rounds' wall time was dispatch, the
            # overlapped admission window and the token fetch
            a = dict(self._async_ms)
            covered = a["dispatch_ms"] + a["overlap_ms"] + a["fetch_ms"]
            a["dispatch_fraction"] = (
                (a["dispatch_ms"] + a["overlap_ms"]) / covered
                if covered else 0.0)
            out["async_overlap"] = a
        if flops_known:
            out["device_flops_total"] = flops_total
            peak = _costs.peak_flops(self._dev)
            if total_ms > 0 and peak:
                out["device_flops_per_sec"] = flops_total / (total_ms / 1e3)
                out["mfu"] = out["device_flops_per_sec"] / peak
        return out

    def stats(self):
        """Engine-lifetime snapshot from host-side accounting: requests by
        outcome, tokens, steps by kind, average batch occupancy, prefix
        hits, the speculative accept rate, queue-wait / TTFT / inter-token
        summaries, the step-time ``breakdown``, health, the served weight
        version (and each loaded adapter's), and on a paged engine the
        pool's ``paging`` block."""
        m = self._m
        occ = (m["occupancy_sum"] / m["occupancy_steps"]
               if m["occupancy_steps"] else 0.0)
        prefix_n = m["prefix_hit"] + m["prefix_miss"]
        out = {
            "slots": self.B,
            "requests": {"submitted": m["submitted"],
                         "queued": len(self._queue),
                         "handoff": len(self._handoff),
                         "prefilling": len(self._prefilling),
                         # decoding slots only: a mid-prefill slot holds a
                         # reservation but counts under "prefilling"
                         "running": sum(1 for s in range(self.B)
                                        if self._slot_req[s] is not None
                                        and s not in self._prefilling),
                         "finished": dict(m["finished"])},
            "tokens_generated": m["tokens"],
            "steps": dict(m["steps"]),
            "batch_occupancy_avg": occ,
            "prefix_cache": {"hit": m["prefix_hit"],
                             "miss": m["prefix_miss"],
                             "hit_rate": (m["prefix_hit"] / prefix_n
                                          if prefix_n else None)},
            "speculative": {"proposed": m["spec_proposed"],
                            "accepted": m["spec_accepted"],
                            "accept_rate": (m["spec_accepted"]
                                            / m["spec_proposed"]
                                            if m["spec_proposed"]
                                            else None)},
            "queue_wait_ms": m["queue_wait_ms"].to_dict(),
            "ttft_ms": m["ttft_ms"].to_dict(),
            "inter_token_ms": m["inter_token_ms"].to_dict(),
            "breakdown": self._breakdown(),
            "health": self.health(),
            "weight_version": str(self._weight_version),
        }
        if self._adapter_versions:
            out["adapter_versions"] = {
                n: str(v) for n, v in sorted(self._adapter_versions.items())}
        if self._paged:
            pg = self._pool.stats()
            live = sum(1 for r in self._slot_req if r is not None)
            pg["live_sessions"] = live
            # pool bytes held per live session against what the dense
            # engine pins per slot (one full-length row)
            pg["kv_bytes_per_session"] = (
                self._pool.bytes_in_use() / live if live else 0.0)
            pg["dense_bytes_per_session"] = (
                self._pool.block_bytes * self._pool.maxb)
            if self._adapters is not None:
                ad = self._adapters.stats()
                ad["loaded_names"] = sorted(self._adapters.loaded())
                pg["adapters"] = ad
            out["paging"] = pg
        return out

    def get_request(self, rid):
        """The Request of a submitted id — queued, handed off, in flight
        or finished. Raises KeyError for an unknown id."""
        for req in self._queue:
            if req.rid == rid:
                return req
        for req in self._slot_req:
            if req is not None and req.rid == rid:
                return req
        for entry in self._handoff:
            if entry[0].rid == rid:
                return entry[0]
        if rid in self._finished:
            return self._finished[rid]
        raise KeyError(f"unknown request id {rid}")

    def _validate_decode_args(self, ids, max_new_tokens, temperature,
                              deadline_ms, top_k, top_p, seed):
        """submit()'s and admit_prefilled()'s argument validation; returns
        the int seed (None stays None)."""
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if deadline_ms is not None and not deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if seed is not None:
            seed = int(seed)
            if not -2**31 <= seed < 2**31:
                raise ValueError(
                    f"seed must fit int32, got {seed} (mask with "
                    "& 0x7FFFFFFF for hash/time-derived seeds)")
        if len(ids) == 0:
            raise ValueError("empty prompt")
        return seed

    def _new_request(self, ids, max_new_tokens, temperature, top_k, top_p,
                     seed, prefix_id, prefix_len, deadline_ms, priority,
                     adapter=None, trace_id=None, parent_span=None):
        """An accepted request: its rid, submit time, version stamps, trace
        spans (a caller's trace_id, and optionally its span as parent,
        thread its spans through) and the submission count."""
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, ids, max_new_tokens, temperature=temperature,
                      top_k=top_k, top_p=top_p, seed=seed,
                      prefix_id=prefix_id, prefix_len=prefix_len,
                      deadline_ms=deadline_ms, priority=priority,
                      adapter=adapter)
        req.submit_time = time.perf_counter()
        req.weight_version = self._weight_version
        if adapter is not None:
            req.adapter_version = self._adapter_versions.get(adapter)
        if _trace._ENABLED[0]:
            # every later span (queue-wait, prefill, per-step decode)
            # parents back to this root span
            req.trace_id = trace_id or _trace.new_trace_id()
            req._span = _trace.start_span(
                "request", subsystem="serving", trace_id=req.trace_id,
                parent=parent_span, rid=rid, prompt_tokens=int(len(ids)),
                prefix_tokens=prefix_len, priority=priority)
            req._qspan = _trace.start_span(
                "queue_wait", subsystem="serving", parent=req._span)
        if deadline_ms is not None:
            self._deadline_live += 1
        self._m["submitted"] += 1
        _REQ_SUBMITTED.inc()
        return req

    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               top_k=None, top_p=None, seed=None, prefix_id=None,
               deadline_ms=None, priority=0, trace_id=None,
               parent_span=None, adapter=None):
        """Queue a prompt; returns the request id. temperature=0 (the
        default) decodes greedily; temperature > 0 samples (optionally
        top_k- and/or top_p-truncated) from a per-request stream (seed
        defaults to the request id).

        deadline_ms: wall-clock budget from submit; an overdue request
        finishes with reason "deadline" at the next step(). priority: on a
        FULL bounded queue (max_queue=) a strictly higher-priority arrival
        sheds the lowest-priority queued request (reason "shed");
        otherwise submit raises QueueFullError. adapter: the name of a
        loaded LoRA adapter (paged engines); None = the base weights.
        trace_id / parent_span: a caller's trace the request's spans join
        (FLAGS_trace)."""
        if self._draining:
            raise RuntimeError(
                "ServingEngine is draining — not accepting new requests "
                "(in-flight work runs to completion; see drain())")
        if adapter is not None:
            self._require_adapters()
            if self._adapters.lookup(adapter) is None:
                raise ValueError(
                    f"adapter {adapter!r} is not loaded — load_adapter() "
                    f"it first (loaded: "
                    f"{sorted(self._adapters.loaded())})")
        ids = _as_ids(prompt_ids)
        seed = self._validate_decode_args(ids, max_new_tokens, temperature,
                                          deadline_ms, top_k, top_p, seed)
        prefix_len = 0
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            prefix_ids = self._prefixes[prefix_id][0]
            prefix_len = len(prefix_ids)
            # the logical prompt is prefix + suffix; only the suffix is
            # prefilled (from the cached prefix KV)
            ids = np.concatenate([prefix_ids, ids])
        if len(ids) + 1 > self.T:
            raise ValueError(
                f"prompt ({len(ids)}) too long for max_seq_len {self.T}")
        if self._paged:
            # a request that can NEVER fit the pool would requeue forever
            need = self._pool.blocks_for(
                min(self.T, len(ids) + int(max_new_tokens)))
            cap = self._pool.n_blocks - 1   # frame 0 = null
            if need > cap:
                raise ValueError(
                    f"request needs {need} KV blocks but the page pool "
                    f"only has {cap}; raise page_blocks or shorten the "
                    "request")
        priority = int(priority)
        if self._max_queue is not None \
                and len(self._queue) + len(self._handoff) >= self._max_queue:
            # shed the lowest-priority queued request (the newest among
            # ties: it has waited least) iff the arrival outranks it;
            # hand-off rows are never shed (their prefill is paid)
            victim_idx = None
            for i, r in enumerate(self._queue):
                if victim_idx is None \
                        or r.priority <= self._queue[victim_idx].priority:
                    victim_idx = i
            if victim_idx is not None \
                    and self._queue[victim_idx].priority < priority:
                self._finish_req(self._queue.pop(victim_idx), "shed")
                _SHED.labels(reason="preempted").inc()
            else:
                _SHED.labels(reason="queue_full").inc()
                raise QueueFullError(
                    f"admission queue full ({len(self._queue)} queued "
                    f"+ {len(self._handoff)} handoff / {self._max_queue});"
                    " request rejected — retry later or submit with a "
                    "higher priority")
        req = self._new_request(ids, max_new_tokens, temperature, top_k,
                                top_p, seed, prefix_id, prefix_len,
                                deadline_ms, priority, adapter=adapter,
                                trace_id=trace_id, parent_span=parent_span)
        self._queue.append(req)
        return req.rid

    def admit_prefilled(self, prompt_ids, kv_row, logits, max_new_tokens=32,
                        temperature=0.0, top_k=None, top_p=None, seed=None,
                        deadline_ms=None, priority=0, trace_id=None,
                        parent_span=None):
        """Prefill/decode disaggregation: admit a request whose prompt KV
        was prefilled elsewhere. ``kv_row`` is the (kc1, vc1) single-row
        cache pair of this engine's decode model (a
        ``serving.disagg.PrefillWorker`` built from the same model, dtype
        and cache_dtype makes it); ``logits`` the prompt's last-position
        logits [V] (fp32). The row is checked against ``HANDOFF_SCHEMA``
        (``HandoffMismatch``, a ValueError, names the leaf), waits for a
        slot, then takes the standard admission tail: its copy into the
        slot and the first token through the same pick, so the tokens
        equal those of submitting the prompt here. Returns the request
        id. Raises while draining, on a full bounded queue
        (QueueFullError), and on a speculative or paged engine
        (RuntimeError)."""
        from ..serving.disagg import HANDOFF_SCHEMA, validate

        if self._draining:
            raise RuntimeError(
                "ServingEngine is draining — not accepting new requests "
                "(in-flight work runs to completion; see drain())")
        if self._draft is not None:
            raise RuntimeError(
                "admit_prefilled does not compose with speculative "
                "decoding (draft_model=): the handoff row carries no "
                "draft-model KV — disaggregate with a plain engine")
        if self._paged:
            raise RuntimeError(
                "admit_prefilled does not compose with FLAGS_paged_kv: "
                "the handoff row targets the dense big cache, a paged "
                "engine re-blocks prompts locally — disaggregate with "
                "dense decode engines")
        ids = _as_ids(prompt_ids)
        seed = self._validate_decode_args(ids, max_new_tokens, temperature,
                                          deadline_ms, top_k, top_p, seed)
        if len(ids) + 1 > self.T:
            raise ValueError(
                f"prompt ({len(ids)}) too long for max_seq_len {self.T}")
        kc1, vc1 = kv_row
        side = cache_leaves(self._kc)[0]
        L, _, KVh, T, hd = side.shape
        validate(HANDOFF_SCHEMA, {"kc": kc1, "vc": vc1, "logits": logits},
                 dims={"L": int(L), "KVh": int(KVh), "T": int(T),
                       "hd": int(hd), "V": int(self.cfg.vocab_size)},
                 dtypes={"cache": side.dtype})
        # the bound is checked after validation: an unservable row fails
        # for good (ValueError), never as retryable backpressure
        if self._max_queue is not None \
                and len(self._queue) + len(self._handoff) >= self._max_queue:
            _SHED.labels(reason="queue_full").inc()
            raise QueueFullError(
                f"admission queue full ({len(self._queue)} queued + "
                f"{len(self._handoff)} handoff / {self._max_queue}); "
                "handoff rejected — back off or target another engine")
        req = self._new_request(ids, max_new_tokens, temperature, top_k,
                                top_p, seed, None, 0, deadline_ms,
                                int(priority), trace_id=trace_id,
                                parent_span=parent_span)
        self._handoff.append([req, kc1, vc1, logits])
        return req.rid

    def _bucket(self, n):
        for b in self._buckets:
            if n <= b:
                return b
        return self.T

    def _finish_req(self, req, reason, slot=None):
        """Terminal transition of a request wherever it lives; with `slot`
        it also frees the slot, its prefill in flight and (paged) its
        frames and adapter slot. A freed dense row needs no scrubbing: the
        next admission's row copy overwrites it."""
        req.finished = True
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        if req._qspan is not None:   # finished while still queued
            req._qspan.end()
            req._qspan = None
        if req._span is not None:
            req._span.end(finish_reason=reason,
                          new_tokens=len(req.output_ids))
            req._span = None
        if req.deadline_ms is not None:
            self._deadline_live -= 1
        self._m["finished"][reason] = self._m["finished"].get(reason, 0) + 1
        _REQ_FINISHED.labels(reason=reason).inc()
        if (self._goodput is not None and req.weight_version is not None
                and req.weight_version.counter
                < self._weight_version.counter):
            # finished under weights older than those served now (a
            # hot_swap landed mid-stream): once per stale finish
            self._goodput.note_stale_session()
        self._finished[req.rid] = req
        if slot is not None:
            self._slot_req[slot] = None
            self._prefilling.pop(slot, None)
            if self._paged:
                self._pool.free_slot(slot)
                self._adapter_slot[slot] = 0

    def _finish(self, slot, reason):
        self._finish_req(self._slot_req[slot], reason, slot=slot)

    def _note_error(self):
        self._last_error_step = self._step_no

    def cancel(self, rid):
        """Cancel a queued, handed-off or in-flight request: it finishes at
        once with reason "cancelled" and frees its slot. Returns True if
        cancelled, False if it had already finished; KeyError for an
        unknown id."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(i)
                self._finish_req(req, "cancelled")
                return True
        for entry in list(self._handoff):
            if entry[0].rid == rid:
                self._handoff.remove(entry)
                self._finish_req(entry[0], "cancelled")
                return True
        for slot in range(self.B):
            req = self._slot_req[slot]
            if req is not None and req.rid == rid:
                self._finish_req(req, "cancelled", slot=slot)
                return True
        if rid in self._finished:
            return False
        raise KeyError(f"unknown request id {rid}")

    def drain(self, stop=True):
        """Stop admitting new requests (submit() raises) while queued and
        in-flight work runs to completion; drain(False) re-opens."""
        self._draining = bool(stop)

    def health(self):
        """"draining" after drain(), "degraded" when a request finished
        with reason "error" in the last 100 steps or the bounded queue is
        at >= 80% depth, else "ok". The depth counts the queue and the
        hand-off rows."""
        depth = len(self._queue) + len(self._handoff)
        state = "ok"
        if self._draining:
            state = "draining"
        else:
            recent_error = (self._last_error_step is not None
                            and self._step_no - self._last_error_step <= 100)
            q_pressure = (self._max_queue is not None and depth
                          >= max(1, int(0.8 * self._max_queue)))
            if recent_error or q_pressure:
                state = "degraded"
        return {"state": state,
                "queue_depth": depth,
                "queue_limit": self._max_queue,
                "active_slots": sum(1 for r in self._slot_req
                                    if r is not None),
                "errors": self._m["finished"].get("error", 0),
                "steps": self._step_no}

    def _expire_deadlines(self):
        """Finish every overdue request (reason "deadline") wherever it
        lives; batch-mates are untouched."""
        if not self._deadline_live:
            return
        now = time.perf_counter()

        def overdue(req):
            return (req.deadline_ms is not None
                    and (now - req.submit_time) * 1e3 > req.deadline_ms)

        for req in [r for r in self._queue if overdue(r)]:
            self._queue.remove(req)
            self._finish_req(req, "deadline")
            _DEADLINE.inc()
        for entry in [e for e in self._handoff if overdue(e[0])]:
            self._handoff.remove(entry)
            self._finish_req(entry[0], "deadline")
            _DEADLINE.inc()
        for slot in range(self.B):
            req = self._slot_req[slot]
            if req is not None and overdue(req):
                self._finish_req(req, "deadline", slot=slot)
                _DEADLINE.inc()

    # -- admission ----------------------------------------------------------
    def _activate(self, slot, req, kc1, vc1, logits, draft_caches=None):
        """Admission tail: copy the single-row cache(s) into the slot and
        emit the first generated token through the standard pick over the
        prompt's last logits [V]."""
        n = len(req.prompt_ids)
        if self._paged:
            # the row goes into the slot's reserved PRIVATE frames
            self._pool.admit_row(slot, kc1[:, 0], vc1[:, 0])
            self._adapter_slot[slot] = self._resolve_adapter_slot(
                req.adapter)
        else:
            for big, row in zip(cache_leaves(self._kc)
                                + cache_leaves(self._vc),
                                cache_leaves(kc1) + cache_leaves(vc1)):
                big[:, slot] = row[:, 0]
        if draft_caches is not None:
            for big, row in zip(cache_leaves(self._kc_d)
                                + cache_leaves(self._vc_d),
                                cache_leaves(draft_caches[0])
                                + cache_leaves(draft_caches[1])):
                big[:, slot] = row[:, 0]
        self._slot_req[slot] = req
        self._pos[slot] = n
        self._temps[slot] = req.temperature
        self._topk[slot] = req.top_k or self.cfg.vocab_size
        self._topp[slot] = 1.0 if req.top_p is None else req.top_p
        self._seeds[slot] = req.seed
        # the draw of the first token takes position n - 1, the index of
        # the context's last token (each emission has its own position)
        pos = np.array([n - 1], np.int32)
        rows = [0] if req.temperature > 0 else []
        tok = int(self._pick(logits[None], rows,
                             self._temps[slot:slot + 1],
                             self._topk[slot:slot + 1],
                             self._topp[slot:slot + 1],
                             self._seeds[slot:slot + 1], pos)[0])
        self._last[slot] = tok
        req.output_ids.append(tok)
        self._after_emit(slot, req)

    def _note_admission(self, req):
        req.admit_time = time.perf_counter()
        wait_ms = (req.admit_time - req.submit_time) * 1e3
        self._m["queue_wait_ms"].add(wait_ms)
        _QUEUE_WAIT_MS.observe(wait_ms)
        if req._qspan is not None:
            req._qspan.end(wait_ms=wait_ms)
            req._qspan = None

    def _admit_one(self, slot, req):
        with _blackbox.progress("serving/admit"):
            self._admit_one_inner(slot, req)

    def _admit_one_inner(self, slot, req):
        if self._paged:
            return self._admit_one_paged(slot, req)
        prefix_len = req.prefix_len
        n = len(req.prompt_ids)
        if prefix_len and req.prefix_id not in self._prefixes:
            # prefix unregistered while this request sat in the queue: the
            # combined prompt is already in prompt_ids — whole-prefill it
            prefix_len = 0
        self._note_admission(req)
        draft = self._draft is not None
        if prefix_len:
            # suffix-only prefill from a COPY of the prefix's KV (each
            # admission writes its suffix into its own copy); chunk width
            # the engine's prefill_chunk or a default for prefix users
            C = self._chunk or min(64, self.T)
            end = prefix_len + -(-(n - prefix_len) // C) * C
            if end <= self.T:
                self._m["prefix_hit"] += 1
                _PREFIX.labels(event="hit").inc()
                sp = None if req._span is None else _trace.start_span(
                    "admit", subsystem="serving", parent=req._span,
                    slot=slot, prefix="hit", prefix_tokens=prefix_len)
                copies = [None if c is None else cache_map(torch.clone, c)
                          for c in self._prefixes[req.prefix_id][1:]]
                self._slot_req[slot] = req
                self._prefilling[slot] = [req, copies[0], copies[1],
                                          prefix_len, C, copies[2],
                                          copies[3]]
                if sp is not None:
                    sp.end()
                return
            # else: whole-prompt prefill (the reference's chunk schedule
            # would write past max_seq_len)
        if req.prefix_len:   # wanted prefix reuse, got a full recompute
            self._m["prefix_miss"] += 1
            _PREFIX.labels(event="miss").inc()
        n_chunks_end = 0 if self._chunk is None else \
            -(-n // self._chunk) * self._chunk
        if self._chunk is not None and n_chunks_end <= self.T:
            # chunked admission: reserve the slot, consume the prompt one
            # chunk a step() so running decodes go on in between
            self._slot_req[slot] = req
            rows_d = self._draft_row() if draft else (None, None)
            self._prefilling[slot] = [req, *self._cache_row(), 0,
                                      self._chunk, *rows_d]
            return
        t0 = time.perf_counter()
        sp = None if req._span is None else _trace.start_span(
            "prefill", subsystem="serving", parent=req._span, slot=slot,
            tokens=n)
        try:
            kc1, vc1 = self._cache_row()
            logits = self._costed("prefill", n, lambda: self._logits1(
                self._prefill_cols(req.prompt_ids, 0, kc1, vc1)))
            draft_caches = None
            if draft:
                draft_caches = self._draft_row()
                self._draft_feed(req.prompt_ids, 0, *draft_caches)
            self._activate(slot, req, kc1, vc1, logits, draft_caches)
        except BaseException:
            # the failing admission's span is recorded too (step()
            # finishes the request with reason "error")
            if sp is not None:
                sp.end(error=True)
            raise
        self._acc_ms("prefill", t0)
        if sp is not None:
            sp.end()

    def _admit_one_paged(self, slot, req):
        """Reserve the session's WHOLE block budget first — a pool that
        cannot cover it raises PagePoolFullError before any prefill or
        state change (the caller requeues the request), as does an
        adapter evicted while the request waited (_AdapterUnavailable). A
        registered prefix under the same adapter maps its full blocks
        shared; then one whole-prompt prefill under the request's adapter
        and _activate copies the row into the private frames."""
        aid = 0
        if req.adapter is not None:
            aid = None if self._adapters is None \
                else self._adapters.peek(req.adapter)
            if aid is None:
                raise _AdapterUnavailable(
                    f"adapter {req.adapter!r} is not loaded (evicted "
                    "mid-flight?) — the request waits at the queue head "
                    "for a reload")
        n = len(req.prompt_ids)
        shared, cow = (), False
        prefix_len = req.prefix_len
        entry = self._prefixes.get(req.prefix_id) if prefix_len else None
        if entry is not None and entry[2] == req.adapter:
            # may raise PagePoolFullError while bringing cold pages back —
            # before reserve(), so backpressure changes nothing
            shared = self._pool.prefix_frames(req.prefix_id)
            cow = bool(shared) and prefix_len % self._pool.bs != 0
        self._pool.reserve(slot, min(self.T, n + req.max_new_tokens),
                           shared_frames=shared, cow=cow)
        if prefix_len:   # counted once the reservation holds
            ev = "hit" if shared else "miss"
            self._m[f"prefix_{ev}"] += 1
            _PREFIX.labels(event=ev).inc()
        self._note_admission(req)
        t0 = time.perf_counter()
        sp = None if req._span is None else _trace.start_span(
            "prefill", subsystem="serving", parent=req._span, slot=slot,
            tokens=n, paged=True)
        try:
            kc1, vc1 = self._cache_row()
            logits = self._costed("prefill", (n, bool(aid)), lambda: (
                self._logits1(self._prefill_cols(req.prompt_ids, 0, kc1,
                                                 vc1, aid=aid))))
            self._activate(slot, req, kc1, vc1, logits)
        except BaseException:
            if sp is not None:
                sp.end(error=True)
            raise
        self._acc_ms("prefill", t0)
        if sp is not None:
            sp.end()

    def _advance_prefill(self, slot):
        """Consume one chunk of a reserved slot's prompt (the draft's
        too); on the last chunk, activate the slot."""
        req, kc1, vc1, off, C, kc1d, vc1d = self._prefilling[slot]
        self._count_step("prefill_chunk")
        t0 = time.perf_counter()
        sp = None if req._span is None else _trace.start_span(
            "prefill_chunk", subsystem="serving", parent=req._span,
            slot=slot, offset=off, width=C)
        n = len(req.prompt_ids)
        end = min(off + C, n)
        try:
            x_last = self._costed(
                "prefill_chunk", end - off, lambda: self._prefill_cols(
                    req.prompt_ids[off:end], off, kc1, vc1))
            if self._draft is not None:
                self._draft_feed(req.prompt_ids[off:end], off, kc1d, vc1d)
            if end >= n:
                del self._prefilling[slot]
                self._slot_req[slot] = None   # _activate re-binds
                self._activate(slot, req, kc1, vc1, self._logits1(x_last),
                               None if self._draft is None
                               else (kc1d, vc1d))
            else:
                self._prefilling[slot] = [req, kc1, vc1, end, C, kc1d,
                                          vc1d]
        except BaseException:
            if sp is not None:   # record the failing chunk's span too
                sp.end(error=True)
            raise
        self._acc_ms("prefill_chunk", t0)
        if sp is not None:
            sp.end(consumed=end)

    def _advance_and_admit(self):
        """Advance every chunked prefill in flight ONE chunk, then admit
        hand-off rows and queued requests into free slots (hand-off rows
        first: their prefill is paid). A failing request finishes with
        reason "error" and the pass goes on."""
        for slot in list(self._prefilling):
            req = self._prefilling[slot][0]
            try:
                self._advance_prefill(slot)
            except Exception:
                self._finish_req(req, "error", slot=slot)
                self._note_error()
        for slot in range(self.B):
            # while, not if: a request finishing DURING admission (eos on
            # its first token, max_new_tokens=1) frees the slot for the
            # next request in the same pass
            while self._slot_req[slot] is None and (self._handoff
                                                    or self._queue):
                if self._handoff:
                    req, kc1, vc1, logits = self._handoff.pop(0)
                    try:
                        with _blackbox.progress("serving/admit"):
                            self._note_admission(req)
                            t0 = time.perf_counter()
                            self._activate(slot, req, kc1, vc1, logits)
                            self._acc_ms("handoff_admit", t0)
                    except Exception:
                        self._finish_req(req, "error", slot=slot)
                        self._note_error()
                        continue
                else:
                    req = self._queue.pop(0)
                    try:
                        self._admit_one(slot, req)
                    except (_paging.PagePoolFullError, _AdapterUnavailable):
                        # backpressure, not a failure: nothing ran and
                        # nothing was reserved; finishing sessions free
                        # frames, a reload brings the adapter back
                        self._queue.insert(0, req)
                        return
                    except Exception:
                        self._finish_req(req, "error", slot=slot)
                        self._note_error()
                        continue
                if self._slot_req[slot] is not None:
                    break

    # -- the step -----------------------------------------------------------
    def _dispatch_decode(self, active):
        """Enqueue ONE decode for every slot at its own position (inactive
        rows ride along: their rows are don't-care until the next
        admission); returns (the tokens [B] on the device, not yet read,
        the step kind)."""
        sampled = [s for s in active if self._temps[s] > 0]
        kind = "decode_sample" if sampled else "decode_greedy"
        with_lora = self._paged and self._lora is not None \
            and bool(self._adapter_slot.any())
        toks = self._costed(kind, (self.B, with_lora),
                            lambda: self._decode(sampled, with_lora))
        self._count_step(kind)
        return toks, kind

    def _decode(self, sampled, with_lora):
        last = torch.as_tensor(self._last, device=self._dev).long()
        pos = torch.as_tensor(self._pos, device=self._dev).long()
        p = self._params
        if self._paged:
            pool = self._pool
            tables = pool.tables_device()
            lora = {}
            if with_lora:
                # a step of base rows only skips the products: they add
                # exact zeros
                lora = {"lora": self._lora, "adapter_ids": torch.as_tensor(
                    self._adapter_slot, device=self._dev).long()}
            kc, vc = _paging.gather_dense(pool.kp, pool.vp, tables)
            x = self._fwd(p, last[:, None], pos, kc, vc, **lora)
            _paging.scatter_cols(pool.kp, pool.vp, kc, vc, tables, pos)
        else:
            x = self._fwd(p, last[:, None], pos, self._kc, self._vc)
        logits = self._logits_of(p, x[:, 0]).float()
        return self._pick(logits, sampled, self._temps, self._topk,
                          self._topp, self._seeds, self._pos)

    def _apply_decode(self, active, next_toks, kind, t0_ns, t1_ns):
        """Emit one fetched round's tokens slot by slot; a per-slot
        failure finishes only that slot's request (reason "error"). Each
        request's ``decode`` span gets the batched step's window."""
        for s in active:
            req = self._slot_req[s]
            try:
                _fp.failpoint("serving/slot")
                self._pos[s] += 1
                self._last[s] = next_toks[s]
                req.output_ids.append(int(next_toks[s]))
                if req._span is not None:
                    _trace.emit("decode", t0_ns, t1_ns,
                                subsystem="serving", parent=req._span,
                                slot=s, pos=int(self._pos[s]),
                                kind=kind, token=int(next_toks[s]))
                self._after_emit(s, req)
            except Exception:
                if self._slot_req[s] is not None:
                    self._finish_req(req, "error", slot=s)
                self._note_error()

    def _after_emit(self, slot, req):
        now = time.perf_counter()
        gap_ms = req._note_token(now)
        self._m["tokens"] += 1
        _TOKENS.inc()
        if gap_ms is None:  # first generated token: TTFT
            ttft = (now - req.submit_time) * 1e3
            self._m["ttft_ms"].add(ttft)
            _TTFT_MS.observe(ttft)
        else:
            self._m["inter_token_ms"].add(gap_ms)
            _ITL_MS.observe(gap_ms)
        if self.eos is not None and req.output_ids[-1] == self.eos:
            self._finish(slot, "eos")
        elif len(req.output_ids) >= req.max_new_tokens:
            self._finish(slot, "length")
        elif self._pos[slot] >= self.T:   # next write column out of cache
            self._finish(slot, "capacity")

    def _paged_active(self):
        """The construction-time FLAGS_paged_kv against the live flag: a
        disarm under a live paged engine raises (it has no dense cache to
        fall back to)."""
        if self._paged and not _flags.get_flag("paged_kv", False):
            raise RuntimeError(
                "FLAGS_paged_kv was disarmed under a live paged engine — "
                "the flag is consumed at ENGINE CONSTRUCTION; build a new "
                "engine instead of toggling it mid-flight")
        return self._paged

    def _active(self):
        return [s for s in range(self.B)
                if self._slot_req[s] is not None
                and s not in self._prefilling]

    def _note_occupancy(self, active):
        self._m["occupancy_sum"] += len(active)
        self._m["occupancy_steps"] += 1
        _OCCUPANCY.set(len(active))
        _trace.add_counter_sample("serving_batch_occupancy", len(active))

    def step(self):
        """Advance chunked prefills, admit queued requests into free slots,
        then run ONE decode step (or speculative round) for every active
        slot. Returns the requests finished in this step. Host-side
        per-slot failures finish only that slot's request (reason
        "error"); a failure of the batched decode itself propagates."""
        # window beacon around the WHOLE step (the failpoint delay
        # included): a thread wedged anywhere inside leaves an active,
        # non-advancing site for the stall sentinel to name
        with _blackbox.progress("serving/step"):
            if self._perf_ledger is None:
                return self._step_inner()
            t0 = time.perf_counter()
            try:
                return self._step_inner()
            finally:
                self._ledger_round((time.perf_counter() - t0) * 1e3)

    def _ledger_round(self, step_ms):
        """Armed-only (FLAGS_perf_ledger) per-step feed: the regression
        sentinel sees every step's wall ms; every
        FLAGS_perf_ledger_interval-th step appends the full
        stats()['breakdown'] row."""
        led = self._perf_ledger
        led.observe("serving", {"step_ms": step_ms})
        self._perf_rounds += 1
        if self._perf_rounds % led.interval == 0:
            from ..monitor import perfledger as _perfledger

            _perfledger.record_engine(self, ledger=led)

    def _step_inner(self):
        with torch.no_grad():
            _fp.failpoint("serving/step")
            if self._paged_active():
                # cold-page sweep on the step cadence
                self._pool.sweep()
            self._step_no += 1
            before = set(self._finished)
            self._expire_deadlines()
            if self._async and self._draft is None and not self._paged:
                self._step_async()
            else:
                self._step_sync()
        return [self._finished[r] for r in set(self._finished) - before]

    def _step_sync(self):
        self._advance_and_admit()
        active = self._active()
        self._note_occupancy(active)
        if not active:
            return
        # a speculative round: every active slot greedy AND spec_k + 1
        # columns of headroom
        if (self._draft is not None
                and all(self._temps[s] == 0 for s in active)
                and all(int(self._pos[s]) + self._spec_k + 1 <= self.T
                        for s in active)):
            self._step_speculative(active)
            return
        t0_ns = time.perf_counter_ns()
        if self._draft is not None:
            # a single-token step with a draft around: mirror the fed
            # token into the draft's cache, so later rounds see an intact
            # context
            self._fwd_d(self._params_d,
                        torch.as_tensor(self._last, device=self._dev)
                        .long()[:, None],
                        torch.as_tensor(self._pos, device=self._dev).long(),
                        self._kc_d, self._vc_d)
        toks, kind = self._dispatch_decode(active)
        next_toks = toks.cpu().numpy()
        t1_ns = time.perf_counter_ns()
        self._acc_ms_value(kind, (t1_ns - t0_ns) / 1e6)
        self._apply_decode(active, next_toks, kind, t0_ns, t1_ns)

    def _step_async(self):
        """The async round: enqueue the decode of the slots active at
        entry, run the next round's chunked-prefill advances and
        admissions while the card computes, and only then read the
        tokens: the round's one host sync. The admissions' row copies are
        enqueued on the same stream after the decode, so they write the
        cache after it has read it. Each slot's tokens equal the sync
        step's; a request admitted in the window decodes from the next
        round on."""
        active = self._active()
        self._note_occupancy(active)
        am = self._async_ms
        am["rounds"] += 1
        t0_ns = time.perf_counter_ns()
        dispatched = self._dispatch_decode(active) if active else None
        t_disp_ns = time.perf_counter_ns()
        am["dispatch_ms"] += (t_disp_ns - t0_ns) / 1e6
        self._advance_and_admit()
        t_ov_ns = t1_ns = time.perf_counter_ns()
        am["overlap_ms"] += (t_ov_ns - t_disp_ns) / 1e6
        if dispatched is not None:
            toks, kind = dispatched
            next_toks = toks.cpu().numpy()   # the round's one host sync
            t1_ns = time.perf_counter_ns()
            am["fetch_ms"] += (t1_ns - t_ov_ns) / 1e6
            # the kind's slice is the dispatch and fetch windows; the
            # overlapped admissions book their own kinds
            self._acc_ms_value(
                kind, (t_disp_ns - t0_ns + t1_ns - t_ov_ns) / 1e6)
            self._apply_decode(active, next_toks, kind, t0_ns, t1_ns)
        if _trace._ENABLED[0]:
            _trace.emit("dispatch/decode", t0_ns, t_disp_ns,
                        subsystem="serving", slots=len(active))
            _trace.emit("dispatch/overlap", t_disp_ns, t_ov_ns,
                        subsystem="serving")
            if dispatched is not None:
                _trace.emit("dispatch/fetch", t_ov_ns, t1_ns,
                            subsystem="serving")

    def _step_speculative(self, active):
        """One speculative round for the active (greedy) slots: spec_k
        draft proposals a slot, one batched (spec_k + 1)-token target
        verify at per-slot positions, 1..spec_k + 1 tokens emitted a slot
        through _after_emit one at a time (so eos, length and capacity
        finish as in the single-token engine). One host read a round:
        the emitted tokens and the accepted counts together."""
        self._count_step("speculative")
        K = self._spec_k
        dev = self._dev
        t0_ns = time.perf_counter_ns()
        last = torch.as_tensor(self._last, device=dev).long()
        pos = torch.as_tensor(self._pos, device=dev).long()
        pd = self._params_d

        def propose():
            d_cur = last
            props = []
            for j in range(K):
                xd = self._fwd_d(pd, d_cur[:, None], pos + j, self._kc_d,
                                 self._vc_d)
                d_cur = torch.argmax(self._logits_d(pd, xd[:, 0]).float(),
                                     -1)
                props.append(d_cur)
            # the K-th proposal's KV too: an all-accepted round continues
            # past that column
            self._fwd_d(pd, d_cur[:, None], pos + K, self._kc_d, self._vc_d)
            return torch.stack(props, dim=1)                     # [B, K]

        def verify(props):
            seq = torch.cat([last[:, None], props], dim=1)
            x = self._fwd(self._params, seq, pos, self._kc, self._vc)
            preds = torch.argmax(self._logits_of(self._params, x).float(),
                                 -1)
            m = torch.cumprod((props == preds[:, :K]).long(), dim=1).sum(1)
            fix = preds.gather(1, m[:, None])
            j_idx = torch.arange(K + 1, device=dev)[None]
            emit = torch.where(j_idx < m[:, None],
                               torch.nn.functional.pad(props, (0, 1)), fix)
            return torch.cat([emit, m[:, None]], dim=1)

        t_draft = [t0_ns]

        def round_():
            props = propose()
            t_draft[0] = time.perf_counter_ns()
            return verify(props)

        host = self._costed("speculative", (self.B, K),
                            round_).cpu().numpy()
        t_draft_ns = t_draft[0]
        t1_ns = time.perf_counter_ns()
        self._acc_ms_value("speculative", (t1_ns - t0_ns) / 1e6)
        if _trace._ENABLED[0]:
            _trace.emit("spec_draft", t0_ns, t_draft_ns,
                        subsystem="serving", slots=len(active), k=K)
            _trace.emit("spec_verify", t_draft_ns, t1_ns,
                        subsystem="serving", slots=len(active))
        emit, m = host[:, :K + 1], host[:, K + 1]
        proposed = K * len(active)
        accepted = int(sum(int(m[s]) for s in active))
        self._m["spec_proposed"] += proposed
        self._m["spec_accepted"] += accepted
        _SPEC.labels(event="proposed").inc(proposed)
        _SPEC.labels(event="accepted").inc(accepted)
        for s in active:
            req = self._slot_req[s]
            try:
                _fp.failpoint("serving/slot")
                toks = emit[s, :int(m[s]) + 1]
                old_pos = int(self._pos[s])
                self._last[s] = int(toks[-1])
                if req._span is not None:
                    _trace.emit("decode", t0_ns, t1_ns,
                                subsystem="serving", parent=req._span,
                                slot=s, pos=old_pos, kind="speculative",
                                accepted=int(m[s]), emitted=len(toks))
                for i, t in enumerate(toks):
                    # pos advances per token, so _after_emit decides at
                    # the state the single-token engine would have
                    self._pos[s] = old_pos + i + 1
                    req.output_ids.append(int(t))
                    self._after_emit(s, req)
                    if req.finished:
                        break
            except Exception:
                if self._slot_req[s] is not None:
                    self._finish_req(req, "error", slot=s)
                self._note_error()

    def has_work(self):
        return bool(self._queue) or bool(self._handoff) \
            or any(r is not None for r in self._slot_req)

    def run_until_complete(self, max_steps=100_000):
        """Step until nothing is queued or in flight; returns {rid:
        Request}. Past `max_steps` every request still in flight finishes
        with reason "engine_stalled" and a RuntimeError names them (and,
        with the recorder on, the dump bundle written first)."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                stalled = []
                # the dump captures the wedge's live state; the finishes
                # below rewrite it, so write the bundle FIRST
                dump_path = None
                if _blackbox.is_enabled():
                    dump_path = _blackbox.dump(
                        "stall", site="serving/step",
                        extra={"trigger": "run_until_complete",
                               "max_steps": max_steps})
                for req in list(self._queue):
                    self._queue.remove(req)
                    self._finish_req(req, "engine_stalled")
                    stalled.append(req.rid)
                for entry in list(self._handoff):
                    self._handoff.remove(entry)
                    self._finish_req(entry[0], "engine_stalled")
                    stalled.append(entry[0].rid)
                for slot in range(self.B):
                    req = self._slot_req[slot]
                    if req is not None:
                        self._finish_req(req, "engine_stalled", slot=slot)
                        stalled.append(req.rid)
                raise RuntimeError(
                    "serving engine did not converge within "
                    f"{max_steps} steps; failed in-flight requests "
                    f"{sorted(set(stalled))} with reason='engine_stalled'"
                    + (f"; blackbox dump bundle: {dump_path}"
                       if dump_path else ""))
        return dict(self._finished)
