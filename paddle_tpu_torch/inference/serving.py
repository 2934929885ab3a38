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
- ``FLAGS_paged_kv`` (read at construction): the dense
  ``[max_batch, max_seq]`` cache becomes the block pool of
  serving/paging.py. Each decode step gathers the pool through the block
  tables into the dense layout, runs the same decode math and writes each
  row's new column back, so the paged engine's tokens are the dense
  engine's. It serves base requests only (the reference's base requests
  add an exact-zero adapter delta).

The engine runs on its model's device (``cuda`` unless the model was
built with ``device="cpu"``) and updates its caches in place. The
reference compiles its programs and pads prompts to ``prompt_buckets``;
here prompts and chunks are prefilled at their own length (the junk
columns the padding writes are causally hidden, so the tokens are the
same), and ``prompt_buckets`` is validated as the reference validates it.
Not ported, each raising ``NotImplementedError``: ``tp_mesh``,
``draft_model``, ``cache_dtype``, ``max_adapters``/``lora_rank`` > 0,
``load_adapter``, ``evict_adapter``, ``submit(adapter=)``, ``hot_swap``,
``admit_prefilled`` and ``warmup``. Not ported at all: the reference's
``FLAGS_async_dispatch`` step, monitor counters, trace spans, blackbox
recorder, failpoints, perf ledger, AOT cache, weight lineage and
``stats()["breakdown"]``.
"""
import time

import numpy as np
import torch

from .. import flags as _flags
from ..serving import decode_model as _dm_registry
from ..serving import paging as _paging

__all__ = ["ServingEngine", "Request", "QueueFullError"]


class QueueFullError(RuntimeError):
    """submit() rejected: the bounded admission queue is full and the
    request's priority does not outrank any queued entry."""


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet")


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
                 prefix_len=0, deadline_ms=None, priority=0):
        self.rid = rid
        self.prompt_ids = np.asarray(prompt_ids, np.int32).ravel()
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = rid if seed is None else int(seed)
        self.prefix_id = prefix_id          # registered shared prefix, or
        self.prefix_len = int(prefix_len)   # 0 = no prefix reuse
        self.deadline_ms = deadline_ms      # None = no deadline
        self.priority = int(priority)       # higher outranks on a full queue
        self.output_ids = []                # generated tokens, no prompt
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
               "finish_reason": self.finish_reason,
               "prompt_tokens": int(len(self.prompt_ids)),
               "prefix_tokens": self.prefix_len,
               "new_tokens": len(self.output_ids)}
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
        if draft_model is not None:
            _not_ported("speculative continuous batching (draft_model=)")
        if max_adapters or lora_rank:
            _not_ported("multi-LoRA serving (max_adapters=, lora_rank=)")
        self._buckets = tuple(sorted(b for b in prompt_buckets
                                     if b <= self.T))
        if not self._buckets:
            raise ValueError("no prompt bucket fits max_seq_len")
        params, dm_aux = dm.extract_params(model, "the model")
        self._compute_dtype = dm.compute_dtype(dtype)
        if self._compute_dtype is not None:
            params = {k: (v.to(self._compute_dtype)
                          if v.is_floating_point() else v)
                      for k, v in params.items()}
        self._params = params
        self._dev = next(iter(params.values())).device
        self._fwd, self._logits_of, self._cache_init = dm.decode_fns(
            cfg, dm_aux, cache_dtype=cache_dtype)
        self._cache_dt = self._compute_dtype or torch.float32

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
        else:
            self._pool = None
            self._kc, self._vc = self._cache_init(self.B, self.T,
                                                  self._cache_dt, self._dev)

        self._chunk = None if prefill_chunk is None else int(prefill_chunk)
        # slot -> [req, kc1, vc1, consumed_offset, chunk_width]
        self._prefilling = {}
        # registered shared prefixes: pid -> (ids, kc1, vc1); paged
        # engines keep the KV in the pool (kc1 = vc1 = None)
        self._prefixes = {}
        self._next_pid = 0

        # engine-local accounting for stats()
        self._m = {"submitted": 0, "finished": {}, "tokens": 0,
                   "steps": {}, "prefix_hit": 0, "prefix_miss": 0,
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
        self._next_rid = 0
        self._finished = {}
        self._draining = False
        self._deadline_live = 0   # unfinished requests carrying deadline_ms
        self._step_no = 0
        self._last_error_step = None

    # -- the decode math ----------------------------------------------------
    def _cache_row(self):
        return self._cache_init(1, self.T, self._cache_dt, self._dev)

    def _prefill_cols(self, ids, offset, kc1, vc1):
        """Run `ids` at columns offset.. of a single-row cache (written in
        place); returns the hidden state of the last token [1, h]."""
        toks = torch.as_tensor(np.asarray(ids, np.int64)[None],
                               device=self._dev)
        return self._fwd(self._params, toks, int(offset), kc1, vc1)[:, -1]

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
        private at admission)."""
        if adapter is not None:
            _not_ported("register_prefix(adapter=) (multi-LoRA serving)")
        ids = _as_ids(prefix_ids)
        if len(ids) == 0:
            raise ValueError("empty prefix")
        if len(ids) + 2 > self.T:
            raise ValueError(
                f"prefix ({len(ids)}) too long for max_seq_len {self.T}")
        kc1, vc1 = self._cache_row()
        self._prefill_cols(ids, 0, kc1, vc1)
        pid = self._next_pid
        self._next_pid += 1
        if self._paged:
            # may raise PagePoolFullError: nothing is registered then
            self._pool.put_prefix(pid, kc1[:, 0], vc1[:, 0], len(ids))
            self._prefixes[pid] = (ids, None, None)
        else:
            self._prefixes[pid] = (ids, kc1, vc1)
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
        _not_ported("warmup() (the reference's AOT program cache)")

    def admit_prefilled(self, prompt_ids, kv_row, logits, max_new_tokens=32,
                        **kwargs):
        _not_ported("admit_prefilled() (prefill/decode disaggregation)")

    def load_adapter(self, name, exported, pin=False):
        _not_ported("load_adapter() (multi-LoRA serving)")

    def evict_adapter(self, name):
        _not_ported("evict_adapter() (multi-LoRA serving)")

    def hot_swap(self, model, decode_model=None):
        _not_ported("hot_swap()")

    def _count_step(self, kind):
        self._m["steps"][kind] = self._m["steps"].get(kind, 0) + 1

    def stats(self):
        """Engine-lifetime snapshot from host-side accounting: requests by
        outcome, tokens, steps by kind, average batch occupancy, prefix
        hits, queue-wait / TTFT / inter-token summaries, health, and on a
        paged engine the pool's ``paging`` block."""
        m = self._m
        occ = (m["occupancy_sum"] / m["occupancy_steps"]
               if m["occupancy_steps"] else 0.0)
        prefix_n = m["prefix_hit"] + m["prefix_miss"]
        out = {
            "slots": self.B,
            "requests": {"submitted": m["submitted"],
                         "queued": len(self._queue),
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
            "queue_wait_ms": m["queue_wait_ms"].to_dict(),
            "ttft_ms": m["ttft_ms"].to_dict(),
            "inter_token_ms": m["inter_token_ms"].to_dict(),
            "health": self.health(),
        }
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
            out["paging"] = pg
        return out

    def get_request(self, rid):
        """The Request of a submitted id — queued, in flight or finished.
        Raises KeyError for an unknown id."""
        for req in self._queue:
            if req.rid == rid:
                return req
        for req in self._slot_req:
            if req is not None and req.rid == rid:
                return req
        if rid in self._finished:
            return self._finished[rid]
        raise KeyError(f"unknown request id {rid}")

    def _validate_decode_args(self, ids, max_new_tokens, temperature,
                              deadline_ms, top_k, top_p, seed):
        """submit()'s argument validation; returns the int seed (None
        stays None)."""
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

    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               top_k=None, top_p=None, seed=None, prefix_id=None,
               deadline_ms=None, priority=0, adapter=None):
        """Queue a prompt; returns the request id. temperature=0 (the
        default) decodes greedily; temperature > 0 samples (optionally
        top_k- and/or top_p-truncated) from a per-request stream (seed
        defaults to the request id).

        deadline_ms: wall-clock budget from submit; an overdue request
        finishes with reason "deadline" at the next step(). priority: on a
        FULL bounded queue (max_queue=) a strictly higher-priority arrival
        sheds the lowest-priority queued request (reason "shed");
        otherwise submit raises QueueFullError."""
        if self._draining:
            raise RuntimeError(
                "ServingEngine is draining — not accepting new requests "
                "(in-flight work runs to completion; see drain())")
        if adapter is not None:
            _not_ported("submit(adapter=) (multi-LoRA serving)")
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
                and len(self._queue) >= self._max_queue:
            # shed the lowest-priority queued request (the newest among
            # ties: it has waited least) iff the arrival outranks it
            victim_idx = None
            for i, r in enumerate(self._queue):
                if victim_idx is None \
                        or r.priority <= self._queue[victim_idx].priority:
                    victim_idx = i
            if victim_idx is not None \
                    and self._queue[victim_idx].priority < priority:
                self._finish_req(self._queue.pop(victim_idx), "shed")
            else:
                raise QueueFullError(
                    f"admission queue full ({len(self._queue)} queued / "
                    f"{self._max_queue}); request rejected — retry later "
                    "or submit with a higher priority")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, ids, max_new_tokens, temperature=temperature,
                      top_k=top_k, top_p=top_p, seed=seed,
                      prefix_id=prefix_id, prefix_len=prefix_len,
                      deadline_ms=deadline_ms, priority=priority)
        req.submit_time = time.perf_counter()
        if deadline_ms is not None:
            self._deadline_live += 1
        self._m["submitted"] += 1
        self._queue.append(req)
        return rid

    def _bucket(self, n):
        for b in self._buckets:
            if n <= b:
                return b
        return self.T

    def _finish_req(self, req, reason, slot=None):
        """Terminal transition of a request wherever it lives; with `slot`
        it also frees the slot, its prefill in flight and (paged) its
        frames. A freed dense row needs no scrubbing: the next admission's
        row copy overwrites it."""
        req.finished = True
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        if req.deadline_ms is not None:
            self._deadline_live -= 1
        self._m["finished"][reason] = self._m["finished"].get(reason, 0) + 1
        self._finished[req.rid] = req
        if slot is not None:
            self._slot_req[slot] = None
            self._prefilling.pop(slot, None)
            if self._paged:
                self._pool.free_slot(slot)

    def _finish(self, slot, reason):
        self._finish_req(self._slot_req[slot], reason, slot=slot)

    def _note_error(self):
        self._last_error_step = self._step_no

    def cancel(self, rid):
        """Cancel a queued or in-flight request: it finishes at once with
        reason "cancelled" and frees its slot. Returns True if cancelled,
        False if it had already finished; KeyError for an unknown id."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(i)
                self._finish_req(req, "cancelled")
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
        at >= 80% depth, else "ok"."""
        depth = len(self._queue)
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
        for slot in range(self.B):
            req = self._slot_req[slot]
            if req is not None and overdue(req):
                self._finish_req(req, "deadline", slot=slot)

    # -- admission ----------------------------------------------------------
    def _activate(self, slot, req, kc1, vc1, x_last):
        """Admission tail: copy the single-row cache into the slot and emit
        the first generated token through the standard pick."""
        n = len(req.prompt_ids)
        if self._paged:
            # the row goes into the slot's reserved PRIVATE frames
            self._pool.admit_row(slot, kc1[:, 0], vc1[:, 0])
        else:
            self._kc[:, slot] = kc1[:, 0]
            self._vc[:, slot] = vc1[:, 0]
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
        tok = int(self._pick(self._logits1(x_last)[None], rows,
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

    def _admit_one(self, slot, req):
        if self._paged:
            return self._admit_one_paged(slot, req)
        prefix_len = req.prefix_len
        n = len(req.prompt_ids)
        if prefix_len and req.prefix_id not in self._prefixes:
            # prefix unregistered while this request sat in the queue: the
            # combined prompt is already in prompt_ids — whole-prefill it
            prefix_len = 0
        self._note_admission(req)
        if prefix_len:
            # suffix-only prefill from a COPY of the prefix's KV (each
            # admission writes its suffix into its own copy); chunk width
            # the engine's prefill_chunk or a default for prefix users
            C = self._chunk or min(64, self.T)
            end = prefix_len + -(-(n - prefix_len) // C) * C
            if end <= self.T:
                self._m["prefix_hit"] += 1
                _, kc_p, vc_p = self._prefixes[req.prefix_id]
                self._slot_req[slot] = req
                self._prefilling[slot] = [req, kc_p.clone(), vc_p.clone(),
                                          prefix_len, C]
                return
            # else: whole-prompt prefill (the reference's chunk schedule
            # would write past max_seq_len)
        if req.prefix_len:   # wanted prefix reuse, got a full recompute
            self._m["prefix_miss"] += 1
        n_chunks_end = 0 if self._chunk is None else \
            -(-n // self._chunk) * self._chunk
        if self._chunk is not None and n_chunks_end <= self.T:
            # chunked admission: reserve the slot, consume the prompt one
            # chunk a step() so running decodes go on in between
            self._slot_req[slot] = req
            self._prefilling[slot] = [req, *self._cache_row(), 0,
                                      self._chunk]
            return
        kc1, vc1 = self._cache_row()
        x_last = self._prefill_cols(req.prompt_ids, 0, kc1, vc1)
        self._activate(slot, req, kc1, vc1, x_last)

    def _admit_one_paged(self, slot, req):
        """Reserve the session's WHOLE block budget first — a pool that
        cannot cover it raises PagePoolFullError before any prefill or
        state change (the caller requeues the request). A registered
        prefix maps its full blocks shared; then one whole-prompt prefill
        and _activate copies the row into the private frames."""
        n = len(req.prompt_ids)
        shared = ()
        prefix_len = req.prefix_len
        if prefix_len and req.prefix_id in self._prefixes:
            # may raise PagePoolFullError while bringing cold pages back —
            # before reserve(), so backpressure changes nothing
            shared = self._pool.prefix_frames(req.prefix_id)
        self._pool.reserve(slot, min(self.T, n + req.max_new_tokens),
                           shared_frames=shared)
        if prefix_len:   # counted once the reservation holds
            ev = "hit" if shared else "miss"
            self._m[f"prefix_{ev}"] += 1
        self._note_admission(req)
        kc1, vc1 = self._cache_row()
        x_last = self._prefill_cols(req.prompt_ids, 0, kc1, vc1)
        self._activate(slot, req, kc1, vc1, x_last)

    def _advance_prefill(self, slot):
        """Consume one chunk of a reserved slot's prompt; on the last
        chunk, activate the slot."""
        req, kc1, vc1, off, C = self._prefilling[slot]
        self._count_step("prefill_chunk")
        n = len(req.prompt_ids)
        end = min(off + C, n)
        x_last = self._prefill_cols(req.prompt_ids[off:end], off, kc1, vc1)
        if end >= n:
            del self._prefilling[slot]
            self._slot_req[slot] = None   # _activate re-binds
            self._activate(slot, req, kc1, vc1, x_last)
        else:
            self._prefilling[slot] = [req, kc1, vc1, end, C]

    def _advance_and_admit(self):
        """Advance every chunked prefill in flight ONE chunk, then admit
        queued requests into free slots. A failing request finishes with
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
            # next queued request in the same pass
            while self._slot_req[slot] is None and self._queue:
                req = self._queue.pop(0)
                try:
                    self._admit_one(slot, req)
                except _paging.PagePoolFullError:
                    # backpressure, not a failure: nothing ran and nothing
                    # was reserved; finishing sessions free frames
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
        """ONE decode for every slot at its own position (inactive rows
        ride along: their rows are don't-care until the next admission);
        returns the host tokens [B]."""
        sampled = [s for s in active if self._temps[s] > 0]
        kind = "decode_sample" if sampled else "decode_greedy"
        last = torch.as_tensor(self._last, device=self._dev).long()
        pos = torch.as_tensor(self._pos, device=self._dev).long()
        p = self._params
        if self._paged:
            pool = self._pool
            tables = pool.tables_device()
            kc, vc = _paging.gather_dense(pool.kp, pool.vp, tables)
            x = self._fwd(p, last[:, None], pos, kc, vc)
            _paging.scatter_cols(pool.kp, pool.vp, kc, vc, tables, pos)
        else:
            x = self._fwd(p, last[:, None], pos, self._kc, self._vc)
        logits = self._logits_of(p, x[:, 0]).float()
        toks = self._pick(logits, sampled, self._temps, self._topk,
                          self._topp, self._seeds, self._pos)
        self._count_step(kind)
        return toks.cpu().numpy()

    def _apply_decode(self, active, next_toks):
        for s in active:
            req = self._slot_req[s]
            try:
                self._pos[s] += 1
                self._last[s] = next_toks[s]
                req.output_ids.append(int(next_toks[s]))
                self._after_emit(s, req)
            except Exception:
                if self._slot_req[s] is not None:
                    self._finish_req(req, "error", slot=s)
                self._note_error()

    def _after_emit(self, slot, req):
        now = time.perf_counter()
        gap_ms = req._note_token(now)
        self._m["tokens"] += 1
        if gap_ms is None:  # first generated token: TTFT
            self._m["ttft_ms"].add((now - req.submit_time) * 1e3)
        else:
            self._m["inter_token_ms"].add(gap_ms)
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

    def step(self):
        """Advance chunked prefills, admit queued requests into free slots,
        then run ONE decode step for every active slot. Returns the
        requests finished in this step. Host-side per-slot failures finish
        only that slot's request (reason "error"); a failure of the
        batched decode itself propagates."""
        with torch.no_grad():
            if self._paged_active():
                # cold-page sweep on the step cadence
                self._pool.sweep()
            self._step_no += 1
            before = set(self._finished)
            self._expire_deadlines()
            self._advance_and_admit()
            active = [s for s in range(self.B)
                      if self._slot_req[s] is not None
                      and s not in self._prefilling]
            self._m["occupancy_sum"] += len(active)
            self._m["occupancy_steps"] += 1
            if active:
                self._apply_decode(active, self._dispatch_decode(active))
        return [self._finished[r] for r in set(self._finished) - before]

    def has_work(self):
        return bool(self._queue) or any(r is not None
                                        for r in self._slot_req)

    def run_until_complete(self, max_steps=100_000):
        """Step until nothing is queued or in flight; returns {rid:
        Request}. Past `max_steps` every request still in flight finishes
        with reason "engine_stalled" and a RuntimeError names them."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                stalled = []
                for req in list(self._queue):
                    self._queue.remove(req)
                    self._finish_req(req, "engine_stalled")
                    stalled.append(req.rid)
                for slot in range(self.B):
                    req = self._slot_req[slot]
                    if req is not None:
                        self._finish_req(req, "engine_stalled", slot=slot)
                        stalled.append(req.rid)
                raise RuntimeError(
                    "serving engine did not converge within "
                    f"{max_steps} steps; failed in-flight requests "
                    f"{sorted(set(stalled))} with reason='engine_stalled'")
        return dict(self._finished)
