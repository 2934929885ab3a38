"""The port's continuous-batching engine (paddle_tpu_torch/inference/
serving.py, on serving/paging.py's pool under FLAGS_paged_kv) against the
JAX package's (paddle_tpu/inference/serving.py) on the CPU, on the
reference's test config (vocab 256, hidden 64, 2 layers, 4 heads,
max_seq 128, fp32), the weights carried across with params_from_jax.

Greedy tokens must be EQUAL to the JAX engine's and to the port's solo
``generate`` (the reference's own bar); stats() counts equal the JAX
engine's for the same drive; the per-row-position decode math within
1e-5 of the JAX package's (fp32: summation order only). Sampled tokens
come from another generator than JAX's, so they are held by determinism,
by their truncation sets, and by top_k=1 / a tiny top_p equalling greedy.
The JAX engines run once per module (compiles dominate their cost).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import QueueFullError, ServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.serving import decode_model

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
INTERLEAVED = (5, 9, 17, 3, 26)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}))
    return jm, tm.eval()


@pytest.fixture
def paged():
    """FLAGS_paged_kv armed in both packages for the test, then restored."""
    old = (pt.get_flag("paged_kv"), paddle.get_flags(["paged_kv"]))
    pt.set_flags({"paged_kv": True})
    paddle.set_flags({"paged_kv": True})
    yield
    pt.set_flags({"paged_kv": old[0]})
    paddle.set_flags({"paged_kv": old[1].get("paged_kv", False)})


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (n,)).astype(np.int32) for n in lens]


def _ref(tm, prompt, n):
    """The port's solo greedy generate: the new tokens."""
    out = tm.generate(torch.from_numpy(np.asarray(prompt)[None]).long(),
                      max_new_tokens=n, temperature=0.0)
    return out[0, len(prompt):].tolist()


def _drain(eng, jobs):
    rids = [eng.submit(p, **kw) for p, kw in jobs]
    res = eng.run_until_complete()
    return [[int(t) for t in res[r].output_ids] for r in rids]


def _stats_drive(E, m):
    """A drive touching every counted path: chunked prefill, a prefix hit
    and a miss (near capacity), greedy and sampled steps, length and
    capacity finishes. Returns the engine."""
    eng = E(m, max_batch=2, prefill_chunk=16)
    pre = _prompts([20], seed=5)[0]
    pid = eng.register_prefix(pre)
    p = _prompts([7, 40, 120, 3], seed=6)
    eng.submit(p[0], max_new_tokens=6)
    eng.submit(p[1], max_new_tokens=5, prefix_id=pid)        # hit
    eng.submit(p[3], max_new_tokens=4, temperature=0.9, seed=3)
    eng.submit(p[2][:100], max_new_tokens=4, prefix_id=pid)  # miss
    eng.submit(p[2], max_new_tokens=50)                      # capacity
    eng.run_until_complete()
    return eng


def _robust_drive(E, m):
    """Shedding, a full queue, cancellation and a deadline. Returns
    ({rid: finish reason}, whether the full queue raised)."""
    eng = E(m, max_batch=1, max_queue=2)
    p = _prompts([4, 5, 6, 7, 8], seed=7)
    r0 = eng.submit(p[0], max_new_tokens=3)
    eng.step()                                   # r0 admitted
    r1 = eng.submit(p[1], max_new_tokens=3)
    r2 = eng.submit(p[2], max_new_tokens=3)
    r3 = eng.submit(p[3], max_new_tokens=3, priority=1)      # sheds r2
    try:
        eng.submit(p[4], max_new_tokens=3)
        full = False
    except Exception as e:
        full = type(e).__name__ == "QueueFullError"
    eng.cancel(r1)
    r4 = eng.submit(p[4], max_new_tokens=3, deadline_ms=1e-3)
    eng.run_until_complete()
    return ({r: eng.get_request(r).finish_reason
             for r in (r0, r1, r2, r3, r4)}, full)


def _paged_jobs():
    out = []
    for i, p in enumerate([[3, 14, 15, 9, 2, 6], [7, 1, 19],
                           [21, 22, 23, 24], list(range(30, 70))]):
        kw = dict(max_new_tokens=6 if i < 3 else 40)
        if i == 2:
            kw.update(temperature=0.8, top_k=16, seed=11)
        out.append((p, kw))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every JAX engine drive of this module, run once."""
    jm, _ = models
    out = {}
    eng = JEngine(jm, max_batch=3)
    out["interleaved"] = _drain(eng, [(p, dict(max_new_tokens=12))
                                      for p in _prompts(INTERLEAVED)])
    out["stats"] = _stats_drive(JEngine, jm).stats()
    out["robust"] = _robust_drive(JEngine, jm)
    old = paddle.get_flags(["paged_kv"]).get("paged_kv", False)
    paddle.set_flags({"paged_kv": True})
    try:
        eng = JEngine(jm, max_batch=4)
        out["paged"] = _drain(eng, _paged_jobs())
        out["paged_stats"] = eng.stats()["paging"]
        eng = JEngine(jm, max_batch=2, page_block=8)
        pid = eng.register_prefix(_prompts([21], seed=8)[0])
        out["paged_prefix"] = _drain(eng, [
            (s, dict(max_new_tokens=5, prefix_id=pid))
            for s in _prompts([4, 9, 6], seed=9)])
        out["paged_prefix_stats"] = (eng.stats()["prefix_cache"],
                                     eng.stats()["paging"])
    finally:
        paddle.set_flags({"paged_kv": old})
    return out


class TestParity:
    def test_interleaved_requests_match_jax_engine_and_generate(
            self, models, jax_runs):
        _, tm = models
        prompts = _prompts(INTERLEAVED)
        eng = ServingEngine(tm, max_batch=3)
        got = _drain(eng, [(p, dict(max_new_tokens=12)) for p in prompts])
        assert got == jax_runs["interleaved"]
        assert got == [_ref(tm, p, 12) for p in prompts]
        assert eng.stats()["requests"]["finished"] == {"length": 5}

    def test_staggered_submission_mid_stream(self, models):
        _, tm = models
        p1, p2 = _prompts([6, 11], seed=1)
        eng = ServingEngine(tm, max_batch=2)
        r1 = eng.submit(p1, max_new_tokens=10)
        for _ in range(4):
            eng.step()                      # p1 is 4+ tokens in
        r2 = eng.submit(p2, max_new_tokens=10)
        res = eng.run_until_complete()
        assert res[r1].tokens.tolist() == _ref(tm, p1, 10)
        assert res[r2].tokens.tolist() == _ref(tm, p2, 10)

    def test_decode_fns_per_row_pos_match_jax(self, models):
        """One decode step of the per-row-position math (each row at its
        own cache column) against the JAX package's on the same cache."""
        from paddle_tpu.models.gpt import _decode_fns as jdecode_fns

        jm, tm = models
        cfg = tm.cfg
        L, H, hd, T = cfg.num_layers, cfg.num_heads, 16, cfg.max_seq_len
        rng = np.random.RandomState(2)
        kc = rng.randn(L, 4, H, T, hd).astype(np.float32)
        vc = rng.randn(L, 4, H, T, hd).astype(np.float32)
        toks = rng.randint(0, 256, (4, 1)).astype(np.int32)
        pos = np.array([3, 10, 0, 127], np.int32)
        jfwd, jlogits, _ = jdecode_fns(jm.cfg, False, False)
        jp = {n: p._data for n, p in jm.named_parameters()}
        jx, jkc, jvc = jfwd(jp, *(jnp.asarray(a)
                                  for a in (toks, pos, kc, vc)))
        fwd, logits_of, _ = pgpt._decode_fns(cfg)
        tp = {n: p.detach() for n, p in tm.named_parameters()}
        tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        with torch.no_grad():
            x = fwd(tp, torch.from_numpy(toks).long(),
                    torch.from_numpy(pos).long(), tkc, tvc)
            lg = logits_of(tp, x[:, 0])
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(lg.numpy(),
                                   np.asarray(jlogits(jp, jx[:, 0])),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), atol=1e-5,
                                   rtol=0)

    def test_scalar_pos_path_keeps_its_results(self, models):
        """A scalar pos and the same pos for every row give the same
        hidden states and cache (the per-row path is a generalisation)."""
        _, tm = models
        fwd, _, cache_init = pgpt._decode_fns(tm.cfg)
        tp = {n: p.detach() for n, p in tm.named_parameters()}
        toks = torch.tensor([[5], [17]])
        a, b = cache_init(2, 128, torch.float32, "cpu"), \
            cache_init(2, 128, torch.float32, "cpu")
        with torch.no_grad():
            xa = fwd(tp, toks, 9, *a)
            xb = fwd(tp, toks, torch.tensor([9, 9]), *b)
        assert torch.equal(xa, xb)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


class TestChunkedAndPrefix:
    @pytest.mark.parametrize("chunk,plen", [(16, 50), (7, 23), (32, 9),
                                            (96, 100)])
    def test_chunked_matches_unchunked(self, models, chunk, plen):
        # (96, 100): the final chunk would cross max_seq_len: the
        # reference's whole-prefill fallback
        _, tm = models
        p = _prompts([plen], seed=3)[0]
        eng = ServingEngine(tm, max_batch=2, prefill_chunk=chunk)
        assert _drain(eng, [(p, dict(max_new_tokens=8))]) == \
            [_ref(tm, p, 8)]
        n_chunks = eng.stats()["steps"].get("prefill_chunk", 0)
        assert n_chunks == (0 if chunk == 96 else -(-plen // chunk))

    def test_decode_interleaves_with_long_prefill(self, models):
        _, tm = models
        p_short, p_long = _prompts([5, 60], seed=4)
        eng = ServingEngine(tm, max_batch=2, prefill_chunk=16)
        r_s = eng.submit(p_short, max_new_tokens=20)
        eng.step()
        short_req = eng.get_request(r_s)
        r_l = eng.submit(p_long, max_new_tokens=4)
        counts = []
        for _ in range(3):
            eng.step()
            counts.append(len(short_req.output_ids))
        assert counts == [counts[0], counts[0] + 1, counts[0] + 2]
        res = eng.run_until_complete()
        assert res[r_s].tokens.tolist() == _ref(tm, p_short, 20)
        assert res[r_l].tokens.tolist() == _ref(tm, p_long, 4)

    def test_prefix_cached_requests_match_full_prompt_twice(self, models):
        """Two requests on one prefix in a row: each admission writes its
        suffix into its own copy of the prefix's KV."""
        _, tm = models
        prefix, *sufs = _prompts([20, 5, 11, 30, 7], seed=10)
        eng = ServingEngine(tm, max_batch=2)
        pid = eng.register_prefix(prefix)
        got = _drain(eng, [(s, dict(max_new_tokens=8, prefix_id=pid))
                           for s in sufs[:3]])
        assert got == [_ref(tm, np.concatenate([prefix, s]), 8)
                       for s in sufs[:3]]
        got = _drain(eng, [(sufs[3], dict(max_new_tokens=6,
                                          prefix_id=pid))])
        assert got == [_ref(tm, np.concatenate([prefix, sufs[3]]), 6)]
        assert eng.stats()["prefix_cache"] == {"hit": 4, "miss": 0,
                                               "hit_rate": 1.0}

    def test_prefix_near_capacity_and_unregistered_fall_back(self, models):
        _, tm = models
        prefix, s, pre2, s2 = _prompts([90, 30, 10, 4], seed=11)
        eng = ServingEngine(tm, max_batch=1)
        pid = eng.register_prefix(prefix)
        got = _drain(eng, [(s, dict(max_new_tokens=4, prefix_id=pid))])
        assert got == [_ref(tm, np.concatenate([prefix, s]), 4)]
        assert eng.stats()["prefix_cache"]["miss"] == 1
        pid2 = eng.register_prefix(pre2)
        rid = eng.submit(s2, max_new_tokens=4, prefix_id=pid2)
        eng.unregister_prefix(pid2)        # the queued request whole-prefills
        res = eng.run_until_complete()
        assert res[rid].tokens.tolist() == _ref(
            tm, np.concatenate([pre2, s2]), 4)
        with pytest.raises(ValueError, match="prefix_id"):
            eng.submit(s2, prefix_id=pid2)
        with pytest.raises(ValueError, match="prefix_id"):
            eng.unregister_prefix(pid2)
        with pytest.raises(ValueError, match="empty"):
            eng.register_prefix(np.zeros((0,), np.int32))
        with pytest.raises(ValueError, match="too long"):
            eng.register_prefix(np.zeros((127,), np.int32))


class TestSlotLifecycle:
    def test_eos_frees_slot_for_queued_request(self, models):
        _, tm = models
        p, p2 = _prompts([8, 5], seed=12)
        ref = _ref(tm, p, 3)
        eos = ref[-1]
        eng = ServingEngine(tm, max_batch=1, eos_token_id=eos)
        r1 = eng.submit(p, max_new_tokens=50)
        r2 = eng.submit(p2, max_new_tokens=6)      # waits for the slot
        res = eng.run_until_complete()
        assert res[r1].finish_reason == "eos"
        assert res[r1].tokens.tolist() == ref[:ref.index(eos) + 1]
        ref2 = _ref(tm, p2, 6)
        cut = ref2.index(eos) + 1 if eos in ref2 else 6
        assert res[r2].tokens.tolist() == ref2[:cut]

    @pytest.mark.parametrize("kv", ["dense", "paged"])
    def test_capacity_finish_while_others_decode_on(self, models, kv,
                                                    request):
        """A slot finished at "capacity" keeps pos == max_seq_len until its
        next admission, and the decode step still feeds it: its write must
        not disturb the slot decoding beside it, nor the next occupant."""
        if kv == "paged":
            request.getfixturevalue("paged")
        _, tm = models
        p_cap, p_a, p_b = _prompts([120, 6, 9], seed=13)
        eng = ServingEngine(tm, max_batch=2)
        r_cap = eng.submit(p_cap, max_new_tokens=500)
        r_a = eng.submit(p_a, max_new_tokens=30)
        r_b = eng.submit(p_b, max_new_tokens=10)   # takes the freed slot
        res = eng.run_until_complete()
        assert res[r_cap].finish_reason == "capacity"
        assert len(res[r_cap].tokens) == 128 - 120 + 1
        assert res[r_cap].tokens[:8].tolist() == _ref(tm, p_cap, 8)
        assert res[r_a].tokens.tolist() == _ref(tm, p_a, 30)
        assert res[r_b].tokens.tolist() == _ref(tm, p_b, 10)

    def test_one_token_requests_chain_through_admission(self, models):
        _, tm = models
        prompts = _prompts([4, 5, 6], seed=14)
        eng = ServingEngine(tm, max_batch=1)
        rids = [eng.submit(p, max_new_tokens=1) for p in prompts]
        eng.step()
        assert all(eng.get_request(r).finished for r in rids)
        assert [eng.get_request(r).tokens.tolist() for r in rids] == \
            [_ref(tm, p, 1) for p in prompts]

    def test_submit_errors(self, models):
        _, tm = models
        eng = ServingEngine(tm, max_batch=1)
        z = np.zeros((3,), np.int32)
        for kw, match in ((dict(prompt_ids=np.zeros((0,), np.int32)),
                           "empty"),
                          (dict(prompt_ids=np.zeros((400,), np.int32)),
                           "too long"),
                          (dict(max_new_tokens=0), "max_new_tokens"),
                          (dict(temperature=-0.1), "temperature"),
                          (dict(top_k=0), "top_k"),
                          (dict(temperature=0.5, top_p=0.0), "top_p"),
                          (dict(temperature=0.5, top_p=1.5), "top_p"),
                          (dict(temperature=0.5, seed=2 ** 31), "seed"),
                          (dict(deadline_ms=0), "deadline_ms"),
                          (dict(prefix_id=99), "prefix_id")):
            kw = {"prompt_ids": z, **kw}
            with pytest.raises(ValueError, match=match):
                eng.submit(**kw)
        with pytest.raises(KeyError):
            eng.get_request(999)


class TestRobustness:
    def test_shedding_full_queue_cancel_deadline_match_jax(self, models,
                                                           jax_runs):
        _, tm = models
        got = _robust_drive(ServingEngine, tm)
        assert got == jax_runs["robust"]
        assert got[0] == {0: "length", 1: "cancelled", 2: "shed",
                          3: "length", 4: "deadline"} and got[1]

    def test_cancel_and_health(self, models):
        _, tm = models
        p = _prompts([5, 6], seed=15)
        eng = ServingEngine(tm, max_batch=1, max_queue=1)
        r0 = eng.submit(p[0], max_new_tokens=20)
        eng.step()
        assert eng.cancel(r0) is True and eng.cancel(r0) is False
        with pytest.raises(KeyError):
            eng.cancel(99)
        assert eng.health()["state"] == "ok"
        eng.submit(p[1], max_new_tokens=3)          # queue at its bound
        assert eng.health()["state"] == "degraded"
        with pytest.raises(QueueFullError):
            eng.submit(p[1], max_new_tokens=3)
        eng.drain()
        assert eng.health()["state"] == "draining"
        with pytest.raises(RuntimeError, match="draining"):
            eng.submit(p[1])
        eng.run_until_complete()                    # in-flight work ends
        eng.drain(False)
        assert eng.health()["state"] == "ok"
        assert eng.stats()["health"]["steps"] == eng.health()["steps"]

    def test_engine_stalled_fails_in_flight_requests(self, models):
        _, tm = models
        p = _prompts([5, 6, 7], seed=16)
        eng = ServingEngine(tm, max_batch=1)
        rids = [eng.submit(q, max_new_tokens=40) for q in p]
        with pytest.raises(RuntimeError, match="engine_stalled"):
            eng.run_until_complete(max_steps=3)
        assert all(eng.get_request(r).finish_reason == "engine_stalled"
                   for r in rids)
        assert not eng.has_work()

    def test_a_failing_slot_finishes_alone_with_error(self, models,
                                                      monkeypatch):
        _, tm = models
        p_bad, p_ok = _prompts([7, 8], seed=17)
        eng = ServingEngine(tm, max_batch=2)
        real = eng._prefill_cols

        def prefill(ids, offset, kc1, vc1):
            if len(ids) == 7:
                raise RuntimeError("injected")
            return real(ids, offset, kc1, vc1)

        monkeypatch.setattr(eng, "_prefill_cols", prefill)
        r_bad = eng.submit(p_bad, max_new_tokens=5)
        r_ok = eng.submit(p_ok, max_new_tokens=5)
        res = eng.run_until_complete()
        assert res[r_bad].finish_reason == "error"
        assert res[r_ok].tokens.tolist() == _ref(tm, p_ok, 5)
        assert eng.health()["state"] == "degraded"
        assert eng.health()["errors"] == 1


class TestStats:
    def test_counts_equal_the_jax_engines(self, models, jax_runs):
        _, tm = models
        got = _stats_drive(ServingEngine, tm).stats()
        want = jax_runs["stats"]
        assert got["requests"]["submitted"] == want["requests"]["submitted"]
        assert got["requests"]["finished"] == want["requests"]["finished"]
        assert got["requests"]["finished"] == {"length": 4, "capacity": 1}
        assert got["tokens_generated"] == want["tokens_generated"]
        assert got["steps"] == want["steps"]
        assert set(got["steps"]) == {"prefill_chunk", "decode_greedy",
                                     "decode_sample"}
        assert got["prefix_cache"] == want["prefix_cache"] == {
            "hit": 1, "miss": 1, "hit_rate": 0.5}
        assert got["batch_occupancy_avg"] == want["batch_occupancy_avg"]
        for k in ("queue_wait_ms", "ttft_ms", "inter_token_ms"):
            assert got[k]["count"] == want[k]["count"]
        assert got["health"]["steps"] == want["health"]["steps"]

    def test_request_stats(self, models):
        _, tm = models
        eng = ServingEngine(tm, max_batch=2)
        rid = eng.submit(_prompts([6], seed=18)[0], max_new_tokens=4)
        eng.run_until_complete()
        st = eng.get_request(rid).stats()
        assert st["new_tokens"] == 4 and st["finish_reason"] == "length"
        assert st["ttft_ms"] > 0 and st["inter_token"]["count"] == 3


class TestSampling:
    def test_greedy_rows_unaffected_by_sampling_neighbor(self, models):
        _, tm = models
        pg, ps = _prompts([7, 9], seed=19)
        eng = ServingEngine(tm, max_batch=2)
        rg = eng.submit(pg, max_new_tokens=10)
        rs = eng.submit(ps, max_new_tokens=10, temperature=0.9)
        res = eng.run_until_complete()
        assert res[rg].tokens.tolist() == _ref(tm, pg, 10)
        assert len(res[rs].tokens) == 10
        assert eng.stats()["steps"].get("decode_sample", 0) > 0

    def test_sampling_deterministic_per_seed_and_slot(self, models):
        _, tm = models
        p, other = _prompts([6, 9], seed=20)

        def run(seed, neighbour=False):
            eng = ServingEngine(tm, max_batch=2)
            if neighbour:            # another request in slot 0
                eng.submit(other, max_new_tokens=12, temperature=0.7)
            rid = eng.submit(p, max_new_tokens=12, temperature=0.8,
                             seed=seed)
            return eng.run_until_complete()[rid].tokens.tolist()

        assert run(7) == run(7) == run(7, neighbour=True)
        assert len({tuple(run(s)) for s in (7, 8, 9, 10)}) > 1

    def test_top_k_one_and_tiny_top_p_are_greedy(self, models):
        _, tm = models
        p = _prompts([8], seed=21)[0]
        for kw in (dict(temperature=1.3, top_k=1),
                   dict(temperature=0.7, top_p=1e-9)):
            eng = ServingEngine(tm, max_batch=1)
            assert _drain(eng, [(p, dict(max_new_tokens=10, **kw))]) == \
                [_ref(tm, p, 10)]

    def test_truncation_sets(self, models):
        """A draw lies in the top-k set of its logits; top_p=1.0 is the
        no-nucleus path; a top-p draw lies in the nucleus."""
        _, tm = models
        eng = ServingEngine(tm, max_batch=4)
        g = torch.Generator().manual_seed(0)
        logits = torch.randn(4, 256, generator=g)
        pos = np.arange(4, dtype=np.int32)
        seeds = np.arange(4, dtype=np.int32)
        temps = np.full(4, 0.9, np.float32)
        ones, full = np.ones(4, np.float32), np.full(4, 256, np.int32)
        rows = [0, 1, 2, 3]
        k = np.full(4, 5, np.int32)
        for s in range(20):
            toks = eng._pick(logits, rows, temps, k, ones, seeds + s, pos)
            top5 = logits.topk(5, -1).indices
            assert all(int(toks[r]) in top5[r].tolist() for r in rows)
        a = eng._pick(logits, rows, temps, full, ones, seeds, pos)
        b = eng._pick(logits, rows, temps, full, np.full(4, 1.0, np.float32),
                      seeds, pos)
        assert torch.equal(a, b)
        p_ = np.full(4, 0.3, np.float32)
        for s in range(20):
            toks = eng._pick(logits, rows, temps, full, p_, seeds + s, pos)
            probs = torch.softmax(logits / 0.9, -1)
            srt, idx = probs.sort(-1, descending=True)
            for r in rows:
                keep = int(((srt[r].cumsum(0) - srt[r]) < 0.3).sum())
                assert int(toks[r]) in idx[r, :keep].tolist()


class TestPaged:
    def test_tokens_equal_dense_and_the_jax_paged_engine(self, models,
                                                         jax_runs, paged):
        _, tm = models
        got = _drain(ServingEngine(tm, max_batch=4), _paged_jobs())
        pt.set_flags({"paged_kv": False})
        dense = _drain(ServingEngine(tm, max_batch=4), _paged_jobs())
        pt.set_flags({"paged_kv": True})
        assert got == dense
        want = jax_runs["paged"]
        assert [got[i] for i in (0, 1, 3)] == [want[i] for i in (0, 1, 3)]

    def test_paging_stats_equal_the_references(self, models, jax_runs,
                                               paged):
        _, tm = models
        eng = ServingEngine(tm, max_batch=4)
        _drain(eng, _paged_jobs())
        # the adapter registry's block included (8 slots, none loaded)
        assert eng.stats()["paging"] == jax_runs["paged_stats"]

    def test_tiny_pool_requeues_to_bit_exact_completion(self, models,
                                                        paged):
        _, tm = models
        jobs = [([5, 6, 7], dict(max_new_tokens=20)),
                ([9, 2], dict(max_new_tokens=20)),
                ([11, 4, 8, 1], dict(max_new_tokens=20))]
        tiny = ServingEngine(tm, max_batch=4, page_blocks=5)
        assert _drain(tiny, jobs) == \
            _drain(ServingEngine(tm, max_batch=4), jobs)
        assert tiny.stats()["paging"]["free_blocks"] == 4

    def test_shared_prefix_frames_and_cow(self, models, jax_runs, paged):
        _, tm = models
        prefix = _prompts([21], seed=8)[0]
        sufs = _prompts([4, 9, 6], seed=9)
        eng = ServingEngine(tm, max_batch=2, page_block=8)
        pid = eng.register_prefix(prefix)
        assert eng.stats()["paging"]["live_blocks"] == 2    # 21 // 8
        got = _drain(eng, [(s, dict(max_new_tokens=5, prefix_id=pid))
                           for s in sufs])
        assert got == jax_runs["paged_prefix"]
        assert got == [_ref(tm, np.concatenate([prefix, s]), 5)
                       for s in sufs]
        hits, pool = jax_runs["paged_prefix_stats"]
        assert eng.stats()["prefix_cache"] == hits
        assert eng.stats()["paging"] == pool
        eng.unregister_prefix(pid)
        assert eng.stats()["paging"]["live_blocks"] == 0

    def test_cold_prefix_pages_come_back(self, models, paged):
        _, tm = models
        prefix, s = _prompts([32, 5], seed=22)
        eng = ServingEngine(tm, max_batch=1, page_block=8,
                            page_cold_steps=2)
        pid = eng.register_prefix(prefix)
        for _ in range(3):
            eng.step()                          # idle: the sweep runs
        assert eng.stats()["paging"]["cold_pages"] == 4
        got = _drain(eng, [(s, dict(max_new_tokens=4, prefix_id=pid))])
        assert eng.stats()["paging"]["cold_pages"] == 0
        assert len(got[0]) == 4

    def test_flag_rules(self, models, paged):
        _, tm = models
        for kw in (dict(cache_dtype="int8"), dict(draft_model=tm),
                   dict(prefill_chunk=16), dict(tp_mesh=object())):
            with pytest.raises(ValueError, match="paged"):
                ServingEngine(tm, max_batch=2, **kw)
        with pytest.raises(ValueError, match="page_block"):
            ServingEngine(tm, max_batch=2, page_block=7)
        eng = ServingEngine(tm, max_batch=2, page_blocks=3)
        with pytest.raises(ValueError, match="KV blocks"):
            eng.submit(list(range(2, 42)), max_new_tokens=20)
        eng = ServingEngine(tm, max_batch=2)
        eng.submit([3, 4], max_new_tokens=2)
        pt.set_flags({"paged_kv": False})
        with pytest.raises(RuntimeError, match="disarmed"):
            eng.step()

    def test_paged_kwargs_require_the_flag(self, models):
        _, tm = models
        assert not pt.get_flag("paged_kv")
        for kw in ({"page_block": 8}, {"page_blocks": 16},
                   {"max_adapters": 2}, {"lora_rank": 4},
                   {"page_cold_steps": 3}):
            with pytest.raises(ValueError, match="paged_kv"):
                ServingEngine(tm, max_batch=2, **kw)


class TestUnported:
    def test_left_out_options_raise(self, models, paged):
        """tp_mesh and warmup() are still left out; every option this
        slice ported refuses what the reference's refuses, with its
        error."""
        _, tm = models
        eng = ServingEngine(tm, max_batch=2, max_adapters=2, lora_rank=4)
        wide = {"rank": 8, "scaling": 1.0, "factors": {}}
        with pytest.raises(ValueError, match="lora_rank"):
            eng.load_adapter("a", wide)
        with pytest.raises(RuntimeError, match="paged_kv"):
            eng.admit_prefilled([1], None, None)
        pt.set_flags({"paged_kv": False})
        with pytest.raises(NotImplementedError, match="not ported"):
            ServingEngine(tm, max_batch=2, tp_mesh=object())
        with pytest.raises(ValueError, match="spec_k"):
            ServingEngine(tm, max_batch=2, draft_model=tm, spec_k=0)
        with pytest.raises(ValueError, match="cache_dtype"):
            ServingEngine(tm, max_batch=2, cache_dtype="int4")
        eng = ServingEngine(tm, max_batch=2)
        with pytest.raises(NotImplementedError, match="not ported"):
            eng.warmup()
        bad = (torch.zeros(2, 1, 4, 64, 16), torch.zeros(2, 1, 4, 64, 16))
        for call, error in (
                (lambda: eng.admit_prefilled([1], bad, torch.zeros(256)),
                 ValueError),
                (lambda: eng.load_adapter("a", {}), RuntimeError),
                (lambda: eng.evict_adapter("a"), RuntimeError),
                (lambda: eng.hot_swap(GPTForCausalLM(GPTConfig(
                    **dict(CFG, num_layers=1)), device="cpu")), ValueError),
                (lambda: eng.submit([1, 2], adapter="a"), RuntimeError),
                (lambda: eng.register_prefix([1, 2], adapter="a"),
                 ValueError)):
            with pytest.raises(error):
                call()

    def test_validation_matches_the_reference(self, models):
        _, tm = models
        for kw, match in ((dict(prefill_chunk=0), "prefill_chunk"),
                          (dict(prefill_chunk=129), "prefill_chunk"),
                          (dict(max_queue=0), "max_queue"),
                          (dict(prompt_buckets=(256,)), "no prompt bucket")):
            with pytest.raises(ValueError, match=match):
                ServingEngine(tm, max_batch=1, **kw)

    def test_decode_model_registry(self, models):
        _, tm = models
        dm = decode_model.resolve(tm)
        assert isinstance(dm, pgpt.GPTDecodeModel) and dm.name == "gpt"
        assert decode_model.get_decode_model("gpt") is dm
        assert "gpt" in decode_model.registered_decode_models()
        assert dm.cache_spec(tm.cfg)["axes"] == {"L": 2, "KVh": 4,
                                                 "T": 128, "hd": 16}
        with pytest.raises(ValueError, match="already registered"):
            decode_model.register_decode_model(pgpt.GPTDecodeModel())
        with pytest.raises(KeyError, match="no decode model"):
            decode_model.get_decode_model("nope")
        with pytest.raises(TypeError, match="no registered decode model"):
            decode_model.resolve(object())
        with pytest.raises(ValueError, match="cache_dtype"):
            dm.decode_fns(tm.cfg, None, cache_dtype="int4")
        for call in (lambda: dm.decode_fns(tm.cfg, None, tp_axis="mp"),
                     lambda: dm.tp_setup(None, tm.cfg, {})):
            with pytest.raises(NotImplementedError, match="not ported"):
                call()
        pack = dm.lora_init(tm.cfg, 2, 4)
        assert pack["qkv"]["A"].shape == (2, 2, 64, 4) and \
            not pack["fc2"]["B"].any()
        with pytest.raises(ValueError, match="lora_rank"):
            dm.lora_pack(tm.cfg, {"rank": 8, "scaling": 1.0,
                                  "factors": {}}, 4)
        kc, vc = pgpt._decode_fns(tm.cfg)[2](2, 8, torch.float32, "cpu")
        assert decode_model.cache_row_bytes((kc, vc)) == \
            2 * 2 * 2 * 4 * 8 * 16 * 4
