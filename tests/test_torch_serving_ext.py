"""The rest of the port's serving engine (paddle_tpu_torch/inference/
serving.py: multi-LoRA adapters on the paged engine, ``hot_swap`` with
weight lineage, ``admit_prefilled``, the async step; paddle_tpu_torch/
serving/disagg.py: ``PrefillWorker``, ``DisaggregatedPool``) against the
JAX package's on the CPU, on the reference's serving test config (vocab
256, hidden 64, 2 layers, 4 heads, max_seq 128, fp32), the weights and
the adapters' factors carried across.

Each drive runs the same script on both packages' engines: every greedy
request's token stream and finish reason equal the JAX engine's, and the
stats() counts both engines keep are equal. Within the port: base
requests on a LoRA engine and pool completions are bit-equal to a plain
engine's, the async step's to the sync step's. The JAX drives run once
per module.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.serving.disagg import DisaggregatedPool as JPool

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate import lora
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax
from paddle_tpu_torch.serving.disagg import DisaggregatedPool, \
    HandoffMismatch, PrefillWorker

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
COUNTS = ("requests", "tokens_generated", "steps", "prefix_cache",
          "batch_occupancy_avg")


def _pair(seed):
    paddle.seed(seed)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}))
    return jm, tm.eval()


def _export(tm, seed):
    """An adapter on all four sites, rank 4, with B drawn non-zero (std
    0.3) so that its tokens differ from the base model's."""
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    m.load_state_dict(tm.state_dict())
    lora.apply_lora(m, r=4, alpha=8,
                    generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for n, p in m.named_parameters():
            if "lora_B" in n:
                p.copy_(torch.from_numpy(
                    rng.normal(0, 0.3, p.shape).astype(np.float32)))
    return lora.export_lora(m)


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (n,)).astype(np.int32) for n in lens]


class _Flags:
    """A flag set in both packages for a block, then restored."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.old = (pt.get_flag(self.name),
                    paddle.get_flags([self.name]).get(self.name, False))
        pt.set_flags({self.name: True})
        paddle.set_flags({self.name: True})

    def __exit__(self, *exc):
        pt.set_flags({self.name: self.old[0]})
        paddle.set_flags({self.name: self.old[1]})


def _streams(eng, rids):
    return ([[int(t) for t in eng.get_request(r).output_ids] for r in rids],
            [eng.get_request(r).finish_reason for r in rids])


def _lora_drive(E, m, exps):
    """Two slots of adapters ("a" pinned, "b") on a 3-slot paged engine;
    loading "c" mid-drain evicts "b", whose sessions restart from the
    queue head and wait for "b" to come back."""
    eng = E(m, max_batch=3, max_adapters=2, lora_rank=4)
    eng.load_adapter("a", exps["a"], pin=True)
    eng.load_adapter("b", exps["b"])
    p = _prompts([6, 9, 4, 7, 5, 8], seed=11)
    pid = eng.register_prefix(_prompts([20], seed=12)[0], adapter="a")
    jobs = [(p[0], dict(adapter="a", prefix_id=pid)),
            (p[1], dict(adapter="b")), (p[2], {}),
            (p[3], dict(adapter="b")), (p[4], dict(adapter="a"))]
    rids = [eng.submit(q, max_new_tokens=7, **kw) for q, kw in jobs]
    for _ in range(3):
        eng.step()
    eng.load_adapter("c", exps["c"])          # evicts "b" (LRU, unpinned)
    mid = (sorted(eng.stats()["paging"]["adapters"]["loaded_names"]),
           [len(eng.get_request(r).output_ids) for r in rids])
    for _ in range(2):
        eng.step()
    eng.evict_adapter("c")
    eng.load_adapter("b", exps["b"])
    rids.append(eng.submit(p[5], max_new_tokens=5))
    eng.run_until_complete()
    eng.load_adapter("d", exps["c"], pin=True)  # evicts "b", never "a"
    try:
        eng.load_adapter("e", exps["c"])
        all_pinned = False
    except RuntimeError:
        all_pinned = True
    return _streams(eng, rids) + (eng.stats(), mid, all_pinned)


def _swap_drive(E, m0, m1):
    eng = E(m0, max_batch=2)
    p = _prompts([5, 8, 6], seed=21)
    rids = [eng.submit(p[0], max_new_tokens=9),
            eng.submit(p[1], max_new_tokens=9)]
    for _ in range(3):
        eng.step()
    version = eng.hot_swap(m1)
    rids.append(eng.submit(p[2], max_new_tokens=6))
    eng.run_until_complete()
    stamps = [eng.get_request(r).weight_version for r in rids]
    return _streams(eng, rids) + (
        [(v.counter, v.origin) for v in stamps + [version]],)


POOL_LENS = (5, 11, 3, 8, 6)


def _pool_drive(P, m):
    pool = P(m, prefill_workers=1, decode_engines=2, max_batch=2)
    rids = [pool.submit(q, max_new_tokens=6 + i % 3)
            for i, q in enumerate(_prompts(POOL_LENS, seed=31))]
    res = pool.run_until_complete()
    return ([[int(t) for t in res[r].output_ids] for r in rids],
            pool.stats()["pool"])


def _async_jobs():
    out = []
    for i, q in enumerate(_prompts((5, 19, 3, 12, 7), seed=41)):
        kw = dict(max_new_tokens=8 + i)
        if i == 3:
            kw.update(temperature=0.9, top_k=10, seed=2)
        out.append((q, kw))
    return out


def _async_drive(E, m):
    eng = E(m, max_batch=2, prefill_chunk=8)
    rids = [eng.submit(q, **kw) for q, kw in _async_jobs()]
    eng.run_until_complete()
    return _streams(eng, rids) + (eng.stats(),)


@pytest.fixture(scope="module")
def models():
    return _pair(0), _pair(1)


@pytest.fixture(scope="module")
def exps(models):
    (_, tm), _ = models
    return {k: _export(tm, s) for k, s in (("a", 1), ("b", 2), ("c", 3))}


@pytest.fixture(scope="module")
def jax_runs(models, exps):
    (jm, _), (jm1, _) = models
    out = {}
    with _Flags("paged_kv"):
        out["lora"] = _lora_drive(JEngine, jm, exps)
    out["swap"] = _swap_drive(JEngine, jm, jm1)
    out["pool"] = _pool_drive(JPool, jm)
    with _Flags("async_dispatch"):
        out["async"] = _async_drive(JEngine, jm)
    return out


class TestMultiLoRA:
    def test_streams_and_counts_match_jax(self, models, exps, jax_runs):
        (_, tm), _ = models
        with _Flags("paged_kv"):
            toks, reasons, stats, mid, pinned = _lora_drive(
                ServingEngine, tm, exps)
        jtoks, jreasons, jstats, jmid, jpinned = jax_runs["lora"]
        assert (toks, reasons, mid, pinned) == (jtoks, jreasons, jmid,
                                                jpinned)
        # the session on "b" restarted from nothing (the second one and
        # the fifth request still queue); the others went on
        assert mid == (["a", "c"], [4, 0, 4, 0, 0]) and pinned
        for key in COUNTS + ("paging",):
            assert stats[key] == jstats[key], key
        assert stats["paging"]["adapters"]["loaded_names"] == ["a", "d"]

    def test_base_requests_bit_equal_a_plain_engine(self, models, exps,
                                                    jax_runs):
        (_, tm), _ = models
        toks = jax_runs["lora"][0]
        p = _prompts([6, 9, 4, 7, 5, 8], seed=11)
        plain = ServingEngine(tm, max_batch=2)
        rids = [plain.submit(p[i], max_new_tokens=n)
                for i, n in ((2, 7), (5, 5))]
        plain.run_until_complete()
        assert _streams(plain, rids)[0] == [toks[2], toks[5]]
        # the adapters move the tokens: every adapter request differs
        # from the base model's greedy tokens on its prompt
        for i in (1, 3, 4):
            base = tm.generate(torch.from_numpy(p[i][None]).long(),
                               max_new_tokens=7, temperature=0.0)
            assert base[0, len(p[i]):].tolist() != toks[i]

    def test_adapter_errors(self, models, exps):
        (_, tm), _ = models
        with _Flags("paged_kv"):
            eng = ServingEngine(tm, max_batch=2, max_adapters=1,
                                lora_rank=4)
            with pytest.raises(ValueError, match="not loaded"):
                eng.submit([3, 4], max_new_tokens=2, adapter="ghost")
            eng.load_adapter("x", exps["a"])
            with pytest.raises(ValueError, match="already loaded"):
                eng.load_adapter("x", exps["a"])
            with pytest.raises(ValueError, match="non-empty str"):
                eng.load_adapter("", exps["a"])
            assert eng.evict_adapter("x") == 1
            with pytest.raises(KeyError):
                eng.evict_adapter("x")
            wide = dict(exps["a"], rank=8)
            with pytest.raises(ValueError, match="lora_rank"):
                eng.load_adapter("w", wide)
            assert eng.stats()["paging"]["adapters"]["loaded"] == 0


class TestHotSwap:
    def test_streams_and_stamps_match_jax(self, models, jax_runs):
        (_, tm), (_, tm1) = models
        w0 = tm.gpt.wte.weight.clone()
        toks, reasons, stamps = _swap_drive(ServingEngine, tm, tm1)
        assert (toks, reasons, stamps) == jax_runs["swap"]
        assert stamps == [(0, "init"), (0, "init"), (1, "hot_swap"),
                          (1, "hot_swap")]
        # the model the engine was built from is untouched
        assert torch.equal(tm.gpt.wte.weight, w0)
        # requests after the swap equal a fresh engine on the new weights
        fresh = ServingEngine(tm1, max_batch=2)
        r = fresh.submit(_prompts([5, 8, 6], seed=21)[2], max_new_tokens=6)
        assert fresh.run_until_complete()[r].output_ids == toks[2]

    def test_a_mismatched_model_changes_nothing(self, models):
        (_, tm), _ = models
        eng = ServingEngine(tm, max_batch=2, dtype="bfloat16")
        before = {k: v.clone() for k, v in eng._params.items()}
        for other in (GPTForCausalLM(GPTConfig(**dict(CFG, num_layers=1)),
                                     device="cpu"),
                      GPTForCausalLM(GPTConfig(**dict(CFG, vocab_size=128)),
                                     device="cpu")):
            with pytest.raises(ValueError, match="hot_swap"):
                eng.hot_swap(other)
        assert all(torch.equal(before[k], v) for k, v in eng._params.items())
        assert eng.stats()["weight_version"].endswith(":0:init")
        eng.hot_swap(tm)
        assert eng.stats()["weight_version"].endswith(":1:hot_swap")
        assert eng._params["gpt.wte.weight"].dtype == torch.bfloat16


class TestDisaggregation:
    def test_pool_equals_jax_pool_and_one_engine(self, models, jax_runs):
        (_, tm), _ = models
        toks, stats = _pool_drive(DisaggregatedPool, tm)
        jtoks, jstats = jax_runs["pool"]
        assert toks == jtoks
        assert stats == jstats
        eng = ServingEngine(tm, max_batch=2)
        rids = [eng.submit(q, max_new_tokens=6 + i % 3)
                for i, q in enumerate(_prompts(POOL_LENS, seed=31))]
        eng.run_until_complete()
        assert _streams(eng, rids)[0] == toks

    @pytest.mark.parametrize("cache_dtype", [None, "int8"])
    def test_admit_prefilled_equals_submit(self, models, cache_dtype):
        (_, tm), _ = models
        worker = PrefillWorker(tm, cache_dtype=cache_dtype)
        p = _prompts([7, 12], seed=51)
        got = ServingEngine(tm, max_batch=2, cache_dtype=cache_dtype)
        want = ServingEngine(tm, max_batch=2, cache_dtype=cache_dtype)
        rids = []
        for q in p:
            row, logits = worker.prefill(q)
            rids.append(got.admit_prefilled(q, row, logits,
                                            max_new_tokens=6))
        assert got.stats()["requests"]["handoff"] == 2
        wids = [want.submit(q, max_new_tokens=6) for q in p]
        got.run_until_complete()
        want.run_until_complete()
        assert _streams(got, rids) == _streams(want, wids)

    def test_handoff_schema_refuses_a_foreign_row(self, models):
        (_, tm), _ = models
        eng = ServingEngine(tm, max_batch=2)
        row, logits = PrefillWorker(tm).prefill([1, 2, 3])
        q_row, _ = PrefillWorker(tm, cache_dtype="int8").prefill([1, 2, 3])
        short = tuple(c[:, :, :, :64] for c in row)
        for kv, lg, leaf in ((short, logits, "kc"),
                             (q_row, logits, "kc"),
                             (row, logits[:10], "logits"),
                             (row, logits.double(), "logits")):
            with pytest.raises(HandoffMismatch, match=leaf):
                eng.admit_prefilled([1, 2, 3], kv, lg)
        assert not eng.has_work()

    def test_left_out_stage_edge_raises(self, models):
        (_, tm), _ = models
        with pytest.raises(NotImplementedError, match="not ported"):
            DisaggregatedPool(tm, compress=8)


class TestAsyncStep:
    def test_streams_match_jax_and_the_sync_step(self, models, jax_runs):
        (_, tm), _ = models
        with _Flags("async_dispatch"):
            toks, reasons, stats = _async_drive(ServingEngine, tm)
        jtoks, jreasons, jstats = jax_runs["async"]
        greedy = [i for i, (_, kw) in enumerate(_async_jobs())
                  if "temperature" not in kw]
        assert [toks[i] for i in greedy] == [jtoks[i] for i in greedy]
        assert reasons == jreasons
        for key in COUNTS:
            assert stats[key] == jstats[key], key
        sync_toks, sync_reasons, _ = _async_drive(ServingEngine, tm)
        assert (toks, reasons) == (sync_toks, sync_reasons)

    def test_trainer_refuses_the_flag(self):
        from paddle_tpu_torch.distributed import SpmdTrainer
        from paddle_tpu_torch.optimizer import AdamW

        lin = torch.nn.Linear(4, 1)
        with _Flags("async_dispatch"):
            with pytest.raises(NotImplementedError, match="async_dispatch"):
                SpmdTrainer(lin, AdamW(parameters=lin.parameters()))
