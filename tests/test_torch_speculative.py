"""Speculative decoding in the port (paddle_tpu_torch/models/gpt.py
``_gpt_speculative`` behind ``generate_speculative``, and the engine's
``draft_model=`` rounds in paddle_tpu_torch/inference/serving.py) against
the JAX package's on the CPU: a target on the reference's serving test
config (vocab 256, hidden 64, 2 layers, 4 heads, max_seq 128), a random
one-layer draft of the same vocabulary, and the target as its own draft;
fp32, weights carried across with params_from_jax.

Sequences and round counts equal the JAX package's (and the target's own
greedy generate); the speculative engine's greedy token streams, finish
reasons and stats() counts equal the JAX engine's on the same drive; the
refusals are the reference's. The JAX runs happen once per module.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
DRAFT = dict(CFG, hidden_size=32, num_layers=1, num_heads=2)
# generate_speculative cases: (draft, k, new tokens, eos)
SPEC = {"random_k3": ("draft", 3, 20, None),
        "self_eos": ("self", 4, 21, "eos")}


def _pair(cfg, seed):
    paddle.seed(seed)
    jm = JGPT(JConfig(**cfg))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(CFG, 0), "draft": _pair(DRAFT, 1)}


def _prompt(n=9, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (1, n)).astype(
        np.int32)


def _eos(models):
    """A token the self-draft run emits mid-stream (its 6th new token)."""
    _, tm = models["target"]
    out = tm.generate(torch.from_numpy(_prompt()).long(), max_new_tokens=6,
                      temperature=0.0)
    return int(out[0, -1])


def _case(models, name):
    which, k, new, eos = SPEC[name]
    draft = models["target" if which == "self" else "draft"]
    return draft, dict(max_new_tokens=new, k=k,
                       eos_token_id=None if eos is None else _eos(models))


def _engine_jobs():
    """Greedy requests and one sampled (its slot forces single-token
    fallback steps while it lives); the drive adds one on a registered
    prefix (admitted by chunks, the draft's too)."""
    rng = np.random.RandomState(3)
    jobs = [(rng.randint(0, 256, (n,)).astype(np.int32),
             dict(max_new_tokens=m)) for n, m in
            ((5, 14), (11, 9), (3, 17), (20, 6), (7, 12))]
    jobs[2][1].update(temperature=0.8, top_k=8, seed=5)
    return jobs


def _engine_drive(E, target, draft):
    eng = E(target, max_batch=3, draft_model=draft, spec_k=3)
    pre = np.random.RandomState(4).randint(0, 256, (10,)).astype(np.int32)
    pid = eng.register_prefix(pre)
    rids = [eng.submit(p, **kw) for p, kw in _engine_jobs()]
    rids.append(eng.submit([9, 8, 7], max_new_tokens=8, prefix_id=pid))
    res = eng.run_until_complete()
    return ([[int(t) for t in res[r].output_ids] for r in rids],
            [res[r].finish_reason for r in rids], eng.stats())


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, _ = models["target"]
    out = {}
    for name in SPEC:
        (jd, _), kw = _case(models, name)
        seq, rounds = jm.generate_speculative(
            jd, paddle.to_tensor(_prompt()), **kw)
        out[name] = (np.asarray(seq._data), rounds)
    out["engine"] = _engine_drive(JEngine, jm, models["draft"][0])
    return out


class TestGenerateSpeculative:
    @pytest.mark.parametrize("name", sorted(SPEC))
    def test_sequences_and_rounds_match_jax(self, models, jax_runs, name):
        _, tm = models["target"]
        (_, td), kw = _case(models, name)
        seq, rounds = tm.generate_speculative(
            td, torch.from_numpy(_prompt()).long(), **kw)
        want_seq, want_rounds = jax_runs[name]
        np.testing.assert_array_equal(seq.numpy(), want_seq)
        assert rounds == want_rounds
        greedy = tm.generate(torch.from_numpy(_prompt()).long(),
                             max_new_tokens=kw["max_new_tokens"],
                             temperature=0.0,
                             eos_token_id=kw["eos_token_id"])
        np.testing.assert_array_equal(seq.numpy(), greedy.numpy())

    def test_self_draft_accepts_every_proposal(self, models):
        _, tm = models["target"]
        _, rounds = tm.generate_speculative(
            tm, torch.from_numpy(_prompt()).long(), max_new_tokens=21, k=4)
        assert rounds == -(-21 // 5)

    def test_quantized_cache_and_bf16_compose(self, models):
        _, tm = models["target"]
        _, td = models["draft"]
        ids = torch.from_numpy(_prompt()).long()
        for kw in (dict(cache_dtype="int8"), dict(dtype="bfloat16")):
            seq, rounds = tm.generate_speculative(td, ids, max_new_tokens=8,
                                                  k=2, **kw)
            assert seq.shape == (1, 17) and 1 <= rounds <= 8

    @pytest.mark.parametrize("args, match", [
        (dict(ids=np.zeros((2, 5), np.int32)), "batch-1"),
        (dict(draft="vocab"), "vocabulary"),
        (dict(k=0), "k must be"),
        (dict(k=17), "k must be"),
        (dict(ids=np.zeros((1, 1), np.int32)), ">= 2 tokens"),
        (dict(new=117), "exceeds a max_seq_len")],
        ids=["batch2", "vocab", "k0", "k17", "prompt1", "too_long"])
    def test_refusals_match_jax(self, models, args, match):
        ids = args.get("ids", _prompt())
        kw = dict(max_new_tokens=args.get("new", 4), k=args.get("k", 3))
        for i, pkg in enumerate(("jax", "port")):
            target = models["target"][i]
            if args.get("draft") == "vocab":
                cfg = dict(DRAFT, vocab_size=128)
                if pkg == "jax":
                    draft = JGPT(JConfig(**cfg))
                else:
                    draft = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
            else:
                draft = models["draft"][i]
            x = paddle.to_tensor(ids) if pkg == "jax" else \
                torch.from_numpy(ids).long()
            with pytest.raises(ValueError, match=match):
                target.generate_speculative(draft, x, **kw)


class TestSpeculativeEngine:
    def test_streams_and_counts_match_jax(self, models, jax_runs):
        _, tm = models["target"]
        _, td = models["draft"]
        toks, reasons, stats = _engine_drive(ServingEngine, tm, td)
        want_toks, want_reasons, want = jax_runs["engine"]
        sampled = 2
        assert [t for i, t in enumerate(toks) if i != sampled] == \
            [t for i, t in enumerate(want_toks) if i != sampled]
        assert len(toks[sampled]) == len(want_toks[sampled])
        assert reasons == want_reasons
        for key in ("requests", "tokens_generated", "steps", "prefix_cache",
                    "speculative", "batch_occupancy_avg"):
            assert stats[key] == want[key], key
        assert stats["speculative"]["proposed"] > 0

    def test_greedy_streams_equal_generate(self, models):
        _, tm = models["target"]
        _, td = models["draft"]
        eng = ServingEngine(tm, max_batch=2, draft_model=td, spec_k=4)
        jobs = [j for j in _engine_jobs() if "temperature" not in j[1]]
        rids = [eng.submit(p, **kw) for p, kw in jobs]
        res = eng.run_until_complete()
        for (p, kw), r in zip(jobs, rids):
            want = tm.generate(torch.from_numpy(p[None]).long(),
                               max_new_tokens=kw["max_new_tokens"],
                               temperature=0.0)[0, len(p):].tolist()
            assert res[r].output_ids == want
        assert eng.stats()["steps"].get("decode_greedy", 0) == 0

    def test_engine_refusals(self, models):
        _, tm = models["target"]
        _, td = models["draft"]
        small = GPTForCausalLM(GPTConfig(**dict(DRAFT, max_seq_len=64)),
                               device="cpu")
        other = GPTForCausalLM(GPTConfig(**dict(DRAFT, vocab_size=128)),
                               device="cpu")
        for kw, match in ((dict(draft_model=other), "vocabulary"),
                          (dict(draft_model=td, spec_k=17), "spec_k"),
                          (dict(draft_model=small), "must cover")):
            with pytest.raises(ValueError, match=match):
                ServingEngine(tm, max_batch=2, **kw)
        eng = ServingEngine(tm, max_batch=2, draft_model=td)
        with pytest.raises(RuntimeError, match="speculative"):
            eng.admit_prefilled([1, 2], None, None)
        old = pt.get_flag("paged_kv")
        pt.set_flags({"paged_kv": True})
        try:
            with pytest.raises(ValueError, match="draft_model"):
                ServingEngine(tm, max_batch=2, draft_model=td)
        finally:
            pt.set_flags({"paged_kv": old})
