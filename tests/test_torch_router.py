"""The port's front-door Router (paddle_tpu_torch/serving/router.py) over two
port engines against the JAX package's Router over two JAX engines, on a
narrow GPT (vocab 256, hidden 64, 2 layers, 4 heads, max_seq 128, fp32)
whose weights are carried across with params_from_jax: the same submits
(sessions, a router-registered prefix, deadlines, plain prompts) give the
same placements, the same affinity hits and misses and the same greedy
tokens, exactly; so do an engine whose step() raises (failover of its
queued and in-flight requests) and ``drain(name)`` (its queued requests
move). With no live engine both raise NoLiveEngineError; with the port's
flight recorder armed the error names the dump bundle, which holds the
router's placement table. One trace_id threads router -> engine -> slot.
The JAX engines are built and run once a module.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.inference.serving import ServingEngine as JEngine  # noqa: E402
from paddle_tpu.models import GPTConfig as JConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving.router import NoLiveEngineError as JNoLive  # noqa: E402
from paddle_tpu.serving.router import Router as JRouter  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import monitor, trace  # noqa: E402
from paddle_tpu_torch.inference import ServingEngine  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax  # noqa: E402
from paddle_tpu_torch.serving import NoLiveEngineError, Router  # noqa: E402

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
NEW = 6


@pytest.fixture(scope="module")
def engines():
    paddle.seed(0)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}))
    tm.eval()

    def pair(eng_cls, model):
        return {"a": eng_cls(model, max_batch=2),
                "b": eng_cls(model, max_batch=2)}

    return pair(JEngine, jm), pair(ServingEngine, tm)


def _prompt(rng, n):
    return rng.randint(0, 256, (n,)).astype(np.int32)


def _jobs():
    """(kwargs for submit) x 12: 3 sessions x 2 turns, 2 on a shared
    prefix, 2 with deadlines, 2 plain prompts."""
    rng = np.random.RandomState(0)
    jobs = []
    for turn in range(2):
        for sess in ("s0", "s1", "s2"):
            jobs.append(dict(prompt_ids=_prompt(rng, 6 + turn),
                             session_id=sess))
    jobs += [dict(prompt_ids=_prompt(rng, 5), prefix=True)
             for _ in range(2)]
    jobs += [dict(prompt_ids=_prompt(rng, 7), deadline_ms=1e7)
             for _ in range(2)]
    jobs += [dict(prompt_ids=_prompt(rng, 9)) for _ in range(2)]
    return jobs


def _submit_all(router, jobs, prefix_ids):
    pid = router.register_prefix(prefix_ids)
    rids = []
    for job in jobs:
        kw = {k: v for k, v in job.items() if k != "prefix"}
        if job.get("prefix"):
            kw["prefix_id"] = pid
        rids.append(router.submit(max_new_tokens=NEW, **kw))
    return rids


def _scenario(router_cls, engs, kind):
    """One routed run; returns placements (after any re-route), tokens
    and the router's accounting."""
    jobs = _jobs()
    prefix = np.arange(3, 19, dtype=np.int32)
    router = router_cls(engs)
    restore = None
    if kind == "engine_error":
        eng = engs["a"]
        calls = [0]
        real = eng.step

        def flaky():
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("injected engine fault")
            return real()

        eng.step = flaky
        restore = lambda: delattr(eng, "step")   # noqa: E731
    try:
        rids = _submit_all(router, jobs, prefix)
        if kind == "drain":
            router.drain("b")
        res = router.run_until_complete()
    finally:
        if restore is not None:
            restore()
    st = router.stats()["router"]
    return ({r: router._reqs[r].engine for r in rids},
            {r: [int(t) for t in res[r].output_ids] for r in rids},
            {k: st[k] for k in ("requests", "failover", "affinity",
                                "alive", "dead")})


@pytest.fixture(scope="module")
def runs(engines):
    jengs, tengs = engines
    return {kind: (_scenario(JRouter, jengs, kind),
                   _scenario(Router, tengs, kind))
            for kind in ("plain", "engine_error", "drain")}


@pytest.mark.parametrize("kind", ["plain", "engine_error", "drain"])
def test_same_placements_tokens_and_accounting(runs, kind):
    want, got = runs[kind]
    assert got[0] == want[0]              # placements
    assert got[1] == want[1]              # greedy tokens, exactly
    assert got[2] == want[2]              # requests, failover, affinity
    if kind == "plain":
        assert set(got[0].values()) == {"a", "b"}
        assert got[2]["affinity"]["hit"] > 0
    if kind == "engine_error":
        assert got[2]["dead"] == ["a"] and got[2]["failover"]["engine_error"]
        assert set(got[0].values()) == {"b"}
    if kind == "drain":
        assert got[2]["failover"]["drain"] > 0


def test_failover_tokens_equal_the_plain_run(runs):
    plain = runs["plain"][1][1]
    assert runs["engine_error"][1][1] == plain
    assert runs["drain"][1][1] == plain


def test_one_trace_id_threads_router_engine_and_slot(engines):
    _, tengs = engines
    was = trace.is_enabled()
    trace.enable()
    trace.clear()
    try:
        router = Router(tengs)
        rid = router.submit(np.arange(4, 12), max_new_tokens=3)
        router.run_until_complete()
        tid = router._reqs[rid].trace_id
        names = {s.name for s in trace.spans() if s.trace_id == tid}
    finally:
        (trace.enable if was else trace.disable)()
        trace.clear()
    assert tid and {"route", "request"} <= names
    assert names & {"prefill", "decode", "admit"}


def test_no_live_engine_names_the_bundle(engines, tmp_path):
    from paddle_tpu_torch.monitor import blackbox as bb

    jengs, tengs = engines
    jr = JRouter(jengs)
    for eng in jengs.values():
        eng.drain()
    with pytest.raises(JNoLive):
        jr.submit(np.arange(5), max_new_tokens=2)
    saved = pt.get_flags(["blackbox", "blackbox_dir"])
    providers = list(monitor._BB_PROVIDERS)
    pt.set_flags({"blackbox": True, "blackbox_dir": str(tmp_path)})
    bb.sync_from_flag()
    try:
        tr = Router(tengs)
        for eng in tengs.values():
            eng.drain()
        with pytest.raises(NoLiveEngineError,
                           match="blackbox dump bundle: ") as err:
            tr.submit(np.arange(5), max_new_tokens=2)
        path = str(err.value).split("blackbox dump bundle: ")[1]
        bundle = bb.load_bundle(path)
    finally:
        bb.disable()
        bb.uninstall_hooks()
        bb.reset()
        pt.set_flags(saved)
        with monitor._BB_PROVIDERS_LOCK:
            monitor._BB_PROVIDERS[:] = providers
    assert bundle["site"] == "router/no_live_engine"
    tables = [t["table"] for t in bundle["requests"] if t["kind"] == "router"]
    assert tables and tables[-1]["alive"] == ["a", "b"]
    fam = monitor.default_registry().get("router_requests_total")
    assert fam.labels(engine="a").value > 0
