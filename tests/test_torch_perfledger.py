"""The port's perf ledger (paddle_tpu_torch/monitor/perfledger.py) and its
hook sites against the JAX package's: the same observation stream fires
the same regressions (site, metric, value, mean, std) with the same
episode latching in both packages; both read each other's JSONL and skip
a torn tail; the trainer's and the engine's rows carry the reference's
keys (the environment fingerprint is the port's own: torch, CUDA, python,
machine, CPU count); a ``serving/step=delay`` failpoint after the baseline
fires ``perf_regression_total{site=serving,metric=step_ms}`` exactly once;
a finished goodput run appends its ``run/goodput`` row; and
``record_stage_runner`` names what it needs.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import trace as jtrace  # noqa: E402
from paddle_tpu.distributed.mesh import build_mesh  # noqa: E402
from paddle_tpu.distributed.spmd import SpmdTrainer as JTrainer  # noqa: E402
from paddle_tpu.inference.serving import ServingEngine as JEngine  # noqa: E402
from paddle_tpu.models import GPTConfig as JConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainLoss as JLoss  # noqa: E402
from paddle_tpu.monitor import perfledger as jledger  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import monitor, trace  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.inference import ServingEngine  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainLoss, params_from_jax)
from paddle_tpu_torch.monitor import perfledger  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.testing import failpoints  # noqa: E402

CFG = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
           max_seq_len=32, dropout=0.0)
FLAGS = ("perf_ledger", "perf_ledger_path", "perf_ledger_sigma",
         "perf_ledger_warmup", "perf_ledger_interval", "goodput")
STEPS = 3


@pytest.fixture(autouse=True)
def _restore():
    saved = (paddle.get_flags(list(FLAGS)), pt.get_flags(list(FLAGS)))
    yield
    paddle.set_flags(saved[0])
    pt.set_flags(saved[1])
    perfledger.reset_ledger()
    jledger.reset_ledger()


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_cost_table():
    from paddle_tpu.trace import costs

    saved = dict(costs._TABLE)
    yield
    with costs._LOCK:
        costs._TABLE.clear()
        costs._TABLE.update(saved)


def _stream():
    """Two sites, a HIGH_IS_BAD and a LOW_IS_BAD metric and one in
    neither list: a steady baseline, a sustained step_ms regression
    (one episode), recovery, a second episode, and an mfu drop."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(40):
        ms = 100.0 + rng.randn()
        mfu = 0.4 + 0.002 * rng.randn()
        if 12 <= i < 16 or 30 <= i < 32:
            ms = 180.0
        if i == 35:
            mfu = 0.1
        out.append(("trainer", {"step_ms": ms, "mfu": mfu,
                                "dispatch_fraction": 0.9}))
        out.append(("serving", {"step_ms": 10.0 + 0.1 * rng.randn()
                                + (20.0 if i == 25 else 0.0)}))
    return out


def test_same_stream_same_regressions_and_latching(tmp_path):
    want_led = jledger.PerfLedger(path=str(tmp_path / "j.jsonl"))
    got_led = perfledger.PerfLedger(path=str(tmp_path / "p.jsonl"))
    want, got = [], []
    for i, (site, m) in enumerate(_stream()):
        call = "observe" if i % 3 == 0 else "on_step"
        want.extend(getattr(want_led, call)(site, m))
        got.extend(getattr(got_led, call)(site, m))
    assert got == want
    assert [(r["site"], r["metric"]) for r in got] == [
        ("trainer", "step_ms"), ("serving", "step_ms"),
        ("trainer", "step_ms"), ("trainer", "mfu")]
    assert got_led.rows_written == want_led.rows_written
    fam = monitor.default_registry().get("perf_regression_total")
    assert fam.labels(site="trainer", metric="step_ms").value >= 2


def test_rows_cross_read_and_a_torn_tail_is_skipped(tmp_path):
    path = tmp_path / "ledger.jsonl"
    led = perfledger.PerfLedger(path=str(path))
    for i in range(3):
        led.on_step("trainer", {"step_ms": 10.0 + i, "bad": float("nan")},
                    sig="s", force=True)
    with open(path, "a") as f:
        f.write('{"v": 1, "site": "trainer", "metr')    # a killed writer
    rows = perfledger.load_rows(str(path))
    assert [r["metrics"]["step_ms"] for r in rows] == [10.0, 11.0, 12.0]
    assert rows[0]["metrics"]["bad"] is None           # non-finite -> null
    assert jledger.load_rows(str(path)) == rows
    assert perfledger.tail(str(path), 2) == rows[-2:]
    assert perfledger.load_rows(str(tmp_path / "absent.jsonl")) == []
    fp = rows[0]["env"]
    assert set(perfledger.CORE_FINGERPRINT) <= set(fp)
    assert fp["torch"] == torch.__version__ and "jax" not in fp
    # a port row never joins the reference's baseline, nor the reverse
    assert perfledger.fingerprint_key(fp) != jledger.fingerprint_key(
        jledger.env_fingerprint())
    assert ("trainer", "step_ms") in perfledger.baselines(rows)
    assert not jledger.baselines(rows)


def _batch():
    rng = np.random.RandomState(0)
    s, v = CFG["max_seq_len"], CFG["vocab_size"]
    return (rng.randint(0, v, (2, s)).astype(np.int32),
            rng.randint(0, v, (2, s)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """The JAX trainer's and engine's ledger rows, tracing on (the cost
    registry feeds the trainer's FLOPs)."""
    d = tmp_path_factory.mktemp("jledger")
    old = (paddle.get_flags(list(FLAGS)), jtrace.is_enabled())
    paddle.set_flags({"perf_ledger": True,
                      "perf_ledger_path": str(d / "rows.jsonl")})
    jledger.reset_ledger()
    jtrace.enable()
    try:
        paddle.seed(0)
        jm = JGPT(JConfig(**CFG))
        init = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters())
        jt = JTrainer(jm, opt, loss_fn=JLoss(),
                      mesh=build_mesh((1,), ("dp",),
                                      devices=jax.devices()[:1]))
        ids, labels = _batch()
        for _ in range(STEPS):
            jt.train_step(paddle.to_tensor(ids), paddle.to_tensor(labels))
        jm.eval()
        eng = JEngine(jm, max_batch=2)
        for n in (5, 9):
            eng.submit(np.arange(n) % 128, max_new_tokens=3)
        eng.run_until_complete()
        return init, jledger.load_rows(str(d / "rows.jsonl"))
    finally:
        (jtrace.enable if old[1] else jtrace.disable)()
        paddle.set_flags(old[0])
        jledger.reset_ledger()


def _port_rows(init, path):
    pt.set_flags({"perf_ledger": True, "perf_ledger_path": str(path)})
    perfledger.reset_ledger()
    was = trace.is_enabled()
    trace.enable()
    try:
        tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
        tm.load_state_dict(params_from_jax(init))
        tt = SpmdTrainer(tm, AdamW(learning_rate=1e-3,
                                   parameters=tm.parameters()),
                         loss_fn=GPTPretrainLoss())
        ids, labels = _batch()
        for _ in range(STEPS):
            tt.train_step(ids, labels)
        eng = ServingEngine(tm.eval(), max_batch=2)
        for n in (5, 9):
            eng.submit(np.arange(n) % 128, max_new_tokens=3)
        eng.run_until_complete()
    finally:
        (trace.enable if was else trace.disable)()
    return perfledger.load_rows(str(path))


@pytest.mark.parametrize("site", ["trainer", "serving"])
def test_trainer_and_engine_rows_have_the_reference_keys(jax_rows, tmp_path,
                                                         site):
    init, want = jax_rows
    got = _port_rows(init, tmp_path / "rows.jsonl")
    want = [r for r in want if r["site"] == site]
    got = [r for r in got if r["site"] == site]
    assert len(got) == len(want) and got
    for w, g in zip(want, got):
        assert set(g) == set(w)
        assert set(g["metrics"]) == set(w["metrics"]), (
            sorted(set(g["metrics"]) ^ set(w["metrics"])))
    if site == "trainer":
        assert [("cold" in r["metrics"]) for r in got] == [True, False, False]
        assert got[0]["sig"] == "int64[2,32]|int64[2,32]"
        assert got[-1]["metrics"]["flops_per_step"] > 0
        assert got[-1]["mesh"] == "device=cpu"


def test_a_delay_after_the_baseline_fires_once(tmp_path):
    """The engine's ledger times its whole step, the ``serving/step``
    failpoint included: steady decode steps (until the sentinel holds no
    episode open, which a shared CPU's noise can start), then 3 delayed
    ones: one fire, latched for the rest of the episode."""
    pt.set_flags({"perf_ledger": True, "perf_ledger_warmup": 5,
                  "perf_ledger_interval": 8,
                  "perf_ledger_path": str(tmp_path / "rows.jsonl")})
    perfledger.reset_ledger()
    pt.seed(0)
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu").eval()
    eng = ServingEngine(tm, max_batch=2)
    led = perfledger.get_ledger()
    seen = []
    observe = led.observe

    def spy(site, m):
        fired = observe(site, m)
        seen.append((m["step_ms"], len(fired)))
        return fired

    led.observe = spy
    fam = monitor.counter("perf_regression_total", labelnames=(
        "site", "metric"))
    for n in (5, 6):
        eng.submit(np.arange(n), max_new_tokens=26)
    for _ in range(12):
        eng.step()
    while ("serving", "step_ms") in led._episode and eng.has_work():
        eng.step()
    assert ("serving", "step_ms") not in led._episode
    before = fam.labels(site="serving", metric="step_ms").value
    n0 = len(seen)
    with failpoints.scoped("serving/step=delay:500"):
        for _ in range(3):
            eng.step()
    delayed = seen[n0:]
    assert len(delayed) == 3 and all(ms >= 500.0 for ms, _ in delayed)
    assert [f for _, f in delayed] == [1, 0, 0]
    assert fam.labels(site="serving", metric="step_ms").value == before + 1
    eng.run_until_complete()
    assert len(seen) == eng._step_no       # every step went through it
    rows = perfledger.load_rows(str(tmp_path / "rows.jsonl"))
    assert len(rows) == len(seen) // 8
    assert all(r["site"] == "serving" for r in rows)


def test_goodput_run_appends_its_row(tmp_path):
    from paddle_tpu_torch.monitor import goodput

    pt.set_flags({"perf_ledger": True, "goodput": True,
                  "perf_ledger_path": str(tmp_path / "rows.jsonl")})
    perfledger.reset_ledger()
    goodput.reset()
    try:
        pt.seed(0)
        tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
        tt = SpmdTrainer(tm, AdamW(learning_rate=1e-3,
                                   parameters=tm.parameters()),
                         loss_fn=GPTPretrainLoss())
        tt.train_step(*_batch())
        row = goodput.end_run()
    finally:
        goodput.reset()
    rows = [r for r in perfledger.load_rows(str(tmp_path / "rows.jsonl"))
            if r["site"] == "run/goodput"]
    assert len(rows) == 1 and rows[0]["sig"] == row["run_id"]
    assert rows[0]["metrics"]["goodput"] == pytest.approx(row["goodput"])
    assert json.dumps(perfledger.get_ledger().snapshot())


def test_record_stage_runner_is_refused_and_record_leg_kept():
    with pytest.raises(NotImplementedError, match="distributed/stage.py"):
        perfledger.record_stage_runner({"tick_ms": 1.0})
    led = perfledger.PerfLedger(path="")
    perfledger.record_leg("unit", {"tokens_per_s": 5.0, "name": "x"},
                          ledger=led)
    assert led.snapshot()["last_rows"]["bench/unit"]["metrics"] == {
        "tokens_per_s": 5.0}
