"""The port's numerics telescope (paddle_tpu_torch/monitor/numerics.py), the
numerics leg of its SpmdTrainer and its parity harness
(paddle_tpu_torch/testing/parity.py) against the JAX package's.

Tolerances:
- ``device_stats`` on the same gradients and parameters (numpy, from a
  seed; NaN and inf entries; tensors below, at and past DIGEST_CAP; a
  weight stored transposed in the port): every stat within rtol 1e-6 of
  the reference's (fp32; only summation order differs), the quantile
  digest within 1e-6.
- The same stats stream through both ``NumericsMonitor``s: the same
  anomalies (kind, layer, step, value), for each of the five rules.
- The narrow GPT trainer armed for 3 AdamW steps (fp32, the same numpy
  weights and batch): every stat of every layer within the band
  test_torch_trainer.py holds the losses to, atol 1e-5 (on top of rtol
  1e-5 for the norms of the embedding, which are O(10)).
- Armed and disarmed port runs: bit-equal losses and parameters (on one
  CPU thread, see ``_one_thread``).
"""
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.mesh import build_mesh  # noqa: E402
from paddle_tpu.distributed.spmd import SpmdTrainer as JTrainer  # noqa: E402
from paddle_tpu.models import GPTConfig as JConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainLoss as JLoss  # noqa: E402
from paddle_tpu.monitor import numerics as jnumerics  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import monitor, trace  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainLoss, params_from_jax)
from paddle_tpu_torch.monitor import numerics  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.testing import parity  # noqa: E402

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0)
LR = 1e-3
STATS_RTOL = 1e-6
TRAIN_TOL = 1e-5
STEPS = 3
FLAGS = ("numerics", "numerics_interval", "check_nan_inf")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = (paddle.get_flags(list(FLAGS)), pt.get_flags(list(FLAGS)))
    yield
    paddle.set_flags(saved[0])
    pt.set_flags(saved[1])


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_cost_table():
    from paddle_tpu.trace import costs

    saved = dict(costs._TABLE)
    yield
    with costs._LOCK:
        costs._TABLE.clear()
        costs._TABLE.update(saved)


# -- device_stats ----------------------------------------------------------------

SHAPES = {"a.weight": (64, 192), "b": (5000,), "c": (4096,), "d": (3,),
          "e": (8193,), "f.weight": (100, 100)}
TRANSPOSED = {"a.weight"}


@pytest.fixture(scope="module")
def stats_pair():
    rng = np.random.RandomState(0)
    g = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    g["d"][1] = np.nan
    g["f.weight"][3, 4] = np.inf
    g["e"][::7] = -np.inf
    old = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    new = {k: (old[k] + 1e-2 * rng.randn(*s)).astype(np.float32)
           for k, s in SHAPES.items()}
    names = sorted(SHAPES)
    want = jnumerics.device_stats(
        names, np.float32(2.5), {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in old.items()},
        {k: jnp.asarray(v) for k, v in new.items()})

    def port(d):   # the port stores the Linear weight [out, in]
        return {k: torch.tensor(v.T.copy() if k in TRANSPOSED else v)
                for k, v in d.items()}

    got = numerics.device_stats(names, torch.tensor(2.5), port(g), port(old),
                                port(new), transposed=TRANSPOSED)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("key", numerics.STAT_KEYS)
def test_device_stats_match_the_reference(stats_pair, key):
    want, got = stats_pair
    assert got[key].shape == want[key].shape and got[key].dtype == np.float32
    tol = 1e-6 if key == "quantiles" else STATS_RTOL
    np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=0)
    if key == "nonfinite":
        assert got[key].tolist() == [0, 0, 0, 1, 1171, 1]   # sorted names
    if key == "quantiles":   # the NaN row is NaN, as jnp.quantile's
        assert np.isnan(got[key][3]).all() and not np.isnan(got[key][0]).any()


def test_digest_subsample_matches_the_reference_positions():
    for n in (1, 4095, 4096, 4097, 8192, 8193, 123457):
        want = np.asarray(jnumerics._digest_source(jnp.arange(n)))
        np.testing.assert_array_equal(numerics._digest_positions(n), want)


# -- the drift detectors -----------------------------------------------------------

LAYERS = ["l0", "l1", "l2"]


def _stream():
    """12 fetches over 3 layers that fire each rule once: a grad spike on
    l0 at step 8, l1 exactly dead from step 3, an update-ratio jump on l2
    at step 9, a non-finite l0 at step 10, and a loss flat from step 2."""
    rng = np.random.RandomState(1)
    out = []
    for step in range(12):
        gn = 1.0 + 0.01 * rng.randn(3)
        ratio = np.full(3, 0.01) + 1e-4 * rng.randn(3)
        nonf = np.zeros(3)
        if step == 8:
            gn[0] = 50.0
        if step >= 3:
            gn[1] = 0.0
        if step == 9:
            ratio[2] = 0.9
        if step == 10:
            nonf[0] = 4.0
        out.append({"grad_norm": gn.astype(np.float32),
                    "update_ratio": ratio.astype(np.float32),
                    "param_norm": np.full(3, 5.0, np.float32),
                    "nonfinite": nonf.astype(np.float32),
                    "quantiles": np.zeros((3, 3), np.float32),
                    "loss": np.float32(3.0 if step >= 2 else 4.0 - step)})
    return out


@pytest.fixture(scope="module")
def fired():
    jm = jnumerics.NumericsMonitor(LAYERS)
    pm = numerics.NumericsMonitor(LAYERS)
    out = ([], [])
    for step, st in enumerate(_stream()):
        out[0].extend(jm.observe(st, step))
        out[1].extend(pm.observe(st, step))
    return out, pm


@pytest.mark.parametrize("kind", ["grad_spike", "dead_layer", "update_ratio",
                                  "nonfinite", "loss_plateau"])
def test_monitors_fire_the_same_anomalies(fired, kind):
    (want, got), _ = fired
    want = [a for a in want if a["kind"] == kind]
    got = [a for a in got if a["kind"] == kind]
    assert want and got == want


def test_monitor_metrics_and_snapshot(fired):
    _, pm = fired
    snap = pm.snapshot()
    assert snap["fetches"] == 12 and snap["step"] == 11
    assert snap["layers"]["l1"]["grad_norm"] == 0.0
    fam = monitor.default_registry().get("numerics_anomaly_total")
    assert fam.labels(kind="dead_layer", layer="l1").value >= 1


# -- the trainer -----------------------------------------------------------------

def _batch(seed=0):
    rng = np.random.RandomState(seed)
    s, v = CFG["max_seq_len"], CFG["vocab_size"]
    return (rng.randint(0, v, (2, s)).astype(np.int32),
            rng.randint(0, v, (2, s)).astype(np.int32))


@contextlib.contextmanager
def _one_thread():
    """Runs compared bit for bit go on one CPU thread: the bits of a
    multi-threaded CPU reduction can follow how a loaded host schedules
    its threads (about one run of fifty here), which no flag touches."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _port_trainer(init):
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(init))
    return tm, SpmdTrainer(tm, AdamW(learning_rate=LR,
                                     parameters=tm.parameters()),
                           loss_fn=GPTPretrainLoss())


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer armed for STEPS AdamW steps: the initial weights
    and every step's loss and fetched stats."""
    paddle.set_flags({"numerics": True, "numerics_interval": 1})
    try:
        paddle.seed(0)
        jm = JGPT(JConfig(**CFG))
        init = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=jm.parameters())
        jt = JTrainer(jm, opt, loss_fn=JLoss(),
                      mesh=build_mesh((1,), ("dp",),
                                      devices=jax.devices()[:1]))
        ids, labels = _batch()
        losses, stats = [], []
        for _ in range(STEPS):
            losses.append(float(np.asarray(jt.train_step(
                paddle.to_tensor(ids), paddle.to_tensor(labels))._data)))
            stats.append({k: np.array(v) for k, v in
                          jt.numerics_fetch().items()})
        return init, losses, stats, sorted(jt.params)
    finally:
        paddle.set_flags({"numerics": False})


def _port_run(init, armed, interval=1):
    pt.set_flags({"numerics": armed, "numerics_interval": interval})
    tm, tt = _port_trainer(init)
    ids, labels = _batch()
    losses, stats = [], []
    for _ in range(STEPS):
        losses.append(float(tt.train_step(ids, labels)))
        host = tt._numerics_last_host
        stats.append(None if host is None else dict(host))
    return tm, tt, losses, stats


@pytest.fixture(scope="module")
def port_runs(jax_run):
    """The port armed, then disarmed (on one CPU thread, see
    _one_thread)."""
    init = jax_run[0]
    old = pt.get_flags(["numerics", "numerics_interval"])
    try:
        with _one_thread():
            return _port_run(init, True), _port_run(init, False)
    finally:
        pt.set_flags(old)


@pytest.mark.parametrize("key", numerics.STAT_KEYS)
def test_armed_trainer_stats_match_the_jax_trainer(jax_run, port_runs, key):
    _, jl, jstats, jlayers = jax_run
    tm, tt, tl, tstats = port_runs[0]
    assert sorted(tt.params) == jlayers
    np.testing.assert_allclose(tl, jl, atol=TRAIN_TOL, rtol=0)
    for step in range(STEPS):
        np.testing.assert_allclose(tstats[step][key], jstats[step][key],
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=f"{key} at step {step}")


def test_armed_and_disarmed_runs_are_bit_equal(port_runs):
    (tm_a, tt_a, la, sa), (tm_d, tt_d, ld, sd) = port_runs
    assert la == ld
    assert all(s is not None for s in sa) and all(s is None for s in sd)
    for (n, p), (_, q) in zip(tm_a.named_parameters(),
                              tm_d.named_parameters()):
        assert torch.equal(p, q), n
    assert tt_d._numerics_old is None and tt_d.stats()["numerics"] is None
    assert tt_a.stats()["numerics"]["fetches"] == STEPS


def test_interval_fetches_every_nth_step_under_a_span(jax_run):
    trace.clear()
    was = trace.is_enabled()
    trace.enable()
    try:
        _, tt, _, stats = _port_run(jax_run[0], True, interval=2)
    finally:
        (trace.enable if was else trace.disable)()
    assert [s is not None for s in stats] == [False, True, False]
    assert tt._numerics.fetches == 1
    spans = [s for s in trace.spans() if s.name == "numerics/fetch"]
    assert len(spans) == 1 and spans[0].subsystem == "trainer"
    trace.clear()


def test_a_poisoned_layer_is_named_before_the_guard_skips(jax_run):
    pt.set_flags({"numerics": True, "numerics_interval": 1,
                  "check_nan_inf": True})
    tm, tt = _port_trainer(jax_run[0])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    target = "gpt.blocks.1.mlp.fc2.bias"
    dict(tm.named_parameters())[target].register_hook(
        lambda g: g * float("inf"))
    tt.train_step(*_batch())
    for n, p in tm.named_parameters():      # the guard skipped the update
        assert torch.equal(p, before[n]), n
    snap = tt.stats()["numerics"]
    bad = sorted(layer for layer, st in snap["layers"].items()
                 if st["nonfinite"])
    assert bad == [target]
    assert [(a["kind"], a["layer"]) for a in snap["anomalies"]] \
        == [("nonfinite", target)]


def test_run_parity_passes_and_names_a_divergence(jax_run):
    init = jax_run[0]
    batches = [_batch(seed) for seed in range(STEPS)]

    def build(lr=LR):
        tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
        tm.load_state_dict(params_from_jax(init))
        return SpmdTrainer(tm, AdamW(learning_rate=lr,
                                     parameters=tm.parameters()),
                           loss_fn=GPTPretrainLoss())

    with _one_thread():
        report = parity.assert_parity(parity.run_parity(build, batches))
    assert report["steps"] == STEPS and report["max_abs_loss_diff"] == 0.0
    assert pt.get_flag("numerics") is False     # flag_scope restored it
    bad = parity.run_parity(build, batches,
                            build_candidate=lambda: build(lr=10 * LR))
    # the losses of step 0 agree; its update ratios do not
    with pytest.raises(parity.ParityDivergence,
                       match=r"step 0 on update_ratio\[gpt\."):
        parity.assert_parity(bad)
