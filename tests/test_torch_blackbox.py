"""The port's flight recorder (paddle_tpu_torch/monitor/blackbox.py) and its
hook sites, with the JAX package read for its bundle format: the ring's
capacity and drop order, refcounted windows and raw beacons, one bundle
each stall episode (timeouts of 0.1 s, polls of 0.02 s), a port bundle
that the reference's ``validate_bundle`` / ``load_bundle`` accept, the
SIGUSR1 and excepthook dumps, the span, checkpoint and hot-swap notes,
``serving/step`` stalls holding every in-flight request (a host stall
through the ``serving/step=delay`` failpoint), and
``run_until_complete``'s ``engine_stalled`` error naming the bundle.

Also the gates of the four runtime services of this slice (the recorder,
the numerics telescope, the perf ledger and the router): in a fresh
process that trains and serves with none of their flags set, no module of
theirs is imported, no sentinel thread runs, no hook is installed and no
``blackbox_*``, ``numerics_*``, ``perf_*`` or ``router_*`` series exists.

Every test that arms the recorder runs under the ``recorder`` fixture,
which stops the sentinel, restores both excepthooks, the SIGUSR1 handler
and every flag it set, unregisters the atexit backstop and clears the
ring, beacons, context and providers, so that the files run after this
one in a worker find the process as it was.
"""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from paddle_tpu.monitor import blackbox as jblackbox  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import monitor, trace  # noqa: E402
from paddle_tpu_torch.framework import io as pio  # noqa: E402
from paddle_tpu_torch.inference import ServingEngine  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.testing import failpoints  # noqa: E402

CFG = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
           max_seq_len=64, dropout=0.0)
FLAGS = ("blackbox", "blackbox_dir", "blackbox_ring", "stall_timeout_s",
         "blackbox_max_bundles")
TIMEOUT_S, POLL_S = 0.1, 0.02


@pytest.fixture
def recorder(tmp_path):
    """The recorder armed into tmp_path for one test, then put back."""
    from paddle_tpu_torch.monitor import blackbox as bb

    saved = pt.get_flags(list(FLAGS))
    hooks = (sys.excepthook, threading.excepthook,
             signal.getsignal(signal.SIGUSR1))
    providers = list(monitor._BB_PROVIDERS)
    pt.set_flags({"blackbox": True, "blackbox_dir": str(tmp_path),
                  "stall_timeout_s": 0.0})
    bb.sync_from_flag()
    try:
        yield bb
    finally:
        bb.stop_sentinel()
        bb.disable()
        bb.uninstall_hooks()
        bb.reset()
        pt.set_flags(saved)
        bb.set_capacity(int(pt.get_flag("blackbox_ring", 512)))
        with monitor._BB_PROVIDERS_LOCK:
            monitor._BB_PROVIDERS[:] = providers
        assert (sys.excepthook, threading.excepthook,
                signal.getsignal(signal.SIGUSR1)) == hooks
        assert not bb.sentinel_running()


@contextlib.contextmanager
def _tracing():
    was = trace.is_enabled()
    trace.enable()
    try:
        yield
    finally:
        (trace.enable if was else trace.disable)()


def _bundles(d):
    return sorted(p for p in Path(d).glob("blackbox-*.json"))


def _wait_for(pred, timeout=5.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.01)
    return True


@pytest.fixture(scope="module")
def model():
    pt.seed(0)
    torch.manual_seed(0)
    return GPTForCausalLM(GPTConfig(**CFG), device="cpu").eval()


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (k,)).astype(np.int32)
            for k in rng.randint(4, 12, n)]


def test_ring_capacity_and_drop_order(recorder):
    recorder.set_capacity(4)
    for i in range(6):
        recorder.note("unit", i=i)
    got = [r["i"] for r in recorder.ring()]
    assert got == [2, 3, 4, 5]          # oldest dropped first
    assert recorder.capacity() == 4
    assert recorder.ring_summary(2)["tail"][-1]["i"] == 5
    recorder.disable()
    recorder.note("unit", i=9)          # disabled: nothing lands
    assert [r["i"] for r in recorder.ring()] == [2, 3, 4, 5]


def test_window_beacons_are_refcounted_and_raw_beacons_wait_for_quiesce(
        recorder):
    with recorder.progress("unit/step"):
        with recorder.progress("unit/step"):
            assert recorder.beacons()["unit/step"]["active"]
        # the inner window closed; the outer one still runs
        assert recorder.beacons()["unit/step"]["active"]
        assert recorder.beacons()["unit/step"]["count"] == 2
    assert not recorder.beacons()["unit/step"]["active"]
    recorder.beacon("unit/raw")
    recorder.beacon("unit/raw")
    assert recorder.beacons()["unit/raw"] == dict(
        recorder.beacons()["unit/raw"], count=2, active=True)
    recorder.quiesce("unit/raw")
    assert not recorder.beacons()["unit/raw"]["active"]


def test_one_bundle_each_stall_episode(recorder, tmp_path):
    recorder.start_sentinel(timeout_s=TIMEOUT_S, poll_s=POLL_S)
    with recorder.progress("unit/loop"):
        assert _wait_for(lambda: len(_bundles(tmp_path)) == 1)
        time.sleep(4 * TIMEOUT_S)       # the same episode: no second one
        assert len(_bundles(tmp_path)) == 1
        recorder.beacon("unit/loop")    # the site advances: re-armed
        assert _wait_for(lambda: len(_bundles(tmp_path)) == 2)
    time.sleep(4 * TIMEOUT_S)           # the window closed: not stalled
    paths = _bundles(tmp_path)
    assert len(paths) == 2
    for p in paths:
        b = recorder.load_bundle(str(p))
        assert b["reason"] == "stall" and b["site"] == "unit/loop"
        assert b["extra"]["stall_timeout_s"] == TIMEOUT_S
    assert monitor.default_registry().get("blackbox_dump_total") \
        .labels(reason="stall").value >= 2


def test_port_bundle_passes_the_reference_validator(recorder, tmp_path,
                                                    model):
    eng = ServingEngine(model, max_batch=2)
    for p in _prompts(3):
        eng.submit(p, max_new_tokens=4)
    eng.step()
    with _tracing(), trace.span("unit/open", subsystem="unit"):
        path = recorder.dump("signal", site="unit")
    bundle = json.loads(Path(path).read_text())
    assert jblackbox.validate_bundle(bundle) == []
    assert jblackbox.load_bundle(path)["reason"] == "signal"
    assert recorder.validate_bundle(bundle) == []
    assert set(jblackbox.BUNDLE_KEYS) == set(recorder.BUNDLE_KEYS)
    tables = [t for t in bundle["requests"] if t["kind"] == "serving_engine"]
    assert any(t["table"]["in_flight"] == [0, 1, 2] for t in tables)
    assert any(s["name"] == "unit/open" for s in bundle["open_spans"])
    assert any(s["name"] == "MainThread" for s in bundle["stacks"])
    eng.run_until_complete()
    with pytest.raises(ValueError, match="missing required keys"):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"format": 1}))
        recorder.load_bundle(str(bad))


def test_sigusr1_and_excepthook_write_bundles(recorder, tmp_path):
    assert sys.excepthook is not sys.__excepthook__     # installed
    os.kill(os.getpid(), signal.SIGUSR1)
    assert _wait_for(lambda: any("-signal" in p.name
                                 for p in _bundles(tmp_path)))
    try:
        raise KeyError("unit")
    except KeyError:
        exc = sys.exc_info()
    with contextlib.redirect_stderr(io.StringIO()):
        sys.excepthook(*exc)
    crash = [p for p in _bundles(tmp_path) if p.name.endswith("-crash.json")]
    assert len(crash) == 1
    b = json.loads(crash[0].read_text())
    assert b["site"] == "excepthook" and "KeyError" in b["extra"]["exception"]


def test_span_checkpoint_and_hot_swap_notes(recorder, tmp_path, model):
    with _tracing(), trace.span("unit/span", subsystem="unit"):
        pass
    pio.save({"w": torch.zeros(3)}, str(tmp_path / "ck.pdparams"))
    eng = ServingEngine(model, max_batch=2)
    eng.hot_swap(model)
    kinds = [(r["kind"], r.get("name"), r.get("op")) for r in recorder.ring()]
    assert ("span_open", "unit/span", None) in kinds
    assert ("span", "unit/span", None) in kinds
    assert ("checkpoint", None, "save") in kinds
    swaps = [r for r in recorder.ring() if r["kind"] == "hot_swap"]
    assert len(swaps) == 1 and swaps[0]["version"] == str(
        eng._weight_version)


def test_host_stall_in_a_step_names_serving_step_with_every_request(
        recorder, tmp_path, model):
    eng = ServingEngine(model, max_batch=2)
    rids = [eng.submit(p, max_new_tokens=3) for p in _prompts(3, seed=1)]
    eng.step()                          # two running, one queued
    recorder.start_sentinel(timeout_s=TIMEOUT_S, poll_s=POLL_S)
    with failpoints.scoped("serving/step=delay:400"):
        eng.step()
    recorder.stop_sentinel()
    paths = _bundles(tmp_path)
    assert len(paths) == 1
    b = json.loads(paths[0].read_text())
    assert b["site"] == "serving/step" and b["reason"] == "stall"
    # the delay hits before the step counts itself
    table = [t["table"] for t in b["requests"]
             if t["kind"] == "serving_engine"
             and t["table"]["step_no"] == eng._step_no - 1]
    assert table and table[0]["in_flight"] == sorted(rids)
    assert len(table[0]["running"]) == 2 and len(table[0]["queued"]) == 1
    eng.run_until_complete()


def test_engine_stalled_names_the_bundle(recorder, tmp_path, model):
    eng = ServingEngine(model, max_batch=2)
    rids = [eng.submit(p, max_new_tokens=8) for p in _prompts(3, seed=2)]
    with pytest.raises(RuntimeError, match="engine_stalled") as err:
        eng.run_until_complete(max_steps=2)
    msg = str(err.value)
    assert "blackbox dump bundle: " in msg
    path = msg.split("blackbox dump bundle: ")[1].strip()
    b = recorder.load_bundle(path)
    assert b["site"] == "serving/step"
    assert b["extra"] == {"trigger": "run_until_complete", "max_steps": 2}
    table = [t["table"] for t in b["requests"]
             if t["kind"] == "serving_engine"
             and t["table"]["step_no"] == eng._step_no]
    assert table[0]["in_flight"] == sorted(rids)
    assert all(eng.get_request(r).finish_reason == "engine_stalled"
               for r in rids)


def test_disarmed_recorder_sites_cost_one_check():
    """With the flag off the facade imports nothing and hands back the
    shared null context."""
    assert not monitor.blackbox_on()
    assert monitor.bb_progress("unit") is monitor._BB_NULL_CM
    assert monitor.bb_dump("stall") is None


GATE_CODE = r"""
import json, sys, threading
import numpy as np, torch
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, GPTPretrainLoss
from paddle_tpu_torch.optimizer import AdamW
import paddle_tpu_torch.serving
hooks = (sys.excepthook, threading.excepthook)
pt.seed(0)
m = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                             num_heads=2, max_seq_len=40, dropout=0.0),
                   device="cpu")
t = SpmdTrainer(m, AdamW(learning_rate=1e-3, parameters=m.parameters()),
                loss_fn=GPTPretrainLoss())
ids = np.zeros((2, 40), np.int32)
t.train_step(ids, ids); t.train_step(ids, ids)
eng = ServingEngine(m.eval(), max_batch=2, prompt_buckets=(8, 32))
eng.submit(np.arange(5), max_new_tokens=3); eng.run_until_complete()
snap = monitor.snapshot()
names = sorted({k for k in (snap if isinstance(snap, dict) else {})})
print(json.dumps({
    "modules": sorted(m for m in sys.modules if m.startswith(
        "paddle_tpu_torch.") and m.rsplit(".", 1)[-1] in (
        "blackbox", "numerics", "perfledger", "router", "parity")),
    "threads": sorted(th.name for th in threading.enumerate()),
    "hooks_untouched": (sys.excepthook, threading.excepthook) == hooks,
    "series": sorted(mt.name for mt in monitor.default_registry().metrics()),
    "stats_numerics": t.stats()["numerics"],
}))
"""


@pytest.fixture(scope="module")
def gate():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FLAGS_")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", GATE_CODE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module,prefix", [
    ("blackbox", "blackbox_"), ("numerics", "numerics_"),
    ("perfledger", "perf_"), ("router", "router_")])
def test_unarmed_services_leave_no_trace(gate, module, prefix):
    assert not [m for m in gate["modules"] if m.endswith("." + module)]
    assert not [s for s in gate["series"] if s.startswith(prefix)]
    assert not [t for t in gate["threads"] if "sentinel" in t]
    assert gate["hooks_untouched"]
    assert gate["stats_numerics"] is None
    # the families the run itself records are there
    assert "step_latency_ms" in gate["series"]
