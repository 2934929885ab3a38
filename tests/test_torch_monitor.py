"""The port's metrics registry and exporters (paddle_tpu_torch/monitor/)
against the JAX package's (paddle_tpu/monitor/): the same recording
sequence gives equal snapshots and byte-equal Prometheus text, the label
cardinality cap collapses into the overflow series, and a disabled
registry (FLAGS_monitor=0) records nothing. Host-side code only: no
tolerance, every comparison is exact."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from paddle_tpu.monitor import exporters as jexp  # noqa: E402
from paddle_tpu.monitor import registry as jreg  # noqa: E402

from paddle_tpu_torch import flags as pflags  # noqa: E402
from paddle_tpu_torch import monitor  # noqa: E402
from paddle_tpu_torch.monitor import exporters as pexp  # noqa: E402
from paddle_tpu_torch.monitor import registry as preg  # noqa: E402


def _record(reg):
    """One recording sequence over every metric kind, labels, escapes and
    the histogram's bucket edges."""
    c = reg.counter("requests_total", "requests by code",
                    labelnames=("code",))
    c.labels(code="200").inc()
    c.labels(code="200").inc(2.5)
    c.labels(code='5"0\\0\n').inc()
    g = reg.gauge("occupancy", "slots in use")
    g.set(7)
    g.dec(2)
    g.inc(0.25)
    h = reg.histogram("latency_ms", "step ms", labelnames=("kind",))
    for v in (0.01, 0.05, 0.3, 1.0, 7.5, 99.0, 12000.0):
        h.labels(kind="decode").observe(v)
    h.labels(kind="prefill").observe(3.0)
    hb = reg.histogram("bytes", buckets=(10, 100, 1000))
    for v in (5, 10, 11, 5000):
        hb.observe(v)
    reg.counter("unused_total", "declared, never incremented")
    return reg


def test_same_sequence_same_snapshot_and_prometheus_text():
    want = _record(jreg.StatRegistry()).snapshot()
    got = _record(preg.StatRegistry()).snapshot()
    assert got == want
    text = pexp.to_prometheus(got)
    assert text == jexp.to_prometheus(want)
    assert pexp.to_json(got) == jexp.to_json(want)
    assert pexp.flatten(got) == jexp.flatten(want)
    assert pexp.parse_prometheus(text) == jexp.parse_prometheus(text)
    parsed = pexp.parse_prometheus(text)
    assert parsed[("requests_total", frozenset({("code", "200")}))] == 3.5
    assert parsed[("latency_ms_count",
                   frozenset({("kind", "decode")}))] == 7
    summaries = {"latency_ms{kind=decode}": {"p50": 1.0, "p90": 99.0,
                                             "p99": 10000.0}}
    assert pexp.to_prometheus(got, summaries) \
        == jexp.to_prometheus(want, summaries)


def test_histogram_summary_quantiles_match():
    reg_j, reg_p = jreg.StatRegistry(), preg.StatRegistry()
    rng = np.random.RandomState(0)
    vals = rng.exponential(20.0, 500)
    for reg in (reg_j, reg_p):
        h = reg.histogram("ms")
        for v in vals:
            h.observe(float(v))
    assert reg_p.get("ms").summary() == reg_j.get("ms").summary()


def test_label_cardinality_cap_and_overflow():
    for reg in (preg.StatRegistry(), jreg.StatRegistry()):
        c = reg.counter("sig_total", labelnames=("sig",))
        for i in range(preg.LABEL_CARDINALITY_CAP + 6):
            c.labels(sig=f"s{i}").inc()
        series = reg.snapshot()["metrics"][0]["series"]
        assert len(series) == preg.LABEL_CARDINALITY_CAP + 1
        over = [s for s in series
                if s["labels"]["sig"] == preg.OVERFLOW_LABEL]
        assert over and over[0]["value"] == 6
        assert c.labels(sig="never-seen").value == 6   # reads the overflow


def test_reset_keeps_handles_and_kind_conflicts_raise():
    reg = preg.StatRegistry()
    c = reg.counter("x_total", labelnames=("a",))
    bound = c.labels(a="1")
    bound.inc(3)
    reg.reset()
    assert bound.value == 0
    bound.inc()
    assert reg.counter("x_total", labelnames=("a",)) is c
    assert bound.value == 1
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total", labelnames=("b",))
    with pytest.raises(ValueError):
        c.labels(a="1").inc(-1)


def test_disabled_registry_records_nothing():
    reg = preg.StatRegistry(enabled=False)
    _record(reg)
    snap = reg.snapshot()
    assert snap["enabled"] is False
    for m in snap["metrics"]:
        for s in m["series"]:
            assert s.get("value", 0) == 0 and s.get("count", 0) == 0
    # the default registry: disable() turns recording off, enable() on
    c = monitor.counter("test_torch_monitor_total")
    try:
        monitor.disable()
        c.inc()
        monitor.STAT_ADD("test_torch_monitor_stat", 5)
        assert c.value == 0
        assert monitor.gauge("test_torch_monitor_stat").value == 0
        with monitor.timed(monitor.histogram("test_torch_monitor_ms")):
            pass
        assert monitor.histogram("test_torch_monitor_ms").count == 0
    finally:
        monitor.enable()
    c.inc()
    monitor.STAT_ADD("test_torch_monitor_stat", 5)
    monitor.STAT_SUB("test_torch_monitor_stat", 2)
    assert c.value == 1
    assert monitor.gauge("test_torch_monitor_stat").value == 3
    monitor.STAT_RESET("test_torch_monitor_stat")
    assert monitor.gauge("test_torch_monitor_stat").value == 0


def test_flags_monitor_0_disables_the_default_registry_at_import():
    code = ("import paddle_tpu_torch.monitor as m; "
            "c = m.counter('x_total'); c.inc(); "
            "print(m.is_enabled(), c.value)")
    env = dict(os.environ, FLAGS_monitor="0", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "0.0"]


def test_unported_flags_refused():
    """Only the AOT cache's flag is left unported; the recorder, the
    telescope and the ledger load lazily and accept their flags."""
    assert set(pflags.NOT_PORTED) == {"jit_cache_dir"}
    with pytest.raises(NotImplementedError, match="framework/aot.py"):
        pflags.set_flags({"FLAGS_jit_cache_dir": "/tmp/cache"})
    pflags.set_flags({"jit_cache_dir": ""})   # disarming is fine
    saved = pflags.get_flags(["blackbox", "numerics", "perf_ledger"])
    try:
        pflags.set_flags({"FLAGS_blackbox": True, "numerics": True,
                          "perf_ledger": True})
    finally:
        pflags.set_flags(saved)
    assert monitor.numerics.STAT_KEYS[0] == "grad_norm"
    assert monitor.perfledger.SCHEMA_VERSION == 1
    assert monitor.bb_dump("x") is None and not monitor.blackbox_on()


def test_tensor_nbytes_and_log_event(tmp_path):
    assert monitor.tensor_nbytes(torch.zeros(3, 4, dtype=torch.bfloat16)) \
        == 24
    assert monitor.tensor_nbytes(np.zeros((2, 5), np.float32)) == 40
    assert monitor.tensor_nbytes(object()) == 0
    path = str(tmp_path / "events.jsonl")
    rec = monitor.log_event("unit", _path=path, step=3)
    assert rec["event"] == "unit" and rec["step"] == 3
    assert monitor.log_event("unit") is None     # no path configured
    monitor.log_snapshot(monitor.snapshot(), _path=path)
    assert len(Path(path).read_text().splitlines()) == 2
