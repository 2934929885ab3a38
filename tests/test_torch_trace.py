"""The port's tracing, cost registry and profiler (paddle_tpu_torch/trace/,
trace/costs.py, profiler/) against the JAX package's: span nesting,
parents and trace ids; span logs and chrome exports read across the two
packages; the cost table and the peak lookups; and the flop formulas of
the port's kernel ops (counted on meta tensors, which run the ops' fake
implementations) against their analytic counts. Host-side code only: every
comparison is exact."""
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import trace as jtrace  # noqa: E402

from paddle_tpu_torch import flags as pflags  # noqa: E402
from paddle_tpu_torch import profiler, trace  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import tpp  # noqa: E402
from paddle_tpu_torch.trace import costs  # noqa: E402


@pytest.fixture
def traced():
    trace.clear()
    with trace.scoped_enabled(True):
        yield
    trace.clear()


def test_disabled_span_is_a_noop():
    with trace.scoped_enabled(False):
        before = len(trace.spans())
        with trace.span("x") as sp:
            sp.set(a=1)
        trace.start_span("y").end()
        trace.emit("z", 0, 1)
        assert len(trace.spans()) == before


def test_nesting_parents_and_trace_ids(traced):
    with trace.span("root", subsystem="trainer", step=1) as root:
        with trace.span("child") as child:
            trace.current_span().set(k="v")
        explicit = trace.start_span("explicit", parent=root)
        trace.emit("emitted", 10, 20, parent=child)
        explicit.end(done=True)
    other = trace.start_span("other")
    other.end()
    by = {s.name: s for s in trace.spans()}
    assert by["child"].parent_id == root.span_id
    assert by["child"].trace_id == root.trace_id
    assert by["child"].attrs == {"k": "v"}
    assert by["explicit"].parent_id == root.span_id
    assert by["explicit"].trace_id == root.trace_id
    assert by["emitted"].parent_id == child.span_id
    assert by["emitted"].trace_id == root.trace_id
    assert (by["emitted"].start_ns, by["emitted"].end_ns) == (10, 20)
    assert by["other"].parent_id is None
    assert by["other"].trace_id != root.trace_id
    assert root.duration_ms >= by["child"].duration_ms >= 0
    assert trace.open_spans() == []
    summ = trace.summary()
    assert summ["root"]["count"] == 1
    assert [r[0] for r in trace.top_spans(1)] == ["root"]
    try:
        with trace.span("fails"):
            raise KeyError("x")
    except KeyError:
        pass
    assert trace.spans()[-1].attrs["error"] is True


def test_ring_buffer_capacity(traced):
    cap = trace.capacity()
    try:
        trace.set_capacity(4)
        for i in range(7):
            trace.emit(f"s{i}", i, i + 1)
        assert [s.name for s in trace.spans()] == ["s3", "s4", "s5", "s6"]
    finally:
        trace.set_capacity(cap)


def _spans_into_log(tmod, flags_mod, path):
    flags_mod.set_flags({"trace_log_path": path})
    try:
        with tmod.scoped_enabled(True):
            with tmod.span("request", subsystem="serving", rid=3) as r:
                tmod.emit("decode", 5, 9, subsystem="serving", parent=r,
                          token=17)
    finally:
        flags_mod.set_flags({"trace_log_path": ""})
        tmod.clear()


def test_span_logs_read_across_packages(tmp_path):
    ours, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    _spans_into_log(trace, pflags, ours)
    _spans_into_log(jtrace, paddle.flags, theirs)
    for got in (jtrace.load_spans(ours), trace.load_spans(theirs)):
        assert [s["name"] for s in got] == ["decode", "request"]
        dec, req = got
        assert dec["parent_id"] == req["span_id"]
        assert dec["trace_id"] == req["trace_id"]
        assert dec["attrs"]["token"] == 17 and req["attrs"]["rid"] == 3
    keys = lambda recs: [sorted(r) for r in recs]  # noqa: E731
    assert keys(trace.load_spans(ours)) == keys(jtrace.load_spans(theirs))


def _chrome(tmod, path):
    tmod.clear()
    with tmod.scoped_enabled(True):
        with tmod.span("train_step", subsystem="trainer", step=0) as sp:
            tmod.add_counter_sample("trainer_step_ms", 1.5)
            tmod.emit("inner", sp.start_ns, sp.start_ns + 1000,
                      subsystem="trainer")
        tmod.start_span("checkpoint/save", subsystem="io").end(bytes=8)
    doc = tmod.export_chrome(path, include_host_events=False)
    tmod.clear()
    return doc


def test_chrome_exports_agree(tmp_path):
    ours = _chrome(trace, str(tmp_path / "p.json"))
    theirs = _chrome(jtrace, str(tmp_path / "j.json"))
    shape = lambda d: sorted(  # noqa: E731
        (e["name"], e["ph"], e.get("cat"), tuple(sorted(e.get("args", {}))))
        for e in d["traceEvents"])
    assert shape(ours) == shape(theirs)
    on_disk = json.loads((tmp_path / "p.json").read_text())
    assert shape(on_disk) == shape(ours)
    assert on_disk["displayTimeUnit"] == "ms"


def test_profiler_record_events_and_summary(tmp_path):
    profiler.start_profiler()
    for _ in range(3):
        with profiler.RecordEvent("outer"):
            with profiler.RecordEvent("inner"):
                pass
    rows = profiler.stop_profiler("calls")
    assert {r["name"]: r["calls"] for r in rows} == {"outer": 3, "inner": 3}
    for key in ("total", "calls", "avg", "ave", "max", "min"):
        assert len(profiler.summary(key)) == 2
    events = profiler.host_events()
    assert [e[4] for e in events[:2]] == [0, 1]      # depth: outer, inner
    path = profiler.export_chrome_tracing(str(tmp_path / "t.json"))
    names = {e["name"] for e in json.loads(Path(path).read_text())
             ["traceEvents"] if e.get("cat") == "host"}
    assert names == {"outer", "inner"}
    with profiler.RecordEvent("off"):      # profiler stopped: not kept
        pass
    assert "off" not in {e[0] for e in profiler.host_events()}


def test_cost_registry_and_peaks():
    costs.reset()
    try:
        e = costs.record("trainer", "int64[2,8]", 1e9, 4e6,
                         {"peak_bytes": 10, "argument_bytes": 4,
                          "temp_bytes": 6})
        assert costs.get("trainer", "int64[2,8]") == e
        assert e["flops"] == 1e9 and e["peak_bytes"] == 10
        costs.record_manual("tpp", "k", flops=5, bytes_accessed=2)
        m = costs.record_manual("tpp", "k", flops=5, bytes_accessed=2)
        assert (m["flops"], m["calls"]) == (10.0, 2)
        assert len(costs.table()) == 2
    finally:
        costs.reset()
    assert costs.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert costs.peak_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert costs.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert costs.peak_flops("some other accelerator") == 1e12
    assert costs.peak_hbm_bandwidth("some other accelerator") == 1e11
    assert costs.peak_flops(torch.device("cpu")) == 1e12
    try:
        pflags.set_flags({"device_peak_flops": 123e12})
        assert costs.peak_flops("NVIDIA H100 80GB HBM3") == 123e12
    finally:
        pflags.set_flags({"device_peak_flops": 0.0})
    assert costs.sample_device_memory() == {}     # no CUDA device here


def test_count_one_call():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with costs.count("cpu") as c:
        out = a @ b
    assert torch.equal(out, a @ b)
    assert c.flops == 2 * 8 * 16 * 4
    assert c.bytes_accessed == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.memory == {}


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 100), (True, 1000)])
def test_flash_flop_formulas(causal, window):
    B, S, H, D = 2, 256, 3, 64
    q, lse = _meta(B, S, H, D), _meta(B * H, S)
    keep = sum(min(i + 1, window or S) if causal else S for i in range(S))
    with FlopCounterMode(display=False) as fwd:
        fa._flash_fwd_op(q, q, q, causal, 0.125, window)
    with FlopCounterMode(display=False) as bwd:
        fa._flash_bwd_op(q, q, q, q, lse, q, causal, 0.125, window)
    assert fwd.get_total_flops() == 4 * D * keep * B * H
    assert bwd.get_total_flops() == (6 + 8) * D * keep * B * H


def test_tpp_matmul_flop_formula():
    x, w = _meta(4096, 768), _meta(768, 3072)
    with FlopCounterMode(display=False) as c:
        tpp._tpp_matmul_op(x, w, _meta(3072), "none", "gelu", None, None)
    assert c.get_total_flops() == 2 * 4096 * 768 * 3072


def test_trace_module_is_callable_as_the_matrix_trace_op():
    x = torch.arange(12.0).reshape(3, 4)
    assert float(trace(x)) == 0 + 5 + 10
    assert float(trace(x, offset=1)) == 1 + 6 + 11
