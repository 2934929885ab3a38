"""The serving engine's runtime services in the port (paddle_tpu_torch/
inference/serving.py with serving/paging.py and serving/disagg.py): on a
narrow GPT (vocab 256, hidden 64, 2 layers, 4 heads, max_seq 128, fp32,
random weights from a seed) the tokens are EQUAL with every flag off, with
the defaults (monitor on) and with monitor, trace and goodput on, on the
dense, chunked, async, paged, speculative and disaggregated paths;
``stats()["breakdown"]`` holds each step kind with its FLOPs while
tracing; every request carries a trace_id and its span tree; the
``serving/slot`` failpoint ends exactly one request; the metric families
are the JAX package's. Also ``GPTDecodeModel.lora_init``'s device."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import paddle_tpu.inference.serving  # noqa: E402,F401  (its families)
import paddle_tpu.serving.disagg  # noqa: E402,F401
import paddle_tpu.serving.paging  # noqa: E402,F401
from paddle_tpu import monitor as jmonitor  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import monitor, trace  # noqa: E402
from paddle_tpu_torch.inference import ServingEngine  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import decode_model  # noqa: E402
from paddle_tpu_torch.serving.disagg import DisaggregatedPool  # noqa: E402
from paddle_tpu_torch.testing import failpoints  # noqa: E402

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
N_REQ, NEW = 6, 12


@pytest.fixture(scope="module")
def model():
    pt.seed(0)
    torch.manual_seed(0)
    return GPTForCausalLM(GPTConfig(**CFG), device="cpu").eval()


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (n,)).astype(np.int32)
            for n in rng.randint(5, 30, N_REQ)]


def _drain(eng, prompts=None):
    prompts = _prompts() if prompts is None else prompts
    rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    res = eng.run_until_complete()
    return [res[r] for r in rids]


class _Modes:
    """Set the runtime flags for a with-block, restoring them after."""

    def __init__(self, monitor_on, trace_on, goodput_on=False, **flags):
        self.want = (monitor_on, trace_on, goodput_on, flags)

    def __enter__(self):
        monitor_on, trace_on, goodput_on, flags = self.want
        self.old = (monitor.is_enabled(), trace.is_enabled(),
                    {k: pt.get_flag(k) for k in ("goodput", *flags)})
        (monitor.enable if monitor_on else monitor.disable)()
        (trace.enable if trace_on else trace.disable)()
        pt.set_flags(dict(flags, goodput=goodput_on))
        trace.clear()

    def __exit__(self, *exc):
        (monitor.enable if self.old[0] else monitor.disable)()
        (trace.enable if self.old[1] else trace.disable)()
        pt.set_flags(self.old[2])
        trace.clear()


@pytest.fixture(scope="module")
def plain(model):
    with _Modes(False, False):
        return [r.output_ids for r in _drain(ServingEngine(model,
                                                           max_batch=4))]


def test_tokens_equal_with_flags_off_default_and_on(model, plain):
    with _Modes(True, False):
        assert [r.output_ids for r in _drain(ServingEngine(
            model, max_batch=4))] == plain
    tokens = monitor.counter("serving_tokens_total")
    n0 = tokens.value
    with _Modes(True, True, goodput_on=True):
        eng = ServingEngine(model, max_batch=4)
        reqs = _drain(eng)
        spans = trace.spans()
        bd = eng.stats()["breakdown"]
    assert [r.output_ids for r in reqs] == plain
    assert tokens.value - n0 == N_REQ * NEW
    assert {"prefill", "decode_greedy"} <= set(bd["kinds"])
    for kind in ("prefill", "decode_greedy"):
        row = bd["kinds"][kind]
        assert row["device_flops_total"] > 0 and row["wall_ms"] > 0
        assert row["flops_per_call"] * row["count"] == pytest.approx(
            row["device_flops_total"])
    assert bd["device_flops_total"] > 0 and bd["mfu"] > 0
    h, L, V, T = 64, 2, 256, 128
    decode = bd["kinds"]["decode_greedy"]["flops_per_call"]
    # 4 rows: the block's matmuls, the tied head, and q.k / p.v over all
    # T cache columns
    assert decode == 4 * (2 * (12 * h * h * L + h * V) + L * 4 * T * h)
    by_trace = {}
    for sp in spans:
        by_trace.setdefault(sp.trace_id, []).append(sp)
    for r in reqs:
        st = r.stats()
        assert st["trace_id"] is not None
        names = sorted({sp.name for sp in by_trace[st["trace_id"]]})
        assert names == ["decode", "prefill", "queue_wait", "request"]
        root = [sp for sp in by_trace[st["trace_id"]]
                if sp.name == "request"][0]
        assert root.attrs["finish_reason"] == "length"
        assert root.attrs["new_tokens"] == NEW


@pytest.mark.parametrize("path", ["chunked", "async", "paged",
                                  "speculative", "pool"])
def test_traced_paths_keep_their_tokens(model, plain, path):
    extra = {"async": {"async_dispatch": True},
             "paged": {"paged_kv": True}}.get(path, {})
    with _Modes(True, True, **extra):
        if path == "pool":
            pool = DisaggregatedPool(model, decode_engines=2, max_batch=2)
            rids = [pool.submit(p, max_new_tokens=NEW) for p in _prompts()]
            res = pool.run_until_complete()
            got = [res[r].output_ids for r in rids]
            names = {sp.name for sp in trace.spans()}
            assert "kv_handoff" in names and "request" in names
            kinds = set()
        else:
            kw = {"chunked": {"prefill_chunk": 8},
                  "speculative": {"draft_model": model}}.get(path, {})
            eng = ServingEngine(model, max_batch=4, **kw)
            got = [r.output_ids for r in _drain(eng)]
            kinds = set(eng.stats()["breakdown"]["kinds"])
            bd = eng.stats()["breakdown"]
        names = {sp.name for sp in trace.spans()}
    assert got == plain
    want = {"chunked": ({"prefill_chunk", "decode_greedy"},
                        {"prefill_chunk"}),
            "async": ({"prefill", "decode_greedy"}, {"dispatch/decode",
                                                     "dispatch/overlap",
                                                     "dispatch/fetch"}),
            "paged": ({"prefill", "decode_greedy"}, {"prefill"}),
            "speculative": ({"speculative"}, {"spec_draft",
                                              "spec_verify"}),
            "pool": (set(), {"kv_handoff"})}[path]
    assert want[0] <= kinds and want[1] <= names
    if path == "async":
        assert bd["async_overlap"]["rounds"] > 0


def test_serving_slot_error_ends_one_request(model, plain):
    with _Modes(True, True):
        eng = ServingEngine(model, max_batch=4)
        rids = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
        for _ in range(3):
            eng.step()
        with failpoints.scoped("serving/slot=error:1"):
            eng.step()
        res = eng.run_until_complete()
    reqs = [res[r] for r in rids]
    failed = [i for i, r in enumerate(reqs) if r.finish_reason == "error"]
    assert len(failed) == 1 and failpoints.hits("serving/slot") == 1
    for i, r in enumerate(reqs):
        if i not in failed:
            assert r.output_ids == plain[i] and r.finish_reason == "length"
    assert eng.health()["state"] == "degraded"
    with failpoints.scoped("serving/step=error:1"):
        with pytest.raises(failpoints.FailpointError):
            eng.step()


def test_metric_families_match_the_reference():
    # every serving family the port declares exists in the JAX package
    # with the same type, labels and help (one scraper reads both); the
    # two lineage families are lazy there (FLAGS_goodput), and arming
    # them would leave series that the JAX package's own tests forbid
    theirs = {m["name"]: (m["type"], m["labelnames"], m["help"])
              for m in jmonitor.snapshot()["metrics"]}
    ours = {m["name"]: (m["type"], m["labelnames"], m["help"])
            for m in monitor.snapshot()["metrics"]
            if m["name"].startswith(("serving_", "request_", "kv_"))
            and m["name"] not in ("serving_weight_version",
                                  "serving_stale_sessions_total")}
    assert len(ours) >= 14
    for name, kind in ours.items():
        assert theirs.get(name) == kind, name


def test_lora_init_default_device_is_cuda():
    dm = decode_model.resolve(GPTForCausalLM(GPTConfig(**CFG),
                                             device="cpu"), None)
    cfg = GPTConfig(**CFG)
    pack = dm.lora_init(cfg, 3, 4, device="cpu")
    assert pack["scale"].device.type == "cpu"
    assert pack["qkv"]["A"].shape == (3, CFG["num_layers"], 64, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dm.lora_init(cfg, 3, 4)
    else:
        assert dm.lora_init(cfg, 3, 4)["scale"].device.type == "cuda"
