"""The port's training path (paddle_tpu_torch/distributed/spmd.py over the
GPT, the cross-entropy, AdamW and auto_cast) against the JAX package's
SpmdTrainer on the CPU: the same numpy weights go into both packages
(params_from_jax), and both see the same ids and labels.

Tolerances:
- fp32: losses and final parameters within 1e-5 after 3 AdamW steps —
  the same math in two frameworks, where only summation order differs.
- bf16 auto_cast: both packages round the loss to bf16 (the reference's
  cross_entropy returns the logits' dtype), so each loss is within one
  bf16 step of the other (2^-7 of its magnitude); the parameters' total
  update after 3 steps within 15% (relative L2). bf16 rounds at other
  places in the two frameworks, and Adam's normalised step turns a
  rounding-sized grad difference into a full lr-sized step wherever a
  grad is near zero; the reading was 4-5% at lr 1e-3 and 1e-4.

Run ``python tests/test_torch_trainer.py --write-train-fixture`` to rewrite
the committed training fixture of the narrow seq-1024 model (chip_smoke.py
phase 3); test_committed_train_fixture_matches_jax checks it still
matches.
"""
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.mesh import build_mesh  # noqa: E402
from paddle_tpu.distributed.spmd import SpmdTrainer as JTrainer  # noqa: E402
from paddle_tpu.models import GPTConfig as JConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainLoss as JLoss  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainLoss, params_from_jax)
from paddle_tpu_torch.nn.functional import cross_entropy  # noqa: E402
from paddle_tpu_torch.ops import tpp  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.testing import golden  # noqa: E402

TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=128, dropout=0.0)
LR = 1e-4
FP32_TOL = 1e-5
BF16_UPDATE_RTOL = 0.15
FLAGS = ("tpp_kernels", "check_nan_inf", "max_skip_steps",
         "quantized_allreduce")


@pytest.fixture(autouse=True)
def _restore_flags():
    """Every flag a test here sets, in either package, is restored."""
    saved = (paddle.get_flags(list(FLAGS)), pt.get_flags(list(FLAGS)))
    yield
    paddle.set_flags(saved[0])
    pt.set_flags(saved[1])
    for name in FLAGS:
        for mod, old in ((paddle, saved[0]), (pt, saved[1])):
            if name not in old and mod.get_flags([name]):
                mod.set_flags({name: False if name != "max_skip_steps"
                               else 3})


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_cost_table():
    """The JAX trainers run here leave the JAX package's cost registry as
    they found it, for the files that run after this one in a worker."""
    from paddle_tpu.trace import costs

    saved = dict(costs._TABLE)
    yield
    with costs._LOCK:
        costs._TABLE.clear()
        costs._TABLE.update(saved)


def _mesh():
    return build_mesh((1,), ("dp",), devices=jax.devices()[:1])


def _amp(mod, on):
    return mod.amp.auto_cast(True, dtype="bfloat16") if on \
        else contextlib.nullcontext()


def _jax_gpt_trainer(cfg, params=None, lr=LR, seed=0):
    paddle.seed(seed)
    jm = JGPT(JConfig(**cfg))
    if params is not None:
        for n, p in jm.named_parameters():
            p.set_value(params[n])
    opt = paddle.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters())
    return jm, JTrainer(jm, opt, loss_fn=JLoss(), mesh=_mesh())


def _port_gpt_trainer(cfg, named, lr=LR):
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    opt = AdamW(learning_rate=lr, parameters=tm.parameters())
    return tm, SpmdTrainer(tm, opt, loss_fn=GPTPretrainLoss())


def _batch(cfg, b=2, seed=0):
    rng = np.random.RandomState(seed)
    s, v = cfg["max_seq_len"], cfg["vocab_size"]
    return (rng.randint(0, v, (b, s)).astype(np.int32),
            rng.randint(0, v, (b, s)).astype(np.int32))


def _train_both(amp, tpp_on, steps=3):
    paddle.set_flags({"tpp_kernels": tpp_on})
    pt.set_flags({"tpp_kernels": tpp_on})
    jm, jt = _jax_gpt_trainer(TINY)
    init = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm, tt = _port_gpt_trainer(TINY, init)
    ids, labels = _batch(TINY)
    jl, tl = [], []
    for _ in range(steps):
        with _amp(paddle, amp):
            jl.append(float(np.asarray(jt.train_step(
                paddle.to_tensor(ids), paddle.to_tensor(labels))._data)))
        with _amp(pt, amp):
            tl.append(float(tt.train_step(ids, labels)))
    final = params_from_jax({n: np.asarray(v) for n, v in jt.params.items()})
    return jl, tl, params_from_jax(init), final, dict(tm.named_parameters())


@pytest.mark.parametrize("tpp_on", [False, True], ids=["dense", "tpp"])
def test_fp32_steps_match_the_jax_trainer(tpp_on):
    jl, tl, _, want, got = _train_both(False, tpp_on)
    np.testing.assert_allclose(tl, jl, atol=FP32_TOL, rtol=0)
    assert tl[-1] < tl[0]
    for n, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("tpp_on", [False, True], ids=["dense", "tpp"])
def test_bf16_auto_cast_steps_match_the_jax_trainer(tpp_on):
    jl, tl, init, want, got = _train_both(True, tpp_on)
    for a, b in zip(tl, jl):
        assert a == np.float32(a).astype(np.float32)
        assert abs(a - b) <= abs(b) * 2.0 ** -7, (tl, jl)
    num = sum(float(((got[n].detach() - init[n]) - (want[n] - init[n]))
                    .norm() ** 2) for n in got)
    den = sum(float((want[n] - init[n]).norm() ** 2) for n in got)
    assert (num / den) ** 0.5 <= BF16_UPDATE_RTOL


def test_bf16_auto_cast_follows_the_reference_op_lists(monkeypatch):
    """Under auto_cast the Linear layers and the tied head run in bf16
    (q/k/v and the logits are bf16), the residual stream and LayerNorms
    stay fp32, the loss comes back in the logits' dtype (bf16) after an
    fp32 reduction, and the TPP hook hands its kernel the fp32 residual
    stream and fp32 weights, as models/gpt.py:297 does."""
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    seen = {}

    def record(name):
        def hook(mod, inputs, out):
            seen.setdefault(name, out.dtype)
        return hook

    blk = tm.gpt.blocks[0]
    blk.attn.qkv.register_forward_hook(record("qkv"))
    blk.ln1.register_forward_hook(record("ln1"))
    blk.register_forward_hook(record("residual"))
    runs = []
    real_run = tpp._run

    def spy(x, w, *a, **k):
        runs.append((x.dtype, w.dtype))
        return real_run(x, w, *a, **k)

    ids, labels = _batch(TINY)
    pt.set_flags({"tpp_kernels": True})
    monkeypatch.setattr(tpp, "_run", spy)
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        logits = tm(torch.from_numpy(ids).long())
        loss = cross_entropy(logits.reshape(-1, TINY["vocab_size"]),
                             torch.from_numpy(labels).reshape(-1))
    assert seen == {"qkv": torch.bfloat16, "ln1": torch.float32,
                    "residual": torch.float32}
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.bfloat16
    assert runs and all(d == (torch.float32, torch.float32) for d in runs)
    assert pt.amp.amp_dtype() is None


def test_auto_cast_state_and_unported_options():
    assert pt.amp.amp_dtype() is None
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        assert pt.amp.amp_dtype() == torch.bfloat16
        assert pt.amp.amp_state()["enabled"] is True
        with pt.amp.amp_guard(False):
            assert pt.amp.amp_dtype() is None
        assert pt.amp.amp_dtype() == torch.bfloat16
    assert pt.amp.amp_state()["enabled"] is False
    # O2 and the custom lists are stored and read by nothing, as in the
    # reference (tests/test_torch_grad_scaler.py holds them against it)
    for kwargs in (dict(level="O2"), dict(custom_white_list={"gelu"}),
                   dict(custom_black_list={"linear"})):
        with pt.amp.auto_cast(True, **kwargs):
            assert pt.amp.amp_dtype() == torch.bfloat16
    assert pt.amp.amp_state()["level"] == "O1"
    with pytest.raises(ValueError, match="dtype"):
        with pt.amp.auto_cast(True, dtype="int8"):
            pass


def test_cross_entropy_matches_reference():
    from paddle_tpu.nn import functional as JF

    rng = np.random.RandomState(2)
    logits = rng.randn(12, 7).astype(np.float32)
    labels = rng.randint(0, 7, (12,)).astype(np.int64)
    labels[[1, 5]] = -100
    for reduction in ("mean", "sum", "none"):
        want = np.asarray(JF.cross_entropy(
            paddle.to_tensor(logits), paddle.to_tensor(labels),
            reduction=reduction)._data)
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), reduction=reduction)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # the other options (tests/test_torch_loss.py holds each of them)
    soft = np.full((12, 7), 1 / 7, np.float32)
    for kwargs, label in ((dict(soft_label=True), soft),
                          (dict(label_smoothing=0.1), labels),
                          (dict(weight=np.ones(7, np.float32)), labels),
                          (dict(use_softmax=False), labels)):
        x = np.abs(logits) if "use_softmax" in kwargs else logits
        want = np.asarray(JF.cross_entropy(
            paddle.to_tensor(x), paddle.to_tensor(label),
            **{k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()})._data)
        got = cross_entropy(
            torch.from_numpy(x), torch.from_numpy(label),
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_model_loss_and_dropout_in_train_mode():
    """GPTForCausalLM.loss is the pretrain loss of its logits; train mode
    with dropout draws masks from the default generator, so a reseed
    repeats them."""
    cfg = {**TINY, "dropout": 0.1}
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ids, labels = (torch.from_numpy(a).long() for a in _batch(TINY))
    tm.eval()
    with torch.no_grad():
        a = tm.loss(ids, labels)
        b = GPTPretrainLoss()(tm(ids), labels)
    assert torch.equal(a, b)
    tm.train()
    pt.seed(5)
    with torch.no_grad():
        c = tm.loss(ids, labels)
    pt.seed(5)
    with torch.no_grad():
        d = tm.loss(ids, labels)
        e = tm.loss(ids, labels)
    assert torch.equal(c, d) and not torch.equal(d, e)
    assert not torch.equal(a, c)


# ---- the non-finite guard ---------------------------------------------------

def _linear_pair():
    w = np.random.RandomState(3).randn(4, 1).astype(np.float32)
    jlin = paddle.nn.Linear(4, 1)
    jlin.weight.set_value(w)
    jlin.bias.set_value(np.zeros((1,), np.float32))
    jt = JTrainer(jlin, paddle.optimizer.AdamW(
        learning_rate=0.1, parameters=jlin.parameters()),
        loss_fn=paddle.nn.MSELoss(), mesh=_mesh())
    tlin = torch.nn.Linear(4, 1)
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(w.T))
        tlin.bias.zero_()
    tt = SpmdTrainer(tlin, AdamW(learning_rate=0.1,
                                 parameters=tlin.parameters()),
                     loss_fn=torch.nn.MSELoss())
    return jt, tt


def _snapshot_jax(jt):
    return jax.tree_util.tree_map(np.array, (jt.params, jt.opt_state))


def _snapshot_port(tt):
    return ({n: p.detach().clone() for n, p in tt.params.items()},
            {n: ({k: v.clone() for k, v in s.items()}
                 if isinstance(s, dict) else s.clone())
             for n, s in tt.opt_state.items()},
            tt.optimizer._step_count)


def test_nonfinite_guard_skips_bit_identically_and_aborts_the_streak():
    paddle.set_flags({"check_nan_inf": True, "max_skip_steps": 3})
    pt.set_flags({"check_nan_inf": True, "max_skip_steps": 3})
    jt, tt = _linear_pair()
    x = np.random.RandomState(4).randn(8, 4).astype(np.float32)
    y = np.ones((8, 1), np.float32)
    bad = x.copy()
    bad[2, 1] = np.nan
    jt.train_step(x, y)
    tt.train_step(x, y)
    jbefore, tbefore = _snapshot_jax(jt), _snapshot_port(tt)
    assert np.isnan(float(np.asarray(jt.train_step(bad, y)._data)))
    assert np.isnan(float(tt.train_step(bad, y)))
    jafter, tafter = _snapshot_jax(jt), _snapshot_port(tt)
    for a, b in zip(jax.tree_util.tree_leaves(jbefore),
                    jax.tree_util.tree_leaves(jafter)):
        np.testing.assert_array_equal(a, b)
    for n in tbefore[0]:
        assert torch.equal(tbefore[0][n], tafter[0][n])
        for k in tbefore[1][n]:
            assert torch.equal(tbefore[1][n][k], tafter[1][n][k])
    assert torch.equal(tbefore[1]["__step__"], tafter[1]["__step__"])
    assert tafter[2] == tbefore[2] == 1
    jstats, tstats = jt.stats(), tt.stats()
    assert jt.optimizer._step_count == 1
    for key in ("nonfinite_skipped_total", "nonfinite_streak"):
        assert tstats["breakdown"][key] == jstats["breakdown"][key] == 1
    # a clean step ends the streak in both packages
    jt.train_step(x, y)
    tt.train_step(x, y)
    assert jt.stats()["breakdown"]["nonfinite_streak"] == 0
    assert tt.stats()["breakdown"]["nonfinite_streak"] == 0
    # max_skip_steps + 1 consecutive skips abort: the port in the step
    # that makes the streak too long, the reference once it learns of it
    for _ in range(3):
        jt.train_step(bad, y)
        tt.train_step(bad, y)
    jt.train_step(bad, y)
    with pytest.raises(FloatingPointError, match="consecutive"):
        jt.guard_sync()
    with pytest.raises(FloatingPointError, match="consecutive"):
        tt.train_step(bad, y)
    assert tt.stats()["breakdown"]["nonfinite_skipped_total"] == 5


# ---- constructor, stats ------------------------------------------------------

class _TwoDeviceMesh:
    devices = np.arange(2)


@pytest.mark.parametrize("kwargs", [
    dict(mesh=_TwoDeviceMesh()), dict(sharding_stage=2),
    dict(localsgd_k=2), dict(extra_param_specs={"w": None}),
    dict(dgc_rampup=1), dict(recompute=True, remat_offload=True)],
    ids=["mesh2", "zero", "localsgd", "tp_specs", "extra_knob",
         "remat_offload"])
def test_refused_constructor_options_raise(kwargs):
    lin = torch.nn.Linear(4, 1)
    with pytest.raises(NotImplementedError, match="not ported"):
        SpmdTrainer(lin, AdamW(parameters=lin.parameters()), **kwargs)


def test_compressed_dp_flags_and_foreign_optimizers_are_refused():
    lin = torch.nn.Linear(4, 1)
    pt.set_flags({"quantized_allreduce": True})
    with pytest.raises(NotImplementedError, match="quantized_allreduce"):
        SpmdTrainer(lin, AdamW(parameters=lin.parameters()))
    pt.set_flags({"quantized_allreduce": False})
    with pytest.raises(TypeError, match="optimizer"):
        SpmdTrainer(lin, torch.optim.AdamW(lin.parameters()))
    # one device is accepted in each spelling
    for mesh in (None, "cpu", torch.device("cpu")):
        SpmdTrainer(lin, AdamW(parameters=lin.parameters()), mesh=mesh)


def test_stats_keys_are_the_references():
    jt, tt = _linear_pair()
    x = np.ones((8, 4), np.float32)
    y = np.zeros((8, 1), np.float32)
    for _ in range(2):
        jt.train_step(x, y)
        tt.train_step(x, y)
    js, ts = jt.stats(), tt.stats()
    assert set(ts) <= set(js)
    assert set(ts["breakdown"]) <= set(js["breakdown"])
    assert {"steps", "step_ms_total", "step_ms_avg", "flops_per_step", "mfu",
            "hbm", "peak_flops"} <= set(ts)
    assert ts["steps"] == js["steps"] == 2
    assert ts["step_ms_avg"] == pytest.approx(ts["step_ms_total"] / 2)
    # without FLAGS_trace nothing is counted; the peak is the nominal
    # 1e12 of an unknown kind in both packages
    assert all(ts[k] is None for k in ("flops_per_step", "mfu", "hbm"))
    assert ts["peak_flops"] == js["peak_flops"] == 1e12


def test_trainer_without_loss_fn_calls_the_layer_with_the_label():
    class WithLoss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 1)

        def forward(self, x, label):
            return torch.nn.functional.mse_loss(self.lin(x), label)

    m = WithLoss()
    tt = SpmdTrainer(m, AdamW(learning_rate=0.01, parameters=m.parameters()))
    x = np.random.RandomState(5).randn(8, 4).astype(np.float32)
    y = x.sum(-1, keepdims=True)
    losses = [float(tt.train_step(x, y)) for _ in range(3)]
    assert losses[-1] < losses[0]


# ---- the narrow model's committed training fixture --------------------------

def _jax_train_golden():
    """The JAX package's SpmdTrainer on the narrow seq-1024 model: losses
    and kept parameter rows after golden.TRAIN_STEPS steps, in fp32 and
    under bf16 auto_cast (each from the same weights and fresh state)."""
    ids, labels = golden.input_ids(), golden.train_labels()
    out = {}
    for tag, amp in (("fp32", False), ("bf16", True)):
        _, jt = _jax_gpt_trainer(golden.NARROW, golden.jax_layout_params(),
                                 lr=golden.TRAIN_LR)
        losses = []
        for _ in range(golden.TRAIN_STEPS):
            with _amp(paddle, amp):
                losses.append(float(np.asarray(jt.train_step(
                    paddle.to_tensor(ids), paddle.to_tensor(labels))._data)))
        out[f"loss_{tag}"] = np.asarray(losses, np.float32)
        rows = golden.kept_rows({n: np.asarray(v)
                                 for n, v in jt.params.items()})
        for n, r in rows.items():
            out[f"rows_{tag}__{n}"] = r.astype(np.float32)
    return out


def test_committed_train_fixture_matches_jax():
    fix = np.load(golden.TRAIN_FIXTURE)
    want = _jax_train_golden()
    assert set(fix.files) == set(want)
    np.testing.assert_allclose(fix["loss_fp32"], want["loss_fp32"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(fix["loss_bf16"], want["loss_bf16"],
                               atol=0.04, rtol=0)
    for key in want:
        if key.startswith("rows_fp32"):
            np.testing.assert_allclose(fix[key], want[key], atol=1e-6, rtol=0)
    # bf16: the rows' update, by the measure chip_smoke.py holds the card to
    rows = {tag: {n: src[f"rows_bf16__{n}"] for n in golden.KEPT_PARAMS}
            for tag, src in (("fix", fix), ("want", want))}
    assert golden.update_rel_err(rows["fix"], rows["want"]) \
        <= golden.TRAIN_BF16_UPDATE_RTOL


def test_port_trains_to_the_committed_fixture_on_cpu():
    """The card's phase-3 fp32 check, on the CPU (plain versions)."""
    fix = np.load(golden.TRAIN_FIXTURE)
    tm, tt = _port_gpt_trainer(golden.NARROW, golden.jax_layout_params(),
                               lr=golden.TRAIN_LR)
    ids, labels = golden.input_ids(), golden.train_labels()
    losses = [float(tt.train_step(ids, labels))
              for _ in range(golden.TRAIN_STEPS)]
    np.testing.assert_allclose(losses, fix["loss_fp32"], atol=1e-4, rtol=0)
    for n, r in golden.port_kept_rows(dict(tm.named_parameters())).items():
        np.testing.assert_allclose(r, fix[f"rows_fp32__{n}"], atol=1e-4,
                                   rtol=0)


class _ZeroGrad(torch.autograd.Function):
    """Identity whose backward returns zeros: a control for the bf16 row
    measure."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


@pytest.mark.parametrize("zero", [None, "dq", "dkv"])
def test_bf16_update_measure_passes_the_port_and_fails_a_zeroed_grad(
        zero, monkeypatch):
    """The narrow model's 3 bf16 auto_cast steps on the CPU (plain
    versions) against the committed JAX fixture, by the measure the card
    is held to: within golden.TRAIN_BF16_UPDATE_RTOL, and outside it when
    attention's dQ, or its dK and dV, are zero."""
    from paddle_tpu_torch.models import gpt

    real = gpt.scaled_dot_product_attention

    def sdpa(q, k, v, *args, **kwargs):
        if zero == "dq":
            q = _ZeroGrad.apply(q)
        elif zero == "dkv":
            k, v = _ZeroGrad.apply(k), _ZeroGrad.apply(v)
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(gpt, "scaled_dot_product_attention", sdpa)
    fix = np.load(golden.TRAIN_FIXTURE)
    tm, tt = _port_gpt_trainer(golden.NARROW, golden.jax_layout_params(),
                               lr=golden.TRAIN_LR)
    ids, labels = golden.input_ids(), golden.train_labels()
    for _ in range(golden.TRAIN_STEPS):
        with _amp(pt, True):
            tt.train_step(ids, labels)
    err = golden.update_rel_err(
        golden.port_kept_rows(dict(tm.named_parameters())),
        {n: fix[f"rows_bf16__{n}"] for n in golden.KEPT_PARAMS})
    if zero is None:
        assert err <= golden.TRAIN_BF16_UPDATE_RTOL
    else:
        assert err > 3 * golden.TRAIN_BF16_UPDATE_RTOL


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_training_step_launches_bf16_flash_and_fp32_tpp_on_card(cuda):
    """A bf16 auto_cast step of the narrow model (seq 1024) runs the bf16
    flash forward, delta pre-pass, dQ and dK/dV kernels once per layer,
    the dQ and dK/dV kernels on the tensor cores, and the TPP kernel (with
    its LN row-statistics pre-pass) in fp32 only (the reference hands it
    the fp32 residual stream)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    pt.set_flags({"tpp_kernels": True})
    tm = GPTForCausalLM(GPTConfig(**golden.NARROW), device=cuda,
                        generator=torch.Generator().manual_seed(0))
    tt = SpmdTrainer(tm, AdamW(learning_rate=1e-4,
                               parameters=tm.parameters()),
                     loss_fn=GPTPretrainLoss())
    before = {**fa.launches, **tpp.launches}
    routes = dict(fa.routes)
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        loss = tt.train_step(golden.input_ids(), golden.train_labels())
    after = {**fa.launches, **tpp.launches}
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    layers = golden.NARROW["num_layers"]
    assert delta == {"flash_fwd:bfloat16": layers,
                     "flash_delta:bfloat16": layers,
                     "flash_dq:bfloat16": layers,
                     "flash_dkv:bfloat16": layers,
                     "tpp_matmul.ln:float32": layers,
                     "tpp_matmul.in_act:float32": layers,
                     "tpp_row_stats:float32": layers}
    for kind in ("fwd", "dq", "dkv"):
        key = f"flash_{kind}:bfloat16:mma"
        assert fa.routes[key] - routes.get(key, 0) == layers
    assert bool(torch.isfinite(loss))


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-train-fixture"]:
        sys.exit("usage: python tests/test_torch_trainer.py "
                 "--write-train-fixture")
    jax.config.update("jax_platforms", "cpu")
    golden.TRAIN_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(golden.TRAIN_FIXTURE, **_jax_train_golden())
    print(f"wrote {golden.TRAIN_FIXTURE}")
