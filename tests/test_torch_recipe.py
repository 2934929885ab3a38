"""The GPT pretraining recipe (warmup plus cosine LR, global-norm clipping,
gradient merge and recompute) on the narrow seq-1024 model, against the
JAX package's SpmdTrainer: the committed fixture
(golden.RECIPE_FIXTURE, written by the JAX package) and the port's run of
it on the CPU, plus the launch counts of the recipe on the card.

Bands, those of the narrow model's plain training phase (chip_smoke.py):
- fp32: losses and kept rows within 1e-4 of the fixture (they read ~1e-6
  on the CPU: the same math, summed in another order); the global norms
  within 1e-4 relative.
- bf16 auto_cast: losses within 2^-5, the kept rows' update within
  golden.TRAIN_BF16_UPDATE_RTOL (golden.update_rel_err), the norms within
  2% relative (the grads of a bf16 forward, rounded at other places).
- The learning rates are the same floats: the schedule is the same
  python arithmetic in both packages.
- Control: the same run without the clip lies more than 1e-4 from the
  fixture's fp32 rows (it reads ~3e-4), so the row check sees the clip.

Run ``python tests/test_torch_recipe.py --write-fixture`` to rewrite the
committed fixture (~20 s); test_committed_recipe_fixture_matches_jax
checks that it still matches a fresh run.
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
from paddle_tpu.optimizer.lr import CosineAnnealingDecay as JCosine  # noqa: E402
from paddle_tpu.optimizer.lr import LinearWarmup as JWarmup  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainLoss, params_from_jax)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.testing import golden  # noqa: E402

FP32_TOL = 1e-4
BF16_LOSS_TOL = 2.0 ** -5
NORM_RTOL = {"fp32": 1e-4, "bf16": 0.02}


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


def _amp(mod, on):
    return mod.amp.auto_cast(True, dtype="bfloat16") if on \
        else contextlib.nullcontext()


class _NormAdamW(paddle.optimizer.AdamW):
    """The JAX package's AdamW, noting the global norm of the grads each
    update sees (before its clip) through a host callback."""

    def __init__(self, norms, **kwargs):
        self._norms = norms
        super().__init__(**kwargs)

    def functional_apply(self, params, grads, states, lr=None):
        sq = sum(jnp.sum(g.astype(jnp.float32) ** 2) for g in grads.values())
        jax.debug.callback(lambda v: self._norms.append(float(v)),
                           jnp.sqrt(sq))
        return super().functional_apply(params, grads, states, lr)


def _jax_recipe(amp):
    """(losses, lrs, norms, kept rows) of the JAX package's recipe run."""
    paddle.seed(golden.SEED)
    jm = JGPT(JConfig(**golden.NARROW))
    init = golden.jax_layout_params()
    for n, p in jm.named_parameters():
        p.set_value(init[n])
    sched = JWarmup(JCosine(golden.RECIPE_LR, T_max=golden.RECIPE_STEPS),
                    warmup_steps=golden.RECIPE_WARMUP, start_lr=0.0,
                    end_lr=golden.RECIPE_LR)
    norms = []
    opt = _NormAdamW(norms, learning_rate=sched, parameters=jm.parameters(),
                     grad_clip=paddle.nn.ClipGradByGlobalNorm(
                         golden.RECIPE_CLIP))
    jt = JTrainer(jm, opt, loss_fn=JLoss(),
                  mesh=build_mesh((1,), ("dp",), devices=jax.devices()[:1]),
                  accumulate_steps=golden.RECIPE_ACCUM, recompute=True)
    ids, labels = golden.recipe_batch()
    losses, lrs = [], []
    for _ in range(golden.RECIPE_STEPS):
        lrs.append(opt.get_lr())
        with _amp(paddle, amp):
            losses.append(float(np.asarray(jt.train_step(
                paddle.to_tensor(ids), paddle.to_tensor(labels))._data)))
        sched.step()
    jax.effects_barrier()
    rows = golden.kept_rows({n: np.asarray(v) for n, v in jt.params.items()})
    return losses, lrs, norms, rows


def _jax_recipe_golden():
    out = {}
    for tag, amp in (("fp32", False), ("bf16", True)):
        losses, lrs, norms, rows = _jax_recipe(amp)
        out[f"loss_{tag}"] = np.asarray(losses, np.float32)
        out[f"norm_{tag}"] = np.asarray(norms, np.float32)
        out["lr"] = np.asarray(lrs, np.float64)
        for n, r in rows.items():
            out[f"rows_{tag}__{n}"] = r.astype(np.float32)
    return out


def port_recipe(amp, clip=True, device="cpu"):
    """(losses, lrs, norms, kept rows) of the port's recipe run."""
    m = GPTForCausalLM(GPTConfig(**golden.NARROW), device=device)
    m.load_state_dict(params_from_jax(golden.jax_layout_params()))
    sched = golden.recipe_schedule()
    opt = AdamW(learning_rate=sched, parameters=m.parameters(),
                grad_clip=ClipGradByGlobalNorm(golden.RECIPE_CLIP)
                if clip else None)
    tr = SpmdTrainer(m, opt, loss_fn=GPTPretrainLoss(),
                     accumulate_steps=golden.RECIPE_ACCUM, recompute=True)
    ids, labels = golden.recipe_batch()
    losses, lrs, norms = [], [], []
    for _ in range(golden.RECIPE_STEPS):
        lrs.append(opt.get_lr())
        with _amp(pt, amp):
            losses.append(float(tr.train_step(ids, labels)))
        if clip:
            norms.append(float(opt._global_norm))
        sched.step()
    return losses, lrs, norms, golden.port_kept_rows(
        dict(m.named_parameters()))


def _rows(src, tag):
    return {n: src[f"rows_{tag}__{n}"] for n in golden.KEPT_PARAMS}


def test_committed_recipe_fixture_matches_jax():
    fix = np.load(golden.RECIPE_FIXTURE)
    want = _jax_recipe_golden()
    assert set(fix.files) == set(want)
    np.testing.assert_array_equal(fix["lr"], want["lr"])
    np.testing.assert_allclose(fix["loss_fp32"], want["loss_fp32"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(fix["loss_bf16"], want["loss_bf16"],
                               atol=0.04, rtol=0)
    for tag in ("fp32", "bf16"):
        np.testing.assert_allclose(fix[f"norm_{tag}"], want[f"norm_{tag}"],
                                   rtol=NORM_RTOL[tag])
        # the clip binds at every step of the run
        assert (fix[f"norm_{tag}"] > golden.RECIPE_CLIP).all()
    for key in want:
        if key.startswith("rows_fp32"):
            np.testing.assert_allclose(fix[key], want[key], atol=1e-6, rtol=0)
    assert golden.update_rel_err(_rows(fix, "bf16"), _rows(want, "bf16")) \
        <= golden.TRAIN_BF16_UPDATE_RTOL


@pytest.mark.parametrize("tag", ["fp32", "bf16"])
def test_port_runs_the_recipe_to_the_fixture_on_cpu(tag):
    fix = np.load(golden.RECIPE_FIXTURE)
    losses, lrs, norms, rows = port_recipe(tag == "bf16")
    assert lrs == fix["lr"].tolist()
    np.testing.assert_allclose(norms, fix[f"norm_{tag}"],
                               rtol=NORM_RTOL[tag])
    want = _rows(fix, tag)
    if tag == "fp32":
        np.testing.assert_allclose(losses, fix["loss_fp32"], atol=FP32_TOL,
                                   rtol=0)
        for n in rows:
            np.testing.assert_allclose(rows[n], want[n], atol=FP32_TOL,
                                       rtol=0)
    else:
        np.testing.assert_allclose(losses, fix["loss_bf16"],
                                   atol=BF16_LOSS_TOL, rtol=0)
        assert golden.update_rel_err(rows, want) \
            <= golden.TRAIN_BF16_UPDATE_RTOL


def test_the_row_check_fails_without_the_clip():
    fix = np.load(golden.RECIPE_FIXTURE)
    _, _, _, rows = port_recipe(False, clip=False)
    want = _rows(fix, "fp32")
    assert max(float(np.abs(rows[n] - want[n]).max()) for n in rows) \
        > FP32_TOL


def test_recipe_schedule_matches_the_reference_and_reads_no_extra_step():
    """The schedule's learning rates over twice the run: warmup, then the
    cosine from its epoch 1; reading the optimizer's rate twice shifts
    nothing (it reads scheduler(), never get_lr())."""
    sched = golden.recipe_schedule()
    ref = JWarmup(JCosine(golden.RECIPE_LR, T_max=golden.RECIPE_STEPS),
                  warmup_steps=golden.RECIPE_WARMUP, start_lr=0.0,
                  end_lr=golden.RECIPE_LR)
    opt = AdamW(learning_rate=sched, parameters=[torch.zeros(1)])
    got, want = [], []
    for _ in range(2 * golden.RECIPE_STEPS):
        opt.get_lr()
        got.append(opt.get_lr())
        want.append(ref())
        sched.step()
        ref.step()
    assert got == want
    assert got[:4] == [0.0, golden.RECIPE_LR / 2,
                       pytest.approx(golden.RECIPE_LR * (1 + 2 ** -0.5) / 2),
                       pytest.approx(golden.RECIPE_LR / 2)]


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch",
                                    "nothing", "everything"])
def test_recipe_step_launches_on_card(cuda, policy):
    """One recipe step (two micro-batches, recompute) launches the flash
    forward twice per layer and micro-batch (the forward and the
    recompute), except under ``everything``, whose checkpoint keeps the
    forward kernel's outputs; the delta pre-pass, dQ and dK/dV once per
    layer and micro-batch."""
    from paddle_tpu_torch.ops import flash_attention as fa

    m = GPTForCausalLM(GPTConfig(**golden.NARROW), device=cuda)
    m.load_state_dict(params_from_jax(golden.jax_layout_params()))
    kwargs = {} if policy is None else {"recompute_policy": policy}
    tr = SpmdTrainer(m, AdamW(learning_rate=golden.recipe_schedule(),
                              parameters=m.parameters(),
                              grad_clip=ClipGradByGlobalNorm(
                                  golden.RECIPE_CLIP)),
                     loss_fn=GPTPretrainLoss(),
                     accumulate_steps=golden.RECIPE_ACCUM, recompute=True,
                     **kwargs)
    ids, labels = golden.recipe_batch()
    fa.launches.clear()
    tr.train_step(ids, labels)
    layers = golden.NARROW["num_layers"] * golden.RECIPE_ACCUM
    fwd = layers if policy == "everything" else 2 * layers
    assert dict(fa.launches) == {"flash_fwd:float32": fwd,
                                 "flash_delta:float32": layers,
                                 "flash_dq:float32": layers,
                                 "flash_dkv:float32": layers}


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_recipe.py --write-fixture")
    jax.config.update("jax_platforms", "cpu")
    out = _jax_recipe_golden()
    np.savez_compressed(golden.RECIPE_FIXTURE, **out)
    print(f"wrote {golden.RECIPE_FIXTURE}: losses {out['loss_fp32']} / "
          f"{out['loss_bf16']}, norms {out['norm_fp32']} / "
          f"{out['norm_bf16']}, lr {out['lr']}")
