"""The port's optimizers (paddle_tpu_torch/optimizer/optimizer.py) against
the JAX package's: the same parameters and grads, made from a numpy seed,
go through the reference's ``functional_apply`` and the port's.

Tolerance: rtol 1e-6 / atol 1e-7 on parameters and moments in fp32 — the
same update rule in two frameworks, where only fused multiply-adds and
rounding order may differ. In bf16 (parameters, grads and moments), 0:
each op rounds its fp32 result to bf16 in both frameworks, in the same
order, so the two agree bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import build_mesh
from paddle_tpu.distributed.spmd import SpmdTrainer as JTrainer
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainLoss as JLoss

from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainLoss, opt_state_from_jax,
                                     params_from_jax)
from paddle_tpu_torch.optimizer import Adam, AdamW

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "ln.weight": (5,)}


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_cost_table():
    """The JAX trainer run here leaves the JAX package's cost registry as
    it found it, for the files that run after this one in a worker."""
    from paddle_tpu.trace import costs

    saved = dict(costs._TABLE)
    yield
    with costs._LOCK:
        costs._TABLE.clear()
        costs._TABLE.update(saved)


def _params(seed=0, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}


def _grads(step, shapes=SHAPES, std=0.1):
    rng = np.random.RandomState(100 + step)
    return {n: (rng.randn(*s) * std).astype(np.float32)
            for n, s in shapes.items()}


def _run_both(jopt, topt, steps, grads=_grads, shapes=SHAPES,
              dtype="float32"):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {n: jnp.asarray(a, dtype=jdt)
          for n, a in _params(shapes=shapes).items()}
    tp = {n: torch.from_numpy(a).to(tdt)
          for n, a in _params(shapes=shapes).items()}
    js, ts = jopt.functional_init(jp), topt.functional_init(tp)
    for i in range(steps):
        g = grads(i)
        jp, js = jopt.functional_apply(jp, {n: jnp.asarray(a, dtype=jdt)
                                            for n, a in g.items()}, js)
        tp, ts = topt.functional_apply(tp, {n: torch.from_numpy(a).to(tdt)
                                            for n, a in g.items()}, ts)
    return (jp, js), (tp, ts)


def _assert_state(j, t, shapes=SHAPES, rtol=RTOL, atol=ATOL):
    """Parameters and every state slot equal within the tolerance, each in
    the reference's dtype."""
    (jp, js), (tp, ts) = j, t

    def close(got, want):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, dtype=np.float32),
                                   rtol=rtol, atol=atol)

    for n in shapes:
        close(tp[n], jp[n])
        for k, v in js[n].items():
            close(ts[n][k], v)
    assert int(ts["__step__"]) == int(js["__step__"])


@pytest.mark.parametrize("name,kwargs,dtype", [
    ("Adam", {}, "float32"),
    ("Adam", dict(weight_decay=0.1, beta1=0.8, epsilon=1e-6), "float32"),
    ("AdamW", {}, "float32"),
    ("AdamW", dict(weight_decay=0.3, beta2=0.99), "float32"),
    ("Adam", {}, "bfloat16"),
    ("AdamW", {}, "bfloat16")],
    ids=["adam", "adam_l2", "adamw", "adamw_wd", "adam_bf16", "adamw_bf16"])
def test_functional_apply_matches_reference_over_5_steps(name, kwargs,
                                                         dtype):
    """fp32 on SHAPES; bf16 on a [64, 64] weight with lr 1e-3, grads of
    std 1e-3 (where fp32 moments gave 43 of 4,096 weights one bf16 step
    off the reference), equal bit for bit."""
    jopt = getattr(paddle.optimizer, name)(learning_rate=0.01, **kwargs)
    topt = {"Adam": Adam, "AdamW": AdamW}[name](learning_rate=0.01,
                                                **kwargs)
    if dtype == "float32":
        _assert_state(*_run_both(jopt, topt, 5))
        return
    shapes = {"fc.weight": (64, 64)}
    jopt.set_lr(1e-3)
    topt.set_lr(1e-3)
    run = _run_both(jopt, topt, 5, shapes=shapes, dtype=dtype,
                    grads=lambda i: _grads(i, shapes, std=1e-3))
    _assert_state(*run, shapes=shapes, rtol=0, atol=0)


def test_adamw_decays_biases_and_layernorm_weights():
    """With zero grads the Adam step is zero, so what moves is the decay,
    p * (1 - lr * wd), on every parameter: the reference's rule (its
    apply_decay_param_fun is stored and never read)."""
    def zeros(step):
        return {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}

    keep = lambda n: False     # would exempt everything, if it were read
    jopt = paddle.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                                  apply_decay_param_fun=keep)
    topt = AdamW(learning_rate=0.1, weight_decay=0.5,
                 apply_decay_param_fun=keep)
    j, t = _run_both(jopt, topt, 1, grads=zeros)
    _assert_state(j, t)
    for n, a in _params().items():
        np.testing.assert_allclose(t[0][n].numpy(), a * (1 - 0.1 * 0.5),
                                   rtol=1e-6)


def test_state_dict_keys_and_step_match_the_reference():
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    jlin = paddle.nn.Linear(3, 2)
    jopt = paddle.optimizer.AdamW(learning_rate=0.01,
                                  parameters=jlin.parameters())
    tlin = torch.nn.Linear(3, 2)
    topt = AdamW(learning_rate=0.01, parameters=tlin.parameters())
    for _ in range(2):
        jlin(paddle.to_tensor(x)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        tlin(torch.from_numpy(x)).sum().backward()
        topt.step()
        topt.clear_grad()
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert set(tsd) == set(jsd)
    assert tsd["step"] == jsd["step"] == 2
    # the bias (same layout in both) has the same moments
    for k in ("1_moment1", "1_moment2", "1_beta1_pow", "1_beta2_pow"):
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(jsd[k]._data),
                                   rtol=1e-5, atol=1e-7)
    assert all(p.grad is None for p in tlin.parameters())
    # set_state_dict restores into a fresh optimizer
    fresh = AdamW(learning_rate=0.01, parameters=tlin.parameters())
    fresh.set_state_dict(tsd)
    again = fresh.state_dict()
    assert set(again) == set(tsd) and again["step"] == 2
    for k, v in tsd.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(again[k], v)


def test_unported_options_raise():
    """LRScheduler rates, regularizer objects and grad_clip are ported
    (tests/test_torch_lr.py and test_torch_optimizers.py hold them against
    the reference); what stays refused is a learning rate or clip that is
    not the port's own: the JAX package's scheduler objects, or a
    grad_clip that is no clip."""
    from paddle_tpu.optimizer.lr import StepDecay

    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr
    from paddle_tpu_torch.regularizer import L2Decay

    with pytest.raises(TypeError, match="LRScheduler"):
        AdamW(learning_rate=StepDecay(0.1, step_size=2))
    with pytest.raises(TypeError, match="grad_clip"):
        AdamW(learning_rate=0.1, grad_clip=object())
    opt = Adam(learning_rate=lr.StepDecay(0.1, step_size=2),
               weight_decay=L2Decay(0.1),
               grad_clip=ClipGradByGlobalNorm(1.0))
    assert opt.get_lr() == 0.1 and opt._wd == 0.1 and opt._wd_is_l2


TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=128, dropout=0.0)


def test_opt_state_from_jax_resumes_a_jax_run():
    """Two steps in the JAX package, then its parameters and optimizer
    state carried across: the port's third step matches the JAX third
    step (losses and parameters within 1e-5)."""
    paddle.seed(0)
    jm = JGPT(JConfig(**TINY))
    jt = JTrainer(jm, paddle.optimizer.AdamW(learning_rate=1e-3,
                                             parameters=jm.parameters()),
                  loss_fn=JLoss(),
                  mesh=build_mesh((1,), ("dp",), devices=jax.devices()[:1]))
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 1024, (2, 128)).astype(np.int32),
                rng.randint(0, 1024, (2, 128)).astype(np.int32))
               for _ in range(3)]
    for ids, labels in batches[:2]:
        jt.train_step(paddle.to_tensor(ids), paddle.to_tensor(labels))
    named = {n: np.asarray(v) for n, v in jt.params.items()}
    state = jax.tree_util.tree_map(np.asarray, jt.opt_state)
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    tt = SpmdTrainer(tm, AdamW(learning_rate=1e-3,
                               parameters=tm.parameters()),
                     loss_fn=GPTPretrainLoss())
    tt.opt_state = opt_state_from_jax(state, device="cpu")
    assert int(tt.opt_state["__step__"]) == 2
    w = "gpt.blocks.0.attn.qkv.weight"
    np.testing.assert_array_equal(tt.opt_state[w]["moment1"].numpy(),
                                  state[w]["moment1"].T)
    ids, labels = batches[2]
    want = float(np.asarray(jt.train_step(paddle.to_tensor(ids),
                                          paddle.to_tensor(labels))._data))
    got = float(tt.train_step(ids, labels))
    assert abs(got - want) <= 1e-5
    assert int(tt.opt_state["__step__"]) == 3
    after = params_from_jax({n: np.asarray(v) for n, v in jt.params.items()})
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(),
                                   atol=1e-5, rtol=0)
