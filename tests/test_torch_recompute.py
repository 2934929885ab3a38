"""The port's SpmdTrainer with recompute, recompute policies, gradient
merge (``accumulate_steps``) and ``return_outputs`` against the JAX
package's SpmdTrainer on the CPU, from the same numpy weights and batch.

Bands:
- fp32 losses, parameters, BatchNorm running statistics and returned
  outputs within 1e-5 of the JAX trainer's after 3 steps (the same math in
  two frameworks, summed in another order);
- the port's run with ``recompute=True`` (every policy) equal BIT FOR BIT
  to its run without: on the GPT at dropout 0.1 (the recompute draws the
  forward's masks from the port's generators) and on a BatchNorm model
  under ``accumulate_steps=2`` (the recompute leaves the running
  statistics as the forward left them).
"""
import functools
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
                                     GPTPretrainLoss, params_from_jax,
                                     state_from_jax)
from paddle_tpu_torch.optimizer import AdamW, Momentum  # noqa: E402

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.0)
TOL = 1e-5
LR = 1e-4
POLICIES = [None, "dots", "dots_no_batch", "nothing", "everything"]


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


def _policy(policy):
    return {} if policy is None else {"recompute_policy": policy}


def _gpt_batch(b=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, TINY["vocab_size"], (b, TINY["max_seq_len"]))
            .astype(np.int32),
            rng.randint(0, TINY["vocab_size"], (b, TINY["max_seq_len"]))
            .astype(np.int32))


@functools.lru_cache(maxsize=None)
def _init():
    """The JAX package's initial GPT weights (seed 0), as numpy arrays."""
    paddle.seed(0)
    return {n: np.asarray(p._data)
            for n, p in JGPT(JConfig(**TINY)).named_parameters()}


def _jax_gpt(**kwargs):
    paddle.seed(0)
    jm = JGPT(JConfig(**TINY))
    init = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    jt = JTrainer(jm, paddle.optimizer.AdamW(learning_rate=LR,
                                             parameters=jm.parameters()),
                  loss_fn=JLoss(), mesh=_mesh(), **kwargs)
    ids, labels = _gpt_batch()
    losses = [float(np.asarray(jt.train_step(
        paddle.to_tensor(ids), paddle.to_tensor(labels))._data))
        for _ in range(3)]
    final = params_from_jax({n: np.asarray(v) for n, v in jt.params.items()})
    return init, losses, final, jt


def _port_gpt(init, cfg=TINY, steps=3, **kwargs):
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(init))
    tt = SpmdTrainer(tm, AdamW(learning_rate=LR,
                               parameters=tm.parameters()),
                     loss_fn=GPTPretrainLoss(), **kwargs)
    ids, labels = _gpt_batch()
    losses = [float(tt.train_step(ids, labels)) for _ in range(steps)]
    return losses, {n: p.detach().clone() for n, p in tm.named_parameters()}, \
        tt


def _close(got, want, tol=TOL):
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w), atol=tol,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_matches_the_jax_trainer_and_the_plain_step(policy):
    init, jl, jfinal, _ = _jax_gpt(recompute=True, **_policy(policy))
    tl, tfinal, _ = _port_gpt(init, recompute=True, **_policy(policy))
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
    _close(tfinal, jfinal)
    pl, pfinal, _ = _port_gpt(init)
    assert tl == pl
    assert all(torch.equal(tfinal[n], pfinal[n]) for n in pfinal)


@pytest.mark.parametrize("recompute", [False, True])
def test_gradient_merge_and_returned_outputs_match_the_jax_trainer(
        recompute):
    """accumulate_steps=2: the two micro-batches' mean loss and grads, one
    update; last_outputs the full batch's logits."""
    init, jl, jfinal, jt = _jax_gpt(accumulate_steps=2, recompute=recompute,
                                    return_outputs=True)
    tl, tfinal, tt = _port_gpt(init, accumulate_steps=2, recompute=recompute,
                               return_outputs=True)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
    _close(tfinal, jfinal)
    want = np.asarray(jt.last_outputs._data)
    got = tt.last_outputs
    assert tuple(got.shape) == want.shape == (4, TINY["max_seq_len"],
                                              TINY["vocab_size"])
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_gradient_merge_is_the_mean_of_the_micro_batches():
    """One merged step from zero state equals the update of the two
    micro-batches' averaged grads, and the loss their mean."""
    init = _init()
    merged, mparams, _ = _port_gpt(init, steps=1, accumulate_steps=2)
    ids, labels = _gpt_batch()
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    tm.load_state_dict(params_from_jax(init))
    loss_fn = GPTPretrainLoss()
    parts = []
    for half in (slice(0, 2), slice(2, 4)):
        loss = loss_fn(tm(torch.as_tensor(ids[half]).long()),
                       torch.as_tensor(labels[half]).long()).float()
        loss.backward()
        parts.append(float(loss.detach()))
    assert merged[0] == pytest.approx(sum(parts) / 2, abs=1e-6)
    grads = {n: p.grad / 2 for n, p in tm.named_parameters()}
    opt = AdamW(learning_rate=LR)
    params = dict(tm.named_parameters())
    with torch.no_grad():
        opt.functional_apply(params, grads, opt.functional_init(params))
    for n, p in params.items():
        torch.testing.assert_close(mparams[n], p.detach(), atol=1e-7, rtol=0)


def test_return_outputs_without_accumulation_and_without_a_loss_fn():
    init, _, _, jt = _jax_gpt(return_outputs=True)
    _, _, tt = _port_gpt(init, return_outputs=True)
    np.testing.assert_allclose(tt.last_outputs.numpy(),
                               np.asarray(jt.last_outputs._data), atol=TOL,
                               rtol=0)

    class WithLoss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 1)

        def forward(self, x, label):
            return torch.nn.functional.mse_loss(self.lin(x), label)

    m = WithLoss()
    tr = SpmdTrainer(m, AdamW(parameters=m.parameters()),
                     return_outputs=True, metrics_fn=lambda *a: 1 / 0)
    tr.train_step(np.ones((2, 4), np.float32), np.ones((2, 1), np.float32))
    assert tr.last_outputs is None      # metrics_fn is never called


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_under_recompute_is_bit_equal(policy):
    """dropout 0.1: the recompute draws the forward's masks, so the losses
    and parameters equal those of the run without recompute; and they
    differ from a run whose masks differ (another seed)."""
    pl, pp = _dropout_run(3)
    rl, rp = _dropout_run(3, recompute=True, **_policy(policy))
    assert rl == pl and _dropout_run(4)[0] != pl
    assert all(torch.equal(rp[n], pp[n]) for n in pp)


@functools.lru_cache(maxsize=None)
def _dropout_run(seed, **kwargs):
    """(losses, parameters) of the port at dropout 0.1 under two
    micro-batches, from generator seed `seed`."""
    pt.seed(seed)
    return _port_gpt(_init(), {**TINY, "dropout": 0.1}, accumulate_steps=2,
                     **kwargs)[:2]


# ---- a BatchNorm model under gradient merge and recompute -----------------

class _JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = paddle.nn.Conv2D(3, 8, 3, padding=1)
        self.bn = paddle.nn.BatchNorm2D(8)
        self.fc = paddle.nn.Linear(8, 5)

    def forward(self, x):
        h = paddle.nn.functional.relu(self.bn(self.conv(x)))
        return self.fc(h.mean(axis=[2, 3]))


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = pt.nn.Conv2D(3, 8, 3, padding=1)
        self.bn = pt.nn.BatchNorm2D(8)
        self.fc = pt.nn.Linear(8, 5)

    def forward(self, x):
        h = torch.relu(self.bn(self.conv(x)))
        return self.fc(h.mean(dim=(2, 3)))


def _bn_batch():
    rng = np.random.RandomState(7)
    return (rng.randn(4, 3, 8, 8).astype(np.float32),
            rng.randint(0, 5, (4,)).astype(np.int64))


def _bn_state():
    rng = np.random.RandomState(8)
    shapes = {"conv.weight": (8, 3, 3, 3), "conv.bias": (8,),
              "bn.weight": (8,), "bn.bias": (8,), "bn._mean": (8,),
              "bn._variance": (8,), "fc.weight": (8, 5), "fc.bias": (5,)}
    st = {n: (0.3 * rng.randn(*s)).astype(np.float32)
          for n, s in shapes.items()}
    st["bn.weight"] += 1.0
    st["bn._variance"] = np.abs(st["bn._variance"]) + 0.5
    return st


def _bn_port(**kwargs):
    m = _TNet()
    m.load_state_dict(state_from_jax(_bn_state(), m))
    tr = SpmdTrainer(m, Momentum(learning_rate=0.1, parameters=m.parameters()),
                     loss_fn=pt.nn.CrossEntropyLoss(), **kwargs)
    x, y = _bn_batch()
    losses = [float(tr.train_step(x, y)) for _ in range(3)]
    return losses, {n: t.detach().clone() for n, t in m.state_dict().items()}


def test_batchnorm_under_gradient_merge_and_recompute_matches_jax():
    jm = _JNet()
    st = _bn_state()
    for n, t in jm.state_dict().items():
        t.set_value(st[n])
    jt = JTrainer(jm, paddle.optimizer.Momentum(learning_rate=0.1,
                                                parameters=jm.parameters()),
                  loss_fn=paddle.nn.CrossEntropyLoss(), mesh=_mesh(),
                  accumulate_steps=2, recompute=True)
    x, y = _bn_batch()
    jl = [float(np.asarray(jt.train_step(paddle.to_tensor(x),
                                         paddle.to_tensor(y))._data))
          for _ in range(3)]
    want = {**{n: np.asarray(v) for n, v in jt.params.items()},
            **{n: np.asarray(v) for n, v in jt.buffers.items()}}
    want = {n: v.numpy() for n, v in state_from_jax(want, _TNet()).items()}
    tl, got = _bn_port(accumulate_steps=2, recompute=True)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
    _close(got, want)
    # the step keeps the last micro-batch's statistics, each micro-batch
    # starting from the step's: not the first micro-batch's, nor both
    # compounded
    once, _ = _bn_port()
    assert not np.allclose(once, jl, atol=TOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_batchnorm_recompute_is_bit_equal(policy):
    plain = _bn_port(accumulate_steps=2)
    again = _bn_port(accumulate_steps=2, recompute=True, **_policy(policy))
    assert again[0] == plain[0]
    assert all(torch.equal(again[1][n], plain[1][n]) for n in plain[1])


# ---- what stays refused, and the reference's own errors -------------------

def _lin():
    lin = torch.nn.Linear(4, 1)
    return lin, AdamW(parameters=lin.parameters())


def test_policy_errors_are_the_references():
    lin, opt = _lin()
    with pytest.raises(ValueError, match="recompute_policy must be one of"):
        SpmdTrainer(lin, opt, recompute=True, recompute_policy="most")
    with pytest.raises(ValueError, match="requires recompute=True"):
        SpmdTrainer(lin, opt, recompute_policy="dots")
    with pytest.raises(NotImplementedError, match="remat_offload"):
        SpmdTrainer(lin, opt, recompute=True, remat_offload=True)
    tr = SpmdTrainer(lin, opt, accumulate_steps=3, loss_fn=torch.nn.MSELoss())
    with pytest.raises(ValueError, match="must divide"):
        tr.train_step(np.ones((4, 4), np.float32), np.ones((4, 1), np.float32))
