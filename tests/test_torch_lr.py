"""The port's learning-rate schedules (paddle_tpu_torch/optimizer/lr.py)
against the JAX package's (paddle_tpu/optimizer/lr.py), and the
optimizers' use of them.

Tolerance: 0. The schedules are the same python float arithmetic in both
packages, so every rate is the same float; each schedule runs over three
of its periods, and its ``state_dict`` carries a run across to a fresh
scheduler that goes on as the reference's does.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum
from paddle_tpu_torch.optimizer import lr as tlr

#: name -> (constructor kwargs, period in steps)
SCHEDULES = {
    "NoamDecay": (dict(d_model=64, warmup_steps=4, learning_rate=2.0), 4),
    "PiecewiseDecay": (dict(boundaries=[3, 6], values=[0.1, 0.05, 0.01]), 6),
    "NaturalExpDecay": (dict(learning_rate=0.5, gamma=0.1), 5),
    "InverseTimeDecay": (dict(learning_rate=0.5, gamma=0.2), 5),
    "PolynomialDecay": (dict(learning_rate=0.1, decay_steps=5, end_lr=0.01,
                             power=2.0), 5),
    "PolynomialDecay_cycle": (dict(learning_rate=0.1, decay_steps=4,
                                   end_lr=0.0, cycle=True), 4),
    "LinearWarmup": (dict(learning_rate=0.1, warmup_steps=3, start_lr=0.0,
                          end_lr=0.1), 3),
    "LinearWarmup_cosine": (dict(warmup_steps=2, start_lr=0.01,
                                 end_lr=0.1), 6),
    "ExponentialDecay": (dict(learning_rate=0.1, gamma=0.9), 5),
    "MultiStepDecay": (dict(learning_rate=0.1, milestones=[2, 5],
                            gamma=0.5), 5),
    "StepDecay": (dict(learning_rate=0.1, step_size=3, gamma=0.5), 3),
    "LambdaDecay": (dict(learning_rate=0.1,
                         lr_lambda=lambda e: 0.95 ** e), 5),
    "MultiplicativeDecay": (dict(learning_rate=0.1,
                                 lr_lambda=lambda e: 0.9), 5),
    "CosineAnnealingDecay": (dict(learning_rate=0.1, T_max=5,
                                  eta_min=0.001), 5),
    "OneCycleLR": (dict(max_learning_rate=0.1, total_steps=10,
                        phase_pct=0.3), 10),
    "CyclicLR": (dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=2, step_size_down=3), 5),
    "CyclicLR_triangular2": (dict(base_learning_rate=0.01,
                                  max_learning_rate=0.1, step_size_up=2,
                                  mode="triangular2"), 4),
    "CyclicLR_exp_range": (dict(base_learning_rate=0.01,
                                max_learning_rate=0.1, step_size_up=2,
                                mode="exp_range", exp_gamma=0.9), 4),
}


def _make(mod, key):
    kwargs, _ = SCHEDULES[key]
    name = key.split("_")[0] if key != "LinearWarmup_cosine" \
        else "LinearWarmup"
    if key == "LinearWarmup_cosine":
        kwargs = {**kwargs,
                  "learning_rate": mod.CosineAnnealingDecay(0.1, T_max=4)}
    return getattr(mod, name)(**kwargs)


def _trajectory(sched, n):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("key", sorted(SCHEDULES))
def test_schedule_matches_the_reference_over_three_periods(key):
    n = 3 * SCHEDULES[key][1]
    want = _trajectory(_make(jlr, key), n)
    got = _trajectory(_make(tlr, key), n)
    assert got == want
    assert all(isinstance(v, float) for v in got)


@pytest.mark.parametrize("key", sorted(SCHEDULES))
def test_state_dict_round_trip_goes_on_as_the_reference(key):
    """A fresh scheduler loaded from a state_dict goes on as the
    reference's does: as the first one, except MultiplicativeDecay, whose
    running product is private (``_cur``), is left out of the state_dict
    and restarts from the base rate in both packages. (A LinearWarmup's
    state_dict holds its inner scheduler itself, which the loaded one then
    shares and steps: the first scheduler is checked here before the
    second steps it.)"""
    period = SCHEDULES[key][1]
    a, ref = _make(tlr, key), _make(jlr, key)
    _trajectory(a, period)
    _trajectory(ref, period)
    sd = a.state_dict()
    assert set(sd) == set(ref.state_dict())
    assert not any(k.startswith("_") for k in sd)
    b, ref_b = _make(tlr, key), _make(jlr, key)
    b.set_state_dict(sd)
    ref_b.set_state_dict(ref.state_dict())
    if key != "MultiplicativeDecay":
        ahead = _make(jlr, key)
        _trajectory(ahead, period)
        assert _trajectory(b, 2 * period) == _trajectory(ahead, 2 * period)
        b = _make(tlr, key)
        b.set_state_dict(_make_at(key, period).state_dict())
    assert _trajectory(b, 2 * period) == _trajectory(ref_b, 2 * period)


def _make_at(key, epochs):
    s = _make(tlr, key)
    _trajectory(s, epochs)
    return s


def test_a_new_scheduler_stands_at_epoch_zero():
    s = tlr.StepDecay(0.1, step_size=2)
    assert s.last_epoch == 0 and s() == s.last_lr == 0.1
    s.step(epoch=4)
    assert s.last_epoch == 4 and s() == pytest.approx(0.1 * 0.01)


def test_linear_warmup_steps_its_inner_schedule_in_get_lr():
    """Each get_lr() past the warmup steps the inner cosine (the
    reference's quirk), so the optimizer reads scheduler(), not get_lr()."""
    for mod in (jlr, tlr):
        s = mod.LinearWarmup(mod.CosineAnnealingDecay(0.1, T_max=4),
                             warmup_steps=1, start_lr=0.0, end_lr=0.1)
        s.step()
        first = s.lr.last_epoch
        s.get_lr()
        assert s.lr.last_epoch == first + 1
    s = tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.1, T_max=4),
                         warmup_steps=1, start_lr=0.0, end_lr=0.1)
    opt = AdamW(learning_rate=s, parameters=[torch.zeros(1)])
    s.step()
    epoch = s.lr.last_epoch
    for _ in range(3):
        opt.get_lr()
    assert s.lr.last_epoch == epoch
    assert "lr" in s.state_dict() and s.state_dict()["lr"] is s.lr


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"),
                                                 ("max", "abs")])
def test_reduce_on_plateau_matches_the_reference(mode, threshold_mode):
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.99, 0.8, 0.81, 0.82, 0.83,
               0.84, 0.85, 0.86]
    if mode == "max":
        metrics = [-m for m in metrics]
    kw = dict(learning_rate=0.1, mode=mode, factor=0.5, patience=2,
              threshold_mode=threshold_mode, cooldown=1, min_lr=0.01)
    j, t = jlr.ReduceOnPlateau(**kw), tlr.ReduceOnPlateau(**kw)
    got, want = [], []
    for i, m in enumerate(metrics):
        j.step(paddle.to_tensor(np.float32(m)))
        # a tensor, or a number, as the caller has it
        t.step(torch.tensor(np.float32(m)) if i % 2 else float(np.float32(m)))
        got.append(t())
        want.append(j())
    assert got == want
    assert t.last_lr < 0.1
    t.step()                        # no metric: nothing moves
    assert t() == got[-1]


def test_optimizer_reads_and_saves_its_scheduler():
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = Momentum(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.1 and opt._learning_rate is sched
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)
    p.grad = torch.ones(3)
    opt.step()
    sched.step()
    assert opt.get_lr() == 0.05
    sd = opt.state_dict()
    assert sd["LR_Scheduler"] == sched.state_dict()
    fresh_sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    fresh = Momentum(learning_rate=fresh_sched, parameters=[p])
    fresh.set_state_dict(sd)
    assert fresh_sched.last_epoch == 1 and fresh.get_lr() == 0.05
    other = tlr.ExponentialDecay(0.2, gamma=0.5)
    fresh.set_lr_scheduler(other)
    assert fresh.get_lr() == 0.2
    plain = SGD(learning_rate=0.1, parameters=[p])
    plain.set_lr(0.3)
    assert plain.get_lr() == 0.3 and plain.state_dict()["LR_Scheduler"] == {}


def test_schedule_steps_the_eager_update_like_the_reference():
    """SGD under StepDecay over four eager steps: the same parameter as the
    reference's (the lr enters each update as an fp32 scalar)."""
    w = np.linspace(-1, 1, 6).astype(np.float32)
    g = np.full(6, 0.5, np.float32)
    jp = paddle.create_parameter([6], "float32")
    jp.set_value(w)
    tp = torch.nn.Parameter(torch.from_numpy(w.copy()))
    js, ts = jlr.StepDecay(0.1, step_size=2, gamma=0.3), \
        tlr.StepDecay(0.1, step_size=2, gamma=0.3)
    jopt = paddle.optimizer.SGD(learning_rate=js, parameters=[jp])
    topt = SGD(learning_rate=ts, parameters=[tp])
    for _ in range(4):
        jp.grad = paddle.to_tensor(g)
        jopt.step()
        js.step()
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
        ts.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                               rtol=0, atol=1e-7)
    assert math.isclose(ts(), js())
