"""Loss scaling, O2 and the numerics checks of the port's ``amp``
(paddle_tpu_torch/amp/grad_scaler.py, ``amp.decorate``, auto_cast's O2
state, ``amp.debugging``) against the JAX package's on the CPU.

Tolerances: the parameters after three scaled steps within 1e-6 of the
reference's (fp32 parameters, an fp16 loss, the same power-of-two scale);
the scale, its counters and the skipped steps exactly the reference's; a
skipped step leaves the parameters and the optimizer state bit-identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.amp.auto_cast import amp_state as jamp_state

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.optimizer import Adam

W = np.random.RandomState(0).randn(4, 3).astype(np.float32) * 0.5
X = np.random.RandomState(1).randn(8, 4).astype(np.float32)


def _jax_linear():
    lin = paddle.nn.Linear(4, 3)
    lin.weight.set_value(W)
    lin.bias.set_value(np.zeros(3, np.float32))
    return lin


def _port_linear():
    lin = pt.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(W.T))
        lin.bias.zero_()
    return lin


def _run(mod, lin, scaler, steps, scale_x=1.0):
    """`steps` scaled Adam steps on an fp16 loss; returns (losses, scales,
    found-inf flags)."""
    opt = mod.optimizer.Adam(learning_rate=0.01, parameters=lin.parameters())
    x = X * scale_x
    losses, scales = [], []
    for _ in range(steps):
        if mod is paddle:
            out = lin(paddle.to_tensor(x))
            loss = (out * out).mean().astype("float16")
        else:
            out = lin(torch.from_numpy(x))
            loss = (out * out).mean().to(torch.float16)
        scaled = scaler.scale(loss)
        scaler.minimize(opt, scaled)
        losses.append(float(np.asarray(loss._data)) if mod is paddle
                      else float(loss.detach()))
        scales.append(scaler._scale)
    return losses, scales, opt


def test_scaled_steps_and_the_scale_schedule_match_the_reference():
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              incr_ratio=4.0)
    jl, tl = _jax_linear(), _port_linear()
    js, ts = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw)
    jlosses, jscales, _ = _run(paddle, jl, js, 3)
    tlosses, tscales, _ = _run(pt, tl, ts, 3)
    assert tscales == jscales == [2.0 ** 10, 2.0 ** 12, 2.0 ** 12]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(tl.weight.detach().numpy().T,
                               np.asarray(jl.weight._data), atol=1e-6,
                               rtol=0)
    assert ts.state_dict() == js.state_dict()


def test_an_overflowing_step_is_skipped_bit_identically():
    """At init_loss_scaling 2^40 the fp16 scaled loss is inf: every step's
    grads are non-finite, so no step is taken (parameters and Adam's
    moments bit-equal), and the scale halves once a
    decr_every_n_nan_or_inf (2) bad steps."""
    kw = dict(init_loss_scaling=2.0 ** 40, decr_every_n_nan_or_inf=2)
    tl = _port_linear()
    ts = amp.GradScaler(**kw)
    opt = Adam(learning_rate=0.01, parameters=tl.parameters())
    w0 = [p.detach().clone() for p in tl.parameters()]
    # one good step first, so that there is optimizer state to keep
    good = amp.GradScaler(init_loss_scaling=1.0)
    loss = (tl(torch.from_numpy(X)) ** 2).mean().to(torch.float16)
    good.minimize(opt, good.scale(loss))
    state0 = {k: v.clone() for k, v in opt.state_dict().items()
              if isinstance(v, torch.Tensor)}
    w1 = [p.detach().clone() for p in tl.parameters()]
    assert not torch.equal(w1[0], w0[0])
    scales, found = [], []
    for _ in range(4):
        loss = (tl(torch.from_numpy(X)) ** 2).mean().to(torch.float16)
        scaled = ts.scale(loss)
        assert torch.isinf(scaled)
        scaled.backward()
        ts.unscale_(opt)
        found.append(ts._found_inf)
        ts.update()
        opt.clear_grad()
        scales.append(ts._scale)
    assert found == [True] * 4
    assert scales == [2.0 ** 40, 2.0 ** 39, 2.0 ** 39, 2.0 ** 38]
    # and minimize skips the same way
    loss = (tl(torch.from_numpy(X)) ** 2).mean().to(torch.float16)
    ts.minimize(opt, ts.scale(loss))
    assert all(torch.equal(p, w) for p, w in zip(tl.parameters(), w1))
    state = opt.state_dict()
    assert all(torch.equal(state[k], v) for k, v in state0.items())
    assert state["step"] == 1
    # the reference's scale walks the same way
    js = paddle.amp.GradScaler(**kw)
    _, jscales, _ = _run(paddle, _jax_linear(), js, 5)
    assert jscales == scales + [2.0 ** 38]


def test_unscale_takes_one_verdict_over_every_grad():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2, dtype=torch.float16))
    opt = Adam(parameters=[p, q])
    s = amp.GradScaler(init_loss_scaling=4.0)
    p.grad = torch.tensor([4.0, 8.0, 12.0])
    q.grad = torch.tensor([2.0, 6.0], dtype=torch.float16)
    s.unscale_(opt)
    assert not s._found_inf
    assert torch.equal(p.grad, torch.tensor([1.0, 2.0, 3.0]))
    assert q.grad.dtype == torch.float16 \
        and torch.equal(q.grad.float(), torch.tensor([0.5, 1.5]))
    q.grad = torch.tensor([float("nan"), 1.0], dtype=torch.float16)
    s.unscale_(opt)
    assert s._found_inf


def test_scaler_api_and_state_round_trip():
    for mod in (paddle.amp, amp):
        assert issubclass(mod.GradScaler, mod.AmpScaler)
    s = amp.GradScaler(enable=False)
    x = torch.ones(2)
    assert s.scale(x) is x and not s.is_enable()
    s = amp.AmpScaler(use_dynamic_loss_scaling=False, init_loss_scaling=8.0)
    assert not s.is_use_dynamic_loss_scaling()
    s._found_inf = True
    s.update()
    assert s._scale == 8.0 and s._found_inf is False
    assert s.get_loss_scaling().dtype == torch.float32 \
        and float(s.get_loss_scaling()) == 8.0
    s.set_init_loss_scaling(16.0)
    s._good_steps, s._bad_steps = 3, 1
    fresh = amp.AmpScaler()
    fresh.load_state_dict(s.state_dict())
    assert (fresh._scale, fresh._good_steps, fresh._bad_steps) == (16.0, 3, 1)
    j = paddle.amp.AmpScaler()
    assert set(j.state_dict()) == set(s.state_dict())


def test_decorate_o2_casts_parameters_and_o1_does_not():
    for level, want in (("O1", torch.float32), ("O2", torch.bfloat16)):
        m = torch.nn.Sequential(pt.nn.Linear(4, 3), pt.nn.BatchNorm2D(3))
        opt = Adam(parameters=m.parameters())
        got_m, got_opt = amp.decorate(m, opt, level=level,
                                      master_weight=True, save_dtype="float32")
        assert got_m is m and got_opt is opt
        assert all(p.dtype == want for p in m.parameters())
        assert all(b.dtype == torch.float32 for b in m.buffers())
    ms = [pt.nn.Linear(2, 2), pt.nn.Linear(2, 2)]
    out = amp.decorate(ms, level="O2", dtype="float16")
    assert out == ms and all(p.dtype == torch.float16
                             for m in ms for p in m.parameters())
    # an O2 model trains: Adam's moments follow the bf16 parameters
    m = pt.nn.Linear(4, 3)
    amp.decorate(m, level="O2")
    opt = Adam(learning_rate=0.01, parameters=m.parameters())
    m(torch.ones(2, 4, dtype=torch.bfloat16)).sum().backward()
    opt.step()
    assert m.weight.dtype == torch.bfloat16


def test_o2_level_and_custom_lists_are_stored_and_change_no_dtype():
    """As in the reference, auto_cast stores level and the custom lists in
    amp_state() and nothing reads them: only amp_dtype() decides a cast,
    and linear casts the same way under O1, O2 or a custom black list."""
    x, w = torch.ones(2, 4), torch.ones(3, 4)
    outs = {}
    for kwargs in (dict(), dict(level="O2"),
                   dict(custom_white_list={"gelu"},
                        custom_black_list={"linear"})):
        with amp.auto_cast(True, dtype="bfloat16", **kwargs), \
                paddle.amp.auto_cast(True, dtype="bfloat16", **kwargs):
            ts, js = amp.amp_state(), jamp_state()
            for k in ("level", "custom_white", "custom_black"):
                assert ts[k] == js[k]
            outs[str(kwargs)] = pt.nn.functional.linear(x, w.t())
    assert {o.dtype for o in outs.values()} == {torch.bfloat16}
    assert amp.amp_state()["level"] == "O1" \
        and amp.amp_state()["custom_white"] == set()
    assert amp.white_list == paddle.amp.white_list
    assert amp.black_list == paddle.amp.black_list


def test_check_numerics_and_enable_check_nan_inf():
    with pytest.raises(amp.debugging.NaNInfError, match="myop"):
        amp.debugging.check_numerics(torch.tensor([1.0, float("inf")]),
                                     "myop")
    ints = torch.tensor([1, 2])
    assert amp.debugging.check_numerics(ints) is ints
    assert issubclass(amp.debugging.NaNInfError, FloatingPointError)
    with paddle.amp.debugging.enable_check_nan_inf():
        pass
    assert pt.get_flag("check_nan_inf", False) is False
    with amp.debugging.enable_check_nan_inf():
        assert pt.get_flag("check_nan_inf") is True
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()
    assert pt.get_flag("check_nan_inf") is False
    assert not torch.is_anomaly_enabled()
    assert jnp.isnan(jnp.sqrt(-1.0))       # the reference's mode is off too


# ---- the fp16 loop the scaler drives ------------------------------------

def test_fp16_naive_attention_masks_like_the_reference():
    """fp16 scores cannot hold the reference's -1e30: it becomes -inf
    there (``jnp.asarray(-1e30, float16)``), and in the port, which
    raised before. Causal and with a bool mask, within fp16 rounding."""
    from paddle_tpu.nn import functional as JF

    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 16, 2, 8).astype(np.float16) for _ in range(3))
    mask = rng.rand(2, 2, 16, 16) > 0.3
    mask[..., 0] = True
    for kwargs in (dict(is_causal=True), dict(attn_mask=mask)):
        want = JF.scaled_dot_product_attention(
            *(paddle.to_tensor(a) for a in (q, k, v)),
            **{n: paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
               for n, a in kwargs.items()})
        got = scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            **{n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for n, a in kwargs.items()})
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want._data, np.float32),
                                   atol=2e-3, rtol=0)


def test_fp16_gpt_steps_under_the_scaler():
    """The narrow GPT's eager fp16 loop (auto_cast float16, the scaled
    loss, minimize) at the default 2^15: finite losses that fall, no
    skipped step, the scale unchanged."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=2, max_seq_len=16, dropout=0.0)
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    opt = Adam(learning_rate=1e-2, parameters=m.parameters())
    scaler = amp.GradScaler()
    ids = torch.randint(0, 128, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(3):
        with amp.auto_cast(True, dtype="float16"):
            loss = m.loss(ids, ids)
        assert loss.dtype == torch.float16
        scaler.minimize(opt, scaler.scale(loss))
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert opt._step_count == 3 and scaler._scale == 2.0 ** 15
