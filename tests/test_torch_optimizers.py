"""The rest of the port's optimizer family (Adagrad, Adadelta, Adamax,
RMSProp, Lamb, Lars, Ftrl, Dpsgd), the regularizer objects, the gradient
clips and the averaging wrappers against the JAX package's, from the same
numpy parameters and grads.

Tolerances:
- fp32: parameters and every state slot within rtol 1e-5 / atol 1e-6
  after 3 steps (the same rule in two frameworks; only fused
  multiply-adds, the order of a norm's sum and pow's rounding differ),
  each slot in the reference's dtype.
- bf16 parameters: the slots in the reference's dtype (its fp32 weight
  decay term widens a bf16 grad, and with it every moment, to fp32), and
  the parameters and slots within rtol 3 x 2^-8 / atol 1e-3 after 3 steps:
  the port writes each new parameter back into the bf16 one (an in-place
  update), where the reference's parameter comes out fp32, so the port's
  parameters carry one bf16 rounding a step more.
- clips: the clipped grads within 1e-6 (fp32) and 0 in bf16 (the same
  fp32 product, rounded once).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import ParamBase

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg

SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "ln.weight": (5,)}


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

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=3 * 2.0 ** -8, atol=1e-3)

#: name -> (optimizer class name, constructor kwargs)
OPTIMIZERS = {
    "adagrad": ("Adagrad", dict(learning_rate=0.05,
                                initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "adamax": ("Adamax", dict(learning_rate=0.02, beta1=0.8)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01)),
    "rmsprop_centered_momentum": ("RMSProp", dict(
        learning_rate=0.01, centered=True, momentum=0.9)),
    "lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.05)),
    "lars": ("Lars", dict(learning_rate=0.1, lars_coeff=0.01,
                          lars_weight_decay=0.001)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.001, l2=0.01)),
    "dpsgd_sigma0": ("Dpsgd", dict(learning_rate=0.1, clip=0.5, sigma=0.0)),
    "adagrad_l2": ("Adagrad", dict(learning_rate=0.05, weight_decay="L2")),
    "rmsprop_l1": ("RMSProp", dict(learning_rate=0.01, weight_decay="L1")),
    "momentum_l1": ("Momentum", dict(learning_rate=0.1, weight_decay="L1")),
    "adamw_l1": ("AdamW", dict(learning_rate=0.01, weight_decay="L1")),
    "sgd_l2": ("SGD", dict(learning_rate=0.1, weight_decay="L2")),
}


def _make(mod, reg, key, **extra):
    name, kwargs = OPTIMIZERS[key]
    kwargs = dict(kwargs, **extra)
    if kwargs.get("weight_decay") == "L2":
        kwargs["weight_decay"] = reg.L2Decay(0.1)
    elif kwargs.get("weight_decay") == "L1":
        kwargs["weight_decay"] = reg.L1Decay(0.1)
    return getattr(mod, name)(**kwargs)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items()}


def _close(got, want, tol):
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), \
        (got.dtype, want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _functional_both(key, dtype, steps=3):
    jo = _make(paddle.optimizer, jreg, key)
    to = _make(topt, treg, key)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {n: jnp.asarray(a, dtype=jdt) for n, a in _params().items()}
    tp = {n: torch.from_numpy(a).to(tdt) for n, a in _params().items()}
    js, ts = jo.functional_init(jp), to.functional_init(tp)
    for i in range(steps):
        g = _grads(i)
        jp, js = jo.functional_apply(
            jp, {n: jnp.asarray(a, dtype=jdt) for n, a in g.items()}, js)
        tp, ts = to.functional_apply(
            tp, {n: torch.from_numpy(a).to(tdt) for n, a in g.items()}, ts)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_functional_apply_matches_reference_fp32(key):
    (jp, js), (tp, ts) = _functional_both(key, "float32")
    for n in SHAPES:
        _close(tp[n], jp[n], FP32)
        assert set(ts[n]) == set(js[n])
        for k, v in js[n].items():
            _close(ts[n][k], v, FP32)
    assert int(ts["__step__"]) == int(js["__step__"]) == 3


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_functional_apply_matches_reference_bf16(key):
    (jp, js), (tp, ts) = _functional_both(key, "bfloat16")
    for n in SHAPES:
        assert tp[n].dtype == torch.bfloat16        # updated in place
        np.testing.assert_allclose(tp[n].float().numpy(),
                                   np.asarray(jp[n], np.float32), **BF16)
        for k, v in js[n].items():
            _close(ts[n][k], v, BF16)


def _eager_both(key, clip=None, need_clip=None, steps=3):
    """Eager step() in both packages; `clip` (a callable of the package's
    nn module) builds the grad_clip; `need_clip` names a parameter whose
    need_clip is False."""
    jps, tps = [], []
    for n, a in _params().items():
        jp = ParamBase(jnp.asarray(a))
        tp = torch.nn.Parameter(torch.from_numpy(a.copy()))
        if n == need_clip:
            jp.need_clip = tp.need_clip = False
        jps.append(jp)
        tps.append(tp)
    extra = {} if clip is None else dict(grad_clip=clip(paddle.nn))
    jo = _make(paddle.optimizer, jreg, key, parameters=jps, **extra)
    extra = {} if clip is None else dict(grad_clip=clip(tnn))
    to = _make(topt, treg, key, parameters=tps, **extra)
    for i in range(steps):
        for jp, tp, g in zip(jps, tps, _grads(i).values()):
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    return jps, tps, jo, to


@pytest.mark.parametrize("key", ["adagrad", "adamax", "lamb", "lars", "ftrl",
                                 "rmsprop_l1", "adamw_l1"])
def test_eager_step_matches_reference(key):
    jps, tps, jo, to = _eager_both(key)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **FP32)
    assert to.state_dict().keys() == jo.state_dict().keys()


CLIPS = {
    "value": lambda nn: nn.ClipGradByValue(0.05, min=-0.02),
    "norm": lambda nn: nn.ClipGradByNorm(0.1),
    "global_norm": lambda nn: nn.ClipGradByGlobalNorm(0.1),
    "global_norm_alias": lambda nn: nn.clip.GradientClipByGlobalNorm(0.1),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("need_clip", [None, "fc.weight"])
def test_clips_through_the_eager_step_match_reference(clip, need_clip):
    jps, tps, _, _ = _eager_both("momentum_l1", CLIPS[clip], need_clip)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_classes_on_param_grad_pairs(dtype):
    """Each clip's grads from the same (param, grad) pairs: norms in fp32,
    each grad back in its dtype; need_clip=False passes unscaled and out
    of the global norm; the grads handed in are not changed."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    grads = [g * 7 for g in _grads(0).values()]
    jpairs, tpairs = [], []
    for i, g in enumerate(grads):
        jp, tp = ParamBase(jnp.zeros(1)), torch.zeros(1)
        if i == 1:
            jp.need_clip = tp.need_clip = False
        jpairs.append((jp, paddle.to_tensor(jnp.asarray(g, dtype=jdt))))
        tpairs.append((tp, torch.from_numpy(g).to(tdt)))
    before = [g.clone() for _, g in tpairs]
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" \
        else dict(rtol=0, atol=0)
    for make in CLIPS.values():
        want = make(paddle.nn)(jpairs)
        got = make(tnn)(tpairs)
        for (_, w), (_, t) in zip(want, got):
            assert t.dtype == tdt
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(w._data, np.float32), **tol)
    assert all(torch.equal(a, g) for a, (_, g) in zip(before, tpairs))


def test_global_norm_is_the_references_fp32_sum_of_squares():
    grads = [torch.from_numpy(g).to(torch.bfloat16)
             for g in _grads(1).values()]
    want = np.sqrt(sum(float(np.sum(g.float().numpy().astype(np.float64)
                                    ** 2)) for g in grads))
    got = tnn.clip.global_norm(grads)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_functional_apply_applies_only_the_global_norm_clip():
    """The trainer's update: ClipGradByGlobalNorm scales the grads; a
    ClipGradByValue or ClipGradByNorm passes unapplied, as in the
    reference's functional_apply."""
    runs = {}
    for name in ("none", "value", "norm", "global_norm"):
        clip = {} if name == "none" else dict(grad_clip=CLIPS[name])
        jo = paddle.optimizer.Momentum(
            learning_rate=0.1, grad_clip=clip["grad_clip"](paddle.nn)
            if clip else None)
        to = topt.Momentum(learning_rate=0.1,
                           grad_clip=clip["grad_clip"](tnn) if clip else None)
        jp = {n: jnp.asarray(a) for n, a in _params().items()}
        tp = {n: torch.from_numpy(a) for n, a in _params().items()}
        js, ts = jo.functional_init(jp), to.functional_init(tp)
        g = {n: a * 5 for n, a in _grads(0).items()}
        jp, _ = jo.functional_apply(jp, {n: jnp.asarray(a)
                                         for n, a in g.items()}, js)
        tp, _ = to.functional_apply(tp, {n: torch.from_numpy(a)
                                         for n, a in g.items()}, ts)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       **FP32)
        runs[name] = tp
    for name in ("value", "norm"):
        assert all(torch.equal(runs[name][n], runs["none"][n])
                   for n in SHAPES)
    assert not torch.equal(runs["global_norm"]["fc.weight"],
                           runs["none"]["fc.weight"])


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    jps, tps = [], []
    for a, g in zip(_params().values(), _grads(2).values()):
        jp = paddle.create_parameter(list(a.shape), "float32")
        jp.grad = paddle.to_tensor(g * 4)
        tp = torch.nn.Parameter(torch.from_numpy(a))
        tp.grad = torch.from_numpy(g * 4)
        jps.append(jp)
        tps.append(tp)
    want = paddle.nn.clip.clip_grad_norm_(jps, 0.3, norm_type=norm_type)
    got = tnn.clip_grad_norm_(tps, 0.3, norm_type=norm_type)
    assert float(got) == pytest.approx(float(np.asarray(want._data)),
                                       rel=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad._data),
                                   rtol=1e-6, atol=1e-7)


def test_regularizer_objects_and_aliases():
    for mod in (jreg, treg):
        assert mod.L2DecayRegularizer is mod.L2Decay
        assert mod.L1DecayRegularizer is mod.L1Decay
    o = topt.SGD(learning_rate=0.1, weight_decay=treg.L1Decay(0.25))
    assert o._wd == 0.25 and not o._wd_is_l2
    o = topt.SGD(learning_rate=0.1, weight_decay=treg.L2Decay(0.5))
    assert o._wd == 0.5 and o._wd_is_l2
    assert treg.L2Decay(0.3).coeff == 0.3


def test_adamw_accepts_and_ignores_lr_ratio():
    """The reference drops lr_ratio: every parameter steps at the one
    rate."""
    def run(mod, **kw):
        o = mod.AdamW(learning_rate=0.01, **kw)
        p = {n: (jnp.asarray(a) if mod is paddle.optimizer
                 else torch.from_numpy(a)) for n, a in _params().items()}
        s = o.functional_init(p)
        g = _grads(0)
        conv = jnp.asarray if mod is paddle.optimizer else torch.from_numpy
        return o.functional_apply(p, {n: conv(a) for n, a in g.items()}, s)[0]

    ratio = lambda p: 0.1          # noqa: E731
    plain, with_ratio = run(topt), run(topt, lr_ratio=ratio)
    want = run(paddle.optimizer, lr_ratio=ratio)
    for n in SHAPES:
        assert torch.equal(plain[n], with_ratio[n])
        np.testing.assert_allclose(with_ratio[n].numpy(), np.asarray(want[n]),
                                   **FP32)


def test_dpsgd_noise_has_the_stated_spread():
    """sigma > 0: the update's deviation from the noise-free one is
    Gaussian noise of std lr * sigma * clip / batch_size, drawn from the
    port's generator (reseeding repeats it)."""
    import paddle_tpu_torch as pt

    def step(sigma):
        p = {"w": torch.zeros(200, 200)}
        o = topt.Dpsgd(learning_rate=0.5, clip=2.0, batch_size=4,
                       sigma=sigma)
        s = o.functional_init(p)
        o.functional_apply(p, {"w": torch.full((200, 200), 1e-4)}, s)
        return p["w"]

    pt.seed(11)
    noisy = step(1.5)
    pt.seed(11)
    again = step(1.5)
    dev = (noisy - step(0.0)).double()
    assert torch.equal(noisy, again)
    assert abs(float(dev.mean())) < 4 * 0.375 / 200
    assert float(dev.std()) == pytest.approx(0.5 * 1.5 * 2.0 / 4, rel=0.02)


# ---- ExponentialMovingAverage, ModelAverage, LookAhead ---------------------

def _pair_params():
    jps, tps = [], []
    for a in _params().values():
        jp = paddle.create_parameter(list(a.shape), "float32")
        jp.set_value(a)
        jps.append(jp)
        tps.append(torch.nn.Parameter(torch.from_numpy(a.copy())))
    return jps, tps


def _nudge(jps, tps, i):
    for jp, tp, g in zip(jps, tps, _grads(i).values()):
        jp.set_value(np.asarray(jp._data) + g)
        with torch.no_grad():
            tp.add_(torch.from_numpy(g))


def _assert_params(jps, tps):
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **FP32)


@pytest.mark.parametrize("kind", ["ema", "model_average"])
def test_averages_apply_and_restore_like_the_reference(kind):
    jps, tps = _pair_params()
    if kind == "ema":
        ja = paddle.optimizer.ExponentialMovingAverage(jps, decay=0.8)
        ta = topt.ExponentialMovingAverage(tps, decay=0.8)
    else:
        ja = paddle.optimizer.ModelAverage(0.5, parameters=jps,
                                           min_average_window=2,
                                           max_average_window=3)
        ta = topt.ModelAverage(0.5, parameters=tps, min_average_window=2,
                               max_average_window=3)
    for i in range(4):         # the window restarts at the 3rd update
        _nudge(jps, tps, i)
        ja.update()
        ta.update()
    live = [tp.detach().clone() for tp in tps]
    with ja.apply(), ta.apply():
        _assert_params(jps, tps)
        assert not torch.equal(tps[0], live[0])
    _assert_params(jps, tps)
    assert all(torch.equal(tp, w) for tp, w in zip(tps, live))
    with ja.apply(need_restore=False), ta.apply(need_restore=False):
        pass
    _assert_params(jps, tps)
    ja.restore()
    ta.restore()
    assert all(torch.equal(tp, w) for tp, w in zip(tps, live))


def test_lookahead_matches_the_reference():
    jps, tps = _pair_params()
    jo = paddle.optimizer.LookAhead(paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jps), alpha=0.4, k=2)
    to = topt.LookAhead(topt.SGD(learning_rate=0.1, parameters=tps),
                        alpha=0.4, k=2)
    for i in range(5):
        for jp, tp, g in zip(jps, tps, _grads(i).values()):
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        _assert_params(jps, tps)
    assert to.get_lr() == jo.get_lr() == 0.1
    assert to.state_dict().keys() == jo.state_dict().keys()


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_trainer_applies_only_the_global_norm_clip(clip):
    """SpmdTrainer's update goes through functional_apply: with a
    ClipGradByValue or ClipGradByNorm its steps equal the unclipped ones
    bit for bit, as the reference trainer's do; ClipGradByGlobalNorm binds.
    Both trainers' parameters within 1e-6 after three steps."""
    import jax

    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.distributed.spmd import SpmdTrainer as JTrainer

    from paddle_tpu_torch.distributed import SpmdTrainer

    w = np.random.RandomState(7).randn(4, 3).astype(np.float32)
    x = np.random.RandomState(8).randn(8, 4).astype(np.float32) * 5
    y = np.zeros((8, 3), np.float32)

    def port(make):
        lin = torch.nn.Linear(4, 3)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.zero_()
        tr = SpmdTrainer(lin, topt.Momentum(
            learning_rate=0.1, parameters=lin.parameters(),
            grad_clip=None if make is None else make(tnn)),
            loss_fn=torch.nn.MSELoss())
        for _ in range(3):
            tr.train_step(x, y)
        return lin.weight.detach().clone()

    jlin = paddle.nn.Linear(4, 3)
    jlin.weight.set_value(w)
    jlin.bias.set_value(np.zeros(3, np.float32))
    jt = JTrainer(jlin, paddle.optimizer.Momentum(
        learning_rate=0.1, parameters=jlin.parameters(),
        grad_clip=CLIPS[clip](paddle.nn)), loss_fn=paddle.nn.MSELoss(),
        mesh=build_mesh((1,), ("dp",), devices=jax.devices()[:1]))
    for _ in range(3):
        jt.train_step(x, y)
    got = port(CLIPS[clip])
    np.testing.assert_allclose(got.numpy().T, np.asarray(jt.params["weight"]),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(got, port(None)) == (clip != "global_norm")
