"""The port's PP-YOLOE training path (BatchNorm with batch statistics,
``SGD`` / ``Momentum``, ``PPYOLOELoss`` and the trainer over them)
against the JAX package's on the CPU.

Bands:
- batch_norm's training output, its input and parameter grads and the
  running statistics within 1e-5 (fp32; the mean and variance sum in
  another order);
- SGD and Momentum (Nesterov too) updates within 1e-6 over three steps;
- PPYOLOELoss's value and its grads within 1e-5 relative to their scale;
- the narrow detector's three Momentum steps under bf16 auto_cast against
  the committed fixture (golden.DET_TRAIN_FIXTURE), by
  ``golden.detector_train_errors`` within golden.DET_TRAIN_RTOL and
  DET_TRAIN_NORM_RTOL (the reasons are there).

Run ``python tests/test_torch_ppyolo_train.py --write-fixture`` to
rewrite the committed fixture; test_committed_train_fixture_matches_jax
checks it still matches the JAX package.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.distributed.mesh import build_mesh  # noqa: E402
from paddle_tpu.distributed.spmd import SpmdTrainer as JTrainer  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.vision.models import PPYOLOELoss as JLoss  # noqa: E402
from paddle_tpu.vision.models.ppyolo import ppyoloe_tiny as jax_tiny  # noqa: E402,E501

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.models import opt_state_from_jax, \
    ppyoloe_params_from_jax  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.optimizer import SGD, Momentum  # noqa: E402
from paddle_tpu_torch.testing import golden  # noqa: E402
from paddle_tpu_torch.vision.models import PPYOLOELoss, \
    ppyoloe_tiny  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = pt.get_flags(["check_nan_inf", "max_skip_steps"])
    yield
    pt.set_flags(saved)


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


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)) \
        .astype(np.float32)


# ---- batch_norm with batch statistics ---------------------------------------

@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_training_matches_reference(data_format):
    shape = (4, 6, 5, 3) if data_format == "NCHW" else (4, 5, 3, 6)
    x = _rand(*shape, scale=2.0) + 0.5
    w, b = 1.0 + _rand(6, seed=1, scale=0.1), _rand(6, seed=2, scale=0.1)
    rm, rv = _rand(6, seed=3, scale=0.1), 1.0 + np.abs(_rand(6, seed=4))
    r = _rand(*shape, seed=5)
    jx, jw, jb = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b))
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    jout = JF.batch_norm(jx, jrm, jrv, jw, jb, training=True,
                         data_format=data_format)
    (jout * paddle.to_tensor(r)).sum().backward()
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    trm, trv = torch.tensor(rm), torch.tensor(rv)
    out = F.batch_norm(tx, trm, trv, tw, tb, training=True,
                       data_format=data_format)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout._data),
                               atol=TOL, rtol=0)
    for got, want in ((trm, jrm), (trv, jrv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   atol=TOL, rtol=0)
    for got, want in ((tx, jx), (tw, jw), (tb, jb)):
        np.testing.assert_allclose(got.grad.numpy(),
                                   np.asarray(want.grad._data), atol=TOL,
                                   rtol=0)
    # the biased variance updates the running one, momentum 0.9
    axes = (0, 2, 3) if data_format == "NCHW" else (0, 1, 2)
    np.testing.assert_allclose(trv.numpy(), 0.9 * rv + 0.1 * x.var(axes),
                               rtol=1e-5)


# ---- SGD and Momentum -------------------------------------------------------

@pytest.mark.parametrize("name, kwargs", [
    ("SGD", {}), ("SGD", dict(weight_decay=0.01)),
    ("Momentum", dict(momentum=0.9)),
    ("Momentum", dict(momentum=0.9, use_nesterov=True)),
    ("Momentum", dict(momentum=0.8, weight_decay=0.01))],
    ids=["sgd", "sgd_l2", "momentum", "nesterov", "momentum_l2"])
def test_sgd_and_momentum_match_reference(name, kwargs):
    params = {"a": _rand(5, 3), "b": _rand(7, seed=1)}
    grads = [{n: _rand(*v.shape, seed=10 * s + i) for i, (n, v) in
              enumerate(params.items())} for s in range(3)]
    jopt = getattr(paddle.optimizer, name)(learning_rate=0.05, **kwargs)
    topt = {"SGD": SGD, "Momentum": Momentum}[name](learning_rate=0.05,
                                                     **kwargs)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = jopt.functional_init(jp)
    tp = {n: torch.tensor(v) for n, v in params.items()}
    ts = topt.functional_init(tp)
    for g in grads:
        jp, js = jopt.functional_apply(jp, {n: jnp.asarray(v)
                                            for n, v in g.items()}, js)
        topt.functional_apply(tp, {n: torch.tensor(v)
                                   for n, v in g.items()}, ts)
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=0)
        for slot, v in js[n].items():
            np.testing.assert_allclose(ts[n][slot].numpy(), np.asarray(v),
                                       atol=1e-6, rtol=0)
    assert int(ts["__step__"]) == int(js["__step__"]) == 3


# ---- PPYOLOELoss ------------------------------------------------------------

def test_ppyoloe_loss_and_grads_match_reference():
    B, A, C = 2, 48, 6
    rng = np.random.RandomState(0)
    xy = rng.rand(B, A, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(B, A, 2) * 30], -1)
    boxes = boxes.astype(np.float32)
    gt = np.concatenate([xy + rng.randn(B, A, 2) * 4,
                         xy + 5 + rng.rand(B, A, 2) * 30], -1)
    gt = gt.astype(np.float32)
    scores = rng.rand(B, C, A).astype(np.float32)
    scores[0, 0, :4] = [0.0, 1e-7, 1.0, 1 - 1e-8]     # clipped
    labels = rng.randint(0, C + 1, (B, A)).astype(np.int64)
    jb = paddle.to_tensor(boxes, stop_gradient=False)
    js = paddle.to_tensor(scores, stop_gradient=False)
    jl = JLoss(num_classes=C)((jb, js), (paddle.to_tensor(gt),
                                         paddle.to_tensor(labels)))
    jl.backward()
    tb = torch.tensor(boxes, requires_grad=True)
    ts = torch.tensor(scores, requires_grad=True)
    tl = PPYOLOELoss(num_classes=C)((tb, ts), (torch.from_numpy(gt),
                                               torch.from_numpy(labels)))
    tl.backward()
    want = float(np.asarray(jl._data))
    assert abs(tl.item() - want) <= TOL * abs(want)
    for got, ref in ((tb, jb), (ts, js)):
        w = np.asarray(ref.grad._data)
        np.testing.assert_allclose(got.grad.numpy(), w,
                                   atol=TOL * np.abs(w).max(), rtol=0)


# ---- the narrow detector's three Momentum steps -----------------------------

def _jax_train_golden():
    """The JAX package's SpmdTrainer run of the fixture: (its summary, the
    trainer)."""
    state = golden.detector_state()
    jm = jax_tiny(num_classes=golden.DET_CLASSES)
    for name, t in jm.state_dict().items():
        t.set_value(state[name])

    class TrainStep(jnn.Layer):
        def __init__(self, det, loss_fn):
            super().__init__()
            self.det = det
            self.det_loss = loss_fn

        def forward(self, x, gt_boxes, gt_labels):
            return self.det_loss(self.det.decode(self.det(x)),
                                 (gt_boxes, gt_labels))

    layer = TrainStep(jm, JLoss(num_classes=golden.DET_CLASSES))
    opt = paddle.optimizer.Momentum(learning_rate=golden.DET_TRAIN_LR,
                                    momentum=golden.DET_TRAIN_MOMENTUM,
                                    parameters=layer.parameters())
    jt = JTrainer(layer, opt, loss_fn=None,
                  mesh=build_mesh((1,), ("dp",), devices=jax.devices()[:1]))
    init = {n: np.asarray(v) for n, v in jt.params.items()}
    imgs = paddle.to_tensor(golden.detector_images())
    gt_boxes, gt_labels = (paddle.to_tensor(a)
                           for a in golden.detector_targets())
    losses = []
    with paddle.amp.auto_cast(True, dtype="bfloat16"):
        for _ in range(golden.DET_TRAIN_STEPS):
            losses.append(float(np.asarray(jt.train_step(
                imgs, gt_boxes, gt_labels)._data)))
    return golden.detector_train_summary(
        losses, {n: np.asarray(v) for n, v in jt.params.items()},
        {n: np.asarray(jt.opt_state[n]["velocity"]) for n in jt.params},
        {n: np.asarray(v) for n, v in jt.buffers.items()}, init), jt


def _port_trainer(device="cpu"):
    det = ppyoloe_tiny(num_classes=golden.DET_CLASSES, device=device)
    det.load_state_dict(ppyoloe_params_from_jax(golden.detector_state()))
    layer = golden.detector_train_step(
        det, PPYOLOELoss(num_classes=golden.DET_CLASSES))
    opt = Momentum(learning_rate=golden.DET_TRAIN_LR,
                   momentum=golden.DET_TRAIN_MOMENTUM,
                   parameters=layer.parameters())
    return layer, SpmdTrainer(layer, opt, loss_fn=None)


def _port_train_summary(tt, init, losses):
    return golden.detector_train_summary(
        losses, {n: p.detach().cpu().numpy() for n, p in tt.params.items()},
        {n: tt.opt_state[n]["velocity"].cpu().numpy() for n in tt.params},
        {n: b.cpu().numpy() for n, b in tt.buffers.items()}, init)


def test_committed_train_fixture_matches_jax():
    """The committed fixture is the JAX package's run; the JAX trainer's
    Momentum state crosses into the port's layout by opt_state_from_jax
    (the port trainer's own state has the same names, slots and shapes)."""
    fix = dict(np.load(golden.DET_TRAIN_FIXTURE))
    want, jt = _jax_train_golden()
    err = golden.detector_train_errors(fix, want)
    assert max(err.values()) <= 1e-6, err
    state = opt_state_from_jax(
        {n: ({k: np.asarray(v) for k, v in s.items()} if n != "__step__"
             else np.asarray(s)) for n, s in jt.opt_state.items()},
        device="cpu")
    _, tt = _port_trainer()
    assert set(state) == set(tt.opt_state)
    assert int(state["__step__"]) == golden.DET_TRAIN_STEPS
    for n in tt.params:
        v = state[n]["velocity"]
        assert v.shape == tt.opt_state[n]["velocity"].shape
        np.testing.assert_array_equal(v.numpy().ravel()[
            :golden.DET_KEPT_VALUES], fix[f"velocity__{n}"])


def test_port_trains_to_the_committed_fixture_on_cpu():
    """chip_smoke.py's check on the card, on the CPU (plain versions)."""
    fix = dict(np.load(golden.DET_TRAIN_FIXTURE))
    _, tt = _port_trainer()
    init = {n: p.detach().numpy().copy() for n, p in tt.params.items()}
    imgs = golden.detector_images()
    gt_boxes, gt_labels = golden.detector_targets()
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        losses = [float(tt.train_step(imgs, gt_boxes, gt_labels))
                  for _ in range(golden.DET_TRAIN_STEPS)]
    err = golden.detector_train_errors(
        _port_train_summary(tt, init, losses), fix)
    assert max(err["loss"], err["values"]) <= golden.DET_TRAIN_RTOL, err
    assert err["norms"] <= golden.DET_TRAIN_NORM_RTOL, err
    assert losses[-1] < losses[0]


def test_skipped_step_leaves_batch_norm_buffers_bit_equal():
    """A non-finite loss under FLAGS_check_nan_inf skips the step: the
    running statistics the training forward updated are put back, bit for
    bit, with the parameters and the velocities."""
    pt.set_flags({"check_nan_inf": True, "max_skip_steps": 3})
    layer, tt = _port_trainer()
    imgs = golden.detector_images()
    gt_boxes, gt_labels = golden.detector_targets()
    tt.train_step(imgs, gt_boxes, gt_labels)
    before = {n: t.detach().clone() for n, t in
              list(tt.params.items()) + list(tt.buffers.items())}
    vel = {n: tt.opt_state[n]["velocity"].clone() for n in tt.params}
    bad = imgs.copy()
    bad[0, 0, 0, 0] = np.nan
    loss = tt.train_step(bad, gt_boxes, gt_labels)
    assert not bool(torch.isfinite(loss))
    assert tt.stats()["breakdown"]["nonfinite_skipped_total"] == 1
    now = dict(list(tt.params.items()) + list(tt.buffers.items()))
    for n, t in before.items():
        assert torch.equal(now[n], t), n
    for n, v in vel.items():
        assert torch.equal(tt.opt_state[n]["velocity"], v), n
    assert any(n.endswith("_mean") for n in tt.buffers)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_ppyolo_train.py "
                 "--write-fixture")
    jax.config.update("jax_platforms", "cpu")
    golden.DET_TRAIN_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(golden.DET_TRAIN_FIXTURE, **_jax_train_golden()[0])
    print(f"wrote {golden.DET_TRAIN_FIXTURE}")
