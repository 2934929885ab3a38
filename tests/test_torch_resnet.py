"""The port's ResNet training path (ResNet with BatchNorm on batch
statistics, Momentum through ``SpmdTrainer``, the weight and
optimizer-state converters) against the JAX package's on the CPU, from
the same numpy-drawn inputs and weights (the pooling layers and
``CrossEntropyLoss`` are tested in tests/test_torch_hapi.py).

Bands:
- the narrow ResNet's (``ResNet(BottleneckBlock, depth=18)``: resnet50's
  block and code, two blocks a stage; num_classes 10, 2 x 3 x 64 x 64,
  the weights of golden.resnet_state) first fp32 training step: the loss
  within 1e-5 relative (reads 3.6e-7), the BatchNorm running statistics
  within 1e-5 (reads 8.3e-7), the grads together (||port - JAX|| / ||JAX||
  over every parameter) within 1e-4 (reads 2.3e-6), and each grad within
  1e-3 of its tensor's largest. Both packages' fp32 grads lie up to 14%
  of a tensor's largest (``layer3.0.conv2.weight``) from an fp64 run of
  the port, by the same amount: the BatchNorm stack stays ill-conditioned
  in places even with golden.RESNET_BRANCH_GAMMA, and the two fp32 runs
  round alike;
- ``BasicBlock`` alone at stride 2 with a downsample: output and input
  grad within 1e-5, parameter grads within 1e-4;
- under bf16 auto_cast the dtypes of ``fc``'s output and of the loss equal
  the reference's (bf16 both: only ``fc`` casts);
- three Momentum steps under bf16 auto_cast against the committed fixture
  (golden.RESNET_FIXTURE), by ``golden.model_train_errors`` within
  golden.MODEL_TRAIN_TOL["resnet"], whose comment gives the reasons and
  the CPU's readings;
- the converters: ``state_from_jax`` and ``opt_state_from_jax`` transpose
  ``fc.weight`` and its velocity only, bit for bit.

Run ``python tests/test_torch_resnet.py --write-fixture`` to rewrite the
committed fixture; test_committed_resnet_fixture_matches_jax checks that
it still matches the JAX package.
"""
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
from paddle_tpu.vision.models.resnet import BottleneckBlock as \
    JBottleneck, ResNet as JResNet  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.models import linear_weights, opt_state_from_jax, \
    state_from_jax  # noqa: E402
from paddle_tpu_torch.optimizer import Momentum  # noqa: E402
from paddle_tpu_torch.testing import golden  # noqa: E402


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


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


# ---- the narrow ResNet -----------------------------------------------------

def _jax_model():
    return JResNet(JBottleneck, golden.RESNET_DEPTH,
                   num_classes=golden.RESNET_CLASSES)


@pytest.fixture(scope="module")
def jax_model():
    """One JAX model (building it compiles its initializers); each test
    loads golden's state into it first."""
    return _jax_model()


def _port_model():
    return golden.resnet_narrow(device="cpu")


@pytest.fixture(scope="module")
def state():
    return golden.resnet_state(_port_model())


def _load_jax(jm, state):
    for name, t in jm.state_dict().items():
        t.set_value(state[name])
    return jm


def _load_port(state):
    m = _port_model()
    m.load_state_dict(state_from_jax(state, m))
    return m


def test_state_names_match_the_reference(jax_model, state):
    assert set(jax_model.state_dict()) == set(state)
    assert "layer1.0.downsample.0.weight" in state
    assert "layer4.1.bn3._variance" in state


def _jax_trainer(jm, state, lr):
    jm = _load_jax(jm, state)
    opt = paddle.optimizer.Momentum(learning_rate=lr,
                                    momentum=golden.RESNET_MOMENTUM,
                                    parameters=jm.parameters())
    return JTrainer(jm, opt, loss_fn=paddle.nn.CrossEntropyLoss(),
                    mesh=build_mesh((1,), ("dp",), devices=jax.devices()[:1]))


def _port_trainer(state, lr, device="cpu"):
    m = golden.resnet_narrow(device=device)
    m.load_state_dict(state_from_jax(state, m))
    return SpmdTrainer(m, Momentum(learning_rate=lr,
                                   momentum=golden.RESNET_MOMENTUM,
                                   parameters=m.parameters()),
                       loss_fn=nn.CrossEntropyLoss()), m


def test_training_forward_and_grads_match_reference(jax_model, state):
    """One fp32 training step of each package's trainer: the loss of the
    training-mode forward, every BatchNorm's batch statistics (through the
    running statistics they update) and every grad (the velocity after
    one Momentum step is the grad)."""
    images, labels = golden.resnet_batch()
    jt = _jax_trainer(jax_model, state, golden.RESNET_LR)
    jloss = float(np.asarray(jt.train_step(paddle.to_tensor(images),
                                           paddle.to_tensor(labels))._data))
    tt, m = _port_trainer(state, golden.RESNET_LR)
    loss = float(tt.train_step(images, labels))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    grads = golden.jax_layout({n: tt.opt_state[n]["velocity"]
                               for n in tt.params}, m)
    assert set(grads) == set(jt.params)
    want = {n: np.asarray(jt.opt_state[n]["velocity"], np.float64)
            for n in grads}
    num = sum(float(np.square(grads[n] - want[n]).sum()) for n in grads)
    den = sum(float(np.square(want[n]).sum()) for n in grads)
    assert (num / den) ** 0.5 <= 1e-4
    for n, g in grads.items():
        scale = float(np.abs(want[n]).max())
        assert float(np.abs(g - want[n]).max()) <= 1e-3 * scale, n
    for n, b in tt.buffers.items():
        np.testing.assert_allclose(b.numpy(), np.asarray(jt.buffers[n]),
                                   atol=1e-5, rtol=0)


def test_basic_block_matches_reference():
    """resnet18 / 34's block, in training mode, at stride 2 with a
    downsample: its output, input grad and parameter grads (fp32)."""
    from paddle_tpu.vision.models.resnet import BasicBlock as JBlock
    from paddle_tpu_torch.vision.models.resnet import BasicBlock

    stride, planes = 2, 8
    jds = paddle.nn.Sequential(paddle.nn.Conv2D(4, 8, 1, stride=2,
                                                bias_attr=False),
                               paddle.nn.BatchNorm2D(8))
    ds = nn.Sequential(nn.Conv2D(4, 8, 1, stride=2, bias_attr=False),
                       nn.BatchNorm2D(8))
    jb = JBlock(4, planes, stride, jds)
    tb = BasicBlock(4, planes, stride, ds)
    st = golden.jax_state({n: tuple(t.shape) for n, t in
                           tb.state_dict().items()}, 11)
    for n, t in jb.state_dict().items():
        t.set_value(st[n])
    tb.load_state_dict({n: torch.tensor(a) for n, a in st.items()})
    x = _rand(2, 4, 6, 6, seed=12)
    r = _rand(2, planes, 6 // stride, 6 // stride, seed=13)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jb(jx)
    (jout * paddle.to_tensor(r)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    out = tb(tx)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout._data),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               atol=1e-5, rtol=0)
    jg = {n: np.asarray(p.grad._data) for n, p in jb.named_parameters()}
    for n, p in tb.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n], atol=1e-4, rtol=0)


def test_bf16_auto_cast_dtypes_match_reference(jax_model, state):
    """Under bf16 auto_cast only fc casts, in both packages: the port's
    pooled features stay fp32, and fc's output and the loss over it take
    the reference's dtypes (its fc and loss on the same fp32 features)."""
    tm = _load_port(state)
    images, labels = golden.resnet_batch()
    feats = {}
    tm.avgpool.register_forward_hook(
        lambda mod, args, out: feats.setdefault("pooled", out))
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        out = tm(images)
        loss = nn.CrossEntropyLoss()(out, torch.from_numpy(labels))
    pooled = torch.flatten(feats["pooled"], 1).detach()
    jm = _load_jax(jax_model, state)
    with paddle.amp.auto_cast(True, dtype="bfloat16"):
        jout = jm.fc(paddle.to_tensor(pooled.numpy()))
        jloss = paddle.nn.CrossEntropyLoss()(jout, paddle.to_tensor(labels))
    assert pooled.dtype == torch.float32
    for got, want in ((out, jout), (loss, jloss)):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert out.dtype == torch.bfloat16


# ---- three Momentum steps ---------------------------------------------------

def _jax_train(jm, state):
    """The JAX package's SpmdTrainer run of the fixture: (its summary, the
    trainer)."""
    jt = _jax_trainer(jm, state, golden.RESNET_LR)
    init = {n: np.asarray(v) for n, v in jt.params.items()}
    images, labels = (paddle.to_tensor(a) for a in golden.resnet_batch())
    with paddle.amp.auto_cast(True, dtype="bfloat16"):
        losses = [float(np.asarray(jt.train_step(images, labels)._data))
                  for _ in range(golden.MODEL_TRAIN_STEPS)]
    return golden.model_train_summary(
        losses, {n: np.asarray(v) for n, v in jt.params.items()}, init,
        {"velocity": {n: np.asarray(jt.opt_state[n]["velocity"])
                      for n in jt.params}},
        {n: np.asarray(v) for n, v in jt.buffers.items()}), jt


@pytest.fixture(scope="module")
def jax_run(jax_model, state):
    return _jax_train(jax_model, state)


def _port_train(state, device="cpu"):
    """The port's run of the fixture: (its summary, the trainer, the
    model)."""
    tt, m = _port_trainer(state, golden.RESNET_LR, device)
    init = golden.jax_layout(tt.params, m)
    images, labels = golden.resnet_batch()
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        losses = [float(tt.train_step(images, labels))
                  for _ in range(golden.MODEL_TRAIN_STEPS)]
    return golden.port_train_summary(tt, m, init, losses,
                                     ["velocity"]), tt, m


@pytest.fixture(scope="module")
def port_run(state):
    return _port_train(state)


def test_committed_resnet_fixture_matches_jax(jax_run):
    fix = dict(np.load(golden.RESNET_FIXTURE))
    err = golden.model_train_errors(fix, jax_run[0])
    assert max(err.values()) <= 1e-6, err


def test_port_trains_to_the_committed_fixture_on_cpu(port_run):
    """chip_smoke.py's check on the card, on the CPU (plain versions)."""
    fix = dict(np.load(golden.RESNET_FIXTURE))
    err = golden.model_train_errors(port_run[0], fix)
    assert golden.within(err, golden.MODEL_TRAIN_TOL["resnet"]), err
    assert np.isfinite(port_run[0]["loss"]).all()


# ---- the converters ---------------------------------------------------------

def test_converters_transpose_the_linear_weight_only(state, jax_run,
                                                     port_run):
    """ResNet's one Linear layer is fc: state_from_jax transposes its
    weight and opt_state_from_jax its velocity, bit for bit, and take
    every other entry (convolutions, BatchNorm parameters and buffers) as
    it is; the converted Momentum state has the port trainer's names,
    slots and shapes, and lies within band of the port's own run."""
    _, jt = jax_run
    _, tt, m = port_run
    assert linear_weights(m) == {"fc.weight"}
    sd = state_from_jax(state, m)
    for n, a in state.items():
        want = a.T if n == "fc.weight" else a
        np.testing.assert_array_equal(sd[n].numpy(), want)
    jstate = {n: ({k: np.asarray(v) for k, v in s.items()}
                  if n != "__step__" else np.asarray(s))
              for n, s in jt.opt_state.items()}
    conv = opt_state_from_jax(jstate, model=m, device="cpu")
    assert set(conv) == set(tt.opt_state)
    assert int(conv["__step__"]) == golden.MODEL_TRAIN_STEPS
    for n in tt.params:
        v = conv[n]["velocity"]
        assert v.shape == tt.opt_state[n]["velocity"].shape, n
        want = jstate[n]["velocity"]
        np.testing.assert_array_equal(
            v.numpy(), want.T if n == "fc.weight" else want)
    num = sum(float((conv[n]["velocity"] - tt.opt_state[n]["velocity"])
                    .double().square().sum()) for n in tt.params)
    den = sum(float(conv[n]["velocity"].double().square().sum())
              for n in tt.params)
    assert (num / den) ** 0.5 <= golden.MODEL_TRAIN_TOL["resnet"]["slots"]
    with pytest.raises(ValueError, match="port model"):
        opt_state_from_jax(jstate, device="cpu")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_resnet.py --write-fixture")
    jax.config.update("jax_platforms", "cpu")
    st = golden.resnet_state(_port_model())
    summary = _jax_train(_jax_model(), st)[0]
    np.savez_compressed(golden.RESNET_FIXTURE, **summary)
    print(f"wrote {golden.RESNET_FIXTURE}: losses {summary['loss']}")
