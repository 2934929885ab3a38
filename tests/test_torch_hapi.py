"""The port's high-level ``Model`` (``prepare``, ``train_batch``,
``eval_batch``, ``predict_batch``) on LeNet, with the pooling layers and
``CrossEntropyLoss`` that LeNet and ResNet train through, against the JAX
package's on the CPU, from the same numpy-drawn weights and batch; and
every option this slice leaves out, pinned to raise NotImplementedError.

Bands:
- pooling outputs and input grads within 1e-6 (fp32; the same windows,
  sums in another order), and ``ceil_mode=True`` giving the reference's
  floor-mode windows exactly in shape;
- CrossEntropyLoss's value and logits grad within 1e-6 on [B] int32 and
  [B, 1] int64 labels;
- LeNet's eval logits within 1e-5 (fp32);
- three ``train_batch`` steps (Adam 1e-3, ``CrossEntropyLoss`` over
  [8, 1] int64 labels) against the committed fixture
  (golden.LENET_FIXTURE), by ``golden.model_train_errors`` within
  golden.MODEL_TRAIN_TOL["lenet"] (fp32 throughout: the losses read
  5.9e-7 relative, the updates 3.9e-6, the norms 2.3e-6 on the CPU;
  Adam's normalised step turns a rounding-sized grad difference into an
  lr-sized step where a grad is near zero, hence 1e-3 for the updates);
- ``eval_batch``'s loss and ``predict_batch``'s logits after those steps
  within 1e-4 of the JAX package's, relative to the loss and to the
  largest logit (the logits read 4.6e-6: the three Adam steps carry
  rounding-sized grad differences into the weights);
- ``state_from_jax`` transposes the three ``fc`` weights, nothing else.

Run ``python tests/test_torch_hapi.py --write-fixture`` to rewrite the
committed fixture; test_committed_lenet_fixture_matches_jax checks that
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
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.vision.models import LeNet as JLeNet  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.hapi import model as hapi_model  # noqa: E402
from paddle_tpu_torch.models import bert, linear_weights, \
    state_from_jax  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.testing import golden  # noqa: E402
from paddle_tpu_torch.vision.models import LeNet  # noqa: E402


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


# ---- pooling ----------------------------------------------------------------

POOLS = [
    ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", dict(kernel_size=2, stride=2)),
    ("max_pool2d", dict(kernel_size=3, stride=1, padding=2)),
    ("max_pool2d", dict(kernel_size=2, stride=2, ceil_mode=True)),
    ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1,
                        exclusive=False)),
    ("avg_pool2d", dict(kernel_size=3, stride=1, padding=2)),
    ("avg_pool2d", dict(kernel_size=(2, 3), stride=(2, 1), padding=(1, 0),
                        ceil_mode=True)),
    ("adaptive_avg_pool2d", dict(output_size=(1, 1))),
    ("adaptive_avg_pool2d", dict(output_size=(3, 4))),
    ("adaptive_avg_pool2d", dict(output_size=(None, 3))),
]


@pytest.mark.parametrize("fn, kwargs", POOLS, ids=[
    "max_k3s2p1", "max_k2s2", "max_wide_pad", "max_ceil_mode",
    "avg_k3s2p1", "avg_inclusive", "avg_wide_pad", "avg_ceil_mode",
    "adaptive_1x1", "adaptive_3x4", "adaptive_none"])
def test_pooling_matches_reference(fn, kwargs):
    x = _rand(2, 3, 7, 10)
    r_seed = 1
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = getattr(JF, fn)(jx, **kwargs)
    r = _rand(*jout.shape, seed=r_seed)
    (jout * paddle.to_tensor(r)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    out = getattr(F, fn)(tx, **kwargs)
    assert tuple(out.shape) == tuple(jout.shape)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout._data),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               atol=1e-6, rtol=0)


def test_ceil_mode_gives_the_reference_floor_windows():
    """The reference's _pool never reads ceil_mode: a 7-wide input pooled
    2 / 2 gives 3 columns with either setting, in both packages."""
    x = _rand(1, 1, 7, 7)
    for ceil in (False, True):
        assert tuple(F.max_pool2d(torch.tensor(x), 2, 2, ceil_mode=ceil)
                     .shape) == (1, 1, 3, 3)
        assert tuple(JF.max_pool2d(paddle.to_tensor(x), 2, 2,
                                   ceil_mode=ceil).shape) == (1, 1, 3, 3)


def test_pooling_layers_match_their_functionals():
    x = torch.tensor(_rand(2, 3, 9, 9))
    for layer, fn in ((nn.MaxPool2D(3, 2, 1), lambda v: F.max_pool2d(
            v, 3, 2, 1)), (nn.AvgPool2D(3, 2, 1), lambda v: F.avg_pool2d(
                v, 3, 2, 1)), (nn.AdaptiveAvgPool2D((1, 1)),
                               lambda v: F.adaptive_avg_pool2d(v, 1))):
        assert torch.equal(layer(x), fn(x))
        assert not list(layer.parameters())


# ---- CrossEntropyLoss -------------------------------------------------------

@pytest.mark.parametrize("label_shape, dtype", [
    ((6,), np.int32), ((6, 1), np.int64)], ids=["B_int32", "B1_int64"])
def test_cross_entropy_loss_matches_reference(label_shape, dtype):
    logits = _rand(6, 10, seed=2) * 3
    labels = np.random.RandomState(3).randint(0, 10, label_shape) \
        .astype(dtype)
    jl = paddle.to_tensor(logits, stop_gradient=False)
    jloss = paddle.nn.CrossEntropyLoss()(jl, paddle.to_tensor(labels))
    jloss.backward()
    tl = torch.tensor(logits, requires_grad=True)
    loss = nn.CrossEntropyLoss()(tl, torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(np.asarray(jloss._data))) <= 1e-6
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jl.grad._data),
                               atol=1e-6, rtol=0)


# ---- LeNet through Model ---------------------------------------------------

def _state():
    return golden.jax_state(golden.jax_shapes(LeNet(device="cpu")),
                            golden.LENET_SEED)


def _jax_run(state):
    """The JAX package's Model run: (the training summary, eval_batch's
    result, predict_batch's outputs)."""
    net = JLeNet()
    for name, t in net.state_dict().items():
        t.set_value(state[name])
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Adam(learning_rate=golden.LENET_LR,
                                        parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss())
    images, labels = golden.lenet_batch()
    losses = [model.train_batch([images], [labels])[0]
              for _ in range(golden.MODEL_TRAIN_STEPS)]
    summary = golden.model_train_summary(
        losses, {n: np.asarray(p._data) for n, p in net.named_parameters()},
        state)
    return summary, model.eval_batch([images], [labels]), \
        model.predict_batch([images])


def _port_model(state, device="cpu"):
    net = LeNet(device=device)
    net.load_state_dict(state_from_jax(state, net))
    model = pt.Model(net)
    model.prepare(Adam(learning_rate=golden.LENET_LR,
                       parameters=model.parameters()),
                  nn.CrossEntropyLoss())
    return model


def _port_run(state):
    model = _port_model(state)
    images, labels = golden.lenet_batch()
    losses = [model.train_batch([images], [labels])[0]
              for _ in range(golden.MODEL_TRAIN_STEPS)]
    summary = golden.model_train_summary(
        losses, golden.jax_layout(dict(model.network.named_parameters()),
                                  model.network), state)
    return summary, model.eval_batch([images], [labels]), \
        model.predict_batch([images])


@pytest.fixture(scope="module")
def state():
    return _state()


@pytest.fixture(scope="module")
def jax_run(state):
    return _jax_run(state)


@pytest.fixture(scope="module")
def port_run(state):
    return _port_run(state)


def test_lenet_eval_forward_matches_reference(state):
    net = JLeNet()
    for name, t in net.state_dict().items():
        t.set_value(state[name])
    net.eval()
    images, _ = golden.lenet_batch()
    want = np.asarray(net(paddle.to_tensor(images))._data)
    tm = LeNet(device="cpu").eval()
    tm.load_state_dict(state_from_jax(state, tm))
    with torch.no_grad():
        got = tm(images).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert set(net.state_dict()) == set(state)


def test_committed_lenet_fixture_matches_jax(jax_run):
    fix = dict(np.load(golden.LENET_FIXTURE))
    err = golden.model_train_errors(fix, jax_run[0])
    assert max(err.values()) <= 1e-6, err


def test_train_batch_trains_to_the_committed_fixture(port_run):
    """chip_smoke.py's check on the card, on the CPU (plain versions)."""
    fix = dict(np.load(golden.LENET_FIXTURE))
    err = golden.model_train_errors(port_run[0], fix)
    assert golden.within(err, golden.MODEL_TRAIN_TOL["lenet"]), err
    assert all(isinstance(x, float) for x in port_run[0]["loss"].tolist())


def test_eval_and_predict_batch_match_reference(jax_run, port_run):
    (_, jeval, jpred), (_, teval, tpred) = jax_run, port_run
    assert len(teval) == len(jeval) == 1
    assert abs(teval[0] - jeval[0]) <= 1e-4 * abs(jeval[0])
    assert len(tpred) == len(jpred) == 1
    assert isinstance(tpred[0], np.ndarray)
    np.testing.assert_allclose(tpred[0], jpred[0],
                               atol=1e-4 * np.abs(jpred[0]).max(), rtol=0)


def test_train_batch_moves_int32_labels_to_int64_on_the_device(state):
    """Labels arrive as numpy int32 [B] too (as ResNet's bench run draws
    them): the adapter casts them to int64, as SpmdTrainer does, and
    gives the int64 run's loss."""
    images, labels = golden.lenet_batch()
    a, b = _port_model(state), _port_model(state)
    la = a.train_batch([images], [labels])
    lb = b.train_batch(images, labels.astype(np.int32).ravel())
    assert la == lb


def test_converters_transpose_the_linear_weights_only(state):
    m = LeNet(device="cpu")
    assert linear_weights(m) == {"fc.0.weight", "fc.1.weight",
                                 "fc.2.weight"}
    sd = state_from_jax(state, m)
    for n, a in state.items():
        want = a.T if n.startswith("fc.") and n.endswith("weight") else a
        np.testing.assert_array_equal(sd[n].numpy(), want)


@pytest.mark.parametrize("build", [
    lambda: LeNet(), lambda: pt.vision.models.resnet18(num_classes=4),
    lambda: pt.models.BertForPretraining(pt.models.BertConfig.tiny())],
    ids=["LeNet", "resnet18", "BertForPretraining"])
def test_new_entry_points_need_cuda_unless_asked_for_the_cpu(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


# ---- what this slice leaves out ---------------------------------------------

def _prepared():
    return pt.Model(LeNet(device="cpu"))


REFUSED = {
    "Model(use_jit=True)": (lambda: pt.Model(LeNet(device="cpu"),
                                             use_jit=True), "use_jit"),
    "prepare(metrics=)": (lambda: _prepared().prepare(
        metrics=[object()]), "metric"),
    "prepare(amp_configs=)": (lambda: _prepared().prepare(
        amp_configs={"level": "O1"}), "amp_configs"),
    "fit": (lambda: _prepared().fit(None), "DataLoader"),
    "evaluate": (lambda: _prepared().evaluate(None), "DataLoader"),
    "predict": (lambda: _prepared().predict(None), "DataLoader"),
    "save": (lambda: _prepared().save("x", training=False), "jit/"),
    "load": (lambda: pt.framework.io.load("x", device="cpu",
                                          encryption_key="k"),
             "framework/crypto.py"),
    "summary": (lambda: _prepared().summary(), "model_summary"),
    "flops": (lambda: hapi_model.flops(None), "model_summary"),
    "max_pool2d(return_mask=True)": (lambda: F.max_pool2d(
        torch.zeros(1, 1, 4, 4), 2, return_mask=True), "return_mask"),
    "max_pool2d NHWC": (lambda: F.max_pool2d(
        torch.zeros(1, 4, 4, 1), 2, data_format="NHWC"), "NCHW only"),
    "avg_pool2d NHWC": (lambda: nn.AvgPool2D(2, data_format="NHWC")(
        torch.zeros(1, 4, 4, 1)), "NCHW only"),
    "adaptive_avg_pool2d NHWC": (lambda: F.adaptive_avg_pool2d(
        torch.zeros(1, 4, 4, 1), 1, data_format="NHWC"), "NCHW only"),
    "avg_pool2d(divisor_override=)": (lambda: F.avg_pool2d(
        torch.zeros(1, 1, 4, 4), 2, divisor_override=3),
        "divisor_override"),
    "pool padding='SAME'": (lambda: F.max_pool2d(
        torch.zeros(1, 1, 4, 4), 2, padding="SAME"), "padding"),
    "MultiHeadAttention.gen_cache": (lambda: nn.MultiHeadAttention(
        8, 2).gen_cache(torch.zeros(1, 2, 8)), "cache"),
    "MultiHeadAttention(cache=)": (lambda: nn.MultiHeadAttention(8, 2)(
        torch.zeros(1, 2, 8), cache=(None, None)), "cache"),
    "TransformerEncoder(cache=)": (lambda: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(8, 2, 16), 2)(
        torch.zeros(1, 2, 8), cache=[None, None]), "cache"),
    "Embedding(padding_idx=)": (lambda: nn.Embedding(4, 3, padding_idx=0),
                                "padding_idx"),
    "BertForSequenceClassification": (
        lambda: bert.BertForSequenceClassification, "fine-tuning heads"),
    "BertForTokenClassification": (
        lambda: bert.BertForTokenClassification, "fine-tuning heads"),
    "BertForQuestionAnswering": (
        lambda: bert.BertForQuestionAnswering, "fine-tuning heads"),
    "resnet50(pretrained=True)": (lambda: pt.vision.models.resnet50(
        pretrained=True, device="cpu"), "pretrained"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_options_left_out_raise_and_name_what_they_lack(what):
    call, names = REFUSED[what]
    with pytest.raises(NotImplementedError, match=names):
        call()


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_hapi.py --write-fixture")
    jax.config.update("jax_platforms", "cpu")
    summary = _jax_run(_state())[0]
    np.savez_compressed(golden.LENET_FIXTURE, **summary)
    print(f"wrote {golden.LENET_FIXTURE}: losses {summary['loss']}")
