"""Every option of the port's ``cross_entropy`` and
``softmax_with_cross_entropy`` (paddle_tpu_torch/nn/functional/loss.py)
against the JAX package's on the same numpy logits and labels, and the
``CrossEntropyLoss`` layer passing them through.

Tolerances: fp32 values and logits grads within 1e-6 (abs and rel; the
same formula, reduced in another order). bf16 logits: the hard path's loss
comes back bf16 in both packages and agrees within one bf16 step (2^-7
relative); the soft path's log-softmax runs in bf16 in both (torch rounds
once from fp32, XLA after each op), within 2% relative, and its result
stays in the promoted dtype (fp32 with fp32 labels), as the reference's
does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn.functional import (cross_entropy,
                                            softmax_with_cross_entropy)

N, C = 12, 7
TOL = dict(rtol=1e-6, atol=1e-6)


def _data(seed=2):
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, C).astype(np.float32)
    labels = rng.randint(0, C, (N,)).astype(np.int64)
    labels[[1, 5]] = -100
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    soft = rng.rand(N, C).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = (0.5 + rng.rand(C)).astype(np.float32)
    return logits, labels, probs.astype(np.float32), soft, weight


def _both(x, label, **kwargs):
    """(the reference's loss and d(sum loss)/dx, the port's)."""
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    jx = paddle.to_tensor(x, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(label), **jkw)
    jl.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tl = cross_entropy(tx, torch.from_numpy(label), **tkw)
    tl.sum().backward()
    return (np.asarray(jl._data), np.asarray(jx.grad._data)), \
        (tl.detach().numpy(), tx.grad.numpy())


HARD = {
    "weight_mean": dict(weight="w"),
    "weight_sum": dict(weight="w", reduction="sum"),
    "weight_none": dict(weight="w", reduction="none"),
    "smoothing": dict(label_smoothing=0.1),
    "smoothing_weight_sum": dict(label_smoothing=0.2, weight="w",
                                 reduction="sum"),
    "no_softmax": dict(use_softmax=False),
    "no_softmax_smoothing_none": dict(use_softmax=False,
                                      label_smoothing=0.1,
                                      reduction="none"),
    "ignore_index_3": dict(ignore_index=3),
}


@pytest.mark.parametrize("case", sorted(HARD))
def test_hard_label_options_match_reference(case):
    logits, labels, probs, _, weight = _data()
    kwargs = {k: weight if v == "w" else v for k, v in HARD[case].items()}
    x = probs if kwargs.get("use_softmax") is False else logits
    if "ignore_index" in kwargs:
        labels = np.where(labels < 0, kwargs["ignore_index"], labels)
    (jv, jg), (tv, tg) = _both(x, labels, **kwargs)
    assert tv.dtype == jv.dtype == np.float32 and tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


SOFT = {
    "mean": dict(), "sum": dict(reduction="sum"),
    "none": dict(reduction="none"), "smoothing": dict(label_smoothing=0.1),
    "no_softmax": dict(use_softmax=False),
    "weight_not_read": dict(weight="w"),
}


@pytest.mark.parametrize("case", sorted(SOFT))
@pytest.mark.parametrize("flag", [True, False], ids=["soft_label",
                                                    "by_shape"])
def test_soft_label_options_match_reference(case, flag):
    logits, _, probs, soft, weight = _data()
    kwargs = {k: weight if v == "w" else v for k, v in SOFT[case].items()}
    x = probs if kwargs.get("use_softmax") is False else logits
    (jv, jg), (tv, tg) = _both(x, soft, soft_label=flag, **kwargs)
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    if case == "weight_not_read":
        (_, _), (plain, _) = _both(x, soft, soft_label=flag)
        np.testing.assert_array_equal(tv, plain)


@pytest.mark.parametrize("soft", [False, True])
def test_bf16_logits_keep_the_references_dtypes(soft):
    logits, labels, _, soft_labels, _ = _data()
    label = soft_labels if soft else labels
    jl = JF.cross_entropy(paddle.to_tensor(logits).astype("bfloat16"),
                          paddle.to_tensor(label), soft_label=soft)
    tl = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                       torch.from_numpy(label), soft_label=soft)
    assert str(tl.dtype).replace("torch.", "") == str(jl._data.dtype)
    rtol = 0.02 if soft else 2.0 ** -7
    np.testing.assert_allclose(float(tl.float()), float(jl.astype(
        "float32")._data), rtol=rtol)


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_with_cross_entropy_matches_reference(axis):
    logits, labels, _, soft, _ = _data()
    if axis == 1:      # [N, C, 1]: the class axis in the middle
        logits, soft = logits[..., None], soft[..., None]
        labels = labels[:, None]
    lab = np.where(labels < 0, 0, labels)[:, None]   # `axis` kept, size 1
    want = JF.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(lab), axis=axis,
        return_softmax=True)
    got = softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(lab), axis=axis,
        return_softmax=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data), **TOL)
    got = softmax_with_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(soft), soft_label=True,
                                     axis=axis)
    want = JF.softmax_with_cross_entropy(paddle.to_tensor(logits),
                                         paddle.to_tensor(soft),
                                         soft_label=True, axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)


def test_cross_entropy_loss_layer_passes_every_option():
    logits, labels, probs, soft, weight = _data()
    cases = [
        (dict(weight=weight, label_smoothing=0.1, reduction="sum"), logits,
         labels),
        (dict(soft_label=True, label_smoothing=0.05), logits, soft),
        (dict(use_softmax=False, ignore_index=2), probs,
         np.where(labels < 0, 2, labels)),
    ]
    for kwargs, x, label in cases:
        jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()}
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()}
        want = paddle.nn.CrossEntropyLoss(**jkw)(paddle.to_tensor(x),
                                                 paddle.to_tensor(label))
        got = CrossEntropyLoss(**tkw)(torch.from_numpy(x),
                                      torch.from_numpy(label))
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   **TOL)


def test_bad_reduction_raises():
    logits, labels, *_ = _data()
    with pytest.raises(ValueError, match="reduction"):
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                      reduction="avg")
