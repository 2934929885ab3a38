"""The port's BERT pretraining path (``layer_norm``, ``gelu``, the
transformer encoder with ``MultiHeadAttention`` and its mask conversion,
``BertForPretraining`` and ``BertPretrainLoss``, AdamW through
``SpmdTrainer``, the optimizer-state converter) against the JAX
package's on the CPU, from the same numpy-drawn inputs and weights.

Bands:
- ``layer_norm`` within 1e-6 in fp32; on a bf16 input within one bf16
  step (2^-7 relative) and in the reference's dtype (fp32 with fp32
  parameters, bf16 without);
- ``MultiHeadAttention`` (a [b, s] keep-mask, a [q, k] bool mask, a [q, k]
  additive mask) and the pre-norm ``TransformerEncoderLayer``: outputs
  within 1e-5 (fp32);
- tiny BERT (``BertConfig.tiny()``, batch 2, seq 16) in training mode:
  the MLM and NSP logits within 1e-4 (read 3.0e-7) and every grad within
  1e-3 of its tensor's largest, floored at 1e-8 (reads 3.8e-4: k_proj's
  bias moves no softmax, so its grads are rounding, ~1e-12), ``pooler``
  and ``nsp`` without a grad in both;
- under bf16 auto_cast the dtypes of q / k / v, the attention output, the
  MLM head's LayerNorm output, the logits and the loss equal the
  reference's (bf16, bf16, fp32, bf16, bf16);
- three AdamW steps of tiny BERT at batch 2, seq 128 under bf16 auto_cast
  against the committed fixture (golden.BERT_FIXTURE), by
  ``golden.model_train_errors`` within golden.MODEL_TRAIN_TOL["bert"]
  (its comment gives the reasons and the CPU's readings), and
  ``pooler`` / ``nsp`` decayed by ``(1 - lr * wd)`` a step with zero
  grads, within 1e-7 of the JAX package's values;
- ``opt_state_from_jax`` transposes the moments of every Linear weight
  (and nothing else: not the tied word embedding), bit for bit.

Run ``python tests/test_torch_bert.py --write-fixture`` to rewrite the
committed fixture; test_committed_bert_fixture_matches_jax checks that it
still matches the JAX package.
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
from paddle_tpu.models import BertConfig as JConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JBert  # noqa: E402
from paddle_tpu.models import BertPretrainLoss as JLoss  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertPretrainLoss, linear_weights,
                                     opt_state_from_jax,
                                     state_from_jax)  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.nn.layer.transformer import \
    _convert_attn_mask  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.testing import golden  # noqa: E402

WD = 0.01        # AdamW's default weight decay, in both packages


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


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


def _load_pair(jlayer, tlayer, seed, **draw):
    """The same numpy-drawn state into a JAX layer and its port."""
    state = golden.jax_state(golden.jax_shapes(tlayer), seed, **draw)
    for name, t in jlayer.state_dict().items():
        t.set_value(state[name])
    tlayer.load_state_dict(state_from_jax(state, tlayer))
    return state


# ---- layer_norm -------------------------------------------------------------

@pytest.mark.parametrize("dtype, affine", [
    ("float32", True), ("bfloat16", True), ("bfloat16", False)],
    ids=["fp32", "bf16_fp32_params", "bf16_no_params"])
def test_layer_norm_matches_reference(dtype, affine):
    x = _rand(3, 5, 32) * 2 + 0.5
    w, b = 1 + 0.1 * _rand(32, seed=1), 0.1 * _rand(32, seed=2)
    jargs = [paddle.to_tensor(w), paddle.to_tensor(b)] if affine else []
    targs = [torch.tensor(w), torch.tensor(b)] if affine else []
    want = JF.layer_norm(paddle.to_tensor(x).astype(dtype), 32, *jargs,
                         epsilon=1e-5)
    got = F.layer_norm(torch.tensor(x).to(getattr(torch, dtype)), 32,
                       *targs, epsilon=1e-5)
    assert _dtype(got) == str(want.dtype)
    w_ = np.asarray(want._data).astype(np.float32)
    tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(w_).max()
    np.testing.assert_allclose(got.float().numpy(), w_, atol=tol, rtol=0)


# ---- attention --------------------------------------------------------------

def test_convert_attn_mask_reads_2d_masks_as_the_reference():
    keep = torch.tensor([[1, 1, 0], [1, 0, 0]])
    out = _convert_attn_mask(keep, q_len=3, k_len=3)
    assert out.shape == (2, 1, 1, 3) and out.dtype == torch.bool
    qk = torch.ones(2, 3, dtype=torch.bool)
    assert _convert_attn_mask(qk, q_len=2, k_len=3) is qk
    add = torch.zeros(4, 3)
    assert _convert_attn_mask(add, q_len=2, k_len=3) is add
    four = torch.ones(2, 1, 2, 3, dtype=torch.bool)
    assert _convert_attn_mask(four, 2, 3) is four
    assert _convert_attn_mask(None) is None


def _masks():
    rng = np.random.RandomState(3)
    keep = np.ones((2, 6), np.int64)
    keep[0, 4:] = 0
    keep[1, 5:] = 0
    qk = np.tril(np.ones((6, 6), bool))
    add = (rng.rand(6, 6) * -2).astype(np.float32)
    return {"keep_b_s": keep, "bool_q_k": qk, "additive_q_k": add}


@pytest.mark.parametrize("mask", ["keep_b_s", "bool_q_k", "additive_q_k"])
def test_multi_head_attention_matches_reference(mask):
    jm = paddle.nn.MultiHeadAttention(16, 4)
    tm = nn.MultiHeadAttention(16, 4)
    _load_pair(jm, tm, 4, std_2d=0.3)
    x = _rand(2, 6, 16, seed=5)
    m = _masks()[mask]
    want = jm(paddle.to_tensor(x), attn_mask=paddle.to_tensor(m))
    got = tm(torch.tensor(x), attn_mask=torch.tensor(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               atol=1e-5, rtol=0)


def test_pre_norm_encoder_layer_matches_reference():
    jl = paddle.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                           normalize_before=True)
    tl = nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                    normalize_before=True)
    _load_pair(jl, tl, 6, std_2d=0.3)
    x = _rand(2, 6, 16, seed=7)
    want = jl(paddle.to_tensor(x))
    got = tl(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               atol=1e-5, rtol=0)


def test_encoder_deep_copies_its_first_layer():
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(8, 2, 16), 3)
    first = {k: v.clone() for k, v in enc.layers[0].state_dict().items()}
    for layer in enc.layers[1:]:
        assert layer is not enc.layers[0]
        for k, v in layer.state_dict().items():
            assert torch.equal(v, first[k]), k
    enc.reset_parameters(torch.Generator().manual_seed(1))
    assert not torch.equal(enc.layers[0].linear1.weight, first[
        "linear1.weight"])
    for layer in enc.layers[1:]:
        assert torch.equal(layer.linear1.weight, enc.layers[0].linear1.weight)


# ---- tiny BERT --------------------------------------------------------------

def _bert_state():
    return golden.jax_state(golden.jax_shapes(BertForPretraining(
        BertConfig.tiny(), device="cpu")), golden.BERT_SEED, std_2d=0.02,
        bias_std=0.02)


@pytest.fixture(scope="module")
def state():
    return _bert_state()


def _jax_bert(state):
    jm = JBert(JConfig.tiny())
    for name, t in jm.state_dict().items():
        t.set_value(state[name])
    return jm


def _port_bert(state, device="cpu"):
    tm = BertForPretraining(BertConfig.tiny(), device=device)
    tm.load_state_dict(state_from_jax(state, tm))
    return tm


def test_epsilons_and_names_match_the_reference(state):
    tm = _port_bert(state)
    assert set(_jax_bert(state).state_dict()) == set(state)
    eps = {n: m._epsilon for n, m in tm.named_modules()
           if isinstance(m, nn.LayerNorm)}
    assert eps.pop("ln") == 1e-5
    assert eps and set(eps.values()) == {1e-12}
    assert "bert.embeddings.ln" in eps and "bert.encoder.layers.1.norm2" in eps


def test_training_forward_and_grads_match_reference(state):
    ids, tok, labels = (a[:, :16] for a in golden.bert_batch())
    jm = _jax_bert(state)
    jm.train()
    jmlm, jnsp = jm(paddle.to_tensor(ids))
    JLoss()((jmlm, jnsp), paddle.to_tensor(labels)).backward()
    tm = _port_bert(state).train()
    mlm, nsp = tm(ids)
    BertPretrainLoss()((mlm, nsp), torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(mlm.detach().numpy(), np.asarray(jmlm._data),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(nsp.detach().numpy(), np.asarray(jnsp._data),
                               atol=1e-4, rtol=0)
    # segment ids of zeros are the default
    with torch.no_grad():
        again = tm(ids, torch.from_numpy(tok))[0]
    torch.testing.assert_close(again, mlm.detach(), rtol=0, atol=0)
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    got = golden.jax_layout({n: p.grad for n, p in tm.named_parameters()
                             if p.grad is not None}, tm)
    no_grad = {n for n, p in tm.named_parameters() if p.grad is None}
    assert no_grad == {n for n, g in jgrads.items() if g is None} == {
        "bert.pooler.weight", "bert.pooler.bias", "nsp.weight", "nsp.bias"}
    for n, g in got.items():
        want = np.asarray(jgrads[n]._data)
        # k_proj's bias moves no softmax: its grads are rounding, ~1e-12
        scale = max(float(np.abs(want).max()), 1e-8)
        assert float(np.abs(g - want).max()) <= 1e-3 * scale, n


def test_bf16_auto_cast_dtypes_match_reference(state):
    """q / k / v, the attention output (out_proj's input), the MLM head's
    LayerNorm output, the logits and the loss, each in the reference's
    dtype."""
    ids, _, labels = (a[:, :16] for a in golden.bert_batch())
    jm, tm = _jax_bert(state), _port_bert(state)
    jattn, tattn = jm.bert.encoder.layers[0].self_attn, \
        tm.bert.encoder.layers[0].self_attn
    with paddle.amp.auto_cast(True, dtype="bfloat16"):
        x = jm.bert.embeddings(paddle.to_tensor(ids))
        jqkv = [getattr(jattn, p)(x) for p in ("q_proj", "k_proj", "v_proj")]
        q = jqkv[0].reshape([2, 16, 4, 16])
        jo = JF.scaled_dot_product_attention(q, q, q, training=False)
        seq, _ = jm.bert(paddle.to_tensor(ids))
        jln = jm.ln(JF.gelu(jm.transform(seq)))
        jmlm, jnsp = jm(paddle.to_tensor(ids))
        jloss = JLoss()((jmlm, jnsp), paddle.to_tensor(labels))
    seen = {}

    def record(name):
        def hook(mod, args, out):
            seen.setdefault(name, (args[0].dtype, out.dtype))
        return hook

    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        getattr(tattn, p).register_forward_hook(record(p))
    tm.ln.register_forward_hook(record("ln"))
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        mlm, nsp = tm(ids)
        loss = BertPretrainLoss()((mlm, nsp), torch.from_numpy(labels))
    for p, jt in zip(("q_proj", "k_proj", "v_proj"), jqkv):
        assert str(seen[p][1]).replace("torch.", "") == str(jt.dtype), p
    assert str(seen["out_proj"][0]).replace("torch.", "") == str(jo.dtype)
    assert str(seen["ln"][1]).replace("torch.", "") == str(jln.dtype)
    assert _dtype(mlm) == str(jmlm.dtype) and _dtype(loss) == str(jloss.dtype)
    assert (str(jqkv[0].dtype), str(jo.dtype), str(jln.dtype),
            str(jmlm.dtype), str(jloss.dtype)) == (
        "bfloat16", "bfloat16", "float32", "bfloat16", "bfloat16")


# ---- three AdamW steps ------------------------------------------------------

SLOTS = ("moment1", "moment2")


def _jax_train(state):
    jm = _jax_bert(state)
    opt = paddle.optimizer.AdamW(learning_rate=golden.BERT_LR,
                                 parameters=jm.parameters())
    jt = JTrainer(jm, opt, loss_fn=JLoss(),
                  mesh=build_mesh((1,), ("dp",), devices=jax.devices()[:1]))
    init = {n: np.asarray(v) for n, v in jt.params.items()}
    batch = [paddle.to_tensor(a) for a in golden.bert_batch()]
    with paddle.amp.auto_cast(True, dtype="bfloat16"):
        losses = [float(np.asarray(jt.train_step(*batch)._data))
                  for _ in range(golden.MODEL_TRAIN_STEPS)]
    return golden.model_train_summary(
        losses, {n: np.asarray(v) for n, v in jt.params.items()}, init,
        {s: {n: np.asarray(jt.opt_state[n][s]) for n in jt.params}
         for s in SLOTS}), jt


def _port_train(state, device="cpu"):
    tm = _port_bert(state, device)
    tt = SpmdTrainer(tm, AdamW(learning_rate=golden.BERT_LR,
                               parameters=tm.parameters()),
                     loss_fn=BertPretrainLoss())
    init = golden.jax_layout(tt.params, tm)
    batch = golden.bert_batch()
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        losses = [float(tt.train_step(*batch))
                  for _ in range(golden.MODEL_TRAIN_STEPS)]
    return golden.port_train_summary(tt, tm, init, losses, SLOTS), tt, tm


@pytest.fixture(scope="module")
def jax_run(state):
    return _jax_train(state)


@pytest.fixture(scope="module")
def port_run(state):
    return _port_train(state)


def test_committed_bert_fixture_matches_jax(jax_run):
    fix = dict(np.load(golden.BERT_FIXTURE))
    err = golden.model_train_errors(fix, jax_run[0])
    assert max(err.values()) <= 1e-6, err


def test_port_trains_to_the_committed_fixture_on_cpu(port_run):
    """chip_smoke.py's check on the card, on the CPU (plain versions)."""
    fix = dict(np.load(golden.BERT_FIXTURE))
    err = golden.model_train_errors(port_run[0], fix)
    assert golden.within(err, golden.MODEL_TRAIN_TOL["bert"]), err


def test_pooler_and_nsp_decay_with_zero_grads(state, jax_run, port_run):
    _, jt = jax_run
    _, tt, tm = port_run
    for n in ("bert.pooler.weight", "bert.pooler.bias", "nsp.weight",
              "nsp.bias"):
        want = state[n].copy()
        for _ in range(golden.MODEL_TRAIN_STEPS):
            want = want * np.float32(1 - golden.BERT_LR * WD)
        got = golden.jax_layout({n: tt.params[n]}, tm)[n]
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
        np.testing.assert_allclose(got, np.asarray(jt.params[n]), atol=1e-7,
                                   rtol=0)
        assert not tt.opt_state[n]["moment1"].any()


def test_opt_state_from_jax_transposes_linear_moments_only(jax_run,
                                                           port_run):
    _, jt = jax_run
    _, tt, tm = port_run
    linear = linear_weights(tm)
    assert {"bert.encoder.layers.0.self_attn.q_proj.weight",
            "bert.encoder.layers.1.linear1.weight", "bert.pooler.weight",
            "transform.weight", "nsp.weight"} <= linear
    assert "bert.embeddings.word.weight" not in linear
    assert len(linear) == 2 * 6 + 3
    jstate = {n: ({k: np.asarray(v) for k, v in s.items()}
                  if n != "__step__" else np.asarray(s))
              for n, s in jt.opt_state.items()}
    conv = opt_state_from_jax(jstate, model=tm, device="cpu")
    assert set(conv) == set(tt.opt_state)
    for n in tt.params:
        for slot in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            got = conv[n][slot]
            assert got.shape == tt.opt_state[n][slot].shape, (n, slot)
            want = jstate[n][slot]
            np.testing.assert_array_equal(
                got.numpy(), want.T if n in linear else want)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_bert.py --write-fixture")
    jax.config.update("jax_platforms", "cpu")
    summary = _jax_train(_bert_state())[0]
    np.savez_compressed(golden.BERT_FIXTURE, **summary)
    print(f"wrote {golden.BERT_FIXTURE}: losses {summary['loss']}")
