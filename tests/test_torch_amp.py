"""The port's ``amp.auto_cast`` (paddle_tpu_torch/amp/auto_cast.py) against
the JAX package's on the CPU: the context only sets the amp state, and
only ``nn.functional.linear`` (with the ``nn.Linear`` layer) and
``tensor.matmul`` read it. Every other op keeps its input dtype.

Bands: an op the context must not cast gives the bits it gives outside
it; linear and matmul in bf16 within 2^-7 relative (one bf16 step) of the
JAX package's (fp32 accumulation in both, the sums in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax
from paddle_tpu_torch.nn import BatchNorm2D, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import transformer
from paddle_tpu_torch.tensor import matmul

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0)
BF16_RTOL = 2.0 ** -7


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def test_auto_cast_enters_no_torch_autocast():
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        assert pt.amp.amp_dtype() == torch.bfloat16
        assert not torch.is_autocast_enabled("cpu")
    assert pt.amp.amp_dtype() is None


def test_gpt_under_auto_cast_keeps_the_references_dtypes(monkeypatch):
    """Narrow GPT-2 under bf16 auto_cast: the residual stream and every
    LayerNorm output stay fp32; q, k, v (what SDPA receives) and the
    logits are bf16, as the JAX package's logits are; the logits agree
    with the JAX package's within bf16 rounding."""
    paddle.seed(0)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}))
    tm.eval()
    seen = {}

    def record(name):
        def hook(mod, inputs, out):
            seen.setdefault(name, set()).add(out.dtype)
        return hook

    for i, blk in enumerate(tm.gpt.blocks):
        blk.ln1.register_forward_hook(record("ln"))
        blk.ln2.register_forward_hook(record("ln"))
        blk.register_forward_hook(record("residual"))
    tm.gpt.ln_f.register_forward_hook(record("ln"))
    real_sdpa = transformer.scaled_dot_product_attention

    def sdpa(q, k, v, *a, **kw):
        for name, t in (("q", q), ("k", k), ("v", v)):
            seen.setdefault(name, set()).add(t.dtype)
        return real_sdpa(q, k, v, *a, **kw)

    from paddle_tpu_torch.models import gpt as pgpt
    monkeypatch.setattr(pgpt, "scaled_dot_product_attention", sdpa)
    ids = np.random.RandomState(1).randint(0, CFG["vocab_size"], (2, 16))
    with torch.no_grad(), pt.amp.auto_cast(True, dtype="bfloat16"):
        logits = tm(torch.from_numpy(ids).long())
    with paddle.amp.auto_cast(True, dtype="bfloat16"):
        jlogits = jm(paddle.to_tensor(ids.astype(np.int32)))
    assert seen == {"ln": {torch.float32}, "residual": {torch.float32},
                    "q": {torch.bfloat16}, "k": {torch.bfloat16},
                    "v": {torch.bfloat16}}
    assert logits.dtype == torch.bfloat16
    assert str(jlogits.dtype) == "bfloat16"
    want = np.asarray(jlogits._data).astype(np.float32)
    scale = np.abs(want).max()
    assert np.abs(logits.float().numpy() - want).max() <= 4 * BF16_RTOL * scale


def test_auto_cast_casts_no_other_op():
    """exp, conv2d and batch_norm (eval, and training with its running
    statistics) under bf16 auto_cast: fp32 in, the same fp32 bits out."""
    x = torch.from_numpy(_rand(2, 4, 8, 8))
    w = torch.from_numpy(_rand(6, 4, 3, 3, seed=1))
    outs = []
    for amp in (False, True):
        bn = BatchNorm2D(6)
        with pt.amp.auto_cast(amp, dtype="bfloat16"):
            y = F.conv2d(x, w, padding=1)
            bn.eval()
            e = bn(y)
            bn.train()
            t = bn(y)
            outs.append((torch.exp(x), y, e, t, bn._mean.clone(),
                         bn._variance.clone()))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
def test_linear_and_matmul_cast_as_the_reference(amp):
    x, w, b = _rand(3, 5, 16), _rand(16, 8, seed=1), _rand(8, seed=2)
    y = _rand(3, 8, 16, seed=3)
    with paddle.amp.auto_cast(amp, dtype="bfloat16"):
        jlin = JF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                         paddle.to_tensor(b))
        jmm = paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(y),
                            transpose_y=True)
    layer = Linear(16, 8)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        layer.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x)
    with pt.amp.auto_cast(amp, dtype="bfloat16"):
        lin = F.linear(tx, torch.from_numpy(w), torch.from_numpy(b))
        lay = layer(tx)
        mm = matmul(tx, torch.from_numpy(y), transpose_y=True)
    want_dt = torch.bfloat16 if amp else torch.float32
    for got, want in ((lin, jlin), (lay, jlin), (mm, jmm)):
        assert got.dtype == want_dt and str(want.dtype) == str(
            want_dt).replace("torch.", "")
        w_ = np.asarray(want._data).astype(np.float32)
        tol = 2 * BF16_RTOL * np.abs(w_).max() if amp else 1e-5
        np.testing.assert_allclose(got.detach().float().numpy(), w_,
                                   atol=tol, rtol=0)
    assert matmul(torch.ones(2, 3), torch.ones(4, 2), transpose_x=True,
                  transpose_y=True).shape == (3, 4)
