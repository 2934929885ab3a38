"""The port's quantized KV caches (``cache_dtype="int8"`` / ``"fp8"`` in
paddle_tpu_torch/models/gpt.py ``_decode_fns``, ``generate`` and the
dense ``ServingEngine``) against the JAX package's on the CPU, on a tiny
GPT whose weights are carried across with params_from_jax.

Bands:
- the quantizer on the same K/V rows: int8 codes and every scale
  bit-equal to the reference's (the same order of operations: absmax in
  the row's dtype, fp32 division by qmax, a floor of 1e-8, round half to
  even, clip); fp8 codes within one e4m3 step of the reference's (torch
  and XLA each round the scaled value to the nearest e4m3 value);
- the caches each package fills from its own prefill: int8 codes within
  one unit and scales within 1e-5 relative (the K/V rows themselves differ
  by fp32 summation order), fp8 codes within one e4m3 step;
- greedy tokens equal to the JAX package's, and the engine's equal to
  ``generate``'s.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax
from paddle_tpu_torch.models import gpt as pgpt

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0)
QUANT = ("int8", "fp8")


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    return jm, tm.eval()


def _ids(b=2, s=9, seed=0):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (b, s)).astype(np.int32)


def _e4m3_step(x):
    """The gap between e4m3 values at |x| (subnormal spacing below 2^-6)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -6)))
    return 2.0 ** (e - 3)


def _jax_prefill(jm, ids, cache_dtype):
    """The JAX package's decode fwd over the prompt: its cache sides."""
    fwd, _, cache_init = jgpt._decode_fns(jm.cfg, False, False,
                                          cache_dtype=cache_dtype)
    params = {n: p._data for n, p in jm.named_parameters()}
    kc, vc = cache_init(ids.shape[0], ids.shape[1], jnp.float32)
    _, kc, vc = fwd(params, jnp.asarray(ids), 0, kc, vc)
    return kc, vc


def _port_prefill(tm, ids, cache_dtype):
    fwd, _, cache_init = pgpt._decode_fns(tm.cfg, cache_dtype)
    p = {n: q.detach() for n, q in tm.named_parameters()}
    kc, vc = cache_init(ids.shape[0], ids.shape[1], torch.float32, "cpu")
    with torch.no_grad():
        fwd(p, torch.from_numpy(ids).long(), 0, kc, vc)
    return kc, vc


def _codes(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t)
                      else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("cache_dtype", QUANT)
def test_quantizer_on_the_references_rows(models, cache_dtype):
    """In layer 0 the reference's fp32 cache holds the rows its quantized
    cache was made from (the same eager decode math; later layers read
    the dequantized cache): the port's quantizer on those rows gives the
    reference's codes and scales."""
    jm, _ = models
    ids = _ids()
    rows = _jax_prefill(jm, ids, None)
    quant = _jax_prefill(jm, ids, cache_dtype)
    for side, (vals, scales) in zip(rows, quant):
        codes, s = pgpt._quantize(torch.tensor(np.asarray(side[0])),
                                  cache_dtype)
        np.testing.assert_array_equal(s.numpy(), np.asarray(scales[0]))
        want = _codes(vals[0])
        if cache_dtype == "int8":
            assert codes.dtype == torch.int8
            np.testing.assert_array_equal(_codes(codes), want)
        else:
            assert codes.dtype == torch.float8_e4m3fn
            assert np.all(np.abs(_codes(codes) - want) <= _e4m3_step(want))


def test_quantizer_edges():
    """Halves round to even (int8), a zero row keeps the 1e-8 floor, and
    the row's absmax lands on +-qmax without turning into NaN in fp8."""
    row = torch.tensor([[0.5, 1.5, 2.5, -2.5, 127.0]])
    codes, s = pgpt._quantize(row, "int8")
    assert float(s) == 1.0
    assert codes.tolist() == [[0, 2, 2, -2, 127]]
    codes, s = pgpt._quantize(torch.zeros(1, 4), "int8")
    assert float(s) == np.float32(1e-8) and not codes.any()
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    codes, s = pgpt._quantize(x, "fp8")
    c = codes.float()
    assert bool(torch.isfinite(c).all())
    assert torch.equal(c.abs().amax(-1), torch.full((64,), 448.0))


@pytest.mark.parametrize("cache_dtype", QUANT)
def test_prefill_caches_match_the_references(models, cache_dtype):
    jm, tm = models
    ids = _ids()
    want = _jax_prefill(jm, ids, cache_dtype)
    got = _port_prefill(tm, ids, cache_dtype)
    for (gv, gs), (wv, ws) in zip(got, want):
        assert gv.dtype == pgpt._QUANT[cache_dtype][0]
        assert gs.dtype == torch.float32 and gs.shape == gv.shape[:-1] + (1,)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=0)
        g, w = _codes(gv), _codes(wv)
        step = 1.0 if cache_dtype == "int8" else _e4m3_step(w)
        assert np.all(np.abs(g - w) <= step)


@pytest.mark.parametrize("cache_dtype", QUANT)
def test_greedy_generate_matches_jax(models, cache_dtype):
    jm, tm = models
    ids = _ids(s=7)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=12,
                                  temperature=0.0,
                                  cache_dtype=cache_dtype)._data)
    got = tm.generate(torch.from_numpy(ids).long(), max_new_tokens=12,
                      temperature=0.0, cache_dtype=cache_dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache_dtype", QUANT)
def test_engine_equals_generate(models, cache_dtype):
    """The dense engine on a quantized cache (staggered admissions, a
    chunked prefill and a prefix hit) gives each request generate's
    tokens on the same cache_dtype."""
    _, tm = models
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, CFG["vocab_size"], (n,)).astype(np.int32)
               for n in (5, 11, 3, 17)]
    eng = ServingEngine(tm, max_batch=2, cache_dtype=cache_dtype,
                        prefill_chunk=8)
    assert isinstance(eng._kc, tuple) and eng._kc[0].dtype \
        == pgpt._QUANT[cache_dtype][0]
    pid = eng.register_prefix(prompts[3][:9])
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts[:3]]
    # a prefix request's prompt is its suffix
    rids.append(eng.submit(prompts[3][9:], max_new_tokens=6, prefix_id=pid))
    res = eng.run_until_complete()
    assert eng.stats()["prefix_cache"]["hit"] == 1
    for p, r in zip(prompts, rids):
        want = tm.generate(torch.from_numpy(p[None]).long(),
                           max_new_tokens=6, temperature=0.0,
                           cache_dtype=cache_dtype)[0, len(p):].tolist()
        assert [int(t) for t in res[r].output_ids] == want


def test_cache_dtype_validation(models):
    _, tm = models
    for call in (lambda: pgpt._decode_fns(tm.cfg, "int4"),
                 lambda: tm.generate(torch.zeros((1, 3), dtype=torch.long),
                                     max_new_tokens=2, cache_dtype="int4"),
                 lambda: ServingEngine(tm, max_batch=1, cache_dtype="bf16")):
        with pytest.raises(ValueError, match="cache_dtype"):
            call()
    assert "quantized" in pgpt.GPTDecodeModel().cache_spec(tm.cfg)
