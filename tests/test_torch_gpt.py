"""The port's GPT (paddle_tpu_torch/models/gpt.py) against the JAX
package's on the CPU: a tiny paddle_tpu GPTForCausalLM's weights are
carried across with params_from_jax, and both packages see the same ids.

Tolerances: eval logits within atol 1e-4 in fp32 (the same math in two
frameworks: only summation order differs); greedy tokens identical.

Run ``python tests/test_torch_gpt.py --write-fixture`` to rewrite the
committed fixture of the narrow seq-1024 model (chip_smoke.py phase 3);
test_committed_fixture_matches_jax checks it still matches.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import GPTConfig as JConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.models import gpt as pgpt  # noqa: E402
from paddle_tpu_torch.models import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import golden  # noqa: E402

ATOL = 1e-4

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.0)


@pytest.fixture(autouse=True)
def _flags_off():
    yield
    paddle.set_flags({"tpp_kernels": False})
    pt.set_flags({"tpp_kernels": False})


def _jax_model(cfg, params=None, seed=0):
    paddle.seed(seed)
    jm = JGPT(JConfig(**cfg))
    jm.eval()
    if params is not None:
        for n, p in jm.named_parameters():
            p.set_value(params[n])
    return jm


def _pair(cfg, seed=0):
    """A JAX model with seeded random weights and the port's copy of it."""
    jm = _jax_model(cfg, seed=seed)
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    tm.eval()
    return jm, tm


def _ids(cfg, b=2, s=12, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg["vocab_size"], (b, s)).astype(np.int32)


def _logits_both(jm, tm, ids):
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    return got, want


class TestEvalForward:
    @pytest.mark.parametrize("tpp_on", [False, True], ids=["dense", "tpp"])
    def test_logits_match_jax(self, tpp_on):
        jm, tm = _pair(TINY)
        paddle.set_flags({"tpp_kernels": tpp_on})
        pt.set_flags({"tpp_kernels": tpp_on})
        got, want = _logits_both(jm, tm, _ids(TINY))
        assert got.shape == want.shape == (2, 12, TINY["vocab_size"])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("extra", [dict(num_kv_heads=2),
                                       dict(attention_window=5),
                                       dict(gelu_approx=True)],
                             ids=["gqa", "window", "gelu_tanh"])
    def test_variant_configs_match_jax(self, extra):
        cfg = {**TINY, **extra}
        jm, tm = _pair(cfg)
        got, want = _logits_both(jm, tm, _ids(cfg, s=16))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    def test_tpp_hook_runs_the_kernel_path(self):
        from paddle_tpu_torch.ops import tpp

        _, tm = _pair(TINY)
        x = torch.randn(2, 12, 64)
        blk = tm.gpt.blocks[0]
        assert blk._tpp_mlp(x) is None          # flag off: dense path
        pt.set_flags({"tpp_kernels": True})
        y = blk._tpp_mlp(x)
        with torch.no_grad():
            want = blk.mlp(blk.ln2(x))
        np.testing.assert_allclose(y.detach().numpy(), want.numpy(),
                                   atol=1e-5, rtol=0)
        # a row count the registry cannot tile falls back to dense
        assert tpp.gpt_block_mlp(torch.randn(1, 7, 64), blk.ln2,
                                 blk.mlp) is None


class TestGenerate:
    def test_greedy_tokens_identical(self):
        jm, tm = _pair(TINY)
        ids = _ids(TINY, s=7)
        want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                      max_new_tokens=9,
                                      temperature=0.0)._data)
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=9,
                          temperature=0.0).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("extra", [dict(num_kv_heads=2),
                                       dict(attention_window=4)],
                             ids=["gqa", "window"])
    def test_greedy_variants_identical(self, extra):
        cfg = {**TINY, **extra}
        jm, tm = _pair(cfg)
        ids = _ids(cfg, s=6, seed=3)
        want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                      max_new_tokens=8,
                                      temperature=0.0)._data)
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=8,
                          temperature=0.0).numpy()
        np.testing.assert_array_equal(got, want)

    def test_greedy_matches_cache_free_forward(self):
        _, tm = _pair(TINY)
        cur = torch.from_numpy(_ids(TINY, s=5)).long()
        got = tm.generate(cur, max_new_tokens=6, temperature=0.0)
        with torch.no_grad():
            for _ in range(6):
                cur = torch.cat([cur, tm(cur)[:, -1].argmax(-1)[:, None]], 1)
        assert torch.equal(got, cur)

    def test_top_k_1_sampling_equals_greedy(self):
        _, tm = _pair(TINY)
        ids = torch.from_numpy(_ids(TINY, s=7)).long()
        greedy = tm.generate(ids, max_new_tokens=9, temperature=0.0)
        sampled = tm.generate(ids, max_new_tokens=9, temperature=0.7,
                              top_k=1, seed=5)
        assert torch.equal(sampled, greedy)

    def test_sampling_seeded_deterministic_and_varies(self):
        _, tm = _pair(TINY)
        ids = torch.ones((1, 4), dtype=torch.long)
        a = tm.generate(ids, max_new_tokens=8, top_k=20, top_p=0.9, seed=7)
        b = tm.generate(ids, max_new_tokens=8, top_k=20, top_p=0.9, seed=7)
        c = tm.generate(ids, max_new_tokens=8, top_k=20, top_p=0.9, seed=8)
        assert torch.equal(a, b)
        assert not torch.equal(a, c)

    def test_eos_pins_finished_rows(self):
        _, tm = _pair(TINY)
        ids = torch.from_numpy(_ids(TINY, s=5)).long()
        greedy = tm.generate(ids, max_new_tokens=6, temperature=0.0)
        eos = int(greedy[0, 6])                 # row 0's second new token
        out = tm.generate(ids, max_new_tokens=6, temperature=0.0,
                          eos_token_id=eos)
        row = out[0, 5:].tolist()
        first = row.index(eos)
        assert all(t == eos for t in row[first:])

    def test_decode_ignores_auto_cast(self):
        """The reference's decode math is raw jnp that no amp state
        reaches: generate under auto_cast gives the tokens it gives
        without, and the decode logits and cache stay in the params' dtype
        (fp32), bit for bit, in both packages."""
        from paddle_tpu_torch.amp import auto_cast

        jm, tm = _pair(TINY)
        ids = _ids(TINY, s=7)
        want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                      max_new_tokens=9,
                                      temperature=0.0)._data)
        with paddle.amp.auto_cast(True, dtype="bfloat16"):
            jamp = np.asarray(jm.generate(paddle.to_tensor(ids),
                                          max_new_tokens=9,
                                          temperature=0.0)._data)
        np.testing.assert_array_equal(jamp, want)
        t = torch.from_numpy(ids).long()
        with auto_cast(True, dtype="bfloat16"):
            got = tm.generate(t, max_new_tokens=9, temperature=0.0)
        np.testing.assert_array_equal(got.numpy(), want)
        fwd, logits_of, cache_init = pgpt._decode_fns(tm.cfg)
        p = {n: q.detach() for n, q in tm.named_parameters()}
        out = []
        for amp in (False, True):
            kc, vc = cache_init(2, 16, torch.float32, "cpu")
            with torch.no_grad(), auto_cast(amp, dtype="bfloat16"):
                x = fwd(p, t, 0, kc, vc)
                out.append((logits_of(p, x[:, -1]), x, kc))
        (base, bx, bkc), (lg, x, kc) = out
        assert lg.dtype == x.dtype == kc.dtype == torch.float32
        assert torch.equal(lg, base) and torch.equal(x, bx) \
            and torch.equal(kc, bkc)

    def test_bf16_serving_dtype(self):
        _, tm = _pair(TINY)
        ids = torch.from_numpy(_ids(TINY, s=5)).long()
        out = tm.generate(ids, max_new_tokens=6, temperature=0.0,
                          dtype="bfloat16")
        assert out.shape == (2, 11) and out.dtype == torch.int64
        assert bool(((out >= 0) & (out < TINY["vocab_size"])).all())

    @pytest.mark.parametrize("kwargs", [
        dict(num_beams=2), dict(cache_dtype="int8"),
        dict(attention_mask=np.ones((2, 5))), dict(tp_mesh=object())],
        ids=["beams", "cache_dtype", "mask", "tp"])
    def test_unported_options_raise(self, kwargs):
        _, tm = _pair(TINY)
        with pytest.raises(NotImplementedError):
            tm.generate(torch.zeros((2, 5), dtype=torch.long),
                        max_new_tokens=2, **kwargs)

    def test_speculative_not_ported(self):
        _, tm = _pair(TINY)
        with pytest.raises(NotImplementedError):
            tm.generate_speculative(tm, torch.zeros((1, 3), dtype=torch.long))


class TestConfigErrors:
    @pytest.mark.parametrize("kwargs", [
        dict(attention_window=0), dict(attention_window=True),
        dict(attention_window=2.5), dict(num_kv_heads=3),
        dict(num_kv_heads=0), dict(num_kv_heads=True)],
        ids=["window0", "window_bool", "window_float", "kv3", "kv0",
             "kv_bool"])
    def test_same_value_errors_as_jax(self, kwargs):
        with pytest.raises(ValueError):
            JConfig(num_heads=4, hidden_size=64, **kwargs)
        with pytest.raises(ValueError):
            GPTConfig(num_heads=4, hidden_size=64, **kwargs)

    @pytest.mark.parametrize("kwargs", [dict(tensor_parallel=True),
                                        dict(num_experts=4),
                                        dict(sequence_parallel=True)],
                             ids=["tp", "moe", "sp"])
    def test_unported_configs_refused(self, kwargs):
        with pytest.raises(ValueError, match="not ported"):
            GPTConfig(**kwargs)

    @pytest.mark.parametrize("attr", ["num_experts", "sequence_parallel",
                                      "tensor_parallel"])
    def test_check_decode_config(self, attr):
        cfg = GPTConfig(**TINY)
        pgpt._check_decode_config(cfg)          # dense: accepted
        setattr(cfg, attr, 2 if attr == "num_experts" else True)
        with pytest.raises(ValueError, match="dense single-replica"):
            pgpt._check_decode_config(cfg)

    def test_decode_setup_errors(self):
        _, tm = _pair(TINY)
        ids = torch.zeros((1, 60), dtype=torch.long)
        with pytest.raises(ValueError, match="max_new_tokens must be"):
            tm.generate(ids, max_new_tokens=0)
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            tm.generate(ids, max_new_tokens=5)
        with pytest.raises(ValueError, match="must be floating"):
            tm.generate(ids, max_new_tokens=1, dtype="int32")


def test_params_from_jax_transposes_linear_weights_only():
    jm = _jax_model(TINY)
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    sd = params_from_jax(named)
    assert set(sd) == set(named)
    for n, a in named.items():
        if n.endswith(("qkv.weight", "proj.weight", "fc1.weight",
                       "fc2.weight")):
            np.testing.assert_array_equal(sd[n].numpy(), a.T)
        else:
            np.testing.assert_array_equal(sd[n].numpy(), a)
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    assert set(tm.state_dict()) == set(sd)


def _jax_golden():
    """The JAX package's outputs for the narrow seq-1024 model."""
    jm = _jax_model(golden.NARROW, params=golden.jax_layout_params())
    ids = golden.input_ids()
    logits = np.asarray(jm(paddle.to_tensor(ids))._data)
    greedy = np.asarray(jm.generate(
        paddle.to_tensor(ids[:, :golden.PROMPT]),
        max_new_tokens=golden.NEW_TOKENS, temperature=0.0)._data)
    return {"logits_rows": logits[0, -golden.LOGIT_ROWS:].astype(np.float32),
            "greedy": greedy.astype(np.int64)}


def test_committed_fixture_matches_jax():
    fix = np.load(golden.FIXTURE)
    want = _jax_golden()
    np.testing.assert_allclose(fix["logits_rows"], want["logits_rows"],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(fix["greedy"], want["greedy"])


def test_port_matches_committed_fixture_on_cpu():
    """The card's phase-3 check, on the CPU (plain versions)."""
    fix = np.load(golden.FIXTURE)
    tm = GPTForCausalLM(GPTConfig(**golden.NARROW), device="cpu")
    tm.load_state_dict(params_from_jax(golden.jax_layout_params()))
    tm.eval()
    ids = torch.from_numpy(golden.input_ids()).long()
    with torch.no_grad():
        rows = tm(ids)[0, -golden.LOGIT_ROWS:].numpy()
    np.testing.assert_allclose(rows, fix["logits_rows"], atol=ATOL, rtol=0)
    got = tm.generate(ids[:, :golden.PROMPT],
                      max_new_tokens=golden.NEW_TOKENS, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), fix["greedy"])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_gpt.py --write-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    golden.FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(golden.FIXTURE, **_jax_golden())
    print(f"wrote {golden.FIXTURE}")
