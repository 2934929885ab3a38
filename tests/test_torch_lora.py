"""LoRA in the port (paddle_tpu_torch/incubate/lora.py, and the gpt decode
model's multi-LoRA factors in paddle_tpu_torch/models/gpt.py) against the
JAX package's (paddle_tpu/incubate/lora.py, paddle_tpu/models/gpt.py) on
the CPU: the same base weights (params_from_jax) and the same A / B
factors (numpy, from a seed) on both sides, fp32.

Forwards of a LoRALinear and of an adapted GPT within atol 1e-5 of the
JAX package's (two frameworks: summation order only); ``export_lora`` and
``lora_pack`` equal in keys, shapes and values; merged models within
1e-5 of the JAX package's merged model and of the un-merged one; the
decode math with per-row adapter factors within 1e-5 of the JAX
package's; the refusals the reference's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.incubate import lora as jlora
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import GPTDecodeModel as JDecodeModel
from paddle_tpu.nn import Linear as JLinear

from paddle_tpu_torch.incubate import lora
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.nn import Linear

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
TARGETS = ["attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"]
ATOL = 1e-5


def _gpt_pair(seed=0):
    paddle.seed(seed)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}))
    return jm, tm.eval()


def _set_factors(jm, tm, seed, std=0.05):
    """The same random A and B on both sides (B non-zero)."""
    rng = np.random.RandomState(seed)
    tnamed = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        if "lora_" in n:
            v = rng.normal(0, std, p.shape).astype(np.float32)
            p.set_value(paddle.to_tensor(v))
            with torch.no_grad():
                tnamed[n].copy_(torch.from_numpy(v))


def _adapted(targets=TARGETS, seed=1):
    jm, tm = _gpt_pair()
    jn = jlora.apply_lora(jm, r=4, alpha=8, target_modules=targets)
    tn = lora.apply_lora(tm, r=4, alpha=8, target_modules=targets)
    _set_factors(jm, tm, seed)
    return jm, tm, jn, tn


def _ids():
    return np.random.RandomState(0).randint(0, 256, (2, 9)).astype(np.int32)


def _logits(jm, tm):
    with torch.no_grad():
        got = tm(torch.from_numpy(_ids()).long()).numpy()
    return got, np.asarray(jm(paddle.to_tensor(_ids()))._data)


@pytest.fixture(scope="module")
def adapted():
    return _adapted()


class TestLayers:
    def test_lora_linear_forward_matches_jax(self):
        paddle.seed(0)
        jl = JLinear(16, 12)
        tl = Linear(16, 12)
        with torch.no_grad():
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data).T))
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias._data)))
        jw, tw = jlora.LoRALinear(jl, r=4, alpha=8), \
            lora.LoRALinear(tl, r=4, alpha=8)
        rng = np.random.RandomState(0)
        for name in ("lora_A", "lora_B"):
            v = rng.normal(0, 0.3, getattr(jw, name).shape).astype(
                np.float32)
            getattr(jw, name).set_value(paddle.to_tensor(v))
            with torch.no_grad():
                getattr(tw, name).copy_(torch.from_numpy(v))
        x = rng.randn(3, 5, 16).astype(np.float32)
        want = np.asarray(jw(paddle.to_tensor(x))._data)
        with torch.no_grad():
            got = tw(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert tw.lora_A.shape == (16, 4) and tw.lora_B.shape == (4, 12)
        assert tw.scaling == jw.scaling == 2.0

    def test_initial_factors_follow_the_generator(self):
        a, b = (lora.LoRALinear(Linear(8, 6), r=2,
                                generator=torch.Generator().manual_seed(5))
                for _ in range(2))
        assert torch.equal(a.lora_A, b.lora_A)
        assert not a.lora_B.any() and abs(a.lora_A.std().item() - 0.02) < .02

    def test_apply_lora_forward_matches_jax(self, adapted):
        jm, tm, jn, tn = adapted
        assert tn == jn
        got, want = _logits(jm, tm)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    def test_trainable_set_is_the_references(self, adapted):
        jm, tm, _, _ = adapted
        want = {n: p.trainable for n, p in jm.named_parameters()}
        assert {n: p.requires_grad for n, p in tm.named_parameters()} == want
        assert [n for n, _ in tm.named_parameters() if "lora_" in n] == \
            [n for n, _ in jm.named_parameters() if "lora_" in n]
        assert len(lora.lora_parameters(tm)) == 16
        assert sorted(lora.lora_state_dict(tm)) == \
            sorted(jlora.lora_state_dict(jm))

    def test_export_lora_equals_jax(self, adapted):
        jm, tm, _, _ = adapted
        want, got = jlora.export_lora(jm), lora.export_lora(tm)
        assert (got["rank"], got["scaling"]) == (want["rank"],
                                                want["scaling"])
        assert sorted(got["factors"]) == sorted(want["factors"])
        for qual, fac in want["factors"].items():
            for side in ("A", "B"):
                np.testing.assert_array_equal(got["factors"][qual][side],
                                              np.asarray(fac[side]))

    def test_lora_pack_equals_jax(self, adapted):
        jm, tm, _, _ = adapted
        exported = lora.export_lora(tm)
        want = JDecodeModel().lora_pack(jm.cfg, exported, 8)
        got = pgpt.GPTDecodeModel().lora_pack(tm.cfg, exported, 8)
        assert got["scale"] == want["scale"]
        for kind in ("qkv", "proj", "fc1", "fc2"):
            for side in ("A", "B"):
                np.testing.assert_array_equal(got[kind][side],
                                              want[kind][side])

    def test_merge_matches_jax_and_the_unmerged_model(self):
        jm, tm, _, _ = _adapted(targets=["attn.qkv", "mlp.fc2"], seed=2)
        before, _ = _logits(jm, tm)
        assert lora.merge_lora(tm) == jlora.merge_lora(jm) == 4
        got, want = _logits(jm, tm)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, before, atol=ATOL, rtol=0)
        assert all(p.requires_grad for p in tm.parameters())
        assert not any("lora_" in n for n, _ in tm.named_parameters())
        # merged: generate reads the folded weights
        out = tm.generate(torch.from_numpy(_ids()).long(), max_new_tokens=3,
                          temperature=0.0)
        want = np.asarray(jm.generate(paddle.to_tensor(_ids()),
                                      max_new_tokens=3,
                                      temperature=0.0)._data)
        np.testing.assert_array_equal(out.numpy(), want)

    def test_decode_fns_with_adapters_match_jax(self, adapted):
        """One prefill through the decode math, row 0 on the base (slot
        0) and row 1 on the adapter (slot 1), against the JAX package's."""
        from paddle_tpu.models.gpt import _decode_fns as jdecode_fns

        jm, tm, _, _ = adapted
        exported = lora.export_lora(tm)
        jbase, tbase = _gpt_pair()
        jdm, tdm = JDecodeModel(), pgpt.GPTDecodeModel()
        jpack = jdm.lora_init(jm.cfg, 2, 4)
        slot = jdm.lora_pack(jm.cfg, exported, 4)
        jpack["scale"] = jpack["scale"].at[1].set(slot["scale"])
        for kind in ("qkv", "proj", "fc1", "fc2"):
            for side in ("A", "B"):
                jpack[kind][side] = jpack[kind][side].at[1].set(
                    jnp.asarray(slot[kind][side]))
        tpack = tdm.lora_init(tm.cfg, 2, 4, device="cpu")
        tpack["scale"][1] = slot["scale"]
        for kind in ("qkv", "proj", "fc1", "fc2"):
            for side in ("A", "B"):
                tpack[kind][side][1] = torch.from_numpy(slot[kind][side])
        ids, aids = _ids(), np.array([0, 1], np.int32)
        jfwd, jlogits, jinit = jdecode_fns(jbase.cfg, False, False)
        jp = {n: p._data for n, p in jbase.named_parameters()}
        jkc, jvc = jinit(2, 16, jnp.float32)
        jx, jkc, _ = jfwd(jp, jnp.asarray(ids), 0, jkc, jvc, lora=jpack,
                          adapter_ids=jnp.asarray(aids))
        fwd, logits_of, init = pgpt._decode_fns(tbase.cfg)
        tp = {n: p.detach() for n, p in tbase.named_parameters()}
        kc, vc = init(2, 16, torch.float32, "cpu")
        with torch.no_grad():
            x = fwd(tp, torch.from_numpy(ids).long(), 0, kc, vc, lora=tpack,
                    adapter_ids=torch.from_numpy(aids).long())
            base = fwd(tp, torch.from_numpy(ids).long(), 0,
                       *init(2, 16, torch.float32, "cpu"))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), atol=ATOL,
                                   rtol=0)
        # slot 0 adds an exact zero: the base row's bits are the plain
        # math's; the adapted row differs
        assert torch.equal(x[0], base[0]) and not torch.equal(x[1], base[1])
        # and the adapter row is the adapted (un-merged) model's forward
        with torch.no_grad():
            full = tm.gpt(torch.from_numpy(ids[1:]).long())
        np.testing.assert_allclose(
            logits_of(tp, x[1:]).numpy(),
            (full @ tm.gpt.wte.weight.t()).numpy(), atol=1e-4, rtol=0)


class TestRefusals:
    def test_double_wrap_finds_no_site(self, adapted):
        jm, tm, _, _ = adapted
        with pytest.raises(ValueError, match="no nn.Linear"):
            jlora.apply_lora(jm, r=4, target_modules=["attn.qkv"])
        with pytest.raises(ValueError, match="no nn.Linear"):
            lora.apply_lora(tm, r=4, target_modules=["attn.qkv"])

    def test_a_shared_linear_gets_one_adapter(self):
        class Two(torch.nn.Module):
            def __init__(self, lin):
                super().__init__()
                self.a = torch.nn.Sequential(lin)
                self.b = torch.nn.Sequential(lin)

        from paddle_tpu.nn import Layer, Sequential as JSeq

        class JTwo(Layer):
            def __init__(self, lin):
                super().__init__()
                self.a = JSeq(lin)
                self.b = JSeq(lin)

        t, j = Two(Linear(4, 4)), JTwo(JLinear(4, 4))
        assert lora.apply_lora(t, r=2) == jlora.apply_lora(j, r=2) == \
            ["a.0", "b.0"]
        assert t.a[0] is t.b[0]
        assert len(lora.lora_parameters(t)) == len(
            jlora.lora_parameters(j)) == 2
        assert lora.merge_lora(t) == jlora.merge_lora(j) == 1

    def test_generate_refuses_unmerged_adapters(self, adapted):
        jm, tm, _, _ = adapted
        with pytest.raises(ValueError, match="un-merged"):
            jm.generate(paddle.to_tensor(_ids()), max_new_tokens=2)
        with pytest.raises(ValueError, match="un-merged"):
            tm.generate(torch.from_numpy(_ids()).long(), max_new_tokens=2)

    def test_wrapping_and_export_errors(self):
        with pytest.raises(TypeError, match="nn.Linear"):
            lora.LoRALinear(torch.nn.Conv1d(2, 2, 1))
        with pytest.raises(ValueError, match="rank"):
            lora.LoRALinear(Linear(4, 4), r=0)
        _, tm = _gpt_pair()
        with pytest.raises(ValueError, match="no LoRALinear"):
            lora.export_lora(tm)
        lora.apply_lora(tm, r=4, target_modules=["attn.qkv"])
        lora.apply_lora(tm, r=2, target_modules=["mlp.fc1"])
        with pytest.raises(ValueError, match="uniform rank"):
            lora.export_lora(tm)
        exported = {"rank": 2, "scaling": 1.0,
                    "factors": {"gpt.wte": {"A": np.zeros((4, 2)),
                                            "B": np.zeros((2, 4))}}}
        with pytest.raises(ValueError, match="injection point"):
            pgpt.GPTDecodeModel().lora_pack(tm.cfg, exported, 4)
