"""Ragged (left-padded) prompts and beam search in the port's
``generate`` (paddle_tpu_torch/models/gpt.py ``_left_pad_mask``,
``_ragged_setup``, ``_gpt_beam_search``) against the JAX package's on
the CPU, on the reference's serving test config (vocab 256, hidden 64, 2
layers, 4 heads, max_seq 128, fp32), the weights carried across with
params_from_jax.

Greedy ragged tokens equal the JAX package's, and each row equals a solo
generate of its unpadded prompt; beam sequences equal the JAX package's
and their scores lie within rtol 1e-5 / atol 1e-5 (fp32 log-probs summed
in two frameworks); the decode math with a key mask and per-row position
ids within 1e-5 of the JAX package's. The JAX runs happen once per module.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    params_from_jax
from paddle_tpu_torch.models import gpt as pgpt

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)
PAD = (0, 3, 9, 5)          # left padding of each row of the ragged batch
S0, NEW = 12, 10
RTOL = ATOL = 1e-5
# beam cases: (num_beams, eos, length_penalty, ragged, cache_dtype, new)
BEAMS = {"eos_lp": (4, 7, 0.7, False, None, 8),
         "masked": (3, None, 1.3, True, None, 8),
         "int8": (2, None, 1.0, True, "int8", 6),
         "one_token": (3, None, 1.0, False, None, 1)}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}))
    return jm, tm.eval()


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (len(PAD), S0)).astype(np.int32)
    mask = np.ones_like(ids)
    for r, n in enumerate(PAD):
        mask[r, :n] = 0
        ids[r, :n] = 0
    return ids, mask


def _jgen(jm, ids, **kw):
    kw = {k: (paddle.to_tensor(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    out = jm.generate(paddle.to_tensor(ids), **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o._data) for o in out)
    return np.asarray(out._data)


def _tgen(tm, ids, **kw):
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    out = tm.generate(torch.from_numpy(ids).long(), **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _beam_kw(name):
    K, eos, lp, ragged, cdt, new = BEAMS[name]
    ids, mask = _batch()
    kw = dict(max_new_tokens=new, num_beams=K, eos_token_id=eos,
              length_penalty=lp, cache_dtype=cdt)
    if ragged:
        kw["attention_mask"] = mask
    return ids, kw


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, _ = models
    ids, mask = _batch()
    out = {"ragged": _jgen(jm, ids, max_new_tokens=NEW, temperature=0.0,
                           attention_mask=mask),
           "ragged_eos": _jgen(jm, ids, max_new_tokens=NEW, temperature=0.0,
                               attention_mask=mask, eos_token_id=11)}
    for name in BEAMS:
        b_ids, kw = _beam_kw(name)
        out[name] = _jgen(jm, b_ids, **kw)
    return out


class TestRagged:
    def test_tokens_equal_jax_and_solo_generate(self, models, jax_runs):
        _, tm = models
        ids, mask = _batch()
        got = _tgen(tm, ids, max_new_tokens=NEW, temperature=0.0,
                    attention_mask=mask)
        np.testing.assert_array_equal(got, jax_runs["ragged"])
        for r, n in enumerate(PAD):
            solo = _tgen(tm, ids[r:r + 1, n:], max_new_tokens=NEW,
                         temperature=0.0)
            np.testing.assert_array_equal(got[r, S0:], solo[0, S0 - n:])

    def test_eos_fills_as_jax(self, models, jax_runs):
        _, tm = models
        ids, mask = _batch()
        got = _tgen(tm, ids, max_new_tokens=NEW, temperature=0.0,
                    attention_mask=mask, eos_token_id=11)
        np.testing.assert_array_equal(got, jax_runs["ragged_eos"])

    def test_all_ones_mask_equals_no_mask(self, models):
        _, tm = models
        ids, _ = _batch()
        a = _tgen(tm, ids, max_new_tokens=NEW, temperature=0.0)
        b = _tgen(tm, ids, max_new_tokens=NEW, temperature=0.0,
                  attention_mask=np.ones_like(ids))
        np.testing.assert_array_equal(a, b)

    def test_bf16_and_sampling_compose(self, models):
        _, tm = models
        ids, mask = _batch()
        for kw in (dict(temperature=0.0, dtype="bfloat16"),
                   dict(temperature=0.9, top_k=20, top_p=0.9, seed=3)):
            out = _tgen(tm, ids, max_new_tokens=NEW, attention_mask=mask,
                        **kw)
            assert out.shape == (len(PAD), S0 + NEW)
            assert ((out >= 0) & (out < 256)).all()
        again = _tgen(tm, ids, max_new_tokens=NEW, attention_mask=mask,
                      temperature=0.9, top_k=20, top_p=0.9, seed=3)
        np.testing.assert_array_equal(out, again)

    @pytest.mark.parametrize("mask, match", [
        (np.ones((3, S0), np.int32), "shape"),
        (np.full((4, S0), 2, np.int32), "binary"),
        (np.array([[1] * 6 + [0] * 6] + [[1] * S0] * 3), "LEFT-padded"),
        (np.array([[0] * S0] + [[1] * S0] * 3), "all-pad")],
        ids=["shape", "binary", "right_padded", "all_pad"])
    def test_bad_masks_raise_as_jax(self, models, mask, match):
        jm, tm = models
        ids, _ = _batch()
        with pytest.raises(ValueError, match=match):
            _jgen(jm, ids, max_new_tokens=2, attention_mask=mask)
        with pytest.raises(ValueError, match=match):
            _tgen(tm, ids, max_new_tokens=2, attention_mask=mask)

    def test_decode_fns_with_key_mask_and_positions_match_jax(self,
                                                              models):
        """One prefill through the decode math with key_valid and pos_ids
        (ragged rows) against the JAX package's _decode_fns."""
        from paddle_tpu.models.gpt import _decode_fns as jdecode_fns
        from paddle_tpu.models.gpt import _ragged_setup as jragged

        jm, tm = models
        ids, mask = _batch()
        T = S0 + 4
        jfwd, jlogits, jinit = jdecode_fns(jm.cfg, False, False)
        jp = {n: p._data for n, p in jm.named_parameters()}
        _, jkv, jpos = jragged(jnp.asarray(mask), len(PAD), S0, T)
        jkc, jvc = jinit(len(PAD), T, jnp.float32)
        jx, jkc, _ = jfwd(jp, jnp.asarray(ids), 0, jkc, jvc, key_valid=jkv,
                          pos_ids=jpos)
        fwd, logits_of, init = pgpt._decode_fns(tm.cfg)
        tp = {n: p.detach() for n, p in tm.named_parameters()}
        tmask = torch.from_numpy(mask).long()
        _, kv, pos = pgpt._ragged_setup(tmask, len(PAD), S0, T)
        kc, vc = init(len(PAD), T, torch.float32, "cpu")
        with torch.no_grad():
            x = fwd(tp, torch.from_numpy(ids).long(), 0, kc, vc,
                    key_valid=kv, pos_ids=pos)
            lg = logits_of(tp, x[:, -1])
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(
            lg.numpy(), np.asarray(jlogits(jp, jx[:, -1])), atol=ATOL,
            rtol=0)


class TestBeamSearch:
    @pytest.mark.parametrize("name", sorted(BEAMS))
    def test_sequences_and_scores_match_jax(self, models, jax_runs, name):
        _, tm = models
        ids, kw = _beam_kw(name)
        seq, score = _tgen(tm, ids, **kw)
        want_seq, want_score = jax_runs[name]
        np.testing.assert_array_equal(seq, want_seq)
        np.testing.assert_allclose(score, want_score, rtol=RTOL, atol=ATOL)

    def test_scores_are_the_sequences_log_probs(self, models):
        """With length_penalty 0 and no eos each score is the joint
        log-prob of its new tokens under the model's own forward."""
        _, tm = models
        ids, _ = _batch()
        seq, score = _tgen(tm, ids, max_new_tokens=5, num_beams=3,
                           length_penalty=0.0)
        with torch.no_grad():
            lp = torch.log_softmax(tm(torch.from_numpy(seq).long()), -1)
        toks = torch.from_numpy(seq[:, S0:]).long()
        want = lp[:, S0 - 1:-1].gather(-1, toks[..., None])[..., 0].sum(-1)
        np.testing.assert_allclose(score, want.numpy(), rtol=RTOL,
                                   atol=1e-4)

    def test_bf16_runs(self, models):
        _, tm = models
        ids, mask = _batch()
        seq, score = _tgen(tm, ids, max_new_tokens=4, num_beams=2,
                           dtype="bfloat16", attention_mask=mask)
        assert seq.shape == (len(PAD), S0 + 4) and np.isfinite(score).all()

    @pytest.mark.parametrize("kwargs, match", [
        (dict(num_beams=2, top_k=3), "sampling knobs"),
        (dict(num_beams=2, top_p=0.5), "sampling knobs"),
        (dict(num_beams=257), "cannot exceed")],
        ids=["top_k", "top_p", "beams_above_vocab"])
    def test_refusals_match_jax(self, models, kwargs, match):
        jm, tm = models
        ids, _ = _batch()
        with pytest.raises(ValueError, match=match):
            _jgen(jm, ids, max_new_tokens=2, **kwargs)
        with pytest.raises(ValueError, match=match):
            _tgen(tm, ids, max_new_tokens=2, **kwargs)

    def test_one_beam_is_refused(self, models):
        _, tm = models
        with pytest.raises(ValueError, match=">= 2"):
            pgpt._gpt_beam_search(tm, torch.zeros((1, 3), dtype=torch.long),
                                  2, 1, None, 1.0)
