"""The port's flash-attention backward (paddle_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas `_flash_bwd`, run in
interpret mode on the CPU as tests/test_flash_attention.py runs it.

Inputs come from a numpy seed and go to both packages; at s 384 the
reference's `_block_for` picks 128, so its 3 x 3 block grid exercises the
causal and window skips. Tolerance: atol 2e-5 on dq, dk and dv in fp32 —
the same function, with the Pallas kernels summing block by block and the
port's plain version over whole rows. Tests marked ``cuda`` hold the CUDA
kernels against the plain version on a card, and skip without one.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import flash_attention as jfa

from paddle_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
MODES = [(False, None), (True, None), (True, 100)]
MODE_IDS = ["full", "causal", "window100"]


def _arrays(*shape, n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(n)]


def _fwd_residuals(q, k, v, causal, scale, window):
    """o and lse from the reference's forward, fed to both backwards."""
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, scale, True, window=window)
    return np.array(o), np.array(lse)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_plain_backward_matches_jax(causal, window):
    q, k, v, do = _arrays(2, 384, 64, seed=1)
    scale = 1.0 / math.sqrt(64)
    o, lse = _fwd_residuals(q, k, v, causal, scale, window)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o, lse, do)),
                          causal, scale, True, window=window)
    got = tfa._flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, o, lse,
                                                         do)),
                         causal, scale, window=window)
    _close(got, want)


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_external_delta_matches_jax(causal, window):
    """ring attention hands _flash_bwd its delta (long_context.py): any
    given delta is used as it is, not recomputed from o and dO."""
    q, k, v, do = _arrays(2, 384, 64, seed=2)
    scale = 1.0 / math.sqrt(64)
    o, lse = _fwd_residuals(q, k, v, causal, scale, window)
    delta = (np.random.RandomState(3).randn(2, 384) * 0.1).astype(np.float32)
    want = jfa._flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o, lse, do)),
                          causal, scale, True, delta=jnp.asarray(delta),
                          window=window)
    got = tfa._flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, o, lse,
                                                         do)),
                         causal, scale, delta=torch.from_numpy(delta),
                         window=window)
    _close(got, want)
    # and the default delta is rowsum(dO * o)
    same = tfa._flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, o, lse,
                                                          do)),
                          causal, scale, window=window,
                          delta=torch.from_numpy((do * o).sum(-1)))
    _close(same, tfa._flash_bwd(*(torch.from_numpy(a) for a in (
        q, k, v, o, lse, do)), causal, scale, window=window))


@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_autograd_grads_match_jax_grad(causal, window):
    q, k, v, g = _arrays(1, 384, 2, 64, seed=4)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True,
                                  window=window)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(g)).sum().backward()
    _close((tq.grad, tk.grad, tv.grad), want)


def test_grads_flow_through_strided_views_of_a_packed_qkv():
    """GPT's q, k, v are views of one packed projection: the grads land in
    the packed tensor's three column blocks."""
    (packed,) = _arrays(1, 256, 3 * 2 * 64, n=1, seed=5)
    tp = torch.from_numpy(packed).requires_grad_()
    q, k, v = (t.reshape(1, 256, 2, 64) for t in tp.split(128, dim=-1))
    tfa.flash_attention(q, k, v, causal=True).square().sum().backward()
    ref = torch.from_numpy(packed).requires_grad_()
    rq, rk, rv = (t.reshape(1, 256, 2, 64).contiguous()
                  for t in ref.split(128, dim=-1))
    tfa.flash_attention(rq, rk, rv, causal=True).square().sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), ref.grad.numpy(), atol=1e-6,
                               rtol=0)


def test_backward_validation():
    t = torch.zeros((2, 128, 64))
    lse = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="window requires causal"):
        tfa._flash_bwd(t, t, t, t, lse, t, False, 1.0, window=8)
    x = torch.zeros((1, 1024, 1, 64))
    rows = torch.zeros((1, 1024))
    with pytest.raises(ValueError, match="must lie on"):
        tfa._launch_dq(x, x, x, x, rows, rows, True, 0.125, None)
    with pytest.raises(ValueError, match="must lie on"):
        tfa._launch_dkv(x, x, x, x, rows, rows, True, 0.125, None)


@pytest.mark.parametrize("d", [48, 320])
def test_backward_kernels_raise_for_head_dims_they_cannot_tile(d):
    x = torch.zeros((1, 1024, 1, d))
    rows = torch.zeros((1, 1024))
    with pytest.raises(ValueError, match="head_dim in"):
        tfa._launch_dq(x, x, x, x, rows, rows, True, 0.125, None)
    with pytest.raises(ValueError, match="head_dim in"):
        tfa._launch_dkv(x, x, x, x, rows, rows, True, 0.125, None)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,window", MODES, ids=MODE_IDS)
def test_kernels_under_autograd_match_plain_on_card(cuda, d, dtype, tol,
                                                    causal, window):
    """flash_attention's autograd runs the forward and both backward
    kernels; its grads match autograd through the plain forward."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(2, 1024, 2, d, generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    dname = str(dtype).replace("torch.", "")
    n_dq, n_dkv = (tfa.launches[f"flash_{kind}:{dname}"]
                   for kind in ("dq", "dkv"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert tfa.launches[f"flash_dq:{dname}"] == n_dq + 1
    assert tfa.launches[f"flash_dkv:{dname}"] == n_dkv + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    ro, _ = tfa.flash_attention_ref(*(tfa._heads(t) for t in ref), causal,
                                    1.0 / math.sqrt(d), window)
    want = torch.autograd.grad(tfa._unheads(ro, 2, 2), ref, do)
    for a, b in zip(got, want):
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale
