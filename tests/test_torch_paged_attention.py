"""The port's paged attention (paddle_tpu_torch/ops/tpp.py
``paged_attention`` and ``paged_attention_ref``, the kernel in
ops/csrc/paged_attention.cu) and the int8 row codec
(paddle_tpu_torch/distributed/compress.py) against the JAX package on the
CPU, on the same numpy inputs. The JAX ``paged_attention`` runs its Pallas
kernel in interpret mode, as the JAX package's own tests run it.

Tolerances: 2e-5 (the band the reference holds its kernel to against its
plain version: fp32 summation order); bf16 outputs within one bf16 step
(2^-7 relative) of the JAX plain version; the codec bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.distributed import compress as jcompress
from paddle_tpu.ops import tpp as jtpp

from paddle_tpu_torch.distributed import compress
from paddle_tpu_torch.ops import tpp

TOL = 2e-5


def _case(quantized, seed=0, B=None):
    """tests/test_paging.py's inputs at the reference's audit shape: random
    frames per row (distinct, frame 0 unused), random lengths."""
    B0, H, hd, bs, maxb = jtpp._PAGED_AUDIT_SHAPES[0]
    B = B or B0
    NB = B0 + 3
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    tables = np.zeros((B, maxb), np.int32)
    lengths = rng.randint(1, maxb * bs, (B,)).astype(np.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)
        tables[b, :n] = rng.choice(np.arange(1, NB), n, replace=False)
    if quantized:
        kp = rng.randint(-127, 128, (NB, H, bs, hd)).astype(np.int8)
        vp = rng.randint(-127, 128, (NB, H, bs, hd)).astype(np.int8)
        ks = rng.rand(NB, H, bs, 1).astype(np.float32) * 0.02
        vs = rng.rand(NB, H, bs, 1).astype(np.float32) * 0.02
        return [q, kp, vp, tables, lengths, ks, vs]
    kp = rng.randn(NB, H, bs, hd).astype(np.float32)
    vp = rng.randn(NB, H, bs, hd).astype(np.float32)
    return [q, kp, vp, tables, lengths, None, None]


def _jax(fn, args):
    return np.asarray(fn(*[None if a is None else jnp.asarray(a)
                           for a in args]).astype(jnp.float32))


def _torch(args, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in args]


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX kernel (interpreted) and its plain version, dense and int8."""
    out = {}
    for quantized in (False, True):
        args = _case(quantized)
        out[quantized] = (_jax(jtpp.paged_attention, args),
                          _jax(jtpp.paged_attention_ref, args))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_matches_the_jax_kernel_and_its_reference(jax_outputs, quantized):
    got = tpp.paged_attention(*_torch(_case(quantized)))
    assert got.dtype == torch.float32 and got.shape == (16, 8, 128)
    kernel, ref = jax_outputs[quantized]
    np.testing.assert_allclose(got.numpy(), kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_bf16_q_within_one_bf16_step_of_jax(quantized):
    args = _case(quantized, seed=1, B=4)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = _torch(args)
    jargs[0], targs[0] = jargs[0].astype(jnp.bfloat16), targs[0].bfloat16()
    if not quantized:
        jargs[1:3] = [a.astype(jnp.bfloat16) for a in jargs[1:3]]
        targs[1:3] = [a.bfloat16() for a in targs[1:3]]
    want = np.asarray(jtpp.paged_attention_ref(*jargs).astype(jnp.float32))
    got = tpp.paged_attention(*targs)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), diff.max()


def test_zero_length_row_gives_zeros_and_shared_frames_agree():
    q, kp, vp, tables, lengths, _, _ = _case(False, seed=2, B=4)
    lengths[0] = 0
    tables[0] = 0
    # rows 2 and 3 read the same frames (a shared prefix) to one length
    tables[3], lengths[3] = tables[2], lengths[2]
    q[3] = q[2]
    args = [q, kp, vp, tables, lengths, None, None]
    got = tpp.paged_attention(*_torch(args)).numpy()
    assert (got[0] == 0).all()
    np.testing.assert_array_equal(got[3], got[2])
    np.testing.assert_allclose(got, _jax(jtpp.paged_attention_ref, args),
                               rtol=TOL, atol=TOL)


def test_argument_errors_match_the_reference():
    q, kp, vp, tables, lengths, ks, vs = _torch(_case(True, B=2))
    with pytest.raises(ValueError, match="H == KVh"):
        tpp.paged_attention(q[:, :4], kp, vp, tables, lengths, ks, vs)
    with pytest.raises(ValueError, match="matching head dim"):
        tpp.paged_attention(q[..., :64], kp, vp, tables, lengths, ks, vs)
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        tpp.paged_attention(q, kp, vp, tables, lengths, ks, None)
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        tpp.paged_attention(q, kp, vp, tables, lengths, None, vs)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    q, kp, vp, tables, lengths, ks, vs = _torch(_case(True, B=2))
    launch = tpp._launch_paged_attention
    with pytest.raises(ValueError, match="int8 pages"):
        launch(q, kp.float(), vp.float(), tables, lengths, ks, vs)
    with pytest.raises(ValueError, match="last three dims contiguous"):
        launch(q, kp.transpose(2, 3), vp.transpose(2, 3), tables, lengths,
               ks, vs)
    bad = tables.clone()
    bad[0, 0] = kp.shape[0]
    with pytest.raises(ValueError, match="table entry"):
        launch(q, kp, vp, bad, lengths, ks, vs)
    with pytest.raises(ValueError, match="lie on"):   # a CPU tensor
        launch(q, kp, vp, tables, lengths, ks, vs)
    # one layer of a [NB, L, H, bs, hd] pool goes in as a strided view
    pool = torch.zeros((kp.shape[0], 3) + tuple(kp.shape[1:]),
                       dtype=torch.int8)
    with pytest.raises(ValueError, match="lie on"):
        launch(q, pool[:, 1], pool[:, 1], tables, lengths, ks, vs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal_to_jax(dtype):
    x = np.random.RandomState(3).randn(5, 4, 64).astype(np.float32) * 3
    x[1, 2] = 0.0                                  # a zero row
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jcompress.quantize_rows(jx)
    tq, ts = compress.quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (5, 4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq[1, 2] == 0).all() and ts[1, 2, 0] == 0
    back = compress.dequantize_rows(tq, ts, getattr(torch, dtype))
    jback = jcompress.dequantize_rows(jq, js, jx.dtype)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback.astype(jnp.float32)))
    # the declared band: |err| <= absmax / 254 a row
    band = tx.float().abs().amax(-1, keepdim=True) / 254 + 1e-7
    err = (compress.dequantize_rows(tq, ts) - tx.float()).abs()
    assert (err <= band).all()


def test_non_finite_value_poisons_its_rows_scale():
    x = torch.ones(3, 8)
    x[1, 4] = float("nan")
    x[2, 0] = float("inf")
    q, s = compress.quantize_rows(x)
    assert torch.isfinite(s[0]).all() and not torch.isfinite(s[1:]).any()
    back = compress.dequantize_rows(q, s)
    assert torch.isfinite(back[0]).all()
    assert not torch.isfinite(back[1]).any()


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the paged-attention kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,dtype", [(False, "float32"),
                                             (False, "bfloat16"),
                                             (True, "float32"),
                                             (True, "bfloat16")])
def test_kernel_matches_plain_on_card(cuda, quantized, dtype):
    args = _torch(_case(quantized, seed=5), cuda)
    dt = getattr(torch, dtype)
    args[0] = args[0].to(dt)
    if not quantized:
        args[1:3] = [a.to(dt) for a in args[1:3]]
    args[4][0] = 0
    args[3][0] = 0
    key = f"tpp_paged_attention.{'int8' if quantized else 'dense'}:{dtype}"
    count = tpp.launches[key]
    got = tpp.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpp.launches[key] == count + 1
    want = tpp.paged_attention_ref(*args)
    diff = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert diff.max().item() <= TOL
    else:
        assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
    assert bool((got[0] == 0).all())
