"""The port's TPP matmul family (paddle_tpu_torch/ops/tpp.py) against the
JAX package's, whose Pallas kernels run in interpret mode on the CPU
(tpp._on_tpu() is false there).

Inputs come from a numpy seed and go to both packages. Tolerance: atol
1e-5 in fp32 — the same function, the Pallas kernel summing over K
blocks and the plain version in one product; the same for the grads of
the autograd Functions against ``jax.vjp`` of the reference's custom_vjps.
Tests marked ``cuda`` hold the CUDA kernel against the plain version on a
card, and skip without one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTMLP as JMLP
from paddle_tpu.ops import tpp as jtpp

import paddle_tpu_torch as pt
from paddle_tpu_torch.models.gpt import GPTConfig, GPTMLP
from paddle_tpu_torch.ops import tpp

ATOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    f = np.float32
    return {
        "x": rng.randn(24, 32).astype(f),
        "w1": (rng.randn(32, 128) * 0.1).astype(f),
        "b1": (rng.randn(128) * 0.1).astype(f),
        "w2": (rng.randn(128, 32) * 0.1).astype(f),
        "b2": (rng.randn(32) * 0.1).astype(f),
        "gamma": (1.0 + 0.1 * rng.randn(32)).astype(f),
        "beta": (0.1 * rng.randn(32)).astype(f),
        "pre": rng.randn(24, 128).astype(f),
    }


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("in_act", tpp._ACTS)
@pytest.mark.parametrize("act", tpp._ACTS)
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_matmul_every_in_act_and_epilogue(data, in_act, act, with_bias):
    b = data["b1"] if with_bias else None
    want = jtpp.matmul(J(data["x"]), J(data["w1"]),
                       None if b is None else J(b), in_act=in_act, act=act)
    got = tpp.matmul(T(data["x"]), T(data["w1"]),
                     None if b is None else T(b), in_act=in_act, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_matmul_reads_a_linear_weight_through_its_transpose(data):
    lin = T(np.ascontiguousarray(data["w1"].T))       # nn.Linear [out, in]
    got = tpp.matmul(T(data["x"]), lin.t(), T(data["b1"]))
    want = jtpp.matmul(J(data["x"]), J(data["w1"]), J(data["b1"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_ln_matmul_matches_jax(data):
    want = jtpp.ln_matmul(J(data["x"]), J(data["gamma"]), J(data["beta"]),
                          J(data["w1"]), J(data["b1"]))
    got = tpp.ln_matmul(T(data["x"]), T(data["gamma"]), T(data["beta"]),
                        T(data["w1"]), T(data["b1"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
def test_fused_tail_matches_jax(data, approx):
    want = jtpp._fused_tail(J(data["pre"]), J(data["w2"]), J(data["b2"]),
                            approx)
    got = tpp._fused_tail(T(data["pre"]), T(data["w2"]), T(data["b2"]),
                          approx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _mlp_pair(h=32, gelu_approx=False, eps=1e-5, seed=1):
    """The JAX block's ln2 + GPTMLP and the port's, with the same weights."""
    rng = np.random.RandomState(seed)
    cfg = dict(vocab_size=64, hidden_size=h, num_layers=1, num_heads=2,
               max_seq_len=64, dropout=0.0, gelu_approx=gelu_approx)
    jln, jmlp = paddle.nn.LayerNorm(h, epsilon=eps), JMLP(JConfig(**cfg))
    tln, tmlp = torch.nn.LayerNorm(h, eps=eps), GPTMLP(GPTConfig(**cfg))
    for jl, tl in ((jmlp.fc1, tmlp.fc1), (jmlp.fc2, tmlp.fc2)):
        w = (rng.randn(*jl.weight.shape) * 0.1).astype(np.float32)
        bb = (rng.randn(*jl.bias.shape) * 0.1).astype(np.float32)
        jl.weight.set_value(w), jl.bias.set_value(bb)
        tl.weight.data.copy_(T(np.ascontiguousarray(w.T)))
        tl.bias.data.copy_(T(bb))
    g = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    be = (0.1 * rng.randn(h)).astype(np.float32)
    jln.weight.set_value(g), jln.bias.set_value(be)
    tln.weight.data.copy_(T(g)), tln.bias.data.copy_(T(be))
    return (jln, jmlp), (tln, tmlp)


@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
def test_gpt_block_mlp_matches_jax(gelu_approx):
    (jln, jmlp), (tln, tmlp) = _mlp_pair(gelu_approx=gelu_approx)
    x = np.random.RandomState(2).randn(2, 8, 32).astype(np.float32)
    want = jtpp.gpt_block_mlp(J(x), jln, jmlp)
    with torch.no_grad():
        got = tpp.gpt_block_mlp(T(x), tln, tmlp)
    assert got.shape == (2, 8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("rows,eps", [(7, 1e-5), (16, 1e-6)],
                         ids=["untileable_rows", "other_eps"])
def test_gpt_block_mlp_declines_like_jax(rows, eps):
    (jln, jmlp), (tln, tmlp) = _mlp_pair(eps=eps)
    x = np.random.RandomState(3).randn(1, rows, 32).astype(np.float32)
    assert jtpp.gpt_block_mlp(J(x), jln, jmlp) is None
    assert tpp.gpt_block_mlp(T(x), tln, tmlp) is None


@pytest.mark.parametrize("dim", [0, 7, 8, 24, 96, 100, 256, 768, 3072, 4100])
def test_pick_block_matches_reference(dim):
    assert tpp.pick_block(dim) == jtpp.pick_block(dim)


@pytest.mark.parametrize("m,k,n", [(24, 32, 128), (4096, 768, 3072),
                                   (7, 32, 128), (24, 33, 128), (24, 32, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_tiling_gates_match_reference(m, k, n, dtype):
    assert tpp.supported_2d(m, k, n, dtype) == \
        jtpp.supported_2d(m, k, n, dtype)
    assert tpp.ln_matmul_supported(m, k, n, dtype) == \
        jtpp.ln_matmul_supported(m, k, n, dtype)
    tdt = getattr(torch, dtype)
    assert tpp.supported_2d(m, k, n, tdt) == jtpp.supported_2d(m, k, n,
                                                               dtype)


@pytest.mark.parametrize("act", tpp._ACTS)
def test_apply_act_matches_reference(act):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(tpp._apply_act(T(x), act).numpy(),
                               np.asarray(jtpp._apply_act(J(x), act)),
                               atol=1e-6, rtol=0)


def test_errors_match_reference(data):
    for mod, arr in ((jtpp, J), (tpp, T)):
        with pytest.raises(ValueError, match="act must be one of"):
            mod.matmul(arr(data["x"]), arr(data["w1"]), act="silu")
        with pytest.raises(ValueError, match="cannot tile"):
            mod.matmul(arr(data["x"][:7]), arr(data["w1"]))


def test_row_stats_plain_version_is_the_ln_statistics(data):
    """The LN pre-pass's plain version: each row's mean and 1/sqrt(var +
    1e-5), the statistics _matmul_ref normalises by; a CPU tensor takes
    it and launches nothing."""
    x = data["x"].astype(np.float64)
    mu = x.mean(-1)
    rstd = 1.0 / np.sqrt(((x - mu[:, None]) ** 2).mean(-1) + 1e-5)
    tpp.launches.clear()
    got = tpp._row_stats(T(data["x"]))
    assert got.shape == (2, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.stack([mu, rstd]), atol=1e-6,
                               rtol=1e-6)
    assert sum(tpp.launches.values()) == 0


def test_cpu_tensors_take_the_plain_version(data):
    tpp.launches.clear()
    tpp.routes.clear()
    tpp.ln_matmul(T(data["x"]), T(data["gamma"]), T(data["beta"]),
                  T(data["w1"]), T(data["b1"]))
    tpp.matmul(T(data["x"]), T(data["w1"]), in_act="gelu")
    assert sum(tpp.launches.values()) == 0
    assert sum(tpp.routes.values()) == 0
    with pytest.raises(ValueError, match="must lie on"):
        tpp._launch(T(data["x"]), T(data["w1"]), None, "none", "none")


def _grads_both(jfn, tfn, arrays, g):
    """(port grads, reference grads) of fn(*arrays) against cotangent g:
    torch autograd through the port's Function, jax.vjp of the
    reference's custom_vjp."""
    _, vjp = jax.vjp(jfn, *(J(a) for a in arrays))
    want = vjp(J(g))
    leaves = [T(a).clone().requires_grad_() for a in arrays]
    got = torch.autograd.grad(tfn(*leaves), leaves, T(g))
    return got, want


def _assert_grads(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_ln_matmul_grads_match_jax_vjp(data):
    g = np.random.RandomState(4).randn(24, 128).astype(np.float32)
    arrays = [data[k] for k in ("x", "gamma", "beta", "w1", "b1")]
    _assert_grads(*_grads_both(jtpp.ln_matmul, tpp.ln_matmul, arrays, g))


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
def test_fused_tail_grads_match_jax_vjp(data, approx):
    g = np.random.RandomState(5).randn(24, 32).astype(np.float32)
    arrays = [data[k] for k in ("pre", "w2", "b2")]
    _assert_grads(*_grads_both(
        lambda *a: jtpp._fused_tail(*a, approx),
        lambda *a: tpp._fused_tail(*a, approx), arrays, g))


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
def test_fused_mlp_and_its_grads_match_jax(data, approx):
    arrays = [data[k] for k in ("x", "w1", "b1", "w2", "b2")]
    want = jtpp.fused_mlp(*(J(a) for a in arrays), approx)
    got = tpp.fused_mlp(*(T(a) for a in arrays), approx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    g = np.random.RandomState(6).randn(24, 32).astype(np.float32)
    _assert_grads(*_grads_both(
        lambda *a: jtpp.fused_mlp(*a, approx),
        lambda *a: tpp.fused_mlp(*a, approx), arrays, g))


@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
def test_gpt_block_mlp_grads_match_jax_vjp(gelu_approx):
    """The hook's grads (x, the LayerNorm's and both Linears' parameters)
    against jax.vjp of the reference hook's two ops."""
    (jln, jmlp), (tln, tmlp) = _mlp_pair(gelu_approx=gelu_approx)
    x = np.random.RandomState(7).randn(2, 8, 32).astype(np.float32)
    g = np.random.RandomState(8).randn(2, 8, 32).astype(np.float32)
    jparams = [np.asarray(p._data) for p in (
        jln.weight, jln.bias, jmlp.fc1.weight, jmlp.fc1.bias,
        jmlp.fc2.weight, jmlp.fc2.bias)]

    def jhook(x_, gm, bt, w1, b1, w2, b2):
        pre = jtpp.ln_matmul(x_.reshape(16, 32), gm, bt, w1, b1)
        return jtpp._fused_tail(pre, w2, b2, gelu_approx).reshape(2, 8, 32)

    _, vjp = jax.vjp(jhook, J(x), *(J(a) for a in jparams))
    want = vjp(J(g))
    tx = T(x).clone().requires_grad_()
    out = tpp.gpt_block_mlp(tx, tln, tmlp)
    tparams = [tln.weight, tln.bias, tmlp.fc1.weight, tmlp.fc1.bias,
               tmlp.fc2.weight, tmlp.fc2.bias]
    got = list(torch.autograd.grad(out, [tx] + tparams, T(g)))
    got[3], got[5] = got[3].t(), got[5].t()     # nn.Linear [out, in]
    _assert_grads(got, want)


def test_backward_runs_in_fp32_under_auto_cast(data):
    """The Functions' plain backward runs with autocast off: under a bf16
    auto_cast the fp32 grads are bit-identical to those without it."""
    def grads():
        leaves = [T(data[k]).clone().requires_grad_()
                  for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2")]
        x, gm, bt, w1, b1, w2, b2 = leaves
        out = tpp._fused_tail(tpp.ln_matmul(x, gm, bt, w1, b1), w2, b2,
                              False)
        return out, torch.autograd.grad(out.square().sum(), leaves)

    plain_out, plain = grads()
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        amp_out, amp = grads()
    assert amp_out.dtype == torch.float32
    assert torch.equal(amp_out, plain_out)
    for a, b in zip(amp, plain):
        assert a.dtype == torch.float32 and torch.equal(a, b)


# ---- the row primitives ----------------------------------------------------

#: fp32: the same function, sums taken in another order and erf/tanh/exp
#: rounding their last bit differently; bf16 outputs may also land one bf16
#: step (2^-8 relative) apart from such a difference
ROW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ROW_DTYPES = ["float32", "bfloat16"]


def _rows(m=48, n=96, seed=9):
    rng = np.random.RandomState(seed)
    return rng.randn(m, n).astype(np.float32), \
        rng.randn(n).astype(np.float32), rng.rand(m, n) > 0.4


def _assert_rows(got, want, dname):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ROW_TOL[dname]
                               * max(1.0, float(np.abs(want[np.isfinite(
                                   want)]).max())), rtol=0)


@pytest.mark.parametrize("dname", ROW_DTYPES)
@pytest.mark.parametrize("act", tpp._ACTS)
def test_bias_act_matches_jax(act, dname):
    x, b, _ = _rows()
    want = jtpp.bias_act(jnp.asarray(x, dname), J(b), act)
    got = tpp.bias_act(T(x).to(getattr(torch, dname)), T(b), act)
    assert got.dtype == getattr(torch, dname)
    _assert_rows(got, want, dname)


@pytest.mark.parametrize("dname", ROW_DTYPES)
def test_softmax_rows_matches_jax(dname):
    x, _, _ = _rows()
    x[5] *= 40.0                               # a row the max must steady
    want = jtpp.softmax_rows(jnp.asarray(x, dname))
    got = tpp.softmax_rows(T(x).to(getattr(torch, dname)))
    assert got.dtype == getattr(torch, dname)
    _assert_rows(got, want, dname)


@pytest.mark.parametrize("dname", ROW_DTYPES)
@pytest.mark.parametrize("kind", ["sum", "max"])
def test_masked_reduce_matches_jax(kind, dname):
    x, _, mask = _rows()
    mask[7] = False                            # a row with nothing kept
    want = jtpp.masked_reduce(jnp.asarray(x, dname), J(mask), kind)
    got = tpp.masked_reduce(T(x).to(getattr(torch, dname)), T(mask), kind)
    assert got.shape == (48, 1) and got.dtype == getattr(torch, dname)
    _assert_rows(got, want, dname)
    assert got[7, 0].item() == (0.0 if kind == "sum" else float("-inf"))
    assert np.asarray(want, np.float32)[7, 0] == got[7, 0].item()


def test_masked_reduce_takes_the_mask_as_int32():
    """A float mask is cast to int32 first, as the reference casts it:
    0.5 drops its column, -1.0 and 2.0 keep theirs."""
    x = np.arange(8, dtype=np.float32).reshape(1, 8) + 1.0
    x = np.repeat(x, 8, 0)
    mask = np.tile(np.array([0.5, -1.0, 2.0, 0.0, 1.0, 0.9, 0.0, 3.0],
                            np.float32), (8, 1))
    want = jtpp.masked_reduce(J(x), J(mask), "sum")
    got = tpp.masked_reduce(T(x), T(mask), "sum")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0].item() == 2.0 + 3.0 + 5.0 + 8.0


@pytest.mark.parametrize("call", [
    lambda m: m.bias_act(m_x(7, 16), m_b(16)),
    lambda m: m.bias_act(m_x(16, 12), m_b(12)),
    lambda m: m.softmax_rows(m_x(9, 16)),
    lambda m: m.masked_reduce(m_x(10, 16), m_x(10, 16))],
    ids=["bias_act_rows", "bias_act_cols", "softmax_rows", "masked_reduce"])
def test_row_primitives_refuse_untileable_shapes_like_jax(call):
    for mod in (jtpp, tpp):
        with pytest.raises(ValueError, match="cannot tile"):
            call(mod)


def m_x(m, n):
    return np.zeros((m, n), np.float32)


def m_b(n):
    return np.zeros((n,), np.float32)


def test_row_primitive_argument_errors_match_jax():
    x, b, mask = _rows()
    for mod, arr in ((jtpp, J), (tpp, T)):
        with pytest.raises(ValueError, match="act must be one of"):
            mod.bias_act(arr(x), arr(b), act="silu")
        with pytest.raises(ValueError, match="kind must be sum"):
            mod.masked_reduce(arr(x), arr(mask), kind="mean")


def test_row_primitives_on_cpu_launch_nothing():
    x, b, mask = _rows()
    tpp.launches.clear()
    tpp.bias_act(T(x), T(b))
    tpp.softmax_rows(T(x))
    tpp.masked_reduce(T(x), T(mask), "max")
    assert sum(tpp.launches.values()) == 0
    with pytest.raises(ValueError, match="must be contiguous and lie on"):
        tpp._launch_softmax_rows(T(x))


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the TPP kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", ["plain", "ln", "gelu_in"])
def test_kernel_matches_plain_on_card(cuda, dtype, tol, variant):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * std).to(dtype)

    k, n = (3072, 768) if variant == "gelu_in" else (768, 3072)
    x, w, b = rn(4096, k), rn(n, k, std=0.02).t(), rn(n, std=0.02)
    gamma, beta = 1.0 + rn(k, std=0.1), rn(k, std=0.1)
    tpp.routes.clear()
    if variant == "ln":
        got = tpp.ln_matmul(x, gamma, beta, w, b)
        want = tpp._matmul_ref(x, w, b, gamma=gamma, beta=beta)
    elif variant == "gelu_in":
        got = tpp._fused_tail(x, w, b, False)
        want = tpp._matmul_ref(x, w, b, "gelu")
    else:
        got, want = tpp.matmul(x, w, b), tpp._matmul_ref(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item())
    # the GPT MLP's shapes: bf16 on the tensor cores, fp32 on the CUDA cores
    dname = tpp._dtype_name(dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    key = "ln" if variant == "ln" else \
        "in_act" if variant == "gelu_in" else "plain"
    assert dict(tpp.routes) == {f"tpp_matmul.{key}:{dname}:{route}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["linear_t", "k_n"])
@pytest.mark.parametrize("m,k,n", [(200, 100, 264), (200, 776, 1000)],
                         ids=["k_not_8", "k_8"])
def test_tile_edges_on_card(cuda, dtype, tol, layout, m, k, n):
    """The new tiles' edges through the public ops: M (200) not a multiple
    of the 128-row tile, N (264, 1000) not one of any column tile, K a
    multiple of 8 (TMA in bf16) or not (100: the CUDA-core path), w an
    nn.Linear weight seen through .t() or a [k, n] array."""
    g = torch.Generator(device=cuda).manual_seed(3)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * std).to(dtype)

    x, lin, b = rn(m, k), rn(n, k, std=0.05), rn(n, std=0.05)
    w = lin.t() if layout == "linear_t" else lin.t().contiguous()
    gamma, beta = 1.0 + rn(k, std=0.1), rn(k, std=0.1)
    dname = tpp._dtype_name(dtype)
    n_ln = tpp.launches[f"tpp_matmul.ln:{dname}"]
    tpp.routes.clear()
    with torch.no_grad():
        # ln_matmul does not gate K; matmul's registry gate refuses K 100,
        # so that case goes to the launcher itself
        got = [tpp.ln_matmul(x, gamma, beta, w, b),
               tpp.matmul(x, w, b, in_act="gelu", act="relu") if k % 8 == 0
               else tpp._launch(x, w, b, "gelu", "relu")]
    want = [tpp._matmul_ref(x, w, b, gamma=gamma, beta=beta),
            tpp._matmul_ref(x, w, b, "gelu", "relu")]
    torch.cuda.synchronize()
    assert tpp.launches[f"tpp_matmul.ln:{dname}"] == n_ln + 1
    # bf16 takes the tensor cores wherever TMA can read K; fp32, and bf16
    # at K 100, the CUDA cores
    route = "wgmma" if dtype == torch.bfloat16 and k % 8 == 0 else "simt"
    assert dict(tpp.routes) == {f"tpp_matmul.ln:{dname}:{route}": 1,
                                f"tpp_matmul.in_act:{dname}:{route}": 1}
    for a, ref in zip(got, want):
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= tol * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
def test_matmul_refuses_grad_on_card(cuda):
    """tpp.matmul has no backward (as in the reference); the ops the GPT
    hook uses do."""
    x = torch.randn(64, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        tpp.matmul(x, torch.randn(64, 64, device=cuda))


@pytest.mark.cuda
def test_functions_launch_the_kernel_and_match_plain_grads_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    x, gm, bt = rn(512, 256), 1.0 + rn(256, std=0.1), rn(256, std=0.1)
    w1, b1 = rn(256, 1024, std=0.05), rn(1024, std=0.05)
    w2, b2 = rn(1024, 256, std=0.05), rn(256, std=0.05)
    leaves = [t.requires_grad_() for t in (x, gm, bt, w1, b1, w2, b2)]
    n = dict(tpp.launches)
    out = tpp._fused_tail(tpp.ln_matmul(*leaves[:5]), *leaves[5:], False)
    got = torch.autograd.grad(out.square().sum(), leaves)
    torch.cuda.synchronize()
    assert tpp.launches["tpp_matmul.ln:float32"] == \
        n.get("tpp_matmul.ln:float32", 0) + 1
    assert tpp.launches["tpp_matmul.in_act:float32"] == \
        n.get("tpp_matmul.in_act:float32", 0) + 1
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    x_, gm_, bt_, w1_, b1_, w2_, b2_ = ref
    pre = tpp._matmul_ref(x_, w1_, b1_, gamma=gm_, beta=bt_)
    want = torch.autograd.grad(
        tpp._matmul_ref(pre, w2_, b2_, "gelu").square().sum(), ref)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= \
            1e-3 * max(1.0, b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 3072), (48, 96), (40, 100),
                                   (37, 1024), (21, 2048)],
                         ids=["wide", "narrow", "unvectorised", "rows1024",
                              "rows2048"])
def test_row_kernels_match_plain_on_card(cuda, dtype, shape):
    """Each row kernel against its plain version, with the launch counted;
    n = 100 is not a multiple of the bias_act vector in bf16, so it takes
    the scalar path (the registry gate is bypassed through the launchers).
    softmax_rows takes its register route where n is a multiple of the
    16-byte vector and at most 2,048 (one warp a row, or two or four at
    n 1,024 and 2,048 in fp32 and 2,048 in bf16; 37 and 21 rows fill no
    whole number of blocks), else the block route (n 3,072; n 100 in
    bf16), counted by route; a row holding +inf gives the plain
    version's NaN row on either, and rows whose max is near the type's
    largest finite value (+3e38, and below -2.4e38 throughout) its finite
    rows."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(shape[1], generator=g, device=cuda)
    mask = torch.rand(*shape, generator=g, device=cuda) > 0.3
    mask[3] = False
    dname = tpp._dtype_name(dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    vec = 4 if dtype == torch.float32 else 8
    route = "register" if shape[1] % vec == 0 and shape[1] <= 2048 \
        else "block"
    key = f"tpp_softmax_rows:{dname}:{route}"
    n_route = tpp.routes[key]
    checks = [(tpp._launch_bias_act(x, b, act), tpp._bias_act_ref(x, b, act),
               f"tpp_bias_act:{act}:{dname}") for act in tpp._ACTS]
    x_inf = x.clone()
    x_inf[1, 5] = float("inf")
    x_big = x.clone()
    x_big[2] = (x[2].float() * 1e37).to(dtype)
    x_big[2, 7] = 3e38
    x_big[4] = (x[4].float() * 1e37 - 2.8e38).to(dtype)
    for xs in (x, x_inf, x_big):
        checks.append((tpp._launch_softmax_rows(xs),
                       tpp._softmax_rows_ref(xs),
                       f"tpp_softmax_rows:{dname}"))
    assert tpp.routes[key] == n_route + 3
    for kind in ("sum", "max"):
        for m in (mask, mask.to(torch.int32), mask.float() * 1.7):
            checks.append((tpp._launch_masked_reduce(x, m, kind),
                           tpp._masked_reduce_ref(x, m, kind),
                           f"tpp_masked_reduce:{kind}:{dname}"))
    torch.cuda.synchronize()
    for got, want, key in checks:
        assert tpp.launches[key] > 0
        assert got.dtype == want.dtype and got.shape == want.shape
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got)), key
        err = (got.float() - want.float())[fin].abs().max().item() \
            if fin.any() else 0.0
        assert err <= tol * max(1.0, want.float()[fin].abs().max().item()
                                if fin.any() else 1.0), (key, err)


# ---- the bf16 tensor-core kernel's rounding ---------------------------------

#: chip_smoke.py's band for a bf16 kernel against its fp32-math plain
#: version, scaled by max(1, max|plain|) (TPP_TOL["bfloat16"] there)
BF16_TOL = 2e-2


def _tensor_core_rounding(x, w, bias, in_act, gamma=None, beta=None):
    """Where the bf16 tensor-core kernel rounds, in plain torch: the x tile
    after the LN (fp32 row statistics) and the input activation, both in
    fp32, is rounded to bf16 before an fp32-accumulated product; bias in
    fp32; the output rounded to bf16."""
    xf = x.float()
    if gamma is not None:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) * (xf - mu)).mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + tpp._LN_EPS) * gamma.float() \
            + beta.float()
    a = tpp._apply_act(xf, in_act).to(torch.bfloat16).float()
    return (a @ w.float() + bias.float()).to(torch.bfloat16)


@pytest.mark.parametrize("variant", ["ln", "gelu_in"])
def test_bf16_tensor_core_rounding_within_band_of_plain(variant):
    """At GPT-2 small's MLP widths (LN + fc1: K 768, N 3072; gelu + fc2:
    K 3072, N 768), 192 rows: rounding the transformed x tile to bf16, as
    the wgmma kernel must, stays within the bf16 band of the fp32-math
    plain version; and on the same inputs the plain version matches the
    JAX package."""
    rng = np.random.RandomState(12)
    k, n = (768, 3072) if variant == "ln" else (3072, 768)
    f = np.float32
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)   # noqa: E731
    x = bf(rng.randn(192, k).astype(f))
    w = bf((rng.randn(k, n) * 0.02).astype(f))
    b = bf((rng.randn(n) * 0.02).astype(f))
    gamma = bf((1.0 + 0.1 * rng.randn(k)).astype(f))
    beta = bf((0.1 * rng.randn(k)).astype(f))
    if variant == "ln":
        plain = tpp._matmul_ref(x, w, b, gamma=gamma, beta=beta)
        rounded = _tensor_core_rounding(x, w, b, "none", gamma, beta)
    else:
        plain = tpp._matmul_ref(x, w, b, "gelu")
        rounded = _tensor_core_rounding(x, w, b, "gelu")
    err = (rounded.float() - plain.float()).abs().max().item()
    assert err <= BF16_TOL * max(1.0, plain.float().abs().max().item())

    # the plain version against the JAX package, fp32 on the same values
    xs, ws, bs, gs, bts = (t.float() for t in (x, w, b, gamma, beta))
    if variant == "ln":
        got = tpp.ln_matmul(xs, gs, bts, ws, bs)
        want = jtpp.ln_matmul(*(J(t.numpy()) for t in (xs, gs, bts, ws, bs)))
    else:
        got = tpp._fused_tail(xs, ws, bs, False)
        want = jtpp._fused_tail(J(xs.numpy()), J(ws.numpy()), J(bs.numpy()),
                                False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
