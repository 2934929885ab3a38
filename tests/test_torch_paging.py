"""The port's paged KV pool (paddle_tpu_torch/serving/paging.py) against
the JAX package's (paddle_tpu/serving/paging.py), driven through the same
operations on the CPU: the cases of tests/test_paging.py's TestPagePool.
Tables, refcounts, free lists and stats must be equal after every
operation; pool contents, gathers and scatters equal exactly (the same
numpy rows go into both); cold pages within the row codec's band
(absmax / 254 a row), and equal to the JAX package's bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.serving import paging as jpaging

from paddle_tpu_torch.serving import paging

DIMS = (2, 2, 8)                    # L, KVh, hd


def _pools(n_blocks=8, bs=4, cold_after=None, max_seq=16):
    j = jpaging.PagePool(DIMS, np.float32, bs, n_blocks, 2, max_seq,
                         cold_after=cold_after)
    t = paging.PagePool(DIMS, torch.float32, bs, n_blocks, 2, max_seq,
                        cold_after=cold_after, device="cpu")
    return j, t


def _row(max_seq=16, seed=0):
    """A dense [L, KVh, T, hd] slot row pair with distinct values."""
    L, KVh, hd = DIMS
    rng = np.random.RandomState(seed)
    return (rng.randn(L, KVh, max_seq, hd).astype(np.float32),
            rng.randn(L, KVh, max_seq, hd).astype(np.float32))


def _same(j, t):
    np.testing.assert_array_equal(t.tables, j.tables)
    np.testing.assert_array_equal(t.refs, j.refs)
    assert t._free == j._free
    assert t.stats() == j.stats()
    np.testing.assert_array_equal(t.kp.numpy(), np.asarray(j.kp))
    np.testing.assert_array_equal(t.vp.numpy(), np.asarray(j.vp))


def test_geometry_and_null_frame():
    j, t = _pools()
    assert (t.maxb, t.bs, tuple(t.kp.shape)) == (j.maxb, j.bs, j.kp.shape)
    assert (t.kp[0] == 0).all() and t.free_blocks() == j.free_blocks() == 7
    assert [t.blocks_for(n) for n in (1, 4, 5, 16)] == \
        [j.blocks_for(n) for n in (1, 4, 5, 16)]
    assert t.block_bytes == j.block_bytes
    _same(j, t)


@pytest.mark.parametrize("bad", [dict(block_size=0), dict(max_seq=15),
                                 dict(n_blocks=1)])
def test_constructor_errors_match(bad):
    kw = {**dict(block_size=4, n_blocks=8, max_seq=16), **bad}
    args = (kw["block_size"], kw["n_blocks"], 2, kw["max_seq"])
    with pytest.raises(ValueError) as je:
        jpaging.PagePool(DIMS, np.float32, *args)
    with pytest.raises(ValueError) as te:
        paging.PagePool(DIMS, torch.float32, *args, device="cpu")
    assert str(te.value) == str(je.value)


def test_reserve_whole_budget_then_free():
    j, t = _pools()
    assert t.reserve(0, 10) == j.reserve(0, 10) == 3
    _same(j, t)
    assert t.tables[0].tolist() == [1, 2, 3, 0]       # frame 1 first
    with pytest.raises(RuntimeError):
        t.reserve(0, 4)                               # double reservation
    t.reserve(1, 5), j.reserve(1, 5)
    _same(j, t)
    t.free_slot(0), j.free_slot(0)
    _same(j, t)
    t.reserve(0, 16), j.reserve(0, 16)                # reuses freed frames
    _same(j, t)


def test_full_pool_raises_before_any_mutation():
    j, t = _pools(n_blocks=3)                         # 2 usable frames
    with pytest.raises(jpaging.PagePoolFullError):
        j.reserve(0, 16)
    with pytest.raises(paging.PagePoolFullError, match="exhausted"):
        t.reserve(0, 16)                              # needs 4 > 2
    _same(j, t)
    assert t.free_blocks() == 2 and not t.tables.any()


def test_shared_prefix_refcounts_and_cow():
    j, t = _pools()
    kc, vc = _row()
    assert t.put_prefix("p", torch.from_numpy(kc), torch.from_numpy(vc),
                        10) == j.put_prefix("p", jnp.asarray(kc),
                                            jnp.asarray(vc), 10) == 2
    _same(j, t)
    frames = t.prefix_frames("p")
    assert frames == j.prefix_frames("p")
    # two sessions on the prefix: 2 shared frames + 1 private each; the
    # prefix (10 columns) is not block-aligned, so the boundary block is
    # a private copy (cow)
    for slot in (0, 1):
        t.reserve(slot, 12, shared_frames=frames)
        j.reserve(slot, 12, shared_frames=frames, cow=True)
        row = _row(seed=slot + 1)
        t.admit_row(slot, *(torch.from_numpy(r) for r in row))
        j.admit_row(slot, *(jnp.asarray(r) for r in row))
        _same(j, t)
    assert t.refs[frames[0]] == 3                     # pin + 2 sessions
    with pytest.raises(ValueError, match="already registered"):
        t.put_prefix("p", torch.from_numpy(kc), torch.from_numpy(vc), 8)
    for slot in (0, 1):
        t.free_slot(slot), j.free_slot(slot)
        _same(j, t)
    assert t.refs[frames[0]] == 1                     # the registry pin
    t.drop_prefix("p"), j.drop_prefix("p")
    _same(j, t)
    assert t.free_blocks() == 7


def test_gather_and_scatter_equal_the_jax_packages():
    j, t = _pools()
    kc, vc = _row(seed=3)
    t.reserve(0, t.max_seq), j.reserve(0, j.max_seq)
    t.admit_row(0, torch.from_numpy(kc), torch.from_numpy(vc))
    j.admit_row(0, jnp.asarray(kc), jnp.asarray(vc))
    _same(j, t)
    kd, vd = paging.gather_dense(t.kp, t.vp, t.tables_device())
    jkd, jvd = jpaging.gather_dense(j.kp, j.vp, j.tables_device())
    np.testing.assert_array_equal(kd.numpy(), np.asarray(jkd))
    np.testing.assert_array_equal(vd.numpy(), np.asarray(jvd))
    np.testing.assert_array_equal(kd[:, 0].numpy(), kc)   # the row back
    assert (kd[:, 1] == 0).all()                          # the null frame
    # frontier write-back: poke column 5 of row 0 and scatter it home
    kd[:, 0, :, 5, :] = 7.0
    jkd = jkd.at[:, 0, :, 5, :].set(7.0)
    pos = np.array([5, 0], np.int32)
    paging.scatter_cols(t.kp, t.vp, kd, vd, t.tables_device(),
                        torch.from_numpy(pos))
    j.kp, j.vp = jpaging.scatter_cols(j.kp, j.vp, jkd, jvd,
                                      j.tables_device(), jnp.asarray(pos))
    _same(j, t)
    kd3, _ = paging.gather_dense(t.kp, t.vp, t.tables_device())
    assert (kd3[:, 0, :, 5, :] == 7.0).all()
    np.testing.assert_array_equal(kd3[:, 0, :, :5].numpy(), kc[:, :, :5])


def test_scatter_of_a_slot_at_capacity_stays_in_the_null_frame():
    """A slot finished at "capacity" keeps pos == T until its next
    admission and the decode step still feeds it: its write must land in
    frame 0, never in another session's frames."""
    _, t = _pools()
    kc, vc = _row(seed=4)
    t.reserve(0, t.max_seq)
    t.admit_row(0, torch.from_numpy(kc), torch.from_numpy(vc))
    before = t.kp[1:].clone()
    kd, vd = paging.gather_dense(t.kp, t.vp, t.tables_device())
    kd[:, 1] = 9.0
    paging.scatter_cols(t.kp, t.vp, kd, vd, t.tables_device(),
                        torch.tensor([3, t.max_seq]))
    assert torch.equal(t.kp[1:], before)


def test_cold_page_roundtrip_within_codec_band():
    j, t = _pools(cold_after=1)
    kc, vc = _row(seed=4)
    t.put_prefix("p", torch.from_numpy(kc), torch.from_numpy(vc), 8)
    j.put_prefix("p", jnp.asarray(kc), jnp.asarray(vc), 8)
    frames = t.prefix_frames("p")
    j.prefix_frames("p")
    hot = t.kp[frames].clone()
    for _ in range(3):
        assert t.sweep() == j.sweep()
        _same(j, t)
    st = t.stats()
    assert st["cold_pages"] == 2 and st["cold_bytes"] > 0
    assert t.free_blocks() == 7                       # frames freed
    back_frames = t.prefix_frames("p")                # touch: decompress
    assert back_frames == j.prefix_frames("p")
    _same(j, t)                                       # codec bit-equal
    assert t.stats()["cold_pages"] == 0
    back = t.kp[back_frames]
    band = hot.abs().amax(-1, keepdim=True) / 254.0 + 1e-7
    assert ((back - hot).abs() <= band).all()


def test_sessions_pin_frames_against_cold_sweep():
    j, t = _pools(cold_after=1)
    kc, vc = _row()
    t.put_prefix("p", torch.from_numpy(kc), torch.from_numpy(vc), 8)
    j.put_prefix("p", jnp.asarray(kc), jnp.asarray(vc), 8)
    frames = t.prefix_frames("p")
    j.prefix_frames("p")
    t.reserve(0, 12, shared_frames=frames)
    j.reserve(0, 12, shared_frames=frames)
    for _ in range(3):
        t.sweep(), j.sweep()
    assert t.stats()["cold_pages"] == 0               # a live ref blocks it
    _same(j, t)
    t.free_slot(0), j.free_slot(0)
    t.sweep(), j.sweep()
    assert t.stats()["cold_pages"] == 2
    _same(j, t)
    t.drop_prefix("p"), j.drop_prefix("p")            # cold pages dropped
    _same(j, t)
    assert t.stats()["cold_bytes"] == 0


def test_cold_decompression_needs_free_frames():
    j, t = _pools(n_blocks=4, cold_after=1)           # 3 usable frames
    kc, vc = _row()
    t.put_prefix("p", torch.from_numpy(kc), torch.from_numpy(vc), 8)
    t.sweep(), t.sweep()
    t.reserve(0, 12)                                  # 3 private frames
    with pytest.raises(paging.PagePoolFullError, match="decompression"):
        t.prefix_frames("p")
    assert t.prefix_frames("missing") is None
