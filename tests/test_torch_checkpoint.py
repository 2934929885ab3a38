"""Durable checkpoints in the port (paddle_tpu_torch/framework/io.py,
incubate/checkpoint/, SpmdTrainer.state_dict / set_state_dict,
hapi.Model.save / load) and the goodput accountant (monitor/goodput.py),
against the JAX package's file format and schema where they meet.

Exact throughout: a round trip returns the same bits, a resumed narrow GPT
(AdamW under a warmup + cosine schedule) gives the same losses and
parameters as the uninterrupted run, and the goodput buckets sum to the
run's wall time up to float rounding (1e-9 relative)."""
import os
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.spmd import CHECKPOINT_SCHEMA as J_SCHEMA  # noqa: E402,E501

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import flags as pflags  # noqa: E402
from paddle_tpu_torch import monitor, trace  # noqa: E402
from paddle_tpu_torch.distributed import SpmdTrainer  # noqa: E402
from paddle_tpu_torch.distributed.spmd import CHECKPOINT_SCHEMA  # noqa: E402
from paddle_tpu_torch.framework import io  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import (  # noqa: E402
    CheckpointSaver, TrainEpochRange)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainLoss)
from paddle_tpu_torch.monitor import goodput  # noqa: E402
from paddle_tpu_torch.optimizer import Adam, AdamW  # noqa: E402
from paddle_tpu_torch.optimizer import lr as lrs  # noqa: E402
from paddle_tpu_torch.testing import failpoints  # noqa: E402
from paddle_tpu_torch.vision.models import LeNet  # noqa: E402

NARROW = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0)
STEPS = 6


def _equal(a, b):
    """Deep equality, tensors bit for bit (dtype and shape too)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a.view(-1).view(
                torch.uint8), b.view(-1).view(torch.uint8))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a == b


def test_round_trip_every_kind(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {
        "fp32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(7, generator=g).bfloat16(),
        "fp16": torch.randn(2, 2, generator=g).half(),
        "fp8": torch.randn(4, generator=g).to(torch.float8_e4m3fn),
        "int": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "long": torch.tensor(2 ** 40), "bool": torch.tensor([True, False]),
        "scalar": torch.tensor(1.5),
        "nested": {"list": [torch.ones(2), 3, "s"],
                   "tuple": (torch.zeros(1, dtype=torch.float16), None)},
        "np": np.arange(3), "meta": {"epoch": 2},
    }
    path = str(tmp_path / "x.pdparams")
    io.save(state, path)
    got = io.load(path, device="cpu")
    assert _equal({k: v for k, v in got.items() if k != "np"},
                  {k: v for k, v in state.items() if k != "np"})
    assert np.array_equal(got["np"], state["np"])
    p = torch.nn.Parameter(torch.ones(2))
    io.save({"p": p}, path)
    assert io.load(path, device="cpu")["p"].requires_grad
    with pytest.raises(NotImplementedError, match="crypto"):
        io.save(state, path, encryption_key="k")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        io.load(path)            # cuda by default: none here


def test_flipped_byte_raises_corrupt(tmp_path):
    path = str(tmp_path / "x.pdparams")
    io.save({"w": torch.randn(64)}, path)
    raw = bytearray(Path(path).read_bytes())
    raw[40] ^= 0x01
    Path(path).write_bytes(bytes(raw))
    with pytest.raises(io.CheckpointCorruptError, match="integrity"):
        io.load(path, device="cpu")


def test_ckpt_write_failpoint_leaves_destination_and_no_tmp(tmp_path):
    path = str(tmp_path / "x.pdparams")
    io.save({"w": torch.zeros(3)}, path)
    before = Path(path).read_bytes()
    with failpoints.scoped("ckpt/write=error:1"):
        with pytest.raises(failpoints.FailpointError):
            io.save({"w": torch.ones(3)}, path)
    assert Path(path).read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["x.pdparams"]
    assert torch.equal(io.load(path, device="cpu")["w"], torch.zeros(3))
    with failpoints.scoped("ckpt/read=error:1"):
        with pytest.raises(failpoints.FailpointError):
            io.load(path, device="cpu")


def test_files_cross_between_the_packages(tmp_path):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    h = rng.randn(5).astype(np.float16)
    ids = rng.randint(0, 9, (6,)).astype(np.int32)
    bf = rng.randn(8).astype(np.float32)
    ours, theirs = str(tmp_path / "p.pdparams"), str(tmp_path / "j.pdparams")
    io.save({"w": torch.from_numpy(w), "h": torch.from_numpy(h),
             "ids": torch.from_numpy(ids),
             "bf": torch.from_numpy(bf).bfloat16(), "n": {"k": [1, 2]}}, ours)
    paddle.save({"w": paddle.to_tensor(w), "h": paddle.to_tensor(h),
                 "ids": paddle.to_tensor(ids),
                 "bf": paddle.to_tensor(bf).astype("bfloat16"),
                 "n": {"k": [1, 2]}}, theirs)
    by_ref = paddle.load(ours)
    by_port = io.load(theirs, device="cpu")
    for k, want in (("w", w), ("h", h), ("ids", ids)):
        assert np.array_equal(np.asarray(by_ref[k]._data), want)
        assert np.array_equal(by_port[k].numpy(), want)
    # bf16: the port reads the reference's ml_dtypes array bit for bit;
    # the reference reads the port's record as its int16 bits
    want_bf = torch.from_numpy(bf).bfloat16()
    assert by_port["bf"].dtype == torch.bfloat16
    assert torch.equal(by_port["bf"], want_bf)
    assert np.array_equal(
        np.asarray(by_ref["bf"]._data).view(ml_dtypes.bfloat16)
        .astype(np.float32), want_bf.float().numpy())
    assert by_ref["n"] == by_port["n"] == {"k": [1, 2]}


def _make_saver_state(i):
    return {"w": torch.full((4,), float(i)), "step": i}


def test_checkpoint_saver_max_num_and_corrupt_fallback(tmp_path):
    d = str(tmp_path / "ck")
    saver = CheckpointSaver(d, max_num=2, device="cpu")
    for i in range(4):
        assert saver.save_checkpoint(_make_saver_state(i),
                                     meta={"epoch": i}) == i
    assert saver.get_checkpoint_numbers() == [2, 3]
    state, meta = saver.load_checkpoint()
    assert meta["epoch"] == 3 and state["step"] == 3
    newest = Path(d) / "__paddle_checkpoint__.3" / "state.pdparams"
    raw = newest.read_bytes()
    newest.write_bytes(raw[:len(raw) // 2])              # a torn write
    rec = monitor.counter("checkpoint_recover_total",
                          labelnames=("reason",)).labels(reason="corrupt")
    n0 = rec.value
    with pytest.warns(UserWarning, match="evicting"):
        state, meta = saver.load_checkpoint()
    assert meta["epoch"] == 2 and torch.equal(state["w"], torch.full((4,),
                                                                     2.0))
    assert saver.get_checkpoint_numbers() == [2] and rec.value == n0 + 1
    with failpoints.scoped("ckpt/commit=error:1"):
        with pytest.raises(failpoints.FailpointError):
            saver.save_checkpoint(_make_saver_state(9))
    assert CheckpointSaver(d, device="cpu").get_checkpoint_numbers() == [2]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]


def test_train_epoch_range_resumes(tmp_path):
    lin = torch.nn.Linear(3, 2)
    opt = Adam(parameters=lin.parameters())
    r = TrainEpochRange(3, "job", save_dir=str(tmp_path), device="cpu")
    r.add(layer=lin, optimizer=opt)
    for epoch in r:
        if epoch == 1:
            break
    saved = lin.weight.detach().clone()       # epoch 0's commit
    with torch.no_grad():
        lin.weight.add_(1.0)
    lin2 = torch.nn.Linear(3, 2)
    r2 = TrainEpochRange(3, "job", save_dir=str(tmp_path), device="cpu")
    r2.add(layer=lin2, optimizer=Adam(parameters=lin2.parameters()))
    assert list(r2.get()) == [1, 2]
    assert torch.equal(lin2.weight, saved)


def _gpt_trainer():
    pt.seed(0)
    torch.manual_seed(0)
    model = GPTForCausalLM(GPTConfig(**NARROW), device="cpu")
    sched = lrs.LinearWarmup(lrs.CosineAnnealingDecay(1e-3, STEPS), 2, 0.0,
                             1e-3)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01)
    return model, SpmdTrainer(model, opt, GPTPretrainLoss()), sched


def _batches():
    rng = np.random.RandomState(0)
    return [[rng.randint(0, NARROW["vocab_size"], (2, 128)).astype(np.int32)
             for _ in range(2)] for _ in range(STEPS)]


def _run(trainer, sched, batches):
    out = []
    for b in batches:
        out.append(trainer.train_step(*b))
        sched.step()
    return out


def test_state_dict_keys_match_the_reference_schema():
    assert set(CHECKPOINT_SCHEMA["payload"]) == set(J_SCHEMA["payload"])
    _, tr, _ = _gpt_trainer()
    assert set(tr.state_dict()) == set(J_SCHEMA["payload"]) | {"buffers"}


def test_narrow_gpt_resumes_bit_exactly(tmp_path):
    batches = _batches()
    model, tr, sched = _gpt_trainer()
    full = _run(tr, sched, batches)

    _, tr_a, sched_a = _gpt_trainer()
    first = _run(tr_a, sched_a, batches[:3])
    saver = CheckpointSaver(str(tmp_path), device="cpu")
    saver.save_checkpoint(tr_a.state_dict(), meta={"step": 3})
    assert tr_a.weight_version.counter == 3

    model_b, tr_b, sched_b = _gpt_trainer()
    state, meta = saver.load_checkpoint()
    tr_b.set_state_dict(state)
    assert tr_b.weight_version.origin == "restore"
    assert tr_b.weight_version.counter == 4   # max(0, 3) + 1
    assert tr_b.optimizer._step_count == 3 and sched_b.last_epoch == 3
    second = _run(tr_b, sched_b, batches[3:])
    assert tr_b.weight_version.counter == 7
    assert all(torch.equal(a, b) for a, b in zip(full, first + second))
    for (n, p), q in zip(model.named_parameters(), model_b.parameters()):
        assert torch.equal(p, q), n
    # a stale checkpoint fails fast with names
    state["params"].pop("gpt.wte.weight")
    with pytest.raises(ValueError, match="missing: \\['gpt.wte.weight'\\]"):
        tr_b.set_state_dict(state)


def test_counted_steps_are_bit_equal_and_fill_stats():
    batches = _batches()[:3]
    model, tr, sched = _gpt_trainer()
    plain = _run(tr, sched, batches)
    assert tr.stats()["flops_per_step"] is None
    model_t, tr_t, sched_t = _gpt_trainer()
    trace.clear()
    with trace.scoped_enabled(True):
        traced = _run(tr_t, sched_t, batches)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    for p, q in zip(model.parameters(), model_t.parameters()):
        assert torch.equal(p, q)
    st = tr_t.stats()
    assert st["flops_per_step"] > 0 and st["peak_flops"] == 1e12
    assert st["mfu"] is not None and st["mfu"] > 0
    assert st["steps"] == 3
    assert st["step_ms_avg"] == pytest.approx(st["step_ms_total"] / 2)
    steps = [s for s in trace.spans() if s.name == "train_step"]
    assert len(steps) == 3 and steps[0].attrs["counted"] is True
    # forward + backward matmuls: 6 x (12 h^2 L + h V) a token, plus the
    # attention products of the plain (CPU) path over all s^2 pairs
    h, L, V, s = 32, 2, 256, 128
    tokens = 2 * s
    assert st["flops_per_step"] == tokens * 6 * (12 * h * h * L + h * V) \
        + 3 * L * 2 * (4 * s * s * h)
    trace.clear()


def test_trainer_batch_scale_failpoint_scales_floats_only():
    model, tr, sched = _gpt_trainer()
    b = _batches()[0]
    with failpoints.scoped("trainer/batch=scale:0"):
        tr.train_step(*b)   # integer ids pass untouched: a normal step
    assert failpoints.hits("trainer/batch") == 1
    with failpoints.scoped("trainer/step=error:1"):
        with pytest.raises(failpoints.FailpointError):
            tr.train_step(*b)


def test_model_save_load(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (4, 1)).astype(np.int64)

    def model():
        torch.manual_seed(0)
        net = LeNet(device="cpu")
        m = pt.Model(net)
        m.prepare(Adam(parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss())
        return m

    a = model()
    a.train_batch([x], [y])
    a.save(str(tmp_path / "lenet"))
    assert sorted(os.listdir(tmp_path)) == ["lenet.pdopt", "lenet.pdparams"]
    b = model()
    b.load(str(tmp_path / "lenet.pdparams"))
    assert _equal(a.network.state_dict(), b.network.state_dict())
    assert a.train_batch([x], [y]) == b.train_batch([x], [y])
    c = model()
    c.load(str(tmp_path / "lenet"), reset_optimizer=True)
    assert c._optimizer._step_count == 0 and b._optimizer._step_count == 2


def test_goodput_buckets_are_exclusive_and_sum_to_wall_time(tmp_path):
    run = goodput.GoodputRun("unit", stall_threshold_s=10.0)
    run.begin("step")
    run.begin("ckpt_save")          # pauses step
    run.end("ckpt_save")
    run.end("step")
    with run.bucket("ckpt_restore"):
        pass
    row = run.finalize()
    assert sum(row["buckets"].values()) == pytest.approx(row["wall_s"],
                                                         rel=1e-9)
    with pytest.raises(ValueError):
        run.begin("nope")
    # armed through the flag: the trainer's steps and checkpoint I/O book
    # their buckets, and the run publishes its families
    pflags.set_flags({"goodput": True})
    try:
        goodput.reset()
        _, tr, sched = _gpt_trainer()
        _run(tr, sched, _batches()[:2])
        path = str(tmp_path / "t.pdparams")
        io.save(tr.state_dict(), path)
        tr.set_state_dict(io.load(path, device="cpu"))
        row = goodput.end_run()
    finally:
        pflags.set_flags({"goodput": False})
        goodput.reset()
    b = row["buckets"]
    assert b["step"] > 0 and b["ckpt_save"] > 0 and b["ckpt_restore"] > 0
    assert sum(b.values()) == pytest.approx(row["wall_s"], rel=1e-9)
    fams = {m["name"] for m in monitor.snapshot()["metrics"]}
    assert {"goodput_seconds_total", "goodput_fraction",
            "checkpoint_total"} <= fams
