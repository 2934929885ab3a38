"""The single-device trainer.

Ports ``SpmdTrainer`` of paddle_tpu/distributed/spmd.py on one device:
``__init__``, ``_forward_loss`` (the layer and loss under the trainer's
``amp_dtype``, or ``layer(*inputs, label)`` without a ``loss_fn``), the
step of ``_build`` (loss and grads, the optimizer's ``functional_apply``,
the ``FLAGS_check_nan_inf`` guard), ``train_step``, the non-finite streak
and ``stats``.

What differs from the reference:
- PyTorch runs eagerly, so there is no compiled step: ``train_step`` runs
  the forward, ``loss.backward()`` with autocast off, and the optimizer's
  in-place update.
- The non-finite guard is synchronous: with ``FLAGS_check_nan_inf`` each
  step reads one boolean back from the device (one ``.item()``), where the
  reference defers the verdict by a step. A non-finite loss or gradient
  skips the update, so parameters, optimizer state, the layer's buffers
  (BatchNorm's running statistics, which a training forward updates in
  place: the guard copies them before the forward and puts the copies
  back) and the step counter stay bit-identical (the learning-rate
  position does not advance); more
  than ``FLAGS_max_skip_steps`` consecutive skips raise FloatingPointError
  from the step that makes the streak too long.
- ``stats()`` times each step on the host clock without a device sync, as
  the reference does without FLAGS_benchmark; its cost-registry keys
  (``flops_per_step``, ``hbm``, ``peak_flops``, ``mfu``) are None until the
  cost registry is ported.

Only one device: a mesh other than None or one device, ZeRO stages,
recompute, gradient merge, tensor-parallel specs, localsgd, DGC,
compressed data parallelism (FLAGS_quantized_allreduce /
FLAGS_shard_weight_update), ``return_outputs``, ``metrics_fn`` and every
other extra knob raise NotImplementedError.
"""
import contextlib
import time

import numpy as np
import torch

from .. import flags as _flags
from ..amp.auto_cast import auto_cast, disabled as _autocast_off
from ..optimizer.optimizer import Optimizer


def _one_device(mesh):
    """Is `mesh` a single device: None, a torch.device or device string,
    or an object whose ``devices`` (or ``size``) counts one device."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return True
    devices = getattr(mesh, "devices", None)
    if devices is not None:
        return int(np.asarray(devices).size) == 1
    size = getattr(mesh, "size", None)
    size = size() if callable(size) else size
    return size == 1


class SpmdTrainer:
    """Train `layer` with `optimizer` one batch at a time on the layer's
    device. ``train_step(*batch)`` takes inputs then the label (numpy
    arrays or tensors) and returns the fp32 loss."""

    def __init__(self, layer, optimizer, loss_fn=None, mesh=None,
                 dp_axis="dp", sharding_stage=0, recompute=False,
                 accumulate_steps=1, extra_param_specs=None, metrics_fn=None,
                 donate=True, amp_dtype=None, return_outputs=False,
                 **extra_kwargs):
        refused = []
        if not _one_device(mesh):
            refused.append("a mesh of more than one device")
        if sharding_stage:
            refused.append(f"sharding_stage={sharding_stage}")
        if recompute:
            refused.append("recompute=True")
        if accumulate_steps != 1:
            refused.append(f"accumulate_steps={accumulate_steps}")
        if extra_param_specs:
            refused.append("extra_param_specs (tensor parallelism)")
        if metrics_fn is not None:
            refused.append("metrics_fn")
        if return_outputs:
            refused.append("return_outputs=True")
        refused += [f"{k}=" for k in sorted(extra_kwargs)]
        for flag in ("quantized_allreduce", "shard_weight_update"):
            if _flags.get_flag(flag, False):
                refused.append(f"FLAGS_{flag} (compressed data parallelism)")
        if type(optimizer).__name__.startswith("DGC"):
            refused.append("a DGC optimizer")
        if refused:
            raise NotImplementedError(
                "SpmdTrainer is ported for one device only; not ported yet: "
                + ", ".join(refused))
        if not isinstance(optimizer, Optimizer):
            raise TypeError(f"optimizer must be a paddle_tpu_torch optimizer, "
                            f"got {type(optimizer).__name__}")
        self.layer = layer
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.amp_dtype = amp_dtype
        self.params = {n: p for n, p in layer.named_parameters()
                       if p.requires_grad}
        self.buffers = dict(layer.named_buffers())
        self.opt_state = optimizer.functional_init(self.params)
        self._device = next(iter(self.params.values())).device \
            if self.params else torch.device("cpu")
        self._nonfinite_streak = 0   # consecutive skipped steps
        self._nonfinite_total = 0    # lifetime skipped steps (stats())
        self._step_count = 0
        self._step_ms_sum = 0.0

    def _forward_loss(self, batch):
        inputs, label = batch[:-1], batch[-1]
        amp_ctx = contextlib.nullcontext()
        if self.amp_dtype is not None:
            amp_ctx = auto_cast(True, dtype=self.amp_dtype)
        with amp_ctx:
            if self.loss_fn is not None:
                return self.loss_fn(self.layer(*inputs), label)
            return self.layer(*inputs, label)

    def _to_device(self, b):
        t = b if isinstance(b, torch.Tensor) else torch.as_tensor(
            np.asarray(b))
        if t.dtype in (torch.int32, torch.int16, torch.uint8):
            t = t.long()             # ids and labels index as int64
        return t.to(self._device)

    def train_step(self, *batch):
        """One step: forward, backward, (guarded) update. Returns the loss
        as a detached fp32 tensor."""
        t_step = time.perf_counter()
        batch = [self._to_device(b) for b in batch]
        for p in self.params.values():
            p.grad = None
        guard = _flags.get_flag("check_nan_inf", False)
        saved = {n: b.clone() for n, b in self.buffers.items()} \
            if guard else None
        loss = self._forward_loss(batch).float()
        with _autocast_off():
            loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        if guard and not self._all_finite(loss, grads):
            with torch.no_grad():
                for n, b in self.buffers.items():
                    b.copy_(saved[n])
            self._skip()
        else:
            self._nonfinite_streak = 0
            self.optimizer.functional_apply(self.params, grads,
                                            self.opt_state,
                                            lr=self.optimizer.get_lr())
            self.optimizer._step_count += 1
        for p in self.params.values():
            p.grad = None
        self._step_count += 1
        self._step_ms_sum += (time.perf_counter() - t_step) * 1e3
        return loss.detach()

    @staticmethod
    def _all_finite(loss, grads):
        """One device-side verdict over the loss and every grad, read back
        with one host sync."""
        flags = [torch.isfinite(loss).all()]
        flags += [torch.isfinite(g).all() for g in grads.values()
                  if g is not None]
        return bool(torch.stack(flags).all().item())

    def _skip(self):
        """A non-finite step: nothing was applied. Count it, and raise once
        the consecutive streak passes FLAGS_max_skip_steps."""
        self._nonfinite_streak += 1
        self._nonfinite_total += 1
        max_skip = int(_flags.get_flag("max_skip_steps", 3))
        if self._nonfinite_streak > max_skip:
            raise FloatingPointError(
                f"train_step: non-finite loss/gradients for "
                f"{self._nonfinite_streak} consecutive steps "
                f"(> FLAGS_max_skip_steps={max_skip}); aborting — every "
                "skipped step left parameters and optimizer state "
                "untouched; inspect the data pipeline / learning rate")

    def stats(self):
        """Step counts and host wall time (no device sync), plus the
        non-finite guard's counters. The cost-registry keys are None (no
        cost registry in the port yet)."""
        n = self._step_count
        return {
            "steps": n,
            "step_ms_total": self._step_ms_sum,
            "step_ms_avg": self._step_ms_sum / n if n else None,
            "flops_per_step": None,
            "hbm": None,
            "peak_flops": None,
            "mfu": None,
            "breakdown": {
                "nonfinite_skipped_total": self._nonfinite_total,
                "nonfinite_streak": self._nonfinite_streak,
            },
        }
