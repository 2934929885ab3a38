"""The single-device trainer.

Ports ``SpmdTrainer`` of paddle_tpu/distributed/spmd.py on one device:
``__init__``, ``_forward_loss`` (the layer and loss under the trainer's
``amp_dtype``, or ``layer(*inputs, label)`` without a ``loss_fn``), the
step of ``_build`` (loss and grads, gradient merge, the optimizer's
``functional_apply``, the ``FLAGS_check_nan_inf`` guard), recompute
(``_wrapped_forward``), ``train_step``, ``return_outputs`` /
``last_outputs``, the non-finite streak and ``stats``.

- ``recompute=True``: the forward and the loss run under
  ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so backward
  runs the forward a second time. ``recompute_policy`` (``dots``,
  ``dots_no_batch``, ``nothing``, ``everything``: the reference's
  ``jax.checkpoint_policies``) becomes a selective-checkpoint policy:
  ``dots`` saves the output of every aten matmul (mm, addmm, bmm,
  baddbmm), ``dots_no_batch`` those without batch dimensions (mm,
  addmm), ``nothing`` saves none and ``everything`` every op, the kernel
  launches of ops/ included (they are ``torch.library`` custom ops), so
  that under ``everything`` no kernel runs twice. A recompute leaves no
  trace of its own: it runs from the generator states and the buffers the
  forward started from (dropout draws the same masks; BatchNorm reads the
  same running statistics) and puts back those that the forward left.
- ``accumulate_steps=k > 1`` (gradient merge): the batch splits
  contiguously along dim 0 into k micro-batches; each one's forward reads
  the step's input buffers (the step keeps the last micro-batch's new
  ones), the grads and the fp32 losses are summed and divided by k, and
  the optimizer updates once.
- ``return_outputs=True``: ``last_outputs`` holds the layer's outputs of
  the step (detached), the micro-batches' concatenated along dim 0; None
  without a ``loss_fn``, as in the reference.
- ``metrics_fn`` is accepted and never read, as in the reference.

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
tensor-parallel specs, localsgd, DGC, compressed data parallelism
(FLAGS_quantized_allreduce / FLAGS_shard_weight_update), the async
dispatch of steps (FLAGS_async_dispatch), ``remat_offload`` and every
other extra knob raise NotImplementedError.
"""
import contextlib
import functools
import time

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint
from torch.utils._python_dispatch import _disable_current_modes as _no_modes

from .. import flags as _flags
from ..amp.auto_cast import auto_cast, disabled as _autocast_off
from ..core import generator as _generator
from ..optimizer.optimizer import Optimizer

_aten = torch.ops.aten
#: the matmul ops a ``dots`` policy saves; those with batch dimensions
#: (``bmm``, ``baddbmm``) are left out by ``dots_no_batch``
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default}
_DOTS_NO_BATCH = {_aten.mm.default, _aten.addmm.default}

#: recompute_policy -> the ops whose outputs a recompute keeps (None: all)
_REMAT_POLICIES = {"dots": _DOTS, "dots_no_batch": _DOTS_NO_BATCH,
                   "nothing": frozenset(), "everything": None}


def _resolve_remat_policy(name):
    if name not in _REMAT_POLICIES:
        raise ValueError(f"recompute_policy must be one of "
                         f"{sorted(_REMAT_POLICIES)}, got {name!r}")
    saved = _REMAT_POLICIES[name]
    CP = _checkpoint.CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        # an op that writes into its inputs (BatchNorm's running
        # statistics) runs again: its cached output would be a tensor
        # that later writes change
        keep = (saved is None and not op._schema.is_mutable) \
            or (saved is not None and op in saved)
        return CP.MUST_SAVE if keep else CP.PREFER_RECOMPUTE

    return functools.partial(_checkpoint.create_selective_checkpoint_contexts,
                             policy)


def _concat_outputs(parts):
    """The micro-batches' outputs (tensors, or tuples / lists / dicts of
    them) concatenated along dim 0, detached."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.detach() for t in parts]) if len(parts) > 1 \
            else first.detach()
    if isinstance(first, (tuple, list)):
        return type(first)(_concat_outputs([p[i] for p in parts])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _concat_outputs([p[k] for p in parts]) for k in first}
    return first


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
        if extra_param_specs:
            refused.append("extra_param_specs (tensor parallelism)")
        refused += [f"{k}=" for k in sorted(extra_kwargs)
                    if k != "recompute_policy"]
        for flag in ("quantized_allreduce", "shard_weight_update"):
            if _flags.get_flag(flag, False):
                refused.append(f"FLAGS_{flag} (compressed data parallelism)")
        if _flags.get_flag("async_dispatch", False):
            refused.append("FLAGS_async_dispatch (the trainer's lazy "
                           "StepHandle)")
        if type(optimizer).__name__.startswith("DGC"):
            refused.append("a DGC optimizer")
        if refused:
            raise NotImplementedError(
                "SpmdTrainer is ported for one device only; not ported yet: "
                + ", ".join(refused))
        if not isinstance(optimizer, Optimizer):
            raise TypeError(f"optimizer must be a paddle_tpu_torch optimizer, "
                            f"got {type(optimizer).__name__}")
        pol = extra_kwargs.get("recompute_policy")
        self._context_fn = None
        if pol is not None:
            self._context_fn = _resolve_remat_policy(pol)
            if not recompute:
                raise ValueError("recompute_policy requires recompute=True "
                                 "(the policy selects what the checkpoint "
                                 "saves; without recompute it changes "
                                 "nothing)")
        if int(accumulate_steps) < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self.layer = layer
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.recompute = bool(recompute)
        self.accumulate_steps = int(accumulate_steps)
        self.amp_dtype = amp_dtype
        self.return_outputs = bool(return_outputs)
        self.last_outputs = None
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
        """(loss, outputs): outputs is the layer's output with a
        ``loss_fn`` and ``return_outputs``, else None (so that nothing
        holds the logits through the backward)."""
        inputs, label = batch[:-1], batch[-1]
        amp_ctx = contextlib.nullcontext()
        if self.amp_dtype is not None:
            amp_ctx = auto_cast(True, dtype=self.amp_dtype)
        with amp_ctx:
            if self.loss_fn is not None:
                out = self.layer(*inputs)
                return self.loss_fn(out, label), \
                    out if self.return_outputs else None
            return self.layer(*inputs, label), None

    def _recomputed_forward_loss(self, batch):
        """_forward_loss under the checkpoint. The first run (the forward)
        notes the port's generator states and the buffers it starts from;
        a second run (the recompute inside backward) starts from them and
        puts back what it found, so that the step's dropout masks, running
        statistics and later draws are those of one forward."""
        _generator.default_generator(self._device)   # exists before a note
        gens = list(_generator._GENERATORS.values())
        buffers = list(self.buffers.values())
        noted = []

        # outside the selective checkpoint's dispatch modes, which would
        # count these copies as ops of the checkpointed region
        def note():
            with _no_modes():
                return ([g.get_state() for g in gens],
                        [b.clone() for b in buffers])

        @torch.no_grad()
        def put(state):
            with _no_modes():
                for g, st in zip(gens, state[0]):
                    g.set_state(st)
                for b, v in zip(buffers, state[1]):
                    b.copy_(v)

        def run(*batch):
            if not noted:
                noted.append(note())
                return self._forward_loss(batch)
            now = note()
            put(noted[0])
            try:
                return self._forward_loss(batch)
            finally:
                put(now)

        kwargs = {}
        if self._context_fn is not None:
            kwargs["context_fn"] = self._context_fn
        return _checkpoint.checkpoint(run, *batch, use_reentrant=False,
                                      **kwargs)

    def _to_device(self, b):
        t = b if isinstance(b, torch.Tensor) else torch.as_tensor(
            np.asarray(b))
        if t.dtype in (torch.int32, torch.int16, torch.uint8):
            t = t.long()             # ids and labels index as int64
        return t.to(self._device)

    def _micro_batches(self, batch):
        """The batch split contiguously along dim 0 into
        ``accumulate_steps`` micro-batches (the reference's
        ``reshape(accum, B // accum, ...)``)."""
        k = self.accumulate_steps
        if k == 1:
            return [batch]
        for b in batch:
            if b.shape[0] % k:
                raise ValueError(f"accumulate_steps={k} must divide the "
                                 f"batch's dim 0, {b.shape[0]}")
        return [[b.narrow(0, i * (b.shape[0] // k), b.shape[0] // k)
                 for b in batch] for i in range(k)]

    def train_step(self, *batch):
        """One step: forward and backward of each micro-batch, then the
        (guarded) update. Returns the loss, the micro-batches' mean, as a
        detached fp32 tensor."""
        t_step = time.perf_counter()
        batch = [self._to_device(b) for b in batch]
        for p in self.params.values():
            p.grad = None
        guard = _flags.get_flag("check_nan_inf", False)
        k = self.accumulate_steps
        saved = {n: b.clone() for n, b in self.buffers.items()} \
            if guard or k > 1 else None
        fwd = self._recomputed_forward_loss if self.recompute \
            else self._forward_loss
        loss, outputs = None, []
        for i, micro in enumerate(self._micro_batches(batch)):
            if i:      # each micro-batch reads the step's input buffers
                with torch.no_grad():
                    for n, b in self.buffers.items():
                        b.copy_(saved[n])
            part, out = fwd(micro)
            part = part.float()
            with _autocast_off():
                part.backward()
            loss = part.detach() if loss is None else loss + part.detach()
            outputs.append(out)
        grads = {n: p.grad for n, p in self.params.items()}
        if k > 1:
            loss = loss / k
            present = [g for g in grads.values() if g is not None]
            if present:
                torch._foreach_div_(present, k)
        if self.return_outputs:
            self.last_outputs = None if outputs[0] is None \
                else _concat_outputs(outputs)
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
        return loss

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
