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
  the reference does without FLAGS_benchmark. Its cost-registry keys come
  from trace/costs.py: with ``FLAGS_trace`` on, the first step of each
  batch signature runs under the FLOP counter (``costs.count``; the same
  ops and kernels, so bit-equal results) and files its FLOPs, bytes and
  memory under ``site="trainer"``, as the reference records its compiled
  step's cost analysis under the same condition. That step's wall time is
  kept out of ``step_ms_total`` (the reference keeps compile time out of
  it), and ``mfu`` = flops / (``step_ms_avg`` × ``costs.peak_flops()``).

Runtime services, as in the reference: ``step_latency_ms{site=trainer}``
and ``train_step_skipped_total{reason}`` (monitor); a ``train_step`` span
a step (subsystem ``trainer``; trace) and a ``guard/skip`` span a skipped
update; the ``trainer/step`` failpoint before the step and the
``trainer/batch`` transform on the batch (``scale:F`` multiplies the float
inputs only); the ``step`` goodput bucket (FLAGS_goodput, read at
construction); a ``trainer/step`` flight-recorder window around each step
(FLAGS_blackbox); the numerics telescope (FLAGS_numerics, below); a
perf-ledger observation each step (FLAGS_perf_ledger: step ms and, with
the step's FLOPs in the cost registry, MFU; a JSONL row every
``FLAGS_perf_ledger_interval`` steps; the first step of each batch
signature, which builds kernels and grows the allocator, is recorded
``cold`` and kept out of the sentinel's baseline, as the reference keeps
a compiling step out); a ``weight_version`` (framework/lineage.py) bumped
each step; ``state_dict`` / ``set_state_dict`` over ``gather_train_state`` /
``restore_train_state`` with the reference's ``CHECKPOINT_SCHEMA`` payload
plus ``buffers``, ``shard_specs`` recording the one-device layout, the
learning-rate scheduler's state riding along (the trainer takes no
GradScaler, as in the reference: its state is ``GradScaler.state_dict()``).
The reference's ``compile_ms`` and ``benchmark_sync_total`` have no
counterpart (nothing compiles; no FLAGS_benchmark).

The numerics telescope (FLAGS_numerics, read each step): the per-layer
stats of monitor/numerics.py, rows in ``sorted(self.params)`` order, are
computed on the RAW gradients before the non-finite guard and the
optimizer's clip (so a poisoned step still names its layer) and, after
the update, on the parameters against a copy of them taken before it
(kept only while armed: one fp32 copy of the parameters). They stay on
the device; ``numerics_fetch()`` reads them back in one transfer every
``FLAGS_numerics_interval`` armed steps under a ``numerics/fetch`` span
and feeds the drift detectors; ``stats()["numerics"]`` holds the
snapshot. Where the guard skips a step, the port applies no update, so
that step's update norm and ratio read 0 (the reference computes its
discarded update). Disarmed, the step runs exactly the ops it ran
before. With dropout, the
port's generator is stateful and not in the checkpoint (the reference
derives each step's key from the step count), so a resumed run draws
other masks; at dropout 0 a resume is bit-exact.

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
from .. import monitor as _monitor
from .. import trace as _trace
from ..monitor import blackbox_lazy as _blackbox  # import-free facade
from ..amp.auto_cast import auto_cast, disabled as _autocast_off
from ..core import generator as _generator
from ..framework import lineage as _lineage
from ..optimizer.optimizer import Optimizer
from ..testing import failpoints as _failpoints
from ..trace import costs as _costs

#: The checkpoint edge: the train-state tree gather_train_state writes
#: and restore_train_state re-places (the reference's CHECKPOINT_SCHEMA,
#: the same payload keys; state_dict() adds ``buffers``).
CHECKPOINT_SCHEMA = {
    "edge": "checkpoint_state",
    "producer": "paddle_tpu_torch/distributed/spmd.py::gather_train_state",
    "consumer": "paddle_tpu_torch/distributed/spmd.py::restore_train_state",
    "runtime_checked": False,
    "doc": "host snapshot of the train state; shard_specs records the "
           "one-device layout that wrote it; __weight_version__ stamps "
           "the writer's weight lineage",
    "payload": {
        "params": {"kind": "opaque",
                   "layout": "{param_name: host tensor}"},
        "opt_state": {"kind": "opaque",
                      "layout": "{param_name: {moment: host tensor}} + "
                                "__step__"},
        "optimizer_step_count": {"kind": "scalar", "dtype": "int"},
        "lr_scheduler": {"kind": "opaque",
                         "layout": "scheduler state_dict or None"},
        "shard_specs": {"kind": "opaque",
                        "layout": "writer topology metadata: {v, mode, "
                                  "ndp, dp_axis, shard_update, quantized, "
                                  "sharding_stage, params: {name: {shape, "
                                  "size}}, shard_ps, sharded_keys, "
                                  "qar_eligible} or None"},
        "__weight_version__": {"kind": "opaque",
                               "layout": "{run_id, counter, origin} "
                                         "weight-version lineage stamp "
                                         "(framework/lineage.py) or "
                                         "absent — a pre-version "
                                         "checkpoint restores as "
                                         "version 0"},
    },
}

_STEP_MS = _monitor.histogram(
    "step_latency_ms",
    "Executor.run / train_step wall time (host dispatch; device-complete "
    "when FLAGS_benchmark=1 forces a sync)", labelnames=("site",))
_SKIPPED = _monitor.counter(
    "train_step_skipped_total",
    "updates skipped by the FLAGS_check_nan_inf non-finite guard (params/"
    "optimizer state left bit-identical; > FLAGS_max_skip_steps "
    "consecutive skips raise)", labelnames=("reason",))

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


def _batch_sig_label(batch):
    """The reference's batch-signature label: ``dtype[d0,d1]|...``."""
    return "|".join(
        f"{str(t.dtype).replace('torch.', '')}"
        f"[{','.join(str(d) for d in t.shape)}]" for t in batch) or "-"


def _validate_state_keys(what, got, expected):
    missing = sorted(set(expected) - set(got))
    unexpected = sorted(set(got) - set(expected))
    if missing or unexpected:
        raise ValueError(
            f"checkpoint {what} mismatch — missing: {missing or 'none'}, "
            f"unexpected: {unexpected or 'none'} (stale checkpoint for a "
            "changed model?)")


def _host(t):
    """An independent host copy of a tensor."""
    return t.detach().to("cpu", copy=True)


def gather_train_state(params, opt_state, optimizer, layout=None,
                       weight_version=None):
    """Host-side {params, opt_state, optimizer_step_count, lr_scheduler,
    shard_specs[, __weight_version__]} snapshot (CHECKPOINT_SCHEMA):
    independent CPU copies of every tensor."""
    lr = optimizer._lr
    out = {
        "params": {k: _host(v) for k, v in params.items()},
        "opt_state": {
            pname: (_host(st) if pname == "__step__"
                    else {k: _host(v) for k, v in st.items()})
            for pname, st in opt_state.items()},
        "optimizer_step_count": int(optimizer._step_count),
        "lr_scheduler": (lr.state_dict()
                         if hasattr(lr, "state_dict") else None),
        "shard_specs": layout,
    }
    if weight_version is not None:
        out["__weight_version__"] = weight_version.to_dict()
    return out


@torch.no_grad()
def _copy_into(dst, src, what):
    """Copy a checkpoint tensor into a live one, bit for bit: the shape
    and the dtype must match."""
    src = torch.as_tensor(src)
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(
            f"checkpoint {what}: {src.dtype} {tuple(src.shape)} does not "
            f"match the live {dst.dtype} {tuple(dst.shape)}")
    dst.copy_(src)


def restore_train_state(state, params, opt_state, optimizer, layout=None):
    """Put a gather_train_state snapshot into the live train state: the
    params are copied in place (they are the layer's own tensors), the
    optimizer state's entries are replaced by device copies (an update
    may widen a moment past its initial dtype), and the step counter and
    the LR scheduler are restored. Key mismatches fail fast with names.
    A snapshot written under another layout (``shard_specs`` of a sharded
    or compressed writer) raises: cross-topology restore is not ported
    (one device)."""
    src = state.get("shard_specs")
    if src is not None and layout is not None and (
            src.get("mode") != layout["mode"] or src.get("sharded_keys")
            or src.get("qar_eligible")):
        raise NotImplementedError(
            f"restoring a checkpoint written under layout mode "
            f"{src.get('mode')!r} with sharded or quantized state is not "
            "ported yet (cross-topology resharding; the port runs on one "
            "device)")
    _validate_state_keys("params", state["params"], params)
    _validate_state_keys("opt_state", state["opt_state"], opt_state)
    for k, v in state["params"].items():
        _copy_into(params[k], v, f"params[{k!r}]")
    device = opt_state["__step__"].device
    for pname, st in state["opt_state"].items():
        if pname == "__step__":
            opt_state[pname] = torch.as_tensor(st).to(device, copy=True)
            continue
        _validate_state_keys(f"opt_state[{pname!r}]", st, opt_state[pname])
        opt_state[pname] = {k: torch.as_tensor(v).to(device, copy=True)
                            for k, v in st.items()}
    optimizer._step_count = int(state.get("optimizer_step_count", 0))
    lr = optimizer._lr
    if state.get("lr_scheduler") and hasattr(lr, "set_state_dict"):
        lr.set_state_dict(state["lr_scheduler"])
    return params, opt_state


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
        self._step_ms_sum = 0.0      # steps not under the FLOP counter
        self._counted_steps = 0      # steps run under the FLOP counter
        self._last_sig = None        # batch-sig label of the last step
        self._cost_entries = {}      # THIS trainer's sig -> cost entry
        self._step_span = None
        # weight-version lineage (framework/lineage.py): host metadata,
        # bumped each step and on restore, stamped into checkpoints
        self.weight_version = _lineage.WeightVersion(
            _lineage.new_run_id(), 0, "init")
        # goodput accountant (FLAGS_goodput), consumed at construction;
        # disarmed, every hook is one `is not None`
        self._goodput = None
        if _flags.get_flag("goodput", False):
            from ..monitor import goodput as _goodput

            _goodput.ensure_run(self.weight_version.run_id)
            self._goodput = _goodput
        # numerics telescope (FLAGS_numerics, read each step): the monitor
        # is created on the first armed fetch, so the plain path never
        # imports monitor/numerics.py
        self._numerics = None
        self._numerics_seen = 0            # armed steps so far
        self._numerics_last_device = None  # device-resident stats
        self._numerics_last_host = None    # cached fetch of the above
        self._numerics_old = None          # pre-update params (armed only):
        #                                    (flat fp32 buffer, param views)
        self._numerics_linear = None       # [out, in] Linear weight names
        # perf ledger (FLAGS_perf_ledger), consumed at construction; host
        # timings only, disarmed the hook is one `is not None`
        self._perf_ledger = None
        self._perf_cold = False            # this step saw a new batch sig
        self._seen_sigs = set()
        if _flags.get_flag("perf_ledger", False):
            from ..monitor import perfledger as _perfledger

            self._perf_ledger = _perfledger.get_ledger()

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
        # trainer/step window for the stall sentinel; a finished run
        # deactivates it instead of reading as stalled forever
        if self._goodput is not None:
            with self._goodput.bucket("step"), \
                    _blackbox.progress("trainer/step"):
                return self._train_step_impl(batch)
        with _blackbox.progress("trainer/step"):
            return self._train_step_impl(batch)

    def _train_step_impl(self, batch):
        _failpoints.failpoint("trainer/step")
        t_step = time.perf_counter()
        batch = [self._to_device(b) for b in batch]
        # value-transforming failpoint (scale:F): one boolean check when
        # nothing is armed
        batch = _failpoints.transform("trainer/batch", batch)
        sig = _batch_sig_label(batch)
        self._last_sig = sig
        if self._perf_ledger is not None:
            self._perf_cold = sig not in self._seen_sigs
            self._seen_sigs.add(sig)
        # the first step of each batch signature runs under the FLOP
        # counter while tracing (the reference records its compiled
        # step's cost analysis under the same condition)
        counter = _costs.count(self._device) \
            if _trace._ENABLED[0] and sig not in self._cost_entries \
            else None
        self._step_span = _trace.start_span(
            "train_step", subsystem="trainer", sig=sig,
            step=int(self.optimizer._step_count),
            guarded=bool(_flags.get_flag("check_nan_inf", False)),
            counted=counter is not None,
            weight_version=str(self.weight_version))
        try:
            with counter if counter is not None else \
                    contextlib.nullcontext():
                loss = self._step_body(batch)
        except BaseException:
            if self._step_span is not None:
                self._step_span.end(error=True)
                self._step_span = None
            raise
        if counter is not None:
            self._cost_entries[sig] = _costs.record(
                "trainer", sig, counter.flops, counter.bytes_accessed,
                counter.memory)
        # the params this step produced are a new weight state (a skipped
        # update included, as in the reference)
        self.weight_version = self.weight_version.bump("step")
        step_ms = (time.perf_counter() - t_step) * 1e3
        if _monitor.is_enabled():
            _STEP_MS.labels(site="trainer").observe(step_ms)
        self._step_count += 1
        if counter is not None:
            self._counted_steps += 1
        else:
            self._step_ms_sum += step_ms
        sp = self._step_span
        if sp is not None:
            sp.end(step_ms=step_ms)
            self._step_span = None
            _trace.add_counter_sample("trainer_step_ms", step_ms)
        if self._perf_ledger is not None:
            self._ledger_step(step_ms)
        return loss

    def _step_body(self, batch):
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
        nstats = None
        if _flags.get_flag("numerics", False):
            # on the RAW grads, before the guard and the optimizer's clip
            nstats = self._numerics_grad_leg(grads)
        elif self._numerics_old is not None:
            self._numerics_old = None        # disarmed: drop the copy
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
        if nstats is not None:
            self._numerics_note(self._numerics_update_leg(nstats, loss))
        for p in self.params.values():
            p.grad = None
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
        _SKIPPED.labels(reason="nonfinite").inc()
        if _trace.is_enabled():
            with _trace.span("guard/skip", subsystem="trainer",
                             step=int(self.optimizer._step_count)):
                pass
        max_skip = int(_flags.get_flag("max_skip_steps", 3))
        if self._nonfinite_streak > max_skip:
            raise FloatingPointError(
                f"train_step: non-finite loss/gradients for "
                f"{self._nonfinite_streak} consecutive steps "
                f"(> FLAGS_max_skip_steps={max_skip}); aborting — every "
                "skipped step left parameters and optimizer state "
                "untouched; inspect the data pipeline / learning rate")

    # -- numerics telescope (FLAGS_numerics) -----------------------------
    def _numerics_grad_leg(self, grads):
        """The gradient half of the step's stats, and the copy of the
        parameters the update half reads; nothing leaves the device."""
        from ..models.convert import linear_weights
        from ..monitor import numerics as _numerics

        names = sorted(self.params)
        params = [self.params[n] for n in names]
        if self._numerics_old is None:
            # one flat fp32 buffer and a view of it shaped as each param
            flat = torch.empty(sum(p.numel() for p in params),
                               dtype=torch.float32, device=self._device)
            self._numerics_old = (flat, [
                v.view(p.shape) for v, p in zip(
                    flat.split([p.numel() for p in params]), params)])
        flat, views = self._numerics_old
        with torch.no_grad():
            if all(p.dtype == torch.float32 for p in params):
                torch.cat([p.reshape(-1) for p in params], out=flat)
            else:
                torch._foreach_copy_(views, params)
        if self._numerics_linear is None:
            self._numerics_linear = linear_weights(self.layer)
        gs = [grads[n] if grads[n] is not None
              else torch.zeros_like(self.params[n]) for n in names]
        return _numerics._grad_stats(
            gs, [n in self._numerics_linear for n in names])

    def _numerics_update_leg(self, nstats, loss):
        from ..monitor import numerics as _numerics

        names = sorted(self.params)
        nstats.update(_numerics._update_stats(
            self._numerics_old[1], [self.params[n] for n in names]))
        return _numerics._with_loss(nstats, loss)

    def _numerics_note(self, nstats):
        """Bank the step's device-resident stats; fetch them to the host
        only every FLAGS_numerics_interval armed steps."""
        self._numerics_seen += 1
        self._numerics_last_device = nstats
        self._numerics_last_host = None
        interval = max(1, int(_flags.get_flag("numerics_interval", 1)))
        if self._numerics_seen % interval == 0:
            self.numerics_fetch()

    def numerics_fetch(self):
        """Fetch the latest on-device numerics stats to the host (one
        transfer), feed the drift detectors, and return the host dict
        (STAT_KEYS -> numpy arrays, rows in ``sorted(self.params)`` order)
        — or None when FLAGS_numerics never armed a step. Idempotent per
        step (the parity harness fetches after every step without
        observing twice); emits a ``numerics/fetch`` span."""
        if self._numerics_last_host is not None:
            return self._numerics_last_host
        nstats = self._numerics_last_device
        if nstats is None:
            return None
        from ..monitor import numerics as _numerics_mod

        if self._numerics is None:
            self._numerics = _numerics_mod.NumericsMonitor(
                sorted(self.params), source="trainer")

        def fetch():
            packed = torch.cat([v.reshape(-1) for v in nstats.values()])
            flat = packed.cpu().numpy()
            host, off = {}, 0
            for k, v in nstats.items():
                n = v.numel()
                host[k] = flat[off:off + n].reshape(tuple(v.shape))
                off += n
            return host

        with _trace.span("numerics/fetch", subsystem="trainer",
                         step=int(self.optimizer._step_count)):
            if _monitor.is_enabled():
                with _monitor.timed(_numerics_mod._metrics()["fetch_ms"]):
                    host = fetch()
            else:
                host = fetch()
        self._numerics_last_host = host
        # anomalies carry the OPTIMIZER step, the clock of the spans
        self._numerics.observe(host, step=int(self.optimizer._step_count))
        return host

    # -- perf ledger (FLAGS_perf_ledger) --------------------------------
    def _ledger_step(self, step_ms):
        """Armed-only per-step feed: the regression sentinel sees every
        step's wall ms and, with the step's FLOPs in the cost registry,
        its MFU; a JSONL row lands every FLAGS_perf_ledger_interval
        steps. The first step of a batch signature is recorded ``cold``
        and kept out of the baseline. Eager steps have no separate
        execution window or sync, so ``exec_ms`` is the step's wall ms
        and ``sync_ms`` 0."""
        m = {"step_ms": step_ms, "exec_ms": step_ms, "sync_ms": 0.0}
        if self._perf_cold:
            m["cold"] = 1
        entry = (self._cost_entries.get(self._last_sig)
                 or _costs.get("trainer", self._last_sig)
                 if self._last_sig else None)
        flops = entry.get("flops") if entry else None
        peak = _costs.peak_flops(self._device)
        if flops and step_ms and peak:
            m["mfu"] = float(flops) / ((step_ms / 1e3) * peak)
            m["flops_per_step"] = flops
        if entry and entry.get("bytes_accessed"):
            m["bytes_per_step"] = entry["bytes_accessed"]
        self._perf_ledger.on_step("trainer", m, sig=self._last_sig,
                                  mesh=f"device={self._device}",
                                  check=not self._perf_cold)

    # -- checkpoint / resume --------------------------------------------
    def _checkpoint_layout(self):
        """The ``shard_specs`` leaf: this trainer's one-device layout in
        the reference's form (pure data, so it pickles through
        framework/io.py)."""
        return {
            "v": 1,
            "mode": "plain",
            "ndp": 1,
            "dp_axis": None,
            "shard_update": False,
            "quantized": False,
            "sharding_stage": 0,
            "params": {k: {"shape": [int(d) for d in v.shape],
                           "size": int(v.numel())}
                       for k, v in self.params.items()},
            "shard_ps": {},
            "sharded_keys": {},
            "qar_eligible": [],
        }

    def state_dict(self):
        """Host-side checkpoint of the FULL train state — params, buffers,
        optimizer moments, step counters, LR-scheduler state, the layout
        and the weight version. ``framework.io.save(trainer.state_dict(),
        path)`` + ``set_state_dict(framework.io.load(path))`` resumes bit
        for bit."""
        state = gather_train_state(self.params, self.opt_state,
                                   self.optimizer,
                                   layout=self._checkpoint_layout(),
                                   weight_version=self.weight_version)
        state["buffers"] = {k: _host(v) for k, v in self.buffers.items()}
        return state

    def set_state_dict(self, state):
        """Restore a state_dict() checkpoint into the live tensors (on the
        trainer's device, in place). Key, shape or dtype mismatches fail
        fast with names. The restored ``__weight_version__`` (absent: a
        pre-version checkpoint, counter 0) re-joins this trainer's lineage
        at ``max(live, loaded) + 1`` with origin ``restore``."""
        with (self._goodput.bucket("ckpt_restore")
              if self._goodput is not None else contextlib.nullcontext()):
            restore_train_state(state, self.params, self.opt_state,
                                self.optimizer,
                                layout=self._checkpoint_layout())
            _validate_state_keys("buffers", state.get("buffers", {}),
                                 self.buffers)
            for k, v in state.get("buffers", {}).items():
                _copy_into(self.buffers[k], v, f"buffers[{k!r}]")
        loaded = _lineage.WeightVersion.from_dict(
            state.get("__weight_version__"),
            run_id=self.weight_version.run_id)
        self.weight_version = _lineage.WeightVersion(
            self.weight_version.run_id,
            max(self.weight_version.counter, loaded.counter) + 1,
            "restore")

    def stats(self):
        """Trainer observability snapshot: step counts and host wall time
        (no device sync) joined with the cost registry into an MFU
        estimate.

        ``mfu`` = the step's FLOPs (counted under ``site="trainer"`` for
        this batch signature, FLAGS_trace on) / (``step_ms_avg`` seconds ×
        ``costs.peak_flops()``); ``step_ms_total`` / ``step_ms_avg`` leave
        out the steps run under the FLOP counter. None until a step has
        run outside the counter and the registry holds this signature."""
        entry = (self._cost_entries.get(self._last_sig)
                 or _costs.get("trainer", self._last_sig)
                 if self._last_sig else None)
        n = self._step_count
        timed = n - self._counted_steps
        avg_ms = self._step_ms_sum / timed if timed else None
        flops = entry.get("flops") if entry else None
        peak = _costs.peak_flops(self._device)
        mfu = None
        if flops and avg_ms and peak:
            mfu = float(flops) / ((avg_ms / 1e3) * peak)
        return {
            "steps": n,
            "step_ms_total": self._step_ms_sum,
            "step_ms_avg": avg_ms,
            "batch_sig": self._last_sig,
            "flops_per_step": flops,
            "hbm": ({k: entry[k] for k in ("peak_bytes", "argument_bytes",
                                           "output_bytes", "temp_bytes")
                     if k in entry} if entry else None),
            "peak_flops": peak,
            "mfu": mfu,
            "breakdown": {
                "nonfinite_skipped_total": self._nonfinite_total,
                "nonfinite_streak": self._nonfinite_streak,
            },
            "device_memory": _costs.sample_device_memory(),
            # the numerics telescope's model-health snapshot (None until
            # FLAGS_numerics arms a fetch)
            "numerics": (self._numerics.snapshot()
                         if self._numerics is not None else None),
        }
