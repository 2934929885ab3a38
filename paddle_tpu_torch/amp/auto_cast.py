"""AMP autocast.

Ports paddle_tpu/amp/auto_cast.py: ``auto_cast`` / ``amp_guard``,
``amp_state`` and ``amp_dtype``. Under the reference's autocast only two
ops read the amp state, ``linear`` and ``matmul``: they cast their
floating inputs to the amp dtype, and every other op runs in its input
dtype (convolutions included; the reference's ``maybe_cast_inputs`` is
called from nowhere). The port keeps no op lists: here the context
enters ``torch.autocast`` for the CPU and, when there is one, the CUDA
device, so a tensor is cast by the autocast of the device it lies on,
and torch's autocast casts every op on torch's own lists. So each ported
op on those lists other than linear/matmul runs with autocast off
(``disabled()``) to keep the reference's semantics: ``nn.functional.
conv2d`` does, and so do the kernel Functions of ops/ (flash attention,
TPP), which run in the dtype they are handed. On the GPT path that gives
the reference's semantics: the Linear layers and the tied head run in
bf16 (so q, k and v, the attention output and the logits are bf16), the
residual stream and LayerNorms stay fp32 and the loss upcasts the logits
itself; on the detector's path everything stays fp32. The ops still to be
ported that torch's lists name (bmm, baddbmm, conv1d/3d, softplus, exp,
log, ...) are listed in ROADMAP.md's Queue 3.

``level="O2"`` and custom white/black lists are not ported yet and raise
NotImplementedError.
"""
import contextlib

import torch

_STATE = {"enabled": False, "dtype": None}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def amp_state():
    return _STATE


def _convert_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    if dtype not in _DTYPES:
        raise ValueError(f"auto_cast dtype must be bfloat16 or float16, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


def _device_types():
    return ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Run the enclosed ops under mixed precision: linear/matmul in
    `dtype`, the ported ops in their input dtype. Nested contexts restore
    the outer state on exit."""
    if level != "O1":
        raise NotImplementedError(f"auto_cast(level={level!r}) is not ported "
                                  "yet (O1 only)")
    if custom_white_list or custom_black_list:
        raise NotImplementedError("auto_cast custom white/black lists are "
                                  "not ported yet")
    d = _convert_dtype(dtype)
    old = dict(_STATE)
    _STATE.update(enabled=bool(enable), dtype=d)
    try:
        with contextlib.ExitStack() as stack:
            for dev in _device_types():
                stack.enter_context(torch.autocast(
                    device_type=dev, dtype=d, enabled=bool(enable)))
            yield
    finally:
        _STATE.update(old)


amp_guard = auto_cast


@contextlib.contextmanager
def disabled():
    """Autocast off on every device type, whatever encloses the block. The
    trainer's backward runs under it (gradients take the dtypes the
    forward chose, as the reference's vjp does), and so do the kernel
    Functions of ops/ and their plain versions, which compute in fp32
    whatever an enclosing autocast says, and ``conv2d``, which the
    reference's auto_cast never casts."""
    with contextlib.ExitStack() as stack:
        for dev in _device_types():
            stack.enter_context(torch.autocast(device_type=dev,
                                               enabled=False))
        yield


def amp_dtype():
    return _STATE["dtype"] if _STATE["enabled"] else None
