"""AMP autocast.

Ports paddle_tpu/amp/auto_cast.py: ``auto_cast`` / ``amp_guard``,
``amp_state`` and ``amp_dtype``. As in the reference, the context only
sets the amp state, and only two ops read it: ``nn.functional.linear``
(and so the ``nn.Linear`` layer) and ``tensor.matmul``, which cast their
floating inputs to the amp dtype. Every other op runs in its input dtype:
convolutions, BatchNorm, softmax, exp, log, reductions and the kernels of
ops/ (the reference's ``maybe_cast_inputs`` is called from nowhere). On
the GPT path that gives the Linear layers and the tied head in bf16 (so
q, k and v, the attention output and the logits are bf16), the residual
stream and LayerNorms in fp32, and the loss upcasting the logits itself;
on the detector's path everything stays fp32.

``auto_cast`` never enters ``torch.autocast``. ``disabled()`` turns off a
``torch.autocast`` that a caller may have entered around the port's code,
for the ops that must not be cast by it (the trainer's backward, the
kernel Functions of ops/, ``conv2d``, SDPA's naive path, the decode
math).

``level`` (``"O2"`` too) and the custom white and black lists are
stored in ``amp_state()`` beside the reference's ``white_list`` and
``black_list``, and read by nothing, as in the reference, where only
``amp_dtype()`` is read (``nn/functional/common.py`` and
``tensor/math.py``) and ``maybe_cast_inputs`` has no caller: they change
no dtype. ``amp.decorate(level="O2")`` is what casts a model's
parameters.
"""
import contextlib

import torch

# imperative/amp_auto_cast.cc's op lists, as the reference keeps them
white_list = {"matmul", "conv2d", "conv1d", "conv3d", "linear", "einsum",
              "bmm", "mm", "mv", "addmm"}
black_list = {"exp", "log", "softmax", "log_softmax", "cross_entropy",
              "mean", "sum", "cosh", "sinh", "softmax_with_cross_entropy"}

_STATE = {"enabled": False, "dtype": None, "level": "O1",
          "custom_white": set(), "custom_black": set()}

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


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Run the enclosed code with the amp state set: linear and matmul
    compute in `dtype`, every other op in its input dtype, whatever the
    level and lists (stored, not read). Nested contexts restore the outer
    state on exit."""
    d = _convert_dtype(dtype)
    old = dict(_STATE)
    _STATE.update(enabled=bool(enable), dtype=d, level=level,
                  custom_white=set(custom_white_list or ()),
                  custom_black=set(custom_black_list or ()))
    try:
        yield
    finally:
        _STATE.update(old)


amp_guard = auto_cast


def _device_types():
    return ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])


@contextlib.contextmanager
def disabled():
    """torch's autocast off on every device type, whatever encloses the
    block (``auto_cast`` itself enters none)."""
    with contextlib.ExitStack() as stack:
        for dev in _device_types():
            stack.enter_context(torch.autocast(device_type=dev,
                                               enabled=False))
        yield


def amp_dtype():
    return _STATE["dtype"] if _STATE["enabled"] else None


def cast_inputs(*ts):
    """The reference's cast in ``linear`` and ``matmul``: under an enabled
    auto_cast, when the first input is floating, every input becomes the
    amp dtype; otherwise inputs of two dtypes meet in their promoted one,
    as ``jnp.matmul`` promotes them."""
    d = amp_dtype()
    if d is None or not ts[0].is_floating_point():
        d = ts[0].dtype
        for t in ts[1:]:
            d = torch.promote_types(d, t.dtype)
    return tuple(t if t.dtype == d else t.to(d) for t in ts)
