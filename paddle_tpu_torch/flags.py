"""Global flag registry.

Ports paddle_tpu/flags.py: the same define_flag / get_flag / set_flags /
get_flags semantics (FLAGS_xxx environment seeding, an error on a
conflicting re-definition, provisional entries made by set_flags before a
flag is defined), with only the flags the ported serving and training
paths read.
"""
import os

_REGISTRY = {}


def define_flag(name, default, help_str=""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    existing = _REGISTRY.get(name)
    if existing is not None:
        # two definitions disagreeing about the default would be resolved
        # by import order; an entry set_flags() made before the definition
        # ("provisional") is adopted instead
        if not existing.get("provisional") \
                and repr(existing["default"]) != repr(default):
            raise ValueError(
                f"FLAGS_{name} re-defined with default {default!r} but "
                f"an earlier define_flag said {existing['default']!r} — "
                "conflicting defaults would be resolved by import order; "
                "one definition must own the default")
        # a value set before the defining module loaded wins
        value = existing["value"]
        if not help_str:
            help_str = existing["help"]
    _REGISTRY[name] = {"value": value, "default": default, "help": help_str}
    return value


def set_flags(flags):
    """Set flags by name (with or without the FLAGS_ prefix)."""
    for k, v in flags.items():
        k = k[6:] if k.startswith("FLAGS_") else k
        if k not in _REGISTRY:
            _REGISTRY[k] = {"value": v, "default": v, "help": "",
                            "provisional": True}
        else:
            _REGISTRY[k]["value"] = v


def get_flags(names):
    """Current values of the named flags, keyed as asked."""
    if isinstance(names, str):
        names = [names]
    out = {}
    for k in names:
        key = k[6:] if k.startswith("FLAGS_") else k
        if key in _REGISTRY:
            out[k] = _REGISTRY[key]["value"]
    return out


def get_flag(name, default=None):
    e = _REGISTRY.get(name)
    return e["value"] if e else default


define_flag("tpp_kernels", False,
            "route each GPT block's ln2 + MLP through the TPP matmul "
            "kernel (ops/tpp.py): the layernorm-prologue matmul for "
            "ln2 + fc1, and the gelu-on-load + bias matmul for fc2. Read "
            "on every forward in models/gpt.py")
define_flag("flash_attention_block", 0,
            "force the flash-attention block size (128/256/512) that "
            "ops/flash_attention.py _block_for reports; 0 = auto (largest "
            "of 512/256/128 dividing seq)")
define_flag("check_nan_inf", False,
            "scan op outputs for NaN/Inf (flags.cc:44); SpmdTrainer builds "
            "its step with an on-device loss/grad finiteness check and "
            "SKIPS the update on a non-finite step (docs/ROBUSTNESS.md)")
define_flag("max_skip_steps", 3,
            "with FLAGS_check_nan_inf: how many CONSECUTIVE non-finite "
            "train steps may be skipped before train_step raises "
            "FloatingPointError (a transient loss spike recovers; a "
            "diverged run fails loudly)")
define_flag("paged_kv", False,
            "paged KV cache for the continuous-batching ServingEngine "
            "(serving/paging.py): the dense [max_batch, max_seq] cache is "
            "replaced by a pool of fixed-size frames with per-slot block "
            "tables, whole-budget reservation at admission "
            "(PagePoolFullError requeues the request), refcounted "
            "shared-prefix frames with copy-on-write boundary blocks, and "
            "int8 cold pages (page_cold_steps=). Read at ENGINE "
            "CONSTRUCTION; disarming it under a live paged engine raises "
            "at the next step")
