"""Global flag registry.

Ports paddle_tpu/flags.py: the same define_flag / get_flag / set_flags /
get_flags semantics (FLAGS_xxx environment seeding, an error on a
conflicting re-definition, provisional entries made by set_flags before a
flag is defined), with only the flags the ported serving and training
paths read. As in the reference, the runtime services define their own
flags where they live (``monitor``, ``trace``, ``testing.failpoints``,
``trace.costs``); ``goodput`` is defined here so that hook sites can read
it without importing monitor/goodput.py.

Flags of modules not ported yet are refused: ``set_flags`` raises
NotImplementedError when one of them is set to a true value (and the
monitor package raises at import when the environment arms one).
"""
import os

_REGISTRY = {}

#: flags whose module is not ported yet -> what is missing
NOT_PORTED = {
    "blackbox": "monitor/blackbox.py (the flight recorder)",
    "numerics": "monitor/numerics.py (the numerics telescope)",
    "perf_ledger": "monitor/perfledger.py (the perf ledger)",
    "jit_cache_dir": "framework/aot.py (the persistent AOT compile cache)",
}


def refuse_unported(name, value):
    """Raise NotImplementedError when `value` arms a flag of a module that
    is not ported yet."""
    if value and name in NOT_PORTED:
        raise NotImplementedError(
            f"FLAGS_{name} is not ported yet (it needs "
            f"{NOT_PORTED[name]})")


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
        refuse_unported(k, v)
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
define_flag("async_dispatch", False,
            "double-buffered step dispatch: ServingEngine.step overlaps "
            "admission/bookkeeping for the next round with the current "
            "round's device compute (enqueue the decode, admit, then read "
            "the tokens). Read at ENGINE CONSTRUCTION; speculative and "
            "paged engines keep the synchronous step. The trainer half "
            "(SpmdTrainer's lazy StepHandle) is not ported: SpmdTrainer "
            "raises NotImplementedError at construction while it is set")
define_flag("goodput", False,
            "goodput ledger + weight-version lineage metrics "
            "(monitor/goodput.py): a per-run wall-clock accountant "
            "classifies every second into exclusive buckets {step, "
            "compile, ckpt_save, ckpt_restore, reshard, resume_backoff, "
            "stall, edge_wait, other} via hooks in the trainer's step, "
            "framework/io, CheckpointSaver and set_state_dict — published "
            "as goodput_seconds_total{bucket} + goodput_fraction. Also "
            "gates the serving lineage families (serving_weight_version / "
            "serving_stale_sessions_total). Host-side accounting only: "
            "armed and disarmed runs train bit-identically. Unset, "
            "monitor/goodput.py is never imported and every hook is one "
            "flag read. The reference's perf-ledger row per run is not "
            "ported (FLAGS_perf_ledger raises)")
define_flag("goodput_stall_s", 2.0,
            "with FLAGS_goodput: an unattributed gap (no bucket active) "
            "at least this many seconds books as `stall`; shorter gaps "
            "book as `other` (loop/bookkeeping overhead)")
for _name in NOT_PORTED:
    define_flag(_name, "" if _name == "jit_cache_dir" else False,
                f"not ported yet: needs {NOT_PORTED[_name]}")
