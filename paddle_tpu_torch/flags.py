"""Global flag registry.

Ports paddle_tpu/flags.py: the same define_flag / get_flag / set_flags /
get_flags semantics (FLAGS_xxx environment seeding, an error on a
conflicting re-definition, provisional entries made by set_flags before a
flag is defined), with only the flags the ported serving and training
paths read. As in the reference, the runtime services define their own
flags where they live (``monitor``, ``trace``, ``testing.failpoints``,
``trace.costs``, ``monitor.blackbox``, ``monitor.numerics``); the master
switches ``goodput``, ``blackbox``, ``numerics`` and ``perf_ledger`` (and
the ledger's knobs) are defined here so that hook sites can read them
without importing the module they arm.

Flags of modules not ported yet are refused: ``set_flags`` raises
NotImplementedError when one of them is set to a true value. Only
``jit_cache_dir`` is left (framework/aot.py).
"""
import os

_REGISTRY = {}

#: flags whose module is not ported yet -> what is missing
NOT_PORTED = {
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
            "flag read. With FLAGS_perf_ledger also armed, each finished "
            "run appends a site=run/goodput ledger row")
define_flag("goodput_stall_s", 2.0,
            "with FLAGS_goodput: an unattributed gap (no bucket active) "
            "at least this many seconds books as `stall`; shorter gaps "
            "book as `other` (loop/bookkeeping overhead)")
define_flag("numerics", False,
            "numerics telescope (monitor/numerics.py): SpmdTrainer adds ONE "
            "batched on-device per-layer tensor-health aggregation to each "
            "step (grad/param norms, update ratio, non-finite counts, "
            "quantile digest) feeding drift detectors; unset, the train "
            "step is bit-identical to the un-instrumented one and the "
            "module is never imported")
define_flag("numerics_interval", 1,
            "with FLAGS_numerics: fetch the on-device stats to the host "
            "every N train steps (the stats stay on the device between "
            "fetches: no new per-step host sync)")
define_flag("blackbox", False,
            "black-box flight recorder on/off (monitor/blackbox.py): "
            "progress beacons, the bounded event ring, the stall sentinel "
            "and dump bundles; off turns every beacon()/note() call site "
            "into one boolean check and monitor/blackbox.py is never "
            "imported")
define_flag("perf_ledger", False,
            "persistent perf ledger (monitor/perfledger.py): trainer, "
            "engine and goodput-run telemetry (step wall ms, MFU, cost-"
            "registry FLOPs and bytes, latency digests) appended as "
            "environment-fingerprinted JSONL rows to FLAGS_perf_ledger_"
            "path, with an EMA/sigma regression sentinel firing "
            "perf_regression_total{site,metric}. Host-side timings only: "
            "armed and disarmed runs train bit-identically. Unset, the "
            "module is never imported and every hook is one boolean check")
define_flag("perf_ledger_path", "",
            "with FLAGS_perf_ledger: path of the append-only JSONL ledger "
            "(one write + flush + fsync a row; readers skip a torn tail). "
            "Empty = rows are kept in-process only")
define_flag("perf_ledger_sigma", 4.0,
            "with FLAGS_perf_ledger: regression threshold, in EMA standard "
            "deviations on the bad side of a (site, metric) baseline")
define_flag("perf_ledger_warmup", 5,
            "with FLAGS_perf_ledger: observations of a (site, metric) "
            "series before the sentinel may fire")
define_flag("perf_ledger_interval", 1,
            "with FLAGS_perf_ledger: append a ledger row every N "
            "observations per site (the sentinel sees every one)")
define_flag("jit_cache_dir", "",
            f"not ported yet: needs {NOT_PORTED['jit_cache_dir']}")
