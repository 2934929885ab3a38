"""The decode-model interface: what a model must provide to be served.

Ports paddle_tpu/serving/decode_model.py. The continuous-batching
``ServingEngine`` (inference/serving.py) is model-agnostic: it drives a
model through the :class:`DecodeModel` adapter registered for its family
(``register_decode_model``), resolved by name or by asking each adapter
whether it ``matches`` the model (``resolve``).

The protocol:

``check_config(cfg)``
    Reject configs the decode math cannot serve. Raises ``ValueError``.
``compute_dtype(dtype)``
    Map a user dtype to the decode compute dtype (``None`` = fp32).
``extract_params(model, who)``
    ``(params, aux)``: a flat ``{name: tensor}`` snapshot and adapter
    state handed back to :meth:`decode_fns`.
``decode_fns(cfg, aux, cache_dtype=None, tp_axis=None, tp_size=1)``
    The decode math ``(fwd, logits_of, cache_init)``:

    - ``cache_init(b, T, dtype, device) -> (kc, vc)``, each
      ``[L, b, KVh, T, hd]``; row 0..b-1 is one slot;
    - ``fwd(params, tok_ids [B, t], pos, kc, vc, lora=None,
      adapter_ids=None) -> x``: run the stack, writing K/V at column(s)
      ``pos`` (an int, or a [B] tensor of per-row columns) INTO kc/vc in
      place (the reference returns new caches); ``lora`` / ``adapter_ids``
      (paged engines) add each row's adapter delta;
    - ``logits_of(params, x_last) -> logits``.
``tp_setup`` / ``tp_wrap``
    Tensor-parallel serving; not ported (they raise).
``cache_spec(cfg)``
    A description of the cache pair (layout, axes, quantized or not).
``lora_init(cfg, n_slots, rank, dtype=None, device=None)``, ``lora_pack``
    Multi-LoRA batched decode: the zeroed stacked factors of n_slots
    adapters (on ``device``: ``cuda`` unless the caller passes another),
    and one exported adapter laid out as one slot of them (the
    base class raises: the engine then serves base requests only).
``matches(model)``
    True when this adapter serves ``model`` (used by :func:`resolve`).

The adapter delegates to the model module's decode helpers and never
re-implements the math, so an engine's outputs equal those helpers'.
``cache_row_bytes``, ``cache_map``, ``cache_leaves`` and ``cast_params``
are the helpers the engine and the model modules share for cache sides
and param snapshots.
"""
import importlib

__all__ = ["DecodeModel", "register_decode_model", "get_decode_model",
           "registered_decode_models", "resolve", "cache_row_bytes",
           "cache_map", "cache_leaves", "cast_params"]


class DecodeModel:
    """Base adapter; subclasses implement the protocol of the module
    docstring. ``name`` is the registry key."""

    name = None

    def check_config(self, cfg):
        raise NotImplementedError

    def compute_dtype(self, dtype):
        raise NotImplementedError

    def extract_params(self, model, who):
        raise NotImplementedError

    def decode_fns(self, cfg, aux, cache_dtype=None, tp_axis=None,
                   tp_size=1):
        raise NotImplementedError

    def matches(self, model):
        raise NotImplementedError

    def tp_setup(self, tp_mesh, cfg, params):
        raise NotImplementedError(
            f"decode model {self.name!r} does not support tensor-parallel "
            "serving")

    def tp_wrap(self, run, tp_mesh, tp_specs, n_extra_in, out_specs,
                in_specs=None, donate=()):
        raise NotImplementedError(
            f"decode model {self.name!r} does not support tensor-parallel "
            "serving")

    def cache_spec(self, cfg):
        """Default spec: an opaque pair, described minimally."""
        return {"kind": "kv_pair", "layout": "adapter-defined",
                "quantized": None}

    def lora_init(self, cfg, n_slots, rank, dtype=None, device=None):
        raise NotImplementedError(
            f"decode model {self.name!r} does not support multi-LoRA "
            "serving")

    def lora_pack(self, cfg, exported, rank):
        raise NotImplementedError(
            f"decode model {self.name!r} does not support multi-LoRA "
            "serving")


# name -> DecodeModel instance. Model modules register themselves at
# import; _LAZY lets the engine resolve a bundled family before the caller
# has imported its module.
_REGISTRY = {}
_LAZY = {"gpt": "paddle_tpu_torch.models.gpt"}


def register_decode_model(adapter, clobber=False):
    """Register a :class:`DecodeModel` instance under ``adapter.name``.
    Re-registering a name raises unless ``clobber=True`` (a silent
    overwrite could swap the serving math under a live engine)."""
    name = getattr(adapter, "name", None)
    if not name:
        raise ValueError("decode-model adapter needs a non-empty .name")
    if name in _REGISTRY and not clobber:
        raise ValueError(
            f"decode model {name!r} is already registered "
            f"({type(_REGISTRY[name]).__name__}); pass clobber=True to "
            "replace it")
    _REGISTRY[name] = adapter
    return adapter


def _materialize(name):
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name])   # the module registers itself
    return _REGISTRY.get(name)


def get_decode_model(name):
    """The registered adapter for ``name`` (a bundled family's module is
    imported on demand). Raises ``KeyError`` naming the known ones."""
    adapter = _materialize(name)
    if adapter is None:
        known = sorted(set(_REGISTRY) | set(_LAZY))
        raise KeyError(
            f"no decode model registered under {name!r}; known: {known}")
    return adapter


def registered_decode_models():
    """Tuple of registered names (bundled lazy families included)."""
    return tuple(sorted(set(_REGISTRY) | set(_LAZY)))


def resolve(model, spec=None):
    """The adapter serving ``model``: ``spec`` may be a registry name, a
    DecodeModel instance, or None (ask every adapter's ``matches``)."""
    if isinstance(spec, DecodeModel):
        return spec
    if spec is not None:
        return get_decode_model(spec)
    for name in registered_decode_models():
        adapter = _materialize(name)
        if adapter is not None and adapter.matches(model):
            return adapter
    raise TypeError(
        f"no registered decode model serves {type(model).__name__}; "
        f"known: {sorted(registered_decode_models())} — register a "
        "DecodeModel adapter (see paddle_tpu_torch/serving/decode_model.py) "
        "or pass decode_model= explicitly")


def cache_row_bytes(row):
    """Total bytes of a cache pytree: a tensor, or a (nested) tuple or
    list of tensors (a (kc, vc) pair, one side)."""
    if isinstance(row, (tuple, list)):
        return sum(cache_row_bytes(x) for x in row)
    return int(row.numel() * row.element_size())


def cache_map(f, c):
    """f over a cache side: a tensor, or a quantized (values, scales)
    tuple."""
    return tuple(f(x) for x in c) if isinstance(c, tuple) else f(c)


def cache_leaves(c):
    """A cache side's tensors: itself, or its (values, scales)."""
    return c if isinstance(c, tuple) else (c,)


def cast_params(params, dtype):
    """Serving precision: a param snapshot's floating tensors cast to
    `dtype` (None = fp32: unchanged)."""
    if dtype is None:
        return params
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}
