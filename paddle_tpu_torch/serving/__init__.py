"""Serving tier (ports paddle_tpu/serving/): the decode-model registry
that makes the engine model-agnostic, the paged KV pool
(``FLAGS_paged_kv``) with its multi-LoRA adapter registry, the
prefill/decode disaggregation (``disagg``) and the front-door ``Router``
over named engines (``router``, loaded lazily as in the reference: a
process that never routes never imports it)."""
from . import decode_model, disagg
from .decode_model import (DecodeModel, get_decode_model,
                           register_decode_model, registered_decode_models)
from .disagg import DisaggregatedPool, PrefillWorker
from .paging import AdapterRegistry, PagePool, PagePoolFullError

__all__ = ["decode_model", "disagg", "DecodeModel", "register_decode_model",
           "get_decode_model", "registered_decode_models", "PagePool",
           "PagePoolFullError", "AdapterRegistry", "PrefillWorker",
           "DisaggregatedPool", "Router", "NoLiveEngineError"]


def __getattr__(name):   # PEP 562: the router loads on first use
    if name in ("Router", "NoLiveEngineError", "router"):
        import importlib

        mod = importlib.import_module(".router", __name__)
        return mod if name == "router" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
