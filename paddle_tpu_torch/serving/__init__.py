"""Serving tier (ports paddle_tpu/serving/): the decode-model registry
that makes the engine model-agnostic, the paged KV pool
(``FLAGS_paged_kv``) with its multi-LoRA adapter registry, and the
prefill/decode disaggregation (``disagg``). The router is not ported
yet."""
from . import decode_model, disagg
from .decode_model import (DecodeModel, get_decode_model,
                           register_decode_model, registered_decode_models)
from .disagg import DisaggregatedPool, PrefillWorker
from .paging import AdapterRegistry, PagePool, PagePoolFullError

__all__ = ["decode_model", "disagg", "DecodeModel", "register_decode_model",
           "get_decode_model", "registered_decode_models", "PagePool",
           "PagePoolFullError", "AdapterRegistry", "PrefillWorker",
           "DisaggregatedPool"]
