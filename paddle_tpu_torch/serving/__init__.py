"""Serving tier (ports paddle_tpu/serving/): the decode-model registry
that makes the engine model-agnostic, and the paged KV pool
(``FLAGS_paged_kv``). The router, the prefill/decode disaggregation and
the multi-LoRA adapter registry are not ported yet."""
from . import decode_model
from .decode_model import (DecodeModel, get_decode_model,
                           register_decode_model, registered_decode_models)
from .paging import PagePool, PagePoolFullError

__all__ = ["decode_model", "DecodeModel", "register_decode_model",
           "get_decode_model", "registered_decode_models", "PagePool",
           "PagePoolFullError"]
