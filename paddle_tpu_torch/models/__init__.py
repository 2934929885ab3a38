"""Model zoo (ports paddle_tpu/models/): GPT serving and training, and
the weight converters (the detector lives in ``vision.models``)."""
from .convert import opt_state_from_jax, params_from_jax, \
    ppyoloe_params_from_jax
from .gpt import GPTConfig, GPTForCausalLM, GPTPretrainLoss

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainLoss",
           "opt_state_from_jax", "params_from_jax", "ppyoloe_params_from_jax"]
