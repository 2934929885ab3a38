"""Model zoo (ports paddle_tpu/models/): GPT serving and training."""
from .convert import opt_state_from_jax, params_from_jax
from .gpt import GPTConfig, GPTForCausalLM, GPTPretrainLoss

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainLoss",
           "opt_state_from_jax", "params_from_jax"]
