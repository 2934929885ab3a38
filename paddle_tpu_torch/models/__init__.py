"""Model zoo (ports paddle_tpu/models/): GPT serving and training, BERT
pretraining, and the weight converters (the detector, ResNet and LeNet
live in ``vision.models``)."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining, BertModel,
                   BertPretrainLoss)
from .convert import (linear_weights, opt_state_from_jax, params_from_jax,
                      ppyoloe_params_from_jax, state_from_jax)
from .gpt import GPTConfig, GPTForCausalLM, GPTPretrainLoss

__all__ = ["BertConfig", "BertEmbeddings", "BertForPretraining", "BertModel",
           "BertPretrainLoss", "GPTConfig", "GPTForCausalLM",
           "GPTPretrainLoss", "linear_weights", "opt_state_from_jax",
           "params_from_jax", "ppyoloe_params_from_jax", "state_from_jax"]
