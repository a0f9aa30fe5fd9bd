"""Models of the port."""
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,
                    ErnieLayer, ErnieModel, ErnieSelfAttention)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieForPretraining",
           "ErnieLayer", "ErnieModel", "ErnieSelfAttention",
           "LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel"]
