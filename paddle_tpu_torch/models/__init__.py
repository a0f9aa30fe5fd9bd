"""Models of the port."""
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,
                    ErnieLayer, ErnieModel, ErnieSelfAttention)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)
from .t5 import (T5Attention, T5Config, T5DecoderLayer, T5EncoderLayer,
                 T5ForConditionalGeneration, T5LayerFF, T5Model)

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieForPretraining",
           "ErnieLayer", "ErnieModel", "ErnieSelfAttention",
           "LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel",
           "T5Attention", "T5Config", "T5DecoderLayer", "T5EncoderLayer",
           "T5ForConditionalGeneration", "T5LayerFF", "T5Model"]
