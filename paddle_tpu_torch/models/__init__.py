"""Models of the port, and static-cache generation."""
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,
                    ErnieLayer, ErnieModel, ErnieSelfAttention)
from .generation import generate, init_caches
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)
from .t5 import (T5Attention, T5Config, T5DecoderLayer, T5EncoderLayer,
                 T5ForConditionalGeneration, T5LayerFF, T5Model)

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieForPretraining",
           "ErnieLayer", "ErnieModel", "ErnieSelfAttention",
           "generate", "init_caches",
           "GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion",
           "LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel",
           "T5Attention", "T5Config", "T5DecoderLayer", "T5EncoderLayer",
           "T5ForConditionalGeneration", "T5LayerFF", "T5Model"]
