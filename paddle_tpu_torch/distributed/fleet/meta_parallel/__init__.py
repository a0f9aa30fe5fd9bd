"""meta_parallel for the port: ring and Ulysses attention
(`ring_attention`)."""
from .ring_attention import (RingFlashAttention, ring_flash_attention,
                             ulysses_attention)

__all__ = ["RingFlashAttention", "ring_flash_attention",
           "ulysses_attention"]
