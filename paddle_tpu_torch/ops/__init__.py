"""The port's operators: the hand-written kernels beside their plain
versions (`flash_attention`: flash-attention forward with dropout and its
backward, CUDA; `norm`: fused RMSNorm/LayerNorm forward and backward,
Triton; `moe_dispatch`: the MoE row gather and its routing indices,
CUDA), ring flash attention over the ring form of the flash kernels
(`ring_flash`), the attention-dropout keep mask (`dropout_mask`), the
cross-entropies (`cross_entropy`) and RoPE (`rope`)."""
