"""The port's operators: the hand-written kernels beside their plain
versions (`flash_attention`: flash-attention forward, CUDA; `norm`: fused
RMSNorm/LayerNorm forward, Triton) and RoPE (`rope`)."""
