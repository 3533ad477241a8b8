"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [arXiv:2411.15242] Mamba2 backbone + shared attention blocks.
    # Shared block runs on concat(h, h) (2*d_model) with per-slot LoRA.
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=224,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_chunk=256,
    shared_attn_every=6, shared_lora_rank=128, tie_embeddings=True,
)
