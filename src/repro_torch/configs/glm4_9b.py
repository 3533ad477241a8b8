"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [hf:THUDM/glm-4-9b] RoPE, GQA kv=2
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=151552, rope_theta=1e4, tie_embeddings=False,
)
