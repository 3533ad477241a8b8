"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [hf:Qwen/Qwen3-235B-A22B] 128 experts top-8, GQA kv=4, qk-norm
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, d_ff_expert=1536, vocab=151936,
    n_experts=128, top_k=8, qk_norm=True, rope_theta=1e6,
    tie_embeddings=False,
)
