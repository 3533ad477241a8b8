"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [arXiv:2405.04434] MLA kv_lora=512; 64 routed top-6 + 2 shared;
    # first layer dense (d_ff=10944)
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, d_ff_expert=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, first_dense_layers=1,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    tie_embeddings=False,
)
