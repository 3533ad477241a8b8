"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [hf:google/gemma-3-4b-pt] 5 local : 1 global, window 1024,
    # theta 1M global / 10k local, qk-norm, post-block norms
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144, activation="geglu",
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, rope_theta=1e6, rope_theta_local=1e4,
    qk_norm=True, post_block_norms=True, embed_scale_by_dim=True,
)
