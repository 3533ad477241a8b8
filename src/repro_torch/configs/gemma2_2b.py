"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [arXiv:2408.00118] local:global alternating (window 4096),
    # attn softcap 50, final logit softcap 30, post-block norms
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000, activation="geglu",
    attn_pattern=("local", "global"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    post_block_norms=True, embed_scale_by_dim=True,
)
