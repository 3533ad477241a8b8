"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [arXiv:2106.07447] encoder-only (w2v2 arch); frame frontend stubbed
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, activation="gelu", causal=False,
    frontend="frame_stub", tie_embeddings=False,
)
