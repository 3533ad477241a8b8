"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [arXiv:2405.21060] SSD; attn-free
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_chunk=256,
)
