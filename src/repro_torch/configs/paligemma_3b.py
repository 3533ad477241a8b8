"""Assigned architecture config — see DESIGN.md §5 for source notes."""

from .base import ModelConfig

CONFIG = ModelConfig(
    # [arXiv:2407.07726] gemma-2b text backbone + SigLIP stub (patch
    # embeddings provided by input_specs); prefix-LM mask over patches
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, activation="geglu",
    embed_scale_by_dim=True, frontend="patch_stub", n_patches=256,
)
