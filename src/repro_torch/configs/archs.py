"""Aggregates the 10 assigned architecture configs (one module each —
exact published configs; see DESIGN.md §5 for sources/fidelity notes) and
the (arch × shape) cell table for the dry-run."""

from __future__ import annotations

from .base import SHAPES, ModelConfig
from .deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE
from .gemma2_2b import CONFIG as GEMMA2_2B
from .gemma3_4b import CONFIG as GEMMA3_4B
from .gemma_2b import CONFIG as GEMMA_2B
from .glm4_9b import CONFIG as GLM4_9B
from .hubert_xlarge import CONFIG as HUBERT_XLARGE
from .mamba2_780m import CONFIG as MAMBA2_780M
from .paligemma_3b import CONFIG as PALIGEMMA_3B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from .zamba2_7b import CONFIG as ZAMBA2_7B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (
    HUBERT_XLARGE, ZAMBA2_7B, MAMBA2_780M, QWEN3_MOE_235B, DEEPSEEK_V2_LITE,
    PALIGEMMA_3B, GLM4_9B, GEMMA3_4B, GEMMA_2B, GEMMA2_2B,
)}

# which of the four shapes each arch skips (DESIGN.md §5):
#  - encoder-only: no autoregressive decode
#  - pure full-attention archs skip long_500k (needs sub-quadratic attn)
SKIPS: dict[str, dict[str, str]] = {
    "hubert-xlarge": {"decode_32k": "encoder-only: no decode step",
                      "long_500k": "encoder-only: no decode step"},
    "qwen3-moe-235b-a22b": {"long_500k": "pure full attention"},
    "deepseek-v2-lite-16b": {"long_500k": "pure full attention"},
    "glm4-9b": {"long_500k": "pure full attention"},
    "gemma-2b": {"long_500k": "pure full attention (MQA)"},
    "paligemma-3b": {"long_500k": "pure full attention"},
}


def cells() -> list[tuple[str, str]]:
    """All runnable (arch, shape) dry-run cells (33 of the 40)."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            if shape not in SKIPS.get(arch, {}):
                out.append((arch, shape))
    return out
