"""Model + run configuration (a copy of the JAX package's, data only).

One ``ModelConfig`` describes every assigned architecture; family-specific
fields are zero/empty when unused. ``ShapeConfig`` is one of the four
assigned input shapes. ``reduced()`` produces the CPU smoke-test variant
of any config (same family/topology, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    activation: str = "swiglu"       # swiglu | geglu | gelu
    # attention layout
    attn_pattern: tuple[str, ...] = ("global",)   # cycled; entries: global|local
    window: int = 0
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    attn_scale: float | None = None               # None -> head_dim**-0.5
    causal: bool = True                           # False: encoder (bidirectional)
    embed_scale_by_dim: bool = False              # gemma family
    post_block_norms: bool = False                # gemma2/3 post-attn/-mlp norms
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / zamba2 backbone)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    # hybrid (zamba2): shared transformer block applied every k ssm layers
    shared_attn_every: int = 0
    shared_lora_rank: int = 0
    # frontends
    frontend: str = "token"          # token | patch_stub | frame_stub
    n_patches: int = 0               # vlm: image patches prepended
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # execution
    remat: str = "full"              # full | dots | none
    # accepted and ignored by the port: its model always calls the
    # kernels' guarded entry points (repro_torch.kernels.ops), which
    # launch on a CUDA tensor and run the plain version on a CPU one
    attn_backend: str = "xla"        # xla | pallas

    # ---- derived -------------------------------------------------------
    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kinds(self) -> list[str]:
        """Per-layer kind list. Kinds: dense_global / dense_local /
        moe_global (moe ffn w/ global attn) / ssm / etc."""
        kinds: list[str] = []
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid"):
                kinds.append("ssm")
            elif self.family == "moe":
                if i < self.first_dense_layers:
                    kinds.append("dense_global")
                else:
                    kinds.append("moe_global")
            else:
                attn = self.attn_pattern[i % len(self.attn_pattern)]
                kinds.append(f"dense_{attn}")
        return kinds

    def repeat_structure(self) -> tuple[list[str], int, list[str], list[str]]:
        """(prologue, n_repeats, unit, tail): layers = prologue + unit ×
        n_repeats + tail, where `unit` is the smallest homogeneous repeat
        group — the lax.scan body in the model assembly."""
        kinds = self.layer_kinds()
        prologue: list[str] = []
        if self.family == "moe" and self.first_dense_layers:
            prologue = kinds[:self.first_dense_layers]
            kinds = kinds[self.first_dense_layers:]
        unit_len = len(self.attn_pattern) if self.family not in ("ssm", "hybrid") else 1
        if self.family in ("ssm", "hybrid") and self.shared_attn_every:
            unit_len = self.shared_attn_every
        n_rep = len(kinds) // unit_len
        unit = kinds[:unit_len]
        tail = kinds[n_rep * unit_len:]
        # verify homogeneity of the repetition
        assert kinds[:n_rep * unit_len] == unit * n_rep, \
            f"{self.name}: pattern {unit} does not tile {len(kinds)} layers"
        return prologue, n_rep, unit, tail

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
SHAPES: dict[str, ShapeConfig] = {s.name: s for s in
                                  (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-topology variant for CPU smoke tests."""
    kw: dict = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        vocab=min(cfg.vocab, 256) or 0,
        rope_theta=cfg.rope_theta,
        window=min(cfg.window, 16) if cfg.window else 0,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
                  head_dim=16, d_ff=128)
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), d_ff_expert=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  n_layers=3 if cfg.first_dense_layers else 2)
    if cfg.kv_lora_rank:
        kw.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16, head_dim=0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
    if cfg.shared_attn_every:
        kw.update(shared_attn_every=2, n_layers=4, shared_lora_rank=4)
    if cfg.family in ("dense", "encoder", "vlm") and len(cfg.attn_pattern) > 1:
        # keep the local:global pattern but make it tile the reduced depth
        kw.update(n_layers=2 * len(cfg.attn_pattern))
    if cfg.n_patches:
        kw.update(n_patches=4)
    return cfg.replace(**kw)
