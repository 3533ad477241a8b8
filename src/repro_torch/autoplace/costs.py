"""Cost extraction: the model stack's compute/bytes profile as MPAHA terms.

The scheduler side of the port consumes ``Subtask`` exec times (seconds,
per processor type) and ``CommEdge`` volumes (bytes); the model side
produces FLOPs and activation shapes. This module is the converter, as
the reference's ``autoplace/costs.py``:

* per-repeat-unit FLOP / HBM-byte terms, from two sources —
  ``source="counted"`` runs ONE repeat unit of the config on fake CPU
  tensors (no allocation, nothing computed) and reads the matmul FLOPs
  and the traffic proxy that
  :func:`repro_torch.launch.op_analysis.analyze_call` counts from its
  aten ops; ``source="analytic"`` uses closed-form matmul counts from
  the config dims, the reference's own expressions, so it equals the
  reference's bit for bit. The reference's ``source="hlo"`` compiles the
  unit and parses its HLO; eager PyTorch has no HLO, so ``"counted"``
  takes its place and ``"hlo"`` is refused;
* per-MoE-expert FLOPs from the routed load (tokens/expert × expert FFN
  matmuls) — always analytic: the one-device MoE path, ``moe_dense``,
  computes every expert on every token, so the counted per-expert term
  is a capacity bound, not a load;
* exec time on a core type = the roofline
  ``max(flops / type_speed, bytes / type_mem_bw)`` against the machine's
  per-type peak vectors (``MachineModel.type_speeds`` / ``type_mem_bw``,
  e.g. ``h100_node``'s datasheet rates; the H100 rates where a machine
  carries none);
* comm volumes from activation shapes: a pipeline hop moves one
  microbatch of activations, ``micro_batch * seq * d_model * dtype_bytes``;
  an expert dispatch edge moves that expert's routed token slice. The
  machine's ``CommLevel`` tiers (HBM ≪ NVLink ≪ InfiniBand on
  ``h100_node``) convert volume -> time inside the scheduler, never
  here — the graph stays architecture-independent (MPAHA's own
  contract).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..configs import SHAPES, ModelConfig
from ..core.machine import H100_HBM_BW, H100_PEAK_FLOPS, MachineModel

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

#: the cost sources :func:`unit_costs` takes
SOURCES = ("analytic", "counted")


# ---------------------------------------------------------------------------
# analytic per-layer terms
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, kind: str, seq: int) -> float:
    """Per-token dot FLOPs of one attention layer (projections + scores)."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads or cfg.n_heads
    if cfg.kv_lora_rank:                     # MLA: latent down/up projections
        lr = cfg.kv_lora_rank
        nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        proj = 2 * d * (hq * (nope + rope)) + 2 * d * (lr + rope) \
            + 2 * lr * hq * (nope + vh) + 2 * hq * vh * d
        eff = seq
        return proj + 2 * eff * hq * (nope + rope) + 2 * eff * hq * vh
    proj = 2 * d * (hq + 2 * hkv) * dh + 2 * hq * dh * d
    eff = min(cfg.window, seq) if kind.endswith("local") and cfg.window \
        else seq
    # causal halves the average score length; scores + weighted sum
    return proj + 2 * (eff / (2 if cfg.causal else 1)) * hq * dh * 2


def _mlp_flops(cfg: ModelConfig) -> float:
    cols = 2 if cfg.activation in ("geglu", "swiglu") else 1
    return 2 * cfg.d_model * cols * cfg.d_ff + 2 * cfg.d_ff * cfg.d_model


def expert_flops_per_token(cfg: ModelConfig) -> float:
    """Dot FLOPs one expert spends on one routed token copy
    (wi (d, 2, F_e) + wo (F_e, d))."""
    f = cfg.d_ff_expert
    return 2 * cfg.d_model * 2 * f + 2 * f * cfg.d_model


def _moe_flops(cfg: ModelConfig) -> float:
    """Per-token MoE FFN dot FLOPs at the *routed* load (top_k copies +
    shared experts + router)."""
    d = cfg.d_model
    fl = 2 * d * cfg.n_experts                       # router
    fl += cfg.top_k * expert_flops_per_token(cfg)
    if cfg.n_shared_experts:
        fs = cfg.d_ff_expert * cfg.n_shared_experts
        fl += 2 * d * 2 * fs + 2 * fs * d
    return fl


def _ssm_flops(cfg: ModelConfig) -> float:
    """Per-token dot FLOPs of one mamba2 layer (projections dominate;
    the chunked state scan adds ~2·d_inner·N per token)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    proj = 2 * d * di * 2 + 2 * di * d               # wz/wx in, wout
    proj += 2 * d * (2 * cfg.ssm_ngroups * n + cfg.ssm_heads)  # wB/wC/wdt
    return proj + 4 * di * n


def layer_flops_analytic(cfg: ModelConfig, kind: str, seq: int) -> float:
    """Per-token dot FLOPs for one layer of ``kind``."""
    if kind == "ssm":
        return _ssm_flops(cfg)
    attn = _attn_flops(cfg, kind, seq)
    ffn = _moe_flops(cfg) if kind.startswith("moe") else _mlp_flops(cfg)
    return attn + ffn


def _layer_weight_bytes(cfg: ModelConfig, kind: str) -> float:
    """Rough per-layer weight bytes — the HBM floor of a layer pass."""
    per_token = layer_flops_analytic(cfg, kind, seq=1)
    # dot flops at seq=1 ~ 2 * (weight elements touched); moe touches
    # top_k of n_experts but the weights *resident* include all experts
    resident = per_token / 2
    if kind.startswith("moe"):
        resident += (cfg.n_experts - cfg.top_k) * \
            expert_flops_per_token(cfg) / 2
    return resident * _DTYPE_BYTES.get(cfg.dtype, 2)


# ---------------------------------------------------------------------------
# the extracted profile
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UnitCosts:
    """Costs of ONE repeat unit (the smallest group of layers the
    executable pipeline can split at) processing one microbatch, plus
    the inter-unit activation volume."""

    arch: str
    n_units: int                      # repeat count (pipeline split points)
    layers_per_unit: int
    flops: float                      # dot FLOPs, one unit, one microbatch
    hbm_bytes: float                  # traffic proxy, same scope
    act_bytes: float                  # activation volume leaving the unit
    tokens: int                       # microbatch tokens (micro_b * seq)
    source: str = "analytic"
    per_kind_flops: dict = field(default_factory=dict, hash=False)

    @property
    def total_flops(self) -> float:
        return self.flops * self.n_units


def unit_costs(cfg: ModelConfig, *, seq: int = 1024, micro_batch: int = 1,
               source: str = "analytic") -> UnitCosts:
    """Per-repeat-unit cost terms for any config in
    :mod:`repro_torch.configs`.

    ``source="analytic"`` — closed-form (instant, every arch);
    ``source="counted"`` — one repeat unit run on fake CPU tensors, its
    aten ops counted (:func:`counted_unit_terms`)."""
    prologue, n_rep, unit, tail = cfg.repeat_structure()
    tokens = micro_batch * seq
    act_bytes = float(tokens * cfg.d_model * _DTYPE_BYTES.get(cfg.dtype, 2))
    if source == "counted":
        flops, hbm = counted_unit_terms(cfg, unit, seq, micro_batch)
        per_kind: dict[str, float] = {}
    elif source == "analytic":
        per_kind = {k: tokens * layer_flops_analytic(cfg, k, seq)
                    for k in set(unit)}
        flops = sum(per_kind[k] for k in unit)
        hbm = sum(_layer_weight_bytes(cfg, k) + 4 * act_bytes for k in unit)
    elif source == "hlo":
        raise ValueError("source 'hlo' compiles the unit to HLO, which "
                         "eager PyTorch has not: use source='counted' "
                         "(the unit's aten ops counted on fake tensors)")
    else:
        raise ValueError(f"unknown cost source {source!r} (have "
                         f"{SOURCES})")
    return UnitCosts(cfg.name, n_rep, len(unit), float(flops), float(hbm),
                     act_bytes, tokens, source, per_kind)


def unit_call(cfg: ModelConfig, unit: list[str], generator, device):
    """``(fn, layers)``: the layers of one repeat unit, random weights
    from ``generator`` on ``device``, and ``fn(layers, x)`` running them
    in order as a training forward (the unit the pipeline splits at)."""
    import torch

    from ..models.blocks import init_layer
    from ..models.model import DTYPES, Layer, MambaLayer, ShardCtx
    dt = DTYPES[cfg.dtype]
    layers = [MambaLayer(init_layer(k, cfg, generator, dt, device))
              if k == "ssm" else Layer(k, init_layer(k, cfg, generator, dt,
                                                     device))
              for k in unit]
    ctx = ShardCtx(mode="train")

    def fn(layers, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in layers:
            x, _, _ = layer(x, cfg=cfg, mode="train", positions=positions,
                            ctx=ctx)
        return x

    return fn, layers


def counted_unit_terms(cfg: ModelConfig, unit: list[str], seq: int,
                       micro_batch: int) -> tuple[float, float]:
    """One repeat unit (fake CPU tensors, one device, so MoE runs
    ``moe_dense``) run once, its matmul FLOPs and traffic proxy counted.
    MoE expert terms are corrected from the dense path's all-experts
    compute down to the routed load, as the reference corrects its
    dense oracle."""
    import torch

    from ..launch.op_analysis import analyze_call, fake_mode
    from ..models.model import DTYPES
    with fake_mode(), torch.no_grad():
        fn, layers = unit_call(cfg, unit, torch.Generator(), "cpu")
        x = torch.zeros((micro_batch, seq, cfg.d_model),
                        dtype=DTYPES[cfg.dtype])
        cost = analyze_call(fn, layers, x)
    flops, hbm = float(cost.dot_flops), float(cost.traffic_bytes)
    n_moe = sum(1 for k in unit if k.startswith("moe"))
    if n_moe and cfg.n_experts:
        # the dense path ran all E experts on all tokens; routed load is k/E
        dense_extra = n_moe * micro_batch * seq * \
            (cfg.n_experts - cfg.top_k) * expert_flops_per_token(cfg)
        flops = max(flops - dense_extra, 0.0)
    return flops, hbm


# ---------------------------------------------------------------------------
# machine speed vectors
# ---------------------------------------------------------------------------

def type_speed_vectors(machine: MachineModel
                       ) -> tuple[list[float], list[float]]:
    """Per-processor-type (peak FLOP/s, memory bytes/s) vectors, defaulted
    to the H100's datasheet rates when the model carries none."""
    speeds = list(machine.type_speeds) or \
        [H100_PEAK_FLOPS] * machine.n_types
    membw = list(machine.type_mem_bw) or [H100_HBM_BW] * machine.n_types
    if len(speeds) < machine.n_types:
        speeds = speeds + [speeds[-1]] * (machine.n_types - len(speeds))
    if len(membw) < machine.n_types:
        membw = membw + [membw[-1]] * (machine.n_types - len(membw))
    return speeds[:machine.n_types], membw[:machine.n_types]


def exec_times(flops: float, hbm_bytes: float, machine: MachineModel
               ) -> tuple[float, ...]:
    """Roofline exec time of a (flops, bytes) work item on every
    processor type — the ``Subtask.times`` tuple."""
    speeds, membw = type_speed_vectors(machine)
    return tuple(max(flops / s, hbm_bytes / b)
                 for s, b in zip(speeds, membw))


def shape_tokens(shape_name: str) -> tuple[int, int]:
    """(seq, global_batch) of a named run shape — convenience for demos."""
    s = SHAPES[shape_name]
    return s.seq_len, s.global_batch
