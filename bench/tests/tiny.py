"""The cells at tiny widths on the CPU: each configuration's file with
its widths shrunk (on both sides: the published keys the reference
reads and the port's ``replace``) and a short traffic mix."""

import copy
import time
from types import SimpleNamespace

import torch

from harness import main, registry

MOE = "train.deepseek-v2-lite-16b-6l.b2s1024"
HYBRID = "train.zamba2-7b-39l.b8s1024"
CELLS = (MOE, HYBRID)

TINY = {
    "moe": ({"hidden_size": 64, "num_attention_heads": 4,
             "kv_lora_rank": 32, "qk_nope_head_dim": 16,
             "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
             "num_experts_per_tok": 2, "n_shared_experts": 1,
             "moe_intermediate_size": 32, "intermediate_size": 128,
             "vocab_size": 256, "num_hidden_layers": 3},
            {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
             "d_ff": 128, "vocab": 256, "n_experts": 8, "top_k": 2,
             "n_shared_experts": 1, "d_ff_expert": 32, "kv_lora_rank": 32,
             "qk_nope_dim": 16, "qk_rope_dim": 8, "v_head_dim": 16}),
    "hybrid": ({"hidden_size": 64, "num_attention_heads": 4,
                "attention_head_dim": 32, "adapter_rank": 4,
                "mamba_d_state": 16, "mamba_headdim": 16, "chunk_size": 8,
                "ffn_hidden_size": 128, "vocab_size": 256,
                "num_hidden_layers": 5},
               {"n_layers": 5, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
                "head_dim": 32, "d_ff": 128, "vocab": 256, "ssm_state": 16,
                "ssm_headdim": 16, "ssm_chunk": 8, "shared_attn_every": 2,
                "shared_lora_rank": 4}),
}
TRAFFIC = {"batch": 2, "seq_len": 16, "pool": 4, "profiled_steps": 2}


def config(workload: str, dtype: str = "float32") -> dict:
    bench = registry.benchmark(registry.BENCH.parent)
    cfg = copy.deepcopy(registry.config_of(
        bench, registry.BENCH.parent, registry.cell(bench, workload)
        ["config"]))
    keys, port = TINY[cfg["family"]]
    cfg.update(keys, dtype=dtype)
    cfg["port"]["replace"].update(port, dtype=dtype)
    if cfg["family"] == "hybrid":
        cfg["reference"]["shared_every"] = 2
    return cfg


def job(workload: str, seed: int = 7, dtype: str = "float32",
        trace: bool = False, wrapper=None):
    args = SimpleNamespace(workload=workload, seed=seed, seconds=0.0,
                           trace=int(trace))
    j = main.make_job(args, registry.BENCH.parent, torch.device("cpu"),
                      time.perf_counter())
    j.config = config(workload, dtype)
    j.traffic = dict(j.traffic, **TRAFFIC)
    j.step_wrapper = wrapper
    return j
