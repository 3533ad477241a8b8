"""Multi-pod dry-run: record rank 0's step of every (arch × shape × mesh)
cell on the production meshes and reckon its roofline terms and memory,
as the reference's ``launch/dryrun.py`` does from a compiled artifact.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

One process plays rank 0 of the production world (256 GPUs, or 512 with
``--multi-pod``): a ``fake`` process group of that size
(:func:`repro_torch.launch.mesh.fake_world`, whose collectives move
nothing), :func:`~repro_torch.launch.mesh.make_production_mesh` over it,
rank 0's slice of the model and optimizer state
(:func:`repro_torch.launch.train.sharded_train_state`: ``shard_params``
and the ZeRO-1 ``moment_specs``, the reference's ``zero1_spec``) on fake
CPU tensors, and its training step (``make_train_step``), prefill, or
decode step, run once under :func:`repro_torch.launch.op_analysis.
analyze_call`. Nothing is allocated and nothing computed: a fake CPU
tensor sends every ``kernels.ops`` call down its plain version, which
runs on shapes alone. A decode step's ``flash_decode`` range guard reads
its positions back; the recorder answers that read from the real
positions it carries beside the fakes, so the guard still checks them.

Per cell this prints and records: the counted matmul FLOPs, the traffic
proxy's bytes and the collective bytes by opcode and by mesh axis; the
three roofline terms and the dominant one, as model figures at datasheet
rates (``core.machine.H100_PEAK_FLOPS`` and ``H100_HBM_BW``; a
collective over an axis whose ranks stay within one 8-GPU node at
``H100_NVLINK_BW``, one that crosses nodes at ``H100_IB_BW``, the record
naming the link each axis took), not measured times; MODEL_FLOPS over
the counted FLOPs (usefulness); and ``memory_analysis``, rank 0's bytes
reckoned from its own slices: parameters (by ``param_spec``), moments
(by ``moment_specs``), gradients (the float32 accumulators of a step
with ``grad_accum`` > 1, else the parameters' type), decode caches (by
``cache_slices``) and a step peak: what the state holds before the step
plus the most bytes the step's own storages held at once (the
recorder's ``track_memory``: every storage an op allocates, freed when
its last tensor goes). ``torch.distributed._tools.mem_tracker.
MemTracker`` does not serve here: it refuses a module called twice in
one step, as every layer is under gradient accumulation and remat.

The reference's ``xla_cost_analysis_raw`` (XLA's own counts, which see
a ``while`` body once) has no counterpart and is dropped: every op that
runs is recorded once per run, so there is no second count to compare.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from ..configs import ARCHS, SHAPES, SKIPS
from ..core.machine import (H100_HBM_BW, H100_HBM_BYTES, H100_IB_BW,
                            H100_NVLINK_BW, H100_PEAK_FLOPS)
from ..runtime.pipeline import NODE_GPUS
from ..sharding.partition import Partitioner
from .mesh import axis_ranks, axis_sizes, fake_world, make_production_mesh
from .op_analysis import analyze_call, fake_mode
from .specs import abstract_params, input_specs, make_ctx, mesh_axes_for

__all__ = ["count_expert_params", "dryrun_cell", "lower_cell", "main",
           "model_flops", "run_cell"]


def model_flops(cfg, shape, n_params: int, expert_params: int) -> float:
    """6·N_active·D train, 2·N_active·D inference (full N, embedding
    included, as the reference keeps it; MoE counts the active experts
    only)."""
    if cfg.n_experts:
        active = (n_params - expert_params
                  + expert_params * (cfg.top_k + cfg.n_shared_experts)
                  / (cfg.n_experts + cfg.n_shared_experts))
    else:
        active = n_params
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.mode == "train" else 2
    return mult * active * tokens


def count_expert_params(model) -> int:
    """Parameters of the MoE layers' experts (``*.moe.wi``/``wo``; not
    the router, not the shared experts)."""
    return sum(p.numel() for k, p in model.named_parameters()
               if ".moe." in k and not k.endswith("router"))


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lower_cell(arch: str, shape_name: str, mesh, grad_accum: int = 8,
               attn_claim: str = "auto", remat: str | None = None,
               n_layers: int | None = None) -> dict:
    """Rank 0's state and step of one cell on fake CPU tensors over
    ``mesh`` (a ``"cpu"`` mesh over :func:`fake_world`'s group), as the
    reference's ``lower_cell`` lowers it: ``{"fn", "args", "mode",
    "cfg", "shape", "n_params", "e_params", "memory", "grad_accum",
    "rows"}``, where ``fn(*args)`` runs the step inside the fake tensor
    mode ``mode`` and ``memory`` holds the state's bytes.
    ``n_layers`` cuts the depth (tests); the CLI runs whole configs."""
    from ..models.model import init_cache
    from ..optim.adamw import OptConfig
    from ..runtime.serve_loop import make_prefill, make_serve_step
    from ..runtime.train_loop import make_train_step
    from .train import sharded_train_state
    cfg = ARCHS[arch]
    if remat:
        cfg = cfg.replace(remat=remat)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    shape = SHAPES[shape_name]
    axes = mesh_axes_for(cfg, mesh)
    part = Partitioner(mesh, axes)
    ctx = make_ctx(cfg, shape, mesh, axes, attn_claim=attn_claim)
    sizes = axis_sizes(mesh)
    dp = part.dp_axes_for_batch(shape.global_batch)
    rows = shape.global_batch // math.prod(sizes[a] for a in dp)
    mode = fake_mode()
    with mode:
        model = abstract_params(cfg)
        n_params = sum(p.numel() for p in model.parameters())
        e_params = count_expert_params(model)
        inp = input_specs(cfg, shape)
        memory = {}
        if shape.mode == "train":
            ga = grad_accum
            while ga > 1 and shape.global_batch % ga:  # a microbatch a shard
                ga //= 2
            opt_cfg = OptConfig()
            state, (pspecs, mspecs) = sharded_train_state(model, opt_cfg,
                                                          part)
            batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                     for k, v in inp.items()}         # whole, every rank
            step = make_train_step(cfg, opt_cfg, ctx, grad_accum=ga,
                                   param_specs=pspecs, moment_specs=mspecs)
            fn, args = step, (state, batch)
            memory["param_bytes"] = _bytes(model.parameters())
            memory["moment_bytes"] = _bytes(
                t for k in ("m", "v", "ef") if k in state["opt"]
                for t in state["opt"][k].values())
            memory["grad_bytes"] = sum(
                p.numel() * (4 if ga > 1 else p.element_size())
                for p in model.parameters())
            memory["cache_bytes"] = 0
        else:
            ga = 1
            from ..sharding.partition import shard_params
            shard_params(model, part)
            memory["param_bytes"] = _bytes(model.parameters())
            memory["moment_bytes"] = memory["grad_bytes"] = 0
            if shape.mode == "prefill":
                batch = {k: torch.zeros((rows,) + tuple(v.shape[1:]),
                                        dtype=v.dtype)
                         for k, v in inp.items() if k != "labels"}
                fn, args = make_prefill(cfg, ctx), (model, batch)
                memory["cache_bytes"] = 0
            else:
                cache = init_cache(cfg, rows, shape.seq_len, "cpu",
                                   part=part)
                token = torch.zeros((rows, 1), dtype=torch.int64)
                fn = make_serve_step(cfg, ctx)
                # the last slot: the decode step over a full cache
                args = (model, cache, token, shape.seq_len - 1)
                memory["cache_bytes"] = _bytes(t for c in cache
                                               for t in c.values())
        memory["input_bytes"] = _bytes(
            t for t in (args[1].values() if shape.mode != "decode"
                        else [args[2]]))
    return {"fn": fn, "args": args, "mode": mode, "cfg": cfg, "shape": shape,
            "n_params": n_params, "e_params": e_params, "memory": memory,
            "grad_accum": ga, "rows": rows}


def _axis_links(mesh) -> dict:
    """``{axis: (sorted ranks through rank 0, link)}``: NVLink where the
    axis' ranks share a node of ``NODE_GPUS``, else InfiniBand."""
    out = {}
    for axis in mesh.mesh_dim_names:
        ranks = tuple(sorted(axis_ranks(mesh, axis)))
        one_node = len({r // NODE_GPUS for r in ranks}) == 1
        out[axis] = (ranks, "nvlink" if one_node else "infiniband")
    return out


_LINK_BW = {"nvlink": H100_NVLINK_BW, "infiniband": H100_IB_BW}


def analyze(cell: dict, cost, mesh) -> dict:
    """The record of one cell from its :class:`~repro_torch.launch.
    op_analysis.CallCost`."""
    cfg, shape = cell["cfg"], cell["shape"]
    n_chips = math.prod(axis_sizes(mesh).values())
    flops_dev = float(cost.dot_flops)
    bytes_dev = float(cost.traffic_bytes)
    links = _axis_links(mesh)
    by_axis: dict[str, dict] = {}
    t_collective = 0.0
    for group, b in cost.collective_groups.items():
        key = tuple(sorted(group))
        axis = next((a for a, (r, _) in links.items() if r == key), None)
        link = links[axis][1] if axis else (
            "nvlink" if len({r // NODE_GPUS for r in key}) == 1
            else "infiniband")
        name = axis or f"group{list(key)[:4]}"
        row = by_axis.setdefault(name, {"bytes": 0.0, "link": link,
                                        "bytes_per_s": _LINK_BW[link]})
        row["bytes"] += b
        t_collective += b / _LINK_BW[link]
    terms = {"compute": flops_dev / H100_PEAK_FLOPS,
             "memory": bytes_dev / H100_HBM_BW,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    mflops = model_flops(cfg, shape, cell["n_params"], cell["e_params"])
    mem = dict(cell["memory"])
    before = mem["param_bytes"] + mem["moment_bytes"] + mem["cache_bytes"] \
        + mem["input_bytes"]
    mem["step_transient_bytes"] = cost.peak_bytes
    mem["step_peak_bytes"] = before + (cost.peak_bytes or 0)
    mem["fits_h100_80gb"] = mem["step_peak_bytes"] <= H100_HBM_BYTES
    return {
        "arch": cfg.name, "shape": shape.name, "n_chips": n_chips,
        "n_params": cell["n_params"],
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": dict(cost.collective_bytes),
        "collective_total": float(cost.collective_total),
        "collective_by_axis": by_axis,
        "roofline_seconds": terms,
        "roofline_note": "model figures at datasheet rates (H100 989 "
                         "TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink, "
                         "50 GB/s InfiniBand a GPU), not measured times",
        "dominant": dominant,
        "model_flops_total": mflops,
        "useful_flops_ratio": (mflops / n_chips / flops_dev)
        if flops_dev else None,
        "memory_analysis": mem,
        "n_ops": cost.n_ops,
        "top_dots": [[f, op, s[:120]] for f, op, s in cost.top_dots[:6]],
        "top_collectives": [[b, op, s[:60]]
                            for b, op, s in cost.top_collectives[:6]],
        "top_traffic": [[t, op, s[:60]] for t, op, s in cost.top_traffic[:6]],
    }


def dryrun_cell(arch: str, shape_name: str, mesh, grad_accum: int = 8,
                attn_claim: str = "auto", remat: str | None = None,
                n_layers: int | None = None) -> dict:
    """Lower and record one cell over ``mesh`` (inside
    :func:`fake_world`); the record with ``lower_s`` (the state built)
    and ``record_s`` (the step recorded), host seconds."""
    t0 = time.time()
    cell = lower_cell(arch, shape_name, mesh, grad_accum=grad_accum,
                      attn_claim=attn_claim, remat=remat, n_layers=n_layers)
    t_lower = time.time() - t0
    with cell["mode"], torch.no_grad() if cell["shape"].mode != "train" \
            else torch.enable_grad():
        cost = analyze_call(cell["fn"], *cell["args"], answer_reads=True,
                            track_memory=True)
    rec = analyze(cell, cost, mesh)
    rec["lower_s"] = round(t_lower, 2)
    rec["record_s"] = round(time.time() - t0 - t_lower, 2)
    rec["attn_claim"] = attn_claim
    rec["grad_accum"] = cell["grad_accum"]
    rec["rows_per_rank"] = cell["rows"]
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None,
             grad_accum: int = 8, attn_claim: str = "auto",
             remat: str | None = None) -> dict:
    """One cell on the production mesh, in a fake world of its size that
    is torn down after; writes ``DIR/<arch>_<shape>_<mesh>.json`` when
    ``out_dir`` is given."""
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec = dryrun_cell(arch, shape_name, mesh, grad_accum=grad_accum,
                          attn_claim=attn_claim, remat=remat)
    rec["mesh"] = "2x16x16" if multi_pod else "16x16"
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{rec['mesh']}".replace("/", "_")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=8)
    ap.add_argument("--attn-claim", default="auto")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        from ..configs import cells as all_cells
        cells = all_cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        if args.shape in SKIPS.get(args.arch, {}):
            print(f"SKIP {args.arch} x {args.shape}: "
                  f"{SKIPS[args.arch][args.shape]}")
            return
        cells = [(args.arch, args.shape)]

    for arch, shape in cells:
        rec = run_cell(arch, shape, args.multi_pod, args.out,
                       grad_accum=args.grad_accum,
                       attn_claim=args.attn_claim, remat=args.remat)
        t = rec["roofline_seconds"]
        mem = rec["memory_analysis"]
        print(f"OK {arch} x {shape} [{rec['mesh']}] "
              f"lower={rec['lower_s']}s record={rec['record_s']}s "
              f"compute={t['compute']:.3e}s memory={t['memory']:.3e}s "
              f"coll={t['collective']:.3e}s dom={rec['dominant']} "
              f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)} "
              f"peak={mem['step_peak_bytes'] / 1e9:.2f}GB",
              flush=True)


if __name__ == "__main__":
    main()
