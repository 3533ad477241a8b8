"""Training cells: the port's training step, driven back to back.

Set-up makes the weights from the seed, builds one train state of the
port and its ``make_train_step``, and drives that state through its
first steps on the traffic's first batches; those steps warm every
shape and are the steps the reference follows. The window then steps
the same state back to back on fresh batches (cycled from a pool in
pinned host memory, copied to the card each step, as a data loader
would) until ``--seconds`` have passed, and synchronises. After the
window the port's state is freed and the float32 reference takes the
same first steps from the same weights; ``correct`` compares the two
(see :func:`compare`).
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import sys
import time

import torch

from harness import trace as tr
from harness import weights


def port_cfg(config: dict):
    from repro_torch.configs import ARCHS
    port = config["port"]
    return ARCHS[port["arch"]].replace(**port.get("replace", {}))


def build_state(job, spec):
    """(train_step, state) of the port on ``job.device``, the state's
    parameters the benchmark's weights for ``job.seed``."""
    from repro_torch.models import ShardCtx
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.runtime.train_loop import make_train_step
    cfg = port_cfg(job.config)
    model = init_params(cfg, torch.Generator(), "meta")
    have = {k: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for k, p in model.named_parameters()}
    want = {leaf.name: (tuple(leaf.shape), leaf.dtype) for leaf in spec}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"{cfg.name}: the port's parameters differ from "
                         f"the reference's layout: {diff}")
    model = model.to_empty(device=job.device)
    weights.make(spec, job.seed, job.device,
                 into={k: p.data for k, p in model.named_parameters()})
    model.requires_grad_(True)
    opt = OptConfig(**job.config["optimizer"])
    step = make_train_step(cfg, opt, ShardCtx())
    return step, {"params": model, "opt": init_opt_state(model, opt)}


def batches(job) -> list[dict]:
    """The traffic's pool of batches ({"tokens", "labels"}, (B, S)
    int64) in host memory, pinned where a card takes them: token ids
    uniform over the vocabulary, drawn from the seed."""
    import numpy as np
    t = job.traffic
    rng = np.random.default_rng([job.seed % (1 << 64), 0x7472])
    ids = rng.integers(0, job.config["vocab_size"],
                       (t["pool"], t["batch"], t["seq_len"] + 1))
    out = []
    for rows in torch.from_numpy(ids):
        b = {"tokens": rows[:, :-1].contiguous(),
             "labels": rows[:, 1:].contiguous()}
        if job.device.type == "cuda":
            b = {k: v.pin_memory() for k, v in b.items()}
        out.append(b)
    return out


def on(device, batch: dict) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


@contextlib.contextmanager
def recorded_routes():
    """The expert ids (T, k) of each call of the port's router while the
    block runs, in call order (under remat the forward's calls, then the
    recomputation's); nothing for a model without experts."""
    from repro_torch.models import moe
    calls, real = [], moe.router_topk

    def spy(x, w_router, top_k):
        out = real(x, w_router, top_k)
        calls.append(out[1].detach())
        return out
    moe.router_topk = spy
    try:
        yield calls
    finally:
        moe.router_topk = real


def first_steps(job, step, state, pool, spec, sync) -> tuple[dict, float]:
    """The first ``checked_steps`` steps of the state on the pool's first
    batches: their losses, each leaf's first gradient as the optimizer
    took it (its first moment after one step over 1 - b1) and each
    leaf's distance from its initial value after the last, and the
    routes its MoE layers took (each step's forward calls); and the
    seconds spent reading those back, which are the check's and not
    set-up."""
    b1 = job.config["optimizer"]["b1"]
    losses, routes = [], []
    for i in range(job.traffic["checked_steps"]):
        with recorded_routes() as calls:
            state, met = step(state, on(job.device, pool[i]))
        routes.append(calls[:len(calls) // 2])
        losses.append(met["loss"].detach().float())
        if i == 0:
            m = state["opt"]["m"]
            norms = torch.stack([torch.linalg.vector_norm(m[k]) for k in m])
    sync()
    t0 = time.perf_counter()
    out = {"losses": torch.stack(losses).tolist(),
           "grad_norms": dict(zip(m, (norms / (1.0 - b1)).tolist())),
           "deltas": weights.delta_norms(
               spec, job.seed, dict(state["params"].named_parameters()),
               job.device),
           "routes": routes}
    return out, time.perf_counter() - t0


def reference_outputs(job, family, spec, pool, prec: str = "fp32",
                      routes=None) -> dict:
    """The reference's first steps from the same weights and batches
    (``prec`` "fp8": the control), its MoE layers taking and judging
    ``routes``, the program's."""
    n = job.traffic["checked_steps"]
    old = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        w = weights.make(spec, job.seed, job.device)
        out = family.L.train_steps(family, job.config, w,
                                   [on(job.device, b) for b in pool[:n]],
                                   prec, routes)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    out["deltas"] = weights.delta_norms(spec, job.seed, out.pop("params"),
                                        job.device)
    return out


def compare(prog: dict, ref: dict, still: float = 1e-3) -> dict:
    """Relative gaps between the program's readings and the reference's:

    * ``loss_gap``: the worst step's loss;
    * ``grad_gap``: the worst leaf's first-gradient norm, against the
      larger of that leaf's reference norm and the median leaf's;
      ``grad_gap_median``: the median leaf's such gap;
    * ``change_gap``, ``change_gap_median``: likewise the norm of each
      leaf's change over the checked steps, leaving out the leaves whose
      reference gradient is under ``still`` times the median leaf's
      (they move by round-off alone);
    * ``route_gap`` (MoE): the reference's judgement of the program's
      routes, which it took: the widest gap in router logits by which a
      token's expert lies below its k-th best.

    Returns ``{name: (gap, the worst leaf or step)}``; the cell's limits
    name the ones that decide ``correct``."""
    def gaps(p, r, keys):
        med = statistics.median(r[k] for k in keys)
        return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keys}

    def worst(g):
        k = max(g, key=g.get)
        return g[k], k

    def median(g):
        return statistics.median(g.values()), "median leaf"
    rl, pl = ref["losses"], prog["losses"]
    loss = max((abs(pl[i] - rl[i]) / abs(rl[i]), i + 1)
               for i in range(len(rl)))
    rg = ref["grad_norms"]
    med = statistics.median(rg.values())
    grad = gaps(prog["grad_norms"], rg, list(rg))
    change = gaps(prog["deltas"], ref["deltas"],
                  [k for k in rg if rg[k] >= still * med])
    out = {"loss_gap": loss, "grad_gap": worst(grad),
           "grad_gap_median": median(grad), "change_gap": worst(change),
           "change_gap_median": median(change)}
    if ref.get("route_gap") is not None:
        out["route_gap"] = (ref["route_gap"], "widest token")
    return out


def run(job) -> dict:
    from harness import registry
    family = registry.module("reference", job.config["family"])
    spec = family.param_spec(job.config)
    dev = job.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {"imports": time.perf_counter() - job.t_start}
    pool = batches(job)
    t = time.perf_counter()
    step, state = build_state(job, spec)
    sync()
    phases["state"] = time.perf_counter() - t
    if job.step_wrapper is not None:
        step = job.step_wrapper(step)
    t = time.perf_counter()
    prog, check_s = first_steps(job, step, state, pool, spec, sync)
    phases["first_steps"] = time.perf_counter() - t - check_s

    tokens_step = job.traffic["batch"] * job.traffic["seq_len"]
    n0 = job.traffic["checked_steps"]
    losses, host_s = [], []
    setup_s = time.perf_counter() - job.t_start
    t0 = time.perf_counter()
    while not losses or time.perf_counter() - t0 < job.seconds:
        b = on(dev, pool[(n0 + len(losses)) % len(pool)])
        th = time.perf_counter()
        state, met = step(state, b)
        host_s.append(time.perf_counter() - th)
        losses.append(met["loss"])
    sync()
    window_s = time.perf_counter() - t0
    tokens_per_s = len(losses) * tokens_step / window_s

    trace = shapes_trace = None
    if job.trace:
        trace = profile(job, step, state, pool, losses)
        if any(getattr(m, "NEEDS_SHAPES", False) for m in job.readers):
            shapes_trace = profile(job, step, state, pool, losses, True)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n_done = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    del state, step, met, b, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference_outputs(job, family, spec, pool,
                            routes=prog.pop("routes"))
    phases["reference"] = time.perf_counter() - t
    phases["check_readback"] = check_s
    host_ms = sorted(1e3 * x for x in host_s)
    print("phases " + json.dumps(phases) + " window " + json.dumps(
        {"steps": n_done, "seconds": window_s,
         "host_ms_min_median_max": [host_ms[0], host_ms[len(host_ms) // 2],
                                    host_ms[-1]]}), file=sys.stderr)
    gaps = compare(prog, ref)
    return {"e2e": {"train_tokens_per_s": tokens_per_s,
                    "setup_s": setup_s - check_s},
            "attempted": n_done, "failed": failed, "gaps": gaps,
            "memory_peak_bytes": peak,
            "reading": Reading(job, family, tokens_per_s, host_s, trace,
                               shapes_trace)}


def profile(job, step, state, pool, losses, shapes: bool = False):
    """A fixed number of steps under the profiler, inside the
    ``bench.window`` span that ends after a device synchronise; with
    ``shapes``, the host operations' input shapes recorded too (a window
    of its own: recording them slows the host's dispatch)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function
    n = job.traffic["profiled_steps"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if job.device.type == "cuda" else [])
    batches_ = [on(job.device, pool[i % len(pool)]) for i in range(n)]
    with prof_ctx(activities=acts, record_shapes=shapes) as p:
        if job.device.type == "cuda":
            torch.cuda.synchronize()
        with record_function(tr.WINDOW):
            for b in batches_:
                state, met = step(state, b)
                losses.append(met["loss"])
            if job.device.type == "cuda":
                torch.cuda.synchronize()
    return tr.extract(p, n)


class Reading:
    """What a per-layer metric's reader reads of a run: the
    configuration, traffic and reference family, the device's peaks
    (None for a device the table lacks), the window's tokens/s and host
    seconds a step call, and the profiled steps' :class:`~harness.trace.
    Trace` (``shapes_trace``: another such window with the host
    operations' input shapes, for the readers that ask for them)."""

    def __init__(self, job, family, tokens_per_s, host_s, trace,
                 shapes_trace=None):
        self.config, self.traffic, self.family = job.config, job.traffic, \
            family
        self.peaks = job.peaks
        self.tokens_per_s = tokens_per_s
        self.host_s = host_s
        self.trace = trace
        self.shapes_trace = shapes_trace

    def peak_flops(self) -> float | None:
        if self.peaks is None:
            return None
        return self.peaks.get(f"{self.config['dtype']}_flops_per_s")
