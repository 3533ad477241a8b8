"""Training step + fault-tolerant loop, on one device or a mesh.

A copy of the reference's ``runtime/train_loop.py``. ``make_train_step``
builds the step for every family (dense, MoE, SSM, hybrid, encoder,
VLM): microbatched gradient accumulation into a float32 accumulator,
family-aware loss, the MoE aux loss mixed in, AdamW with optional int8
gradient compression, and metrics. The gradients come from autograd
through the model's kernels, whose backward is a kernel too
(``ops.flash_attention_bwd``, ``ops.rmsnorm_bwd``,
``ops.ssd_scan_bwd``).

``Trainer`` is the loop: checkpoint every ``ckpt_every`` steps and at
the end (the writer drained before it returns), step retry on a
transient failure, and a straggler monitor that flags step-time
outliers.

A train state is ``{"params": Model, "opt": {"m", "v", "step", ...}}``;
the step updates both in place (see :mod:`repro_torch.optim.adamw`) and
returns the same state. Under a mesh (a context whose ``mesh`` is a
``DeviceMesh``) the parameters and moments are this rank's slices
(:func:`repro_torch.sharding.shard_params`; the moments at their ZeRO-1
specs, :meth:`~repro_torch.sharding.Partitioner.moment_specs`), every
rank is handed the whole batch and takes its data-parallel rows, and
the step averages the gradients and the loss over the data-parallel
axes, so it equals the one-device step. A parameter FSDP cuts over the
data axes gets its gradient reduce-scattered by the forward's gather,
summed over the data ranks; the step divides it by their number.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..checkpoint.ckpt import CheckpointManager
from ..launch.mesh import axis_sizes
from ..models.layers import cross_entropy
from ..models.model import ShardCtx, forward, init_params
from ..optim.adamw import OptConfig, apply_updates, init_opt_state
from ..sharding.partition import Shardings, Spec, shard


def family_loss(cfg, logits, batch):
    """Next-token CE for LMs; masked-unit CE for the encoder; text-only
    CE for the VLM (the loss starts after the image prefix)."""
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:]
    return cross_entropy(logits, batch["labels"],
                         logit_softcap=cfg.logit_softcap)


def make_loss_fn(cfg, ctx: ShardCtx, aux_weight: float = 0.01):
    def loss_fn(params, micro):
        logits, aux = forward(params, micro, cfg, ctx.with_mode("train"))
        loss = family_loss(cfg, logits, micro)
        return loss + aux_weight * aux, (loss, aux)
    return loss_fn


def _split(batch: dict, n: int, i: int) -> dict:
    """Microbatch ``i`` of ``n`` (each leaf cut along its first axis)."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does "
                             f"not split into {n} microbatches")
        m = x.shape[0] // n
        out[k] = x[i * m:(i + 1) * m]
    return out


def _mean_over(tensors: list, mesh, axes: tuple[str, ...], n: int) -> list:
    """The float32 mean of each tensor over the ranks of ``axes`` (one
    all-reduce an axis over the tensors joined), in order."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    for a in axes:
        dist.all_reduce(flat, group=mesh.get_group(a))
    flat /= n
    return [x.view(t.shape) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_grad_fn(cfg, ctx: ShardCtx, grad_accum: int = 1):
    """Returns grad_fn(params, batch) -> (grads, loss, aux): the gradients
    a train step applies (``{name: tensor}``, each this rank's slice
    under a mesh), the loss and the aux loss. ``batch`` leaves are (B,
    ...) tensors on the parameters' device; with ``grad_accum`` > 1 they
    are cut into that many microbatches whose gradients are summed in
    float32 and averaged.

    Under a mesh every rank is handed the same whole batch and takes its
    rows over ``ctx.dp_axes`` (the partitioner's ``batch_spec``); each
    microbatch is then a slice of those rows, as the reference pins the
    data-parallel axes onto the microbatch dim. Gradients (in float32),
    the loss and the aux loss are averaged over the data-parallel axes.
    The gradient of a parameter the model holds cut over the data axes
    (FSDP, its ``fsdp_dims``) arrives summed over the data ranks and is
    divided by their number instead, whether or not the batch divides
    over them (where it does not, every rank runs all rows)."""
    loss_fn = make_loss_fn(cfg, ctx)
    mesh = ctx.mesh
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError("train step: a ShardCtx on a mapping of axis "
                        "sizes names a layout; run it on a DeviceMesh")
    sizes = axis_sizes(mesh) if mesh is not None else {}
    dp = tuple(ctx.dp_axes) if mesh is not None else ()
    dp_n = math.prod(sizes[a] for a in dp)

    def rows(batch):
        if not dp:
            return batch
        return {k: shard(x, Spec(dp), mesh) for k, x in batch.items()}

    def grads_of(params, micro):
        params.zero_grad(set_to_none=True)
        total, (loss, aux) = loss_fn(params, micro)
        total.backward()
        grads = {k: p.grad for k, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        return grads, loss.detach(), torch.as_tensor(aux).detach()

    def grad_fn(params, batch):
        fsdp = getattr(params, "fsdp_dims", {})
        params.requires_grad_(True)
        batch = rows(batch)
        if grad_accum == 1:
            grads, loss, aux = grads_of(params, batch)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.named_parameters()}
            loss = aux = 0.0
            for i in range(grad_accum):
                g, l_, a = grads_of(params, _split(batch, grad_accum, i))
                for k, gk in g.items():
                    grads[k] += gk
                loss, aux = loss + l_, aux + a
                del g
            grads = {k: g / grad_accum for k, g in grads.items()}
            loss, aux = loss / grad_accum, aux / grad_accum
        if dp_n > 1:
            names = [k for k in grads if k not in fsdp]
            *averaged, loss, aux = _mean_over(
                [grads[k] for k in names] + [torch.as_tensor(loss),
                                             torch.as_tensor(aux)],
                mesh, dp, dp_n)
            grads.update(zip(names, averaged))
        for k, (_, axes) in fsdp.items():        # summed over data ranks
            n = math.prod(sizes[a] for a in axes)
            if n > 1:
                grads[k] = grads[k].to(torch.float32) / n
        return grads, loss, aux

    return grad_fn


def make_train_step(cfg, opt_cfg: OptConfig, ctx: ShardCtx,
                    grad_accum: int = 1, param_specs: dict | None = None,
                    moment_specs: dict | None = None):
    """Returns train_step(state, batch) -> (state, metrics): the
    gradients of :func:`make_grad_fn`, then AdamW. ``metrics``:
    ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` as float32 tensors.

    Under a mesh ``param_specs`` (``{name: Spec}``, the layout
    :func:`repro_torch.sharding.shard_params` kept the parameters in) is
    required, and the clip reads the global norm of the sharded
    gradients (:func:`repro_torch.optim.adamw.global_norm`);
    ``moment_specs`` (default ``param_specs``) is the layout of the
    optimizer moments, ZeRO-1's
    (:func:`repro_torch.optim.adamw.apply_updates`)."""
    grad_fn = make_grad_fn(cfg, ctx, grad_accum)
    if ctx.mesh is not None and param_specs is None:
        raise ValueError("make_train_step: under a mesh give param_specs, "
                         "the specs the parameters were sharded by")

    def train_step(state, batch):
        params = state["params"]
        grads, loss, aux = grad_fn(params, batch)
        _, opt, stats = apply_updates(params, grads, state["opt"], opt_cfg,
                                      param_specs, ctx.mesh, moment_specs)
        del grads
        metrics = {"loss": loss, "aux_loss": aux, **stats}
        return {"params": params, "opt": opt}, metrics

    return train_step


def state_shardings(mesh, param_specs: dict,
                    moment_specs: dict | None = None) -> Shardings:
    """The :class:`~repro_torch.sharding.Shardings` of a train state
    whose parameters lie at ``param_specs`` on ``mesh`` and whose
    moments (``m``, ``v`` and int8's residual ``ef``) lie at
    ``moment_specs`` (default the parameters'), the step whole. What a
    checkpoint of a sharded state is saved and restored by; the saved
    leaves are whole, so it restores on one device or another mesh."""
    moments = param_specs if moment_specs is None else moment_specs
    return Shardings(mesh, {"params": param_specs,
                            "opt": {"m": moments, "v": moments,
                                    "ef": moments}})


def init_train_state(cfg, opt_cfg: OptConfig, generator: torch.Generator,
                     device=None) -> dict:
    """Random parameters (``init_params`` from ``generator``), made
    trainable, and a fresh optimizer state on their device."""
    params = init_params(cfg, generator, device)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------

@dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` × the running median — the
    signal a pod controller uses for replace/evict decisions."""
    threshold: float = 2.0
    window: int = 50
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        slow = len(self.times) >= 5 and dt > self.threshold * med
        if slow:
            self.flagged.append((step, dt, med))
        return slow


@dataclass
class Trainer:
    cfg: object
    opt_cfg: OptConfig
    ctx: ShardCtx
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    grad_accum: int = 1
    param_specs: dict | None = None   # under a mesh: the parameters' specs
    moment_specs: dict | None = None  # and the moments' (ZeRO-1)

    def run(self, state, data_iter, n_steps: int, log_every: int = 10):
        """Step ``state`` from its optimizer step to ``n_steps`` on the
        batches of ``data_iter``. A step that raises is tried again up to
        ``max_retries`` times; after the last, the state is restored from
        the latest checkpoint (if any) and the error raised. Returns
        (state, history, monitor); ``history`` holds {step, loss,
        sec_per_step} every ``log_every`` steps and at the end. Under a
        mesh every rank runs it; checkpoints are saved and restored by
        :func:`state_shardings` (rank 0 writes)."""
        step_fn = make_train_step(self.cfg, self.opt_cfg, self.ctx,
                                  self.grad_accum, self.param_specs,
                                  self.moment_specs)
        shardings = None if self.ctx.mesh is None else state_shardings(
            self.ctx.mesh, self.param_specs, self.moment_specs)
        mgr = CheckpointManager(self.ckpt_dir)
        monitor = StragglerMonitor()
        step = int(state["opt"]["step"])
        history = []
        while step < n_steps:
            batch = next(data_iter)
            t0 = time.perf_counter()
            for attempt in range(self.max_retries):
                try:
                    state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])   # waits for the step
                    break
                except Exception:                       # noqa: BLE001
                    if attempt == self.max_retries - 1:
                        # unrecoverable in-process: restart from checkpoint
                        if mgr.list_steps():
                            state = mgr.restore_latest(state, shardings)
                        raise
            dt = time.perf_counter() - t0
            step += 1
            monitor.record(step, dt)
            if step % log_every == 0 or step == n_steps:
                history.append({"step": step, "loss": loss,
                                "sec_per_step": dt})
            if step % self.ckpt_every == 0 or step == n_steps:
                mgr.save(state, step, shardings=shardings)
        mgr.wait()          # drain the async writer before returning
        return state, history, monitor
