"""Training step + fault-tolerant loop on one device.

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
returns the same state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..checkpoint.ckpt import CheckpointManager
from ..models.layers import cross_entropy
from ..models.model import ShardCtx, forward, init_params
from ..optim.adamw import OptConfig, apply_updates, init_opt_state

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


def make_train_step(cfg, opt_cfg: OptConfig, ctx: ShardCtx,
                    grad_accum: int = 1):
    """Returns train_step(state, batch) -> (state, metrics). ``batch``
    leaves are (B, ...) tensors on the parameters' device; with
    ``grad_accum`` > 1 they are cut into that many microbatches whose
    gradients are summed in float32 and averaged. ``metrics``: ``loss``,
    ``aux_loss``, ``grad_norm``, ``lr`` as float32 tensors."""
    loss_fn = make_loss_fn(cfg, ctx)

    def grads_of(params, micro):
        params.zero_grad(set_to_none=True)
        total, (loss, aux) = loss_fn(params, micro)
        total.backward()
        grads = {k: p.grad for k, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        return grads, loss.detach(), torch.as_tensor(aux).detach()

    def train_step(state, batch):
        params = state["params"]
        params.requires_grad_(True)
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
        _, opt, stats = apply_updates(params, grads, state["opt"], opt_cfg)
        del grads
        metrics = {"loss": loss, "aux_loss": aux, **stats}
        return {"params": params, "opt": opt}, metrics

    return train_step


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

    def run(self, state, data_iter, n_steps: int, log_every: int = 10):
        """Step ``state`` from its optimizer step to ``n_steps`` on the
        batches of ``data_iter``. A step that raises is tried again up to
        ``max_retries`` times; after the last, the state is restored from
        the latest checkpoint (if any) and the error raised. Returns
        (state, history, monitor); ``history`` holds {step, loss,
        sec_per_step} every ``log_every`` steps and at the end."""
        step_fn = make_train_step(self.cfg, self.opt_cfg, self.ctx,
                                  self.grad_accum)
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
                            state = mgr.restore_latest(state)
                        raise
            dt = time.perf_counter() - t0
            step += 1
            monitor.record(step, dt)
            if step % log_every == 0 or step == n_steps:
                history.append({"step": step, "loss": loss,
                                "sec_per_step": dt})
            if step % self.ckpt_every == 0 or step == n_steps:
                mgr.save(state, step)
        mgr.wait()          # drain the async writer before returning
        return state, history, monitor
