"""Guarded public wrappers of the port's kernels.

A wrapper checks what it is given and raises on anything its kernel
does not take: shapes, dtypes, one device, contiguity, and the range of
every gather index. The last matters on the card: a CUDA gather does not
clamp an out-of-range index the way XLA does, it reads stray memory or
faults. The check reads the index tensor wherever it lies — on the host
for a CPU tensor, as one device reduction read back before the launch
for a CUDA tensor — so it never silently skips.

Then the wrapper runs the kernel's plain PyTorch version when the
tensors lie on the CPU, and otherwise launches the kernel and adds one
to its ``launches`` count. A CUDA tensor launches the kernel or raises:
there is no fallback.
"""

from __future__ import annotations

import torch

from . import sched_score as _ss
from . import sim_step as _sim


def check_shape(name: str, x: torch.Tensor, shape: tuple[int, ...]) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")


def check_gather_bounds(name: str, idx: torch.Tensor, bound: int) -> None:
    """Every index in ``[0, bound]`` (``bound`` is the sentinel slot)."""
    if idx.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi > bound:
        raise IndexError(f"{name}: indices span [{lo}, {hi}], outside "
                         f"[0, {bound}]")


def _check_tensors(name: str, tensors: dict[str, torch.Tensor],
                   dtypes: dict[str, torch.dtype]) -> torch.device:
    for arg, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}.{arg}: expected a torch.Tensor, got "
                            f"{type(x).__name__}")
        if x.dtype != dtypes[arg]:
            raise TypeError(f"{name}.{arg}: dtype {x.dtype}, expected "
                            f"{dtypes[arg]}")
        if not x.is_contiguous():
            raise ValueError(f"{name}.{arg}: must be contiguous")
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    return device


def sim_relax_pop(pred, lat, volbw, duration, release, *,
                  n_steps: int) -> torch.Tensor:
    """``n_steps`` sparse max-plus sweeps (see :mod:`.sim_step`): int32
    ``pred`` (B, S, P+1) with sentinel ``S``, float32 ``lat``/``volbw``
    (B, S, P+1), float32 ``duration``/``release`` (B, S), all contiguous
    on one device. Returns (B, S) float32 finish times."""
    device = _check_tensors(
        "sim_relax_pop",
        dict(pred=pred, lat=lat, volbw=volbw, duration=duration,
             release=release),
        dict(pred=torch.int32, lat=torch.float32, volbw=torch.float32,
             duration=torch.float32, release=torch.float32))
    if pred.dim() != 3:
        raise ValueError(f"sim_relax_pop.pred: expected (B, S, P+1), got "
                         f"shape {tuple(pred.shape)}")
    b, s, p1 = pred.shape
    check_shape("sim_relax_pop.lat", lat, (b, s, p1))
    check_shape("sim_relax_pop.volbw", volbw, (b, s, p1))
    check_shape("sim_relax_pop.duration", duration, (b, s))
    check_shape("sim_relax_pop.release", release, (b, s))
    if n_steps < 0:
        raise ValueError(f"sim_relax_pop: n_steps {n_steps} < 0")
    # the kernel gathers end[pred] from an (S+1)-slot buffer whose last
    # slot is the zero sentinel; anything past it reads garbage
    check_gather_bounds("sim_relax_pop.pred", pred, s)
    if device.type == "cpu":
        return _sim.sim_relax_pop_torch(pred, lat, volbw, duration, release,
                                        n_steps=n_steps)
    if _sim.shared_bytes(s) > _sim.MAX_SHARED_BYTES:
        raise ValueError(
            f"sim_relax_pop: S={s} needs {_sim.shared_bytes(s)} bytes of "
            f"shared memory per block, more than the "
            f"{_sim.MAX_SHARED_BYTES} a block may use")
    if b == 0 or s == 0:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    out = _sim.sim_relax_pop_cuda(pred, lat, volbw, duration, release,
                                  n_steps=n_steps)
    sim_relax_pop.launches += 1
    return out


sim_relax_pop.launches = 0


def sched_score(drain, frontiers, release) -> torch.Tensor:
    """The (apps × cores) admission screening matrix
    ``max(frontier[j], release[i]) + drain[i, j]`` (see
    :mod:`.sched_score`): float32 ``drain`` (A, C), ``frontiers`` (C,),
    ``release`` (A,), all contiguous on one device. Returns (A, C)
    float32. NaN propagates as in ``np.maximum``."""
    device = _check_tensors(
        "sched_score", dict(drain=drain, frontiers=frontiers,
                            release=release),
        dict(drain=torch.float32, frontiers=torch.float32,
             release=torch.float32))
    if drain.dim() != 2:
        raise ValueError(f"sched_score.drain: expected (A, C), got shape "
                         f"{tuple(drain.shape)}")
    a, c = drain.shape
    check_shape("sched_score.frontiers", frontiers, (c,))
    check_shape("sched_score.release", release, (a,))
    if device.type == "cpu":
        return _ss.sched_score_torch(drain, frontiers, release)
    if a == 0 or c == 0:
        return torch.empty((a, c), dtype=torch.float32, device=device)
    out = _ss.sched_score_cuda(drain, frontiers, release)
    sched_score.launches += 1
    return out


sched_score.launches = 0
