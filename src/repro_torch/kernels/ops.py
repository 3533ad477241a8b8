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

from . import flash_attention as _fa
from . import flash_decode as _fd
from . import rmsnorm as _rn
from . import sched_score as _ss
from . import sim_step as _sim
from . import ssd_scan as _ssd

FLOAT_TYPES = (torch.float32, torch.bfloat16)


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
                   dtypes: dict[str, torch.dtype | tuple[torch.dtype, ...]]
                   ) -> torch.device:
    for arg, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}.{arg}: expected a torch.Tensor, got "
                            f"{type(x).__name__}")
        want = dtypes[arg]
        if x.dtype not in (want if isinstance(want, tuple) else (want,)):
            raise TypeError(f"{name}.{arg}: dtype {x.dtype}, expected "
                            f"{want}")
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


def _check_dense(name: str, end, lat, volbw, duration, release
                 ) -> tuple[torch.device, int, int]:
    """Types, contiguity, one device and the (B, S) / (B, S, S) shapes of
    a dense sweep's inputs (``end`` may be None: ``sim_relax``)."""
    tensors = dict(lat=lat, volbw=volbw, duration=duration, release=release)
    if end is not None:
        tensors["end"] = end
    device = _check_tensors(name, tensors,
                            {arg: torch.float32 for arg in tensors})
    _check_rank(f"{name}.lat", lat, 3, "(B, S, S)")
    b, s = lat.shape[:2]
    check_shape(f"{name}.lat", lat, (b, s, s))
    check_shape(f"{name}.volbw", volbw, (b, s, s))
    check_shape(f"{name}.duration", duration, (b, s))
    check_shape(f"{name}.release", release, (b, s))
    if end is not None:
        check_shape(f"{name}.end", end, (b, s))
    if device.type == "cuda" and s > 0:
        why = _sim.dense_refusal(s)
        if why is not None:
            raise ValueError(f"{name}: {why}")
    return device, b, s


def sim_step(end, lat, volbw, duration, release) -> torch.Tensor:
    """One dense max-plus sweep (see :mod:`.sim_step`): float32 ``end``,
    ``duration``, ``release`` (B, S) and ``lat``/``volbw`` (B, S, S) with
    ``-inf`` non-edges, all contiguous on one device. Returns (B, S)
    float32. NaN propagates as in ``torch.amax``."""
    device, b, s = _check_dense("sim_step", end, lat, volbw, duration,
                                release)
    if b == 0 or s == 0:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    if device.type == "cpu":
        return _sim.sim_step_torch(end, lat, volbw, duration, release)
    out = _sim.sim_step_cuda(end, lat, volbw, duration, release)
    sim_step.launches += 1
    return out


sim_step.launches = 0


def sim_relax(lat, volbw, duration, release, *,
              n_steps: int) -> torch.Tensor:
    """``n_steps`` dense max-plus sweeps from all-zero ends (see
    :mod:`.sim_step`), inputs as :func:`sim_step` without ``end``.
    Returns (B, S) float32 finish times. ``launches`` counts calls that
    ran the kernel (each runs ``n_steps`` sweeps)."""
    device, b, s = _check_dense("sim_relax", None, lat, volbw, duration,
                                release)
    if n_steps < 0:
        raise ValueError(f"sim_relax: n_steps {n_steps} < 0")
    if b == 0 or s == 0 or n_steps == 0:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    if device.type == "cpu":
        return _sim.sim_relax_torch(lat, volbw, duration, release,
                                    n_steps=n_steps)
    out = _sim.sim_relax_cuda(lat, volbw, duration, release, n_steps=n_steps)
    sim_relax.launches += 1
    return out


sim_relax.launches = 0


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


def _check_one_type(name: str, **tensors: torch.Tensor) -> None:
    types = {arg: x.dtype for arg, x in tensors.items()}
    if len(set(types.values())) != 1:
        raise TypeError(f"{name}: inputs of several dtypes {types}")


def _check_rank(name: str, x: torch.Tensor, rank: int, layout: str) -> None:
    if x.dim() != rank:
        raise ValueError(f"{name}: expected {layout}, got shape "
                         f"{tuple(x.shape)}")


def _check_attention_options(name: str, hq: int, hkv: int, d: int, dv: int,
                             softcap, device: torch.device,
                             window=None) -> None:
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: {hq} q heads are not a multiple of "
                         f"{hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap {softcap} must be > 0")
    if device.type == "cuda" and max(d, dv) > _fa.MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dims ({d}, {dv}) exceed the "
                         f"kernel's {_fa.MAX_HEAD_DIM}")


def rmsnorm(x, w, *, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    """Row RMSNorm over the last axis (see :mod:`.rmsnorm`): ``x``
    (..., d) and ``w`` (d,), each float32 or bfloat16, contiguous on one
    device. Returns x's shape and type. ``zero_centered`` scales by
    ``1 + w`` computed in float32."""
    device = _check_tensors("rmsnorm", dict(x=x, w=w),
                            dict(x=FLOAT_TYPES, w=FLOAT_TYPES))
    if x.dim() == 0:
        raise ValueError("rmsnorm.x: expected (..., d), got a scalar")
    check_shape("rmsnorm.w", w, (x.shape[-1],))
    if device.type == "cpu":
        return _rn.rmsnorm_torch(x, w, eps=eps, zero_centered=zero_centered)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _rn.rmsnorm_cuda(x, w, eps=eps, zero_centered=zero_centered)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Prefill attention (see :mod:`.flash_attention`): ``q`` (B, S, Hq,
    D), ``k`` (B, S, Hkv, D), ``v`` (B, S, Hkv, Dv), one type (float32
    or bfloat16), contiguous on one device; Hq a multiple of Hkv,
    ``window`` None or >= 1, ``softcap`` None or > 0. Returns (B, S, Hq,
    Dv) in q's type."""
    device = _check_tensors("flash_attention", dict(q=q, k=k, v=v),
                            dict(q=FLOAT_TYPES, k=FLOAT_TYPES,
                                 v=FLOAT_TYPES))
    _check_one_type("flash_attention", q=q, k=k, v=v)
    for arg, x in (("q", q), ("k", k), ("v", v)):
        _check_rank(f"flash_attention.{arg}", x, 4, "(B, S, H, D)")
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    check_shape("flash_attention.k", k, (b, s, hkv, d))
    check_shape("flash_attention.v", v, (b, s, hkv, dv))
    _check_attention_options("flash_attention", hq, hkv, d, dv, softcap,
                             device, window)
    if device.type == "cpu":
        return _fa.flash_attention_torch(q, k, v, causal=causal, scale=scale,
                                         window=window, softcap=softcap)
    if q.numel() == 0 or v.numel() == 0:
        return torch.zeros((b, s, hq, dv), dtype=q.dtype, device=device)
    out = _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                   window=window, softcap=softcap)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_decode(q, k_cache, v_cache, pos, *, scale: float | None = None,
                 softcap: float | None = None,
                 ring: bool = False) -> torch.Tensor:
    """Decode attention of one token (see :mod:`.flash_decode`): ``q``
    (B, Hq, D), ``k_cache`` (B, T, Hkv, D), ``v_cache`` (B, T, Hkv, Dv),
    one type (float32 or bfloat16), int32 ``pos`` (B,), contiguous on
    one device. ``pos`` is the absolute position of the token just
    inserted: at least 0, and at most T - 1 for a linear cache (stricter
    than the reference wrapper, whose kernel lets a zero padding slot
    into the softmax at ``pos == T``). Returns (B, Hq, Dv) in q's type."""
    device = _check_tensors(
        "flash_decode", dict(q=q, k_cache=k_cache, v_cache=v_cache, pos=pos),
        dict(q=FLOAT_TYPES, k_cache=FLOAT_TYPES, v_cache=FLOAT_TYPES,
             pos=torch.int32))
    _check_one_type("flash_decode", q=q, k_cache=k_cache, v_cache=v_cache)
    _check_rank("flash_decode.q", q, 3, "(B, Hq, D)")
    _check_rank("flash_decode.k_cache", k_cache, 4, "(B, T, Hkv, D)")
    _check_rank("flash_decode.v_cache", v_cache, 4, "(B, T, Hkv, Dv)")
    b, hq, d = q.shape
    t, hkv, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    check_shape("flash_decode.k_cache", k_cache, (b, t, hkv, d))
    check_shape("flash_decode.v_cache", v_cache, (b, t, hkv, dv))
    check_shape("flash_decode.pos", pos, (b,))
    _check_attention_options("flash_decode", hq, hkv, d, dv, softcap, device)
    if t == 0:
        raise ValueError("flash_decode: empty cache (T = 0)")
    if pos.numel():
        lo, hi = torch.stack(torch.aminmax(pos)).tolist()   # one sync
        top = None if ring else t - 1
        if lo < 0 or (top is not None and hi > top):
            raise IndexError(f"flash_decode.pos: positions span [{lo}, {hi}]"
                             f", outside [0, {'inf' if top is None else top}]"
                             f" ({'ring' if ring else 'linear'} cache of "
                             f"{t} slots)")
    if device.type == "cpu":
        return _fd.flash_decode_torch(q, k_cache, v_cache, pos, scale=scale,
                                      softcap=softcap, ring=ring)
    if q.numel() == 0 or v_cache.numel() == 0:
        return torch.zeros((b, hq, dv), dtype=q.dtype, device=device)
    out = _fd.flash_decode_cuda(q, k_cache, v_cache, pos, scale=scale,
                                softcap=softcap, ring=ring)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """The Mamba-2 SSD chunked scan (see :mod:`.ssd_scan`): ``x`` (B, S,
    H, P), float32 ``dt`` (B, S, H), float32 ``A`` (H,), ``B``/``C`` (B, S,
    G, N) with G dividing H; x, B and C of one type (float32 or
    bfloat16), all contiguous on one device; ``chunk`` >= 1 and any S
    (the ragged tail acts as ``dt = 0`` padding). Returns (y (B, S, H,
    P), final state (B, H, P, N)), both in x's type."""
    device = _check_tensors(
        "ssd_scan", dict(x=x, dt=dt, A=A, B=B, C=C),
        dict(x=FLOAT_TYPES, dt=torch.float32, A=torch.float32,
             B=FLOAT_TYPES, C=FLOAT_TYPES))
    _check_one_type("ssd_scan", x=x, B=B, C=C)
    _check_rank("ssd_scan.x", x, 4, "(B, S, H, P)")
    _check_rank("ssd_scan.B", B, 4, "(B, S, G, N)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    check_shape("ssd_scan.dt", dt, (b, s, h))
    check_shape("ssd_scan.A", A, (h,))
    check_shape("ssd_scan.B", B, (b, s, g, n))
    check_shape("ssd_scan.C", C, (b, s, g, n))
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: {g} groups do not divide {h} heads")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk!r} must be an int >= 1")
    if device.type == "cpu":
        return _ssd.ssd_scan_torch(x, dt, A, B, C, chunk)
    why = _ssd.refusal(p, n, chunk)
    if why is not None:
        raise ValueError(f"ssd_scan: {why}")
    if x.numel() == 0 or n == 0:
        return (torch.zeros_like(x),
                torch.zeros((b, h, p, n), dtype=x.dtype, device=device))
    out = _ssd.ssd_scan_cuda(x, dt, A, B, C, chunk)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0
