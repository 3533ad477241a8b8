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

from . import adamw as _aw
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
    need = _sim.pop_plan(b, s, p1).shared_bytes
    if need > _sim.MAX_SHARED_BYTES:
        raise ValueError(
            f"sim_relax_pop: S={s} needs {need} bytes of shared memory per "
            f"block, more than the {_sim.MAX_SHARED_BYTES} a block may use")
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
    """What ``n_steps`` dense max-plus sweeps from all-zero ends give (see
    :mod:`.sim_step`), inputs as :func:`sim_step` without ``end``.
    Returns (B, S) float32 finish times. ``launches`` counts calls that
    ran the kernels; ``variants`` counts, per variant (``"compact"``: the
    lags compacted on the card and relaxed to each row's fixpoint;
    ``"dense"``: the ``n_steps`` sweeps), the calls in which it gave at
    least one scenario's result."""
    device, b, s = _check_dense("sim_relax", None, lat, volbw, duration,
                                release)
    if n_steps < 0:
        raise ValueError(f"sim_relax: n_steps {n_steps} < 0")
    if b == 0 or s == 0 or n_steps == 0:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    if device.type == "cpu":
        return _sim.sim_relax_torch(lat, volbw, duration, release,
                                    n_steps=n_steps)
    out, info = _sim.sim_relax_cuda(lat, volbw, duration, release,
                                    n_steps=n_steps, with_info=True)
    sim_relax.launches += 1
    sim_relax.variants["compact"] += int(info.compact.any())
    sim_relax.variants["dense"] += int(not info.compact.all())
    return out


sim_relax.launches = 0
sim_relax.variants = {"compact": 0, "dense": 0}


def sched_score(drain, frontiers, release, *, row_min: bool = False):
    """The (apps × cores) admission screening matrix
    ``max(frontier[j], release[i]) + drain[i, j]`` (see
    :mod:`.sched_score`): float32 ``drain`` (A, C), ``frontiers`` (C,),
    ``release`` (A,), all contiguous on one device. Returns (A, C)
    float32; with ``row_min``, ``(matrix, row minima (A,))`` from the
    same launch (C must then be non-zero). NaN propagates as in
    ``np.maximum`` and ``ndarray.min``."""
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
    if row_min and c == 0:
        raise ValueError("sched_score: row minima of zero columns")
    if device.type == "cpu":
        return _ss.sched_score_torch(drain, frontiers, release,
                                     row_min=row_min)
    if a == 0 or c == 0:
        out = torch.empty((a, c), dtype=torch.float32, device=device)
        return (out, out.new_empty((a,))) if row_min else out
    out = _ss.sched_score_cuda(drain, frontiers, release, row_min=row_min)
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
                             window=None, tensors=None) -> None:
    """What the kernels of ``name`` cannot take; ``tensors`` (q, k, v),
    where given, are also held to :func:`flash_attention.refusal` on the
    card (the bfloat16 kernel's TMA loads)."""
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
    if device.type == "cuda" and tensors is not None:
        why = _fa.refusal(*tensors)
        if why is not None:
            raise ValueError(f"{name}: {why}")


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


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-6, zero_centered: bool = True):
    """The gradients of :func:`rmsnorm` (see :mod:`.rmsnorm`): ``x`` and
    ``dy`` (..., d) of one type, ``w`` (d,), each float32 or bfloat16,
    contiguous on one device; on the card d at most
    :data:`.rmsnorm.MAX_BWD_WIDTH`. Returns (dx in x's type and shape,
    dw in w's)."""
    device = _check_tensors("rmsnorm_bwd", dict(x=x, w=w, dy=dy),
                            dict(x=FLOAT_TYPES, w=FLOAT_TYPES,
                                 dy=FLOAT_TYPES))
    _check_one_type("rmsnorm_bwd", x=x, dy=dy)
    if x.dim() == 0:
        raise ValueError("rmsnorm_bwd.x: expected (..., d), got a scalar")
    check_shape("rmsnorm_bwd.w", w, (x.shape[-1],))
    check_shape("rmsnorm_bwd.dy", dy, tuple(x.shape))
    if device.type == "cpu":
        return _rn.rmsnorm_bwd_torch(x, w, dy, eps=eps,
                                     zero_centered=zero_centered)
    if x.shape[-1] > _rn.MAX_BWD_WIDTH:
        raise ValueError(f"rmsnorm_bwd: width {x.shape[-1]} above the "
                         f"kernel's {_rn.MAX_BWD_WIDTH}")
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros_like(w)
    out = _rn.rmsnorm_bwd_cuda(x, w, dy, eps=eps, zero_centered=zero_centered)
    rmsnorm_bwd.launches += 1
    return out


rmsnorm_bwd.launches = 0


def _check_prefix(name: str, prefix_len, b: int, device) -> None:
    if prefix_len is None:
        return
    _check_tensors(name, dict(prefix_len=prefix_len),
                   dict(prefix_len=torch.int32))
    check_shape(f"{name}.prefix_len", prefix_len, (b,))
    if prefix_len.device != device:
        raise ValueError(f"{name}: prefix_len on {prefix_len.device}, the "
                         f"inputs on {device}")


def _check_qkv(name: str, q, k, v) -> torch.device:
    device = _check_tensors(name, dict(q=q, k=k, v=v),
                            dict(q=FLOAT_TYPES, k=FLOAT_TYPES,
                                 v=FLOAT_TYPES))
    _check_one_type(name, q=q, k=k, v=v)
    for arg, x in (("q", q), ("k", k), ("v", v)):
        _check_rank(f"{name}.{arg}", x, 4, "(B, S, H, D)")
    b, _, _, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    check_shape(f"{name}.k", k, (b, sk, hkv, d))
    check_shape(f"{name}.v", v, (b, sk, hkv, dv))
    return device


def _check_offset(name: str, q_offset, sq: int, sk: int) -> None:
    """``q_offset``: a host int with ``0 <= q_offset`` and ``q_offset +
    Sq <= Sk`` (every query row's position has its key)."""
    if isinstance(q_offset, bool) or not isinstance(q_offset, int):
        raise TypeError(f"{name}: q_offset must be a host int, not "
                        f"{type(q_offset).__name__}")
    if q_offset < 0 or q_offset + sq > sk:
        raise ValueError(f"{name}: q_offset {q_offset} with {sq} query rows "
                         f"does not fit {sk} keys (0 <= q_offset, q_offset "
                         f"+ Sq <= Sk)")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None,
                    softcap: float | None = None,
                    prefix_len: torch.Tensor | None = None,
                    return_lse: bool = False, q_offset: int = 0):
    """Prefill attention (see :mod:`.flash_attention`): ``q`` (B, Sq,
    Hq, D), ``k`` (B, Sk, Hkv, D), ``v`` (B, Sk, Hkv, Dv), one type
    (float32 or bfloat16), contiguous on one device; Hq a multiple of
    Hkv, ``window`` None or >= 1, ``softcap`` None or > 0,
    ``prefix_len`` None or int32 (B,) on the same device (the prefix-LM
    mask, read when ``causal``), ``q_offset`` a host int, the global
    position of query row 0, with ``q_offset + Sq <= Sk``; on the card,
    head dims at most 256, and for bfloat16 multiples of 8 with 16-byte
    aligned tensors (:func:`.flash_attention.refusal`). Returns (B, Sq,
    Hq, Dv) in q's type; with ``return_lse``, ``(out, lse)``, lse (B, Hq,
    Sq) float32."""
    device = _check_qkv("flash_attention", q, k, v)
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    _check_offset("flash_attention", q_offset, s, k.shape[1])
    _check_attention_options("flash_attention", hq, hkv, d, dv, softcap,
                             device, window, tensors=(q, k, v))
    _check_prefix("flash_attention", prefix_len, b, device)
    kw = dict(causal=causal, scale=scale, window=window, softcap=softcap,
              prefix_len=prefix_len, return_lse=return_lse,
              q_offset=q_offset)
    if device.type == "cpu":
        return _fa.flash_attention_torch(q, k, v, **kw)
    if q.numel() == 0 or v.numel() == 0:
        out = torch.zeros((b, s, hq, dv), dtype=q.dtype, device=device)
        return (out, torch.zeros((b, hq, s), dtype=torch.float32,
                                 device=device)) if return_lse else out
    out = _fa.flash_attention_cuda(q, k, v, **kw)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        scale: float | None = None,
                        window: int | None = None,
                        softcap: float | None = None,
                        prefix_len: torch.Tensor | None = None,
                        q_offset: int = 0):
    """The gradients of :func:`flash_attention` (see
    :mod:`.flash_attention`): ``q``, ``k``, ``v`` as there, ``out`` and
    ``dout`` (B, Sq, Hq, Dv) of their type, ``lse`` (B, Hq, Sq) float32
    from the forward with ``return_lse``, the forward's options (and
    ``q_offset``); dq has q's shape, dk and dv k's and v's; all
    contiguous on one device; on the card head dims at most 256, and for
    bfloat16 what :func:`.flash_attention.refusal` takes (head dims
    multiples of 8, q, k, v 16-byte aligned) with dout 16-byte aligned.
    Returns (dq, dk, dv) in the inputs' type. ``launches`` counts calls
    that ran the kernels: float32 three launches each (delta, dK/dV,
    dQ), bfloat16 three, or four where :func:`.flash_attention.bwd_plan`
    splits the dK/dV blocks (delta, dK/dV, the partials' sum, dQ)."""
    device = _check_qkv("flash_attention_bwd", q, k, v)
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    _check_tensors("flash_attention_bwd", dict(out=out, dout=dout, lse=lse),
                   dict(out=q.dtype, dout=q.dtype, lse=torch.float32))
    check_shape("flash_attention_bwd.out", out, (b, s, hq, dv))
    check_shape("flash_attention_bwd.dout", dout, (b, s, hq, dv))
    check_shape("flash_attention_bwd.lse", lse, (b, hq, s))
    if len({x.device for x in (q, out, dout, lse)}) != 1:
        raise ValueError("flash_attention_bwd: inputs on several devices")
    _check_offset("flash_attention_bwd", q_offset, s, k.shape[1])
    _check_attention_options("flash_attention_bwd", hq, hkv, d, dv, softcap,
                             device, window, tensors=(q, k, v))
    if device.type == "cuda" and q.dtype == torch.bfloat16 \
            and dout.data_ptr() % 16:
        raise ValueError("flash_attention_bwd: dout not 16-byte aligned, "
                         "which the bfloat16 kernel's loads need")
    _check_prefix("flash_attention_bwd", prefix_len, b, device)
    kw = dict(causal=causal, scale=scale, window=window, softcap=softcap,
              prefix_len=prefix_len, q_offset=q_offset)
    if device.type == "cpu":
        return _fa.flash_attention_bwd_torch(q, k, v, out, dout, lse, **kw)
    if q.numel() == 0 or v.numel() == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    grads = _fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0


def flash_decode(q, k_cache, v_cache, pos, *, scale: float | None = None,
                 softcap: float | None = None, ring: bool = False,
                 return_lse: bool = False):
    """Decode attention of one token (see :mod:`.flash_decode`): ``q``
    (B, Hq, D), ``k_cache`` (B, T, Hkv, D), ``v_cache`` (B, T, Hkv, Dv),
    one type (float32 or bfloat16), int32 ``pos`` (B,), contiguous on
    one device. ``pos`` is the absolute position of the token just
    inserted: at least 0, and at most T - 1 for a linear cache (stricter
    than the reference wrapper, whose kernel lets a zero padding slot
    into the softmax at ``pos == T``). Returns (B, Hq, Dv) in q's type.
    With ``return_lse`` returns (out float32, lse (B, Hq) float32, the
    log-sum-exp of the scaled scores) and takes ``pos`` -1 for a row with
    no valid slot (out 0, lse -inf, no cache read): one slot range of a
    cache split over ranks, merged by
    :func:`.flash_decode.merge_ranges`."""
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
        # the pos range guard: one read-back per call (moving it out of
        # the call is the CUDA-graph work)
        lo, hi = torch.stack(torch.aminmax(pos)).tolist()  # lint: sync-ok
        top = None if ring else t - 1
        bottom = -1 if return_lse else 0
        if lo < bottom or (top is not None and hi > top):
            raise IndexError(f"flash_decode.pos: positions span [{lo}, {hi}]"
                             f", outside [{bottom}, "
                             f"{'inf' if top is None else top}]"
                             f" ({'ring' if ring else 'linear'} cache of "
                             f"{t} slots)")
    kw = dict(scale=scale, softcap=softcap, ring=ring, return_lse=return_lse)
    if device.type == "cpu":
        return _fd.flash_decode_torch(q, k_cache, v_cache, pos, **kw)
    if q.numel() == 0 or v_cache.numel() == 0:
        if return_lse:
            return (torch.zeros((b, hq, dv), device=device),
                    torch.full((b, hq), -torch.inf, device=device))
        return torch.zeros((b, hq, dv), dtype=q.dtype, device=device)
    out = _fd.flash_decode_cuda(q, k_cache, v_cache, pos, **kw)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _check_scan(name, x, dt, A, B, C, chunk) -> torch.device:
    device = _check_tensors(
        name, dict(x=x, dt=dt, A=A, B=B, C=C),
        dict(x=FLOAT_TYPES, dt=torch.float32, A=torch.float32,
             B=FLOAT_TYPES, C=FLOAT_TYPES))
    _check_one_type(name, x=x, B=B, C=C)
    _check_rank(f"{name}.x", x, 4, "(B, S, H, P)")
    _check_rank(f"{name}.B", B, 4, "(B, S, G, N)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    check_shape(f"{name}.dt", dt, (b, s, h))
    check_shape(f"{name}.A", A, (h,))
    check_shape(f"{name}.B", B, (b, s, g, n))
    check_shape(f"{name}.C", C, (b, s, g, n))
    if g == 0 or h % g:
        raise ValueError(f"{name}: {g} groups do not divide {h} heads")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"{name}: chunk {chunk!r} must be an int >= 1")
    return device


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """The Mamba-2 SSD chunked scan (see :mod:`.ssd_scan`): ``x`` (B, S,
    H, P), float32 ``dt`` (B, S, H), float32 ``A`` (H,), ``B``/``C`` (B, S,
    G, N) with G dividing H; x, B and C of one type (float32 or
    bfloat16), all contiguous on one device; ``chunk`` >= 1 and any S
    (the ragged tail acts as ``dt = 0`` padding). Returns (y (B, S, H,
    P), final state (B, H, P, N)), both in x's type."""
    device = _check_scan("ssd_scan", x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[3]
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


def ssd_scan_bwd(x, dt, A, B, C, dy, dfinal=None, chunk: int = 256):
    """The gradients of :func:`ssd_scan` (see :mod:`.ssd_scan`): its
    inputs as there, ``dy`` (B, S, H, P) in x's type and ``dfinal`` (B,
    H, P, N) in x's type or None (no gradient reaches the final state),
    contiguous on the inputs' device. Returns (dx, ddt, dA, dB, dC): dx,
    dB and dC in x's type, ddt (B, S, H) and dA (H,) float32.
    ``launches`` counts calls that ran the kernels (four launches each:
    the states and their gradients carried over the chunks with C B^T
    per group; both sides of each causal tile pair with dCB summed over
    each group's heads; dB and dC per group; the reverse cumsum, ddt and
    dA)."""
    name = "ssd_scan_bwd"
    device = _check_scan(name, x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[3]
    grads = dict(dy=dy) if dfinal is None else dict(dy=dy, dfinal=dfinal)
    _check_tensors(name, grads, dict(dy=x.dtype, dfinal=x.dtype))
    check_shape(f"{name}.dy", dy, (b, s, h, p))
    if dfinal is not None:
        check_shape(f"{name}.dfinal", dfinal, (b, h, p, n))
    if len({t.device for t in (x, *grads.values())}) != 1:
        raise ValueError(f"{name}: inputs on several devices")
    if device.type == "cpu":
        return _ssd.ssd_scan_bwd_torch(x, dt, A, B, C, dy, dfinal, chunk)
    why = _ssd.bwd_refusal(p, n, chunk, x.dtype)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if x.numel() == 0 or n == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(B),
                torch.zeros_like(C))
    grads = _ssd.ssd_scan_bwd_cuda(x, dt, A, B, C, dy, dfinal, chunk)
    ssd_scan_bwd.launches += 1
    return grads


ssd_scan_bwd.launches = 0


def _check_lists(name: str, lists: dict[str, list],
                 dtypes: dict[str, torch.dtype | tuple[torch.dtype, ...]]
                 ) -> torch.device:
    """Lists of tensors of one length, each tensor of its list's types,
    contiguous, all on one device; the i-th tensor of every list of the
    first one's shape. One pass, hundreds of tensors a call: a tensor's
    message is formed only where it fails."""
    first, *others = lists
    n = len(lists[first])
    if n == 0:
        raise ValueError(f"{name}: no tensors")
    devices = set()
    for arg, xs in lists.items():
        if len(xs) != n:
            raise ValueError(f"{name}.{arg}: {len(xs)} tensors, {first} "
                             f"has {n}")
        want = dtypes[arg] if isinstance(dtypes[arg], tuple) \
            else (dtypes[arg],)
        for i, x in enumerate(xs):
            if not isinstance(x, torch.Tensor) or x.dtype not in want \
                    or not x.is_contiguous():
                _check_tensors(name, {f"{arg}[{i}]": x},
                               {f"{arg}[{i}]": dtypes[arg]})
            devices.add(x.device)
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    for i, x in enumerate(lists[first]):
        for arg in others:
            if lists[arg][i].shape != x.shape:
                check_shape(f"{name}.{arg}[{i}]", lists[arg][i],
                            tuple(x.shape))
    return device


def grad_sumsq(grads) -> torch.Tensor:
    """The sum of squares of each gradient (see :mod:`.adamw`): ``grads``
    a non-empty list of float32 or bfloat16 tensors, contiguous on one
    device. Returns float32 (len(grads),). ``launches`` counts calls that
    ran the kernels (two launches each: the chunks' partials, then each
    tensor's sum of them in a fixed order)."""
    grads = list(grads)
    device = _check_lists("grad_sumsq", dict(grads=grads),
                          dict(grads=FLOAT_TYPES))
    if device.type == "cpu":
        return _aw.grad_sumsq_torch(grads)
    out = _aw.grad_sumsq_cuda(grads)
    grad_sumsq.launches += 1
    return out


grad_sumsq.launches = 0


def adamw_update(params, grads, ms, vs, *, clip, lr, b1c, b2c, b1: float,
                 b2: float, eps: float, weight_decay: float) -> None:
    """One AdamW update of every tensor in place (see :mod:`.adamw`):
    lists ``params`` and ``grads`` (float32 or bfloat16, each its own)
    and ``ms``, ``vs`` (float32), the i-th of each of one shape; float32
    scalar tensors ``clip``, ``lr``, ``b1c``, ``b2c``; all contiguous on
    one device. ``launches`` counts calls that ran the kernel (one launch
    each), ``tensors`` the parameter tensors those calls updated."""
    lists = [list(xs) for xs in (params, grads, ms, vs)]
    device = _check_lists(
        "adamw_update", dict(zip(("params", "grads", "ms", "vs"), lists)),
        dict(params=FLOAT_TYPES, grads=FLOAT_TYPES, ms=torch.float32,
             vs=torch.float32))
    scalars = dict(clip=clip, lr=lr, b1c=b1c, b2c=b2c)
    if _check_tensors("adamw_update", scalars,
                      dict.fromkeys(scalars, torch.float32)) != device:
        raise ValueError(f"adamw_update: scalars on another device than "
                         f"the tensors' {device}")
    for arg, x in scalars.items():
        check_shape(f"adamw_update.{arg}", x, ())
    kw = dict(clip=clip, lr=lr, b1c=b1c, b2c=b2c, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if device.type == "cpu":
        _aw.adamw_update_torch(*lists, **kw)
        return
    _aw.adamw_update_cuda(*lists, **kw)
    adamw_update.launches += 1
    adamw_update.tensors += len(lists[0])


adamw_update.launches = 0
adamw_update.tensors = 0
