"""One new query token against a KV cache: the CUDA kernel's launcher
and its plain PyTorch version.

``q`` (B, Hq, D), ``k_cache`` (B, T, Hkv, D), ``v_cache`` (B, T, Hkv, Dv),
all float32 or all bfloat16, ``pos`` (B,) int32, the absolute position
of the token just inserted; the result is (B, Hq, Dv) in q's type. Slot
``t`` is valid iff ``t < pos + 1`` (a linear cache, so ``pos < T``) or
``t < min(pos + 1, T)`` (``ring``: a sliding-window ring buffer; slot
order does not matter because RoPE was applied at insert). The scaled
scores are softcapped, masked with -2e38 and turned into probabilities
in float32. With ``return_lse`` each gives its output in float32 (a
partial, rounded to q's type only once the ranges are merged) and the
float32 log-sum-exp (B, Hq) of the scaled scores over the valid slots,
and ``pos`` may be -1 (a row with no valid slot: out 0, lse -inf): a
cache cut into slot ranges, each run on its own, is then merged by
:func:`merge_ranges` (tensor-parallel decode over a cache split along
T). The CUDA kernel (``csrc/flash_decode.cu``) cuts each (b, kv
head) pair's cache into ``splits`` ranges of ``chunk`` slots by
:func:`decode_plan`, streams each range through a ring of 32-slot tiles
and combines the ranges in a second, small launch;
:func:`repro_torch.kernels.ops.flash_decode` is the guarded entry point
that picks between the kernel and the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256                  # q is held in registers up to this width
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WARPS = 8                           # warps of one split block
TILE = 32                           # cache slots per tile of the ring
STAGES = 3                          # tiles of the ring
SMS = 132                           # H100 SXM streaming multiprocessors
SM_SHARED_BYTES = 233_472           # shared memory of one SM (228 KB)
CTA_RESERVED_BYTES = 1_024          # shared memory the system keeps per block
MAX_BLOCKS_PER_SM = 2               # blocks per SM the split rule aims at


class DecodePlan(NamedTuple):
    """How ``flash_decode`` launches for one shape: each (b, kv head)
    pair's cache cut into ``splits`` ranges of ``chunk`` slots, ``gr`` q
    heads per block (``gchunks`` blocks per kv head), the dynamic shared
    memory of one block and the blocks of the split launch."""
    splits: int
    chunk: int
    gr: int
    gchunks: int
    shared_bytes: int
    blocks: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def decode_shared_bytes(d: int, dv: int, gr: int, itemsize: int) -> int:
    """Shared memory of one split block (the layout of
    ``csrc/flash_decode.cu``, whose launch refuses other bytes): the ring
    of ``STAGES`` K and V tiles of ``TILE`` rows padded to the 16-byte
    vector, or the warps' float accumulators if larger, then each warp's
    running max and sum per head."""
    vec = 16 // itemsize
    dp, dvp = _round_up(d, vec), _round_up(dv, vec)
    region = max(STAGES * TILE * (dp + dvp) * itemsize, 4 * WARPS * gr * dvp)
    return region + 8 * WARPS * gr


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, t: int, hkv: int, d: int, *, dv: int | None = None,
                g: int = 1, itemsize: int = 2) -> DecodePlan:
    """The launch rule of ``flash_decode``, by shape alone. A block takes
    up to 4 q heads of one kv head (``gr`` 1, 2 or 4 by G). The blocks
    that fit an SM at once (by shared memory, at most 2) times the 132
    SMs is the target; the splits per (b, kv head, head chunk) are that
    target over the pairs, at least 1 and at most T // 32 (each range at
    least one tile), and ``chunk`` = ceil(T / splits), so the ranges are
    even and none is empty."""
    dv = d if dv is None else dv
    gr = 1 if g == 1 else 2 if g == 2 else 4
    gchunks = -(-g // gr)
    shared = decode_shared_bytes(d, dv, gr, itemsize)
    per_sm = max(1, min(MAX_BLOCKS_PER_SM,
                        SM_SHARED_BYTES // (shared + CTA_RESERVED_BYTES)))
    pairs = b * hkv * gchunks
    splits = max(1, min(per_sm * SMS // pairs, t // TILE))
    chunk = -(-t // splits)
    splits = -(-t // chunk)
    return DecodePlan(splits, chunk, gr, gchunks, shared, pairs * splits)


def valid_slots(pos: torch.Tensor, t: int, ring: bool) -> torch.Tensor:
    """(B, T) bool: the cache slots that hold a token."""
    limit = (pos.clamp_max(t - 1) if ring else pos) + 1
    return torch.arange(t, device=pos.device)[None, :] < limit[:, None]


def flash_decode_torch(q, k_cache, v_cache, pos, *,
                       scale: float | None = None,
                       softcap: float | None = None,
                       ring: bool = False, return_lse: bool = False):
    """Plain PyTorch version: one softmax over the whole cache in
    float32, invalid slots given probability 0; with ``return_lse``,
    (out float32, lse (B, Hq) float32), -inf on a row with no valid
    slot."""
    b, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qg = (q.float() * scale).view(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    valid = valid_slots(pos, t, ring)[:, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.where(valid,
                    torch.exp(scores - scores.amax(dim=-1, keepdim=True)),
                    0.0)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    total = p.sum(dim=-1, keepdim=True)
    out = (out / total.clamp_min(1e-30)).reshape(b, hq, dv)
    if not return_lse:
        return out.to(q.dtype)
    lse = scores.amax(dim=-1) + torch.log(total[..., 0])
    return out, lse.reshape(b, hq)


def merge_ranges(outs, lses) -> tuple[torch.Tensor, torch.Tensor]:
    """The attention over a cache from its slot ranges' partials, each
    from ``flash_decode(..., return_lse=True)`` on one range: ``outs``
    (B, Hq, Dv) and ``lses`` (B, Hq) in range order. In float32, in that
    order: lse = log sum_r exp(lse_r), out = sum_r exp(lse_r - lse)
    out_r. Returns (out float32, lse); a range with no valid slot (lse
    -inf) adds nothing."""
    lse = torch.logsumexp(torch.stack([x.float() for x in lses]), dim=0)
    out = None
    for o, x in zip(outs, lses):
        term = torch.exp(x.float() - lse)[..., None] * o.float()
        out = term if out is None else out + term
    return out, lse


@functools.cache
def _library():
    lib = build.load("flash_decode")
    fn = lib.flash_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    lib.flash_decode_shared_bytes.argtypes = [ctypes.c_int] * 4
    lib.flash_decode_shared_bytes.restype = ctypes.c_longlong
    return lib


def flash_decode_cuda(q, k_cache, v_cache, pos, *,
                      scale: float | None = None,
                      softcap: float | None = None,
                      ring: bool = False, return_lse: bool = False):
    """Launch the split kernel and the combine on the current stream of
    the inputs' device, with :func:`decode_plan`'s ranges and one float32
    workspace for the ranges' partials; with ``return_lse`` the combine
    writes a float32 out and the (B, Hq) float32 log-sum-exp (out,
    lse). The cp.async path needs q and
    the caches 16-byte aligned and D, Dv multiples of the 16-byte vector;
    other inputs take the kernel's plain-load copy. Unguarded: the caller
    has checked shapes (D and Dv at most ``MAX_HEAD_DIM``), types,
    contiguity, the range of ``pos`` and that nothing is empty."""
    lib = _library()
    b, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    size = q.element_size()
    plan = decode_plan(b, t, hkv, d, dv=dv, g=hq // hkv, itemsize=size)
    vec = 16 // size
    aligned = (d % vec == 0 and dv % vec == 0
               and all(x.data_ptr() % 16 == 0 for x in (q, k_cache, v_cache)))
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, dv), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    ws = torch.empty(b * hq * plan.splits * (dv + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), ws.data_ptr(), b, t, hq,
            hkv, d,
            dv, plan.splits, plan.chunk, plan.gr, plan.shared_bytes, scale,
            0.0 if softcap is None else softcap, int(ring), int(aligned),
            DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode launch failed: CUDA error {err} "
            f"({lib.flash_decode_error_string(err).decode()})")
    return (out, lse) if return_lse else out
