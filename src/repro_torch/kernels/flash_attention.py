"""Attention with an online softmax, forward and backward: the CUDA
kernels' launchers and their plain PyTorch versions.

``q`` (B, Sq, Hq, D), ``k`` (B, Sk, Hkv, D), ``v`` (B, Sk, Hkv, Dv), all
float32 or all bfloat16; the result is (B, Sq, Hq, Dv) in q's type. GQA:
q head ``h`` attends kv head ``h // (Hq // Hkv)``. Query row ``i`` sits
at global position ``q_offset + i`` (a host int, 0 unless the queries
are a chunk of a longer sequence whose keys are all given, as in
sequence-parallel attention; ``q_offset + Sq <= Sk``). Key ``j`` is
visible from query row ``i`` iff, when ``causal``, ``j <= q_offset + i``
or ``j < prefix_len[b]`` (the prefix-LM mask of the reference's
``attention_streamed``: a VLM's image prefix attends bidirectionally),
and ``q_offset + i - j < window`` when a window is set (the last
``window`` keys including the query itself, the HF convention of the
reference). The softcap ``cap * tanh(s / cap)`` is applied to the scaled
scores before the mask. Scores and sums are float32; any S is accepted
(the TPU kernel wanted a multiple of its 512-row blocks). The forward
can also return each row's log-sum-exp ``lse`` (B, Hq, Sq) float32, from
which the backward recomputes the probabilities, as the reference's
custom VJP ``_flash_bwd`` does.

``csrc/flash_attention.cu`` holds two CUDA kernels, chosen by dtype:
bfloat16 launches the tensor-core kernel (wgmma products, TMA loads,
warp-specialised; its loads need head dims that are multiples of 8 and
16-byte aligned tensors, see :func:`refusal`), float32 the SIMT kernel,
whose float32 FMAs keep float32's tolerance.
``csrc/flash_attention_bwd.cu`` holds the backward: delta, then dK/dV,
then dQ; bfloat16 on the tensor cores (``mma.sync``, P and dS split into
bf16 hi + lo, the dK/dV blocks split by :func:`bwd_plan` and their
float32 partials summed in a fixed order), float32 on SIMT. A key that
no query row sees (causal, past ``q_offset + Sq - 1``) gets dk = dv = 0.
:func:`repro_torch.kernels.ops.flash_attention` and
:func:`repro_torch.kernels.ops.flash_attention_bwd` are the guarded entry
points that pick between the plain versions and the CUDA kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256                  # the kernels' accumulator size
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132                           # H100 SXM streaming multiprocessors
BWD_BLOCKS_PER_SM = 2               # bf16 backward blocks an SM holds
BWD_STREAM = 32                     # rows of the tiles a bf16 backward
                                    # block streams


def visible(s: int, *, causal: bool, window: int | None,
            prefix_len: torch.Tensor | None = None,
            device=None, sk: int | None = None,
            q_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool, ``s`` = Sq query rows at global positions
    ``q_offset ..`` and ``sk`` keys (default ``s``): key ``j`` (column)
    visible from query row ``i`` (row); (B, Sq, Sk) with a ``prefix_len``
    (B,) when causal."""
    sk = s if sk is None else sk
    i = q_offset + torch.arange(s, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=device)
    if window is not None:
        mask &= i - j < window
    if not causal:
        return mask
    if prefix_len is None:
        return mask & (j <= i)
    pre = prefix_len.to(device=device, dtype=torch.long)[:, None, None]
    return mask & ((j <= i) | (j < pre))


def _grouped_scores(q, k, *, scale, softcap, mask):
    """Scaled, softcapped float32 scores (B, Hkv, G, Sq, Sk), masked
    entries ``NEG_INF``; ``mask`` (Sq, Sk) or (B, Sq, Sk)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = (q.float() * scale).view(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    m5 = mask if mask.dim() == 2 else mask[:, None, None]
    return scores.masked_fill(~m5, NEG_INF), m5


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          scale: float | None = None,
                          window: int | None = None,
                          softcap: float | None = None,
                          prefix_len: torch.Tensor | None = None,
                          return_lse: bool = False, q_offset: int = 0):
    """Plain PyTorch version: the whole (Sq, Sk) score matrix in float32,
    masked probabilities set to 0, on whatever device the inputs lie on.
    With ``return_lse``, ``(out, lse)``: lse (B, Hq, Sq) float32 in
    natural units."""
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    mask = visible(s, causal=causal, window=window, prefix_len=prefix_len,
                   device=q.device, sk=k.shape[1], q_offset=q_offset)
    scores, m5 = _grouped_scores(q, k, scale=scale, softcap=softcap,
                                 mask=mask)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(m5, torch.exp(scores - m), 0.0)
    lsum = p.sum(dim=-1)                              # (B, Hkv, G, S)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = out / lsum.permute(0, 3, 1, 2).clamp_min(1e-30)[..., None]
    out = out.reshape(b, s, hq, dv).to(q.dtype).contiguous()
    if not return_lse:
        return out
    lse = m[..., 0] + torch.log(lsum.clamp_min(1e-30))
    return out, lse.reshape(b, hq, s).contiguous()


def flash_attention_bwd_torch(q, k, v, out, dout, lse, *,
                              causal: bool = True,
                              scale: float | None = None,
                              window: int | None = None,
                              softcap: float | None = None,
                              prefix_len: torch.Tensor | None = None,
                              q_offset: int = 0):
    """Plain PyTorch version of the backward, the reference's
    ``_flash_bwd`` on the whole (Sq, Sk) matrix: ``delta = rowsum(dout ·
    out)``, P recomputed from ``lse`` (B, Hq, Sq), ``ds = P (dP - delta)``
    times ``1 - (sc / cap)^2`` under a softcap, masked pairs 0, the G q
    heads of a kv head summed into dk/dv. Float32 throughout; returns
    (dq, dk, dv) in the inputs' types."""
    b, s, hq, d = q.shape
    hkv, dv_ = k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    mask = visible(s, causal=causal, window=window, prefix_len=prefix_len,
                   device=q.device, sk=k.shape[1], q_offset=q_offset)
    sc, m5 = _grouped_scores(q, k, scale=scale, softcap=softcap, mask=mask)
    do = dout.float()
    delta = (do * out.float()).sum(-1)                # (B, S, Hq)
    delta = delta.view(b, s, hkv, g).permute(0, 2, 3, 1)
    do_g = do.view(b, s, hkv, g, dv_)
    p = torch.exp(sc - lse.float().view(b, hkv, g, s)[..., None])
    p = torch.where(m5, p, 0.0)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do_g)
    dp = torch.einsum("bskgd,btkd->bkgst", do_g, v.float())
    ds = p * (dp - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - torch.square(sc / softcap))
    ds = torch.where(m5, ds, 0.0)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.float().view(b, s, hkv, g, d)) * scale
    return (dq.reshape(b, s, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.cache
def _library():
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_fits.argtypes = [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.flash_attention_fits.restype = ctypes.c_int
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def refusal(q, k, v) -> str | None:
    """Why the CUDA kernel of these tensors' dtype cannot take them (the
    rule as the library states it), or None. The bfloat16 tensor-core
    kernel reads q, k and v through TMA tensor maps, whose row strides and
    base addresses must be multiples of 16 bytes: head dims that are
    multiples of 8 and 16-byte aligned data. The float32 SIMT kernel takes
    any head dim up to the library's maximum."""
    lib = _library()
    d, dv = q.shape[-1], v.shape[-1]
    why = lib.flash_attention_fits(d, dv, q.data_ptr(), k.data_ptr(),
                                   v.data_ptr(), DTYPE_CODES[q.dtype])
    if why == 1:
        return (f"head dims ({d}, {dv}) exceed the kernel's "
                f"{lib.flash_attention_max_head_dim()}")
    if why == 2:
        return (f"head dims ({d}, {dv}) are not multiples of 8, which the "
                f"bfloat16 kernel's TMA loads need")
    if why == 3:
        off = [n for n, x in (("q", q), ("k", k), ("v", v))
               if x.data_ptr() % 16]
        return (f"{', '.join(off)} not 16-byte aligned, which the bfloat16 "
                f"kernel's TMA loads need")
    return None


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: float | None = None,
                         window: int | None = None,
                         softcap: float | None = None,
                         prefix_len: torch.Tensor | None = None,
                         return_lse: bool = False, q_offset: int = 0):
    """Launch the kernel of the inputs' dtype (bfloat16: tensor cores;
    float32: SIMT) on the current stream of their device; with
    ``return_lse``, ``(out, lse)``. Unguarded: the caller has checked
    shapes (head dims at most ``MAX_HEAD_DIM``, ``prefix_len`` int32
    (B,) on the same device, ``0 <= q_offset``, ``q_offset + Sq <=
    Sk``), types, contiguity, :func:`refusal` and that nothing is
    empty."""
    lib = _library()
    b, s, hq, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, s, hq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if prefix_len is None else prefix_len.data_ptr(),
            b, s, sk, hq, hkv, d, dv, q_offset, scale, int(causal),
            0 if window is None else window,
            0.0 if softcap is None else softcap, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({what})")
    return (out, lse) if return_lse else out


class BwdPlan(NamedTuple):
    """How the bfloat16 backward launches for one shape: the dK/dV
    blocks split each kv head's G q heads into ``n_g`` groups and each
    key tile's query range into ``n_q`` parts; ``kv_blocks`` and
    ``q_blocks`` blocks of the dK/dV and dQ launches; ``partial_bytes``
    of the float32 dK/dV partials (0 when nothing is split)."""
    n_g: int
    n_q: int
    kv_blocks: int
    q_blocks: int
    partial_bytes: int


def bwd_fixed_rows(d: int, dv: int) -> int:
    """Rows of a bfloat16 backward block's own tile (keys for dK/dV,
    query rows for dQ): 64, or 32 where a head dim is above 96, so that
    two blocks fit an SM."""
    return 32 if max(d, dv) > 96 else 64


def bwd_shared_bytes(d: int, dv: int, kv: bool) -> int:
    """Dynamic shared memory of one bfloat16 backward block, as the
    library computes it (``flash_attention_bwd_shared_bytes``; the
    layout of ``csrc/flash_attention_bwd.cu``: bf16 rows padded to 16
    columns plus 8): the fixed tiles, the 2-stage ring, the P / dS hi
    and lo staging (4 tiles for dK/dV, 2 for dQ) and the float32 lse
    and delta rows. The tests hold two blocks an SM to it."""
    def ld(x):
        return -(-x // 16) * 16 + 8
    f = bwd_fixed_rows(d, dv)
    tiles = (f + 2 * BWD_STREAM) * (ld(d) + ld(dv)) \
        + (4 if kv else 2) * f * (BWD_STREAM + 8)
    return 2 * tiles + 4 * (4 * BWD_STREAM if kv else 2 * f)


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, s: int, hq: int, hkv: int, d: int,
             dv: int, sk: int | None = None) -> BwdPlan:
    """The launch rule of the bfloat16 backward, by shape alone: ``s``
    query rows against ``sk`` keys (default ``s``). Unsplit, dK/dV has
    one block per (key tile, kv head, batch) and dQ one per (query tile,
    q head, batch), tiles of :func:`bwd_fixed_rows` rows. The target is
    the blocks the card holds at once, two an SM on the 132 SMs. While
    the dK/dV blocks are fewer, the G q heads of a kv head are split:
    ``n_g`` is the smallest divisor of G that reaches the target, else
    G; then, if still short, the query range: ``n_q`` = ceil(target /
    blocks), at most its 32-row tiles. Each split block writes a float32
    partial of its tile's dK and dV."""
    sk = s if sk is None else sk
    g = hq // hkv
    f = bwd_fixed_rows(d, dv)
    base = -(-sk // f) * hkv * b
    target = BWD_BLOCKS_PER_SM * SMS
    n_g = next((x for x in range(1, g + 1) if g % x == 0
                and base * x >= target), g)
    n_q = 1
    if base * n_g < target:
        n_q = min(-(-target // (base * n_g)), -(-s // BWD_STREAM))
    splits = n_g * n_q
    partial = 4 * splits * b * sk * hkv * (d + dv) if splits > 1 else 0
    return BwdPlan(n_g, n_q, base * splits, -(-s // f) * hq * b, partial)


@functools.cache
def _bwd_library():
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = [ctypes.c_void_p] * 12 \
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_bwd_shared_bytes.restype = ctypes.c_longlong
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool = True,
                             scale: float | None = None,
                             window: int | None = None,
                             softcap: float | None = None,
                             prefix_len: torch.Tensor | None = None,
                             q_offset: int = 0):
    """Launch the backward on the current stream of the inputs' device;
    returns (dq, dk, dv) in their type. float32: delta, dK/dV, dQ on
    SIMT. bfloat16: delta, dK/dV split by :func:`bwd_plan` (with a
    float32 workspace for its partials and their sum when it splits),
    dQ, on the tensor cores. Unguarded: the caller has checked shapes
    (head dims at most ``MAX_HEAD_DIM``, ``0 <= q_offset``, ``q_offset +
    Sq <= Sk``), types (``lse`` float32 (B, Hq, Sq), ``prefix_len`` int32
    (B,)), one device, contiguity,
    :func:`refusal` of q, k, v and dout's alignment for bfloat16, and that
    nothing is empty."""
    lib = _bwd_library()
    b, s, hq, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    n_g = n_q = 1
    ws = None
    if q.dtype == torch.bfloat16:
        plan = bwd_plan(b, s, hq, hkv, d, dv, sk)
        n_g, n_q = plan.n_g, plan.n_q
        if plan.partial_bytes:
            ws = torch.empty(plan.partial_bytes // 4, dtype=torch.float32,
                             device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            None if prefix_len is None else prefix_len.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, s, sk, hq, hkv, d, dv, q_offset, scale, int(causal),
            0 if window is None else window,
            0.0 if softcap is None else softcap, n_g, n_q,
            DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err} ({what})")
    return dq, dk, dvv
