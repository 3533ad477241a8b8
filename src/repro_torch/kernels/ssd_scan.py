"""Mamba-2 SSD chunked scan: the CUDA kernel's launcher and its plain
PyTorch version.

For each (batch b, head h), over chunks of ``chunk`` positions, with the
(P, N) state carried from chunk to chunk (zero before the first):

    dA = dt * A                 cs = inclusive cumsum of dA over the chunk
    M[q, k] = (C_q . B_k) * exp(cs_q - cs_k) * dt_k     for k <= q, else 0
    y[q]    = M x + exp(cs_q) * (C_q . state)
    state   = state * exp(cs_end) + sum_k x_k (exp(cs_end - cs_k) dt_k B_k)

``x`` (B, S, H, P), ``dt`` (B, S, H) float32 (post-softplus), ``A`` (H,)
float32 (negative), ``B``/``C`` (B, S, G, N) with G dividing H (head h
reads group ``h // (H // G)``); x, B and C are all float32 or all
bfloat16. Returns ``y`` (B, S, H, P) in x's type and the final state (B,
H, P, N) in x's type. Everything between the loads and the final casts is
float32, as in the TPU kernel, except the cumsum: it is summed in float64
and rounded once, so that its value does not depend on the order of the
sum (a parallel scan on the card, a sequential one here). Any S >= 1 is
taken: the ragged last chunk behaves as ``dt = 0`` padding (exact: decay
1, no update), and ``y`` covers the real positions only.

The CUDA kernel lives in ``csrc/ssd_scan.cu``: three passes (the
chunks' local states, the carry between chunks, the chunks' outputs),
bf16 products on the tensor cores with float32 operands split into bf16
hi + lo, float32 on SIMT FMAs;
:func:`repro_torch.kernels.ops.ssd_scan` is the guarded entry point that
picks between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_cumsum(da: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis, summed in float64 and
    rounded once to float32 (what the kernel computes)."""
    # the kernel sums in float64 too
    return torch.cumsum(da.double(), dim=-1).float()  # lint: dtype-ok


def ssd_scan_torch(x, dt, A, B, C, chunk: int = 256):
    """Plain PyTorch version: the kernel's expressions, one chunk per
    loop step, batched over (b, h), on whatever device the inputs lie
    on. Returns (y, final_state)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    if pad:                         # dt = 0 padding: exact
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    ys = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xc = xf[:, sl].transpose(1, 2)                       # (b, h, Q, p)
        dtc = dtf[:, sl].transpose(1, 2)                     # (b, h, Q)
        Bc = Bf[:, sl].repeat_interleave(rep, dim=2).transpose(1, 2)
        Cc = Cf[:, sl].repeat_interleave(rep, dim=2).transpose(1, 2)
        cs = chunk_cumsum(dtc * A.float()[None, :, None])
        seg = cs[..., :, None] - cs[..., None, :]
        L = torch.where(causal, torch.exp(seg), 0.0)
        M = (Cc @ Bc.transpose(-1, -2)) * L * dtc[..., None, :]
        y = M @ xc
        y = y + torch.exp(cs)[..., None] * (Cc @ state.transpose(-1, -2))
        w = (torch.exp(cs[..., -1:] - cs) * dtc)[..., None] * Bc
        state = state * torch.exp(cs[..., -1])[..., None, None] \
            + xc.transpose(-1, -2) @ w
        ys.append(y)
    if ys:
        y = torch.cat(ys, dim=2)[:, :, :s].transpose(1, 2)
    else:
        y = torch.zeros((b, 0, h, p), device=x.device)
    return y.to(x.dtype).contiguous(), state.to(x.dtype)


@functools.cache
def _library():
    lib = build.load("ssd_scan")
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    lib.ssd_scan_fits.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_fits.restype = ctypes.c_int
    lib.ssd_scan_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_shared_bytes.restype = ctypes.c_longlong
    for limit in (lib.ssd_scan_max_head_dim, lib.ssd_scan_max_state,
                  lib.ssd_scan_max_shared_bytes):
        limit.argtypes, limit.restype = [], ctypes.c_int
    return lib


def refusal(p: int, n: int, chunk: int) -> str | None:
    """Why the kernel cannot take head dim ``p``, state ``n`` and
    ``chunk`` (its register tiles and shared memory, as the library
    states them), or None if it can."""
    lib = _library()
    why = lib.ssd_scan_fits(p, n, chunk)
    if why == 1:
        return (f"head dim {p} exceeds the kernel's "
                f"{lib.ssd_scan_max_head_dim()}")
    if why == 2:
        return f"state {n} exceeds the kernel's {lib.ssd_scan_max_state()}"
    if why == 3:
        return (f"chunk {chunk} needs {lib.ssd_scan_shared_bytes(p, n, chunk)}"
                f" bytes of shared memory per block, more than the "
                f"{lib.ssd_scan_max_shared_bytes()} a block may use")
    return None


def shared_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory one block of the kernel uses (from the library)."""
    return _library().ssd_scan_shared_bytes(p, n, chunk)


def ssd_scan_cuda(x, dt, A, B, C, chunk: int = 256):
    """Launch the kernel's three passes on the current stream of the
    inputs' device, with scratch for the chunks' cumsums and states
    (float32; in bf16 also the entering states split into hi + lo).
    Unguarded: the caller has checked shapes (:func:`refusal`), types,
    contiguity and that nothing is empty."""
    lib = _library()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-s // chunk)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    cs = torch.empty((b, h, nc * chunk), dtype=torch.float32,
                     device=x.device)
    local = torch.empty((b, h, nc, p, n), dtype=torch.float32,
                        device=x.device)
    split = torch.empty((b, h, nc, 2, p, n) if x.dtype == torch.bfloat16
                        else (0,), dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), cs.data_ptr(),
            local.data_ptr(), split.data_ptr(), b, s, h, p, g, n, chunk,
            DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({lib.ssd_scan_error_string(err).decode()})")
    return y, state
