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

The backward (:func:`ssd_scan_bwd_torch`) takes ``dy`` and the final
state's gradient and gives x, dt, A, B and C theirs, with explicit
chunked formulas in the same float32 (its reverse cumsum, like the
forward's cumsum, summed in float64 and rounded once).

The CUDA kernels live in ``csrc/ssd_scan.cu``: the forward in three
passes (the chunks' local states, the carry between chunks, the chunks'
outputs), the backward in four (the states and their gradients carried
over the chunks, with C B^T per group; the key and query sides of each
causal tile pair, dCB summed over each group's heads; dB and dC, one
product per pair and group plus the heads' state terms; the reverse
cumsum); bf16 products on the tensor cores with float32 operands split
into bf16 hi + lo. The forward's float32 path keeps SIMT FMAs; the
backward's float32 path takes the same passes with every operand as
three bf16 planes. :func:`repro_torch.kernels.ops.ssd_scan` and
:func:`repro_torch.kernels.ops.ssd_scan_bwd` are the guarded entry
points that pick between the plain versions and the kernels.
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
    rounded once to da's type (what the kernel computes)."""
    # the kernel sums in float64 too
    return torch.cumsum(da.double(), dim=-1).to(da.dtype)  # lint: dtype-ok


def chunk_revsum(d: torch.Tensor) -> torch.Tensor:
    """Reverse inclusive cumsum over the last axis (out[j] = sum of
    d[j:]), summed in float64 and rounded once to d's type: the
    backward of :func:`chunk_cumsum`."""
    # the kernel sums in float64 too
    rev = torch.cumsum(d.double().flip(-1), dim=-1)  # lint: dtype-ok
    return rev.flip(-1).to(d.dtype)


def work_type(x: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs (which only the plain versions take)."""
    f64 = x.dtype == torch.float64  # lint: dtype-ok
    return x.dtype if f64 else torch.float32


def ssd_scan_torch(x, dt, A, B, C, chunk: int = 256):
    """Plain PyTorch version: the kernel's expressions, one chunk per
    loop step, batched over (b, h), on whatever device the inputs lie
    on. Returns (y, final_state)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    ft = work_type(x)
    xf, dtf, Bf, Cf = (t.to(ft) for t in (x, dt, B, C))
    if pad:                         # dt = 0 padding: exact
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    state = torch.zeros((b, h, p, n), dtype=ft, device=x.device)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    ys = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xc = xf[:, sl].transpose(1, 2)                       # (b, h, Q, p)
        dtc = dtf[:, sl].transpose(1, 2)                     # (b, h, Q)
        Bc = Bf[:, sl].repeat_interleave(rep, dim=2).transpose(1, 2)
        Cc = Cf[:, sl].repeat_interleave(rep, dim=2).transpose(1, 2)
        cs = chunk_cumsum(dtc * A.to(ft)[None, :, None])
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


def _by_chunk(t, nc, chunk):
    """(B, S', K, D) padded to nc chunks -> (B, K, nc, chunk, D)."""
    b, k, d = t.shape[0], t.shape[2], t.shape[-1]
    return t.reshape(b, nc, chunk, k, d).permute(0, 3, 1, 2, 4)


def ssd_scan_bwd_torch(x, dt, A, B, C, dy, dfinal=None, chunk: int = 256,
                       mm=torch.matmul):
    """Plain PyTorch version of the backward of :func:`ssd_scan_torch`:
    the explicit chunked formulas the kernel computes, with its products,
    on whatever device the inputs lie on, batched over (b, h, chunk).
    ``dy`` (B, S, H, P) in x's type, ``dfinal`` (B, H, P, N) or None
    (zeros). Returns (dx, ddt, dA, dB, dC): dx, dB and dC in x's type,
    ddt and dA float32 (float64 for float64 inputs).

    With cs the chunk's cumsum of dt * A, L[q, k] = exp(cs_q - cs_k)
    (k <= q), CB = C B^T (once per group), M = CB * L * dt_k and w_k =
    exp(cs_end - cs_k) dt_k:

    1. the states entering each chunk, recomputed (the forward's carry);
    2. the state gradient carried backward over the chunks: dS_out of the
       last chunk is ``dfinal``, and dS_in[c] = exp(cs_end) dS_out[c] +
       sum_q exp(cs_q) dy_q (x) C_q is dS_out[c - 1];
    3. per chunk, the dual form's and the state terms' gradients:
       dM = dy x^T (causal), dCB_h = dM L dt_k summed over each group's
       heads into dCB, dx = M^T dy + w (B dS_out^T), dB = dCB^T C + the
       group's sum of w (x dS_out), dC = dCB B + the group's sum of
       exp(cs) (dy S_in), and the direct part of ddt;
    4. d(cs) through the reverse cumsum (float64, rounded once, as the
       forward's cumsum) to d(dt * A): ddt += A d(dt A), dA = sum dt
       d(dt A) over (b, s).

    The ragged tail's ``dt = 0`` padding gives nothing back (padded
    positions are cut off). ``mm`` computes every matrix product (the
    tests pass the bf16 kernel's split products to emulate its
    rounding)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    ft = work_type(x)
    dev = x.device
    xf, dtf, Bf, Cf, dyf = (t.to(ft) for t in (x, dt, B, C, dy))
    if pad:                         # dt = 0 padding: exact
        xf, Bf, Cf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (xf, Bf, Cf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    xc, dyc = (_by_chunk(t, nc, chunk) for t in (xf, dyf))   # (b,h,nc,Q,p)
    Bg, Cg = (_by_chunk(t, nc, chunk) for t in (Bf, Cf))     # (b,g,nc,Q,n)
    Bc, Cc = (t.repeat_interleave(rep, dim=1) for t in (Bg, Cg))  # by head
    dtc = dtf.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)    # (b,h,nc,Q)
    cs = chunk_cumsum(dtc * A.to(ft)[None, :, None, None])
    ecs = torch.exp(cs)
    decay = ecs[..., -1]                                      # (b,h,nc)
    w = torch.exp(cs[..., -1:] - cs) * dtc                    # (b,h,nc,Q)

    def group_sum(t):               # (b, h, ...) -> (b, g, ...), heads in order
        return t.reshape(b, g, rep, *t.shape[2:]).sum(2)

    # 1. the states entering each chunk
    local = mm((w[..., None] * xc).transpose(-1, -2), Bc)      # (b,h,nc,p,n)
    s_in = torch.zeros_like(local)
    run = torch.zeros((b, h, p, n), dtype=ft, device=dev)
    for c in range(nc):
        s_in[:, :, c] = run
        run = run * decay[:, :, c, None, None] + local[:, :, c]

    # 2. the state gradient, carried backward
    u = mm((ecs[..., None] * dyc).transpose(-1, -2), Cc)        # (b,h,nc,p,n)
    ds_out = torch.empty_like(u)
    run = torch.zeros((b, h, p, n), dtype=ft, device=dev) if dfinal is None \
        else dfinal.to(ft)
    for c in reversed(range(nc)):
        ds_out[:, :, c] = run
        run = run * decay[:, :, c, None, None] + u[:, :, c]

    # 3. per chunk
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    L = torch.where(causal, torch.exp(cs[..., :, None] - cs[..., None, :]),
                    0.0)                                      # (.., q, k)
    CB = mm(Cg, Bg.transpose(-1, -2)).repeat_interleave(rep, dim=1)
    M = CB * L * dtc[..., None, :]
    dM = torch.where(causal, mm(dyc, xc.transpose(-1, -2)), 0.0)
    dCB = group_sum(dM * L * dtc[..., None, :])               # (b,g,nc,q,k)
    BG = mm(Bc, ds_out.transpose(-1, -2))                     # (.., Q, p)
    dyS = mm(dyc, s_in)                                         # (.., Q, n)
    dx = mm(M.transpose(-1, -2), dyc) + w[..., None] * BG
    dB = mm(dCB.transpose(-1, -2), Cg) \
        + group_sum(w[..., None] * mm(xc, ds_out))
    dC = mm(dCB, Bg) + group_sum(ecs[..., None] * dyS)
    dw = (xc * BG).sum(-1)                                    # (b,h,nc,Q)
    ddt = (dM * CB * L).sum(-2) + torch.exp(cs[..., -1:] - cs) * dw

    # 4. d(cs) -> d(dt * A)
    T = torch.where(causal.tril(-1), dM * M, 0.0)   # the diagonal cancels
    wdw = w * dw
    dcs = T.sum(-1) - T.sum(-2) + ecs * (dyS * Cc).sum(-1) - wdw
    dcs[..., -1] += wdw.sum(-1) + decay * (ds_out * s_in).sum((-1, -2))
    da = chunk_revsum(dcs)
    ddt = ddt + A.to(ft)[None, :, None, None] * da
    dA = (dtc * da).sum((0, 2, 3))

    def back(t):                    # (b, k, nc, Q, d) -> (b, s, k, d)
        return t.permute(0, 2, 3, 1, 4).reshape(
            b, nc * chunk, t.shape[1], t.shape[-1])[:, :s]
    ddt = ddt.permute(0, 2, 3, 1).reshape(b, nc * chunk, h)[:, :s]
    return (back(dx).to(x.dtype).contiguous(), ddt.contiguous(), dA,
            back(dB).to(B.dtype).contiguous(),
            back(dC).to(C.dtype).contiguous())


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
    lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_fits.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_bwd_fits.restype = ctypes.c_int
    lib.ssd_scan_bwd_shared_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_bwd_shared_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_workspace.argtypes = [ctypes.c_int] * 8
    lib.ssd_scan_bwd_workspace.restype = ctypes.c_longlong
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


def bwd_refusal(p: int, n: int, chunk: int,
                dtype: torch.dtype = torch.bfloat16) -> str | None:
    """Why the backward kernel cannot take head dim ``p``, state ``n``
    and ``chunk`` in ``dtype`` (the forward's limits, and its own shared
    memory, which grows with chunk), or None if it can."""
    lib = _library()
    code = DTYPE_CODES[dtype]
    why = lib.ssd_scan_bwd_fits(p, n, chunk, code)
    if why == 3:
        need = lib.ssd_scan_bwd_shared_bytes(p, n, chunk, code)
        return (f"chunk {chunk} needs {need} bytes of shared memory per "
                f"block, more than the {lib.ssd_scan_max_shared_bytes()} a "
                f"block may use")
    return refusal(p, n, chunk) if why else None


def bwd_workspace_bytes(b: int, s: int, h: int, p: int, g: int, n: int,
                        chunk: int, dtype: torch.dtype) -> int:
    """Bytes of scratch the backward kernel takes at these shapes (from
    the library): the states and their gradients as bf16 planes, C B^T
    and the group's dCB per causal tile pair, per-position partials."""
    return 4 * _library().ssd_scan_bwd_workspace(b, s, h, p, g, n, chunk,
                                                 DTYPE_CODES[dtype])


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


def ssd_scan_bwd_cuda(x, dt, A, B, C, dy, dfinal=None, chunk: int = 256):
    """Launch the backward's four passes on the current stream of the
    inputs' device, with one workspace for their scratch
    (:func:`bwd_workspace_bytes`). Returns (dx, ddt, dA, dB, dC).
    Unguarded: the caller has checked shapes (:func:`bwd_refusal`),
    types, contiguity and that nothing is empty."""
    lib = _library()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    work = torch.empty(bwd_workspace_bytes(b, s, h, p, g, n, chunk, x.dtype)
                       // 4, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if dfinal is None else dfinal.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            work.data_ptr(), b, s, h, p, g, n, chunk, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {err} "
                           f"({lib.ssd_scan_error_string(err).decode()})")
    return dx, ddt, dA, dB, dC
