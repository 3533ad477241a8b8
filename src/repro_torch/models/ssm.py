"""Mamba-2 SSD (state-space duality) in plain PyTorch — arXiv:2405.21060.

A copy of the JAX package's ``models/ssm.py``: the chunked algorithm
(``ssd_chunked``, Listing 1 of the paper), the one-token recurrence the
decode loop runs (``ssd_decode_step``) and the token-by-token recurrence
both are held to (``ssd_sequential``). The model's prefill does not call
``ssd_chunked``: it runs the ``ssd_scan`` kernel through
:func:`repro_torch.kernels.ops.ssd_scan`; the chunked form stays as an
oracle with the reference's own roundings.

Shapes follow the paper: x (B,S,H,P) values, dt (B,S,H) step sizes
(post-softplus), A (H,) negative decay, B/C (B,S,G,N) input/output
projections shared across H//G head groups.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum(x[..., j+1:i+1]) for
    j<=i, -inf above the diagonal. x: (..., Q) -> (..., Q, Q)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Returns (y (B,S,H,P), final_state (B,H,P,N)), rounding where the
    reference rounds: ``M`` and the decay weights are cast to x's type
    before their products, and the diagonal and off-diagonal parts are
    rounded apart before they are added."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    if pad:
        # ragged tail: dt=0 padding is exact (decay exp(0)=1, zero update)
        def zpad(t):
            return F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
        y, final = ssd_chunked(zpad(x), zpad(dt), A, zpad(B), zpad(C), chunk,
                               initial_state)
        return y[:, :s], final
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)
    dA = (dtc * A.float()).permute(0, 1, 3, 2)             # (b,nc,h,Q)
    dA_cs = torch.cumsum(dA, dim=-1)

    # 1. intra-chunk (diagonal blocks): Y_diag = (C B^T ⊙ L ⊙ dt) X
    L = torch.exp(segsum(dA))                              # (b,nc,h,Q,Q)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)        # (b,nc,g,Q,Q)
    CB = CB.repeat_interleave(rep, dim=2)                  # (b,nc,h,Q,Q)
    M = CB * L * dtc.permute(0, 1, 3, 2)[..., None, :]     # scale by dt_k
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M.to(x.dtype), xc)

    # 2. chunk states: state_c = sum_k B_k dt_k x_k decay(k->end)
    decay = torch.exp(dA_cs[..., -1:] - dA_cs)             # (b,nc,h,Q)
    Bd = Bc.repeat_interleave(rep, dim=3) if g != h else Bc
    w = (decay.permute(0, 1, 3, 2) * dtc).to(x.dtype)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bd, w, xc)

    # 3. inter-chunk recurrence (scan over chunks); keep the state
    #    *before* each chunk
    chunk_decay = torch.exp(dA_cs[..., -1])                # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)                 # (b,nc,h,p,n)

    # 4. off-diagonal contribution: Y_off = C · decay(start->q) · state_prev
    state_decay = torch.exp(dA_cs)
    Cd = Cc.repeat_interleave(rep, dim=3) if g != h else Cc
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cd.float(), prev_states,
                         state_decay).to(x.dtype)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry.to(x.dtype)


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token recurrence. state (B,H,P,N); x (B,H,P); dt (B,H);
    B/C (B,G,N). Returns (y (B,H,P), new_state in state's type)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    dA = torch.exp(dt.float() * A.float())                 # (B,H)
    Bd = B.repeat_interleave(rep, dim=1)                   # (B,H,N)
    Cd = C.repeat_interleave(rep, dim=1)
    upd = (dt.float()[..., None, None] * x.float()[..., None]
           * Bd.float()[..., None, :])                     # (B,H,P,N)
    new_state = state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cd.float())
    return y.to(x.dtype), new_state.to(state.dtype)


def ssd_sequential(x, dt, A, B, C, initial_state=None):
    """Token-by-token recurrence — the ground truth the chunked forms
    must match."""
    b, s, h, p = x.shape
    n = B.shape[3]
    st = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    ys = []
    for t in range(s):
        y, st = ssd_decode_step(st, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, h, p))
    return y, st.to(x.dtype)
