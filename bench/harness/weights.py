"""Weights drawn from the seed, the same for the program and the
reference.

One float32 stream of standard normals, drawn on the device by one
generator seeded with ``--seed`` in chunks of :data:`CHUNK`, is laid
over the leaves of a layout (``param_spec`` of a reference module) in
its order; each leaf maps its part of the stream by its ``init`` and is
cast to its stored type. A leaf's values depend only on the seed and its
place in the layout, so :func:`delta_norms` can draw the stream again
to compare a leaf with where it started.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 28                     # normals a draw (1 GiB of float32)
NORM_STD = 0.1                      # norm scales about the norm's 1
DT_RANGE = (1e-3, 1e-1)             # Mamba-2's dt, log-uniform
DT_FLOOR = 1e-4
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _mapped(z: torch.Tensor, leaf) -> torch.Tensor:
    """The float32 values of ``leaf`` from its normals ``z``."""
    if leaf.init == "normal":
        return z / math.sqrt(leaf.fan_in)
    if leaf.init == "norm":
        return z * NORM_STD
    if leaf.init == "one":
        return torch.ones_like(z)
    u = torch.special.ndtr(z)                       # U(0, 1)
    if leaf.init == "A_log":                        # A in -[1, 16]
        return torch.log(1.0 + 15.0 * u)
    if leaf.init == "dt_bias":                      # softplus^-1 of dt
        lo, hi = (math.log(t) for t in DT_RANGE)
        dt = torch.exp(lo + (hi - lo) * u).clamp_min(DT_FLOOR)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")


def _segments(spec):
    """(leaf, start, numel) in stream order."""
    start = 0
    for leaf in spec:
        n = math.prod(leaf.shape)
        yield leaf, start, n
        start += n


def _stream(spec, seed: int, device):
    """For each chunk of the stream: (chunk start, normals), drawn in
    order from one generator seeded with ``seed``."""
    total = sum(n for _, _, n in _segments(spec))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    for c0 in range(0, total, CHUNK):
        yield c0, torch.randn(min(CHUNK, total - c0), generator=gen,
                              dtype=torch.float32, device=device)


def _visit(spec, seed: int, device, fn) -> None:
    """Calls ``fn(leaf, flat offset, values)`` for every piece of every
    leaf, in stream order, with the piece's mapped float32 values."""
    segs = list(_segments(spec))
    for c0, z in _stream(spec, seed, device):
        c1 = c0 + z.numel()
        for leaf, s0, n in segs:
            lo, hi = max(s0, c0), min(s0 + n, c1)
            if lo < hi:
                fn(leaf, lo - s0, _mapped(z[lo - c0:hi - c0], leaf))
        del z


def make(spec, seed: int, device, into: dict | None = None) -> dict:
    """``{name: tensor}`` of every leaf of ``spec`` on ``device`` in its
    stored type; with ``into``, fills those tensors (same names, shapes
    and types, contiguous) instead of allocating."""
    out = into if into is not None else {
        leaf.name: torch.empty(leaf.shape, dtype=DTYPES[leaf.dtype],
                               device=device) for leaf in spec}
    for leaf in spec:
        t = out[leaf.name]
        if tuple(t.shape) != tuple(leaf.shape) or t.dtype != \
                DTYPES[leaf.dtype] or not t.is_contiguous():
            raise ValueError(f"{leaf.name}: {tuple(t.shape)} {t.dtype}, the "
                             f"layout has {leaf.shape} {leaf.dtype}")

    def put(leaf, off, vals):
        flat = out[leaf.name].view(-1)
        flat[off:off + vals.numel()] = vals.to(flat.dtype)
    with torch.no_grad():
        _visit(spec, seed, device, put)
    return out


def delta_norms(spec, seed: int, params: dict, device) -> dict:
    """``{name: |p - p0|}``: each leaf's distance from the value the seed
    drew for it (in its stored type), in float32."""
    sums = {leaf.name: torch.zeros((), dtype=torch.float64, device=device)
            for leaf in spec}

    def acc(leaf, off, vals):
        p = params[leaf.name].detach().reshape(-1)[off:off + vals.numel()]
        p0 = vals.to(DTYPES[leaf.dtype])
        sums[leaf.name] += (p.float() - p0.float()).double().square().sum()
    with torch.no_grad():
        _visit(spec, seed, device, acc)
    return {k: float(torch.sqrt(v)) for k, v in sums.items()}
