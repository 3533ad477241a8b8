"""Max-plus relaxations: the CUDA kernels' launchers and their plain
PyTorch versions.

**Dense** (``sim_step`` / ``sim_relax``, ``csrc/sim_step.cu``). One
synchronous (Jacobi) sweep over dense lag tensors:

    end'[b, s] = duration[b, s]
               + max(release[b, s],
                     max(max_j((end[b, j] + lat[b, s, j]) + volbw[b, s, j]),
                         0))

``end``/``duration``/``release`` (B, S) float32, ``lat``/``volbw``
(B, S, S) float32 with ``-inf`` where ``j`` does not gate ``s``
(:func:`repro_torch.core.lowering.dense_lags` builds them).
``sim_relax`` returns what ``n_steps`` such sweeps from all-zero ends
give, bit for bit, by two variants: the **compact** one compacts the
lags once on the card (:func:`compact_lags_cuda`, plain version
:func:`compact_lags_torch`) into the sparse gather form below and relaxes
that with ``sim_relax_pop``, which stops each row at its fixpoint; the
**dense** one runs the ``n_steps`` sweeps. A scenario takes the compact
variant unless its inputs hold NaN or +inf (or an entry with one lag
``-inf`` and the other finite), a row of it keeps more than
``COMPACT_MAX`` entries, or the shape is too large for ``sim_relax_pop``;
a compact scenario whose ends overflow to +inf or NaN is redone dense
(see ``csrc/sim_step.cu`` for why that is exact).
:func:`sim_relax_variants_torch` runs that choice with the plain
versions, on the CPU.

**Sparse population** (``sim_relax_pop``, ``csrc/sim_relax_pop.cu``).
``n_steps`` synchronous sweeps, from all-zero ends, of

    end[b, s] = duration[b, s]
              + max(release[b, s],
                    max(max_p((end[b, pred[b, s, p]] + lat[b, s, p])
                              + volbw[b, s, p]), 0))

over the padded gather form: ``pred`` (B, S, P+1) int32 sources with the
sentinel ``S`` (an always-zero slot), ``lat``/``volbw`` (B, S, P+1)
float32 per-edge lags with ``-inf`` pads, ``duration``/``release`` (B, S)
float32. Returns (B, S) float32 finish times. The kernel stops a row at
its first sweep that leaves the ends unchanged bit for bit, which gives
the ``n_steps`` result bit for bit; it launches a thread-block cluster
of ``k`` CTAs per row and stages the edge inputs in shared memory where
they fit, both by :func:`pop_plan`.

:mod:`repro_torch.kernels.ops` holds the guarded entry points that pick
between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

MAX_SHARED_BYTES = 232_448          # dynamic shared memory one block may use
SMS = 132                           # H100 SXM streaming multiprocessors
SM_SHARED_BYTES = 233_472           # shared memory of one SM (228 KB)
CTA_RESERVED_BYTES = 1_024          # shared memory the system keeps per block
MAX_CLUSTER = 16                    # CTAs of a cluster (non-portable > 8)
MIN_SLICE = 32                      # least subtasks a CTA of a cluster keeps
FLAG_BYTES = 16                     # the kernel's two vote slots, padded
COMPACT_MAX = 64                    # kept entries a compact row may hold
FLOAT32_MAX = torch.finfo(torch.float32).max


class PopPlan(NamedTuple):
    """How ``sim_relax_pop`` launches for one shape: ``k`` CTAs (a
    thread-block cluster) per row, ``variant`` ``"staged"`` (the slice's
    edge inputs copied once into shared memory) or ``"l2"`` (read from
    L2 every sweep), the dynamic shared memory of one CTA, and its
    threads."""
    k: int
    variant: str
    shared_bytes: int
    threads: int


def shared_bytes(s: int) -> int:
    """Shared memory of the double-buffered (S+1)-slot ends, which every
    CTA of a cluster holds whole."""
    return 2 * (s + 1) * 4


def pop_shared_bytes(s: int, p1: int, slice_: int, staged: bool) -> int:
    """Shared memory of one ``sim_relax_pop`` CTA (the layout of
    ``csrc/sim_relax_pop.cu``, whose launch takes these bytes from the
    plan): the vote flags and the two end buffers; staged, also the
    slice's lat and volbw (float32), dur and rel, and pred narrowed to 16
    bits, padded to 4 bytes."""
    n = FLAG_BYTES + shared_bytes(s)
    if staged:
        e = slice_ * p1
        n += 8 * e + 8 * slice_ + (2 * e + 3) // 4 * 4
    return n


def pop_plan(b: int, s: int, p1: int) -> PopPlan:
    """The launch rule of ``sim_relax_pop``, by shape alone. ``k`` is the
    largest power of two up to 16 for which the B * k CTAs fit the 132
    SMs once and each CTA keeps at least 32 subtasks (so a small
    population spreads over the card and a large one keeps one CTA per
    row). The staged variant is taken when one CTA's staged bytes fit a
    block and the population's fit the card's shared memory in one wave;
    else the L2 variant, which holds only the ends. Threads: one per
    subtask of the slice, in whole warps, at most 1024."""
    k = 1
    while (2 * k <= MAX_CLUSTER and b * 2 * k <= SMS
           and -(-s // (2 * k)) >= MIN_SLICE):
        k *= 2
    slice_ = -(-s // k)
    threads = min(1024, -(-slice_ // 32) * 32)
    staged = pop_shared_bytes(s, p1, slice_, True)
    if (staged <= MAX_SHARED_BYTES
            and b * k * (staged + CTA_RESERVED_BYTES)
            <= SMS * SM_SHARED_BYTES):
        return PopPlan(k, "staged", staged, threads)
    return PopPlan(k, "l2", pop_shared_bytes(s, p1, slice_, False), threads)


def sim_step_torch(end, lat, volbw, duration, release) -> torch.Tensor:
    """Plain PyTorch version of one dense sweep: the kernel's
    expressions on whatever device the inputs lie on. NaN propagates
    (``amax``, ``torch.maximum``)."""
    ready = ((end[:, None, :] + lat) + volbw).amax(dim=2)
    zero = torch.zeros((), dtype=ready.dtype, device=ready.device)
    return duration + torch.maximum(release, torch.maximum(ready, zero))


def sim_relax_torch(lat, volbw, duration, release, *,
                    n_steps: int) -> torch.Tensor:
    """Plain PyTorch version of ``n_steps`` dense sweeps from zeros."""
    b, s, _ = lat.shape
    end = torch.zeros((b, s), dtype=torch.float32, device=lat.device)
    for _ in range(n_steps):
        end = sim_step_torch(end, lat, volbw, duration, release)
    return end


@functools.cache
def _dense_library():
    lib = build.load("sim_step")
    lib.sim_step_fits.argtypes = [ctypes.c_int]
    lib.sim_step_fits.restype = ctypes.c_int
    lib.sim_step_shared_bytes.argtypes = [ctypes.c_int]
    lib.sim_step_shared_bytes.restype = ctypes.c_longlong
    lib.sim_step_max_shared_bytes.argtypes = []
    lib.sim_step_max_shared_bytes.restype = ctypes.c_int
    return lib


def dense_refusal(s: int) -> str | None:
    """Why the dense kernel cannot take ``S`` (a block stages the end
    row in shared memory, as the library states it), or None if it
    can."""
    lib = _dense_library()
    if lib.sim_step_fits(s):
        return None
    return (f"S={s} needs {lib.sim_step_shared_bytes(s)} bytes of shared "
            f"memory per block, more than the "
            f"{lib.sim_step_max_shared_bytes()} a block may use")


def dense_shared_bytes(s: int) -> int:
    """Shared memory one ``sim_step`` block uses (from the library)."""
    return _dense_library().sim_step_shared_bytes(s)


@functools.cache
def _dense_launchers():
    lib = _dense_library()
    step = lib.sim_step
    step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    step.restype = ctypes.c_int
    relax = lib.sim_relax
    relax.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    relax.restype = ctypes.c_int
    lib.compact_lags.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.compact_lags.restype = ctypes.c_int
    lib.compact_finish.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    lib.compact_finish.restype = ctypes.c_int
    err_str = lib.sim_step_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return step, relax, err_str


def _raise_on(err: int, name: str, err_str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


def sim_step_cuda(end, lat, volbw, duration, release) -> torch.Tensor:
    """Launch one dense sweep on the current stream of the inputs'
    device. Unguarded: the caller has checked shapes, types, contiguity,
    :func:`dense_refusal` and that B and S are non-zero."""
    step, _, err_str = _dense_launchers()
    b, s = end.shape
    out = torch.empty((b, s), dtype=torch.float32, device=end.device)
    with torch.cuda.device(end.device):
        err = step(end.data_ptr(), lat.data_ptr(), volbw.data_ptr(),
                   duration.data_ptr(), release.data_ptr(), out.data_ptr(),
                   b, s, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sim_step", err_str)
    return out


def _dense_relax_cuda(lat, volbw, duration, release, n_steps, rows, out):
    """The dense variant on the card: ``n_steps`` sweeps from zeros, two
    end buffers in ping-pong (never in place), over the scenarios
    ``rows`` (all when None), written into ``out``."""
    _, relax, err_str = _dense_launchers()
    b, s = duration.shape
    every = rows is None or rows.numel() == b
    dst = out.zero_() if every else torch.zeros_like(out)
    scratch = torch.zeros_like(out)
    sel = None if every else rows.to(device=out.device, dtype=torch.int32)
    with torch.cuda.device(out.device):
        err = relax(lat.data_ptr(), volbw.data_ptr(), duration.data_ptr(),
                    release.data_ptr(), dst.data_ptr(), scratch.data_ptr(),
                    None if sel is None else sel.data_ptr(),
                    b if sel is None else sel.numel(), s, n_steps,
                    torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sim_relax", err_str)
    if not every:
        out[sel.long()] = dst[sel.long()]


def compact_lags_cuda(lat, volbw, duration, release) -> CompactLags:
    """The compaction pass on the card (``csrc/sim_step.cu``): one pass
    over the lags into a (B, S, :func:`compact_width`) scratch with each
    row's count and each scenario's widest row and flag, read back once
    (the call's one sync), then the padded gather form of the scenarios
    that may take the compact variant. Equal to
    :func:`compact_lags_torch`. Unguarded, as :func:`sim_step_cuda`."""
    lib = _dense_library()
    _, _, err_str = _dense_launchers()
    b, s, _ = lat.shape
    w = compact_width(s)
    dev = lat.device
    cpred = torch.empty((b, s, w), dtype=torch.int32, device=dev)
    clat = torch.empty((b, s, w), dtype=torch.float32, device=dev)
    cvolbw = torch.empty_like(clat)
    counts = torch.empty((b, s), dtype=torch.int32, device=dev)
    info = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.compact_lags(lat.data_ptr(), volbw.data_ptr(),
                               duration.data_ptr(), release.data_ptr(),
                               cpred.data_ptr(), clat.data_ptr(),
                               cvolbw.data_ptr(), counts.data_ptr(),
                               info.data_ptr(), b, s, w, stream)
    _raise_on(err, "compact_lags", err_str)
    # the one read-back that sizes the compact form
    widest, bad = info.cpu().unbind(1)  # lint: sync-ok
    rows = ((bad == 0) & (widest <= w)).nonzero().flatten()
    n = rows.numel()
    p1 = max(1, int(widest[rows].max())) if n else 1
    pred = torch.empty((n, s, p1), dtype=torch.int32, device=dev)
    lat_c = torch.empty((n, s, p1), dtype=torch.float32, device=dev)
    volbw_c = torch.empty_like(lat_c)
    if n:
        sel = None if n == b else rows.to(device=dev, dtype=torch.int32)
        with torch.cuda.device(dev):
            err = lib.compact_finish(cpred.data_ptr(), clat.data_ptr(),
                                     cvolbw.data_ptr(), counts.data_ptr(),
                                     None if sel is None else sel.data_ptr(),
                                     n, s, w, p1,
                                     pred.data_ptr(), lat_c.data_ptr(),
                                     volbw_c.data_ptr(), stream)
        _raise_on(err, "compact_finish", err_str)
    return CompactLags(pred, lat_c, volbw_c, rows)


def sim_relax_cuda(lat, volbw, duration, release, *, n_steps: int,
                   with_info: bool = False):
    """``n_steps`` dense sweeps from zeros on the current stream, by
    variant (see the module note): the compaction pass, ``sim_relax_pop``
    with its stop and overflow flag on the compact scenarios (its flags
    read back once), the dense kernel on the rest. Returns the (B, S)
    ends, and with ``with_info`` also the :class:`RelaxInfo`. Unguarded,
    as :func:`sim_step_cuda`."""
    b, s, _ = lat.shape

    def compact(*args):
        return None if compact_refusal(s) else compact_lags_cuda(*args)

    def relax(pred, lat_c, volbw_c, dur, rel, steps):
        dev = pred.device.index if pred.device.index is not None \
            else torch.cuda.current_device()
        if max_active_clusters(pop_plan(*pred.shape), dev) < 1:
            return None
        ends, sw, over = sim_relax_pop_cuda(
            pred, lat_c, volbw_c, dur, rel, n_steps=steps, with_sweeps=True,
            with_overflow=True)
        # the overflow flags pick the rows the dense variant redoes
        sw, over = torch.stack((sw, over)).cpu()  # lint: sync-ok
        return ends, sw, over.bool()

    def dense(rows, out):
        _dense_relax_cuda(lat, volbw, duration, release, n_steps, rows, out)
    out, info = _relax_variants(lat, volbw, duration, release, n_steps,
                                compact=compact, relax=relax, dense=dense)
    return (out, info) if with_info else out


def sim_relax_pop_torch(pred, lat, volbw, duration, release, *,
                        n_steps: int) -> torch.Tensor:
    """Plain PyTorch version: the kernel's expressions, one sweep per
    loop step, on whatever device the inputs lie on."""
    b, s, p1 = pred.shape
    idx = pred.reshape(b, s * p1).long()
    end = torch.zeros((b, s + 1), dtype=torch.float32, device=pred.device)
    for _ in range(n_steps):
        g = torch.gather(end, 1, idx).view(b, s, p1)
        ready = ((g + lat) + volbw).amax(dim=2)
        end[:, :s] = duration + torch.maximum(release, ready.clamp_min(0.0))
    return end[:, :s].clone()


def fixpoint_sweeps_torch(pred, lat, volbw, duration, release, *,
                          n_steps: int, with_overflow: bool = False):
    """The kernel's stop, in plain PyTorch: the same sweeps as
    :func:`sim_relax_pop_torch`, each row stopped at its first sweep that
    leaves its ends unchanged bit for bit. Returns the (B, S) ends and
    the (B,) int32 sweeps each row ran (that sweep counted; ``n_steps``
    for a row that never settles), what the kernel reports; with
    ``with_overflow`` also the kernel's (B,) flag of rows that computed
    an end of +inf or NaN at any sweep."""
    b, s, p1 = pred.shape
    idx = pred.reshape(b, s * p1).long()
    end = torch.zeros((b, s + 1), dtype=torch.float32, device=pred.device)
    sweeps = torch.zeros(b, dtype=torch.int32, device=pred.device)
    live = torch.ones(b, dtype=torch.bool, device=pred.device)
    over = torch.zeros(b, dtype=torch.bool, device=pred.device)
    for _ in range(n_steps):
        if not bool(live.any()):
            break
        g = torch.gather(end, 1, idx).view(b, s, p1)
        ready = ((g + lat) + volbw).amax(dim=2)
        new = duration + torch.maximum(release, ready.clamp_min(0.0))
        same = (new.view(torch.int32) == end[:, :s].view(torch.int32)).all(1)
        sweeps += live.int()
        over |= live & ~(new <= FLOAT32_MAX).all(1)
        end[live, :s] = new[live]
        live &= ~same
    if with_overflow:
        return end[:, :s].clone(), sweeps, over
    return end[:, :s].clone(), sweeps


class CompactLags(NamedTuple):
    """The compact variant's input: the gather form (N, S, P+1) of the N
    scenarios ``rows`` (int64, in order, on the host) that may take it,
    each row's kept entries in column order then pads of the sentinel S
    with ``-inf`` lags; P+1 the widest row among them (at least 1)."""
    pred: torch.Tensor
    lat: torch.Tensor
    volbw: torch.Tensor
    rows: torch.Tensor


class RelaxInfo(NamedTuple):
    """Which variant gave each of the B scenarios of one ``sim_relax``:
    ``compact`` (B,) bool, the sweeps each compact row ran (0 for the
    dense ones), ``redone`` (B,) bool the compact scenarios that
    overflowed and were redone dense, and the compact form's P+1 (0 when
    no scenario was compacted)."""
    compact: torch.Tensor
    sweeps: torch.Tensor
    redone: torch.Tensor
    p1: int


def compact_width(s: int) -> int:
    """Kept entries the compaction scratch holds per row: ``COMPACT_MAX``
    (past it the gather form's 12 bytes an entry gain less over the dense
    row's 8 bytes a column, and the scratch grows with it), or S."""
    return min(COMPACT_MAX, s)


def compact_refusal(s: int) -> str | None:
    """Why no scenario of S subtasks can take the compact variant (the
    end buffers of ``sim_relax_pop`` do not fit a block), or None."""
    need = pop_shared_bytes(s, 1, s, False)
    if need > MAX_SHARED_BYTES:
        return (f"S={s} needs {need} bytes of shared memory for "
                f"sim_relax_pop's ends")
    return None


def _bad_inputs(lat, volbw, duration, release) -> torch.Tensor:
    """(B,) bool: scenarios the compact variant's exactness does not
    cover: NaN or +inf anywhere in their inputs, or an entry with one lag
    -inf and the other finite."""
    inf = float("inf")
    bad = (torch.isnan(lat) | (lat == inf) | torch.isnan(volbw)
           | (volbw == inf) | ((lat == -inf) != (volbw == -inf)))
    ends = (torch.isnan(duration) | (duration == inf) | torch.isnan(release)
            | (release == inf))
    return bad.flatten(1).any(1) | ends.any(1)


def compact_lags_torch(lat, volbw, duration, release) -> CompactLags:
    """Plain PyTorch version of the compaction pass: an entry is kept iff
    both its lags are > -inf; a scenario is compacted unless
    ``_bad_inputs`` flags it or a row of it keeps more than
    :func:`compact_width` entries."""
    b, s, _ = lat.shape
    neg = float("-inf")
    keep = (lat > neg) & (volbw > neg)
    widest = keep.sum(2).amax(1)
    ok = ~_bad_inputs(lat, volbw, duration, release) \
        & (widest <= compact_width(s))
    rows = ok.nonzero().flatten().cpu()  # lint: sync-ok plain version
    n = rows.numel()
    p1 = max(1, int(widest[ok].max())) if n else 1
    pred = torch.full((n, s, p1), s, dtype=torch.int32, device=lat.device)
    lat_c = torch.full((n, s, p1), neg, dtype=torch.float32,
                       device=lat.device)
    volbw_c = torch.full_like(lat_c, neg)
    if n:
        sel = rows.to(lat.device)
        k = keep.index_select(0, sel)
        bi, si, ji = k.nonzero(as_tuple=True)
        slot = (k.cumsum(2) - 1)[bi, si, ji]
        pred[bi, si, slot] = ji.int()
        lat_c[bi, si, slot] = lat.index_select(0, sel)[bi, si, ji]
        volbw_c[bi, si, slot] = volbw.index_select(0, sel)[bi, si, ji]
    return CompactLags(pred, lat_c, volbw_c, rows)


def _relax_variants(lat, volbw, duration, release, n_steps, *, compact,
                    relax, dense) -> tuple[torch.Tensor, RelaxInfo]:
    """The choice of ``sim_relax``'s variant per scenario, with the
    pieces given: ``compact(lat, volbw, duration, release)`` a
    :class:`CompactLags` (or None: no scenario may be compacted);
    ``relax(pred, lat, volbw, duration, release, n_steps)`` the stopped
    relaxation's (ends, sweeps, overflow), the last two on the host (or
    None: the form cannot be placed); ``dense(rows, out)`` the dense
    variant of scenarios ``rows`` written into ``out``."""
    b, s = duration.shape
    out = torch.zeros((b, s), dtype=torch.float32, device=duration.device)
    use = torch.zeros(b, dtype=torch.bool)
    sweeps = torch.zeros(b, dtype=torch.int32)
    redone = torch.zeros(b, dtype=torch.bool)
    p1 = 0
    comp = compact(lat, volbw, duration, release)
    if comp is not None and comp.rows.numel():
        every = comp.rows.numel() == b          # rows are 0..B-1 in order
        sel = None if every else comp.rows.to(duration.device)
        got = relax(comp.pred, comp.lat, comp.volbw,
                    *((duration, release) if every else
                      (duration.index_select(0, sel),
                       release.index_select(0, sel))), n_steps)
        if got is not None:
            ends, sw, over = got
            if every:
                out = ends
            else:
                out.index_copy_(0, sel, ends)
            use[comp.rows] = ~over
            sweeps[comp.rows] = torch.where(over, 0, sw)
            redone[comp.rows] = over
            p1 = comp.pred.shape[2]
    need = (~use).nonzero().flatten()
    if need.numel():
        dense(need, out)
    return out, RelaxInfo(use, sweeps, redone, p1)


def sim_relax_variants_torch(lat, volbw, duration, release, *,
                             n_steps: int) -> tuple[torch.Tensor, RelaxInfo]:
    """The card's ``sim_relax`` with plain versions for its kernels:
    :func:`compact_lags_torch`, :func:`fixpoint_sweeps_torch` with the
    overflow flag, :func:`sim_relax_torch` for the dense scenarios. Equal
    to ``sim_relax_torch(..., n_steps)`` bit for bit (NaN at the same
    places)."""
    def compact(*args):
        return None if compact_refusal(lat.shape[1]) else \
            compact_lags_torch(*args)

    def relax(*args):
        ends, sw, over = fixpoint_sweeps_torch(*args[:5], n_steps=args[5],
                                               with_overflow=True)
        return ends, sw.cpu(), over.cpu()  # lint: sync-ok plain version

    def dense(rows, out):
        sel = rows.to(out.device)
        out[sel] = sim_relax_torch(*(x.index_select(0, sel) for x in
                                     (lat, volbw, duration, release)),
                                   n_steps=n_steps)
    return _relax_variants(lat, volbw, duration, release, n_steps,
                           compact=compact, relax=relax, dense=dense)


@functools.cache
def _library():
    lib = build.load("sim_relax_pop")
    fn = lib.sim_relax_pop
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sim_relax_pop_error_string.argtypes = [ctypes.c_int]
    lib.sim_relax_pop_error_string.restype = ctypes.c_char_p
    lib.sim_relax_pop_max_active_clusters.argtypes = [ctypes.c_int] * 3 \
        + [ctypes.c_longlong]
    lib.sim_relax_pop_max_active_clusters.restype = ctypes.c_int
    return lib


@functools.cache
def max_active_clusters(plan: PopPlan, device_index: int) -> int:
    """Clusters of the plan's kind the device holds at once (the
    library's ``cudaOccupancyMaxActiveClusters``); 0 means it cannot
    run one."""
    lib = _library()
    with torch.cuda.device(device_index):
        n = lib.sim_relax_pop_max_active_clusters(
            plan.k, int(plan.variant == "staged"), plan.threads,
            plan.shared_bytes)
    if n < 0:
        raise RuntimeError(
            f"sim_relax_pop: occupancy query failed: CUDA error {-n} "
            f"({lib.sim_relax_pop_error_string(-n).decode()})")
    return n


def sim_relax_pop_cuda(pred, lat, volbw, duration, release, *,
                       n_steps: int, with_sweeps: bool = False,
                       with_overflow: bool = False):
    """Launch the kernel on the current stream of the inputs' device with
    :func:`pop_plan`'s cluster and variant. Returns the (B, S) ends, then
    with ``with_sweeps`` the (B,) int32 sweeps each row ran, then with
    ``with_overflow`` the (B,) int32 flag of rows that computed an end of
    +inf or NaN at any sweep. Raises if the device cannot hold one such
    cluster. Unguarded otherwise: the caller has checked shapes, types,
    contiguity, index bounds, the shared-memory size and that B and S are
    non-zero."""
    lib = _library()
    b, s, p1 = pred.shape
    plan = pop_plan(b, s, p1)
    dev = pred.device.index if pred.device.index is not None \
        else torch.cuda.current_device()
    if max_active_clusters(plan, dev) < 1:
        raise RuntimeError(
            f"sim_relax_pop: the device cannot hold one cluster of "
            f"{plan.k} CTAs of {plan.threads} threads with "
            f"{plan.shared_bytes} bytes of shared memory each "
            f"({plan.variant} variant at B={b}, S={s}, P+1={p1})")
    out = torch.empty((b, s), dtype=torch.float32, device=pred.device)
    sweeps = torch.empty(b, dtype=torch.int32, device=pred.device) \
        if with_sweeps else None
    overflow = torch.zeros(b, dtype=torch.int32, device=pred.device) \
        if with_overflow else None
    with torch.cuda.device(pred.device):
        err = lib.sim_relax_pop(
            pred.data_ptr(), lat.data_ptr(), volbw.data_ptr(),
            duration.data_ptr(), release.data_ptr(), out.data_ptr(),
            None if sweeps is None else sweeps.data_ptr(),
            None if overflow is None else overflow.data_ptr(), b, s, p1,
            n_steps, plan.k, int(plan.variant == "staged"), plan.threads,
            plan.shared_bytes, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sim_relax_pop", lib.sim_relax_pop_error_string)
    extra = tuple(x for x in (sweeps, overflow) if x is not None)
    return (out, *extra) if extra else out
