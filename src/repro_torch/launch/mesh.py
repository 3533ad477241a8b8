"""Meshes over ``torch.distributed`` ranks, and the helpers the sharded
modules read them with.

The reference builds its meshes from JAX devices, and a CPU test forces
N host devices with ``XLA_FLAGS``. Here a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the first
``prod(shape)`` ranks of the initialised default process group: one
process per device, NCCL on the card, gloo on the CPU. The counterpart
of the forced host devices is :func:`spawn_cpu_ranks`, which starts N
CPU processes on gloo and runs a function in each.

The dry-run and the abstract trace-check entries run one process as
rank 0 of a larger world: :func:`fake_world` starts a process group on
PyTorch's ``fake`` backend, whose collectives return at once and move
nothing, and :func:`make_mesh` builds a ``"cpu"`` mesh over it. No
other group accepts it, and a card mesh still needs NCCL.

Defined as functions, so importing this module starts no process and
touches no process group.
"""

from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from collections.abc import Mapping
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["axis_ranks", "axis_sizes", "check_tensors", "fake_world",
           "make_mesh", "make_production_mesh", "mesh_coords",
           "spawn_cpu_ranks"]

#: the backend each mesh device type runs its collectives on
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: the analysis-only backend a ``"cpu"`` mesh also takes (:func:`fake_world`)
FAKE_BACKEND = "fake"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16 x 16 = 256 devices per pod; 2 x 16 x 16 = 512 across two pods,
    with the reference's axis names. The ``pod`` axis is the slow
    inter-pod dimension."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str | None = None,
              ranks: list[int] | None = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over ranks ``0 .. prod(shape) -
    1`` of the default process group, row-major, or over ``ranks`` in
    that order (a permuted mesh: :func:`repro_torch.autoplace.
    stage_mesh`). ``device_type`` is ``"cuda"`` (an NCCL group) unless
    the caller asks for ``"cpu"`` (a gloo group, or the ``fake`` group
    of :func:`fake_world`). Every rank of the world calls it. Raises
    when no group is initialised, when the group's backend does not
    serve the device type, when the world has fewer ranks than the
    mesh, or when ``ranks`` are not that many distinct ranks of it."""
    device_type = device_type or "cuda"
    if device_type not in BACKENDS:
        raise ValueError(f"device type {device_type!r} is not one of "
                         f"{sorted(BACKENDS)}")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"no process group: start {n} processes (one per device, e.g. "
            f"torchrun --nproc-per-node {n}, or spawn_cpu_ranks({n}, ...) "
            f"on the CPU) and init_process_group in each")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks, have {world}: start {n} processes (torchrun "
            f"--nproc-per-node {n}, or spawn_cpu_ranks({n}, ...) on the "
            f"CPU)")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type] and not (
            backend == FAKE_BACKEND and device_type == "cpu"):
        raise ValueError(f"a {device_type} mesh needs a "
                         f"{BACKENDS[device_type]} process group, this one "
                         f"is {backend}")
    order = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(set(order)) != n or len(order) != n or \
            not all(0 <= r < world for r in order):
        raise ValueError(f"ranks {ranks}: need {n} distinct ranks of the "
                         f"world's {world}")
    return DeviceMesh(device_type, torch.tensor(order).reshape(shape),
                      mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a world of ``n`` ranks on the ``fake``
    backend, for analysis only: its collectives return at once and move
    nothing, so one process records what rank 0 of a production mesh
    runs (:mod:`repro_torch.launch.dryrun`, the abstract trace-check
    entries). :func:`make_mesh` builds a ``"cpu"`` mesh over it. The
    group is destroyed on exit; raises if a group is already
    initialised."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake world needs the process to itself")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a :class:`DeviceMesh`, or of a mapping from
    axis name to size (the counterpart of the reference's
    ``AbstractMesh``: specs at production sizes need no processes)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coords(mesh: DeviceMesh) -> dict[str, int]:
    """This rank's index along every axis of ``mesh``; raises for a rank
    outside the mesh. A collective over one axis runs on the mesh's own
    group of it, ``mesh.get_group(axis)``, in which a rank's index is
    its place among the group's global ranks in increasing order. That
    equals its coordinate along the axis where the mesh lists its ranks
    in increasing order along it (every :func:`make_mesh` mesh without
    ``ranks``), not in a permuted mesh: there a neighbour's rank comes
    from :func:`axis_ranks`."""
    at = mesh.get_coordinate()
    if at is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, at))


def axis_ranks(mesh: DeviceMesh, axis: str) -> list[int]:
    """The global ranks along ``axis`` through this rank, by coordinate:
    entry i is the rank at coordinate i of the axis (this rank's
    coordinates on the others), read from the mesh's own rank tensor."""
    from torch.utils._python_dispatch import _disable_current_modes
    at = mesh_coords(mesh)
    index = tuple(slice(None) if a == axis else at[a]
                  for a in mesh.mesh_dim_names)
    with _disable_current_modes():          # the mesh's real rank tensor
        return [int(r) for r in mesh.mesh[index].tolist()]


def check_tensors(mesh: DeviceMesh, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the mesh's device type: a CUDA
    tensor under a gloo (``"cpu"``) mesh, or a CPU tensor under an NCCL
    one, is refused, never moved."""
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(
                f"a {t.device.type} tensor under a {mesh.device_type} mesh "
                f"({BACKENDS[mesh.device_type]}): move it to "
                f"{mesh.device_type} or build the mesh for "
                f"{t.device.type}; nothing is moved silently")


# ---------------------------------------------------------------------------
# N CPU ranks on gloo (the counterpart of forced host devices)
# ---------------------------------------------------------------------------

def _rank_main(rank, n, store_path, results, payload, timeout_s):
    torch.set_num_threads(1)
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        store = dist.FileStore(store_path, n)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:           # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_cpu_ranks(n: int, fn, *args, timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``n`` new CPU processes joined in one
    gloo process group (a ``FileStore`` in a fresh temporary directory,
    world size ``n``), one thread each, and return their results in rank
    order. ``fn`` and ``args`` are pickled once (``fn`` by its import
    path) into a file each rank reads, so the ranks start together
    whatever the arguments' size (through the process arguments each
    start would wait for the last rank to take them); each result is
    pickled by value. Raises with the rank's traceback when a
    rank fails, and ``TimeoutError`` when the ranks have not all
    returned ``timeout`` seconds after the start; either way every rank
    still running is killed."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_gloo_") as tmp:
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, os.path.join(tmp, "store"),
                                   results, payload, timeout),
                             daemon=True) for r in range(n)]
        deadline = time.monotonic() + timeout
        done = {}
        try:
            for p in procs:
                p.start()
            while len(done) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{n - len(done)} of {n} ranks had not returned "
                        f"after {timeout:.0f} s (ranks "
                        f"{sorted(set(range(n)) - set(done))}): killed")
                try:
                    rank, ok, out = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"ranks exited without a result "
                                           f"(rank, exit code): {dead}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
                done[rank] = pickle.loads(out)
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
            results.close()
        return [done[r] for r in range(n)]
