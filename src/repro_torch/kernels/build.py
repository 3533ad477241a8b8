"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, under
``build/kernels/`` at the repository root (git ignores ``build/``). The
library's file name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads what an earlier
process built. :func:`build` starts one ``nvcc`` per source, all at
once, and keeps each compiler's ``-Xptxas -v`` report in :data:`BUILT`.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuiltKernel:
    name: str
    path: Path
    seconds: float          # nvcc wall time; 0.0 when an earlier build is reused
    log: str                # nvcc's stderr (the ptxas register/spill report)


BUILT: dict[str, BuiltKernel] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin "
                       "and /usr/local/cuda/bin): the CUDA kernels are "
                       "built at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: list[str] | None = None) -> dict[str, BuiltKernel]:
    """Build every named kernel (default: every source in ``csrc/``) that
    has no library yet, one ``nvcc`` per source, started together.
    Raises ``RuntimeError`` with the compiler's output if one fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        if name in BUILT:
            continue
        out = library_path(name)
        if out.is_file():
            BUILT[name] = BuiltKernel(name, out, 0.0, "(reused)")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, out, tmp, time.perf_counter())
    failed = []
    for name, (proc, out, tmp, t0) in jobs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)            # atomic: readers never see half a file
        BUILT[name] = BuiltKernel(name, out, seconds, stdout + stderr)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: BUILT[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed. The
    caller sets ``argtypes`` and ``restype`` on the functions it calls."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LOADED[name] = lib
    return lib
