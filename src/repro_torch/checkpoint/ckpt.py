"""Checkpointing: async save, keep-K retention, restore onto a device,
and restore with reshard.

The reference's on-disk layout (``checkpoint/ckpt.py``): one directory
``step_%08d`` per step holding a flat ``state.npz`` (leaves keyed by
their path, ``params/<parameter name>``, ``opt/m/<name>``,
``opt/step``, ...) and ``meta.json``; a ``COMMIT`` marker written last
and the directory renamed into place from ``.tmp``, so a partial save is
invisible to :meth:`CheckpointManager.list_steps`. NumPy has no
bfloat16: such a leaf is stored as its uint16 bits and ``meta.json``
names its dtype, so a restore gives the same bits back.

A train state is ``{"params": Model, "opt": {"m": {...}, "v": {...},
"step": tensor, ...}}``. :meth:`CheckpointManager.save` copies every
leaf to host memory before it returns (the next step may update the
tensors in place), then writes on a thread; :meth:`restore` copies the
saved values into a template state of the same structure, in place, on
the devices of the template's tensors (a fresh state built on the
device to restore onto).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from ..sharding.partition import Spec, gather, shard_slices


def _flatten(tree, prefix="") -> dict:
    if isinstance(tree, Spec):
        return {prefix: tree}
    if isinstance(tree, torch.nn.Module):
        return {f"{prefix}/{k}" if prefix else k: v
                for k, v in tree.named_parameters()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    return t.cpu().numpy(), str(t.dtype).replace("torch.", "")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}


def _member(npz: str, info: zipfile.ZipInfo) -> np.ndarray:
    """The array of one stored ``.npz`` member, memory-mapped read-only:
    only the pages a slice of it touches are read."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{npz}: {info.filename} is compressed")
    with open(npz, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)                   # the zip local file header
        name_len = int.from_bytes(head[26:28], "little")
        extra_len = int.from_bytes(head[28:30], "little")
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        read = _HEADERS.get(version)
        if read is None:
            raise ValueError(f"{npz}: {info.filename} has .npy format "
                             f"{version}")
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if dtype.hasobject:
        raise ValueError(f"{npz}: {info.filename} holds objects")
    if not shape:
        return np.fromfile(npz, dtype=dtype, count=1,
                           offset=offset).reshape(())
    return np.memmap(npz, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ---- save -----------------------------------------------------------
    def save(self, state, step: int, block: bool = False, shardings=None):
        """Snapshot ``state`` to host memory now, write it on a thread
        (or here with ``block`` or ``async_save=False``). With
        ``shardings`` every rank of the mesh calls it: each sharded leaf
        is gathered whole, and rank 0 alone writes."""
        leaves = _flatten(state)
        if shardings is not None:
            specs = _flatten(shardings.specs)
            leaves = {k: gather(v.detach(), specs[k], shardings.mesh)
                      if k in specs else v for k, v in leaves.items()}
            if torch.distributed.get_rank() != 0:
                return
        flat, dtypes = {}, {}
        for k, v in leaves.items():
            flat[k], dtypes[k] = _to_numpy(v)
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_caught, args=(flat, dtypes, step),
                daemon=True)
            self._thread.start()
        else:
            self._write(flat, dtypes, step)

    def _write_caught(self, flat, dtypes, step):
        try:
            self._write(flat, dtypes, step)
        except BaseException as e:          # noqa: BLE001 - re-raised by wait
            self._error = e

    def _write(self, flat, dtypes, step):
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "n_leaves": len(flat), "dtypes": dtypes}, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()

    def wait(self):
        """Wait for the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---- restore ----------------------------------------------------------
    def list_steps(self) -> list[int]:
        """The committed steps, in order."""
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(full, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, template, step: int, shardings=None):
        """Copy step ``step`` into ``template`` (a state of the same
        structure and types) in place, each leaf onto its own device;
        returns the template. With ``shardings`` a leaf that has a spec
        is this rank's slice under it (the template holds the local
        shapes), read alone from the file; the others are whole."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f)["dtypes"]
        npz = os.path.join(path, "state.npz")
        with zipfile.ZipFile(npz) as z:
            stored = {n[:-len(".npy")]: z.getinfo(n) for n in z.namelist()}
        leaves = _flatten(template)
        differ = sorted(set(leaves) ^ set(stored))
        if differ:
            raise ValueError(f"checkpoint {path}: leaves differ from the "
                             f"template's: {differ[:5]}")
        specs = _flatten(shardings.specs) if shardings is not None else {}
        with torch.no_grad():
            for k, t in leaves.items():
                whole = _member(npz, stored[k])
                if k in specs:
                    whole = whole[shard_slices(whole.shape, specs[k],
                                               shardings.mesh)]
                src = _from_numpy(np.array(whole, order="C"), dtypes[k])
                if src.dtype != t.dtype or src.shape != t.shape:
                    raise ValueError(f"{k}: saved {src.dtype} "
                                     f"{tuple(src.shape)}"
                                     f"{' sliced' if k in specs else ''}, "
                                     f"template {t.dtype} "
                                     f"{tuple(t.shape)}")
                t.copy_(src.to(t.device))
        return template

    def restore_latest(self, template, shardings=None):
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return self.restore(template, steps[-1], shardings)
