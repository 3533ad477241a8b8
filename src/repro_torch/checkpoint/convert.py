"""A checkpoint of the JAX package's training run -> a train state of the
port.

The reference's :class:`CheckpointManager` writes one directory
``step_%08d`` per step, holding ``state.npz`` with every leaf of the
train state keyed by its tree path, a ``meta.json`` and, last, a
``COMMIT`` marker. The parameters are ``params/<path>`` in the
reference's layout (``prologue/<i>/...`` and ``tail/<i>/...`` lists,
``groups/<pos>/...`` stacked over the repeats along a leading axis,
Zamba-2's ``shared/...`` and ``shared_lora/...``, the top-level leaves
such as ``embed``); the optimizer's ``opt/m/<path>``, ``opt/v/<path>``
and, under int8 compression, ``opt/ef/<path>`` follow the same tree, and
``opt/step`` is a 0-d int32.

:func:`state_from_reference` rebuilds the tree, maps the parameters
through :func:`repro_torch.models.convert.params_from_reference` and the
moments through the same layer mapping, so that they are keyed by the
port's parameter names (``Model.named_parameters()``), as
:func:`repro_torch.optim.adamw.init_opt_state` lays them out. The result
is the port's train state ``{"params": Model, "opt": {...}}``, which
``Trainer`` steps and the port's own checkpoint manager saves.

NumPy has no bfloat16: the reference's bfloat16 leaves come back from
``np.load`` as 2-byte void (``|V2``) arrays with their bits intact, and
are reinterpreted as ``torch.bfloat16`` where the port's parameter is of
that type. Nothing is filled in: a leaf the port lacks or needs, a shape
other than the port's, or an element size other than the port's type's
is refused with the leaf's key, and so is a step without ``COMMIT``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.convert import params_from_reference, reference_key
from ..models.model import Model, init_params
from ..optim.adamw import OptConfig


class ReferenceCheckpointError(ValueError):
    """A reference checkpoint the port cannot take as it is."""


def _step_dir(path: str) -> str:
    """``path`` itself when it is one ``step_XXXXXXXX`` directory (which
    must hold ``COMMIT``), else the latest committed step under it."""
    path = os.path.abspath(path)
    if os.path.basename(path).startswith("step_"):
        if not os.path.exists(os.path.join(path, "COMMIT")):
            raise ReferenceCheckpointError(
                f"{path}: no COMMIT marker (a partial save)")
        return path
    steps = sorted(name for name in os.listdir(path)
                   if name.startswith("step_") and not name.endswith(".tmp")
                   and os.path.exists(os.path.join(path, name, "COMMIT")))
    if not steps:
        raise ReferenceCheckpointError(f"{path}: no committed checkpoint")
    return os.path.join(path, steps[-1])


def _unflatten(flat: dict) -> dict:
    """``/``-separated keys -> nested dicts; the ``prologue`` and
    ``tail`` entries become lists (their digit keys index them), the
    ``groups`` entry stays a dict keyed by the position's string, as the
    reference's tree has them."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        return {k: [lists(v[str(i)]) for i in range(len(v))]
                if k in ("prologue", "tail") else lists(v)
                for k, v in node.items()}
    return lists(tree)


def _leaf(key: str, a: np.ndarray, shape: tuple, dtype: torch.dtype
          ) -> torch.Tensor:
    """The saved array ``a`` as a CPU tensor of ``dtype``, refused unless
    its shape is ``shape`` and its elements are ``dtype``'s: a bfloat16
    leaf is 2-byte void (or ml_dtypes' ``bfloat16``) and is reinterpreted
    bit for bit."""
    if tuple(a.shape) != tuple(shape):
        raise ReferenceCheckpointError(
            f"{key}: shape {tuple(a.shape)}, the port's is {tuple(shape)}")
    size = torch.empty((), dtype=dtype).element_size()
    if a.dtype.itemsize != size:
        raise ReferenceCheckpointError(
            f"{key}: {a.dtype.itemsize}-byte elements ({a.dtype}), the "
            f"port's {dtype} has {size}")
    a = np.array(a, copy=True, order="C")      # writable, contiguous
    if dtype == torch.bfloat16:
        if a.dtype.kind != "V" and a.dtype.name != "bfloat16":
            raise ReferenceCheckpointError(
                f"{key}: {a.dtype} where the port holds bfloat16")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    want = torch.empty((), dtype=dtype).numpy().dtype
    if a.dtype != want:
        raise ReferenceCheckpointError(
            f"{key}: {a.dtype} where the port holds {want}")
    return torch.from_numpy(a)


def _expected(template: Model, cfg: ModelConfig) -> dict:
    """{reference path: (shape, dtype)} of the port's parameters: a leaf
    stacked over repeats has the repeat count in front."""
    n_rep = cfg.repeat_structure()[1]
    out = {}
    for name, p in template.named_parameters():
        key, rep = reference_key(name, cfg)
        out[key] = ((n_rep,) if rep is not None else ()) + tuple(p.shape), \
            p.dtype
    return out


def state_from_reference(path: str, cfg: ModelConfig, opt_cfg: OptConfig,
                         device=None) -> dict:
    """The reference checkpoint at ``path`` (a checkpoint directory, whose
    latest committed step is taken, or one ``step_XXXXXXXX``) as the
    port's train state ``{"params": Model (trainable), "opt": {"m", "v",
    "step", and "ef" under int8 compression}}`` on ``device`` (the card
    unless given). Raises :class:`ReferenceCheckpointError` with the
    leaf's key on a missing or extra leaf, a shape or an element size
    other than the port's, and on a step without ``COMMIT``."""
    device = torch.device(device if device is not None else "cuda")
    path = _step_dir(path)
    template = init_params(cfg, torch.Generator(), "meta")
    expected = _expected(template, cfg)
    parts = ("m", "v") + (("ef",) if opt_cfg.compression == "int8" else ())
    want = {f"params/{k}": v for k, v in expected.items()}
    for part in parts:
        want.update({f"opt/{part}/{k}": (shape, torch.float32)
                     for k, (shape, _) in expected.items()})
    want["opt/step"] = ((), torch.int32)

    with np.load(os.path.join(path, "state.npz")) as data:
        missing = sorted(set(want) - set(data.files))
        extra = sorted(set(data.files) - set(want))
        if missing or extra:
            raise ReferenceCheckpointError(
                f"{path}: leaves the port needs and the checkpoint lacks "
                f"{missing[:5]}, leaves the port does not have {extra[:5]}")
        flat = {k: _leaf(k, data[k], *want[k]) for k in data.files}

    tree = _unflatten(flat)
    params = params_from_reference(tree["params"], cfg, device)
    params.requires_grad_(True)

    def named(sub: dict) -> dict:
        return {k: p.detach() for k, p in
                params_from_reference(sub, cfg, device).named_parameters()}
    opt = {part: named(tree["opt"][part]) for part in parts}
    opt["step"] = tree["opt"]["step"].to(device)
    return {"params": params, "opt": opt}
