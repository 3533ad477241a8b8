"""The JAX package's parameter tree -> the port's model.

The reference model keeps the layers of each repeat group stacked along
a leading axis (``params["groups"][str(pos)]``, one entry per position
``pos`` of the repeat unit, for ``lax.scan``); the port keeps one
:class:`~repro_torch.models.model.Layer` per layer. Layer
``len(prologue) + rep * len(unit) + pos`` is repeat ``rep`` of
``groups[str(pos)]``; the prologue and tail layers are unstacked lists
already. A Mamba layer's tree is flat (no ``attn``/``mlp`` subtrees); a
MoE layer has ``moe`` ({"router", "wi", "wo"}) and, with shared
experts, ``shared_mlp`` subtrees in place of ``mlp``; an MLA layer's
``attn`` holds ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``.
Zamba-2's ``shared`` block is one tree; its ``shared_lora`` is stacked
over the ``n_rep`` repeat slots and unstacked here, one
:class:`~repro_torch.models.model.LoRA` per slot. The frontends'
``frontend`` (encoder) and ``patch_proj`` (VLM) are top-level leaves,
beside ``embed``. Every leaf is copied as it is: the layouts are the
same.

The tree's leaves are NumPy arrays (``np.asarray`` of each JAX array;
bfloat16 arrives as ml_dtypes' ``bfloat16`` and is reinterpreted bit for
bit) or tensors already of the port's types (a reference checkpoint read
by :mod:`repro_torch.checkpoint.convert`, which finds each of the port's
parameters in it by :func:`reference_key`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import TOP_LEVEL, Model


def to_tensor(a, device=None) -> torch.Tensor:
    """A copy of the array or tensor ``a`` as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        t = a.detach().clone(memory_format=torch.contiguous_format)
        return t.to(device) if device is not None else t
    a = np.array(a, copy=True, order="C")          # writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _flat(tree: dict, device, rep: int | None = None) -> dict:
    return {k: to_tensor(v if rep is None else v[rep], device)
            for k, v in tree.items()}


SUBTREES = ("attn", "mlp", "moe", "shared_mlp")


def _layer(tree: dict, device, rep: int | None = None) -> dict:
    if "attn" not in tree:                      # a Mamba layer
        return _flat(tree, device, rep)
    out = {"norms": _flat({k: v for k, v in tree.items()
                           if k not in SUBTREES}, device, rep)}
    out.update({k: _flat(tree[k], device, rep) for k in SUBTREES
                if k in tree})
    return out


def params_from_reference(tree: dict, cfg: ModelConfig,
                          device=None) -> Model:
    """The reference's ``init_params`` tree (leaves as NumPy arrays) as
    the port's :class:`~repro_torch.models.model.Model` on ``device``."""
    prologue, n_rep, unit, tail = cfg.repeat_structure()
    layers = [_layer(t, device) for t in tree.get("prologue", [])]
    for rep in range(n_rep):
        layers += [_layer(tree["groups"][str(pos)], device, rep)
                   for pos in range(len(unit))]
    layers += [_layer(t, device) for t in tree.get("tail", [])]
    tensors = {"layers": layers,
               **{k: to_tensor(tree[k], device)
                  for k in TOP_LEVEL if k in tree}}
    if "shared" in tree:
        sh = tree["shared"]
        tensors["shared"] = {
            "norms": {k: to_tensor(sh[k], device) for k in ("ln1", "ln2")},
            "attn": _flat(sh["attn"], device),
            "mlp": _flat(sh["mlp"], device),
            "down": to_tensor(sh["down"], device)}
        tensors["shared_lora"] = [_flat(tree["shared_lora"], device, rep)
                                  for rep in range(n_rep)]
    return Model(cfg, tensors)


def reference_key(name: str, cfg: ModelConfig) -> tuple[str, int | None]:
    """The reference's tree path of the port's parameter ``name`` and,
    for a leaf stacked over repeats, the repeat's index along its leading
    axis: the layout :func:`params_from_reference` reads, the other way
    round."""
    parts = name.split(".")
    if parts[0] == "layers":
        prologue, n_rep, unit, _ = cfg.repeat_structure()
        i, rest = int(parts[1]), "/".join(parts[2:])
        if i < len(prologue):
            return f"prologue/{i}/{rest}", None
        j = i - len(prologue)
        if j < n_rep * len(unit):
            return f"groups/{j % len(unit)}/{rest}", j // len(unit)
        return f"tail/{j - n_rep * len(unit)}/{rest}", None
    if parts[:2] == ["shared", "lora"]:
        return "shared_lora/" + "/".join(parts[3:]), int(parts[2])
    return "/".join(parts), None
