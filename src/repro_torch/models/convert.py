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
:class:`~repro_torch.models.model.LoRA` per slot. Every leaf is copied
as it is: the layouts are the same.

The tree's leaves are NumPy arrays (``np.asarray`` of each JAX array);
bfloat16 arrives as ml_dtypes' ``bfloat16`` and is reinterpreted bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import Model


def to_tensor(a, device=None) -> torch.Tensor:
    """A copy of the array ``a`` as a tensor on ``device``."""
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
                  for k in ("embed", "final_norm", "head") if k in tree}}
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
