"""Faults planted in the port's train step, each of which ``correct``
has to catch: the step wrapped, the program untouched. Used by
``tools/calibrate.py`` (the faults' readings on the card) and the
tests (``correct`` false at tiny sizes)."""

import copy

import torch


def unchanged(step):
    """A step that returns its state unchanged."""
    def broken(state, batch):
        keep = copy.deepcopy(state)
        _, met = step(state, batch)
        with torch.no_grad():
            for p, q in zip(state["params"].parameters(),
                            keep["params"].parameters()):
                p.copy_(q)
        for k in ("m", "v"):
            for name, t in state["opt"][k].items():
                t.copy_(keep["opt"][k][name])
        state["opt"]["step"] = keep["opt"]["step"]
        return state, met
    return broken


def half_batch(step):
    """Half of each batch left out, the mean taken over the rest."""
    def broken(state, batch):
        return step(state, {k: v[:v.shape[0] // 2] for k, v in
                            batch.items()})
    return broken


def answer_altered(step):
    """The loss the step reports altered by 1 % where it is produced."""
    def broken(state, batch):
        state, met = step(state, batch)
        return state, dict(met, loss=met["loss"] * 1.01)
    return broken
