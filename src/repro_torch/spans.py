"""Named spans of the port's layers in a profiler's trace.

:func:`span` marks a region of the port by name while
``torch.profiler`` records: the span is an event of the profiler's own
session, on the clock of its device trace, so a ``torch.profiler`` or
Perfetto view of the port shows which layer launched each kernel. While
no profiler records it returns one shared no-op context, and a span
costs a check of the profiler's state.

The spans of the port, each around the whole body of its function:

* ``optim.adamw`` — :func:`repro_torch.optim.adamw.apply_updates`;
* ``model.moe`` — :func:`repro_torch.models.moe.moe_ffn` (router,
  dispatch, expert products, combine; not the shared experts);
* ``model.mamba2`` — :func:`repro_torch.models.blocks.mamba_forward`;
* ``model.attention`` — :func:`repro_torch.models.blocks.attn_forward`
  (MLA, and the hybrid shared block's attention with its LoRA).

The model's spans sit inside the functions that a remat region
(``torch.utils.checkpoint``) runs again in the backward, so the
recomputation enters them too, on the thread that runs the backward.

A kernel launched by a ctypes call outside every PyTorch operation has
no launching operation in a profile: the profiler links a device
operation to the operation that launched it, and a span is not one. So
a span reader could not count it. :func:`launch` marks such a call as an
operation of its own while a profiler records: the multi-tensor AdamW
kernels (``adamw.grad_sumsq``, ``adamw.update``), which run inside
``optim.adamw`` but in no operation of PyTorch's.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` around its body while a profiler
    records on this thread (``torch.profiler.record_function``), and
    the shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def launch(name: str):
    """A context that records ``name`` as a host operation (not a span)
    around a kernel launch while a profiler records on this thread, so
    the kernels launched in it link to it, and the shared no-op context
    otherwise. ``torch._C._profiler._RecordFunctionFast``: PyTorch marks
    the launches of its own compiled kernels the same way."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
