"""Roofline terms of one eager call, counted from the aten ops it runs.

The counterpart of the reference's ``repro/launch/hlo_analysis.py``,
under another name because there is nothing to parse: eager PyTorch
compiles no HLO module, and a Python loop runs its body as many times as
it turns, so no trip count needs correcting. Instead :func:`analyze_call`
runs the call once under :class:`Recorder` (a ``TorchDispatchMode``
that sees every aten op after PyTorch's composite decompositions, with
its tensors' shapes, dtypes and devices) and under
``torch.utils.flop_counter.FlopCounterMode``, and returns a
:class:`CallCost` with the reference's ``ModuleCost`` fields where they
still mean something:

* ``dot_flops`` — the matrix-product FLOPs ``FlopCounterMode`` counts
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, SDPA); like
  the reference's, elementwise work is not counted;
* ``traffic_bytes`` — an HBM traffic proxy: the operand bytes plus the
  result bytes of every recorded op, left out: views and aliases (any op
  whose schema returns an alias of an input: ``view``, ``permute``,
  ``expand``, ``slice``, ``detach``, ...), metadata queries (``prim.*``,
  ``sym_size``, ``is_contiguous``, ...), ``lift_fresh`` and the
  allocations ``empty``/``empty_like``/``empty_strided``/``new_empty``.
  Copies (``clone``, ``_to_copy``, ``copy_``) count: in eager CUDA a
  copy is a kernel of its own, where the reference's proxy skips XLA's
  ``copy`` as loop-carry plumbing. Unfused eager code therefore counts
  more traffic than the compiled program the reference measures;
* ``collective_bytes`` by the reference's opcode names and
  ``collective_total`` — the bytes a rank hands each ``c10d`` collective
  (``allreduce_`` is ``all-reduce``, ``alltoall_base_`` ``all-to-all``,
  a ``send`` of the pipeline's shift ``collective-permute``, ...); a
  ``recv_`` is the other side of a send and adds nothing;
* ``top_dots``, ``top_collectives``, ``top_traffic`` — the largest ops
  of each term.

``unknown_trip_counts`` has no counterpart and is dropped: nothing is
estimated, every op that runs is recorded.

The call may run on real tensors or, for the dry-run and the abstract
trace-check entries, on fake CPU tensors (``FakeTensorMode``: shapes and
dtypes, no storage, nothing computed) under a ``fake`` process group
(:func:`repro_torch.launch.mesh.fake_world`), whose collectives the
recorder sees as ``c10d`` ops. A fake tensor cannot answer a host read
(``.item()``, ``.tolist()``): with ``answer_reads`` the recorder keeps a
real copy of every small integer tensor the call makes from host values
(a decode position, its guard's range), computing each op on the copies
beside the fakes, and answers a host read of such a tensor with its real
value. So a range guard such as ``ops.flash_decode``'s still checks the
positions the call computed; a read of anything else (a float, a large
tensor) still raises.

This module also holds the one op recorder of the port:
:mod:`repro_torch.analysis.tracecheck` reads the same records.
"""

from __future__ import annotations

import heapq
import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["CallCost", "OpRecord", "Recorder", "analyze_call", "call_cost",
           "fake_mode", "record"]

#: the reference's opcode name of each c10d collective, and which
#: argument holds what a rank hands it
COLLECTIVES = {
    "allreduce_": ("all-reduce", 0), "broadcast_": ("broadcast", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}

#: ops that move no bytes: metadata queries and bare allocations
_NO_TRAFFIC = frozenset({
    "lift_fresh", "lift_fresh_copy", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
    "is_strides_like_format", "is_non_overlapping_and_dense", "size",
    "stride", "numel", "dim", "storage_offset", "recv_"})

#: the largest integer tensor the recorder keeps a real copy of
_SHADOW_NUMEL = 1 << 16


@dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op: its name, the (shape, dtype, device type)
    of every tensor it took and returned, its matrix-product FLOPs, its
    bytes to the traffic proxy, what it hands a collective and the
    global ranks of that collective's group."""

    op: str
    inputs: tuple
    outputs: tuple
    flops: float = 0.0
    traffic: int = 0
    sent: int = 0
    group: Optional[tuple] = None


def _metas(tensors) -> tuple:
    return tuple((tuple(x.shape), x.dtype, x.device.type) for x in tensors)


def _meta(tree) -> tuple:
    return _metas(x for x in tree_flatten(tree)[0]
                  if isinstance(x, torch.Tensor))


def _nbytes(meta) -> int:
    shape, dtype, _ = meta
    return math.prod(shape) * dtype.itemsize


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


@dataclass
class CallCost:
    """The roofline terms of one call (see the module docstring).
    ``collective_groups`` maps each collective group (its global ranks)
    to the bytes handed it; ``peak_bytes`` is the most bytes the call
    held at once beyond what existed before it (where the recorder
    tracked memory, else None)."""

    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_groups: dict = field(default_factory=dict)
    top_dots: list = field(default_factory=list)         # (flops, op, shapes)
    top_collectives: list = field(default_factory=list)  # (bytes, op, shape)
    top_traffic: list = field(default_factory=list)      # (bytes, op, shape)
    n_ops: int = 0
    peak_bytes: Optional[int] = None

    @property
    def collective_total(self) -> float:
        return float(sum(self.collective_bytes.values()))


class _Tally:
    """A running :class:`CallCost` over records, the top lists bounded."""

    def __init__(self, top: int = 12):
        self.cost, self.top = CallCost(), top
        self._heaps = ([], [], [])
        self._n = 0

    def add(self, r: OpRecord) -> None:
        c = self.cost
        c.n_ops += 1
        c.traffic_bytes += r.traffic
        if r.sent:
            kind = COLLECTIVES[r.op][0]
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) \
                + r.sent
            if r.group is not None:
                c.collective_groups[r.group] = \
                    c.collective_groups.get(r.group, 0.0) + r.sent
        shapes = None
        for heap, key, name in zip(
                self._heaps, (r.flops, r.sent, r.traffic),
                (r.op, COLLECTIVES.get(r.op, (r.op,))[0], r.op)):
            if not key or (len(heap) == self.top and key <= heap[0][0]):
                continue
            shapes = shapes or str([m[0] for m in r.inputs])
            self._n += 1
            item = (key, self._n, name, shapes)
            if len(heap) < self.top:
                heapq.heappush(heap, item)
            else:
                heapq.heapreplace(heap, item)

    def result(self, dot_flops: float) -> CallCost:
        c = self.cost
        c.dot_flops = float(dot_flops)
        c.top_dots, c.top_collectives, c.top_traffic = (
            [(k, name, sh) for k, _, name, sh in sorted(h, reverse=True)]
            for h in self._heaps)
        return c


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active, in ``ops``
    (unless ``keep`` is off) and in a running tally (:meth:`cost`). With
    ``answer_reads`` it keeps real copies of the small integer fake
    tensors the call makes from host values and answers host reads of
    them (see the module docstring). With ``track_memory`` it follows
    the storages the call allocates, freed when their last tensor goes,
    and keeps the most bytes live at once (``peak_bytes``): storages
    that existed before the call (parameters, optimizer state) are not
    counted."""

    def __init__(self, *, answer_reads: bool = False,
                 track_memory: bool = False, keep: bool = True):
        super().__init__()
        self.ops: list[OpRecord] = []
        self.keep = keep
        self._tally = _Tally()
        self._real = WeakIdKeyDictionary() if answer_reads else None
        self._mem = ({"live": 0, "peak": 0}, WeakIdKeyDictionary(),
                     WeakIdKeyDictionary()) if track_memory else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":             # device, layout queries
            return func(*args, **kwargs)
        name, moves = _op_facts(func)
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        if self._real is not None and name == "_local_scalar_dense" \
                and args[0] in self._real:
            with _disable_current_modes():
                out = self._real[args[0]].item()
        else:
            if self._mem is not None:
                self._known(ins)
            out = func(*args, **kwargs)
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        if self._real is not None and name != "_local_scalar_dense":
            self._shadow(func, args, kwargs, ins, outs)
        if self._mem is not None:
            self._allocated(outs)
        m_in, m_out = _metas(ins), _metas(outs)
        sent = _sent(name, args)
        traffic = sum(_nbytes(m) for m in m_in + m_out) if moves else 0
        r = OpRecord(name, m_in, m_out, _op_flops(func, args, kwargs, out),
                     traffic, sent, _group(func, args) if sent else None)
        self._tally.add(r)
        if self.keep:
            self.ops.append(r)
        return out

    def cost(self, dot_flops: float) -> CallCost:
        """The tally of every op recorded, with ``dot_flops``."""
        c = self._tally.result(dot_flops)
        if self._mem is not None:
            c.peak_bytes = self._mem[0]["peak"]
        return c

    # -- memory --------------------------------------------------------------
    def _known(self, tensors) -> None:
        """Storages an op reads that the call did not allocate: there
        before it."""
        count, live, before = self._mem
        for x in tensors:
            st = x.untyped_storage()
            if st not in live and st not in before:
                before[st] = True

    def _allocated(self, tensors) -> None:
        count, live, before = self._mem
        for x in tensors:
            st = x.untyped_storage()
            if st in live or st in before:
                continue
            n = st.nbytes()
            live[st] = n
            count["live"] += n
            count["peak"] = max(count["peak"], count["live"])
            weakref.finalize(st, _free, count, n)

    # -- host reads of fake tensors -----------------------------------------
    def _shadow(self, func, args, kwargs, ins, outs) -> None:
        """Compute ``func`` on real copies where every output is a small
        integer fake tensor and every tensor input is real or has one."""
        if not outs or not all(
                not x.dtype.is_floating_point and not x.dtype.is_complex
                and x.numel() <= _SHADOW_NUMEL and _is_fake(x)
                for x in outs):
            return
        if any(_is_fake(x) and x not in self._real for x in ins):
            return

        def real(x):
            if isinstance(x, torch.Tensor) and _is_fake(x):
                return self._real[x]
            if isinstance(x, torch.device):
                return torch.device("cpu")
            return x

        with _disable_current_modes():
            got = func(*tree_map(real, args), **tree_map(real, kwargs))
        for fake, r in zip(outs, [x for x in tree_flatten(got)[0]
                                  if isinstance(x, torch.Tensor)]):
            self._real[fake] = r


def _free(count: dict, n: int) -> None:
    count["live"] -= n


def _group(func, args) -> Optional[tuple]:
    """The global ranks of a collective's process group."""
    import torch.distributed as dist
    for arg, a in zip(func._schema.arguments, args):
        if arg.name == "process_group":
            try:
                return tuple(dist.get_process_group_ranks(
                    dist.ProcessGroup.unbox(a)))
            except (RuntimeError, ValueError, AttributeError):
                return None
    return None


def _op_flops(func, args, kwargs, out) -> float:
    formula = flop_registry.get(func.overloadpacket)
    if formula is None:
        return 0.0
    return float(formula(*args, **kwargs, out_val=out))


_FACTS: dict = {}


def _op_facts(func) -> tuple[str, bool]:
    """(name, whether the op moves bytes): not a view or alias, not a
    metadata query or a bare allocation."""
    facts = _FACTS.get(func)
    if facts is None:
        name = func.overloadpacket.__name__
        moves = not (name in _NO_TRAFFIC or func.is_view or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns))
        facts = _FACTS[func] = (name, moves)
    return facts


def _sent(name: str, args) -> int:
    if name not in COLLECTIVES:
        return 0
    arg = args[COLLECTIVES[name][1]]
    return sum(_nbytes(m) for m in _meta(arg))


def record(fn, *args, answer_reads: bool = False, **kwargs
           ) -> tuple[list[OpRecord], float, Any]:
    """``(ops, dot_flops, result)`` of one call ``fn(*args, **kwargs)``
    under the recorder and ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as flops, \
            Recorder(answer_reads=answer_reads) as rec:
        result = fn(*args, **kwargs)
    return rec.ops, float(flops.get_total_flops()), result


def call_cost(ops: list[OpRecord], dot_flops: float) -> CallCost:
    """The :class:`CallCost` of a record."""
    tally = _Tally()
    for r in ops:
        tally.add(r)
    return tally.result(dot_flops)


def analyze_call(fn, *args, answer_reads: bool = False,
                 track_memory: bool = False, **kwargs) -> CallCost:
    """Run ``fn(*args, **kwargs)`` once and return its :class:`CallCost`
    (the records themselves are tallied as they come, not kept).
    Gradients are whatever the caller's mode says (a training step runs
    its own backward)."""
    with FlopCounterMode(display=False) as flops, \
            Recorder(answer_reads=answer_reads, track_memory=track_memory,
                     keep=False) as rec:
        fn(*args, **kwargs)
    return rec.cost(float(flops.get_total_flops()))


def fake_mode():
    """A ``FakeTensorMode`` for an abstract call: tensors made inside it
    have shapes, dtypes and devices and no storage; a CPU fake sends
    every ``kernels.ops`` call down its plain version, so nothing
    launches and nothing is computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()
