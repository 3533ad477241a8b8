"""Unified entry points: the Scheduler protocol and the name registries.

Every mapping algorithm in the repo shares one call shape — take an
MPAHA graph and a machine, return a Schedule-like timeline — and every
T_exec source shares another. The registries make that explicit so
benchmarks, examples and services select implementations by *name*
(``--scheduler engine``) instead of importing concrete functions:

* ``SCHEDULERS`` — ``amtha`` (seed reference), ``engine`` (array-backed
  ``ArrayAMTHA``, placement-identical and the default fast path),
  ``heft`` / ``etf`` (baselines, not task-coherent), ``ga`` (the
  mapping search of :mod:`repro_torch.search`, engine-seeded);
* ``SIMULATORS`` — ``events`` (seed pure-Python event loop), ``arrays``
  (the lowered event loop of ``core/sim_engine.py``, bit-for-bit equal
  and faster). The whole-suite batched path has a different shape (many
  scenarios, one call) and is exported separately as
  :func:`~repro_torch.core.sim_engine.simulate_suite`.

``register_scheduler`` / ``register_simulator`` are open: downstream
code can add a mapper under its own name and every name-aware caller
picks it up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

from .amtha import amtha_schedule
from .engine import engine_schedule
from .heft import etf_schedule, heft_schedule
from .sim_engine import simulate_scenario
from .simulator import simulate


@runtime_checkable
class Scheduler(Protocol):
    """Anything that maps an MPAHA graph onto a machine.

    Must accept ``(graph, machine)`` positionally and return a
    Schedule-like object (``makespan``, ``placements``, ``core_of``,
    ``order_on_core``). Schedulers that support incremental admission
    additionally take the ``warm_start`` / ``release_time`` /
    ``sid_offset`` keywords — ``amtha`` and ``engine`` do, the
    HEFT/ETF baselines are offline-only."""

    def __call__(self, graph, machine, **kwargs): ...


@dataclass(frozen=True)
class SchedulerEntry:
    name: str
    fn: Callable
    task_coherent: bool             # AMTHA places whole tasks; HEFT/ETF don't
    doc: str = ""


@dataclass(frozen=True)
class SimulatorEntry:
    name: str
    fn: Callable
    doc: str = ""


SCHEDULERS: dict[str, SchedulerEntry] = {}
SIMULATORS: dict[str, SimulatorEntry] = {}


def register_scheduler(name: str, fn: Callable, *, task_coherent: bool = True,
                       doc: str = "", overwrite: bool = False) -> None:
    if name in SCHEDULERS and not overwrite:
        raise ValueError(f"scheduler {name!r} already registered")
    SCHEDULERS[name] = SchedulerEntry(name, fn, task_coherent, doc)


def register_simulator(name: str, fn: Callable, *, doc: str = "",
                       overwrite: bool = False) -> None:
    if name in SIMULATORS and not overwrite:
        raise ValueError(f"simulator {name!r} already registered")
    SIMULATORS[name] = SimulatorEntry(name, fn, doc)


def scheduler_entry(name: str) -> SchedulerEntry:
    try:
        return SCHEDULERS[name]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r} "
                         f"(have {sorted(SCHEDULERS)})") from None


def get_scheduler(name: str, *, verify: bool = False) -> Callable:
    """The mapping callable registered under ``name``. With
    ``verify=True`` the callable is wrapped so every schedule it emits
    is proof-checked by :mod:`repro_torch.analysis.verify` (overlap,
    precedence + comm cost, release floors, namespace, coherence per
    the entry's ``task_coherent``) before being returned."""
    entry = scheduler_entry(name)
    if not verify:
        return entry.fn
    from ..analysis.verify import verified_scheduler
    return verified_scheduler(entry)


def get_simulator(name: str, *, verify: bool = False) -> Callable:
    """The T_exec source registered under ``name`` — signature of the
    seed ``simulate(graph, machine, schedule, contention=..., ...)``.
    With ``verify=True`` every :class:`SimResult` it emits is checked
    (coverage, finite ends, stranding only under faults, makespan)."""
    try:
        entry = SIMULATORS[name]
    except KeyError:
        raise ValueError(f"unknown simulator {name!r} "
                         f"(have {sorted(SIMULATORS)})") from None
    if not verify:
        return entry.fn
    from ..analysis.verify import verified_simulator
    return verified_simulator(entry)


register_scheduler("amtha", amtha_schedule,
                   doc="seed reference AMTHA (Fig. 3)")
register_scheduler("engine", engine_schedule,
                   doc="array-backed ArrayAMTHA, placement-identical")
register_scheduler("heft", heft_schedule, task_coherent=False,
                   doc="HEFT baseline (subtask-level)")
register_scheduler("etf", etf_schedule, task_coherent=False,
                   doc="ETF baseline (subtask-level)")


def _ga_schedule(graph, machine, **kwargs):
    """Lazy bridge to :func:`repro_torch.search.ga.ga_schedule` — the
    search package sits above core (it consumes the registry, the IR and
    the batched simulator), so the import happens at call time to keep
    the layering acyclic while still listing ``ga`` at import time."""
    from ..search.ga import ga_schedule
    return ga_schedule(graph, machine, **kwargs)


register_scheduler("ga", _ga_schedule,
                   doc="bias-elitist GA + hill climber, batched-sim "
                       "fitness, engine-seeded (never worse)")

register_simulator("events", simulate,
                   doc="seed pure-Python discrete-event loop")
register_simulator("arrays", simulate_scenario,
                   doc="lowered event loop (bit-for-bit, faster)")
