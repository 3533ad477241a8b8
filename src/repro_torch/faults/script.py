"""Deterministic fault scripts: what breaks, when, and by how much.

The paper evaluates AMTHA on healthy multicores; its own future work
(clusters of multicores, §7) implies machines where cores die, cores
slow down (stragglers) and links degrade mid-run. A
:class:`FaultScript` is the *ground truth* of one such degraded run —
an ordered tuple of timed events:

* ``core_fail(t, core)`` — core ``core`` executes nothing at or after
  ``t``; a subtask still running at ``t`` is killed (its result is
  lost and must be re-run somewhere else). The completion rule every
  simulator shares: **a subtask on a failed core completes iff its
  finish instant is <= the fail instant.**
* ``core_slow(t, core, factor)`` — from ``t`` on, subtasks *starting*
  on ``core`` take ``factor``× their nominal time. Factors of multiple
  events compose multiplicatively in script order; the factor is
  sampled once at the subtask's start and applies to its whole
  duration (a deterministic, start-instant semantics both the event
  loop and the batched relaxation can replay identically).
* ``link_degrade(t, a, b, factor)`` — from ``t`` on, transfers between
  cores ``a`` and ``b`` (either direction) pay ``factor``× the latency
  and ``1/factor``× the bandwidth. The factor is sampled at the
  transfer's start (= the producer's finish instant).

Scripts are plain data with no dependency on the scheduler layers;
``core/lowering.py`` lowers them into the scenario array IR
(:func:`repro_torch.core.lowering.lower_faults`) so the seed event simulator,
the lowered event loop and the batched relaxation all replay the same
script bit-identically. ``random_script`` draws a script as a pure
function of ``seed`` — the injection side of the determinism contract
(same script + same seed => same degraded run everywhere).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

CORE_FAIL = "core_fail"
CORE_SLOW = "core_slow"
LINK_DEGRADE = "link_degrade"
KINDS = (CORE_FAIL, CORE_SLOW, LINK_DEGRADE)


@dataclass(frozen=True)
class FaultEvent:
    """One timed fault. ``core_b``/``factor`` are meaningful only for
    the kinds that use them (see the module docstring)."""

    kind: str
    t: float
    core: int = -1
    core_b: int = -1
    factor: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(have {KINDS})")
        if self.t < 0.0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.kind in (CORE_SLOW, LINK_DEGRADE) and self.factor <= 0.0:
            raise ValueError(f"{self.kind} factor must be > 0")


def core_fail(t: float, core: int) -> FaultEvent:
    return FaultEvent(CORE_FAIL, float(t), core=core)


def core_slow(t: float, core: int, factor: float) -> FaultEvent:
    return FaultEvent(CORE_SLOW, float(t), core=core, factor=float(factor))


def link_degrade(t: float, a: int, b: int, factor: float) -> FaultEvent:
    if a == b:
        raise ValueError("link_degrade needs two distinct cores")
    return FaultEvent(LINK_DEGRADE, float(t), core=a, core_b=b,
                      factor=float(factor))


@dataclass(frozen=True)
class FaultScript:
    """An immutable, replayable sequence of fault events.

    Event *order in the tuple* is part of the script's identity: slow /
    degrade factors compose multiplicatively in that order, so two
    scripts with the same events in different orders are the same
    mathematical degradation but may differ in the last float ulp —
    determinism is defined per script, not per event set.
    """

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))

    def __bool__(self) -> bool:
        return bool(self.events)

    def validate(self, n_cores: int) -> "FaultScript":
        """Check every core index against the machine; returns self."""
        for e in self.events:
            cores = (e.core,) if e.kind != LINK_DEGRADE else (e.core, e.core_b)
            for c in cores:
                if not 0 <= c < n_cores:
                    raise ValueError(
                        f"{e.kind} names core {c}, machine has {n_cores}")
        return self

    # ---- normalized views (what the simulators consume) ---------------
    def fail_times(self, n_cores: int) -> list[float]:
        """Per-core fail instant, ``inf`` = never; earliest event wins."""
        out = [float("inf")] * n_cores
        for e in self.events:
            if e.kind == CORE_FAIL and e.t < out[e.core]:
                out[e.core] = e.t
        return out

    def slow_events(self, n_cores: int) -> list[list[tuple[float, float]]]:
        """Per-core ``(t, factor)`` list in script order."""
        out: list[list[tuple[float, float]]] = [[] for _ in range(n_cores)]
        for e in self.events:
            if e.kind == CORE_SLOW:
                out[e.core].append((e.t, e.factor))
        return out

    def degrade_events(self) -> dict[tuple[int, int], list[tuple[float, float]]]:
        """Unordered core pair -> ``(t, factor)`` list in script order."""
        out: dict[tuple[int, int], list[tuple[float, float]]] = {}
        for e in self.events:
            if e.kind == LINK_DEGRADE:
                key = (min(e.core, e.core_b), max(e.core, e.core_b))
                out.setdefault(key, []).append((e.t, e.factor))
        return out

    def dead_cores(self, at: float) -> set[int]:
        """Cores already failed at instant ``at``."""
        return {e.core for e in self.events
                if e.kind == CORE_FAIL and e.t <= at}

    def slow_factor(self, core: int, at: float) -> float:
        """Cumulative slowdown in effect on ``core`` at instant ``at``."""
        f = 1.0
        for e in self.events:
            if e.kind == CORE_SLOW and e.core == core and e.t <= at:
                f *= e.factor
        return f

    def until(self, at: float) -> "FaultScript":
        """The prefix of events with ``t <= at`` (what a detector that
        has watched the run up to ``at`` can possibly know)."""
        return FaultScript(tuple(e for e in self.events if e.t <= at))


def random_script(n_cores: int, *, seed: int, horizon: float,
                  n_fail: int = 1, n_slow: int = 1, n_degrade: int = 1,
                  slow_factor: tuple[float, float] = (2.0, 6.0),
                  degrade_factor: tuple[float, float] = (2.0, 10.0),
                  t_window: tuple[float, float] = (0.1, 0.9),
                  protect: tuple[int, ...] = ()) -> FaultScript:
    """Draw a script as a pure function of ``seed``.

    Event times are uniform over ``t_window`` fractions of ``horizon``;
    failed cores are sampled without replacement and never include
    ``protect`` (at least one core always survives). Events are emitted
    sorted by time so the script reads like a run log.
    """
    rng = np.random.default_rng(seed)
    lo, hi = t_window
    events: list[FaultEvent] = []
    eligible = [c for c in range(n_cores) if c not in protect]
    n_fail = min(n_fail, max(len(eligible) - 1, 0))
    failed = rng.choice(eligible, size=n_fail, replace=False) if n_fail else []
    for c in failed:
        events.append(core_fail(float(rng.uniform(lo, hi)) * horizon, int(c)))
    alive = [c for c in range(n_cores) if c not in {int(x) for x in failed}]
    for _ in range(n_slow):
        if not alive:
            break
        events.append(core_slow(float(rng.uniform(lo, hi)) * horizon,
                                int(rng.choice(alive)),
                                float(rng.uniform(*slow_factor))))
    for _ in range(n_degrade):
        if n_cores < 2:
            break
        a, b = rng.choice(n_cores, size=2, replace=False)
        events.append(link_degrade(float(rng.uniform(lo, hi)) * horizon,
                                   int(a), int(b),
                                   float(rng.uniform(*degrade_factor))))
    events.sort(key=lambda e: (e.t, KINDS.index(e.kind), e.core, e.core_b))
    return FaultScript(tuple(events))
