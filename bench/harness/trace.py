"""Reduction of one profiler window to what the per-layer metrics read.

:func:`extract` turns ``torch.profiler``'s raw events into
:class:`Trace`: the device's operations (kernels, copies, sets), the
host's operations with their input shapes, and the traced window (the
``bench.window`` span the runner puts around the profiled steps, which
ends after a device synchronise). Everything after that is plain
arithmetic on intervals, so it is tested without a device.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

WINDOW = "bench.window"
RUNTIME_PREFIXES = ("cuda", "cu", "nccl")      # the driver and runtime API


@dataclass(frozen=True)
class Op:
    name: str
    start: float            # seconds from the trace's start
    end: float
    corr: int = 0           # host op: its id; device op: its launcher's id
    shapes: tuple = ()


@dataclass
class Trace:
    window: tuple[float, float]
    device: list[Op] = field(default_factory=list)
    host: list[Op] = field(default_factory=list)
    steps: int = 1

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _clipped(self, ops):
        lo, hi = self.window
        return sorted((max(o.start, lo), min(o.end, hi)) for o in ops
                      if o.end > lo and o.start < hi)

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(b - a for a, b in _union(self._clipped(self.device)))

    def gaps(self) -> list[tuple[float, float]]:
        """The window's idle intervals, in order."""
        out, t = [], self.window[0]
        for a, b in _union(self._clipped(self.device)):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def device_s(self, match) -> float:
        """Seconds of the device operations whose name ``match`` accepts."""
        return sum(min(o.end, self.window[1]) - max(o.start, self.window[0])
                   for o in self.device if match(o.name)
                   and o.end > self.window[0] and o.start < self.window[1])

    def device_s_under(self, match_host) -> float:
        """Seconds of the device operations launched by a host operation
        that ``match_host`` accepts (the launcher named by correlation)."""
        hosts = {o.corr: o for o in self.host if o.corr}
        return sum(o.end - o.start for o in self.device
                   if o.corr in hosts and match_host(hosts[o.corr]))

    def top_device_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operation names with the most seconds in the
        window."""
        lo, hi = self.window
        by = {}
        for o in self.device:
            if o.end > lo and o.start < hi:
                by[o.name] = by.get(o.name, 0.0) + min(o.end, hi) \
                    - max(o.start, lo)
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list[list]:
        """Idle seconds summed by what the host was running when each gap
        began (its innermost operation, the runtime API's calls only
        where nothing else was), the ``n`` largest."""
        hosts = sorted(self.host, key=lambda o: o.start)
        starts = [o.start for o in hosts]
        by = {}
        for a, b in self.gaps():
            name = _innermost(hosts, starts, a) or "(no host operation)"
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals):
    """Sorted (start, end) intervals merged where they overlap."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(hosts, starts, t, depth: int = 4096):
    """The name of the innermost host operation running at ``t``: of
    those that cover it, the latest started, preferring one outside the
    runtime API."""
    i = bisect.bisect_right(starts, t)
    best = {}
    for o in reversed(hosts[max(0, i - depth):i]):
        if o.end > t:
            runtime = o.name.startswith(RUNTIME_PREFIXES)
            if runtime not in best:
                best[runtime] = o.name
            if False in best:
                return best[False]
    return best.get(False) or best.get(True)


def extract(prof, steps: int) -> Trace:
    """:class:`Trace` of a finished ``torch.profiler.profile`` whose
    profiled steps ran inside one ``record_function(WINDOW)``."""
    events = prof.profiler.kineto_results.events()
    t0 = min(e.start_ns() for e in events)
    device, host, window = [], [], None
    for e in events:
        start, end = (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9
        name = e.name()
        on_host = "CPU" in str(e.device_type())
        if on_host and name == WINDOW:
            window = (start, end)
        elif e.is_user_annotation() or name == WINDOW:   # spans, on both sides
            continue
        elif not on_host:
            device.append(Op(name, start, end, corr=e.linked_correlation_id()))
        else:
            host.append(Op(name, start, end, e.correlation_id(),
                           tuple(tuple(s) for s in e.shapes())))
    if window is None:
        raise RuntimeError(f"the profile has no {WINDOW!r} span")
    return Trace(window, device, host, steps)
