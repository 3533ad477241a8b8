"""The program's spans in a profiled window: device and idle seconds by
the span the host was in.

The port marks its layers with ``torch.profiler.record_function`` spans
(``repro_torch.spans``). :func:`harness.trace.extract` leaves spans out of
:class:`~harness.trace.Trace`; importing this module wraps it so that the
``Trace`` it returns, unchanged, also keeps the profile's host events
(``span_source``), which :class:`SpanIndex` reads on the first question:

* :func:`device_s_in_span`: seconds of the device operations whose
  launching host operation lies in a span;
* :func:`idle_s_in_span`: seconds of the window's idle gaps that begin
  while the host is in a span.

A host operation lies in the innermost span that holds it on its own
thread. An autograd node (a ``...Backward`` function, ``sequence_nr`` >=
0, with the thread of its forward) stands for the forward operation of
the same (thread, ``sequence_nr``), and its operations take that
operation's span; a span opened inside the node (a remat region's
recomputation, which runs in the backward) is the innermost and wins.
A program without spans reads nothing: both functions give 0.
"""

from __future__ import annotations

import bisect
import functools
from typing import NamedTuple

import torch

from harness import trace as tr

CPU = torch.autograd.DeviceType.CPU


class Event(NamedTuple):
    """A host event of the profile: an operation or a span."""
    name: str
    start: float            # seconds, on the clock of ``Trace``
    end: float
    thread: int
    corr: int = 0
    seq: int = -1           # autograd sequence number
    fwd_thread: int = 0     # an autograd node: its forward's thread
    span: bool = False


class SpanIndex:
    """The span each host event lies in (:attr:`label`, None outside
    every span), and the innermost event at a time; O(n log n)."""

    def __init__(self, events: list[Event]):
        ev = sorted(events, key=lambda e: (e.start, -e.end))
        self.events = ev
        parent = [-1] * len(ev)
        by_thread: dict[int, list[int]] = {}
        stacks: dict[int, list[int]] = {}
        for i, e in enumerate(ev):
            stack = stacks.setdefault(e.thread, [])
            while stack and ev[stack[-1]].end <= e.start:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
            by_thread.setdefault(e.thread, []).append(i)
        self.parent = parent
        self.threads = {t: (idx, [ev[i].start for i in idx])
                        for t, idx in by_thread.items()}
        label: list[str | None] = [None] * len(ev)
        forward: dict[tuple[int, int], int] = {}
        for i, e in enumerate(ev):
            up = label[parent[i]] if parent[i] >= 0 else None
            if e.span:
                label[i] = e.name
            elif e.seq >= 0 and e.fwd_thread > 0:     # autograd node
                f = forward.get((e.fwd_thread, e.seq))
                label[i] = label[f] if f is not None else up
            else:
                label[i] = up
                if e.seq >= 0:       # the last op to take a number made it
                    forward[(e.thread, e.seq)] = i
        self.label = label
        self.by_corr = {e.corr: i for i, e in enumerate(ev) if e.corr}

    def at(self, t: float) -> int:
        """The index of the innermost event running at ``t`` on any
        thread (of those, the latest started), or -1."""
        best = -1
        for idx, starts in self.threads.values():
            k = bisect.bisect_right(starts, t) - 1
            j = idx[k] if k >= 0 else -1
            while j >= 0 and self.events[j].end <= t:
                j = self.parent[j]
            if j >= 0 and (best < 0 or
                           self.events[j].start > self.events[best].start):
                best = j
        return best

    def device_s(self, trace: tr.Trace) -> dict:
        """{span: seconds in the window of the device operations it
        launched}."""
        lo, hi = trace.window
        out: dict = {}
        for o in trace.device:
            i = self.by_corr.get(o.corr, -1)
            if i >= 0 and o.end > lo and o.start < hi:
                name = self.label[i]
                out[name] = out.get(name, 0.0) + min(o.end, hi) \
                    - max(o.start, lo)
        return out

    def idle_s(self, trace: tr.Trace) -> dict:
        """{span: seconds of the gaps that begin while the host is in
        it}."""
        out: dict = {}
        for a, b in trace.gaps():
            i = self.at(a)
            name = self.label[i] if i >= 0 else None
            out[name] = out.get(name, 0.0) + (b - a)
        return out


def events_of(results) -> list[Event]:
    """The program's host events of a profile's ``kineto_results``: its
    operations and spans, on the clock of :func:`harness.trace.extract`.
    Left out: the device's events, the runtime and driver API's calls
    (:data:`harness.trace.RUNTIME_PREFIXES`, whose correlation ids are
    another count), the profiler's own overhead (of no process) and the
    window's span."""
    events = results.events()
    t0 = min(e.start_ns() for e in events)
    out = []
    for e in events:
        if e.device_type() != CPU:
            continue
        name = e.name()
        if name.startswith(tr.RUNTIME_PREFIXES) or name == tr.WINDOW \
                or e.device_index() < 0:
            continue
        start, end = (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9
        if e.is_user_annotation():
            out.append(Event(name, start, end, e.start_thread_id(),
                             e.correlation_id(), -1, 0, True))
        else:
            out.append(Event(name, start, end, e.start_thread_id(),
                             e.correlation_id(), e.sequence_nr(),
                             e.fwd_thread_id(), False))
    return out


def index(trace) -> SpanIndex | None:
    """The trace's :class:`SpanIndex`, built on the first call; None
    where the trace kept no host events."""
    if trace is None:
        return None
    if getattr(trace, "span_index", None) is None:
        source = getattr(trace, "span_source", None)
        if source is None:
            return None
        trace.span_index = SpanIndex(events_of(source))
        trace.span_source = None
        trace.span_device_s = trace.span_index.device_s(trace)
        trace.span_idle_s = trace.span_index.idle_s(trace)
    return trace.span_index


def device_s_in_span(trace, name: str) -> float:
    """Seconds of the device operations launched from span ``name``."""
    return trace.span_device_s.get(name, 0.0) if index(trace) else 0.0


def idle_s_in_span(trace, name: str) -> float:
    """Idle seconds of the gaps that begin while the host is in span
    ``name``."""
    return trace.span_idle_s.get(name, 0.0) if index(trace) else 0.0


def ms_per_step(seconds: float, trace) -> float | None:
    """Milliseconds a profiled step; None for nothing read."""
    return 1e3 * seconds / trace.steps if seconds > 0 else None


def _keep_host_events(extract):
    @functools.wraps(extract)
    def wrapped(prof, steps: int) -> tr.Trace:
        t = extract(prof, steps)
        t.span_source = prof.profiler.kineto_results
        return t
    wrapped.keeps_host_events = True
    return wrapped


# a cell's readers are loaded before its runner profiles (harness.main)
if not getattr(tr.extract, "keeps_host_events", False):
    tr.extract = _keep_host_events(tr.extract)
