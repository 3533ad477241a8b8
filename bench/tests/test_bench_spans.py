"""The program's spans read from a profiled window (``harness/spans.py``):
attribution by hand on a made-up profile (a nested span, a backward node
linked to its forward by sequence number, a recomputed span inside a
node, idle gaps beginning inside spans), a real CPU profile of each tiny
cell, the span readers on the CPU and on a program without spans, and
the harness's own ``Trace`` left as it was."""

import contextlib
import io
import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import tiny
from harness import main, registry, spans
from harness import trace as tr

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

SPAN_METRICS = {"adamw_ms_per_step": "optim.adamw",
                "moe_ms_per_step": "model.moe",
                "mamba2_ms_per_step": "model.mamba2",
                "attention_ms_per_step": "model.attention",
                "mamba2_idle_ms_per_step": "model.mamba2"}


class FakeEvent:
    """The methods of a kineto event that ``spans.events_of`` reads."""

    def __init__(self, name, start, end, thread=1, corr=0, seq=-1, fwd=0,
                 span=False, device=CPU, process=118):
        self._v = dict(name=name, start_ns=int(start * 1e9),
                       end_ns=int(end * 1e9), start_thread_id=thread,
                       correlation_id=corr, sequence_nr=seq,
                       fwd_thread_id=fwd, is_user_annotation=span,
                       device_type=device, device_index=process)

    def __getattr__(self, key):
        return lambda: self._v[key]


def span_event(name, start, end, thread=1, corr=0, **kw):
    return FakeEvent(name, start, end, thread, corr, span=True, **kw)


def made_up_trace():
    """Thread 1 runs the forward and thread 2 the backward, as the
    autograd engine does on a card."""
    host = [
        span_event("bench.window", 0, 50),
        span_event("outer", 0, 10),
        span_event("inner", 1, 4),
        FakeEvent("aten::mm", 2, 3, corr=11, seq=5),
        FakeEvent("aten::add", 5, 6, corr=12, seq=6),
        FakeEvent("aten::sum", 11, 12, corr=13, seq=7),
        FakeEvent("MmBackward0", 20, 30, thread=2, seq=5, fwd=1),
        FakeEvent("aten::mm", 21, 22, thread=2, corr=21),
        FakeEvent("AddBackward0", 31, 40, thread=2, seq=6, fwd=1),
        span_event("inner", 32, 36, thread=2),          # recomputation
        FakeEvent("aten::mm", 33, 34, thread=2, corr=22, seq=90),
        FakeEvent("aten::mul", 37, 38, thread=2, corr=23),
        FakeEvent("SumBackward0", 41, 42, thread=2, seq=7, fwd=1),
        FakeEvent("aten::fill_", 41.2, 41.3, thread=2, corr=24),
        # the runtime's launch and the profiler's overhead: ids of their
        # own, one the same as the forward mm's
        FakeEvent("cudaLaunchKernel", 2.1, 2.2, corr=11),
        FakeEvent("Command Buffer Full", 2.15, 2.18, corr=11, process=-1),
        span_event("inner", 2.5, 3.5, corr=11, device=CUDA, process=0),
    ]
    device = [tr.Op("k", 2.5, 3.5, corr=11), tr.Op("k", 5.5, 6, corr=12),
              tr.Op("k", 21, 23, corr=21), tr.Op("k", 33, 35, corr=22),
              tr.Op("k", 37, 39, corr=23), tr.Op("k", 41, 41.5, corr=24),
              tr.Op("k", 49, 52, corr=13)]
    t = tr.Trace(window=(0.0, 50.0), device=device, steps=2)
    t.span_source = SimpleNamespace(events=lambda: host)
    return t


def test_made_up_profile_by_hand():
    t = made_up_trace()
    idx = spans.index(t)
    assert {e.name for e in idx.events} >= {"outer", "inner", "aten::mm"}
    assert "bench.window" not in {e.name for e in idx.events}
    assert {e.name for e in idx.events}.isdisjoint(
        {"cudaLaunchKernel", "Command Buffer Full"})
    assert sum(e.name == "inner" for e in idx.events) == 2
    # the forward's mm in the nested span; the backward's mm by its node;
    # the recomputed mm in the span opened inside the node; the mul of
    # that node outside the recomputation by the node's forward, the add
    assert t.span_device_s == pytest.approx(
        {"inner": 1 + 2 + 2, "outer": 0.5 + 2, None: 0.5 + 1})
    assert spans.device_s_in_span(t, "inner") == pytest.approx(5)
    assert spans.device_s_in_span(t, "nowhere") == 0
    # gaps [0, 2.5) [3.5, 5.5) [6, 21) [23, 33) [35, 37) [39, 41)
    # [41.5, 49): the host in outer, inner, outer, MmBackward0 (inner),
    # the recomputed inner, AddBackward0 (outer), SumBackward0 (none)
    assert spans.idle_s_in_span(t, "outer") == pytest.approx(2.5 + 15 + 2)
    assert spans.idle_s_in_span(t, "inner") == pytest.approx(2 + 10 + 2)
    assert t.span_idle_s[None] == pytest.approx(7.5)
    assert sum(t.span_idle_s.values()) == pytest.approx(
        t.window_s - t.busy_s())
    assert spans.ms_per_step(spans.device_s_in_span(t, "inner"), t) == \
        pytest.approx(2500)


def test_innermost_event_at_a_time():
    idx = spans.index(made_up_trace())
    name = {t: idx.events[idx.at(t)].name for t in (0.5, 2.5, 3.5, 21.5,
                                                    33.5, 35.5, 60)
            if idx.at(t) >= 0}
    assert name == {0.5: "outer", 2.5: "aten::mm", 3.5: "inner",
                    21.5: "aten::mm", 33.5: "aten::mm", 35.5: "inner"}


def test_a_program_without_spans_reads_nothing():
    t = made_up_trace()
    events = [e for e in t.span_source.events()
              if not e.is_user_annotation() or e.name() == "bench.window"]
    t.span_source = SimpleNamespace(events=lambda: events)
    run = SimpleNamespace(trace=t)
    assert spans.index(t) is not None and set(t.span_device_s) == {None}
    for metric in SPAN_METRICS:
        assert registry.module("metrics", metric).read(run) is None
    # a trace the harness made without the host events, and none at all
    for t in (tr.Trace(window=(0.0, 1.0), device=[tr.Op("k", 0, 1, 1)]),
              None):
        for metric in SPAN_METRICS:
            assert registry.module("metrics", metric).read(
                SimpleNamespace(trace=t)) is None


def test_the_harness_trace_is_left_as_it_was():
    """The wrapped ``extract`` returns the harness's own ``Trace`` for the
    same window, field for field, and the harness's readers and breakdown
    read the same from it."""
    assert tr.extract.keeps_host_events
    x = torch.randn(16, 16, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            for _ in range(2):
                with record_function("model.moe"):
                    y = (x @ x).sin()
                y.sum().backward()
    plain, kept = tr.extract.__wrapped__(prof, 2), tr.extract(prof, 2)
    assert plain == kept and plain.host == kept.host
    assert plain.device == kept.device and plain.window == kept.window
    assert kept.idle_by_host() == plain.idle_by_host()
    assert kept.top_device_ops() == plain.top_device_ops()
    assert spans.index(plain) is None and spans.index(kept) is not None
    bench = registry.benchmark(registry.BENCH.parent)
    for workload in tiny.CELLS:
        job = tiny.job(workload)
        family = registry.module("reference", job.config["family"])
        for m in registry.metrics_for(bench, workload, "per_layer"):
            if m["name"] in SPAN_METRICS:
                continue
            reader = registry.module("metrics", m["name"])
            reads = [reader.read(SimpleNamespace(
                trace=t, shapes_trace=t, config=job.config,
                traffic=job.traffic, family=family, peaks=None,
                host_s=[0.5], tokens_per_s=1.0, peak_flops=lambda: None))
                for t in (plain, kept)]
            assert reads[0] == reads[1], m["name"]


@pytest.fixture(scope="module", params=tiny.CELLS)
def cell_run(request):
    job = tiny.job(request.param, trace=True)
    runner = registry.module("runners", "train")
    with contextlib.redirect_stderr(io.StringIO()):
        result = runner.run(job)
    return request.param, job, result["reading"]


def test_backward_ops_land_in_the_forward_span(cell_run):
    """A real CPU profile of the tiny cell: every span of the port there,
    twice a layer under remat (the recomputation inside a backward node);
    each backward node of an einsum inside a layer's span takes the
    span, and so do the operations it runs."""
    workload, job, reading = cell_run
    idx = spans.index(reading.trace)
    ev, label, parent = idx.events, idx.label, idx.parent
    names = {e.name for e in ev if e.span}
    layer = {"model.moe", "model.attention"} if workload == tiny.MOE \
        else {"model.mamba2", "model.attention"}
    assert names == layer | {"optim.adamw"}

    def in_node(i):
        while i >= 0 and not (ev[i].seq >= 0 and ev[i].fwd_thread > 0):
            i = parent[i]
        return i >= 0
    for name in layer:
        opened = [i for i, e in enumerate(ev) if e.span and e.name == name]
        recomputed = [i for i in opened if in_node(i)]
        assert len(recomputed) * 2 == len(opened) > 0, name
    nodes = [i for i, e in enumerate(ev)
             if e.name in ("MmBackward0", "BmmBackward0")]
    assert {label[i] for i in nodes} >= layer
    for i in nodes:
        end = next((j for j in range(i + 1, len(ev))
                    if ev[j].start >= ev[i].end), len(ev))
        kids = [j for j in range(i + 1, end)
                if parent[j] == i and not ev[j].span]
        assert kids and all(label[j] == label[i] for j in kids)


def test_span_readers_read_nothing_on_the_cpu(cell_run):
    """No device operations on the CPU: each span reader gives None and
    raises nothing."""
    _, _, reading = cell_run
    for metric in SPAN_METRICS:
        assert registry.module("metrics", metric).read(reading) is None


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_result_line_leaves_the_span_metrics_out_on_the_cpu(workload):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main.report(main.execute(tiny.job(workload, trace=True))) \
            == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert not set(line["metrics"]) & set(SPAN_METRICS)
    listed = {m["name"] for m in registry.metrics_for(
        registry.benchmark(registry.BENCH.parent), workload, "per_layer")}
    want = {"adamw_ms_per_step", "attention_ms_per_step"} | (
        {"moe_ms_per_step"} if workload == tiny.MOE else
        {"mamba2_ms_per_step", "mamba2_idle_ms_per_step"})
    assert listed & set(SPAN_METRICS) == want
