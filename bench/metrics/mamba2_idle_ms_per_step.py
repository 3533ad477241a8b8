"""``mamba2_idle_ms_per_step`` (ms): idle time a profiled step of the
device's gaps that begin while the host is in the port's
``model.mamba2`` span (its forward, its recomputation or the backward of
its operations), by :mod:`harness.spans`."""

from harness import spans

SPAN = "model.mamba2"


def read(run):
    return spans.ms_per_step(spans.idle_s_in_span(run.trace, SPAN),
                             run.trace)
