"""``moe_ms_per_step`` (ms): device time a profiled step of the
operations launched inside the port's ``model.moe`` span
(``models/moe.moe_ffn``: the router, the dispatch, the expert products
and the combine, not the shared experts), in the forward, the remat
recomputation and the backward, by :mod:`harness.spans`."""

from harness import spans

SPAN = "model.moe"


def read(run):
    return spans.ms_per_step(spans.device_s_in_span(run.trace, SPAN),
                             run.trace)
