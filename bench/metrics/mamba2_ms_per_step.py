"""``mamba2_ms_per_step`` (ms): device time a profiled step of the
operations launched inside the port's ``model.mamba2`` span
(``models/blocks.mamba_forward``: the norm and in-projections, the
convolutions, ``ssd_scan``, the gated norm and the out-projection), in
the forward, the remat recomputation and the backward, by
:mod:`harness.spans`."""

from harness import spans

SPAN = "model.mamba2"


def read(run):
    return spans.ms_per_step(spans.device_s_in_span(run.trace, SPAN),
                             run.trace)
