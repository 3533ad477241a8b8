"""``adamw_ms_per_step`` (ms): device time a profiled step of the
operations launched inside the port's ``optim.adamw`` span
(``optim/adamw.apply_updates``: the float32 casts, the norm and the
clip, the moments, the update and the copy back), by
:mod:`harness.spans`."""

from harness import spans

SPAN = "optim.adamw"


def read(run):
    return spans.ms_per_step(spans.device_s_in_span(run.trace, SPAN),
                             run.trace)
