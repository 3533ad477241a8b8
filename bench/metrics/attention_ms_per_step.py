"""``attention_ms_per_step`` (ms): device time a profiled step of the
operations launched inside the port's ``model.attention`` span
(``models/blocks.attn_forward``: the projections, RoPE, the attention
kernel and the out-projection; MLA, and the shared block's attention
with its LoRA), in the forward, the remat recomputation and the
backward, by :mod:`harness.spans`."""

from harness import spans

SPAN = "model.attention"


def read(run):
    return spans.ms_per_step(spans.device_s_in_span(run.trace, SPAN),
                             run.trace)
