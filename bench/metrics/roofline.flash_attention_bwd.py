"""``roofline.flash_attention_bwd`` (%): the least time the card could
take for a profiled step's attention backward (``roofline/
flash_attention_bwd.py``: the work, not the kernel's way of doing it)
over the device time of the kernels ``flash_attention_bwd`` launches,
picked by name."""

import re

KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel", "bwd_tc_kernel",
           "sum_partials")
PATTERN = re.compile(r"(?:^|[\s:])(?:%s)(?:<|\(|$)" % "|".join(KERNELS))


def read(run):
    from harness import registry
    t = run.trace
    calls = run.family.attention_calls(run.config, run.traffic)
    if t is None or not calls or run.peaks is None:
        return None
    measured = t.device_s(PATTERN.search)
    if measured <= 0:
        return None
    work = registry.module("roofline", "flash_attention_bwd")
    bound = sum(work.seconds(c, run.config["dtype"], run.peaks)
                for c in calls)
    return 100.0 * bound * t.steps / measured
