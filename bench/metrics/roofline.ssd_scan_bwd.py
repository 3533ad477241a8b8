"""``roofline.ssd_scan_bwd`` (%): the least time the card could take for
a profiled step's SSD scan backwards (``roofline/ssd_scan_bwd.py``: the
chunked SSD's own products and the bytes of its inputs and gradients)
over the device time of the backward pass kernels of ``ssd_scan.cu``,
picked by name."""

import re

KERNELS = ("bwd_states", "bwd_dual", "bwd_group", "bwd_finish")
PATTERN = re.compile(r"(?:^|[\s:])(?:%s)(?:<|\(|$)" % "|".join(KERNELS))


def read(run):
    from harness import registry
    t = run.trace
    calls = run.family.ssd_calls(run.config, run.traffic)
    if t is None or not calls or run.peaks is None:
        return None
    measured = t.device_s(PATTERN.search)
    if measured <= 0:
        return None
    work = registry.module("roofline", "ssd_scan_bwd")
    bound = sum(work.seconds(c, run.config["dtype"], run.peaks)
                for c in calls)
    return 100.0 * bound * t.steps / measured
