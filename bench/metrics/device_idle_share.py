"""``device_idle_share`` (%): the share of the profiled window in which
no operation ran on the device (one minus the union of the device's
operation intervals over the window)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
