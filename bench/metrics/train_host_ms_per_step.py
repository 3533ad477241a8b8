"""``train_host_ms_per_step`` (ms): the host's wall time from the call
of the train step to its return, unsynchronised, averaged over the
window's steps (the traced run's window before the profiler starts)."""


def read(run):
    if not run.host_s:
        return None
    return 1e3 * sum(run.host_s) / len(run.host_s)
