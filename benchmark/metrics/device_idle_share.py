"""device_idle_share (read for device_idle_share.call and .walk): the share
of the traced window in which no operation ran on the device, in percent.
The profiler's own host time widens the gaps it measures (PERF.md, §5)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
