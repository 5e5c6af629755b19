"""tesserae_host_ms: the mean wall time of a section that the aligner ran on
the device, in the traced window, less its device time (the trace's busy
time over those sections): the aligner's packing, uploads, launch and
traceback decode on the host, with the profiler's own host time in it."""


def read(run):
    n = run.counts.get("device_sections")
    if run.trace is None or not n:
        return None
    return (run.counts["device_section_s"] - run.trace.busy_s) / n * 1e3
