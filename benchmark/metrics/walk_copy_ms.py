"""walk_copy_ms: device-to-host copy time a walk call in the traced window
(the pitched copy of the walks and the lane results into pinned memory),
from the device trace."""


def read(run):
    n = run.counts.get("walk_calls")
    if run.trace is None or not n:
        return None
    ms = run.trace.seconds(lambda name: "DtoH" in name) * 1e3
    return ms / n if ms > 0 else None
