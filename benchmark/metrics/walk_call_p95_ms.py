"""walk_call_p95_ms: the 95th percentile of every walk call's latency in the
window, from the seeds handed over to the host arrays returned."""

import numpy as np


def read(run):
    if not run.counts.get("walk_calls"):
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
