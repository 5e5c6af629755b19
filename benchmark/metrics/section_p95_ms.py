"""section_p95_ms: the 95th percentile of every section's latency in the
window, from the call into the aligner to its segments returned."""

import numpy as np


def read(run):
    if not run.counts.get("sections"):
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
