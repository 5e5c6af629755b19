"""jump_walk_roofline: the frozen bound of every walk call in the traced
window (benchmark/counts/bounds.walk_bound: seeds, outputs, the seed
lookups' distinct buckets and the distinct rows read) over the time of the
`jump_walk_kernel` launches in the device trace, in percent."""


def read(run):
    bound = run.counts.get("walk_bound_ms")
    if run.trace is None or not bound:
        return None
    kernel_ms = run.trace.seconds(lambda n: "jump_walk_kernel" in n) * 1e3
    return 100.0 * bound / kernel_ms if kernel_ms > 0 else None
