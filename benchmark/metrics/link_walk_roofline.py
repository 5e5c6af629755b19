"""link_walk_roofline: the frozen bound of every linked walk call in the
traced window (benchmark/counts/link_bounds.link_walk_bound: seeds,
outputs, the distinct k-mers' bucket rows, the records' edge bytes and
offsets, their link-pool rows; the steps' operations) over the time of the
`link_walk_kernel` launches in the device trace, in percent."""


def read(run):
    bound = run.counts.get("link_walk_bound_ms")
    if run.trace is None or not bound:
        return None
    kernel_ms = run.trace.seconds(lambda n: "link_walk_kernel" in n) * 1e3
    return 100.0 * bound / kernel_ms if kernel_ms > 0 else None
