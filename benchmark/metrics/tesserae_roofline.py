"""tesserae_roofline: the frozen bound of every section served in the traced
window (benchmark/counts/bounds.tesserae_bound) over the time of the
`tesserae_kernel` launches in the device trace, in percent."""


def read(run):
    bound = run.counts.get("tesserae_bound_ms")
    if run.trace is None or not bound:
        return None
    kernel_ms = run.trace.seconds(lambda n: "tesserae_kernel" in n) * 1e3
    return 100.0 * bound / kernel_ms if kernel_ms > 0 else None
