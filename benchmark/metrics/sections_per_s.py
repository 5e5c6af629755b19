"""sections_per_s: Tesserae sections completed, their segments back on the
host, over the whole window."""


def read(run):
    n = run.counts.get("sections")
    return n / run.window_s if n else None
