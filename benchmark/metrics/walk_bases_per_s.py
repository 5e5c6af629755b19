"""walk_bases_per_s: walk bases delivered to the host (the steps of every
lane of every call) over the whole window."""


def read(run):
    n = run.counts.get("walk_bases")
    return n / run.window_s if n else None
