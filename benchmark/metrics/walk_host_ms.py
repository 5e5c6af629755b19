"""walk_host_ms: the mean, over the `jump.walk` spans of the traced window,
of the span's duration less its `jump.walk.wait` child: walk_forward_jumps'
seed upload, launch, pinned buffers and copies' enqueue and the numpy views
on the host, from the program's own spans
(corticall_tpu_torch/utils/profiling); None where the program records no
spans."""

from corticall_tpu_torch.utils import profiling


def read(run):
    if not hasattr(profiling, "recorded"):
        return None
    spans = [s for s in profiling.recorded() if s.end_ns is not None]
    kids = profiling.children(spans)
    ms = []
    for s in spans:
        if s.name == "jump.walk":
            wait = sum(c.duration_ns for c in kids.get(s.index, []) if c.name == "jump.walk.wait")
            ms.append((s.duration_ns - wait) * 1e-6)
    return sum(ms) / len(ms) if ms else None
