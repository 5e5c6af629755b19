"""link_walk_host_ms: the mean, over the `links.walk` spans of the traced
window, of the span's duration less its `links.walk.wait` child:
LinkedWalker.walk_words' seed upload, launch and copies to the host, from
the program's own spans (corticall_tpu_torch/utils/profiling); None where
the program records no such spans."""

from corticall_tpu_torch.utils import profiling


def read(run):
    if not hasattr(profiling, "recorded"):
        return None
    spans = [s for s in profiling.recorded() if s.end_ns is not None]
    kids = profiling.children(spans)
    ms = []
    for s in spans:
        if s.name == "links.walk":
            wait = sum(c.duration_ns for c in kids.get(s.index, []) if c.name == "links.walk.wait")
            ms.append((s.duration_ns - wait) * 1e-6)
    return sum(ms) / len(ms) if ms else None
