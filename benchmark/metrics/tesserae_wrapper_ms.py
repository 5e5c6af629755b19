"""tesserae_wrapper_ms: the mean, over the `tesserae.align` spans of the
traced window that reached the device (those with a `tesserae.launch`
child), of the span's duration less its `tesserae.wait` child: the aligner's
packing, uploads, launch, read-back and decode on the host, from the
program's own spans (corticall_tpu_torch/utils/profiling).  The in-program
twin of tesserae_host_ms; None where the program records no spans."""

from corticall_tpu_torch.utils import profiling


def read(run):
    if not hasattr(profiling, "recorded"):
        return None
    spans = [s for s in profiling.recorded() if s.end_ns is not None]
    kids = profiling.children(spans)
    ms = []
    for s in spans:
        below = kids.get(s.index, [])
        if s.name == "tesserae.align" and any(c.name == "tesserae.launch" for c in below):
            wait = sum(c.duration_ns for c in below if c.name == "tesserae.wait")
            ms.append((s.duration_ns - wait) * 1e-6)
    return sum(ms) / len(ms) if ms else None
