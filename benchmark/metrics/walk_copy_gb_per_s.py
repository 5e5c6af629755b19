"""walk_copy_gb_per_s: the bytes that walk_forward_jumps copied from the
device in the traced window (the `bytes` of its `jump.walk.copy` spans:
the walks' rows and the lane results) over the device-to-host copy seconds
of the device trace (the copies walk_copy_ms reads), in GB/s: the copy's
rate against the host link.  None where the program records no spans."""

from corticall_tpu_torch.utils import profiling


def read(run):
    if run.trace is None or not hasattr(profiling, "recorded"):
        return None
    nbytes = sum(s.attrs.get("bytes", 0) for s in profiling.recorded()
                 if s.name == "jump.walk.copy")
    seconds = run.trace.seconds(lambda name: "DtoH" in name)
    return nbytes / seconds * 1e-9 if nbytes and seconds > 0 else None
