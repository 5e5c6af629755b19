"""Profiling/tracing hooks: a named-section timer for per-stage breakdowns
and a torch.profiler trace around any code region.

The reference logs wall-clock + peak memory per command (Dispatch.java:75-84)
and nothing deeper.  Copy of corticall_tpu/utils/profiling.py, with
torch_trace in place of its jax profiler trace.
"""

from __future__ import annotations

import contextlib
import os
import time

from .progress import peak_memory_mb


class SectionTimer:
    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = [f"  {name}: {dt:.2f}s ({100 * dt / total:.0f}%)"
                 for name, dt in sorted(self.sections.items(),
                                        key=lambda kv: -kv[1])]
        lines.append(f"  peak memory: {peak_memory_mb():.0f} MB")
        return "\n".join(lines)



@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """Capture a torch.profiler trace around a region: CPU activity, and CUDA
    activity (kernels, copies, the runtime calls that launch them) when a card
    is visible.  On leaving, also by an exception, the device is synchronized
    and the trace written to log_dir as a Chrome trace (trace_<pid>_<ns>.json, for Perfetto or
    chrome://tracing); yields the profiler, whose key_averages() sums time by
    op and kernel.  A no-op that yields None when log_dir is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
