"""Profiling hooks: a named-section timer for per-stage breakdowns.

The reference logs wall-clock + peak memory per command (Dispatch.java:75-84)
and nothing deeper.  Copy of corticall_tpu/utils/profiling.py without its
jax profiler trace.
"""

from __future__ import annotations

import contextlib
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

