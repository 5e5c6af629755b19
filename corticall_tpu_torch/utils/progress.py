"""Rate-limited progress logging + resource reporting.

ProgressMeter parity (utils/progress/ProgressMeter.java:32-97: `N/M (x%) msg`
lines at an update interval) and PerformanceUtils-style memory strings
(utils/performance/PerformanceUtils.java:14-42).
"""

from __future__ import annotations

import resource
import sys
import time


class ProgressMeter:
    def __init__(self, header: str = "Processing...", message: str = "processed",
                 max_record: int = 0, update_record: int = 0, log=None):
        self.header = header
        self.message = message
        self.max_record = max_record
        self.update_record = update_record or max(1, max_record // 10)
        self.count = 0
        self.log = log or (lambda s: print(s, file=sys.stderr))
        self.start = time.time()
        self.log(self.header)

    def update(self, message: str | None = None) -> None:
        self.count += 1
        if self.count % self.update_record == 0:
            msg = message or self.message
            if self.max_record:
                pct = 100.0 * self.count / self.max_record
                self.log(f"  {self.count}/{self.max_record} ({pct:.1f}%) {msg}")
            else:
                self.log(f"  {self.count} {msg}")

    def finish(self) -> None:
        dt = time.time() - self.start
        self.log(f"  {self.count} {self.message} in {dt:.1f}s")


def peak_memory_mb() -> float:
    """Peak RSS in MB (the reference logs peak memory per command at exit,
    Dispatch.java:75-84)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_maxrss / 1024.0  # linux reports KB


def performance_summary(start_time: float) -> str:
    return (f"elapsed: {time.time() - start_time:.1f}s; "
            f"peak memory: {peak_memory_mb():.1f} MB")
