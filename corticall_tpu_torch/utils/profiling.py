"""Profiling/tracing hooks: spans at the program's call boundaries, a
named-section timer for per-stage breakdowns, and a torch.profiler trace
around any code region.

The reference logs wall-clock + peak memory per command (Dispatch.java:75-84)
and nothing deeper.  Copy of corticall_tpu/utils/profiling.py, with
torch_trace in place of its jax profiler trace, and `span`.

`span(name, **attrs)` marks one call boundary (`tesserae.align`,
`jump.walk.copy`, ...).  It is off unless a torch.profiler records (the
benchmark's traced window, `torch_trace`, the CLI's `--trace`) or a
`recording()` context is open; off, it costs one check and hands back a
shared no-op.  On, it enters torch's fast record function, so that it is a
`cpu_op` event of the profiler's Chrome trace on the clock of the kernels
and copies, and appends a `Span` to an in-memory list of at most
MAX_RECORDS (`recorded()`, `dropped()`, `clear()`); spans write nothing to
disk.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
from torch.autograd import profiler as _torch_profiler

from .progress import peak_memory_mb

try:                            # private torch API: spans fall back to the list alone
    from torch._C._profiler import _RecordFunctionFast
except ImportError:
    _RecordFunctionFast = None

MAX_RECORDS = 1 << 20


class _Recorder:
    """The process's recorded spans: the list, the spans dropped past its
    bound, the depth of open recording() contexts and the stack of open
    spans (the program's calls run on one thread)."""

    def __init__(self):
        self.records: list = []
        self.dropped = 0
        self.forced = 0
        self.open: list = []


_REC = _Recorder()


class Span:
    """One recorded span: `name`, `start_ns` and `end_ns` by
    time.perf_counter_ns (end None while open), `index` in recorded(), the
    index of its `parent` span (-1 for an outermost one), `request`: the
    index of its outermost span, which the spans of one call share, and
    `attrs` (e.g. bytes=).  Indices are -1 for spans dropped past the
    bound."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "index", "parent", "request", "_rf")

    def __init__(self, name: str, attrs: dict | None = None):
        self.name = name
        self.attrs = attrs or {}
        self.start_ns = self.end_ns = None
        self.index = self.parent = self.request = -1
        self._rf = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _REC.open
        if len(_REC.records) < MAX_RECORDS:
            self.index = len(_REC.records)
            _REC.records.append(self)
        else:
            _REC.dropped += 1
        if stack:
            self.parent, self.request = stack[-1].index, stack[-1].request
        else:
            self.request = self.index
        stack.append(self)
        if _RecordFunctionFast is not None:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _REC.open.pop()
        return False


class _Off:
    """The span handed out while spans are off: does nothing, and is false,
    so that `if sp:` skips attributes that cost something to work out."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
# C callables rather than methods, so that `with` on the no-op runs no
# Python frame: __enter__() gives _OFF back, __exit__(*exc) gives "", which
# is false, so an exception passes on
_Off.__enter__ = itertools.repeat(_OFF).__next__
_Off.__exit__ = "".format


def span(name: str, **attrs):
    """A context manager marking one call boundary; see the module's
    docstring for when it records.  Whether a profiler records is read from
    torch's own Python flag, set while a torch profiler runs, which is
    cheaper than a call into torch._C."""
    if _torch_profiler._is_profiler_enabled or _REC.forced:
        return Span(name, attrs)
    return _OFF


@contextlib.contextmanager
def recording():
    """Spans on inside the block with no profiler running (tests, overhead
    measurements, the set-up split)."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def recorded() -> list:
    """The spans recorded since the last clear(), in the order they were
    entered (a copy of the list)."""
    return list(_REC.records)


def dropped() -> int:
    """Spans not recorded since the last clear() because the list was full."""
    return _REC.dropped


def clear() -> None:
    """Empty the list (call it between calls, with no span open)."""
    _REC.records = []
    _REC.dropped = 0


def children(records: list) -> dict:
    """{index of a span: [its child spans]} over `records`."""
    out: dict = {}
    for s in records:
        if s.parent >= 0:
            out.setdefault(s.parent, []).append(s)
    return out


class SectionTimer:
    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
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
    is visible; the program's spans are its `cpu_op` events by their names.
    On leaving, also by an exception, the device is synchronized
    and the trace written to log_dir as a Chrome trace (trace_<pid>_<ns>.json, for Perfetto or
    chrome://tracing); yields the profiler, whose key_averages() sums time by
    op and kernel.  A no-op that yields None when log_dir is None."""
    if log_dir is None:
        yield None
        return
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
