"""CPU tests of the three readers of the program's spans
(benchmark/metrics/tesserae_wrapper_ms.py, walk_host_ms.py,
walk_copy_gb_per_s.py) on hand-built span lists and runs, their silence
where the program records no spans, and a tiny traced walk cell read
through run.py.  Run with

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import run
from benchmark.lib import trace as btrace
from benchmark.tests import tiny
from corticall_tpu_torch.utils import profiling

MS = 1_000_000          # ns


def _reader(name):
    return run.load_module(run.reader_path(tiny.ROOT, name), "test_reader_" + name)


def _spans(*rows):
    """Spans from (name, start ms, end ms, parent index, attrs) rows."""
    out = []
    for i, (name, a, b, parent, attrs) in enumerate(rows):
        s = profiling.Span(name, dict(attrs))
        s.start_ns, s.end_ns, s.index, s.parent = int(a * MS), int(b * MS), i, parent
        s.request = i if parent < 0 else out[parent].request
        out.append(s)
    return out


def _run(trace=None):
    return run.Run(1.0, 1.0, np.array([0.001]), {}, {}, trace)


def _trace(copies_us):
    """A Trace whose window holds device-to-host copies of the given
    durations, and one kernel."""
    events = [{"ph": "X", "cat": "user_annotation", "name": btrace.WINDOW, "ts": 0.0,
               "dur": 1e6},
              {"ph": "X", "cat": "kernel", "name": "jump_walk_kernel<3>", "ts": 10.0,
               "dur": 500.0}]
    t = 1000.0
    for d in copies_us:
        events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
                       "ts": t, "dur": d})
        t += d + 100.0
    return btrace.Trace(events)


@pytest.fixture
def spans(monkeypatch):
    """Hand the readers a span list in place of the program's."""
    box = []
    monkeypatch.setattr(profiling, "recorded", lambda: list(box))
    return box


SECTIONS = [
    # a device section: 3 ms, of it 2 ms waiting on the kernel
    ("tesserae.align", 0.0, 3.0, -1, {}),
    ("tesserae.pack", 0.0, 0.3, 0, {"bytes": 1000}),
    ("tesserae.launch", 0.3, 0.5, 0, {}),
    ("tesserae.wait", 0.5, 2.5, 0, {}),
    ("tesserae.fetch", 2.5, 2.7, 0, {}),
    ("tesserae.decode", 2.7, 3.0, 0, {}),
    # the host route: no launch, not the wrapper's
    ("tesserae.align", 4.0, 50.0, -1, {}),
    ("tesserae.host_oracle", 4.0, 50.0, 6, {}),
    # a second device section: 2 ms, 0.5 of it waiting
    ("tesserae.align", 60.0, 62.0, -1, {}),
    ("tesserae.launch", 60.2, 60.4, 8, {}),
    ("tesserae.wait", 60.4, 60.9, 8, {}),
]

WALKS = [
    ("jump.walk", 0.0, 5.0, -1, {"seeds": 4}),
    ("jump.walk.upload", 0.0, 0.4, 0, {"bytes": 48}),
    ("jump.walk.launch", 0.4, 0.5, 0, {}),
    ("jump.walk.copy", 0.5, 1.0, 0, {"bytes": 3_000_000}),
    ("jump.walk.wait", 1.0, 4.5, 0, {}),
    ("jump.walk", 10.0, 13.0, -1, {"seeds": 4}),
    ("jump.walk.upload", 10.0, 10.3, 5, {"bytes": 48}),
    ("jump.walk.launch", 10.3, 10.4, 5, {}),
    ("jump.walk.copy", 10.4, 10.8, 5, {"bytes": 1_000_000}),
    ("jump.walk.wait", 10.8, 12.0, 5, {}),
]


def test_wrapper_is_the_device_sections_span_less_its_wait(spans):
    spans.extend(_spans(*SECTIONS))
    got = _reader("tesserae_wrapper_ms").read(_run())
    assert got == pytest.approx(((3.0 - 2.0) + (2.0 - 0.5)) / 2)


def test_walk_host_is_the_walk_span_less_its_wait(spans):
    spans.extend(_spans(*WALKS))
    assert _reader("walk_host_ms").read(_run()) == pytest.approx(((5.0 - 3.5) + (3.0 - 1.2)) / 2)


def test_walk_copy_rate_is_the_spans_bytes_over_the_traced_copies(spans):
    spans.extend(_spans(*WALKS))
    reader = _reader("walk_copy_gb_per_s")
    # 4 MB in 80 us of copies: 50 GB/s
    assert reader.read(_run(_trace([50.0, 30.0]))) == pytest.approx(4e6 / 80e-6 * 1e-9)
    assert reader.read(_run()) is None                     # untraced
    assert reader.read(_run(_trace([]))) is None           # no copy in the trace


def test_readers_are_silent_without_spans(spans, monkeypatch):
    """Nothing recorded (the CPU route's sections, a program without
    spans): each reader returns None and does not raise."""
    names = ("tesserae_wrapper_ms", "walk_host_ms", "walk_copy_gb_per_s")
    spans.extend(_spans(("tesserae.align", 0.0, 1.0, -1, {}),        # host route only
                        ("tesserae.host_oracle", 0.0, 1.0, 0, {})))
    assert [_reader(n).read(_run(_trace([10.0]))) for n in names] == [None] * 3
    monkeypatch.delattr(profiling, "recorded")                        # the parent's module
    assert [_reader(n).read(_run(_trace([10.0]))) for n in names] == [None] * 3


def test_traced_tiny_walk_cell_reports_the_walk_spans(tmp_path):
    """A traced run of the tiny walk cell on the CPU route: walk_host_ms
    is read from the window's jump.walk spans; no copy span or device copy
    there, so walk_copy_gb_per_s is left out."""
    root = tiny.make_root(str(tmp_path))
    profiling.clear()
    res = run.run_cell(root, "tiny_walks", 11, 0.3, True, device="cpu",
                       t_start=time.perf_counter())
    walks = [s for s in profiling.recorded() if s.name == "jump.walk"]
    profiling.clear()
    assert res["correct"]
    assert len(walks) == res["attempted"]                  # the window's calls alone
    assert res["metrics"]["walk_host_ms"]["value"] > 0
    assert res["metrics"]["walk_host_ms"]["unit"] == "ms"
    assert "walk_copy_gb_per_s" not in res["metrics"]
