"""The port's tracing (corticall_tpu_torch/utils/profiling): the trace hook
torch_trace, the counterpart of corticall_tpu/utils/profiling.jax_trace (a
traced region writes one Chrome trace that parses and names what ran inside
it; None traces nothing; on a card the trace holds the Tesserae kernel's
launch), and the program's spans: off and empty without a profiler or
recording(), nested with parent and request ids when on, `cpu_op` events of
the profiler's trace, and recorded by TesseraeDevice.align, walk_forward_jumps
and build_jump_table at their call boundaries.  On a card, the walk's kernel
launch and copies lie inside their spans."""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu_torch import fixtures as tfix, kmer as tkm  # noqa: E402
from corticall_tpu_torch.ops import jump as tj, tesserae_torch as tt  # noqa: E402
from corticall_tpu_torch.utils import profiling  # noqa: E402
from corticall_tpu_torch.utils.profiling import torch_trace  # noqa: E402

WALK_SPANS = ("jump.walk.upload", "jump.walk.launch", "jump.walk.copy", "jump.walk.wait")
ALIGN_SPANS = ("tesserae.pack", "tesserae.launch", "tesserae.wait", "tesserae.fetch",
               "tesserae.decode")


@pytest.fixture(autouse=True)
def fresh_spans():
    """Each test starts and ends with an empty span list."""
    profiling.clear()
    yield
    profiling.clear()


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_names_the_ops_run_inside(tmp_path):
    a = torch.ones(16, 16)
    torch.mm(a, a)                       # outside: not traced
    with torch_trace(str(tmp_path / "trace")) as prof:
        torch.mm(a, a).sum()
    names = {e.get("name") for e in _events(str(tmp_path / "trace"))}
    assert "aten::mm" in names and "aten::sum" in names
    assert any(row.key == "aten::mm" for row in prof.key_averages())


def test_trace_of_none_writes_nothing(tmp_path):
    with torch_trace(None) as prof:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_trace_is_written_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError):
        with torch_trace(str(tmp_path / "trace")):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert any(e.get("name") == "aten::sum" for e in _events(str(tmp_path / "trace")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_holds_the_tesserae_kernel_on_card(cuda, tmp_path):
    """A ctk_tesserae launch inside the region: the trace holds the CUDA
    kernel it launched (the device function's name, tesserae_kernel) with a
    duration, and the runtime call that launched it."""
    from corticall_tpu_torch.ops import tesserae_torch as tt
    args = tt.section_inputs("ACGTACGGTCA" * 8, ["ACGTACGGTCA" * 7, "ACGTTCGGTCA" * 9],
                             (0.35, 0.90, 6e-4, 1e-3), cuda)
    tt.tesserae_fused(*args)                 # the kernels' build, outside the trace
    torch.cuda.synchronize()
    with torch_trace(str(tmp_path / "trace")):
        tt.tesserae_fused(*args)
    events = _events(str(tmp_path / "trace"))
    kernels = [e for e in events if e.get("cat") == "kernel" and "tesserae_kernel" in e["name"]]
    assert kernels and all(e["dur"] > 0 for e in kernels)
    assert any("LaunchKernel" in e.get("name", "") for e in events
               if e.get("cat") == "cuda_runtime")


# ---- spans ---------------------------------------------------------------------

def _tree(records):
    """{name: [(span, [child names])]} of recorded spans."""
    kids = profiling.children(records)
    out = {}
    for r in records:
        out.setdefault(r.name, []).append((r, [c.name for c in kids.get(r.index, [])]))
    return out


def test_span_off_records_nothing():
    """No profiler and no recording(): every span is the one shared no-op,
    and nothing is recorded."""
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("x.outer", bytes=3), profiling.span("x.inner")
    assert a is b and not a
    with a as sp:
        with b:
            sp.set(bytes=4)
    assert profiling.recorded() == [] and profiling.dropped() == 0
    with pytest.raises(KeyError):               # the no-op lets an exception pass
        with profiling.span("x.raises"):
            raise KeyError("inside")


def test_nested_spans_carry_parent_and_request_ids():
    with profiling.recording():
        for _ in range(2):
            with profiling.span("call", seeds=2):
                with profiling.span("call.a") as sp:
                    assert sp
                    sp.set(bytes=8)
                with profiling.span("call.b"):
                    with profiling.span("call.b.c"):
                        pass
    with profiling.span("after"):               # off again
        pass
    recs = profiling.recorded()
    assert [r.name for r in recs] == ["call", "call.a", "call.b", "call.b.c"] * 2
    assert [r.index for r in recs] == list(range(8))
    assert [r.parent for r in recs] == [-1, 0, 0, 2, -1, 4, 4, 6]
    assert [r.request for r in recs] == [0] * 4 + [4] * 4
    assert recs[0].attrs == {"seeds": 2} and recs[1].attrs == {"bytes": 8}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert sorted(profiling.children(recs)) == [0, 2, 4, 6]


def test_span_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.recorded()) == 3 and profiling.dropped() == 2
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_spans_are_cpu_ops_of_the_profilers_trace(tmp_path):
    """Under a CPU torch.profiler a span is on: torch's fast record function
    (a private API, pinned here) puts it in the Chrome trace as a `cpu_op`
    inside its parent's interval, and recorded() holds it.  The profiler's
    Python flag, which turns spans on, follows the profiler (also pinned)."""
    assert profiling._RecordFunctionFast is not None
    assert not torch.autograd.profiler._is_profiler_enabled
    with torch_trace(str(tmp_path / "trace")):
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("outer.call"):
            with profiling.span("outer.call.inner"):
                torch.ones(8).sum()
    ev = {e["name"]: e for e in _events(str(tmp_path / "trace"))
          if e.get("ph") == "X" and e.get("name", "").startswith("outer.call")}
    outer, inner = ev["outer.call"], ev["outer.call.inner"]
    assert outer["cat"] == inner["cat"] == "cpu_op"
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert [(r.name, r.parent) for r in profiling.recorded()] == [("outer.call", -1),
                                                                 ("outer.call.inner", 0)]


def test_section_timer_opens_a_span():
    t = profiling.SectionTimer()
    with profiling.recording():
        with t.section("host:load_walk"):
            pass
    assert [r.name for r in profiling.recorded()] == ["host:load_walk"]
    assert list(t.sections) == ["host:load_walk"]


def _section():
    rng = np.random.default_rng(3)
    a, b = ("".join(rng.choice(list("ACGT"), 60)) for _ in range(2))
    return a[:30] + b[30:], {"mom": a, "dad": b}


def test_tesserae_align_records_its_spans():
    query, targets = _section()
    dev = tt.TesseraeDevice(device="cpu")
    with profiling.recording():
        path = dev.align(query, targets)
    assert path == tt.TesseraeDevice(device="cpu").align(query, targets)   # spans change nothing
    tree = _tree(profiling.recorded())
    (align, kids), = tree["tesserae.align"]
    assert kids == list(ALIGN_SPANS) and align.parent == -1
    pack = tree["tesserae.pack"][0][0]
    # query and target codes int32, the mask a byte a cell, parameters float32
    assert pack.attrs["bytes"] == 4 * 60 + 4 * 2 * 60 + 2 * 60 + 4 * (9 + 25 + 5)
    assert all(r.request == align.index for r in profiling.recorded())

    profiling.clear()
    dev.HBM_BUDGET_BYTES = 1024                  # the budget gate's host route
    with profiling.recording():
        dev.align(query, targets)
    assert [(r.name, r.parent) for r in profiling.recorded()] == [
        ("tesserae.align", -1), ("tesserae.host_oracle", 0)]
    assert dev.host_sections == 1 and dev.device_sections == 1


def _graph(k=31, n=3000):
    genome = "".join(np.random.default_rng(7).choice(list("ACGT"), n))
    g = tfix.build_graph({"kid": [genome]}, k)
    seeds = tkm.pack_codes(tkm.strings_to_codes([genome[i:i + k] for i in (0, 500, 1000)]), k)
    return g, seeds


def test_walk_and_table_record_their_spans():
    """On the CPU route: the build's place / scatter / rows under jump.table,
    and the walk's upload and launch under jump.walk (no copy or wait)."""
    g, seeds = _graph()
    with profiling.recording():
        jt = tj.build_jump_table(g.kmers, g.edges[:, 0], 31, device="cpu")
        out = tj.walk_forward_jumps(jt.buckets, jt.rows, seeds, 31, 200)
    tree = _tree(profiling.recorded())
    assert tree["jump.table"][0][1] == ["jump.table.place", "jump.table.scatter",
                                        "jump.table.rows"]
    (walk, kids), = tree["jump.walk"]
    assert kids == ["jump.walk.upload", "jump.walk.launch"]
    assert walk.attrs == {"seeds": 3}
    assert tree["jump.walk.upload"][0][0].attrs == {"bytes": seeds.nbytes}
    assert (out[2] > 0).all()


@pytest.mark.cuda
def test_walk_launch_and_copies_lie_inside_their_spans(cuda, tmp_path):
    """A traced walk on the card: the host call that launched
    jump_walk_kernel (matched by the trace's correlation id) lies inside
    jump.walk.launch, the calls that enqueued the device-to-host copies
    inside jump.walk.copy, and the copy span's bytes are the copies'."""
    g, seeds = _graph()
    jt = tj.build_jump_table(g.kmers, g.edges[:, 0], 31, device=cuda)
    tj.walk_forward_jumps(jt.buckets, jt.rows, seeds, 31, 200)       # the kernels' build
    torch.cuda.synchronize()
    with torch_trace(str(tmp_path / "trace")):
        tj.walk_forward_jumps(jt.buckets, jt.rows, seeds, 31, 200)
    events = [e for e in _events(str(tmp_path / "trace")) if e.get("ph") == "X"]
    spans = {e["name"]: e for e in events if e.get("cat") == "cpu_op"
             and e["name"].startswith("jump.walk")}
    assert set(spans) == {"jump.walk", *WALK_SPANS}
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}

    def inside(device_event, name):
        call, sp = calls[device_event["args"]["correlation"]], spans[name]
        return sp["ts"] <= call["ts"] and call["ts"] + call["dur"] <= sp["ts"] + sp["dur"]

    kernels = [e for e in events if e.get("cat") == "kernel" and "jump_walk_kernel" in e["name"]]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]]
    assert len(kernels) == 1 and inside(kernels[0], "jump.walk.launch")
    assert copies and all(inside(c, "jump.walk.copy") for c in copies)
    copy_span, = [r for r in profiling.recorded() if r.name == "jump.walk.copy"]
    assert copy_span.attrs["bytes"] == sum(c["args"]["bytes"] for c in copies)
