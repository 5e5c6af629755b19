"""CPU tests of the benchmark harness: what it imports, its generators, its
reference against the program's CPU route, its frozen counts against
chip_smoke.py's, a cell found by its files alone, and a run's `correct`
under planted faults and under the control.  Run with

    python3 -m pytest benchmark/tests -q

The test marked `cuda` runs a tiny cell on the card and skips without one.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.lib import genome
from benchmark.reference import tesserae as ref_tz
from benchmark.tests import tiny

ROOT = tiny.ROOT
BENCH = os.path.join(ROOT, "benchmark")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, workload, seed=11, seconds=0.3, traced=False):
    return run.run_cell(root, workload, seed, seconds, traced, device="cpu",
                        t_start=time.perf_counter())


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        if os.sep + "tests" in dirpath[len(BENCH):] or "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_imported():
    """No module of the benchmark imports jax, jaxlib, flax or the JAX
    package, compared by whole top-level names (corticall_tpu_torch is not
    corticall_tpu); the reference and the counts import nothing of the
    program."""
    for path in _sources():
        tops = set(_top_imports(path))
        assert not tops & set(run.FORBIDDEN), (path, tops & set(run.FORBIDDEN))
        rel = os.path.relpath(path, BENCH)
        if rel.startswith(("reference", "counts", "lib")):
            assert "corticall_tpu_torch" not in tops, path
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run, control; "
            "[run.resolve_cell(run.ROOT, w['name']) for w in "
            "run.load_json(run.ROOT + '/BENCHMARK.json')['workloads']]; "
            "m = run.load_json(run.ROOT + '/BENCHMARK.json'); "
            "[run.load_module(run.reader_path(run.ROOT, e['name']), 'x' + str(i)) "
            "for i, e in enumerate(m['end_to_end'] + m['per_layer'])]; "
            "print(run.forbidden_loaded())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert "corticall_tpu_torch" not in run.FORBIDDEN
    assert "corticall_tpu_torch".split(".")[0] != "corticall_tpu"


def test_generators_are_deterministic_per_seed():
    big = 2 ** 40 + 7
    a, b, c = (genome.make_trio(tiny.config(), s) for s in (big, big, big + 1))
    for x, y in zip(a.child + a.mother + a.father, b.child + b.mother + b.father):
        assert np.array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a.child, c.child))
    assert [(s.chrom, s.pos, s.kind) for s in a.sites] == [(s.chrom, s.pos, s.kind)
                                                            for s in b.sites]
    from benchmark.traffic import bulk_walks, sections
    s1, s2 = (sections.make_inputs(tiny.config(), tiny.SECTIONS, big) for _ in range(2))
    assert s1.sections == s2.sections and s1.check == s2.check
    s3 = sections.make_inputs(tiny.config(), tiny.SECTIONS, big + 1)
    assert s3.sections != s1.sections

    def shape(st):
        return sorted((len(q), len(t), max(map(len, t.values()))) for q, t in st.sections)
    assert shape(s3) == shape(s1)                 # the same work for every seed
    w1, w2 = (bulk_walks.make_inputs(tiny.config(), tiny.WALKS, big, CPU) for _ in range(2))
    for x, y in zip(w1.batches, w2.batches):
        assert np.array_equal(x, y)
    assert np.array_equal(w1.lanes, w2.lanes)
    assert np.array_equal(w1.graph[0], w2.graph[0]) and np.array_equal(w1.graph[1], w2.graph[1])


def test_section_parents_line_up():
    """Each section's first two targets are the parents' bases over the
    query's stretch: the child's segment is found in them up to its events."""
    trio = genome.make_trio(tiny.config(), 5)
    for site in trio.sites:
        if site.kind != "snv":
            continue
        c, p = site.chrom, site.pos
        q = trio.child[c][p - 30:p + 30]
        m = trio.mother[c][trio.parent_pos(c, p - 30):][:60]
        f = trio.father[c][trio.parent_pos(c, p - 30):][:60]
        assert min((q != m).sum(), (q != f).sum()) <= 3


def test_reference_matches_the_port_on_the_cpu():
    """The plain references against the program's CPU route (its plain
    twins) at a tiny size: every walk lane and every section equal."""
    from benchmark.traffic import bulk_walks, sections
    from corticall_tpu_torch.ops import jump
    from corticall_tpu_torch.ops.tesserae_torch import TesseraeDevice
    for k in (47, 31):
        st = bulk_walks.make_inputs(tiny.config(k), tiny.WALKS, 3, CPU)
        kmers, edges = st.graph
        table = jump.build_jump_table(kmers, edges, k, device="cpu")
        out = jump.walk_forward_jumps(table.buckets, table.rows, st.batches[0], k, st.cap)
        n = st.batches[0].shape[0]
        lanes = np.arange(n)
        assert bulk_walks.count_wrong(st, np.zeros(n, dtype=np.int64), lanes, list(out),
                                      CPU) == 0
        assert (out[2] < st.cap).any() and (out[2] == st.cap).any() and out[5].any()
    st = sections.make_inputs(tiny.config(), tiny.SECTIONS, 3)
    dev = TesseraeDevice(*st.hmm, device="cpu")
    for query, targets in st.sections:
        path = dev.align(query, targets)
        want_path, want_llk = ref_tz.align(query, targets, st.hmm)
        assert path == want_path
        assert dev.llk == want_llk


def test_frozen_counts_equal_chip_smoke():
    """benchmark/counts against chip_smoke.py's bound arithmetic on the same
    inputs: a section's bound, and a walk's with its distinct rows and seed
    buckets (chip_smoke counts the rows from the plain walk's visits, the
    benchmark from the walks' bases)."""
    code = r'''
import sys, json
sys.path.insert(0, %r)
import numpy as np, torch
import chip_smoke as cs
from benchmark.counts import bounds
from benchmark.tests import tiny
from benchmark.traffic import bulk_walks, sections
from corticall_tpu_torch.ops import jump, tesserae_torch as tt
out = []
st = sections.make_inputs(tiny.config(), tiny.SECTIONS, 4)
for q, t in st.sections:
    args = tt.section_inputs(q, list(t.values()), st.hmm, "cpu")
    out.append([cs.tesserae_bound(args)[0], sections.section_bound_ms(q, t)])
for k in (47, 31):
    w = bulk_walks.make_inputs(tiny.config(k), tiny.WALKS, 4, torch.device("cpu"))
    table = jump.build_jump_table(*w.graph, k, device="cpu")
    seeds = torch.from_numpy(w.batches[0].view(np.int32))
    got = jump.walk_jumps(table.buckets, table.rows, seeds, k, w.cap)
    want = cs.walk_bound(table.buckets, table.rows, seeds, k, w.cap, got)[0]
    s64 = torch.from_numpy(w.batches[0].astype(np.int64))
    packed = got[0].to(torch.int64) & 0xFFFFFFFF
    rows = bounds.walk_rows_read(s64, packed, got[1].to(torch.int64), k, w.cap)
    mine = bounds.walk_bound(w.batches[0].nbytes, bounds.walk_out_bytes(len(s64), w.cap),
                             bounds.seed_bucket_bytes(table.buckets, s64, k), rows)[0]
    out.append([want, mine])
print(json.dumps(out))
''' % ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    for want, mine in json.loads(res.stdout.strip().splitlines()[-1]):
        assert mine == pytest.approx(want, rel=1e-12)


def test_a_new_cell_is_found_by_its_files_alone(root):
    """A configuration, a traffic mix and a cell added as files and manifest
    entries, with no code changed, are found and run."""
    bench = os.path.join(root, "benchmark")
    cfg = tiny.config(47)
    cfg["name"], cfg["genome_mbp"] = "tiny_new", 0.045
    with open(os.path.join(bench, "configs", "tiny_new.json"), "w") as f:
        json.dump(cfg, f)
    mix = dict(tiny.WALKS, seeds_per_call=256, max_walk=200)
    with open(os.path.join(bench, "traffic", "tiny_new_walks.json"), "w") as f:
        json.dump(mix, f)
    path = os.path.join(root, "BENCHMARK.json")
    manifest = json.load(open(path))
    manifest["configs"].append({"name": "tiny_new", "source": "tests", "reduced": [],
                                "file": "benchmark/configs/tiny_new.json", "why": "tests"})
    manifest["workloads"].append({"name": "tiny_new", "config": "tiny_new",
                                  "traffic": "tiny_new_walks", "chips": 1, "why": "tests"})
    for m in manifest["end_to_end"]:
        if m["name"] == "walk_bases_per_s":
            m["workloads"].append("tiny_new")
    json.dump(manifest, open(path, "w"))
    found = run.resolve_cell(root, "tiny_new")
    assert found["mix"]["max_walk"] == 200 and found["config"]["genome_mbp"] == 0.045
    names = [m["name"] for m in run.cell_metrics(found["manifest"], "tiny_new", False)]
    assert names == ["walk_bases_per_s", "setup_s"]
    res = _run(root, "tiny_new")
    assert res["correct"] and set(res["metrics"]) == set(names)
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("workload", ["tiny_sections", "tiny_walks", "tiny31_walks"])
def test_sound_runs_are_correct(root, workload):
    res = _run(root, workload)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


def test_traced_run_reads_its_trace(root):
    res = _run(root, "tiny_walks", traced=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert "jump_table_build_s" in res["metrics"]
    assert "jump_walk_roofline" not in res["metrics"]   # no device kernel on the CPU
    # device_idle_share.walk has no file of its own: device_idle_share.py reads it
    assert not os.path.exists(os.path.join(BENCH, "metrics", "device_idle_share.walk.py"))
    assert res["metrics"]["device_idle_share.walk"]["value"] == 100.0
    assert res["attempted"] % tiny.WALKS["batches"] == 0


def test_host_routed_sections_are_judged(root, monkeypatch):
    """A section that the aligner's budget gate sends to its host oracle is
    served, timed apart and judged like the others; the window closes at the
    end of a turn of the record."""
    from benchmark.traffic import sections
    from corticall_tpu_torch.ops import tesserae_torch as tt
    monkeypatch.setattr(tt.TesseraeDevice, "HBM_BUDGET_BYTES", 2_000_000)
    record = sections.load_record(tiny.SECTIONS["record"])
    sizes = [tt.section_bytes(q, [n for _, n in t]) for q, t in record]
    assert sum(b > 2_000_000 for b in sizes) == 1
    res = _run(root, "tiny_sections", traced=True)
    assert res["correct"], res["compared"]
    assert res["attempted"] % len(record) == 0
    assert 0 < res["metrics"]["tesserae_host_route_share"]["value"] < 100
    assert res["metrics"]["device_idle_share.call"]["value"] == 100.0


def _flip_base(out):
    out = list(out)
    packed = out[0].copy()
    packed[len(packed) // 3, 0] ^= 1 << 30
    out[0] = packed
    return tuple(out)


def _half_batch(out):
    """The second half of the lanes left out: nothing walked there."""
    out = [x.copy() for x in out]
    half = out[0].shape[0] // 2
    for x in out:
        x[half:] = 0
    return tuple(out)


def _step_short(out):
    out = [x.copy() for x in out]
    out[2][::5] = np.maximum(out[2][::5] - 1, 0)
    return tuple(out)


@pytest.mark.parametrize("fault", [_flip_base, _half_batch, _step_short])
def test_a_broken_walk_is_not_correct(root, monkeypatch, fault):
    """The timed walk broken underneath (an answer altered where it is
    produced, half of the batch left out, a step lost) makes the run
    incorrect."""
    from corticall_tpu_torch.ops import jump
    orig = jump.walk_forward_jumps
    monkeypatch.setattr(jump, "walk_forward_jumps", lambda *a: fault(orig(*a)))
    res = _run(root, "tiny_walks")
    assert not res["correct"] and res["compared"]["lanes_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", ["path", "llk"])
def test_a_broken_section_is_not_correct(root, monkeypatch, fault):
    """A section's answer altered where it is produced: a copied base
    changed in its path, or its log-likelihood off by 1e-5 of itself."""
    from corticall_tpu_torch.ops.tesserae_torch import TesseraeDevice
    orig = TesseraeDevice.align

    def broken(self, query, targets):
        path = orig(self, query, targets)
        if fault == "llk":
            self.llk *= 1 + 1e-5
            return path
        name, track, span = path[-1]
        i = len(track) - 1
        return path[:-1] + [(name, track[:i] + ("a" if track[i] != "a" else "c"), span)]

    monkeypatch.setattr(TesseraeDevice, "align", broken)
    res = _run(root, "tiny_sections")
    assert not res["correct"]


@pytest.mark.parametrize("workload", ["tiny_sections", "tiny_walks"])
def test_the_control_fails(root, workload):
    """The control (Tesserae in bfloat16; walks through junctions) fails a
    number the run compares, at the tiny size."""
    found = run.resolve_cell(root, workload)
    readings = found["driver"].control(found["config"], found["mix"], 9, CPU, 60)
    limits = found["mix"]["limits"]
    assert any(readings[n] > limits[n] for n in readings), readings


def test_no_card_no_result():
    """Without a card the command exits with 3 and prints no result; without
    the program beside it, it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cmd = [sys.executable, "benchmark/run.py", "--workload", "pf47_walks", "--seed",
           str(2 ** 33), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 3 and out.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the command fails and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    cmd = [sys.executable, "benchmark/run.py", "--workload", "pf47_sections", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_tiny_cells_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in ("tiny_sections", "tiny_walks", "tiny31_walks"):
        res = run.run_cell(root, workload, 2 ** 35 + 1, 0.5, True, device="cuda",
                           t_start=time.perf_counter())
        assert res["correct"], (workload, res["compared"])
        assert res["device"]["busy_s"] > 0
