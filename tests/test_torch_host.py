"""The port's copies of the JAX package's host modules, held against their
originals on the CPU: file bytes, graph records, simulations, the native
walkers (built by the port into build/native/), the traversal engine, the
evaluation and the host graph build.  Also the carry-across functions that
the other tests use to hand a JAX-package graph and its links to the port,
through the .ctx and .ctp bytes."""

import copy
import gzip
import os
import tempfile

import numpy as np
import pytest

from corticall_tpu import build as jbuild, evaluation as jev, fixtures as jfix  # noqa: E402
from corticall_tpu import native as jnat, simulate as jsim  # noqa: E402
from corticall_tpu.io import ctx as jctx, links as jlinks  # noqa: E402
from corticall_tpu.traversal import (BOTH, TraversalConfig as JConfig,  # noqa: E402
                                     TraversalEngine as JEngine, to_contig as jto_contig)
from corticall_tpu.traversal.stopping import ContigStopper as JStopper  # noqa: E402
from corticall_tpu_torch import build as tbuild, demo, evaluation as tev  # noqa: E402
from corticall_tpu_torch import fixtures as tfix, graph as tgr  # noqa: E402
from corticall_tpu_torch import native as tnat, simulate as tsim  # noqa: E402
from corticall_tpu_torch.io import ctx as tctx, links as tlinks  # noqa: E402
from corticall_tpu_torch.traversal import (TraversalConfig as TConfig,  # noqa: E402
                                           TraversalEngine as TEngine,
                                           to_contig as tto_contig)
from corticall_tpu_torch.traversal.stopping import ContigStopper as TStopper  # noqa: E402
from corticall_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- carry-across: the JAX package's objects as the port's ---------------

def port_graph(g):
    """The port's CortexGraph of the JAX package's graph `g`, through the
    .ctx bytes."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.ctx")
        jctx.write_ctx(path, g.data)
        return tgr.CortexGraph(tctx.read_ctx(path))


def port_links(ld):
    """The port's LinksData of the JAX package's links `ld`, through the
    .ctp bytes."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "l.ctp")
        jlinks.write_links(path, ld)
        return tlinks.read_links(path)


# ---- fixtures ---------------------------------------------------------------

def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _haplotypes(name):
    if name == "golden":
        return {"mom": ["AATA"], "dad": ["AATG"]}, 3
    if name == "contigs":
        return {"mom": ["AGTTCTGATCTGGGCTATATGCT"],
                "dad": ["AGTTCGAATCTGGGCTATATGCT"],
                "kid": ["AGTTCTGATCTGGGCTATGGCTA"]}, 5
    if name == "cycle":
        return {"test": ["ACTGATTTCGATGCGATGCGATGCCACGGTGG"]}, 5
    rng = np.random.default_rng(int(name[len("random"):]))
    genome = _genome(rng, 3000)
    child = list(genome)
    for pos in rng.integers(31, 2969, 8):
        child[pos] = "ACGT"[(ord(child[pos]) + 1) % 4]
    return {"kid": ["".join(child)], "mom": [genome], "dad": [genome[:2000]]}, 31


GRAPHS = ["golden", "contigs", "cycle", "random1", "random2"]


def _links_case(seed=17, k=15):
    """A child with a tandem repeat and links threaded through it."""
    rng = np.random.default_rng(seed)
    genome = _genome(rng, 1200)
    unit = genome[500:540]
    genome = genome[:500] + unit * 3 + genome[540:]
    g = jfix.build_graph({"kid": [genome], "mom": [genome[:900]]}, k)
    return g, genome, jlinks.build_links(g, {"kid": [genome]}, "kid")


# ---- .ctx / .ctp bytes ------------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS)
def test_ctx_bytes_round_trip(tmp_path, name):
    g = jfix.build_graph(*_haplotypes(name))
    jctx.write_ctx(tmp_path / "jax.ctx", g.data)
    data = tctx.read_ctx(tmp_path / "jax.ctx")
    tctx.write_ctx(tmp_path / "port.ctx", data)
    assert (tmp_path / "port.ctx").read_bytes() == (tmp_path / "jax.ctx").read_bytes()
    tg = port_graph(g)
    np.testing.assert_array_equal(tg.kmers, g.kmers)
    np.testing.assert_array_equal(tg.coverages, g.coverages)
    np.testing.assert_array_equal(tg.edges, g.edges)
    assert tg.sample_names == g.sample_names


@pytest.mark.parametrize("indexed", [False, True])
def test_ctp_bytes_round_trip(tmp_path, indexed, monkeypatch):
    g, _, ld = _links_case()
    assert len(ld) > 0
    if indexed:
        jlinks.write_links_indexed(str(tmp_path / "jax.ctp.bgz"), ld, source="kid")
        tlinks.write_links_indexed(str(tmp_path / "port.ctp.bgz"), port_links(ld),
                                   source="kid")
        for ext in ("", ".idx"):
            assert (tmp_path / f"port.ctp.bgz{ext}").read_bytes() == \
                (tmp_path / f"jax.ctp.bgz{ext}").read_bytes()
        ra = tlinks.open_links(str(tmp_path / "jax.ctp.bgz"))
        assert len(ra) == len(ld)
        for key in sorted(ld.records)[:20]:
            assert ra.get(key) is not None
    else:
        # gzip's header names the file: the same name in two directories;
        # and it holds the write time in seconds: one clock for both writes
        monkeypatch.setattr(gzip.time, "time", lambda: 1_700_000_000.0)
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        jlinks.write_links(tmp_path / "jax" / "l.ctp", ld)
        tlinks.write_links(tmp_path / "port" / "l.ctp", port_links(ld))
        assert (tmp_path / "port" / "l.ctp").read_bytes() == \
            (tmp_path / "jax" / "l.ctp").read_bytes()


# ---- fixtures.build_graph ---------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS)
def test_fixture_graph_records(name):
    haps, k = _haplotypes(name)
    assert tfix.build_graph(haps, k).record_strings() == \
        jfix.build_graph(haps, k).record_strings()


# ---- simulate and the smoke run's cross -------------------------------------

def _variant_fields(variants):
    return [sorted((key, repr(val)) for key, val in vars(v).items()) for v in variants]


@pytest.mark.parametrize("what", ["cross", "child", "reads"])
def test_simulation_from_one_seed(what):
    from demo_pf_cross import make_cross as jax_make_cross
    if what == "cross":
        got = demo.make_cross(np.random.default_rng(3), 0.06, 2, 0.003)
        want = jax_make_cross(np.random.default_rng(3), 0.06, 2, 0.003)
        assert got == want
        return
    mom, dad = demo.make_cross(np.random.default_rng(4), 0.05, 2, 0.003)
    args = dict(parents=("mom", "dad"), mu=2.0, num_variants=6, k=21, seed=7)
    got = tsim.simulate_haploid_child(mom, dad, **args)
    want = jsim.simulate_haploid_child(mom, dad, **args)
    if what == "child":
        assert got["child"] == want["child"]
        assert got.get("recombs") == want.get("recombs")
        assert _variant_fields(got["truth_vcf"]) == _variant_fields(want["truth_vcf"])
    else:
        seqs = list(got["child"].values())
        assert tsim.simulate_reads(seqs, 8.0, 100, 0.002, seed=11) == \
            jsim.simulate_reads(seqs, 8.0, 100, 0.002, seed=11)


def test_evaluation_venn():
    """The smoke run's scoring (demo.evaluate, over the port's evaluation)
    against demo_pf_cross.evaluate, on a call set missing two truths and
    with one false call."""
    from demo_pf_cross import evaluate as jax_evaluate
    mom, dad = demo.make_cross(np.random.default_rng(5), 0.05, 2, 0.003)
    args = dict(parents=("mom", "dad"), mu=2.0, num_variants=8, k=21, seed=9)
    got_res = tsim.simulate_haploid_child(mom, dad, **args)
    want_res = jsim.simulate_haploid_child(mom, dad, **args)
    calls = []
    for res in (got_res, want_res):
        false_call = copy.deepcopy(res["truth_vcf"][0])
        false_call.start += 37
        false_call.stop += 37
        calls.append(res["truth_vcf"][2:] + [false_call])
    got_calls, want_calls = calls
    got = demo.evaluate(got_calls, got_res["truth_vcf"], mom, dad, 21,
                        recombs=got_res.get("recombs"))
    want = jax_evaluate(want_calls, want_res["truth_vcf"], mom, dad, 21,
                        recombs=want_res.get("recombs"))
    assert got["kmer_venn"] == want["kmer_venn"]
    assert got["kmer_venn"]["fp"] > 0 and got["strict_recovered"] < len(got_res["truth_vcf"])
    assert got == want
    parts = [("p0", mom["chr1"][:400]), ("p1", dad["chr2"][100:600])]
    rois = {mom["chr1"][i:i + 21] for i in range(0, 300, 7)}
    assert tev.trim_partitions(parts, rois, 21, margin=50) == \
        jev.trim_partitions(parts, rois, 21, margin=50)


# ---- the native core, built by the port -------------------------------------

def test_native_core_builds_under_build():
    assert os.path.dirname(tnat._SO) == os.path.join(REPO, "build", "native")
    assert tnat._SRC.startswith(os.path.join(REPO, "corticall_tpu_torch", "csrc"))
    if not tnat.available():
        pytest.skip("no C++ toolchain")
    assert os.path.exists(tnat._SO)


@pytest.mark.parametrize("name", ["contigs", "random1", "random2"])
def test_native_walk_table(name):
    if not (tnat.available() and jnat.available()):
        pytest.skip("needs the native core")
    from corticall_tpu import kmer as km
    g = jfix.build_graph(*_haplotypes(name))
    tg = port_graph(g)
    k, color = g.kmer_size, 0
    seeds = km.pack_codes(km.strings_to_codes(
        [g.kmer_string(i) for i in range(0, g.num_records, 3)]), k)
    got = tnat.WalkTableNative(tg.kmers, tg.edges[:, color], k).walk(seeds, 300)
    want = jnat.WalkTableNative(g.kmers, g.edges[:, color], k).walk(seeds, 300)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_links_walker_contigs():
    if not (tnat.available() and jnat.available()):
        pytest.skip("needs the native core")
    g, genome, ld = _links_case()
    tg, tld = port_graph(g), port_links(ld)
    kid = g.color_for_sample("kid")
    seeds = [g.kmer_string(i) for i in range(0, g.num_records, 5)]
    got = tnat.LinksWalkerNative(tg, [kid], [tld]).walk(seeds, 2000)
    want = jnat.LinksWalkerNative(g, [kid], [ld]).walk(seeds, 2000)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


# ---- the traversal engine -----------------------------------------------------

@pytest.mark.parametrize("name, seed, golden", [
    ("contigs", "CTGGG", ["AGTTCTGATCTGGGCTATATGCT", "TTCGAATCTGGGCTATATGCT",
                          "AGTTCTGATCTGGGCTATGGCT"]),
    ("cycle", "ACTGA", ["ACTGATTTCGATGC"]),
])
def test_traversal_engine_golden_walk(name, seed, golden):
    """TraversalEngineTest.java's contigs (tests/test_traversal.py) on the
    port's engine, and the JAX package's engine on the same graph."""
    g = jfix.build_graph(*_haplotypes(name))
    tg = port_graph(g)
    for c, want in enumerate(golden):
        got = tto_contig(TEngine(TConfig(graph=tg, traversal_colors=[c],
                                         stopping_rule=TStopper)).walk(seed))
        ref = jto_contig(JEngine(JConfig(graph=g, traversal_colors=[c],
                                         stopping_rule=JStopper)).walk(seed))
        assert got == ref == want


def test_traversal_engine_with_links():
    g, genome, ld = _links_case()
    tg, tld = port_graph(g), port_links(ld)
    kid = g.color_for_sample("kid")
    seed = genome[100:115]
    got = tto_contig(TEngine(TConfig(graph=tg, traversal_colors=[kid], direction=BOTH,
                                     stopping_rule=TStopper, links=[tld])).walk(seed))
    want = jto_contig(JEngine(JConfig(graph=g, traversal_colors=[kid], direction=BOTH,
                                      stopping_rule=JStopper, links=[ld])).walk(seed))
    assert got == want and len(got) > 600


# ---- the host graph build -------------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
def test_build_graph_from_reads(use_native):
    rng = np.random.default_rng(12)
    genome = _genome(rng, 4000)
    reads = jsim.simulate_reads([genome], 12.0, 120, 0.004, seed=3)
    got = tbuild.build_graph_from_reads(reads, 31, "s", use_native=use_native)
    want = jbuild.build_graph_from_reads(reads, 31, "s", use_native=use_native,
                                         use_device=False)
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.coverages, want.coverages)
    np.testing.assert_array_equal(got.edges, want.edges)
    got_c = tbuild.clean_graph(got, min_coverage=2)
    want_c = jbuild.clean_graph(want, min_coverage=2)
    assert got_c.record_strings() == want_c.record_strings()


def test_device_branches_name_their_roadmap_item(monkeypatch):
    """The device branches of ROADMAP §1 items 2-3 are ported: the device
    graph build and resume_walks ask for a card when given no device and
    run the plain twins on the CPU, where they used to raise
    NotImplementedError."""
    import torch
    from corticall_tpu_torch.device import DeviceGraph
    from corticall_tpu_torch.ops import cuckoo as tck
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbuild.build_graph_from_reads(["ACGTACGTAC"], 5, "s", use_device=True)
    g = tbuild.build_graph_from_reads(["ACGTACGTAC"], 5, "s", use_device=True, device="cpu")
    assert g.record_strings() == tbuild.build_graph_from_reads(["ACGTACGTAC"], 5,
                                                               "s").record_strings()
    bases, cycled, steps = tckpt.resume_walks(DeviceGraph.from_graph(g, device="cpu"), [0],
                                              {"cur": g.kmers[:1]}, 10)
    assert bases.shape == (tck.spec_iters(10), 1) and cycled.shape == steps.shape == (1,)
