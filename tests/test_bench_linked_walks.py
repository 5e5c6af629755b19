"""The linked walk cell of the benchmark (benchmark/traffic/linked_walks.py)
on the CPU at a tiny size: the program's linked walks against the plain
reference (benchmark/reference/linked_walks.py), the benchmark's link
generator against the program's threading, the walker's record entry
against its graph entry, the links file read by the program, the run's
`correct` under planted faults and under the control, and the frozen bound
against chip_smoke.py's count.  The test marked `cuda` holds the card's
walks against the plain twin at a bulk batch."""

from __future__ import annotations

import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.counts import link_bounds
from benchmark.lib import graph as bgraph, links as blinks
from benchmark.reference import linked_walks as ref
from benchmark.tests import tiny
from benchmark.traffic import linked_walks as lw
from corticall_tpu_torch import build as bd, fixtures
from corticall_tpu_torch.io import links as lkio
from corticall_tpu_torch.ops import walk_links as wl
from corticall_tpu_torch.traversal import TraversalConfig, TraversalEngine, to_contig
from corticall_tpu_torch.traversal.stopping import ContigStopper

CPU = torch.device("cpu")
MIX = {"kind": "linked_walks", "seeds_per_call": 256, "max_walk": 300, "batches": 2,
       "limits": {"lanes_wrong": 0}}
SEED = 2 ** 33 + 5


def config(k: int = 47) -> dict:
    cfg = tiny.config(k)
    cfg.update(link_read_coverage=20, read_length=150)
    return cfg


@pytest.fixture(autouse=True)
def one_thread():
    """The plain twin runs thousands of small ops a walk: on one thread they
    are faster, and they do not contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strings(chroms) -> list:
    return ["".join("ACGT"[x] for x in c) for c in chroms]


def _reads(chroms, reads, read_length: int) -> list:
    """The generator's reads (draw_reads') as strings, each on its strand."""
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for c, s, strand in zip(*reads):
        r = "".join("ACGT"[x] for x in chroms[c][s:s + read_length])
        out.append(r.translate(comp)[::-1] if strand else r)
    return out


def _walker(state, links_list, samples="child"):
    kmers, edges = state.graph
    return wl.LinkedWalker.from_records(state.k, kmers, edges, links_list, samples, device="cpu")


def _plant(state) -> None:
    """Records added to the links file: 20 of one orientation at every
    other link k-mer, more than MAX_ADD, so that walks passing one overflow
    and walks passing the others resolve their junctions."""
    recs = ref.read_ctp(state.ctp)
    rng = np.random.default_rng(3)
    out = {}
    for i, (kmer, rs) in enumerate(recs.items()):
        extra = 20 if i % 2 else 0
        fw = rs[0][0]
        more = ["".join(rng.choice(list("ACGT"), rng.integers(1, 6))) for _ in range(extra)]
        out[kmer] = [(f, c, 1) for f, c in rs] + [(fw, c, 1) for c in more]
    blinks.write_ctp(state.ctp, blinks.ReadLinks(state.k, out, 0, None, None), "child",
                     state.graph[0].shape[0])


@pytest.mark.parametrize("k,planted", [(47, True), (31, False)])
def test_walk_words_matches_the_reference(k, planted):
    """Every lane of a batch walked by LinkedWalker.walk_words on the CPU
    route (the plain twin) equals the reference in all four outputs; some
    lanes resolve a junction by a link, and with records planted past
    MAX_ADD and past the store's capacity some overflow."""
    state = lw.make_inputs(config(k), MIX, SEED + k, CPU)
    try:
        if planted:
            _plant(state)
        walker = _walker(state, [lkio.read_links(state.ctp)])
        out = walker.walk_words(state.batches[0], state.cap)
        child = ref.LinkedChild(state.trio.child, state.k, ref.read_ctp(state.ctp), CPU)
        lanes = np.arange(state.batches[0].shape[0])
        assert lw.count_wrong(state, child, np.zeros_like(lanes), lanes, list(out)) == 0
        assert out[3].any() and (out[0] & 8).any()
        assert out[1].any() == planted
        assert walker.stats["walks"] == len(lanes)
        assert walker.stats["junctions_resolved"] == int(out[3].sum())
        assert walker.stats["overflow_lanes"] == int(out[1].sum())
    finally:
        shutil.rmtree(state.folder, ignore_errors=True)


def test_generator_threads_as_the_program():
    """The benchmark's link generator and the program's build.thread_reads
    and io/links.merge_prefix_links on the same reads give the same records,
    each k-mer's in the same order, coverages included."""
    cfg = config()
    from benchmark.lib import genome
    trio = genome.make_trio(cfg, 17)
    reads = blinks.draw_reads(trio.child, 20, 150, 17)
    mine = blinks.thread(trio.child, 47, reads, 150, CPU)
    graph = fixtures.build_graph({name: _strings(c) for name, c in trio.genomes()}, 47)
    theirs = lkio.merge_prefix_links(bd.thread_reads(
        graph, _reads(trio.child, reads, 150), "child"))
    want = {key: [(r.forward, r.choices, r.coverages[0]) for r in recs]
            for key, recs in theirs.records.items()}
    assert want and mine.records == want
    assert mine.counts()["kmers_with_links"] == len(want)


def _old_link_arrays(graph, links_list):
    """build_link_arrays as it was: each file's k-mers looked up by
    graph.find_records, file by file."""
    from corticall_tpu_torch import kmer as km
    rec_of, choice_strs, forward, truncated = [], [], [], 0
    for lm in links_list:
        if lm.sample_name not in set(graph.sample_names) or not lm.records:
            continue
        keys = list(lm.records)
        canon, _ = km.canonicalize_codes(km.strings_to_codes(keys))
        for key, rec in zip(keys, graph.find_records(km.pack_codes(canon, graph.kmer_size))):
            if rec < 0:
                continue
            for jr in lm.records[key]:
                if len(jr.choices) > wl.MAX_J:
                    truncated += 1
                    continue
                rec_of.append(int(rec))
                choice_strs.append(jr.choices)
                forward.append(jr.forward)
    order = np.argsort(np.asarray(rec_of, dtype=np.int64), kind="stable")
    return ([choice_strs[i] for i in order], [forward[i] for i in order],
            np.bincount(np.asarray(rec_of, dtype=np.int64), minlength=graph.num_records),
            truncated)


def test_from_records_equals_the_graph_walker():
    """LinkedWalker.from_records on the graph's records builds the tables
    that LinkedWalker(graph, ...) builds, bit for bit, with the links of
    two samples, a k-mer outside the graph and records past MAX_J; the
    records form of build_link_arrays packs what a lookup file by file
    packed."""
    cfg = config()
    from benchmark.lib import genome
    trio = genome.make_trio(cfg, 23)
    graph = fixtures.build_graph({name: _strings(c) for name, c in trio.genomes()}, 47)
    files = []
    for name, chroms in (("child", trio.child), ("mother", trio.mother)):
        reads = _reads(chroms, blinks.draw_reads(chroms, 8, 150, 5), 150)
        files.append(lkio.merge_prefix_links(bd.thread_reads(graph, reads, name)))
    key = next(iter(files[0].records))
    files[0].records[key] = files[0].records[key] + [
        lkio.JunctionRecord(True, 40, (1,), "ACGT" * 10)]
    files[1].records["A" * 47] = [lkio.JunctionRecord(True, 1, (1,), "C")]
    child = graph.color_for_sample("child")
    want = wl.LinkedWalker(graph, [child], files, device="cpu")
    got = wl.LinkedWalker.from_records(47, graph.kmers, graph.edges[:, child], files,
                                       graph.sample_names, device="cpu")
    for a, b in zip(got.args, want.args):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.truncated == want.truncated == 1
    la = wl.build_link_arrays(graph, files)
    strs, fw, per_record, truncated = _old_link_arrays(graph, files)
    assert truncated == la.truncated and np.array_equal(np.diff(la.offsets), per_record)
    lens = np.asarray([len(s) for s in strs])
    assert np.array_equal(la.lengths[:len(strs)], lens) and np.array_equal(la.forward[:len(fw)], fw)
    only = wl.LinkedWalker.from_records(47, graph.kmers, graph.edges[:, child], files, "child",
                                        device="cpu")
    assert only.stats["link_records"] < got.stats["link_records"]


def test_links_file_round_trip(tmp_path):
    """The generator's .ctp.gz read by the program's io/links.read_links and
    by the reference's reader gives its records back."""
    cfg = config()
    from benchmark.lib import genome
    trio = genome.make_trio(cfg, 29)
    links = blinks.thread(trio.child, 47, blinks.draw_reads(trio.child, 20, 150, 29), 150, CPU)
    path = str(tmp_path / "child.ctp.gz")
    blinks.write_ctp(path, links, "child", 1234)
    ld = lkio.read_links(path)
    assert ld.sample_name == "child" and ld.kmer_size == 47 and ld.num_kmers_in_graph == 1234
    got = {k: [(r.forward, r.choices, r.coverages[0]) for r in v] for k, v in ld.records.items()}
    assert got == links.records
    assert all(r.num_kmers == len(r.choices) for v in ld.records.values() for r in v)
    assert ref.read_ctp(path) == {k: [(f, c) for f, c, _ in v] for k, v in links.records.items()}


@pytest.fixture(scope="module")
def served():
    """The tiny cell set up as a run sets it up, two requests served with
    the program's spans recorded, and the reference's child graph: (state,
    the reference's LinkedChild, the spans)."""
    from corticall_tpu_torch.utils import profiling
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    state = lw.setup(config(), MIX, SEED, CPU, False)
    child = ref.LinkedChild(state.trio.child, state.k, ref.read_ctp(state.ctp), CPU)
    profiling.clear()
    with profiling.recording():
        counts = [lw.request(state, i)[1] for i in range(MIX["batches"])]
    spans = profiling.recorded()
    profiling.clear()
    torch.set_num_threads(threads)
    yield state, child, spans, counts
    shutil.rmtree(state.folder, ignore_errors=True)


def _kept(state):
    b_of = np.concatenate([np.full(len(x[1]), x[0]) for x in state.kept])
    lane = np.concatenate([x[1] for x in state.kept])
    return b_of, lane, [np.concatenate([x[2 + j] for x in state.kept]) for j in range(4)]


def test_served_lanes_are_correct(served):
    """The kept lanes of the served calls equal the reference; one of each
    call's two passes a k-mer with links facing it, and some resolve a
    junction by a link."""
    state, child, _, counts = served
    b_of, lane, got = _kept(state)
    assert lw.count_wrong(state, child, b_of, lane, got) == 0
    assert (got[0][1::2] & 8).any(axis=1).all() and got[3].any()
    assert sum(c["walk_calls"] for c in counts) == MIX["batches"]
    # the warm-up walked the same batches once: the walker's counters hold both
    served_junctions = sum(c["junctions_resolved"] for c in counts)
    assert served_junctions > 0
    assert state.walker.stats["junctions_resolved"] == 2 * served_junctions


def test_span_metrics_read_the_walks(served):
    """The cell's per-layer metrics that read the program's spans and the
    set-up timer find them; the device metrics stay silent on the CPU."""
    from corticall_tpu_torch.utils import profiling
    state, _, spans, counts = served
    names = [s.name for s in spans]
    assert names.count("links.walk") == MIX["batches"]
    assert {"links.walk.upload", "links.walk.launch", "links.walk.copy"} <= set(names)
    # a call's steps in order: the copy is enqueued before the one wait (on a card)
    steps = ["links.walk.upload", "links.walk.launch", "links.walk.copy"]
    kids = profiling.children(spans)
    for s in spans:
        if s.name == "links.walk":
            assert [c.name for c in kids[s.index]] in (steps, steps + ["links.walk.wait"])
    manifest = run.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    entries = run.cell_metrics(manifest, "pf47_linked_walks", True)
    saved = profiling._REC.records
    profiling._REC.records = spans
    try:
        got = run.read_metrics(tiny.ROOT, entries, run.Run(1.0, 1.0, np.ones(2), {},
                                                          state.timers, None))
    finally:
        profiling._REC.records = saved
    assert set(got) == {"link_table_build_s", "link_walk_host_ms"}
    assert got["link_walk_host_ms"]["value"] > 0


def _links_ignored(state, b_of, lane, got):
    """The kept lanes walked with the link CSR emptied: walked unlinked."""
    walker = state.walker
    saved = walker.args
    walker.args = (*saved[:2], torch.zeros_like(saved[2]), *saved[3:])
    try:
        seeds = np.stack([state.batches[b][i] for b, i in zip(b_of, lane)])
        return list(walker.walk_words(seeds, state.cap))
    finally:
        walker.args = saved


def _store_bit(state, b_of, lane, got):
    emitted = got[0].copy()
    emitted[:, 0] = np.where(emitted[:, 0] >= 0, emitted[:, 0] ^ 8, emitted[:, 0])
    return [emitted, *got[1:]]


@pytest.mark.parametrize("fault", [_links_ignored, _store_bit])
def test_planted_faults_read_wrong(served, fault):
    """The served lanes broken, their links ignored or their store bit
    flipped, read wrong, so a run with them is not correct."""
    state, child, _, _ = served
    b_of, lane, got = _kept(state)
    wrong = lw.count_wrong(state, child, b_of, lane, fault(state, b_of, lane, got))
    assert wrong > MIX["limits"]["lanes_wrong"]


def test_the_control_fails():
    """The reference walked with an empty link set reads above the limit."""
    readings = lw.control(config(), MIX, 9, CPU, 8)
    assert readings["lanes_wrong"] > MIX["limits"]["lanes_wrong"], readings


def test_a_program_without_the_entries_fails_at_once(monkeypatch):
    monkeypatch.delattr(wl.LinkedWalker, "walk_words")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="walk_words"):
        lw.setup(config(), MIX, SEED, CPU, False)
    assert time.perf_counter() - t0 < 1


def test_link_walk_bound_counts_as_chip_smoke():
    """The frozen bound's reads and operations against chip_smoke.py's
    count on the same walks: the records, offsets and pool rows found and
    the lookups alike, the operations with no store state charged equal."""
    saved = {m: sys.modules.get(m) for m in ("jax", "corticall_tpu")}
    import chip_smoke as cs
    for m, v in saved.items():             # chip_smoke blocks the JAX imports for itself
        if v is None:
            sys.modules.pop(m, None)
        else:
            sys.modules[m] = v
    state = lw.make_inputs(config(), MIX, SEED, CPU)
    try:
        walker = _walker(state, [lkio.read_links(state.ctp)])
        seeds = state.batches[0]
        out = walker.walk_words(seeds, state.cap)
        emitted = torch.from_numpy(np.ascontiguousarray(out[0]))
        sizes = torch.full((state.cap, len(seeds)), -1, dtype=torch.int8)
        want = cs.link_walk_reads(walker.args, torch.from_numpy(seeds.view(np.int32)), state.k,
                                  emitted.t(), sizes)
        kmers, edges = state.graph
        links = blinks.ReadLinks(state.k, {k: [(f, c, 1) for f, c in v]
                                           for k, v in ref.read_ctp(state.ctp).items()},
                                 0, None, None)
        g = bgraph.Graph(state.k, torch.from_numpy(kmers.astype(np.int64)),
                         torch.from_numpy(edges)[:, None], None, None, None, None)
        got = link_bounds.link_walk_reads(lw.bound_records(g, links, state.k),
                                          torch.from_numpy(seeds.astype(np.int64)), emitted,
                                          state.k, walker.args[0].shape[1])
        for name in ("offsets", "pool_rows", "walk_steps", "ops"):
            assert got[name] == want[name], name
        assert got["kmers"] == want["records"]
        assert want["pool_rows"] > 0
    finally:
        shutil.rmtree(state.folder, ignore_errors=True)


def test_device_walker_and_host_engine_part_on_same_list():
    """ROADMAP §1: a walk that meets a junction while its store holds an
    element of "AC" (past its first choice) and a younger one of "ACA" (at
    its first): their choice words are equal, so the device walker takes
    them for one list and follows the latest element, "ACA"'s A, where the
    host engine (traversal/linkstore.py, LinkStore.java) follows the oldest
    list "AC"'s own last element, C.  The benchmark's reference follows the
    device walker."""
    k = 11
    rng = np.random.default_rng(7)

    def bases(n):
        return "".join(rng.choice(list("ACGT"), n))

    left, k1, mid, k2, r1, r2, g1 = (bases(n) for n in (60, k, 60, k, 60, 60, 60))
    hap = left + k1 + "A" + mid + k2 + "A" + r1
    haps = [hap, k1 + "G" + g1, k2 + "C" + r2]
    graph = fixtures.build_graph({"s": haps}, k)

    def record(kmer, choices):
        rc = kmer.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        return min(kmer, rc), lkio.JunctionRecord(kmer < rc, len(choices), (1,), choices)

    x1 = hap[20:20 + k]
    x2 = hap[len(left) + k + 1 + 20:][:k]
    links = lkio.LinksData("s", k, num_kmers_in_graph=graph.num_records)
    for kmer, choices in ((x1, "AC"), (x2, "ACA")):
        key, jr = record(kmer, choices)
        links.records[key] = [jr]
    seed = hap[:k]
    walker = wl.LinkedWalker(graph, [0], [links], device="cpu")
    device = walker.assemble([seed], 256)[0][0]
    engine = TraversalEngine(TraversalConfig(graph=graph, traversal_colors=[0],
                                             stopping_rule=ContigStopper, links=[links],
                                             max_branch_length=256))
    host = to_contig(engine.assemble(seed))
    at_k2 = len(left) + k + 1 + len(mid) + k
    assert device == hap
    assert host == hap[:at_k2] + "C" + r2
    codes = [np.frombuffer(h.encode(), dtype=np.uint8) for h in haps]
    codes = [np.searchsorted(np.frombuffer(b"ACGT", dtype=np.uint8), c).astype(np.uint8)
             for c in codes]
    child = ref.LinkedChild(codes, k, {key: [(jr.forward, jr.choices) for jr in v]
                                       for key, v in links.records.items()}, CPU)
    want = child.walk(child.graph.gid[[0]], 256)
    got = walker.walk_words(walker_words(seed, k), 256)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def walker_words(seed: str, k: int) -> np.ndarray:
    from corticall_tpu_torch import kmer as km
    return km.pack_codes(km.strings_to_codes([seed], k), k)


@pytest.mark.cuda
def test_card_walks_equal_the_twin():
    """walk_words on the card (ctk_link_walk) against the plain twin run on
    the card's tables, on the tiny trio's links with records planted, at a
    bulk batch of 131,072 seeds (chip_smoke's 2 Mbp walks run 262,144)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mix = dict(MIX, seeds_per_call=131_072, batches=1)
    state = lw.make_inputs(config(), mix, SEED, torch.device("cuda"))
    try:
        _plant(state)
        kmers, edges = state.graph
        card = wl.LinkedWalker.from_records(state.k, kmers, edges,
                                            [lkio.read_links(state.ctp)], "child")
        got = card.walk_words(state.batches[0], state.cap)
        seeds = torch.from_numpy(state.batches[0].view(np.int32)).cuda()
        want = wl.walk_links_forward_plain(*card.args, seeds, state.k, state.cap)
        want = (want[0].t(), *want[1:])
        for a, b in zip(got, want):
            assert np.array_equal(a, b.cpu().numpy())
        assert got[3].any() and got[1].any()
    finally:
        shutil.rmtree(state.folder, ignore_errors=True)
