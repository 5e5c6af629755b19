"""The port's copies of the JAX package's library-only modules held against
the originals, twin by twin: caller/bubbles.py with traversal/pathfinder.py
(tests/test_bubbles.py), io/xmfa.py (test_more_commands.py::test_xmfa),
utils/containers.py (test_utils.py::test_containers) and
models/interval_combiner.py (test_alignment.py::test_interval_combiner).
The same inputs go into both packages; the outputs must be equal, and hold
what the JAX package's own tests assert."""

import numpy as np

from corticall_tpu import fixtures as jfix  # noqa: E402
from corticall_tpu.caller import bubbles as jbub  # noqa: E402
from corticall_tpu.commands import core as jcore  # noqa: E402
from corticall_tpu.io import xmfa as jxmfa  # noqa: E402
from corticall_tpu.models import interval_combiner as jic  # noqa: E402
from corticall_tpu.models.reference_index import IndexedReference as JRef  # noqa: E402
from corticall_tpu.traversal import TraversalConfig as JConfig  # noqa: E402
from corticall_tpu.traversal import TraversalEngine as JEngine, to_contig as jcontig  # noqa: E402
from corticall_tpu.traversal.pathfinder import PathFinder as JPathFinder  # noqa: E402
from corticall_tpu.traversal.stopping import ExplorationStopper as JExplore  # noqa: E402
from corticall_tpu.utils import containers as jct  # noqa: E402
from corticall_tpu_torch import fixtures as tfix  # noqa: E402
from corticall_tpu_torch.caller import bubbles as tbub  # noqa: E402
from corticall_tpu_torch.commands import core as tcore  # noqa: E402
from corticall_tpu_torch.io import xmfa as txmfa  # noqa: E402
from corticall_tpu_torch.models import interval_combiner as tic  # noqa: E402
from corticall_tpu_torch.models.reference_index import IndexedReference as TRef  # noqa: E402
from corticall_tpu_torch.traversal import TraversalConfig as TConfig  # noqa: E402
from corticall_tpu_torch.traversal import TraversalEngine as TEngine  # noqa: E402
from corticall_tpu_torch.traversal import to_contig as tcontig  # noqa: E402
from corticall_tpu_torch.traversal.pathfinder import PathFinder as TPathFinder  # noqa: E402
from corticall_tpu_torch.traversal.stopping import ExplorationStopper as TExplore  # noqa: E402
from corticall_tpu_torch.utils import containers as tct  # noqa: E402


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def test_trim_alleles_matches_jax():
    for ref, alt in (("AAACGTTT", "AAATGTTT"), ("AAATTT", "AAACGTTT"), ("ACGT", "ACGT"),
                     ("", "A"), ("GATTACA", "GATACA")):
        assert tbub._trim(ref, alt) == jbub._trim(ref, alt), (ref, alt)
    assert tbub._trim("AAACGTTT", "AAATGTTT") == ("C", "T")
    assert tbub._trim("AAATTT", "AAACGTTT") == ("", "CG")


def _two_path_paths(fix, engine, config, explore, finder, to_contig):
    g = fix.build_graph({
        "kid": ["AGTTCGAATCTGGGCTATATGCT", "AGTTCGAATCTGAGCTATATGCT"],
    }, 7)
    e = engine(config(graph=g, traversal_colors=[0], stopping_rule=explore))
    d = e.dfs("AGTTCGA", "ATATGCT")
    assert d is not None
    v0, v1 = d.find_vertex("AGTTCGA"), d.find_vertex("ATATGCT")
    assert v0 is not None and v1 is not None
    return [to_contig(p) for p in finder(d, 0).get_paths(v0, v1)]


def test_pathfinder_two_paths_matches_jax():
    """tests/test_bubbles.py::test_pathfinder_two_paths in both packages:
    the same paths, in the same order."""
    want = _two_path_paths(jfix, JEngine, JConfig, JExplore, JPathFinder, jcontig)
    got = _two_path_paths(tfix, TEngine, TConfig, TExplore, TPathFinder, tcontig)
    assert got == want
    assert set(got) == {"AGTTCGAATCTGGGCTATATGCT", "AGTTCGAATCTGAGCTATATGCT"}


def _bubbles(fix, core, bub, haplotypes):
    """Every ROI seed's bubbles (max_pairs 8) as comparable tuples."""
    g = fix.build_graph(haplotypes, 21)
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    assert rois.num_records > 0
    bc = bub.BubbleCaller(g, rois, g.color_for_sample("kid"),
                          g.colors_for_samples(["mom", "dad"]))
    out = []
    for i in range(rois.num_records):
        seed = rois.kmer_string(i)
        out.append([(b.ref_allele, b.alt_allele, sorted(b.novel_kmers))
                    for b in bc.call(seed, max_pairs=8)])
    return out


def test_bubble_caller_snp_bubble_matches_jax():
    """tests/test_bubbles.py::test_bubble_caller_snp_bubble in both
    packages: every ROI seed's bubbles equal, and the SNP found."""
    rng = np.random.default_rng(91)
    parent = _genome(rng, 600)
    pos = 300
    alt = "ACGT"[("ACGT".index(parent[pos]) + 1) % 4]
    child = parent[:pos] + alt + parent[pos + 1:]
    haplotypes = {"kid": [child], "mom": [parent], "dad": [parent]}
    want = _bubbles(jfix, jcore, jbub, haplotypes)
    got = _bubbles(tfix, tcore, tbub, haplotypes)
    assert got == want
    first = next(b for b in got if b)[0]
    assert first[0].upper() == parent[pos] and first[1].upper() == alt and first[2]


def test_xmfa_matches_jax(tmp_path):
    """test_more_commands.py::test_xmfa in both packages."""
    p = tmp_path / "a.xmfa"
    p.write_text(
        "> chr1:1-10 + src1\nACGTACGTAC\n"
        "> chr2:5-14 - src2\nACGTAC--AC\n"
        "=\n"
        "> chr1:20-24 +\nAAAAA\n"
        "=\n")

    def blocks(mod):
        return [[(e.seqid, e.start, e.end, e.strand, e.sequence) for e in b.entries]
                for b in mod.read_xmfa(p)]

    got = blocks(txmfa)
    assert got == blocks(jxmfa)
    assert len(got) == 2 and len(got[0]) == 2
    assert got[0][1] == ("chr2", 5, 14, "-", "ACGTAC--AC")


def _containers(ct):
    df = ct.DataFrame(default=0)
    df.set("r1", "c1", 5)
    df.set("r2", "c2", 7)
    ts = ct.DataTables()
    t = ts.add("stats", "desc", ["name", "n"])
    t.set("a", "name", "a")
    t.increment("a", "n")
    t.increment("a", "n")
    d = {}
    for key in ("x", "x", "y"):
        ct.increment(d, key)
    return (df.get("r1", "c1"), df.get("r2", "c9"), df.to_tsv(), t.get("a", "n"), d,
            ct.most_common_key(d))


def test_containers_match_jax():
    """test_utils.py::test_containers in both packages."""
    got = _containers(tct)
    assert got == _containers(jct)
    assert got[0] == 5 and got[1] == 0 and "c1" in got[2] and got[3] == 2 and got[5] == "x"


def test_interval_combiner_matches_jax():
    """test_alignment.py::test_interval_combiner in both packages (its own
    sequence; no reference data)."""
    rng = np.random.default_rng(9)
    seq = _genome(rng, 3000)
    k = 21
    walk = ([seq[i:i + k] for i in range(100, 160)]
            + [seq[i:i + k] for i in range(2000, 2030)])

    def states(mod, ref, window, cap):
        return [(name, it.contig, it.start, it.end, it.negative)
                for name, it in mod.get_intervals(walk, {"ref": ref({"chr1": seq})}, window, cap)]

    for window, cap in ((50, 2), (50, 1), (10, 3)):
        assert states(tic, TRef, window, cap) == states(jic, JRef, window, cap), (window, cap)
    got = states(tic, TRef, 50, 2)
    assert len(got) == 2 and all(n == "ref" for n, *_ in got)
    ivs = sorted((s, e) for _, _, s, e, _ in got)
    assert ivs[0][0] <= 60 and ivs[0][1] >= 220
    assert ivs[1][0] <= 1960 and ivs[1][1] >= 2090
    assert got[0][3] - got[0][2] >= got[1][3] - got[1][2]
