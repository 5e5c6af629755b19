"""The port's copies of the command layer's host modules held against the
JAX package's, twin by twin: the same inputs into both packages, equal
outputs.  Twins of tests/test_commands.py (FindShared, FindUnanchored, the
command-line round trip), test_extra_commands.py, test_more_commands.py
(test_walk_checkpoint_resume's twin is in test_torch_walk_table.py,
test_xmfa's in test_torch_library.py), test_inheritance.py,
test_bam_index.py and test_utils.py's statistics, GFF, table, GFA and
visualizer tests (test_containers' twin is in test_torch_library.py)."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from corticall_tpu import fixtures as jfix, inheritance as jinh, kmer_index as jki  # noqa: E402
from corticall_tpu import quality as jq, simulate as jsim, visualizer as jviz  # noqa: E402
from corticall_tpu.commands import cli as jcli, core as jcore  # noqa: E402
from corticall_tpu.commands import extra as jextra, more as jmore  # noqa: E402
from corticall_tpu.io import bam as jbam, gfa as jgfa, gff as jgff, table as jtbl  # noqa: E402
from corticall_tpu.models.reference_index import IndexedReference as JRef  # noqa: E402
from corticall_tpu.traversal import TraversalConfig as JConfig, TraversalEngine as JEngine  # noqa: E402
from corticall_tpu.traversal.stopping import ContigStopper as JStopper  # noqa: E402
from corticall_tpu.utils import profiling as jprof, statistics as jst  # noqa: E402
from corticall_tpu_torch import fixtures as tfix, inheritance as tinh  # noqa: E402
from corticall_tpu_torch import kmer_index as tki, quality as tq  # noqa: E402
from corticall_tpu_torch import simulate as tsim, visualizer as tviz  # noqa: E402
from corticall_tpu_torch.commands import core as tcore  # noqa: E402
from corticall_tpu_torch.commands import extra as textra, more as tmore  # noqa: E402
from corticall_tpu_torch.io import bam as tbam, gfa as tgfa, gff as tgff, table as ttbl  # noqa: E402
from corticall_tpu_torch.models.reference_index import IndexedReference as TRef  # noqa: E402
from corticall_tpu_torch.traversal import TraversalConfig as TConfig  # noqa: E402
from corticall_tpu_torch.traversal import TraversalEngine as TEngine  # noqa: E402
from corticall_tpu_torch.traversal.stopping import ContigStopper as TStopper  # noqa: E402
from corticall_tpu_torch.utils import profiling as tprof, statistics as tst  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIO = {"kid": ["AGTTCTGATCTGGGCTATGGCTA"], "mom": ["AGTTCTGATCTGGGCTATATGCT"],
        "dad": ["AGTTCGAATCTGGGCTATATGCT"]}


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def both_graphs(haplotypes, k):
    """(JAX package's graph, port's graph) built from the same haplotypes."""
    return jfix.build_graph(haplotypes, k), tfix.build_graph(haplotypes, k)


def records(g):
    return [g.record_string(i) for i in range(g.num_records)]


def _snp_trio(seed, n=900, k=21):
    """tests/test_more_commands.py's _trio in both packages: (jax graph,
    jax rois, port graph, port rois)."""
    rng = np.random.default_rng(seed)
    parent = _genome(rng, n)
    pos = n // 2
    alt = "ACGT"[("ACGT".index(parent[pos]) + 1) % 4]
    child = parent[:pos] + alt + parent[pos + 1:]
    jg, tg = both_graphs({"kid": [child], "mom": [parent], "dad": [parent]}, k)
    return (jg, jcore.find_rois(jg, "kid", ["mom", "dad"]),
            tg, tcore.find_rois(tg, "kid", ["mom", "dad"]))


# ---- test_commands.py ---------------------------------------------------------

def test_find_shared():
    jg, tg = both_graphs({**TRIO, "sib": ["CTATGGCTA"]}, 5)
    jr, tr = jcore.find_rois(jg, "kid", ["mom", "dad"]), tcore.find_rois(tg, "kid", ["mom", "dad"])
    got = tcore.find_shared(tg, tr, ["mom", "dad"])
    assert records(got) == records(jcore.find_shared(jg, jr, ["mom", "dad"]))
    assert got.num_records > 0
    assert records(tcore.find_shared(tg, tr, ["mom"], ["sib"])) == \
        records(jcore.find_shared(jg, jr, ["mom"], ["sib"]))


def test_find_unanchored():
    rng = np.random.default_rng(71)
    parent = _genome(rng, 800)
    pos = 400
    alt = "ACGT"[("ACGT".index(parent[pos]) + 1) % 4]
    floating = _genome(rng, 120)
    jg, tg = both_graphs({"kid": [parent[:pos] + alt + parent[pos + 1:], floating],
                          "mom": [parent], "dad": [parent]}, 21)
    jr, tr = jcore.find_rois(jg, "kid", ["mom", "dad"]), tcore.find_rois(tg, "kid", ["mom", "dad"])
    got = tcore.find_unanchored(tg, tr, ["mom", "dad"], {"mom": TRef({"chr1": parent})})
    want = jcore.find_unanchored(jg, jr, ["mom", "dad"], {"mom": JRef({"chr1": parent})})
    assert records(got) == records(want)
    assert 0 < got.num_records < tr.num_records


def test_find_contamination():
    rng = np.random.default_rng(72)
    parent = _genome(rng, 800)
    contaminant = _genome(rng, 150)
    jg, tg = both_graphs({"kid": [parent[:300] + "TTGA" + parent[300:], contaminant],
                          "mom": [parent], "dad": [parent]}, 21)
    jc, tc = both_graphs({"contam": [contaminant]}, 21)
    jr, tr = jcore.find_rois(jg, "kid", ["mom", "dad"]), tcore.find_rois(tg, "kid", ["mom", "dad"])
    got = tcore.find_contamination(tg, tr, ["mom", "dad"], tc, {"mom": TRef({"c": parent})})
    want = jcore.find_contamination(jg, jr, ["mom", "dad"], jc, {"mom": JRef({"c": parent})})
    assert records(got) == records(want)
    assert got.num_records > 0


def test_cli_roundtrip(tmp_path):
    """tests/test_commands.py's round trip through `python -m
    corticall_tpu_torch --device cpu`, each output equal to the JAX
    package's command line run in-process on the same files."""
    _, g = both_graphs(TRIO, 5)
    gp = tmp_path / "trio.ctx"
    g.save(gp)

    def run(*args):
        return subprocess.run([sys.executable, "-m", "corticall_tpu_torch", "--device", "cpu",
                               *args], capture_output=True, text=True, cwd=REPO)

    rois, parts = tmp_path / "rois.ctx", tmp_path / "parts.fa"
    r = run("FindROIs", "-g", str(gp), "-c", "kid", "-p", "mom", "-p", "dad", "-o", str(rois))
    assert r.returncode == 0, r.stderr
    r = run("Partition", "-g", str(gp), "-r", str(rois), "-o", str(parts))
    assert r.returncode == 0, r.stderr
    assert parts.read_text().startswith(">partition0")
    view, cov = run("View", "-g", str(rois)), run("CovStats", "-g", str(gp))
    assert view.returncode == cov.returncode == 0
    assert "kid" in cov.stdout

    jrois, jparts = tmp_path / "jrois.ctx", tmp_path / "jparts.fa"
    assert jcli.main(["FindROIs", "-g", str(gp), "-c", "kid", "-p", "mom", "-p", "dad",
                      "-o", str(jrois)]) == 0
    assert jcli.main(["Partition", "-g", str(gp), "-r", str(jrois), "-o", str(jparts)]) == 0
    assert rois.read_bytes() == jrois.read_bytes()
    assert parts.read_bytes() == jparts.read_bytes()
    for path, out in ((jrois, view.stdout), (gp, cov.stdout)):
        jout = tmp_path / "jout.txt"
        cmd = "View" if path == jrois else "CovStats"
        assert jcli.main([cmd, "-g", str(path), "-o", str(jout)]) == 0
        assert out == jout.read_text()


# ---- test_extra_commands.py ----------------------------------------------------

def test_recover_excluded_kmers():
    rng = np.random.default_rng(81)
    seq = _genome(rng, 400)
    jg, tg = both_graphs({"kid": [seq[:200]], "mom": [seq]}, 21)
    jd, td = both_graphs({"kid": [seq]}, 21)
    got = textra.recover_excluded_kmers(tg, td)
    assert records(got) == records(jextra.recover_excluded_kmers(jg, jd))
    assert got.sample_names == ["kid"] and got.num_records > 0


def test_compare_rois():
    ja, ta = both_graphs({"s": ["AGTTCTGATCT"]}, 5)
    jb, tb = both_graphs({"s": ["TCTGATCTGGG"]}, 5)
    got = textra.compare_rois(ta, tb)
    assert got == jextra.compare_rois(ja, jb)
    assert got["o"] > 0


def test_filter_partitions():
    rng = np.random.default_rng(83)
    seq = _genome(rng, 500)
    jg, tg = both_graphs({"kid": [seq], "mom": [seq[:200] + seq[260:]]}, 21)
    contigs = [("good", seq[150:350]), ("sparse", seq[:100])]
    got = textra.filter_partitions(contigs, tcore.find_rois(tg, "kid", ["mom"]), 5)
    assert got == jextra.filter_partitions(contigs, jcore.find_rois(jg, "kid", ["mom"]), 5)
    assert [h for h, _ in got] == ["good"]


def test_combine_contigs_extends():
    rng = np.random.default_rng(85)
    seq = _genome(rng, 400)
    jg, tg = both_graphs({"kid": [seq], "mom": [seq[:150] + seq[250:]]}, 21)
    args = ([("c0", seq[100:300])], [("p0", seq[50:350])])
    got = textra.combine_contigs(*args, tcore.find_rois(tg, "kid", ["mom"]))
    assert got == jextra.combine_contigs(*args, jcore.find_rois(jg, "kid", ["mom"]))
    assert got[0][1] == seq[50:350]


def test_coverage_table():
    jg, tg = both_graphs({"s": ["AGTTCTGATCT"]}, 5)
    got = textra.coverage_table(tg, [("c1 x", "AGTTCTGA")], "s")
    assert got == jextra.coverage_table(jg, [("c1 x", "AGTTCTGA")], "s")
    assert len(got) == 4


def test_sim_to_vcf():
    rng = np.random.default_rng(87)
    parent = _genome(rng, 600)
    pos = 300
    old = parent[pos]
    new = "ACGT"[("ACGT".index(old) + 1) % 4]
    rows = [{"type": "SNV", "parent": "mom", "old": old, "new": new,
             "sleft": parent[pos - 100:pos], "sright": parent[pos + 1:pos + 101]},
            {"type": "RECOMB", "parent": "mom", "old": ".", "new": ".",
             "sleft": ".", "sright": "."}]
    got = textra.sim_to_vcf(rows, {"mom": TRef({"chr1": parent})})
    want = jextra.sim_to_vcf(rows, {"mom": JRef({"chr1": parent})})
    assert [(v.chrom, v.start, v.stop, v.alleles, v.attributes) for v in got] == \
        [(v.chrom, v.start, v.stop, v.alleles, v.attributes) for v in want]
    assert [(v.chrom, v.start) for v in got] == [("chr1", pos + 1)]


# ---- test_more_commands.py -------------------------------------------------------

def test_compile_feature_table():
    jg, jr, tg, tr = _snp_trio(111)
    want = jmore.compile_feature_table(jg, jr, {"tips": jcore.find_tips(jg, jr, ["mom", "dad"])},
                                       jcore.partition(jg, jr), jr)
    got = tmore.compile_feature_table(tg, tr, {"tips": tcore.find_tips(tg, tr, ["mom", "dad"])},
                                      tcore.partition(tg, tr, device="cpu"), tr)
    assert got == want
    assert len(got) == tr.num_records and all(r["truth"] == "1" for r in got)


def test_evaluate_rois():
    rng = np.random.default_rng(112)
    ref1, ref2 = {"a": _genome(rng, 1500)}, {"b": _genome(rng, 1500)}
    jres = jsim.simulate_haploid_child(ref1, ref2, mu=0, num_variants=2, k=21, seed=3)
    tres = tsim.simulate_haploid_child(ref1, ref2, mu=0, num_variants=2, k=21, seed=3)
    child = tres["child"]["chr1"]
    assert child == jres["child"]["chr1"]
    jg, tg = both_graphs({"kid": [child], "p1": [ref1["a"]], "p2": [ref2["b"]]}, 21)
    got = tmore.evaluate_rois(tcore.find_rois(tg, "kid", ["p1", "p2"]), tres["kmers"])
    assert got == jmore.evaluate_rois(jcore.find_rois(jg, "kid", ["p1", "p2"]), jres["kmers"])
    assert got["tp"] > 0 and got["fn"] == 0


def test_kmer_pair_matrix():
    kmer_rows = [{"index": 0, "kmer": "AAACG"}, {"index": 0, "kmer": "AACGT"},
                 {"index": 1, "kmer": "GGGTC"}]
    contigs = [("c0", "AAACGT"), ("c1", "GGGTCAAACG")]
    got = tmore.compute_kmer_pair_matrix(kmer_rows, contigs)
    assert got == jmore.compute_kmer_pair_matrix(kmer_rows, contigs)
    assert got[0][1] == 1 and got[0][2] == -1


def test_inheritance_tracks():
    rows = [{"chrom": "c1", "pos": "100", "kidA": "momref:5", "kidB": "dadref:7"}]
    assert tmore.inheritance_to_matrix(rows, ["kidA", "kidB"]) == \
        jmore.inheritance_to_matrix(rows, ["kidA", "kidB"])
    assert tmore.inheritance_to_circos_tracks(rows, ["kidA"]) == \
        jmore.inheritance_to_circos_tracks(rows, ["kidA"]) == {"kidA": ["c1 100 101 momref"]}
    vrows = [{"chrom": "c1", "pos": 5, "info": {"BACKGROUND": "mom"}}]
    assert tmore.vcf_to_inheritance_track(vrows) == jmore.vcf_to_inheritance_track(vrows)


def test_section_timer():
    reports = []
    for prof in (jprof, tprof):
        t = prof.SectionTimer()
        for name in ("a", "b"):
            with t.section(name):
                pass
        reports.append(t.report())
        assert sorted(t.sections) == ["a", "b"]
    assert [ln.split(":")[0] for ln in reports[1].splitlines()] == \
        [ln.split(":")[0] for ln in reports[0].splitlines()]


def test_annotate_calls():
    jg, jr, tg, tr = _snp_trio(121)
    jparts, tparts = jcore.partition(jg, jr), tcore.partition(tg, tr, device="cpu")
    assert tparts == jparts
    rows = [{"chrom": "chr1", "pos": 450, "ref": "A", "alt": "T", "id": ".", "filter": "PASS",
             "info": {"PARTITION_NAME": tparts[0][0].split(" ")[0]}}]
    out = []
    for gffio, more, parts, rois in ((jgff, jmore, jparts, jr), (tgff, tmore, tparts, tr)):
        genes = gffio.GFF3(records=[
            gffio.GFF3Record("chr1", "s", "gene", 400, 500, ".", "+", ".", {"ID": "gene1"}),
            gffio.GFF3Record("chr1", "s", "gene", 5000, 6000, ".", "+", ".", {"ID": "far"})])
        repeats = gffio.GFF3(records=[
            gffio.GFF3Record("chr1", "s", "repeat", 440, 460, ".", "+", ".", {"ID": "rep7"})])
        out.append(more.annotate_calls(rows, [("chr1", 430, 470)], genes, repeats, parts, rois))
    assert out[1] == out[0]
    info = out[1][0]["info"]
    assert (info["REGION"], info["GENES"], info["REPEAT"]) == ("accessory", "gene1", "rep7")


def test_show_novel_kmers():
    jg, jr, tg, tr = _snp_trio(131)
    parts = tcore.partition(tg, tr, device="cpu")
    got = tmore.show_novel_kmers(parts[:1], tr, tg)
    assert got == jmore.show_novel_kmers(parts[:1], jr, jg)
    assert len(got) == len(parts[0][1]) - tr.kmer_size + 2


def test_nahr_generator():
    seq = _genome(np.random.default_rng(122), 3000)
    got = tsim.gen_nahr(seq, 800, np.random.default_rng(5), 20)
    assert got == jsim.gen_nahr(seq, 800, np.random.default_rng(5), 20)


# ---- test_inheritance.py ----------------------------------------------------------

def _pedigree(seed, n, snp):
    rng = np.random.default_rng(seed)
    base = _genome(rng, n)
    pos = n // 2
    dad = base[:pos] + "ACGT"[("ACGT".index(base[pos]) + 1) % 4] + base[pos + 1:] \
        if snp else base
    return base, dad


def test_inheritance_paints_child_alleles():
    mom, dad = _pedigree(77, 1200, True)
    haps = {"kid": [mom], "mom": [mom], "dad": [dad], "mom_draft": [mom],
            "dad_draft": [dad], "ref": [dad]}
    seqs = {"mom_draft": {"mchr": mom}, "dad_draft": {"dchr": dad}, "ref": {"refchr": dad}}
    jg, tg = both_graphs(haps, 21)
    parents = {"mom_draft": "mom", "dad_draft": "dad"}
    want = jinh.compute_inheritance(jg, {n: JRef(s) for n, s in seqs.items()}, parents,
                                    children=["kid"], ref_name="ref")
    got = tinh.compute_inheritance(tg, {n: TRef(s) for n, s in seqs.items()}, parents,
                                   children=["kid"], ref_name="ref")
    assert got == want
    assert got and got[0]["type"] == "SNP" and got[0]["chrom"] == "refchr"


def test_variant_seeds_require_unique_coordinates():
    base, _ = _pedigree(78, 600, False)
    haps = {"kid": [base], "mom": [base], "dad": [base], "mom_draft": [base], "ref": [base]}
    out = []
    for g, ref, inh in zip(both_graphs(haps, 21), (JRef, TRef), (jinh, tinh)):
        refs = {"mom_draft": ref({"m": base}), "ref": ref({"r": base})}
        out.append(inh.get_variant_seeds(
            g, g.color_for_sample("ref"),
            {g.color_for_sample("mom"), g.color_for_sample("dad")},
            {g.color_for_sample("mom_draft")}, refs))
    assert out[1] == out[0] == []


# ---- test_bam_index.py -------------------------------------------------------------

def _make_bams(tmp_path, reads):
    """The same reads written by both packages; the bytes must be equal."""
    paths = []
    for name, bamio in (("jax", jbam), ("torch", tbam)):
        (tmp_path / name).mkdir(exist_ok=True)
        p = tmp_path / name / "reads.bam"
        bamio.write_bam(p, [("chr1", 10000)],
                        [{"name": f"r{i}", "seq": s} for i, s in enumerate(reads)])
        paths.append(p)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    return paths


def test_bam_roundtrip(tmp_path):
    rng = np.random.default_rng(91)
    reads = [_genome(rng, 80) for _ in range(50)]
    jp, tp = _make_bams(tmp_path, reads)
    jr, tr = jbam.BamReader(jp), tbam.BamReader(tp)
    assert tr.refs == jr.refs == ["chr1"]
    got = [(vo, rec["name"], rec["seq"]) for vo, _, rec in tr]
    assert got == [(vo, rec["name"], rec["seq"]) for vo, _, rec in jr]
    assert [(n, s) for _, n, s in got] == [(f"r{i}", s) for i, s in enumerate(reads)]


def test_bam_record_at(tmp_path):
    rng = np.random.default_rng(92)
    _, tp = _make_bams(tmp_path, [_genome(rng, 60) for _ in range(30)])
    offsets = [(vo, rec["name"]) for vo, _, rec in tbam.BamReader(tp)]
    jr, tr = jbam.BamReader(tp), tbam.BamReader(tp)
    for vo, name in offsets[::7]:
        assert tr.record_at(vo) == jr.record_at(vo)
        assert tr.record_at(vo)["name"] == name


def test_kmer_index_query(tmp_path):
    rng = np.random.default_rng(93)
    genome = _genome(rng, 500)
    reads = [genome[i:i + 60] for i in range(0, 440, 20)]
    jp, tp = _make_bams(tmp_path, reads)
    k = 21
    assert os.path.basename(tki.index_bam(tp, k)) == os.path.basename(jki.index_bam(jp, k))
    assert open(tki.index_path(str(tp), k), "rb").read() == \
        open(jki.index_path(str(jp), k), "rb").read()
    jidx, tidx = jki.KmerIndexFile(jp, k), tki.KmerIndexFile(tp, k)
    assert len(tidx) == len(jidx) > 0
    for sk in (reads[5][10:10 + k], "T" * k, reads[9][30:30 + k]):
        assert tidx.find(sk) == jidx.find(sk)
        assert tidx.query_reads(sk) == jidx.query_reads(sk)
    assert any(rec["seq"] == reads[5] for rec in tidx.query_reads(reads[5][10:10 + k]))


def test_assembly_quality():
    rng = np.random.default_rng(94)
    truth_seq = _genome(rng, 2000)
    eval_seq = list(truth_seq)
    for pos in (500, 1500):
        eval_seq[pos] = "ACGT"[("ACGT".index(eval_seq[pos]) + 1) % 4]
    eval_seq = "".join(eval_seq)
    je, te = both_graphs({"eval": [eval_seq]}, 21)
    jc, tc = both_graphs({"truth": [truth_seq]}, 21)
    got = tq.compute_assembly_quality(te, tc, TRef({"chr1": eval_seq}))
    assert got == jq.compute_assembly_quality(je, jc, JRef({"chr1": eval_seq}))
    assert 20 < got < 40
    assert tq.compute_assembly_quality(tc, tc, TRef({"c": truth_seq})) == float("inf")


# ---- test_utils.py ------------------------------------------------------------------

def test_statistics_on_stream():
    xs = [2.0, 4.0, 4.0, 4.0, 5.0, 5.0, 7.0, 9.0]
    got, want = tst.StatisticsOnStream(), jst.StatisticsOnStream()
    for x in xs:
        got.push(x)
        want.push(x)
    assert (got.n, got.mean(), got.variance(), got.stdev()) == \
        (want.n, want.mean(), want.variance(), want.stdev())
    assert abs(got.variance() - np.var(xs, ddof=1)) < 1e-12


def test_empirical_distribution():
    got = tst.EmpiricalDistribution([0, 0, 1, 1], np.random.default_rng(0))
    want = jst.EmpiricalDistribution([0, 0, 1, 1], np.random.default_rng(0))
    draws = [got.draw() for _ in range(200)]
    assert draws == [want.draw() for _ in range(200)]
    assert set(draws) <= {2, 3} and got.mean() == want.mean()


def test_n50():
    for lengths in ([2, 2, 2, 3, 3, 4, 8, 8], [10]):
        assert tst.n50(lengths) == jst.n50(lengths)
        assert tst.ng50(lengths, 30) == jst.ng50(lengths, 30)
    assert tst.n50([2, 2, 2, 3, 3, 4, 8, 8]) == 8


def test_pca_identifies_variance_axis():
    rng = np.random.default_rng(1)
    t = rng.normal(size=200)
    x = np.stack([t * 3, t * 3 + rng.normal(scale=0.01, size=200),
                  rng.normal(scale=0.01, size=200)], axis=1)
    got, want = tst.PCA(x), jst.PCA(x)
    np.testing.assert_array_equal(got.explained_variance_ratio, want.explained_variance_ratio)
    np.testing.assert_array_equal(got.transform(x), want.transform(x))
    assert got.explained_variance_ratio[0] > 0.95


def test_gff3(tmp_path):
    p = tmp_path / "t.gff3"
    p.write_text("##gff-version 3\n"
                 "chr1\tsrc\tgene\t100\t500\t.\t+\t.\tID=g1;Name=geneA\n"
                 "chr1\tsrc\texon\t100\t200\t.\t+\t.\tParent=g1\n"
                 "chr2\tsrc\tgene\t50\t80\t.\t-\t.\tID=g2\n")
    got, want = tgff.GFF3(p), jgff.GFF3(p)
    assert [vars(r) for r in got] == [vars(r) for r in want] and len(got) == 3
    for query in (("get_type", "gene"), ("get_contained", "chr1", 1, 300),
                  ("get_overlapping", "chr1", 150, 160)):
        assert [vars(r) for r in getattr(got, query[0])(*query[1:])] == \
            [vars(r) for r in getattr(want, query[0])(*query[1:])]
    assert got.get_type("gene")[0].get_attribute("Name") == "geneA"


def test_table_roundtrip(tmp_path):
    for name, tbl in (("jax", jtbl), ("torch", ttbl)):
        w = tbl.TableWriter(tmp_path / f"{name}.tsv")
        w.add_entry({"a": 1, "b": "x"})
        w.add_entry({"a": 2, "b": "y"})
        w.close()
    assert (tmp_path / "torch.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    rows = list(ttbl.TableReader(tmp_path / "jax.tsv"))
    assert rows == list(jtbl.TableReader(tmp_path / "jax.tsv"))
    assert rows == [{"a": "1", "b": "x"}, {"a": "2", "b": "y"}]
    p2 = tmp_path / "t2.tsv"
    p2.write_text("1\tx\n2\ty\n")
    assert list(ttbl.TableReader(p2, columns=["a", "b"])) == \
        list(jtbl.TableReader(p2, columns=["a", "b"]))


def test_gfa_export(tmp_path):
    jg, tg = both_graphs({"s": ["AGTTCTGATCTGGG"]}, 5)
    contigs = {"u1": "AGTTCTGATC", "u2": "GATCTGGG"}
    jgfa.write_gfa1(tmp_path / "j.gfa", jg, contigs, "s")
    tgfa.write_gfa1(tmp_path / "t.gfa", tg, contigs, "s")
    text = (tmp_path / "t.gfa").read_text()
    assert text == (tmp_path / "j.gfa").read_text()
    assert any(line.startswith("L\tu1\t+\tu2\t+") for line in text.splitlines())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return r.read()


def test_visualizer_serves_subgraph():
    """Both packages' servers (each on its own ephemeral port) serve the
    same subgraph JSON and page, and take the same POST."""
    served = []
    for fix, viz, config, engine, stopper in (
            (jfix, jviz, JConfig, JEngine, JStopper), (tfix, tviz, TConfig, TEngine, TStopper)):
        g = fix.build_graph({"s": ["AGTTCTGATCTGGG"]}, 5)
        sub = engine(config(graph=g, traversal_colors=[0], stopping_rule=stopper)).dfs("TTCTG")
        v = viz.GraphVisualizer(port=0)
        try:
            v.display(sub, "test")
            graph, page = _get(v.port, "/graph"), _get(v.port, "/")
            body = json.dumps({"vertices": [{"id": 0, "kmer": "AAAAA"}], "edges": []}).encode()
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{v.port}/post", data=body, method="POST"))
            served.append((graph, page, _get(v.port, "/graph")))
        finally:
            v.shutdown()
    assert served[1] == served[0]
    assert len(json.loads(served[1][0])["vertices"]) == sub.num_vertices()
    assert b"corticall_tpu" in served[1][1]


def test_visualizer_search_and_stats():
    served = []
    for fix, core, viz in ((jfix, jcore, jviz), (tfix, tcore, tviz)):
        g = fix.build_graph({"kid": ["AGTTCTGATCTGGGA"], "mom": ["AGTTCTGATCTGGGA"]}, 5)
        v = viz.GraphVisualizer(port=0, graph=g, rois=core.find_rois(g, "kid", ["mom"]))
        try:
            stats = json.loads(_get(v.port, "/stats"))
            search = json.loads(_get(v.port, "/search?kmer=TTCTG&radius=8"))
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(v.port, "/search?kmer=NNNNN")
            served.append((stats, search, err.value.code))
        finally:
            v.shutdown()
    assert served[1] == served[0]
    stats, search, code = served[1]
    assert stats["samples"] == ["kid", "mom"] and search["vertices"] and code == 400
