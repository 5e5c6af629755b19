"""The port's command line (corticall_tpu_torch/commands/cli.py) against the
JAX package's: the same subcommands and flags (the port adds the top-level
--device), and every command, one case a command, run in-process by both
`main`s on the same inputs, writing the same bytes, printing the same
output and returning the same code (the port with `--device cpu`).  Also
`python -m corticall_tpu_torch` in a process where jax and corticall_tpu
cannot be imported, and the device rule: a kernel command with no card and
no --device raises RuntimeError, a host command runs."""

import argparse
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu_torch import fixtures as tfix, simulate as tsim  # noqa: E402
from corticall_tpu_torch.caller.variants import write_vcf  # noqa: E402
from corticall_tpu_torch.commands import cli as tcli, core as tcore  # noqa: E402
from corticall_tpu_torch.io import bam as tbam, fasta as tfa  # noqa: E402
from corticall_tpu_torch.pipeline import run_pipeline  # noqa: E402
from corticall_tpu_torch.visualizer import GraphVisualizer  # noqa: E402
from test_torch_pipeline import make_trio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 21
NO_CUDA = "no CUDA device is available"


def _jax_cli():
    pytest.importorskip("jax")
    from corticall_tpu.commands import cli as jcli
    return jcli


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


# ---- inputs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every file the commands read: the port's pipeline run over
    tests/test_torch_pipeline.py's trio (its graphs, links, ROIs,
    partitions and VCFs), the references and kid reads as FASTA, a BAM of
    kid reads, a simulated child with its tables and truth VCF, a pedigree
    graph for ComputeInheritance, a GFF, a BED and an inheritance table."""
    d = tmp_path_factory.mktemp("cli_inputs")
    reads, refs = make_trio()
    wd = d / "wd"
    run_pipeline(str(wd), reads, "kid", ["mom", "dad"], references=refs, k=K,
                 min_coverage=2, device="cpu")
    p = {name: str(wd / name) for name in os.listdir(wd)}
    for name, ir in refs.items():
        p[f"{name}.fa"] = str(d / f"{name}.fa")
        tfa.write_fasta(p[f"{name}.fa"], ir.seqs)
    p["kid_reads.fa"] = str(d / "kid_reads.fa")
    tfa.write_fasta(p["kid_reads.fa"], {f"r{i}": s for i, s in enumerate(reads["kid"][:400])})
    p["reads.bam"] = str(d / "reads.bam")
    tbam.write_bam(p["reads.bam"], [("chr1", 10000)],
                   [{"name": f"r{i}", "seq": s} for i, s in enumerate(reads["kid"][:120])])
    parent = refs["mom"].seqs["chr1"]
    p["begin"], p["end"], p["kmer"] = parent[100:100 + K], parent[160:160 + K], parent[300:300 + K]

    rng = np.random.default_rng(91)
    ref1, ref2 = {"a": _genome(rng, 1500)}, {"b": _genome(rng, 1500)}
    for name, seqs in (("ref1.fa", ref1), ("ref2.fa", ref2)):
        p[name] = str(d / name)
        tfa.write_fasta(p[name], seqs)
    res = tsim.simulate_haploid_child(ref1, ref2, parents=("p1", "p2"), mu=1.0,
                                      num_variants=3, k=K, seed=5)
    p["sim_variants.tsv"], p["sim_kmers.tsv"] = str(d / "sim_variants.tsv"), str(d / "sim_kmers.tsv")
    tsim.write_tables(res, p["sim_variants.tsv"], p["sim_kmers.tsv"])
    p["truth.vcf"] = str(d / "truth.vcf")
    write_vcf(p["truth.vcf"], res["truth_vcf"],
              [(n, len(s)) for n, s in list(ref1.items()) + list(ref2.items())])
    p["ref12.fa"] = str(d / "ref12.fa")
    tfa.write_fasta(p["ref12.fa"], {**ref1, **ref2})

    base = _genome(rng, 900)
    dad = base[:450] + "ACGT"[("ACGT".index(base[450]) + 1) % 4] + base[451:]
    g = tfix.build_graph({"kid": [base], "mom": [base], "dad": [dad], "mom_draft": [base],
                          "dad_draft": [dad], "ref": [dad]}, K)
    p["pedigree.ctx"] = str(d / "pedigree.ctx")
    g.save(p["pedigree.ctx"])
    for name, seq in (("mom_draft", base), ("dad_draft", dad), ("ref", dad)):
        p[f"{name}.fa"] = str(d / f"{name}.fa")
        tfa.write_fasta(p[f"{name}.fa"], {f"{name}_chr": seq})

    # a trio for the prefilters (tests/test_commands.py's shapes): the kid
    # has a SNP, a low-complexity insertion, a dead-end novel tail, a
    # floating fragment part of which a sibling shares, and a novel k-mer of
    # three predecessors and three successors (FindDust's degree)
    parent = _genome(rng, 1200)
    floating = _genome(rng, 120)
    dust = _genome(rng, K)
    snp = "ACGT"[("ACGT".index(parent[400]) + 1) % 4]
    kid = [parent[:400] + snp + parent[401:800] + "AC" * 15 + parent[800:], floating,
           parent[:300] + _genome(rng, 40)] + [b + dust + b for b in "ACG"]
    g = tfix.build_graph({"kid": kid, "mom": [parent], "dad": [parent],
                          "sib": [floating[:60]]}, K)
    p["pf.ctx"], p["pf_rois.ctx"], p["pf_mom.fa"] = (str(d / n) for n in
                                                     ("pf.ctx", "pf_rois.ctx", "pf_mom.fa"))
    g.save(p["pf.ctx"])
    tcore.find_rois(g, "kid", ["mom", "dad"]).save(p["pf_rois.ctx"])
    tfa.write_fasta(p["pf_mom.fa"], {"chr1": parent})

    p["genes.gff"] = str(d / "genes.gff")
    with open(p["genes.gff"], "w") as f:
        f.write("##gff-version 3\n"
                "chr1\ts\tgene\t1000\t2500\t.\t+\t.\tID=gene1\n"
                "chr1\ts\tgene\t3000\t3400\t.\t-\t.\tID=gene2\n")
    p["repeats.gff"] = str(d / "repeats.gff")
    with open(p["repeats.gff"], "w") as f:
        f.write("chr1\ts\trepeat\t1950\t2050\t.\t+\t.\tID=rep1\n")
    p["accessory.bed"] = str(d / "accessory.bed")
    with open(p["accessory.bed"], "w") as f:
        f.write("chr1\t1900\t2100\n")
    p["inheritance.tsv"] = str(d / "inheritance.tsv")
    with open(p["inheritance.tsv"], "w") as f:
        f.write("chrom\tpos\tkidA\tkidB\nc1\t100\tmomref:5\tdadref:7\n"
                "c1\t250\tdadref:2\tdadref:9\n")
    return p


# ---- the commands, one case each --------------------------------------------

def _links(i):
    return [a for s in ("kid", "mom", "dad") for a in ("-l", i[f"{s}.ctp.bgz"])]


def _copied(i, name, d):
    """A copy of input `name` in the run's directory (commands that write
    beside their input)."""
    dst = os.path.join(d, os.path.basename(i[name]))
    shutil.copy(i[name], dst)
    return dst


def _pf(i):
    """The prefilter trio's graph, ROIs and parents."""
    return ["-g", i["pf.ctx"], "-r", i["pf_rois.ctx"], "-p", "mom", "-p", "dad"]


CASES = {
    "Join": lambda i, d: ["Join", "-g", i["kid.clean.ctx"], "-g", i["mom.clean.ctx"],
                          "-o", f"{d}/out.ctx"],
    "Remove": lambda i, d: ["Remove", "-g", i["joined.ctx"], "-s", i["mom.clean.ctx"],
                            "-o", f"{d}/out.ctx"],
    "FindROIs": lambda i, d: ["FindROIs", "-g", i["joined.ctx"], "-p", "mom", "-p", "dad",
                              "-c", "kid", "-o", f"{d}/out.ctx"],
    "FindLowCoverage": lambda i, d: ["FindLowCoverage", "-r", i["rois.ctx"], "-m", "40",
                                     "-o", f"{d}/out.ctx"],
    "FindDust": lambda i, d: ["FindDust", *_pf(i), "-o", f"{d}/out.ctx"],
    "FindLowComplexity": lambda i, d: ["FindLowComplexity", *_pf(i), "-t", "1.6",
                                       "-o", f"{d}/out.ctx"],
    "FindShared": lambda i, d: ["FindShared", *_pf(i), "-o", f"{d}/out.ctx"],
    "FindTips": lambda i, d: ["FindTips", *_pf(i), "-o", f"{d}/out.ctx"],
    "FindOrphans": lambda i, d: ["FindOrphans", *_pf(i), "-o", f"{d}/out.ctx"],
    "Partition": lambda i, d: ["Partition", "-g", i["joined.ctx"], "-r", i["rois.filtered.ctx"],
                               *_links(i), "-o", f"{d}/out.fa"],
    "View": lambda i, d: ["View", "-g", i["rois.ctx"], "-r", i["begin"] + i["end"]],
    "Head": lambda i, d: ["Head", "-g", i["joined.ctx"], "-n", "7"],
    "Tail": lambda i, d: ["Tail", "-g", i["joined.ctx"], "-n", "7", "-o", f"{d}/out.txt"],
    "CovStats": lambda i, d: ["CovStats", "-g", i["joined.ctx"]],
    "Sort": lambda i, d: ["Sort", "-g", i["joined.ctx"], "-o", f"{d}/out.ctx"],
    "IndexLinks": lambda i, d: ["IndexLinks", "-l", i["kid.ctp.bgz"], "-s", "kid.reads",
                                "-o", f"{d}/out.ctp.bgz"],
    "IndexReference": lambda i, d: ["IndexReference", "-r", _copied(i, "mom.fa", d),
                                    "-s", "mom", "-s", "dad"],
    "FindUnanchored": lambda i, d: ["FindUnanchored", *_pf(i), "-d", f"mom:{i['pf_mom.fa']}",
                                    "-o", f"{d}/out.ctx"],
    "FindContamination": lambda i, d: ["FindContamination", "-g", i["joined.ctx"], "-r",
                                       i["rois.ctx"], "-p", "mom", "-p", "dad",
                                       "-contam", i["rois.filtered.ctx"], *_links(i), "-d",
                                       f"mom:{i['mom.fa']}", "-o", f"{d}/out.ctx"],
    "Build": lambda i, d: ["Build", "-1", i["kid_reads.fa"], "-k", str(K), "-s", "kid",
                           "-o", f"{d}/out.ctx"],
    "Clean": lambda i, d: ["Clean", "-g", i["joined.ctx"], "-m", "3", "-o", f"{d}/out.ctx"],
    "InferEdges": lambda i, d: ["InferEdges", "-g", i["joined.ctx"], "-o", f"{d}/out.ctx"],
    "Thread": lambda i, d: ["Thread", "-g", i["kid.clean.ctx"], "-1", i["kid_reads.fa"],
                            "-o", f"{d}/out.ctp.gz"],
    "AnnotateCalls": lambda i, d: ["AnnotateCalls", "-v", i["calls.vcf"], "-a",
                                   i["accessory.bed"], "-gff", i["genes.gff"], "-rm",
                                   i["repeats.gff"], "-p", i["partitions.trimmed.fa"],
                                   "-r", i["rois.filtered.ctx"], "-o", f"{d}/out.vcf"],
    "VisualCortex": lambda i, d: ["VisualCortex", "-g", i["joined.ctx"], "-r", i["rois.ctx"],
                                  "-s", i["kmer"], "--radius", "6", "--once"],
    "Explore": lambda i, d: ["Explore", "-g", i["joined.ctx"], *_links(i)[:2], "-s", "kid",
                             "-b", i["begin"], "-e", i["end"]],
    "SimulateRecombBetweenVars": lambda i, d: ["SimulateRecombBetweenVars",
                                               "-o", f"{d}/out.txt"],
    "ShowNovelKmers": lambda i, d: ["ShowNovelKmers", "-c", i["partitions.fa"],
                                    "-r", i["rois.ctx"], "-g", i["joined.ctx"]],
    "CompileFeatureTable": lambda i, d: ["CompileFeatureTable", "-g", i["joined.ctx"],
                                         "-r", i["rois.ctx"], "-f",
                                         f"kept:{i['rois.filtered.ctx']}", "-c",
                                         i["partitions.fa"], "-rt", i["rois.filtered.ctx"],
                                         "-o", f"{d}/out.tsv"],
    "EvaluateROIs": lambda i, d: ["EvaluateROIs", "-r", i["rois.ctx"], "-k", i["sim_kmers.tsv"]],
    "InheritanceToMatrix": lambda i, d: ["InheritanceToMatrix", "-t", i["inheritance.tsv"],
                                         "-c", "kidA", "-c", "kidB"],
    "InheritanceToCircosTracks": lambda i, d: ["InheritanceToCircosTracks", "-t",
                                               i["inheritance.tsv"], "-c", "kidA", "-c",
                                               "kidB", "-o", f"{d}/circos"],
    "VCFToInheritanceTrack": lambda i, d: ["VCFToInheritanceTrack", "-v", i["calls.vcf"]],
    "IndexBam": lambda i, d: ["IndexBam", "-b", _copied(i, "reads.bam", d), "-k", str(K)],
    "QueryIndex": lambda i, d: ["QueryIndex", "-b", _indexed_bam(i, d), "-k", str(K),
                                "-s", i["kmer"]],
    "PrintIndex": lambda i, d: ["PrintIndex", "-b", _indexed_bam(i, d), "-k", str(K),
                                "-o", f"{d}/out.txt"],
    "CollectReads": lambda i, d: ["CollectReads", "-b", _indexed_bam(i, d),
                                  "-r", i["rois.ctx"], "-o", f"{d}/out.fa"],
    "ComputeAssemblyQuality": lambda i, d: ["ComputeAssemblyQuality", "-e",
                                            i["mom.clean.ctx"], "-c", i["dad.clean.ctx"],
                                            "-r", i["mom.fa"]],
    "Range": lambda i, d: ["Range", "-g", i["joined.ctx"], "-s", "5", "-e", "40"],
    "RecoverExcludedKmers": lambda i, d: ["RecoverExcludedKmers", "-g", i["joined.ctx"],
                                          "-d", i["kid.clean.ctx"], "-o", f"{d}/out.ctx"],
    "CompareROIs": lambda i, d: ["CompareROIs", "-t", i["rois.ctx"], "-e",
                                 i["rois.filtered.ctx"]],
    "CombineContigs": lambda i, d: ["CombineContigs", "-c", i["partitions.trimmed.fa"],
                                    "-p", i["partitions.fa"], "-r", i["rois.ctx"]],
    "FilterPartitions": lambda i, d: ["FilterPartitions", "-c", i["partitions.fa"],
                                      "-r", i["rois.ctx"], "-nt", "3", "-o", f"{d}/out.fa"],
    "AlignContigs": lambda i, d: ["AlignContigs", "-c", i["partitions.trimmed.fa"],
                                  "-R", f"mom:{i['mom.fa']}", "-R", f"dad:{i['dad.fa']}",
                                  "-o", f"{d}/out.tsv"],
    "FilterCalls": lambda i, d: ["FilterCalls", "-v", i["calls.vcf"], "-R",
                                 f"mom:{i['mom.fa']}", "-m", "3", "-o", f"{d}/out.vcf"],
    "Coverage": lambda i, d: ["Coverage", "-g", i["joined.ctx"], "-c",
                              i["partitions.trimmed.fa"], "-s", "kid"],
    "SimToVCF": lambda i, d: ["SimToVCF", "-s", i["sim_variants.tsv"], "-b",
                              f"p1:{i['ref1.fa']}", "-b", f"p2:{i['ref2.fa']}",
                              "-o", f"{d}/out.vcf"],
    "ToGfa1": lambda i, d: ["ToGfa1", "-g", i["joined.ctx"], "-f", i["partitions.fa"],
                            "-s", "kid", "-o", f"{d}/out.gfa"],
    "VCFToKmers": lambda i, d: ["VCFToKmers", "-v", i["truth.vcf"], "-R", i["ref12.fa"],
                                "-k", str(K)],
    "EvaluateCalls": lambda i, d: ["EvaluateCalls", "-t", i["truth.vcf"], "-c",
                                   i["truth.vcf"], "-R", i["ref12.fa"], "-k", str(K)],
    "TrimPartitions": lambda i, d: ["TrimPartitions", "-p", i["partitions.fa"],
                                    "-r", i["rois.ctx"], "-m", "100"],
    "CountNovelKmersInPartitions": lambda i, d: ["CountNovelKmersInPartitions", "-c",
                                                 i["partitions.fa"], "-r", i["rois.ctx"]],
    "ComputeInheritance": lambda i, d: ["ComputeInheritance", "-g", i["pedigree.ctx"],
                                        "-r", f"mom_draft:{i['mom_draft.fa']}",
                                        "-r", f"dad_draft:{i['dad_draft.fa']}",
                                        "-r", f"ref:{i['ref.fa']}", "-p", "mom_draft:mom",
                                        "-p", "dad_draft:dad", "-c", "kid", "-rn", "ref"],
    "SimulateHaploidChild": lambda i, d: ["SimulateHaploidChild", "-r1", i["ref1.fa"],
                                          "-r2", i["ref2.fa"], "-v", "2", "-k", str(K),
                                          "-s", "3", "-o", f"{d}/child.fa", "-vo",
                                          f"{d}/variants.tsv", "-ko", f"{d}/kmers.tsv",
                                          "-to", f"{d}/truth.vcf"],
    "Call": lambda i, d: ["Call", "-g", i["joined.ctx"], "-r", i["rois.filtered.ctx"],
                          "-p", i["partitions.trimmed.fa"], "-b", "mom", "-b", "dad",
                          "-R", f"mom:{i['mom.fa']}", "-R", f"dad:{i['dad.fa']}",
                          *_links(i), "-l", i["ref_mom.ctp.bgz"], "-l", i["ref_dad.ctp.bgz"],
                          "-o", f"{d}/calls.vcf", "-ao", f"{d}/accounting.txt"],
}
# commands whose stderr is deterministic (a JSON line of counts)
STDERR_SAME = {"AlignContigs", "FilterCalls"}
# SendToVisualizer runs against a server of its own (test below)
SERVER_CASES = {"SendToVisualizer"}


def _indexed_bam(i, d):
    bam = _copied(i, "reads.bam", d)
    from corticall_tpu_torch import kmer_index
    kmer_index.index_bam(bam, K)
    return bam


def _argv(name, i, d):
    return CASES[name](i, d)


def _files(d):
    """{relative path: bytes} of every file under d; a gzip member's header
    time (bytes 4-7, the second it was written) is zeroed."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                data = f.read()
            if n.endswith(".gz"):
                data = data[:4] + bytes(4) + data[8:]
            out[os.path.relpath(path, d)] = data
    return out


def _run(main, argv, capsys):
    code = main(argv)
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def test_every_command_has_a_case():
    jcli = _jax_cli()
    names = set(_subparsers(jcli.build_parser()))
    assert names == set(CASES) | SERVER_CASES


@pytest.mark.parametrize("name", sorted(CASES))
def test_command_matches_jax(name, inputs, tmp_path, capsys):
    jcli = _jax_cli()
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jd.mkdir()
    td.mkdir()
    want = _run(jcli.main, _argv(name, inputs, str(jd)), capsys)
    got = _run(tcli.main, ["--device", "cpu", *_argv(name, inputs, str(td))], capsys)
    assert got[0] == want[0] == 0, got[2][-2000:]
    assert got[1].replace(str(td), str(jd)) == want[1]
    if name in STDERR_SAME:
        assert got[2] == want[2]
    want_files, got_files = _files(jd), _files(td)
    assert sorted(got_files) == sorted(want_files)
    for path, data in want_files.items():
        assert got_files[path] == data, path
    assert want_files or want[1], "the command wrote nothing"


def test_error_exit_codes_match_jax(inputs, tmp_path, capsys):
    """A user-input error (a sample the graph does not have, a missing
    file) is one line and exit code 1 in both."""
    jcli = _jax_cli()
    for argv in (["Explore", "-g", inputs["joined.ctx"], "-s", "nobody",
                  "-b", inputs["begin"], "-e", inputs["end"]],
                 ["View", "-g", str(tmp_path / "missing.ctx")]):
        want = _run(jcli.main, argv, capsys)
        got = _run(tcli.main, ["--device", "cpu", *argv], capsys)
        assert got[0] == want[0] == 1
        assert got[1] == want[1] == ""
        assert got[2] == want[2] and got[2].startswith("error: ")


def test_send_to_visualizer_matches_jax(inputs, capsys):
    """Both CLIs post the same neighbourhood to one running server."""
    jcli = _jax_cli()
    v = GraphVisualizer(port=0)
    try:
        posted = []
        for main, head in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
            code, out, _ = _run(main, [*head, "SendToVisualizer", "-g", inputs["joined.ctx"],
                                       "-s", inputs["kmer"], "-p", str(v.port),
                                       "--radius", "6"], capsys)
            assert code == 0
            posted.append((out, json.dumps(v._payload, sort_keys=True)))
        assert posted[0] == posted[1]
        assert json.loads(posted[0][0])["sent_vertices"] > 0
    finally:
        v.shutdown()


# ---- the parsers --------------------------------------------------------------

def _subparsers(parser):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices
    raise AssertionError("no subcommands")


def _flags(parser):
    return sorted((tuple(a.option_strings), a.dest, repr(a.default), a.required,
                   repr(a.nargs), getattr(a.type, "__name__", None), repr(a.const),
                   type(a).__name__)
                  for a in parser._actions if not isinstance(a, argparse._SubParsersAction))


def test_parsers_have_the_same_commands_and_flags():
    jcli = _jax_cli()
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jsubs, tsubs = _subparsers(jp), _subparsers(tp)
    assert list(tsubs) == list(jsubs)
    for name in jsubs:
        assert _flags(tsubs[name]) == _flags(jsubs[name]), name
        assert tsubs[name].get_default("fn").__name__ == jsubs[name].get_default("fn").__name__
    top = [a for a in _flags(tp) if a[0] not in (("--device",), ("--trace",))]
    assert top == _flags(jp)
    plain = tp.parse_args(["View", "-g", "x"])
    assert plain.device is None and plain.trace is None
    assert tp.parse_args(["--device", "cpu", "View", "-g", "x"]).device == "cpu"
    assert tp.parse_args(["--trace", "t", "View", "-g", "x"]).trace == "t"
    assert tp.prog == "corticall_tpu_torch"


def test_trace_option_writes_the_commands_spans(inputs, tmp_path, capsys):
    """--trace DIR: Call runs inside torch_trace, and DIR's one Chrome trace
    holds Call's stages (SectionTimer's spans, under the breakdown's names)
    as `cpu_op` events, the assembly's chain walks inside the haplotype
    assembly that runs them; the command's output is the untraced run's."""
    from corticall_tpu_torch.utils import profiling
    d, out, plain = (str(tmp_path / x) for x in ("trace", "out", "plain"))
    os.makedirs(out)
    os.makedirs(plain)
    assert tcli.main(["--device", "cpu", "--trace", d, *_argv("Call", inputs, out)]) == 0
    profiling.clear()
    assert tcli.main(["--device", "cpu", *_argv("Call", inputs, plain)]) == 0
    assert _files(out) == _files(plain)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        ops = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "cpu_op"]
    names = {e["name"] for e in ops}
    assert {"host:load_walk", "mixed:assemble_haplotypes", "host:tesserae"} <= names
    outer = [e for e in ops if e["name"] == "mixed:assemble_haplotypes"]
    inner = [e for e in ops if e["name"] == "asm/chain_walks"]
    assert inner and all(any(o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
                             for o in outer) for i in inner)


# ---- the device rule ------------------------------------------------------------

def test_kernel_commands_need_the_card_unless_asked_for_the_cpu(inputs, tmp_path,
                                                               monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    for name in ("Partition", "AlignContigs", "Call"):
        with pytest.raises(RuntimeError, match=NO_CUDA):
            tcli.main(_argv(name, inputs, d))
        assert os.listdir(d) == [], name           # raised before any output
    monkeypatch.setenv("CORTICALL_DEVICE_BUILD", "1")
    with pytest.raises(RuntimeError, match=NO_CUDA):
        tcli.main(_argv("Build", inputs, d))
    assert os.listdir(d) == []
    assert tcli.main(["--device", "cpu", *_argv("Build", inputs, d)]) == 0
    monkeypatch.delenv("CORTICALL_DEVICE_BUILD")
    # a host command never reads --device, and the native build neither
    assert tcli.main(_argv("Head", inputs, d)) == 0
    assert len(capsys.readouterr().out.splitlines()) == 7
    os.makedirs(tmp_path / "native")
    assert tcli.main(_argv("Build", inputs, str(tmp_path / "native"))) == 0
    assert (tmp_path / "native" / "out.ctx").read_bytes() == (tmp_path / "out.ctx").read_bytes()


def test_module_runs_without_jax(inputs, tmp_path):
    """`python -m corticall_tpu_torch`: --help of the program and of every
    subcommand, then AlignContigs, in a process where jax and corticall_tpu
    cannot be imported and no card is visible."""
    argv = _argv("AlignContigs", inputs, str(tmp_path))
    script = textwrap.dedent(f"""
        import contextlib, io, runpy, sys
        sys.modules["jax"] = None
        sys.modules["corticall_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        torch.cuda.is_available = lambda: False
        from corticall_tpu_torch.commands import cli
        names = list(cli.build_parser()._subparsers._group_actions[0].choices)
        for head in [[]] + [[n] for n in names]:
            with contextlib.redirect_stdout(io.StringIO()):
                try:
                    cli.main([*head, "--help"])
                except SystemExit as e:
                    assert e.code == 0, head
        sys.argv = ["corticall_tpu_torch", "--device", "cpu", *{argv!r}]
        try:
            runpy.run_module("corticall_tpu_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not any(n == "jax" or n.startswith(("jax.", "corticall_tpu."))
                       for n, m in sys.modules.items() if m is not None)
        print("OK", len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == f"OK {len(_subparsers(tcli.build_parser()))}"
    assert (tmp_path / "out.tsv").read_text().startswith("#contig\treference")
