"""Final inventory ports: feature tables, simulation/inheritance reporting.

Covers CompileFeatureTable (prefilter/), CompareContigLengths and
ComputeKmerPairMatrix (discover/eval/), EvaluateROIs (simulate/), and the
inheritance track converters (inheritance/InheritanceTo*, VCFToInheritanceTrack).
"""

from __future__ import annotations

from .. import graph as gr
from .. import kmer as km
from ..utils.statistics import StatisticsOnStream
from .core import compression_ratio


def compile_feature_table(graph: gr.CortexGraph, rois: gr.CortexGraph,
                          features: dict, contigs: list,
                          rois_truth: gr.CortexGraph) -> list:
    """Per-novel-kmer feature rows for FDR modelling (CompileFeatureTable.java).

    features: {name: CortexGraph of excluded kmers}; contigs: [(header, seq)].
    """
    color = graph.color_for_sample(rois.sample_name(0))
    k = rois.kmer_size

    sos = StatisticsOnStream()
    for cov in graph.coverages[:, color]:
        sos.push(float(cov))
    mean, sd = sos.mean(), sos.stdev() or 1.0

    truth = {rois_truth.kmer_string(i) for i in range(rois_truth.num_records)}

    table: dict = {}
    for i in range(rois.num_records):
        ck = rois.kmer_string(i)
        table[ck] = {"covZScore": (float(rois.coverages[i, 0]) - mean) / sd}

    for header, seq in contigs:
        name = header.split(" ")[0]
        novel_here = []
        entry = {}
        for i in range(len(seq) - k + 1):
            sk = seq[i:i + k]
            ck = min(sk, km.revcomp(sk))
            if ck in table:
                dist = min(i, len(seq) - k - i)
                entry = {"partitionName": name, "partitionLength": len(seq),
                         "distanceFromTerminus": dist,
                         "compressionRatio": compression_ratio(ck)}
                novel_here.append(ck)
        for ck in novel_here:
            if len(novel_here) > table[ck].get("numNovelsInPartition", 0):
                table[ck].update(entry)
                table[ck]["numNovelsInPartition"] = len(novel_here)

    feature_sets = {name: {g.kmer_string(i) for i in range(g.num_records)}
                    for name, g in features.items()}
    rows = []
    for ck, entry in table.items():
        row = {
            "ck": ck,
            "partitionName": str(entry.get("partitionName", "unknown")),
            "partitionLength": str(entry.get("partitionLength", 0)),
            "numNovelsInPartition": str(entry.get("numNovelsInPartition", 0)),
            "distanceFromTerminus": str(entry.get("distanceFromTerminus", 0)),
            "compressionRatio": str(entry.get("compressionRatio", 1.0)),
        }
        for name in features:
            row[name] = "1" if ck in feature_sets[name] else "0"
        row["truth"] = "1" if ck in truth else "0"
        row["covZScore"] = f"{entry['covZScore']:.4f}"
        rows.append(row)
    return rows


def evaluate_rois(rois: gr.CortexGraph, truth_kmer_rows: list) -> dict:
    """Found-vs-simulated novel kmer concordance (simulate/EvaluateROIs.java)."""
    truth = {min(r["kmer"], km.revcomp(r["kmer"])) for r in truth_kmer_rows}
    found = {rois.kmer_string(i) for i in range(rois.num_records)}
    return {
        "truth": len(truth), "found": len(found),
        "tp": len(truth & found), "fn": len(truth - found),
        "fp": len(found - truth),
    }


def compare_contig_lengths(variant_rows: list, kmer_rows: list,
                           fastas: dict) -> list:
    """Per-novel-kmer contig lengths across assemblies keyed by the seed=
    header token (CompareContigLengths.java)."""
    ids = {str(r["index"]): r["type"] for r in variant_rows
           if r.get("type") != "RECOMB"}
    entries: dict = {}
    for r in kmer_rows:
        ck = min(r["kmer"], km.revcomp(r["kmer"]))
        entries[ck] = {"num": r.get("numNovel", r.get("length", "")),
                       "type": ids.get(str(r["index"])), "lengths": {}}

    for key, seqs in fastas.items():
        for header, seq in seqs:
            for tok in header.split(" "):
                if tok.startswith("seed="):
                    ck = min(tok[5:], km.revcomp(tok[5:]))
                    if ck in entries:
                        entries[ck]["lengths"][key] = len(seq)

    keys = sorted(fastas)
    rows = [["kmer", "id", "type"] + keys]
    for ck, e in entries.items():
        rows.append([ck, str(e["num"]), str(e["type"])]
                    + [str(e["lengths"].get(kk)) for kk in keys])
    return rows


def compute_kmer_pair_matrix(kmer_rows: list, contigs: list) -> list:
    """Same-variant adjacency matrix of novel kmers observed co-occurring on
    contigs (ComputeKmerPairMatrix.java)."""
    ids: dict = {}
    index: dict = {}
    for r in kmer_rows:
        ck = min(r["kmer"], km.revcomp(r["kmer"]))
        if ck not in index:
            ids[ck] = str(r["index"])
            index[ck] = len(index)
    n = len(index)
    m = [[0] * n for _ in range(n)]
    if not kmer_rows:
        return m
    k = len(next(iter(index)))
    for _, seq in contigs:
        cks = []
        for i in range(len(seq) - k + 1):
            sk = seq[i:i + k]
            ck = min(sk, km.revcomp(sk))
            if ck in index:
                cks.append(ck)
        for a in cks:
            for b in cks:
                same = 1 if ids[a] == ids[b] else -1
                m[index[a]][index[b]] = same
                m[index[b]][index[a]] = same
    return m


def inheritance_to_matrix(rows: list, children: list) -> list:
    """Inheritance table -> site x child parent-assignment matrix
    (InheritanceToMatrix.java equivalent)."""
    out = [["chrom", "pos"] + list(children)]
    for row in rows:
        r = [row["chrom"], row["pos"]]
        for c in children:
            val = row.get(c, ".")
            r.append(val.split(":")[0] if ":" in str(val) else str(val))
        out.append(r)
    return out


def inheritance_to_circos_tracks(rows: list, children: list) -> dict:
    """Per-child circos-style track lines: 'chrom start end parent'
    (InheritanceToCircosTracks.java equivalent)."""
    tracks: dict = {c: [] for c in children}
    for row in rows:
        pos = int(row["pos"])
        for c in children:
            val = str(row.get(c, ""))
            if ":" in val:
                parent = val.split(":")[0]
                tracks[c].append(f"{row['chrom']} {pos} {pos + 1} {parent}")
    return tracks


def annotate_calls(vcf_rows: list, accessory_bed: list, genes, repeats,
                   partitions: list, rois: gr.CortexGraph) -> list:
    """Post-hoc call annotation (discover/call/AnnotateCalls.java): label
    core/accessory, overlapping + closest genes, repeat overlap, partition
    length and novel-kmer count.  Returns annotated VCF rows (info updated).

    accessory_bed: [(chrom, start, end)] 1-based; genes/repeats: GFF3 objects.
    """
    k = rois.kmer_size
    roiset = {rois.kmer_string(i) for i in range(rois.num_records)}
    part_seqs = {h.split(" ")[0]: s for h, s in partitions}

    gene_records = [r for r in genes if "gene" in r.type] if genes else []
    repeat_records = list(repeats) if repeats else []

    out = []
    for v in vcf_rows:
        chrom, start = v["chrom"], v["pos"]
        end = start + len(v["ref"]) - 1
        info = dict(v["info"])

        label = "core"
        for bc, bs, be in accessory_bed:
            if bc == chrom and bs <= end and be >= start:
                label = "accessory"
                break
        info["REGION"] = label

        overlapping = sorted(r.get_attribute("ID", "") for r in gene_records
                             if r.seqid == chrom and r.start <= end and r.end >= start)
        if overlapping:
            info["GENES"] = ",".join(x for x in overlapping if x)

        nearby = [r for r in gene_records
                  if r.seqid == chrom and r.start <= end + 100000
                  and r.end >= start - 100000]
        if nearby:
            nearest = min(nearby, key=lambda r: abs(r.start - start))
            info["CLOSEST_GENE"] = nearest.get_attribute("ID", "")

        reps = [r.get_attribute("ID", "") for r in repeat_records
                if r.seqid == chrom and r.start <= end and r.end >= start]
        info["REPEAT"] = reps[0] if reps else "NA"

        pname = info.get("PARTITION_NAME", "")
        if pname in part_seqs:
            seq = part_seqs[pname]
            info["PARTITION_LENGTH"] = len(seq)
            info["PARTITION_NOVELS"] = sum(
                1 for i in range(len(seq) - k + 1)
                if min(seq[i:i + k], km.revcomp(seq[i:i + k])) in roiset)

        nv = dict(v)
        nv["info"] = info
        out.append(nv)
    return out


def show_novel_kmers(contigs: list, rois: gr.CortexGraph,
                     graph: gr.CortexGraph) -> list:
    """Per-contig-kmer novelty/record listing (discover/call/
    ShowNovelKmers.java:21-35): for every kmer of every contig, whether it is
    an ROI and its graph record string.  Returns text lines."""
    k = rois.kmer_size
    out = []
    for header, seq in contigs:
        out.append(header.split(" ")[0])
        n = len(seq) - k
        for i in range(n + 1):
            sk = seq[i:i + k]
            in_roi = rois.find_record(sk) >= 0
            rec = graph.find_record(sk)
            rec_str = graph.record_string(rec) if rec >= 0 else "null"
            out.append(f"{i}/{n} {sk} {in_roi} {rec_str}")
    return out


def explore(graph: gr.CortexGraph, links_list: list, sample: str,
            begin: str, end: str) -> str:
    """utils/Explore.java:38-72 equivalent: DestinationStopper DFS between
    two kmers in one sample's color (the reference hardcodes sample "3D7"
    and ships its output block commented out; here the walk contig is
    actually emitted).  Returns the walked contig ('' if unreachable)."""
    from ..traversal.engine import (TraversalConfig, TraversalEngine, BOTH,
                                    OR)
    from ..traversal.stopping import DestinationStopper
    from ..traversal.utils import to_contig, to_walk

    color = graph.color_for_sample(sample)
    e = TraversalEngine(TraversalConfig(
        graph=graph, traversal_colors=[color], direction=BOTH,
        combination=OR, stopping_rule=DestinationStopper,
        links=list(links_list)))
    g = e.dfs(begin, end)
    if g is None:
        g = e.dfs(end, begin)
    if g is None:
        return ""
    w = to_walk(g, begin, color, graph=graph)
    return to_contig(w) if w else ""


def vcf_to_inheritance_track(vcf_rows: list, attribute: str = "BACKGROUND") -> list:
    """VCF -> 'chrom pos parent' inheritance track (VCFToInheritanceTrack.java)."""
    return [f"{v['chrom']} {v['pos']} {v['info'].get(attribute, 'unknown')}"
            for v in vcf_rows]
