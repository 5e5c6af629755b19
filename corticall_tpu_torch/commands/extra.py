"""Remaining command-layer ports: recovery, verification, partition/call
utilities, display helpers (commands/discover/{recover,verify,call,display},
commands/utils/Range, commands/simulate/SimToVCF)."""

from __future__ import annotations

import numpy as np

from .. import graph as gr
from .. import kmer as km
from ..caller.variants import Variant
from ..io import ctx as ctxio


def _roi_set(roi: gr.CortexGraph) -> set:
    return {roi.kmer_string(i) for i in range(roi.num_records)}


def _novel_kmers(seq: str, rois: set, k: int) -> set:
    return {min(seq[i:i + k], km.revcomp(seq[i:i + k]))
            for i in range(len(seq) - k + 1)} & rois


def recover_excluded_kmers(graph: gr.CortexGraph, dirty: gr.CortexGraph) -> gr.CortexGraph:
    """Re-admit child kmers zeroed by cleaning when other samples cover them
    and the dirty (pre-clean) graph did too (RecoverExcludedKmers.java)."""
    child_color = graph.color_for_sample(dirty.sample_name(0))
    cov = graph.coverages
    child_cov = cov[:, child_color]
    others = np.delete(np.arange(graph.num_colors), child_color)
    other_cov = (cov[:, others] > 0).any(axis=1) if len(others) else np.zeros(graph.num_records, bool)

    keep = child_cov > 0
    candidates = np.nonzero(~keep & other_cov)[0]
    didx = dirty.find_records(graph.kmers[candidates]) if len(candidates) else np.zeros(0, int)

    out_mask = keep.copy()
    new_cov = cov.copy()
    recovered = candidates[(didx >= 0)]
    d_hit = didx[didx >= 0]
    if len(recovered):
        dcov = dirty.coverages[d_hit, 0]
        sel = dcov > 0
        recovered = recovered[sel]
        new_cov[recovered, child_color] = dcov[sel]
        out_mask[recovered] = True

    # single-color output named for the child (the reference writes a 1-color
    # header; we slice the child color — the reference's writer quirkily
    # slices color 0, which only matches when the child is color 0)
    header = ctxio.CtxHeader.make([graph.sample_name(child_color)], graph.kmer_size)
    header.colors[0] = graph.header.colors[child_color]
    data = ctxio.CtxData(
        header, graph.kmers[out_mask],
        new_cov[out_mask][:, [child_color]].copy(),
        graph.edges[out_mask][:, [child_color]].copy(),
        graph.data.kmer_bytes[out_mask])
    return gr.CortexGraph(data)


def compare_rois(truth: gr.CortexGraph, eval_g: gr.CortexGraph) -> dict:
    """Truth/eval ROI Venn (CompareROIs.java)."""
    t = _roi_set(truth)
    e = _roi_set(eval_g)
    return {
        "t": len(t), "e": len(e),
        "pt": len(t - e), "pe": len(e - t), "o": len(t & e),
        "private_to_eval": sorted(e - t),
    }


def emit_validated_novel_kmers(graph: gr.CortexGraph, zero_colors, positive_colors,
                               cov_limit: int = 0) -> gr.CortexGraph:
    """Generalized EmitValidatedNovelKmers: keep records with zero coverage in
    zero_colors and positive coverage (> cov_limit for the last) in
    positive_colors (the reference hard-codes its 12-color layout)."""
    cov = graph.coverages
    mask = np.ones(graph.num_records, dtype=bool)
    for c in zero_colors:
        mask &= cov[:, c] == 0
    for i, c in enumerate(positive_colors):
        limit = cov_limit if i == len(positive_colors) - 1 else 0
        mask &= cov[:, c] > limit
    data = ctxio.CtxData(graph.header, graph.kmers[mask], cov[mask],
                         graph.edges[mask], graph.data.kmer_bytes[mask])
    return gr.CortexGraph(data)


def combine_contigs(contigs: list, partitions: list, roi: gr.CortexGraph) -> list:
    """Extend contigs with their best novel-kmer-overlap partition
    (CombineContigs.java).  Inputs [(header, seq)]; returns [(header, seq)]."""
    k = roi.kmer_size
    rois = _roi_set(roi)
    part_novels = [(h, s, _novel_kmers(s, rois, k)) for h, s in partitions]

    out = []
    for header, rs in contigs:
        nks = _novel_kmers(rs, rois, k)
        best, best_overlap = None, 0
        for h, s, qks in part_novels:
            ov = len(nks & qks)
            if ov > best_overlap:
                best_overlap, best = ov, s
        if best_overlap == 0:
            continue
        # orientation by shared raw kmers
        rsk = {rs[i:i + k] for i in range(len(rs) - k + 1)}
        qfwd = {best[i:i + k] for i in range(len(best) - k + 1)}
        qrev = {km.revcomp(best[i:i + k]) for i in range(len(best) - k + 1)}
        seq = best if len(rsk & qfwd) > len(rsk & qrev) else km.revcomp(best)

        if seq in rs:
            new_contig = rs
        elif rs in seq:
            new_contig = seq
        else:
            ib = ir = 0
            kk = 1
            while (kk < 5 and ib >= 0 and ir >= 0 and kk * k < len(rs)
                   and kk * k < len(seq)):
                kl = kk * k
                ib = rs.find(seq[:kl])
                ir = seq.find(rs[:kl])
                kk += 1
            if ir >= 0 and ib == -1:
                merged = seq[:ir] + rs
            elif ib >= 0 and ir == -1:
                merged = rs[:ib] + seq
            else:
                merged = rs if len(rs) > len(seq) else seq
            if len(merged) > len(rs) and len(merged) > len(seq):
                new_contig = merged
            else:
                new_contig = rs if len(rs) > len(seq) else seq
        out.append((f"{header.split(' ')[0]} len={len(new_contig) - k + 1}", new_contig))
    return out


def filter_partitions(partitions: list, roi: gr.CortexGraph,
                      novel_kmer_threshold: int = 5) -> list:
    """Drop partitions with too few novel kmers or novel terminal kmers;
    emit remaining sorted by novel count desc (FilterPartitions.java)."""
    k = roi.kmer_size
    rois = _roi_set(roi)
    kept = []
    for header, seq in partitions:
        if len(seq) < k:
            continue
        cks = _novel_kmers(seq, rois, k)
        ck0 = min(seq[:k], km.revcomp(seq[:k]))
        ck1 = min(seq[-k:], km.revcomp(seq[-k:]))
        if len(cks) > novel_kmer_threshold and ck0 not in rois and ck1 not in rois:
            kept.append((header, seq, len(cks)))
    kept.sort(key=lambda t: -t[2])
    return [(h, s) for h, s, _ in kept]


def coverage_table(graph: gr.CortexGraph, contigs: list, sample: str) -> list:
    """Per-kmer coverage rows (Coverage.java): (contig, kmer, index, coverage)."""
    c = graph.color_for_sample(sample)
    k = graph.kmer_size
    rows = []
    for header, seq in contigs:
        name = header.split(" ")[0]
        for i in range(len(seq) - k + 1):
            sk = seq[i:i + k]
            rec = graph.find_record(sk)
            cov = graph.coverage(rec, c) if rec >= 0 else 0
            rows.append((name, sk, i, cov))
    return rows


def sim_to_vcf(sim_rows: list, backgrounds: dict) -> list:
    """Simulation truth table -> VCF records against the parents' references
    (SimToVCF.java).  backgrounds: {parent_name: IndexedReference}."""
    out = []
    for te in sim_rows:
        if te.get("type") == "RECOMB":
            continue
        sleft, sright = te["sleft"], te["sright"]
        old = te["old"].replace(".", "")
        new = te["new"].replace(".", "")
        if old == new:
            continue
        ref = backgrounds.get(te["parent"])
        if ref is None:
            continue
        old_hap = (sleft + old + sright).upper()
        srs = sorted(ref.align(old_hap), key=lambda s: (-(s.end - s.start), s.nm))
        if not srs:
            continue
        sr = srs[0]
        is_snv = te["type"].upper() == "SNV"
        pos = sr.start + len(sleft) + (1 if is_snv else 0) - 1
        if is_snv:
            ref_base = ""
        else:
            seq = ref.seqs.get(sr.contig, "")
            ref_base = seq[pos - 1:pos].upper() if 0 < pos <= len(seq) else sleft[-1].upper()
        v = Variant(chrom=sr.contig, start=pos,
                    alleles=[ref_base + old, ref_base + new],
                    attributes={"TYPE": te["type"]}).compute_end_from_alleles()
        out.append(v)
    out.sort(key=lambda v: (v.chrom, v.start))
    return out
