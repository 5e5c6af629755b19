"""FilterCalls — the manuscript's false-discovery-rate filter as a command.

The reference ships FilterCalls as an empty stub (discover/call/
FilterCalls.java:10-21 — `execute()` is blank); the actual publication
protocol applies the FDR rule described in the manuscript's Methods
(BASELINE.md FDR row): reject events supported by fewer than 5 novel
k-mers, and hold NAHR breakend records to a multi-breakend standard.
This module implements that protocol over the NOVEL_KMERS INFO field the
caller now emits, so the shipped VCF can be reduced to the
publication-grade call set with one command.
"""

from __future__ import annotations


def inherited_in_references(v, references: dict, flank: int = 47) -> bool:
    """True when the call's predicted variant haplotype (draft flank + alt
    allele + draft flank) occurs exactly in ANY parental draft, either
    strand — i.e. the "novel" child sequence is actually inherited.

    This rejects the dominant low-coverage false-positive class: a local
    coverage trough in ONE parent's reads drops that parent's kmers during
    cleaning, so inherited child kmers pass the FindROIs subtraction as
    "novel" and produce a call whose haplotype any draft still contains.
    A true de novo variant's haplotype exists in no parental draft.  (The
    reference sidesteps the class with 75-100x coverage, Simulate.wdl
    read depths; at lower depth this check is the principled guard.)
    """
    if v.is_symbolic() or len(v.alleles) < 2 or not references:
        return False
    alt = v.alleles[1]
    ref = v.alleles[0]
    # build the predicted haplotype in EVERY frame that carries the call's
    # chromosome: the liftover frame (BACKGROUND) may be the draft the
    # child does NOT locally descend from — the other parent's flanks are
    # the ones the inherited haplotype actually continues into.  A hap
    # constructed in a coordinate-mismatched frame is a chimera that
    # matches nothing, so extra frames cannot create false rejections.
    for ir in references.values():
        seqs = getattr(ir, "seqs", None) or {}
        s = seqs.get(v.chrom)
        if s is None:
            continue
        p = v.start - 1
        if p < 0 or p + len(ref) > len(s):
            continue
        hap = (s[max(0, p - flank):p] + alt
               + s[p + len(ref):p + len(ref) + flank]).upper()
        rc = hap.translate(_RC)[::-1]
        for ir2 in references.values():
            for t in (getattr(ir2, "seqs", None) or {}).values():
                tu = t.upper()
                if hap in tu or rc in tu:
                    return True
    return False


_RC = str.maketrans("ACGTacgt", "TGCATGCA")


def filter_calls(variants: list, min_novel_kmers: int = 5,
                 require_nahr_multibreakend: bool = True,
                 min_novel_coverage: int = 0,
                 references: dict | None = None):
    """Partition `variants` into (kept, rejected) per the manuscript FDR
    protocol.

    - Events with NOVEL_KMERS < min_novel_kmers are rejected (manuscript
      Methods: "events with <5 novel k-mers rejected").
    - With min_novel_coverage > 0, events whose NOVEL_KMER_COV (median
      child coverage of their novel kmers) falls below it are rejected.
      This is the low-depth analog of the reference's fixed
      `mccortex clean -m 10` cleaning threshold at 75-100x coverage
      (Simulate.wdl:620-666): recurrent read errors form partial chains
      hovering at the cleaning threshold, while real DNM chains sit near
      the sample depth.  The pipeline passes half the median ROI coverage.
    - Breakend (SVTYPE=BND) records follow their MATEID partner: if either
      end of a pair fails, both are rejected (a half-pair is not a call).
    - With require_nahr_multibreakend, surviving BND records are kept only
      with multi-breakend support — the manuscript requires multi-breakend
      or long-read support for NAHR, and a lone pair has neither.  Support
      is either (a) >= 2 breakend pairs in the same partition (a double
      breakpoint within one contig), or (b) a RECIPROCAL pair elsewhere in
      the callset: this pair's bracket locus overlaps the other pair's
      breakend position and vice versa (an NAHR insertion's region-side and
      donor-side partitions corroborate each other).

    INFO values may arrive as strings (VCF round-trip).
    """
    def as_int(v, key) -> int:
        n = v.get_attr(key, 0)
        try:
            return int(n)
        except (TypeError, ValueError):
            return 0

    def novel_count(v) -> int:
        return as_int(v, "NOVEL_KMERS")

    def is_bnd(v) -> bool:
        return (v.get_attr("SVTYPE", "") == "BND") or v.is_symbolic()

    # per-partition BND counts for the multi-breakend rule
    bnd_per_partition: dict = {}
    bnds = [v for v in variants if is_bnd(v)]
    for v in bnds:
        p = v.get_attr("PARTITION_NAME", v.chrom)
        bnd_per_partition[p] = bnd_per_partition.get(p, 0) + 1

    def bracket_locus(v):
        """(chrom, lo, hi) of the bracket (mate) locus in an allele like
        'G[mom:chr1:611907-612673:+:159[' — None if unparsable."""
        for a in v.alleles[1:]:
            core = a.strip("ACGTNacgtn")
            core = core.strip("[]")
            parts = core.split(":")
            if len(parts) >= 3 and "-" in parts[2]:
                try:
                    lo, hi = (int(x) for x in parts[2].split("-")[:2])
                    return parts[1], lo, hi
                except ValueError:
                    return None
        return None

    def reciprocal_support(v) -> bool:
        """Another pair's breakend sits inside this pair's bracket locus
        AND this breakend sits inside that pair's bracket locus."""
        loc = bracket_locus(v)
        if loc is None:
            return False
        c, lo, hi = loc
        mine = v.get_attr("PARTITION_NAME", v.chrom)
        for o in bnds:
            if o.get_attr("PARTITION_NAME", o.chrom) == mine:
                continue
            if o.chrom != c or not (lo - 500 <= o.start <= hi + 500):
                continue
            oloc = bracket_locus(o)
            if (oloc is not None and oloc[0] == v.chrom
                    and oloc[1] - 500 <= v.start <= oloc[2] + 500):
                return True
        return False

    fails: set = set()
    by_id = {v.id_: v for v in variants if v.id_}
    for v in variants:
        reject = novel_count(v) < min_novel_kmers
        if (not reject and min_novel_coverage > 0
                and as_int(v, "NOVEL_KMER_COV") < min_novel_coverage):
            reject = True
        if not reject and references and inherited_in_references(v, references):
            reject = True
        if not reject and is_bnd(v) and require_nahr_multibreakend:
            p = v.get_attr("PARTITION_NAME", v.chrom)
            reject = (bnd_per_partition.get(p, 0) < 4
                      and not reciprocal_support(v))
        if reject:
            fails.add(id(v))
            mate = by_id.get(v.get_attr("MATEID"))
            if mate is not None:
                fails.add(id(mate))

    kept = [v for v in variants if id(v) not in fails]
    rejected = [v for v in variants if id(v) in fails]
    return kept, rejected
