"""Call-set evaluation: truth-vs-called novel-kmer concordance.

Capability port of commands/discover/eval/ (VCFToKmers.java, EvaluateCalls)
and the WDL's evaluation protocol (Simulate.wdl:1209-1330): variants are
compared through the k-mers their alt haplotypes introduce — a call matches a
truth variant when their alt-kmer sets overlap — yielding TP/FN/FP counts and
a per-variant-type breakdown.
"""

from __future__ import annotations

from . import kmer as km


def read_vcf(path) -> list:
    """Minimal VCF reader -> list of dict rows (our own writer's output or any
    simple VCF)."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 8:
                continue
            info = {}
            if parts[7] != ".":
                for kv in parts[7].split(";"):
                    if "=" in kv:
                        k, v = kv.split("=", 1)
                        info[k] = v
                    else:
                        info[kv] = True
            rows.append({
                "chrom": parts[0], "pos": int(parts[1]), "id": parts[2],
                "ref": parts[3], "alt": parts[4].split(",")[0],
                "filter": parts[6], "info": info,
            })
    return rows


def variant_alt_kmers(ref_seqs: dict, chrom: str, pos: int, ref: str, alt: str,
                      k: int) -> set:
    """Canonical kmers of the alt haplotype (flank + alt + flank), VCFToKmers
    semantics (VCFToKmers.java:20-45).  pos is 1-based."""
    seq = ref_seqs.get(chrom)
    if seq is None:
        return set()
    start = pos - 1
    before = seq[max(0, start - k):start]
    after = seq[start + len(ref):start + len(ref) + k]
    hap = before + alt + after
    out = set()
    for i in range(len(hap) - k + 1):
        sk = hap[i:i + k].upper()
        if all(c in "ACGT" for c in sk):
            out.add(min(sk, km.revcomp(sk)))
    return out


def vcf_to_kmers(variants: list, ref_seqs: dict, k: int) -> list:
    """Rows of (chrom, pos, ref, alt, kmerIndex, kmer, canonical)."""
    rows = []
    for v in variants:
        seq = ref_seqs.get(v["chrom"])
        if seq is None:
            continue
        start = v["pos"] - 1
        before = seq[max(0, start - k):start]
        after = seq[start + len(v["ref"]):start + len(v["ref"]) + k]
        hap = before + v["alt"] + after
        for i in range(len(hap) - k + 1):
            sk = hap[i:i + k]
            rows.append((v["chrom"], v["pos"], v["ref"], v["alt"], i, sk,
                         min(sk, km.revcomp(sk))))
    return rows


def combined_alt_kmers(ref_seqs: dict, chrom: str, center: int, calls: list,
                       k: int, window: int = 100) -> set:
    """Alt-haplotype kmers with ALL calls within `window` of `center` applied
    at once.  Affine-gap alignment legally decomposes an MNP into an
    adjacent insertion+deletion pair; per-call alt-kmer sets then share
    nothing with the truth even though the reconstructed haplotype is
    identical — applying nearby calls jointly restores the comparison."""
    seq = ref_seqs.get(chrom)
    if seq is None:
        return set()
    near = sorted((c for c in calls if c["chrom"] == chrom
                   and abs(c["pos"] - center) <= window),
                  key=lambda c: c["pos"], reverse=True)
    if not near:
        return set()
    hap_lo = max(0, min(c["pos"] for c in near) - 1 - k)
    hap_hi = max(c["pos"] - 1 + len(c["ref"]) for c in near) + k
    hap = seq[hap_lo:hap_hi]
    for c in near:
        off = c["pos"] - 1 - hap_lo
        if hap[off:off + len(c["ref"])].upper() != c["ref"].upper():
            return set()  # overlapping/inconsistent decomposition
        hap = hap[:off] + c["alt"] + hap[off + len(c["ref"]):]
    out = set()
    for i in range(len(hap) - k + 1):
        sk = hap[i:i + k].upper()
        if all(ch in "ACGT" for ch in sk):
            out.add(min(sk, km.revcomp(sk)))
    return out


def evaluate_calls(truth: list, calls: list, ref_seqs: dict, k: int,
                   min_novel_kmers: int = 1,
                   combine_window: int | None = None) -> dict:
    """Kmer-Venn concordance.

    truth/calls: VCF rows (read_vcf).  A call matches a truth variant when
    their alt-kmer sets share >= min_novel_kmers kmers.  Returns counts +
    per-type breakdown + matched pairs.  With combine_window set, unmatched
    truth variants get a second chance against the haplotype with all calls
    within that window applied jointly (credits alignment-decomposed MNPs);
    None keeps the reference protocol's strict per-variant comparison.
    """
    truth_kmers = [(t, variant_alt_kmers(ref_seqs, t["chrom"], t["pos"],
                                         t["ref"], t["alt"], k)) for t in truth]
    call_kmers = [(c, variant_alt_kmers(ref_seqs, c["chrom"], c["pos"],
                                        c["ref"], c["alt"], k)) for c in calls]

    matched_truth = set()
    matched_calls = set()
    pairs = []
    for ti, (t, tks) in enumerate(truth_kmers):
        for ci, (c, cks) in enumerate(call_kmers):
            if len(tks & cks) >= min_novel_kmers:
                matched_truth.add(ti)
                matched_calls.add(ci)
                pairs.append((ti, ci, len(tks & cks)))

    if combine_window is not None:
        for ti, (t, tks) in enumerate(truth_kmers):
            if ti in matched_truth or not tks:
                continue
            cks = combined_alt_kmers(ref_seqs, t["chrom"], t["pos"],
                                     calls, k, combine_window)
            if len(tks & cks) >= min_novel_kmers:
                matched_truth.add(ti)
                pairs.append((ti, -1, len(tks & cks)))
                for ci, c in enumerate(calls):
                    if (c["chrom"] == t["chrom"]
                            and abs(c["pos"] - t["pos"]) <= combine_window):
                        matched_calls.add(ci)

    by_type: dict = {}
    for ti, (t, _) in enumerate(truth_kmers):
        vtype = t["info"].get("TYPE", "UNK")
        d = by_type.setdefault(vtype, {"tp": 0, "fn": 0})
        if ti in matched_truth:
            d["tp"] += 1
        else:
            d["fn"] += 1

    return {
        "num_truth": len(truth),
        "num_calls": len(calls),
        "tp": len(matched_truth),
        "fn": len(truth) - len(matched_truth),
        "fp": len(calls) - len(matched_calls),
        "by_type": by_type,
        "pairs": pairs,
    }


def trim_partitions(partitions: list, rois: set, k: int, margin: int = 500) -> list:
    """TrimPartitions.java:18-57: crop each partition to its novel span ± margin."""
    out = []
    for header, seq in partitions:
        n = len(seq) - k + 1
        if n <= 0:
            continue
        start = n - 1
        stop = 0
        for i in range(n):
            sk = seq[i:i + k]
            if min(sk, km.revcomp(sk)) in rois:
                if i < start:
                    start = i
                if i > stop:
                    stop = i
        start = start - margin if start - margin >= 0 else 0
        stop = stop + margin if stop + margin < n - 1 else n - 1
        out.append((header, seq[start:stop + k - 1]))
    return out


def count_novel_kmers_in_partitions(partitions: list, rois: set, k: int) -> list:
    """CountNovelKmersInPartitions.java rows: (name, length, num novel)."""
    rows = []
    for header, seq in partitions:
        used = set()
        for i in range(len(seq) - k + 1):
            sk = seq[i:i + k]
            ck = min(sk, km.revcomp(sk))
            if ck in rois:
                used.add(ck)
        rows.append((header.split(" ")[0], len(seq), len(used)))
    return rows
