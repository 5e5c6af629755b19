"""The linked DNM pipeline on the port: reads -> VCF, resumable.

Counterpart of corticall_tpu.pipeline.run_pipeline with the same stage
order, artifacts (.ctx, .ctp.bgz, FASTA, VCF, accounting, state.json) and
stats: per-sample Build+Clean, Join, Thread (reads and references), FindROIs,
the prefilter chain, Partition (the port's routes), Trim, Call (the port's
Caller: CUDA Tesserae and banded-SW kernels) and FilterCalls.  The resumable
runner (`Pipeline`) and its file helpers are copies of the JAX package's.
Graphs are built on the native counting core, or by the device count when
CORTICALL_DEVICE_BUILD=1.  `run_cross_pipeline` is the cross: N progeny
over parents built once.
"""

from __future__ import annotations

import json
import os
import time

from . import build as bd
from . import evaluation as ev
from . import graph as gr
from .caller.call import Caller
from .caller.filter import filter_calls
from .caller.variants import Variant, write_vcf
from .commands import core
from .device import resolve
from .io import ctx as ctxio
from .io import fasta as faio
from .io import links as lkio
from .ops.tesserae_torch import TesseraeDevice

STATE_FILE = "state.json"


class _State:
    def __init__(self, workdir: str, resume: bool):
        self.path = os.path.join(workdir, STATE_FILE)
        self.data: dict = {"stages": {}}
        if resume and os.path.exists(self.path):
            with open(self.path) as f:
                self.data = json.load(f)

    def done(self, name: str) -> bool:
        return name in self.data["stages"]

    def mark(self, name: str, seconds: float, stats: dict | None = None) -> None:
        self.data["stages"][name] = {
            "seconds": round(seconds, 3), **({"stats": stats} if stats else {})}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1)
        os.replace(tmp, self.path)

    def stats(self, name: str) -> dict:
        return self.data["stages"].get(name, {}).get("stats", {})

    def seconds(self, name: str) -> float:
        return self.data["stages"].get(name, {}).get("seconds", 0.0)


def _read_graph(path: str) -> gr.CortexGraph:
    return gr.CortexGraph(ctxio.read_ctx(path))


def _write_fasta_list(path: str, records: list) -> None:
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n{seq}\n")


def _read_fasta_list(path: str) -> list:
    return faio.read_fasta_full_headers(path)


class Pipeline:
    """Resumable staged runner.  Each stage writes its artifact(s) into
    `workdir`; a stage re-runs only if its artifact or state entry is missing.
    """

    def __init__(self, workdir: str, resume: bool = True, log=None):
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.state = _State(workdir, resume)
        self.log = log or (lambda *a: None)

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def stage(self, name: str, artifacts: list, compute, load):
        """Run `compute()` unless every artifact exists and the state says
        the stage completed; in that case `load()` re-materializes results."""
        paths = [self.path(a) for a in artifacts]
        if self.state.done(name) and all(os.path.exists(p) for p in paths):
            self.log(f"[pipeline] {name}: resume (cached)")
            return load(*paths)
        t0 = time.perf_counter()
        result, stats = compute(*paths)
        self.state.mark(name, time.perf_counter() - t0, stats)
        self.log(f"[pipeline] {name}: {self.state.seconds(name)} s")
        return result


def run_pipeline(workdir: str, reads_by_sample: dict, child: str,
                 parents: list, references=None, k: int = 47,
                 min_coverage: int = 2, tip_length: int | None = None,
                 link_samples=None, prefilter: bool = True,
                 lowcov_min: int | str = "auto", max_walk: int = 2000,
                 trim_margin: int = 500, resume: bool = True,
                 caller_opts: dict | None = None, log=None,
                 clean: bool = True, prefilters=None,
                 thread_refs: bool = True,
                 shared_graphs: dict | None = None, device=None) -> dict:
    """Execute the production pipeline from reads to VCF; arguments and
    result keys as corticall_tpu.pipeline.run_pipeline, plus `device` for
    the kernels of the Partition and Call stages and of the device graph
    build, which CORTICALL_DEVICE_BUILD=1 selects (default: the CUDA card,
    and RuntimeError without one; "cpu" runs the plain twins)."""
    device = resolve(device)
    pl = Pipeline(workdir, resume=resume, log=log)
    samples = [child] + list(parents)
    link_samples = list(link_samples if link_samples is not None else samples)
    prefilters = list(prefilters if prefilters is not None
                      else ("orphans", "tips", "dust", "lowcov", "lowcomplexity"))

    # ---- per-sample build + clean (mccortex build/clean/inferedges) -------
    cleaned: dict = {}
    for s in samples:
        if shared_graphs and s in shared_graphs:
            cleaned[s] = shared_graphs[s]
            continue
        def compute(path, s=s):
            g = bd.build_graph_from_reads(reads_by_sample[s], k, s, device=device)
            raw_records = g.num_records
            if clean:
                g = bd.clean_graph(g, min_coverage=min_coverage,
                                   tip_length=tip_length)
            ctxio.write_ctx(path, g.data)
            return g, {"raw_records": raw_records,
                       "clean_records": g.num_records}
        cleaned[s] = pl.stage(f"build_clean_{s}", [f"{s}.clean.ctx"],
                              compute, _read_graph)

    # ---- join ---------------------------------------------------------------
    def compute_join(path):
        g = core.join([cleaned[s] for s in samples])
        ctxio.write_ctx(path, g.data)
        return g, {"records": g.num_records}
    joined = pl.stage("join", ["joined.ctx"], compute_join, _read_graph)

    # ---- thread reads -> indexed links --------------------------------------
    links: list = []
    for s in link_samples:
        def compute(path_bgz, s=s):
            ld = lkio.merge_prefix_links(
                bd.thread_reads(joined, reads_by_sample[s], s))
            lkio.write_links_indexed(path_bgz, ld, source=f"{s}.reads")
            return ld, {"kmers_with_links": len(ld)}
        links.append(pl.stage(
            f"thread_{s}", [f"{s}.ctp.bgz"], compute,
            lambda p: lkio.open_links(p)))

    # ---- thread references -> indexed links (along the child color) --------
    if thread_refs and references:
        for name, ref in references.items():
            def compute(path_bgz, name=name, ref=ref):
                ld = lkio.merge_prefix_links(bd.thread_reads(
                    joined, list(ref.seqs.values()), child))
                ld.source = name
                lkio.write_links_indexed(path_bgz, ld, source=name)
                return ld, {"kmers_with_links": len(ld)}
            links.append(pl.stage(
                f"thread_ref_{name}", [f"ref_{name}.ctp.bgz"], compute,
                lambda p: lkio.open_links(p)))

    # ---- FindROIs -------------------------------------------------------------
    def compute_rois(path):
        r = core.find_rois(joined, child, parents)
        ctxio.write_ctx(path, r.data)
        return r, {"rois": r.num_records}
    rois = pl.stage("find_rois", ["rois.ctx"], compute_rois, _read_graph)

    # ---- prefilter chain + Remove ---------------------------------------------
    if prefilter and rois.num_records:
        def compute_pf(path):
            excluded = []
            per = {}
            if "orphans" in prefilters:
                e = core.find_orphans(joined, rois, parents)
                per["orphans"] = e.num_records
                excluded.append(e)
            if "tips" in prefilters:
                e = core.find_tips(joined, rois, parents)
                per["tips"] = e.num_records
                excluded.append(e)
            if "dust" in prefilters:
                e = core.find_dust(joined, rois, parents)
                per["dust"] = e.num_records
                excluded.append(e)
            if "lowcov" in prefilters:
                m = (core.adaptive_lowcov_threshold(joined, child)
                     if lowcov_min == "auto" else lowcov_min)
                e = core.find_low_coverage(rois, min_coverage=m)
                per["lowcov"] = e.num_records
                per["lowcov_threshold"] = m
                excluded.append(e)
            if "lowcomplexity" in prefilters:
                e = core.find_low_complexity(joined, rois, parents)
                per["lowcomplexity"] = e.num_records
                excluded.append(e)
            out = core.remove(rois, [e for e in excluded if e.num_records])
            ctxio.write_ctx(path, out.data)
            return out, {"excluded": per,
                         "excluded_union": rois.num_records - out.num_records,
                         "roi_before": rois.num_records,
                         "kept": out.num_records,
                         "removed": rois.num_records - out.num_records}
        rois = pl.stage("prefilter", ["rois.filtered.ctx"],
                        compute_pf, _read_graph)

    # ---- Partition with links -------------------------------------------------
    def compute_partition(path):
        stats: dict = {}
        parts = core.partition(joined, rois, links=links, max_walk=max_walk,
                               stats=stats,
                               checkpoint=pl.path("partition.ckpt.npz"),
                               device=device)
        _write_fasta_list(path, parts)
        stats["partitions"] = len(parts)
        return parts, stats
    parts = pl.stage("partition", ["partitions.fa"],
                     compute_partition, _read_fasta_list)

    # ---- TrimPartitions -------------------------------------------------------
    def compute_trim(path):
        roi_set = {rois.kmer_string(i) for i in range(rois.num_records)}
        trimmed = ev.trim_partitions(parts, roi_set, k, margin=trim_margin)
        _write_fasta_list(path, trimmed)
        return trimmed, {"partitions": len(trimmed)}
    parts_t = pl.stage("trim", ["partitions.trimmed.fa"],
                       compute_trim, _read_fasta_list)

    # ---- Call with links (the two CUDA kernels) -------------------------------
    def compute_call(vcf_path, acct_path):
        caller = Caller(joined, rois, parts_t, backgrounds=list(parents),
                        references=references or {}, links=links,
                        device=device, **(caller_opts or {}))
        variants, _ = caller.write_outputs(vcf_path, acct_path)
        breakdown = {name: round(dt, 3)
                     for name, dt in sorted(caller.timer.sections.items(),
                                            key=lambda kv: -kv[1])}
        if breakdown:
            pl.log(f"[pipeline] call breakdown: {breakdown}")
        stats = {"calls": len(variants), "call_breakdown": breakdown,
                 "contig_aligner": dict(caller.align_stats)}
        if isinstance(caller.ma, TesseraeDevice):
            stats["tesserae"] = {"device_sections": caller.ma.device_sections,
                                 "host_sections": caller.ma.host_sections}
        return variants, stats
    variants = pl.stage(
        "call", ["calls.vcf", "accounting.txt"], compute_call,
        lambda vp, ap: _load_vcf_variants(vp))

    # ---- FilterCalls: the manuscript FDR protocol -----------------------------
    def compute_filter(path):
        mnc = 0
        kept, rejected = filter_calls(variants, min_novel_coverage=mnc,
                                      references=references)
        sd, seen = [], set()
        for rid, ir in (references or {}).items():
            for name, seq in ir.seqs.items():
                if name not in seen:
                    sd.append((name, len(seq)))
                    seen.add(name)
            if f"{rid}_unknown" not in seen:
                sd.append((f"{rid}_unknown", len(parts_t)))
                seen.add(f"{rid}_unknown")
        write_vcf(path, kept, sd)
        return kept, {"input_calls": len(variants), "kept": len(kept),
                      "rejected": len(rejected),
                      "min_novel_coverage": mnc}
    filtered = pl.stage("filter_calls", ["calls.filtered.vcf"],
                        compute_filter, _load_vcf_variants)

    return {
        "graph": joined, "rois": rois, "links": links,
        "partitions": parts_t, "variants": variants,
        "filtered_variants": filtered,
        "stages": {n: pl.state.seconds(n) for n in pl.state.data["stages"]},
        "stats": {n: pl.state.stats(n) for n in pl.state.data["stages"]},
        "workdir": workdir,
    }


def run_cross_pipeline(workdir: str, parent_reads: dict, progeny_reads: dict,
                       parents: list, references=None, log=None, device=None,
                       **opts) -> dict:
    """The cross (ProcessPfCross.wdl's N progeny over shared parents), as
    corticall_tpu.pipeline.run_cross_pipeline: each parent built and cleaned
    once into `{s}.clean.ctx` of the shared workdir, then run_pipeline for
    every child in `workdir/<child>` over those graphs, with every option
    (`resume` included) and `device` passed on.  `device` as run_pipeline's;
    the parents' builds take the device count when CORTICALL_DEVICE_BUILD=1.
    Returns the parents' records, `shared_parent_build_s`, `per_sample` (each
    run_pipeline's result with its `wallclock_s`), `progeny` and `total_s`."""
    device = resolve(device)
    t_all = time.perf_counter()
    pl = Pipeline(workdir, resume=opts.get("resume", True), log=log)
    k = opts.get("k", 47)
    min_coverage = opts.get("min_coverage", 2)
    tip_length = opts.get("tip_length")
    clean = opts.get("clean", True)

    shared: dict = {}
    for s in parents:
        def compute(path, s=s):
            g = bd.build_graph_from_reads(parent_reads[s], k, s, device=device)
            raw = g.num_records
            if clean:
                g = bd.clean_graph(g, min_coverage=min_coverage,
                                   tip_length=tip_length)
            ctxio.write_ctx(path, g.data)
            return g, {"raw_records": raw, "clean_records": g.num_records}
        shared[s] = pl.stage(f"build_clean_{s}", [f"{s}.clean.ctx"],
                             compute, _read_graph)
    shared_s = round(time.perf_counter() - t_all, 2)

    per_sample: dict = {}
    for child in progeny_reads:
        t0 = time.perf_counter()
        res = run_pipeline(
            os.path.join(workdir, child),
            {child: progeny_reads[child], **parent_reads},
            child, list(parents), references=references, log=log,
            shared_graphs=shared, device=device, **opts)
        res["wallclock_s"] = round(time.perf_counter() - t0, 2)
        per_sample[child] = res

    return {
        "parents": {s: {"records": shared[s].num_records} for s in parents},
        "shared_parent_build_s": shared_s,
        "per_sample": per_sample,
        "progeny": list(progeny_reads),
        "total_s": round(time.perf_counter() - t_all, 2),
    }


def _load_vcf_variants(vcf_path: str) -> list:
    """Re-materialize Variant objects from a pipeline-written VCF (resume)."""
    out = []
    with open(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos, _, ref, alt = fields[:5]
            filt = fields[6] if len(fields) > 6 else "."
            v = Variant(chrom, int(pos), 0, [ref] + alt.split(","))
            if not v.is_symbolic():
                v.compute_end_from_alleles()
            for kv in (fields[7].split(";") if len(fields) > 7 else []):
                if "=" in kv:
                    kk, vv = kv.split("=", 1)
                    v.attr(kk, vv)
            if filt not in (".", "PASS"):
                v.filters.update(filt.split(";"))
            out.append(v)
    return out
