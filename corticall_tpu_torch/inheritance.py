"""Parental-allele inheritance painting (commands/inheritance/ComputeInheritance.java).

Per child: find seed kmers unique to one parent + one draft reference with
unique reference coordinates (vectorized filters over the record arrays, then
the chain filter over a both-orientation string graph), walk the child color
outward to where the *other* parent's allele rejoins, walk that parent between
the junctions, trim to alleles, and emit a table of inherited-variant sites.
"""

from __future__ import annotations

import numpy as np

from . import graph as gr
from . import kmer as km
from .traversal import TraversalConfig, TraversalEngine
from .traversal.stopping import StoppingRule
from .traversal.subgraph import Vertex
from .traversal.utils import to_contig


def _degrees(g: gr.CortexGraph):
    e = g.edges.astype(np.uint16)
    in_deg = np.zeros_like(e, dtype=np.int8)
    out_deg = np.zeros_like(e, dtype=np.int8)
    for b in range(4):
        in_deg += ((e >> (4 + b)) & 1).astype(np.int8)
        out_deg += ((e >> b) & 1).astype(np.int8)
    return in_deg, out_deg


def get_variant_seeds(g: gr.CortexGraph, ref_color: int, parent_colors, draft_colors,
                      references: dict) -> list:
    """Seed kmers for inherited-variant calling (getVariantSeeds, :239-322)."""
    parent_colors = sorted(parent_colors)
    draft_colors = sorted(draft_colors)
    cov = g.coverages
    in_deg, out_deg = _degrees(g)

    covered = cov > 0
    # singly connected in every covered color
    singly = np.ones(g.num_records, dtype=bool)
    for c in range(g.num_colors):
        bad = covered[:, c] & ~((in_deg[:, c] == 1) & (out_deg[:, c] == 1))
        singly &= ~bad

    n_parents = covered[:, parent_colors].sum(axis=1)
    n_drafts = covered[:, draft_colors].sum(axis=1)
    one_parent = (n_parents == 1) & (n_drafts == 1)

    ignore = set(parent_colors) | set(draft_colors) | {ref_color}
    child_cols = [c for c in range(g.num_colors) if c not in ignore]
    n_children = covered[:, child_cols].sum(axis=1) if child_cols else np.zeros(g.num_records)
    some_children = ((len(child_cols) == 1)
                     | ((n_children > 1) & (n_children < len(child_cols))))

    candidates = np.nonzero(singly & one_parent & some_children)[0]

    # unique coordinates on the single covered draft
    seeds = []
    for i in candidates:
        dc = next(c for c in draft_colors if covered[i, c])
        ir = references.get(g.sample_name(dc))
        if ir is None:
            continue
        if len(ir.find(g.kmer_string(int(i)))) == 1:
            seeds.append(int(i))

    # chain filter over a both-orientation string graph of the seed kmers
    succ: dict = {}
    pred: dict = {}

    def add_edge(a, b):
        succ.setdefault(a, set()).add(b)
        pred.setdefault(b, set()).add(a)
        succ.setdefault(b, set())
        pred.setdefault(a, set())

    for i in seeds:
        fwd = g.kmer_string(i)
        rev = km.revcomp(fwd)
        succ.setdefault(fwd, set()), pred.setdefault(fwd, set())
        succ.setdefault(rev, set()), pred.setdefault(rev, set())
        for c in range(g.num_colors):
            if not covered[i, c]:
                continue
            pm, nm = gr.edges_to_masks(np.uint8(g.edges[i, c]), False)
            for b in range(4):
                if int(pm) & (1 << b):
                    ie = "ACGT"[b] + fwd[:-1]
                    add_edge(ie, fwd)
                    add_edge(rev, km.revcomp(ie))
                if int(nm) & (1 << b):
                    oe = fwd[1:] + "ACGT"[b]
                    add_edge(fwd, oe)
                    add_edge(km.revcomp(oe), rev)

    good = set()
    for sk in succ:
        if len(pred.get(sk, ())) == 0 and len(succ.get(sk, ())) == 1:
            contig = [sk]
            v = sk
            while len(succ.get(v, ())) == 1:
                v = next(iter(succ[v]))
                contig.append(v)
            if len(contig) > 3:
                good.add(min(contig[1], km.revcomp(contig[1])))
    return sorted(good)


def _trim_to_alleles(s0: str, s1: str):
    """trimToAlleles (:406-433): strip shared prefix/suffix, return cores."""
    s0start, s0end = 0, len(s0)
    s1start, s1end = 0, len(s1)
    for i in range(min(len(s0), len(s1))):
        if s0[i] != s1[i]:
            s0start = i
            s1start = i
            break
    i, j = len(s0) - 1, len(s1) - 1
    while i >= 0 and j >= 0:
        if s0[i] != s1[j] or i == s0start - 1 or j == s1start - 1:
            s0end = i + 1
            s1end = j + 1
            break
        i -= 1
        j -= 1
    return s0[s0start:s0end], s1[s1start:s1end]


def call_variant(g: gr.CortexGraph, references: dict, parents: dict, ck: str,
                 parent_colors, child_colors):
    """callVariant (:102-237): walk the child across the unshared allele to
    the other parent's flanks, walk that parent between them, emit a row."""
    rec = g.find_record(ck)
    if rec < 0:
        return None
    for c in sorted(child_colors):
        if g.coverage(rec, c) <= 0:
            continue
        cfg = TraversalConfig(graph=g, traversal_colors=[c],
                              stopping_rule=StoppingRule)
        e = TraversalEngine(cfg)

        shares, not_shares = -1, -1
        for pc in sorted(parent_colors):
            if g.coverage(rec, pc) > 0:
                shares = pc
            else:
                not_shares = pc
        if not_shares < 0:
            continue

        sk = ck
        contig_child = [Vertex(sk, rec)]
        source = None
        e.seek(sk)
        while e.has_previous():
            cv = e.previous()
            contig_child.insert(0, cv)
            if cv.rec >= 0 and g.coverage(cv.rec, not_shares) > 0:
                source = cv
                break
        destination = None
        e.seek(sk)
        while e.has_next():
            cv = e.next()
            contig_child.append(cv)
            if cv.rec >= 0 and g.coverage(cv.rec, not_shares) > 0:
                destination = cv
                break

        if source is None or destination is None:
            continue

        cfg.traversal_colors = [not_shares]
        contig_parent = [source]
        destination_reached = False
        e.seek(source.kmer)
        while e.has_next():
            cv = e.next()
            contig_parent.append(cv)
            if cv.kmer == destination.kmer and cv.rec == destination.rec:
                destination_reached = True
                break
        if not destination_reached:
            continue

        ref_ir = references.get("ref")
        if ref_ir is None:
            continue
        src_its = ref_ir.find(source.kmer)
        dst_its = ref_ir.find(destination.kmer)
        if len(src_its) != 1 or len(dst_its) != 1:
            continue
        src_it = next(iter(src_its))
        dst_it = next(iter(dst_its))
        if src_it.contig != dst_it.contig:
            continue

        parent_cov = sum(g.coverage(v.rec, not_shares) for v in contig_parent
                         if v.rec >= 0) / len(contig_parent)
        a_child, a_parent = _trim_to_alleles(to_contig(contig_child),
                                             to_contig(contig_parent))
        if len(a_child) == 1 and len(a_parent) == 1:
            vtype = "SNP"
        elif len(a_child) == len(a_parent):
            vtype = "MNP"
        elif len(a_child) < len(a_parent):
            vtype = "DEL"
        else:
            vtype = "INS"

        row = {"chrom": src_it.contig, "pos": str(src_it.start),
               "type": vtype, "cov_parent": str(int(parent_cov))}
        for cc in sorted(child_colors):
            child_cov = sum(g.coverage(v.rec, cc) for v in contig_child
                            if v.rec >= 0) / len(contig_child)
            target = not_shares if g.coverage(rec, cc) == 0 else shares
            for ref_name, sample in parents.items():
                if sample == g.sample_name(target):
                    row[g.sample_name(cc)] = f"{ref_name}:{int(child_cov)}"
                    break
        row["alleles"] = f"{a_child}/{a_parent}"
        return row
    return None


def compute_inheritance(g: gr.CortexGraph, references: dict, parents: dict,
                        children, ref_name: str) -> list:
    """Top-level (execute, :48-65).  Returns table rows sorted by locus."""
    ref_color = g.color_for_sample(ref_name)
    parent_colors = set(g.colors_for_samples(list(parents.values())))
    # drafts = every REFERENCES key present as a graph color (the reference
    # includes the canonical ref in REFERENCES, so its color lands here too)
    draft_colors = {g.color_for_sample(n) for n in references
                    if n in g.sample_names}
    child_colors = set(g.colors_for_samples(list(children)))

    seeds = get_variant_seeds(g, ref_color, parent_colors, draft_colors, references)
    rows = {}
    for ck in seeds:
        row = call_variant(g, references, parents, ck, parent_colors, child_colors)
        if row is not None:
            rows[(row["chrom"], int(row["pos"]))] = row
    return [rows[k] for k in sorted(rows)]
