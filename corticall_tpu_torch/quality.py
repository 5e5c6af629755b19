"""Assembly quality estimation (commands/quality/ComputeAssemblyQuality.java).

Join the eval and truth graphs, find eval-private singly-connected kmers with
unique reference placement (the same seed-chain filter the inheritance caller
uses), and report a Phred-style quality Q = -10*log10(seeds / reference bases).
"""

from __future__ import annotations

import math

import numpy as np

from . import graph as gr
from . import inheritance as inh
from . import kmer as km
from .commands import core


def quality_seeds(joined: gr.CortexGraph, eval_color: int, comp_color: int,
                  ref) -> list:
    """Eval-private error-candidate seed kmers (getVariantSeeds, quality flavor)."""
    cov = joined.coverages
    in_deg, out_deg = inh._degrees(joined)
    covered = cov > 0

    singly = np.ones(joined.num_records, dtype=bool)
    for c in range(joined.num_colors):
        bad = covered[:, c] & ~((in_deg[:, c] == 1) & (out_deg[:, c] == 1))
        singly &= ~bad
    unique_to_eval = covered[:, eval_color] & ~covered[:, comp_color]
    candidates = np.nonzero(singly & unique_to_eval)[0]

    seeds = [int(i) for i in candidates
             if len(ref.find(joined.kmer_string(int(i)))) == 1]

    # chain filter (same both-orientation string graph trick)
    succ: dict = {}
    pred: dict = {}

    def add_edge(a, b):
        succ.setdefault(a, set()).add(b)
        pred.setdefault(b, set()).add(a)
        succ.setdefault(b, set())
        pred.setdefault(a, set())

    for i in seeds:
        fwd = joined.kmer_string(i)
        rev = km.revcomp(fwd)
        succ.setdefault(fwd, set()), pred.setdefault(fwd, set())
        succ.setdefault(rev, set()), pred.setdefault(rev, set())
        for c in range(joined.num_colors):
            if not covered[i, c]:
                continue
            pm, nm = gr.edges_to_masks(np.uint8(joined.edges[i, c]), False)
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


def compute_assembly_quality(eval_g: gr.CortexGraph, comp_g: gr.CortexGraph,
                             ref) -> float:
    """Q score of eval vs truth (ComputeAssemblyQuality.execute)."""
    joined = core.join([eval_g, comp_g])
    seeds = quality_seeds(joined, 0, eval_g.num_colors, ref)
    num_bases = sum(len(s) for s in ref.seqs.values())
    if not seeds:
        return float("inf")
    return -10.0 * math.log10(len(seeds) / num_bases)
