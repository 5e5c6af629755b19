"""GFA1 export (utils/io/gfa/GFA1Writer.java + commands/utils/ToGfa1.java).

Segments = supplied unitigs/contigs (with per-sample average kmer coverage),
links = k-1 overlaps between segment ends found through the graph.
"""

from __future__ import annotations

from .. import kmer as km


def write_gfa1(path, graph, contigs: dict, sample_name: str | None = None) -> None:
    """contigs: {name: sequence}.  Emits H/S/L lines."""
    color = graph.color_for_sample(sample_name) if sample_name else 0
    k = graph.kmer_size

    begins: dict = {}
    ends: dict = {}
    oriented = []
    for name, seq in contigs.items():
        for orient, s in (("+", seq), ("-", km.revcomp(seq))):
            begins.setdefault(s[:k], []).append((name, orient))
            ends.setdefault(s[-k:], []).append((name, orient))
            oriented.append((name, orient, s))

    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for name, seq in contigs.items():
            cov = 0
            n = 0
            for i in range(len(seq) - k + 1):
                rec = graph.find_record(seq[i:i + k])
                if rec >= 0:
                    cov += graph.coverage(rec, color)
                    n += 1
            avg = int(cov / n) if n else 0
            f.write(f"S\t{name}\t{seq}\tKC:i:{avg}\n")
        emitted = set()
        for name, orient, s in oriented:
            # successors: contigs whose first kmer follows our last kmer
            last = s[-k:]
            rec = graph.find_record(last)
            if rec < 0:
                continue
            canon = graph.kmer_string(rec)
            flipped = canon != last
            from .. import graph as gr
            import numpy as np
            _, next_mask = gr.edges_to_masks(np.uint8(graph.edges[rec, color]), flipped)
            for b in range(4):
                if int(next_mask) & (1 << b):
                    nxt = last[1:] + "ACGT"[b]
                    for (name2, orient2) in begins.get(nxt, []):
                        key = (name, orient, name2, orient2)
                        if key not in emitted:
                            emitted.add(key)
                            f.write(f"L\t{name}\t{orient}\t{name2}\t{orient2}\t{k - 1}M\n")
