"""Interval merging for candidate target windows.

Port of utils/alignment/intervalcombiner/IntervalCombiner.java:14-87 (the
reference ships it without call sites; the Call pipeline's own windowing in
caller/call.py covers the production path — this standalone utility exists
for API parity): pad each walk kmer's reference hits by a window, merge
same-strand overlapping intervals per background, clamp to chromosome
bounds, and return the longest max_states_per_background intervals per
background.
"""

from __future__ import annotations

from .reference_index import Interval


def get_intervals(walk_kmers, refs: dict, location_window: int,
                  max_states_per_background: int) -> list:
    """walk_kmers: iterable of kmer strings (walk order); refs:
    {name: IndexedReference}.  Returns [(name, Interval)] — per background,
    the longest merged windows first, at most max_states_per_background."""
    out = []
    for name, ir in refs.items():
        merged: list[Interval] = []
        for sk in walk_kmers:
            for it in ir.find(sk):
                start = it.start - location_window
                end = it.end + location_window
                keep = []
                for oit in merged:
                    overlaps = (oit.contig == it.contig
                                and oit.start <= end and oit.end >= start)
                    if overlaps and oit.negative == it.negative:
                        start = min(start, oit.start)
                        end = max(end, oit.end)
                    else:
                        keep.append(oit)
                keep.append(Interval(it.contig, start, end, it.negative))
                merged = keep

        clamped = []
        for it in merged:
            start = max(it.start, 1)
            max_len = len(ir.seqs[it.contig])
            end = min(it.end, max_len - 1)
            clamped.append(Interval(it.contig, start, end, it.negative))
        clamped.sort(key=lambda it: it.end - it.start, reverse=True)
        out.extend((name, it) for it in clamped[:max_states_per_background])
    return out
