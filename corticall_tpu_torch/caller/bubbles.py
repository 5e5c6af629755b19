"""Bubble caller: open a bubble in the child color, close it per parent.

The reference ships this as a disabled stub (BubbleCaller.call returns an
empty set; the implementation is commented out, utils/caller/BubbleCaller.java:44-47)
— we provide the working capability following that commented design:

- open: DFS from a novel seed in the alternate (child) color with
  BubbleOpeningStopper (novel kmers then joining-color contact);
- anchor: candidate source/sink vertices with unique reference placement;
- close: per reference color, DFS source -> sink with BubbleClosingStopper;
- emit Bubble objects carrying the ref/alt paths and the novel kmers inside.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..traversal import (AND, BOTH, FORWARD, OR, TraversalConfig,
                         TraversalEngine, to_contig)
from ..traversal.pathfinder import shortest_path
from ..traversal.stopping import BubbleClosingStopper, BubbleOpeningStopper, DestinationStopper


@dataclass(frozen=True)
class Bubble:
    ref_contig: str
    alt_contig: str
    ref_color: int
    novel_kmers: frozenset = frozenset()
    source: str = ""
    sink: str = ""

    @property
    def ref_allele(self) -> str:
        """Core ref allele with the shared flanks trimmed."""
        return _trim(self.ref_contig, self.alt_contig)[0]

    @property
    def alt_allele(self) -> str:
        return _trim(self.ref_contig, self.alt_contig)[1]


def _trim(s0: str, s1: str):
    a = 0
    while a < min(len(s0), len(s1)) and s0[a] == s1[a]:
        a += 1
    b = 0
    while (b < min(len(s0), len(s1)) - a and s0[len(s0) - 1 - b] == s1[len(s1) - 1 - b]):
        b += 1
    return s0[a:len(s0) - b], s1[a:len(s1) - b]


class BubbleCaller:
    def __init__(self, graph, rois, alternate_color: int, reference_colors,
                 references=None, links=()):
        self.graph = graph
        self.rois = rois
        self.alt_color = alternate_color
        self.ref_colors = list(reference_colors)
        self.references = references or {}
        self.links = list(links)
        self.e_open = TraversalEngine(TraversalConfig(
            graph=graph, traversal_colors=[alternate_color],
            joining_colors=self.ref_colors, direction=BOTH, combination=AND,
            stopping_rule=BubbleOpeningStopper, rois=rois, links=self.links))

    def call(self, seed: str, max_pairs: int | None = None) -> set:
        """max_pairs caps the source x sink closing probes (closest anchors
        to the seed first); None = exhaustive like the reference design."""
        gc = self.e_open.dfs(seed)
        bubbles: set = set()
        if gc is None:
            return bubbles

        seed_v = gc.find_vertex(seed)
        if seed_v is None:
            return bubbles

        # candidate anchors: vertices with parental coverage and (when
        # references are available) a unique placement
        def anchored(v):
            if v.rec < 0:
                return False
            if not any(self.graph.coverage(v.rec, pc) > 0 for pc in self.ref_colors):
                return False
            if self.references:
                hits = set()
                for ir in self.references.values():
                    hits |= ir.find(v.kmer)
                return len(hits) == 1
            return True

        # the dfs tags non-seed vertices with a direction index (-1 reverse,
        # +1 forward); sources come from the reverse sweep, sinks from the
        # forward sweep (the reference's dRev/dFwd candidate split)
        sources = {v for v in gc.vertices() if anchored(v) and v.index <= 0}
        sinks = {v for v in gc.vertices() if anchored(v) and v.index >= 0}

        # closest anchors to the seed first (path distance within gc)
        def dist_order(vs):
            out = []
            for v in sorted(vs, key=lambda v: v.kmer):
                p = shortest_path(gc, v, seed_v) or shortest_path(gc, seed_v, v)
                out.append((len(p) if p else 1 << 30, v))
            out.sort(key=lambda t: (t[0], t[1].kmer))
            return [v for _, v in out]

        pairs = 0
        for so in dist_order(sources):
            for si in dist_order(sinks):
                if so == si:
                    continue
                if max_pairs is not None and pairs >= max_pairs:
                    return bubbles
                pairs += 1
                alt_path = shortest_path(gc, so, si)
                if alt_path is None:
                    continue
                novel = frozenset(v.canonical for v in alt_path
                                  if self.rois.find_record(v.canonical) >= 0)
                if not novel:
                    continue
                for pc in self.ref_colors:
                    if (self.graph.coverage(so.rec, pc) == 0
                            or self.graph.coverage(si.rec, pc) == 0):
                        continue
                    e_close = TraversalEngine(TraversalConfig(
                        graph=self.graph, traversal_colors=[pc],
                        joining_colors=self.ref_colors, direction=FORWARD,
                        combination=OR, stopping_rule=DestinationStopper,
                        rois=self.rois, links=self.links))
                    gp = e_close.dfs(so.kmer, si.kmer)
                    if gp is None:
                        continue
                    so_p = gp.find_vertex(so.kmer)
                    si_p = gp.find_vertex(si.kmer)
                    if so_p is None or si_p is None:
                        continue
                    ref_path = shortest_path(gp, so_p, si_p)
                    if ref_path is None:
                        continue
                    bubbles.add(Bubble(
                        ref_contig=to_contig(ref_path),
                        alt_contig=to_contig(alt_path),
                        ref_color=pc, novel_kmers=novel,
                        source=so.kmer, sink=si.kmer))
        return bubbles
