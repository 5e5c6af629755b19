"""Lightweight directed multigraph over traversal vertices.

Replaces JGraphT's DirectedWeightedPseudograph as used by the reference
(TraversalEngine.java output type).  Vertex identity mirrors
CortexVertex.equals (CortexVertex.java:69-83): kmer string + record + copy
index + index + sources all participate, so the same kmer reached as a repeat
copy (links) or tagged with a post-dfs direction index is a distinct vertex.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import kmer as km


@dataclass(frozen=True)
class Vertex:
    kmer: str                 # walk-orientation kmer string
    rec: int                  # record index in the graph's SoA arrays (-1 if absent)
    copy: int = 0
    index: int = 0
    sources: frozenset = frozenset()

    @property
    def canonical(self) -> str:
        return min(self.kmer, km.revcomp(self.kmer))

    def with_index(self, index: int) -> "Vertex":
        return Vertex(self.kmer, self.rec, self.copy, index, self.sources)

    def with_copy(self, copy: int) -> "Vertex":
        return Vertex(self.kmer, self.rec, copy, self.index, self.sources)

    def __repr__(self):
        return f"V({self.kmer},rec={self.rec},copy={self.copy},idx={self.index})"


class Subgraph:
    """Directed graph; one colored edge per (u, v) pair (first insert wins),
    matching the reference's containsEdge guard (TraversalEngine.java:494-516)."""

    def __init__(self):
        self.out: dict[Vertex, dict[Vertex, int]] = {}
        self.inc: dict[Vertex, dict[Vertex, int]] = {}

    # -- mutation ----------------------------------------------------------
    def add_vertex(self, v: Vertex) -> None:
        if v not in self.out:
            self.out[v] = {}
            self.inc[v] = {}

    def add_edge(self, u: Vertex, v: Vertex, color: int) -> None:
        self.add_vertex(u)
        self.add_vertex(v)
        if v not in self.out[u]:
            self.out[u][v] = color
            self.inc[v][u] = color

    def add_graph(self, other: "Subgraph") -> None:
        for v in other.out:
            self.add_vertex(v)
        for u, targets in other.out.items():
            for v, c in targets.items():
                self.add_edge(u, v, c)

    # -- queries -----------------------------------------------------------
    def __contains__(self, v: Vertex) -> bool:
        return v in self.out

    def vertices(self):
        return self.out.keys()

    def num_vertices(self) -> int:
        return len(self.out)

    def num_edges(self) -> int:
        return sum(len(t) for t in self.out.values())

    def out_edges(self, v: Vertex):
        return self.out.get(v, {}).items()

    def in_edges(self, v: Vertex):
        return self.inc.get(v, {}).items()

    def successors(self, v: Vertex, color: int | None = None):
        return [t for t, c in self.out.get(v, {}).items() if color is None or c == color]

    def predecessors(self, v: Vertex, color: int | None = None):
        return [s for s, c in self.inc.get(v, {}).items() if color is None or c == color]

    def map_vertices(self, fn) -> "Subgraph":
        """Rebuild the graph with fn applied to every vertex (used for the
        post-dfs direction-index tagging, TraversalEngine.java:75-81)."""
        g = Subgraph()
        for v in self.out:
            g.add_vertex(fn(v))
        for u, targets in self.out.items():
            for v, c in targets.items():
                g.add_edge(fn(u), fn(v), c)
        return g

    def find_vertex(self, kmer_str: str):
        """First vertex with this walk-orientation kmer (TraversalUtils.findVertex)."""
        for v in self.out:
            if v.kmer == kmer_str:
                return v
        return None

    def find_vertex_canonical(self, canon_str: str):
        for v in self.out:
            if v.canonical == canon_str:
                return v
        return None
