"""Subgraph linearization and conversion helpers (TraversalUtils.java:20-613)."""

from __future__ import annotations

from .subgraph import Subgraph, Vertex


def to_contig(walk) -> str:
    """Vertices -> sequence: first kmer + last base of each following kmer
    (TraversalUtils.java:367-381)."""
    out = []
    for v in walk:
        if not out:
            out.append(v.kmer)
        else:
            out.append(v.kmer[-1])
    return "".join(out)


def _all_same_canonical(vs) -> bool:
    return all(v.canonical == vs[0].canonical for v in vs[1:])


def to_walk(g: Subgraph | None, sk: str, color: int, graph=None) -> list:
    """Linearize a dfs subgraph from a seed along single-color in/out degree
    (TraversalUtils.java:387-488).

    graph: optional CortexGraph for the coverage>0 seed filter; vertices carry
    rec indices so coverage is checked through it when provided.
    """
    w: list = []
    if g is None:
        return w

    seed = None
    for v in g.vertices():
        if v.kmer == sk and v.rec >= 0:
            if graph is not None and graph.coverage(v.rec, color) <= 0:
                continue
            if seed is None or v.copy < seed.copy:
                seed = v
    if seed is None:
        return w

    w.append(seed)

    seen: set = set()
    cv = seed
    while cv is not None and cv not in seen:
        nvs = [t for t, c in g.out_edges(cv) if c == color]
        nvs = [t for t in nvs if t != cv]
        nv = None
        if len(nvs) == 1:
            nv = nvs[0]
        elif len(nvs) > 1 and _all_same_canonical(nvs):
            nv = min(nvs, key=lambda v: v.copy)
        if nv is not None:
            w.append(nv)
            seen.add(cv)
        cv = nv

    seen = set()
    cv = seed
    while cv is not None and cv not in seen:
        pvs = [s for s, c in g.in_edges(cv) if c == color]
        pvs = [s for s in pvs if s != cv]
        pv = None
        if len(pvs) == 1:
            pv = pvs[0]
        elif len(pvs) > 1 and _all_same_canonical(pvs):
            pv = max(pvs, key=lambda v: v.copy)
        if pv is not None:
            w.insert(0, pv)
            seen.add(cv)
        cv = pv

    return w


def to_graph(walk, colors, graph) -> Subgraph:
    """Walk -> chain subgraph with edges for every color covered at both ends
    (TraversalUtils.java:327-348)."""
    g = Subgraph()
    if not walk:
        return g
    pv = walk[0]
    g.add_vertex(pv)
    for nv in walk[1:]:
        g.add_vertex(nv)
        for c in colors:
            if (pv.rec >= 0 and nv.rec >= 0
                    and graph.coverage(pv.rec, c) > 0 and graph.coverage(nv.rec, c) > 0):
                g.add_edge(pv, nv, c)
        pv = nv
    return g


def subset_graph(g: Subgraph, color: int) -> Subgraph:
    """Edges of one color only (TraversalUtils.java:350-365)."""
    gs = Subgraph()
    for u in g.vertices():
        for v, c in g.out_edges(u):
            if c == color:
                gs.add_edge(u, v, c)
    return gs


def find_vertex(g: Subgraph, sk: str):
    """TraversalUtils.java:500-508."""
    return g.find_vertex(sk) if g is not None else None


def find_vertex_canonical(g: Subgraph, canon: str):
    """TraversalUtils.java:490-498."""
    return g.find_vertex_canonical(canon) if g is not None else None


def connected_components(g: Subgraph) -> list:
    """Weakly connected components (ConnectivityInspector equivalent)."""
    seen: set = set()
    comps = []
    for v in g.vertices():
        if v in seen:
            continue
        comp = set()
        stack = [v]
        seen.add(v)
        while stack:
            u = stack.pop()
            comp.add(u)
            for t, _ in g.out_edges(u):
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
            for s, _ in g.in_edges(u):
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        comps.append(comp)
    return comps


def fill_gaps(walk, graph, links, colors) -> Subgraph:
    """TraversalUtils.fillGaps(List<CortexVertex>, ...) port
    (TraversalUtils.java:121-205; the reference ships it without call sites —
    Call's close_gaps covers the production pattern).  Per color: connect the
    covered sub-walk, then close coverage gaps with a DestinationStopper DFS
    (max branch 1000) from vertices with unrealized next-kmers to vertices
    with unrealized prev-kmers; merge all colors."""
    from .engine import TraversalConfig, TraversalEngine, FORWARD, REVERSE, OR
    from .stopping import DestinationStopper

    g_all = Subgraph()
    for c in colors:
        g = Subgraph()
        for i, v in enumerate(walk):
            if v.rec >= 0 and int(graph.coverages[v.rec, c]) > 0:
                g.add_vertex(v)
                if i > 0:
                    p = walk[i - 1]
                    if p.rec >= 0 and int(graph.coverages[p.rec, c]) > 0:
                        g.add_edge(p, v, c)

        def engine(direction):
            return TraversalEngine(TraversalConfig(
                graph=graph, traversal_colors=[c], direction=direction,
                combination=OR, stopping_rule=DestinationStopper,
                max_branch_length=1000, links=list(links)))

        ef = engine(FORWARD)
        sources, sinks = set(), set()
        for v in g.vertices():
            next_in_g = {t.kmer for t, _ in g.out_edges(v)}
            if ef._all_adjacent(v.kmer, True).get(c, set()) - next_in_g:
                sources.add(v.kmer)
            prev_in_g = {s.kmer for s, _ in g.in_edges(v)}
            if ef._all_adjacent(v.kmer, False).get(c, set()) - prev_in_g:
                sinks.add(v.kmer)

        g_fill = ef.dfs_multi(sorted(sources), sorted(sinks))
        if g_fill is None:
            g_fill = engine(REVERSE).dfs_multi(sorted(sinks), sorted(sources))
        if g_fill is not None:
            g.add_graph(g_fill)
        g_all.add_graph(g)
    return g_all
