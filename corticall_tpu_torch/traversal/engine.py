"""Host traversal engine: cursor walks, contig assembly, DFS with stopping rules.

Faithful reimplementation of the reference engine semantics
(TraversalEngine.java:20-646): single-step cursor (seek/next/previous) with
link-assisted junction resolution, bidirectional assemble bounded by
maxBranchLength, and recursive DFS with per-branch stopping rules, repeat
copy-indices under links, and recruitment-color fallback.

This is the sequential correctness oracle; the batched device kernels
(ops/walk.py, ops/cuckoo.py, ops/walk_links.py) are validated against it and
used for throughput.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import kmer as km
from .. import graph as gr
from .linkstore import LinkStore
from .stopping import StoppingRule, TraversalState
from .subgraph import Subgraph, Vertex

FORWARD = "FORWARD"
REVERSE = "REVERSE"
BOTH = "BOTH"
AND = "AND"
OR = "OR"

_BASES = "ACGT"
_REV4_I = [int(f"{i:04b}"[::-1], 2) for i in range(16)]


@dataclass
class TraversalConfig:
    """TraversalEngineConfiguration.java:15-84 equivalent (fluent factory knobs)."""
    graph: object = None                      # CortexGraph
    traversal_colors: list = field(default_factory=list)
    joining_colors: list = field(default_factory=list)
    recruitment_colors: list = field(default_factory=list)
    secondary_colors: list = field(default_factory=list)
    direction: str = BOTH
    combination: str = OR
    connect_all_neighbors: bool = False
    max_branch_length: int = 75000
    stopping_rule: type = StoppingRule
    rois: object = None                       # CortexGraph of novel kmers
    links: list = field(default_factory=list)  # list[LinksData]
    references: dict = field(default_factory=dict)
    debug: bool = False


class TraversalEngine:
    def __init__(self, config: TraversalConfig):
        self.ec = config
        self.cur_kmer: str | None = None
        self.prev_kmer: str | None = None
        self.next_kmer: str | None = None
        self.seen: set | None = None
        self.kmer_sources: set | None = None
        self.links_initialized: bool = False
        self.link_store = LinkStore()
        self.go_forward = True

    # ------------------------------------------------------------------
    # neighbor expansion
    # ------------------------------------------------------------------
    def _all_adjacent(self, sk: str, want_next: bool) -> dict:
        """color -> set of adjacent kmer strings (TraversalUtils.getAllNext/PrevKmers).

        Pure-int edge decode (the numpy scalar path costs ~6us/color; this is
        the hottest host-walk helper)."""
        g = self.ec.graph
        rec, flipped = g.find_record_oriented(sk)
        out: dict[int, set] = {c: set() for c in range(g.num_colors)}
        if rec < 0:
            return out
        erow = g.edges[rec]
        stem_next = sk[1:]
        stem_prev = sk[:-1]
        for c in range(g.num_colors):
            e = int(erow[c])
            hi = e >> 4
            lo = e & 0xF
            if want_next:
                mask = hi if flipped else lo
            else:
                mask = _REV4_I[lo] if flipped else _REV4_I[hi]
            if mask:
                s = out[c]
                for b in range(4):
                    if mask & (1 << b):
                        s.add(stem_next + _BASES[b] if want_next
                              else _BASES[b] + stem_prev)
        return out

    def _vertices_for(self, kmers) -> set:
        g = self.ec.graph
        return {Vertex(sk, g.find_record(sk)) for sk in kmers}

    def get_prev_vertices(self, sk: str) -> set:
        """TraversalEngine.java:147-192 (traversal colors; recruitment fallback)."""
        return self._get_adjacent_vertices(sk, want_next=False)

    def get_next_vertices(self, sk: str) -> set:
        """TraversalEngine.java:194-239."""
        return self._get_adjacent_vertices(sk, want_next=True)

    def _get_adjacent_vertices(self, sk: str, want_next: bool) -> set:
        adj = self._all_adjacent(sk, want_next)
        combined: set = set()
        for c in self.ec.traversal_colors:
            combined |= adj.get(c, set())
        if combined:
            return self._vertices_for(combined)
        recruited: set = set()
        for c in self.ec.recruitment_colors:
            recruited |= adj.get(c, set())
        return self._vertices_for(recruited)

    # ------------------------------------------------------------------
    # cursor iteration (seek / next / previous)
    # ------------------------------------------------------------------
    def seek(self, sk: str) -> None:
        """TraversalEngine.java:321-335."""
        if sk is None:
            return
        self.cur_kmer = sk
        pvs = self.get_prev_vertices(sk)
        self.prev_kmer = next(iter(pvs)).kmer if len(pvs) == 1 else None
        nvs = self.get_next_vertices(sk)
        self.next_kmer = next(iter(nvs)).kmer if len(nvs) == 1 else None
        self.link_store = LinkStore()
        self.seen = set()
        self.links_initialized = False

    def has_next(self) -> bool:
        return self.next_kmer is not None

    def has_previous(self) -> bool:
        return self.prev_kmer is not None

    def _active_links(self):
        """Links files whose color-0 sample matches a traversal sample
        (initializeLinkStore/updateLinkStore filtering, :548-597)."""
        g = self.ec.graph
        samples = {g.sample_name(c) for c in self.ec.traversal_colors}
        return [lm for lm in self.ec.links if lm.sample_name in samples]

    def _add_links_for(self, sk: str, go_forward: bool) -> None:
        canon = min(sk, km.revcomp(sk))
        for lm in self._active_links():
            recs = lm.get(canon)
            if recs is not None:
                self.link_store.add(sk, canon, recs, go_forward, lm.source)

    def _initialize_link_store(self, go_forward: bool) -> None:
        self.links_initialized = True
        if self.ec.links and self.cur_kmer is not None:
            self._add_links_for(self.cur_kmer, go_forward)

    def _update_link_store(self, go_forward: bool) -> None:
        if not self.ec.links:
            return
        target = self.next_kmer if go_forward else self.prev_kmer
        if target is not None:
            self._add_links_for(target, go_forward)

    def _get_adjacent_by_link(self, kmer_str: str, adj_vertices: set, go_forward: bool):
        """Pick the link-dictated neighbor at a junction (getAdjacentKmer, :518-546)."""
        choice, sources = self.link_store.next_junction_choice()
        if choice is not None:
            if go_forward:
                adj = kmer_str[1:] + choice
            else:
                adj = choice + kmer_str[:-1]
            if any(v.kmer == adj for v in adj_vertices):
                return adj, sources
        return None, None

    def next(self) -> Vertex:
        """Advance the cursor one step forward (TraversalEngine.java:241-279)."""
        if self.next_kmer is None:
            raise StopIteration(f"no single advance kmer from cursor {self.cur_kmer!r}")
        if not self.links_initialized or not self.go_forward:
            self.go_forward = True
            self.seek(self.cur_kmer)
            self._initialize_link_store(True)
        self._update_link_store(True)

        g = self.ec.graph
        cv = Vertex(self.next_kmer, g.find_record(self.next_kmer),
                    sources=frozenset(self.kmer_sources or ()))

        self.prev_kmer = self.cur_kmer
        self.cur_kmer = self.next_kmer

        next_vertices = self.get_next_vertices(self.cur_kmer)
        self.next_kmer = None
        self.kmer_sources = None

        if len(next_vertices) == 1:
            nv = next(iter(next_vertices))
            if nv.kmer not in self.seen or self.link_store.is_active():
                self.next_kmer = nv.kmer
                self.seen.add(nv.kmer)
        elif len(next_vertices) > 1:
            adj, sources = self._get_adjacent_by_link(self.cur_kmer, next_vertices, True)
            self.next_kmer = adj
            self.kmer_sources = sources
            self.link_store.increment_ages()

        if self.link_store.num_new_paths() > 0:
            self.link_store.increment_ages()
        return cv

    def previous(self) -> Vertex:
        """Advance the cursor one step backward (TraversalEngine.java:281-319)."""
        if self.prev_kmer is None:
            raise StopIteration(f"no single prev kmer from cursor {self.cur_kmer!r}")
        if not self.links_initialized or self.go_forward:
            self.go_forward = False
            self.seek(self.cur_kmer)
            self._initialize_link_store(False)
        self._update_link_store(False)

        g = self.ec.graph
        cv = Vertex(self.prev_kmer, g.find_record(self.prev_kmer),
                    sources=frozenset(self.kmer_sources or ()))

        self.next_kmer = self.cur_kmer
        self.cur_kmer = self.prev_kmer

        prev_vertices = self.get_prev_vertices(self.cur_kmer)
        self.prev_kmer = None
        self.kmer_sources = None

        if len(prev_vertices) == 1:
            pv = next(iter(prev_vertices))
            if pv.kmer not in self.seen or self.link_store.is_active():
                self.prev_kmer = pv.kmer
                self.seen.add(pv.kmer)
        elif len(prev_vertices) > 1:
            adj, sources = self._get_adjacent_by_link(self.cur_kmer, prev_vertices, False)
            self.prev_kmer = adj
            self.kmer_sources = sources
            self.link_store.increment_ages()

        if self.link_store.num_new_paths() > 0:
            self.link_store.increment_ages()
        return cv

    # ------------------------------------------------------------------
    # assemble (bidirectional cursor contig, :112-145)
    # ------------------------------------------------------------------
    def assemble(self, seed: str) -> list:
        g = self.ec.graph
        contig = [Vertex(seed, g.find_record(seed))]
        contig.extend(self.assemble_dir(seed, True))
        contig[0:0] = self.assemble_dir(seed, False)
        return contig

    def assemble_dir(self, seed: str, go_forward: bool) -> list:
        contig: list = []
        self.seek(seed)
        if go_forward:
            while self.has_next() and len(contig) < self.ec.max_branch_length:
                contig.append(self.next())
        else:
            while self.has_previous() and len(contig) < self.ec.max_branch_length:
                contig.insert(0, self.previous())
        return contig

    # ------------------------------------------------------------------
    # DFS (:355-482)
    # ------------------------------------------------------------------
    def walk(self, seed: str) -> list:
        from .utils import to_walk
        return to_walk(self.dfs(seed), seed, self.ec.traversal_colors[0])

    def dfs(self, source: str, *sinks) -> Subgraph | None:
        g = self.ec.graph
        cv = Vertex(source, g.find_record(source))

        dfsr = (self._dfs_branch(cv, False, 0, 0, set(), sinks)
                if self.ec.direction in (BOTH, REVERSE) else None)
        dfsf = (self._dfs_branch(cv, True, 0, 0, set(), sinks)
                if self.ec.direction in (BOTH, FORWARD) else None)

        # tag direction indices on non-seed vertices (:75-81)
        if dfsr is not None:
            dfsr = dfsr.map_vertices(lambda v: v if v == cv else v.with_index(-1))
        if dfsf is not None:
            dfsf = dfsf.map_vertices(lambda v: v if v == cv else v.with_index(1))

        combined = None
        if self.ec.combination == OR:
            if dfsr is not None or dfsf is not None:
                combined = Subgraph()
                if dfsr is not None:
                    combined.add_graph(dfsr)
                if dfsf is not None:
                    combined.add_graph(dfsf)
        else:  # AND
            if dfsr is not None and dfsf is not None:
                combined = Subgraph()
                combined.add_graph(dfsr)
                combined.add_graph(dfsf)

        if combined is not None:
            return self._add_secondary_colors(combined)
        return None

    def dfs_multi(self, sources, sinks=None) -> Subgraph | None:
        """dfs over many sources, merging results (:37-58)."""
        sinks = tuple(sinks or ())
        out = None
        for source in sources:
            one = self.dfs(source, *sinks)
            if one is not None:
                if out is None:
                    out = one
                else:
                    out.add_graph(one)
        return out

    def _connect(self, g: Subgraph, cv: Vertex, pvs, nvs) -> None:
        color = self.ec.traversal_colors[0] if self.ec.traversal_colors else 0
        g.add_vertex(cv)
        if pvs:
            for pv in pvs:
                g.add_edge(pv, cv, color)
        if nvs:
            for nv in nvs:
                g.add_edge(cv, nv, color)

    def _dfs_branch(self, cv: Vertex, go_forward: bool, graph_size: int,
                    junction_depth: int, visited_old: set, sinks) -> Subgraph | None:
        g = Subgraph()
        visited = set(visited_old)

        if self.ec.links:
            self.seek(cv.kmer)

        rule: StoppingRule = self.ec.stopping_rule()

        while True:
            pvs = self.get_prev_vertices(cv.kmer)
            nvs = self.get_next_vertices(cv.kmer)
            avs = set(nvs) if go_forward else set(pvs)
            rvs = pvs if go_forward else nvs

            if self.ec.links:
                qv = None
                if go_forward and self.has_next():
                    qv = self.next()
                elif not go_forward and self.has_previous():
                    qv = self.previous()
                if qv is not None:
                    # repeat vertices get distinct copy indices (:380-407)
                    lv = None
                    while True:
                        if go_forward:
                            copy = 0 if lv is None else lv.copy + 1
                        else:
                            copy = 0 if lv is None else lv.copy - 1
                        lv = Vertex(qv.kmer, qv.rec, copy)
                        if lv not in visited:
                            break
                    avs = {lv}

            if self.ec.connect_all_neighbors:
                self._connect(g, cv, pvs, nvs)

            avs = {av for av in avs if av not in visited}

            previously_visited = cv in visited
            visited.add(cv)

            ts = TraversalState(
                vertex=cv, go_forward=go_forward,
                traversal_colors=self.ec.traversal_colors,
                joining_colors=self.ec.joining_colors,
                graph_size=graph_size + g.num_vertices(),
                junction_depth=junction_depth,
                branch_size=g.num_vertices(),
                num_adjacent_edges=len(avs),
                num_adjacent_reverse_edges=len(rvs),
                children_already_traversed=False,
                reached_max_branch_length=g.num_vertices() > self.ec.max_branch_length,
                rois=self.ec.rois, sinks=set(sinks), graph=self.ec.graph,
            )

            if not previously_visited and rule.keep_going(ts):
                if len(avs) == 1:
                    av = next(iter(avs))
                    if go_forward:
                        self._connect(g, cv, None, avs)
                    else:
                        self._connect(g, cv, avs, None)
                    cv = av
                else:
                    children_successful = False
                    for av in sorted(avs, key=lambda v: (v.kmer, v.copy)):
                        branch = self._dfs_branch(av, go_forward,
                                                  graph_size + g.num_vertices(),
                                                  junction_depth + 1, visited, sinks)
                        if branch is not None:
                            if go_forward:
                                self._connect(branch, cv, None, {av})
                            else:
                                self._connect(branch, cv, {av}, None)
                            g.add_graph(branch)
                            children_successful = True

                    ts_child = TraversalState(
                        vertex=cv, go_forward=go_forward,
                        traversal_colors=self.ec.traversal_colors,
                        joining_colors=self.ec.joining_colors,
                        graph_size=graph_size + g.num_vertices(),
                        junction_depth=junction_depth,
                        branch_size=g.num_vertices(),
                        num_adjacent_edges=len(avs),
                        num_adjacent_reverse_edges=len(rvs),
                        children_already_traversed=True,
                        reached_max_branch_length=g.num_vertices() > self.ec.max_branch_length,
                        rois=self.ec.rois, sinks=set(sinks), graph=self.ec.graph,
                    )
                    if children_successful or rule.has_succeeded(ts_child):
                        return g
                    return None
            elif rule.succeeded():
                return g
            else:
                return None

    def _add_secondary_colors(self, g: Subgraph) -> Subgraph:
        """Overlay secondary-color edges between existing vertices' neighbors (:599-645)."""
        m = Subgraph()
        m.add_graph(g)
        if not self.ec.secondary_colors:
            return m
        graph = self.ec.graph
        for c in self.ec.secondary_colors:
            if c in self.ec.traversal_colors:
                continue
            g2 = Subgraph()
            for v in list(g.vertices()):
                pks = self._all_adjacent(v.kmer, want_next=False)
                nks = self._all_adjacent(v.kmer, want_next=True)
                g2.add_vertex(v)
                for pk in pks.get(c, ()):
                    pv = Vertex(pk, graph.find_record(pk))
                    g2.add_edge(pv, v, c)
                for nk in nks.get(c, ()):
                    nv = Vertex(nk, graph.find_record(nk))
                    g2.add_edge(v, nv, c)
            m.add_graph(g2)
        return m
