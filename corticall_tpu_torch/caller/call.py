"""Call — the de novo mutation caller (the reference's flagship command).

Faithful port of commands/discover/call/Call.java (2452 LoC): per partition
contig, section around novel-kmer runs, assemble parental candidate haplotypes
(dfs + gap closing + flank extension), mosaic-align the trimmed child query
against labelled targets with Tesserae, extract variants from the alignment
columns (small/large bubbles, repeats, breakpoints), merge adjacent bubbles
and paired breakends, lift coordinates onto the reference via flank
realignment, and emit a VCF + per-ROI accounting table.

Method-by-method line citations are given inline.  Deliberate deviations:
- iteration orders that Java leaves to HashMap/HashSet hashing are made
  deterministic (sorted/insertion order) — flagged where they occur;
- a non-terminating loop in the reference (mergeDoubleBreakpoints kmer
  builders, Call.java:966-987/1259-1286, which spin when the child column is
  a gap) gets a break guard.

Copy of corticall_tpu/caller/call.py with the port's two device entry
points: `_make_tesserae` builds ops/tesserae_torch.TesseraeDevice (the CUDA
Tesserae kernel) and `label_targets` runs models/contig_aligner (the CUDA
banded-SW pre-score), both on `device`.
"""

from __future__ import annotations

import numpy as np

from .. import kmer as km
from ..device import resolve
from ..models.contig_aligner import align_contigs
from ..models.tesserae import Tesserae
from ..ops.tesserae_torch import TesseraeDevice
from ..traversal import (BOTH, FORWARD, OR, REVERSE, TraversalConfig,
                         TraversalEngine, to_contig, to_walk)
from ..traversal import utils as tu
from ..traversal.stopping import ContigStopper, DestinationStopper
from ..traversal.subgraph import Subgraph, Vertex
from ..utils.profiling import SectionTimer
from .variants import Variant, VariantSorterSet, write_vcf

# vectorized canonical-kmer hashing for link-key membership: a hash
# collision only routes one more chain to the exact linked replay (the
# correctness oracle), so false positives are safe and false negatives
# impossible
_HASH_POWERS: dict = {}


def _kmer_hash_codes(codes: np.ndarray) -> np.ndarray:
    """uint8[N, k] base codes -> uint64[N] polynomial hashes (wraparound)."""
    k = codes.shape[1]
    p = _HASH_POWERS.get(k)
    if p is None:
        # modular powers under uint64 wraparound; numpy warns on scalar
        # overflow even though wrapping is the intent, so compute in bulk
        # (array ops wrap silently)
        mult = np.uint64(0x9E3779B97F4A7C15)
        p = np.empty(k, np.uint64)
        p[0] = 1
        for i in range(1, k):
            p[i:i + 1] = p[i - 1:i] * mult
        _HASH_POWERS[k] = p
    return (codes.astype(np.uint64) * p[None, :]).sum(axis=1,
                                                      dtype=np.uint64)


# batched walk-replay/link-membership helpers (shared with the prefilter
# chain walks): ops/walk_np.py owns them; re-exported here for callers/tests
from ..ops.walk_np import (rolling_window_hashes as _rolling_window_hashes,
                           batch_replay_exts as _batch_replay_exts,
                           batch_link_touch as _batch_link_touch)


def graph_from_dfs_edges(graph, edges, seed_kmer: str, color: int,
                         reverse: bool) -> Subgraph:
    """Rebuild the Subgraph a host engine.dfs would return from a native
    dfs_dest edge list (closeGaps probes).  reverse probes ran forward in
    revcomp space: map each vertex back (rc kmer, negated copy), flip edge
    direction, and tag non-seed vertices with the post-dfs direction index
    (TraversalEngine.java:75-81)."""
    gg = Subgraph()
    vcache: dict = {}

    def vert(kmer_str, copy):
        if reverse:
            kmer_str = km.revcomp(kmer_str)
            copy = -copy
        v = vcache.get((kmer_str, copy))
        if v is None:
            idx = (0 if (kmer_str == seed_kmer and copy == 0)
                   else (-1 if reverse else 1))
            v = Vertex(kmer_str, graph.find_record(kmer_str), copy, idx)
            vcache[(kmer_str, copy)] = v
        return v

    for (u, uc), (v, vc) in edges:
        if reverse:
            gg.add_edge(vert(v, vc), vert(u, uc), color)
        else:
            gg.add_edge(vert(u, uc), vert(v, vc), color)
    return gg


class Caller:
    def __init__(self, graph, rois_graph, partitions, backgrounds,
                 references=None, links=(), partition_names=None,
                 del_=0.35, eps=0.90, rho=6e-4, term=1e-3,
                 window=200, split_distance=2000, logger=None,
                 tesserae: str = "auto", device=None):
        """partitions: [(name_header, sequence)] (FASTA order).
        references: {background_name: IndexedReference}.

        tesserae: "device" runs the mosaic-alignment DP through
        ops/tesserae_torch.TesseraeDevice on `device` (its plain twin on the
        CPU), "host" keeps the numpy oracle, "auto" picks device when
        `device` is CUDA (Tesserae is the Call hot path, SURVEY §3.2 /
        Call.java:2126-2263 + Tesserae.java:127-132).  device: the kernels'
        device (default: the CUDA card, and RuntimeError without one; "cpu"
        runs the plain twins)."""
        self.device = resolve(device)
        self.graph = graph
        self.rois_graph = rois_graph
        self.partitions = partitions
        self.backgrounds = list(backgrounds)
        self.references = references or {}
        self.links = list(links)
        self.partition_names = set(partition_names) if partition_names else None
        self.ma = self._make_tesserae(tesserae, del_, eps, rho, term)
        self.window = window
        self.split_distance = split_distance
        self.k = graph.kmer_size
        self.log = logger or (lambda *a: None)
        self._walkers: dict = {}
        # per-phase wall-clock (device phases prefixed "device:"), reported
        # by the pipeline's call stage — the reference logs only a total
        # (Dispatch.java:75-84)
        self.timer = SectionTimer()
        # batched contig-aligner accounting (label_targets): device-scored
        # candidate windows vs host tracebacks
        self.align_stats: dict = {}

    def _make_tesserae(self, mode: str, del_, eps, rho, term):
        if mode == "auto":
            mode = "device" if self.device.type == "cuda" else "host"
        if mode == "device":
            return TesseraeDevice(del_, eps, rho, term, device=self.device)
        return Tesserae(del_, eps, rho, term)

    # ------------------------------------------------------------------
    # loaders (Call.java:2348-2381)
    # ------------------------------------------------------------------
    def load_rois(self) -> set:
        return {self.rois_graph.kmer_string(i)
                for i in range(self.rois_graph.num_records)}

    def _roi_coverage(self, canon: str) -> int:
        """Child coverage of a novel kmer (rois carry the child color)."""
        i = self.rois_graph.find_record(canon)
        return int(self.rois_graph.coverages[i, 0]) if i >= 0 else 0

    def load_child_walk(self, contig: str) -> list:
        w = []
        seen: dict = {}
        for i in range(len(contig) - self.k + 1):
            sk = contig[i:i + self.k]
            seen[sk] = seen.get(sk, -1) + 1
            w.append(Vertex(sk, self.graph.find_record(sk), copy=seen[sk]))
        return w

    # ------------------------------------------------------------------
    # sectioning (Call.java:2383-2452)
    # ------------------------------------------------------------------
    def get_regions(self, rois: set, cvs: list) -> list:
        regions = []
        start = -1
        stop = 0
        for i, v in enumerate(cvs):
            if v.canonical in rois:
                if start == -1:
                    start = i
                stop = i
            else:
                if start > -1:
                    regions.append((start, stop))
                    start = -1
                    stop = 0
        if start > -1:
            regions.append((start, stop))
        return regions

    def section_contig(self, rois: set, w: list):
        regions = self.get_regions(rois, w)
        if not regions:
            return None
        sub_start = max(regions[0][0] - self.window, 0)
        sub_stop = min(regions[-1][1] + self.window, len(w) - 1)
        sections = []
        for i in range(len(regions) - 1):
            if regions[i + 1][0] - regions[i][1] > self.split_distance:
                sections.append((sub_start, regions[i][1] + self.window))
                sub_start = regions[i + 1][0] - self.window
        sections.append((sub_start, sub_stop))
        return [(a, b, w[a:b + 1]) for a, b in sections]

    # ------------------------------------------------------------------
    # candidate haplotype assembly (Call.java:2126-2263)
    # ------------------------------------------------------------------
    def _engine(self, colors, direction, rule, max_branch=75000):
        return TraversalEngine(TraversalConfig(
            graph=self.graph, traversal_colors=list(colors), direction=direction,
            combination=OR, stopping_rule=rule, max_branch_length=max_branch,
            links=self.links))

    # ------------------------------------------------------------------
    # batched chain walks (the dfs-with-ContigStopper hot path of
    # fasterAssembleCandidateHaplotypes, Call.java:2126-2230, moved off the
    # per-vertex host engine onto the batched walkers)
    # ------------------------------------------------------------------
    def _chain_walker(self, colors):
        """Cached per-color-set batched walker: (native table or None, active
        link set keys).  active follows the engine's _active_links sample
        filter; link_keys is the union of canonical kmers carrying link
        records — any chain touching one gets the exact host-oracle replay."""
        key = tuple(colors)
        w = self._walkers.get(key)
        if w is None:
            samples = {self.graph.sample_name(c) for c in colors}
            active = [lm for lm in self.links if lm.sample_name in samples]
            key_strs: set = set()
            for lm in active:
                idx = getattr(lm, "index", None)
                key_strs |= set(idx if idx is not None
                                else getattr(lm, "records", {}))
            # canonical link-carrying kmers as sorted uint64 hashes:
            # membership tests run vectorized per walked path instead of
            # string-decoding every window
            link_keys = None
            if key_strs:
                link_keys = np.unique(_kmer_hash_codes(
                    km.strings_to_codes(sorted(key_strs))))
            from .. import native as nat
            table = linked = None
            if nat.available():
                edges = np.bitwise_or.reduce(
                    self.graph.edges[:, list(colors)], axis=1)
                table = nat.WalkTableNative(
                    np.ascontiguousarray(self.graph.kmers), edges, self.k)
                # built even with no active links: the dfs probes
                # (close_gaps) need the packed table either way
                linked = nat.LinksWalkerNative(self.graph, list(colors),
                                               active)
            w = (table, link_keys, linked)
            self._walkers[key] = w
        return w

    def _batched_chain_exts(self, colors, seeds: list, max_branch: int):
        """(fwd_ext, back_ext) per seed with exact dfs-with-ContigStopper
        semantics, or None per seed where links could alter the walk (links
        only ever EXTEND a chain past the link-free stop point, and only when
        a walked kmer carries link records — so link-free chains not touching
        the link key set are exact as-is; the rest are flagged for the
        caller's host-oracle replay).  Returns None entirely when the native
        library is unavailable."""
        table, link_keys, linked = self._chain_walker(colors)
        if table is None or not seeds:
            return None
        k = self.k
        rc = [km.revcomp(s) for s in seeds]
        fb, fc, _ = table.walk(km.pack_codes(km.strings_to_codes(seeds), k),
                               max_branch)
        rb, rcy, _ = table.walk(km.pack_codes(km.strings_to_codes(rc), k),
                                max_branch)
        fb, rb = np.asarray(fb).T, np.asarray(rb).T
        # batched decode + replay gates (one rolling-hash pass over all
        # paths instead of per-seed kmerize/unique — the per-seed python
        # was the Call stage's dominant cost at flagship scale)
        fwds = _batch_replay_exts(seeds, fb, np.asarray(fc), max_branch)
        backs = _batch_replay_exts(rc, rb, np.asarray(rcy), max_branch)
        out: list = [(f, b) for f, b in zip(fwds, backs)]
        if link_keys is not None:
            paths = [(km.revcomp(b) if b else "") + s + f
                     for s, (f, b) in zip(seeds, out)]
            touched = _batch_link_touch(paths, k, link_keys)
            relink = np.nonzero(touched)[0]
            for i in relink:
                out[i] = None
            if len(relink) and linked is not None:
                # exact link-assisted walks (native unbounded LinkStore)
                ss = [seeds[i] for i in relink]
                f, _ = linked.walk(ss, max_branch)
                bk, _ = linked.walk([km.revcomp(s) for s in ss], max_branch)
                for j, i in enumerate(relink):
                    out[i] = (f[j], bk[j])
        return out

    def _path_graph_from_exts(self, seed: str, fwd_ext: str, back_ext: str,
                              color: int) -> Subgraph:
        """Rebuild the Subgraph engine.dfs(seed) (BOTH, ContigStopper) would
        return, from the walked extensions: a linear path with the engine's
        copy-index rule (occurrence count per walk-orientation kmer, negative
        on the reverse side; TraversalEngine.java:380-407) and the post-dfs
        direction index tags (+1 forward / -1 reverse / 0 seed)."""
        g = Subgraph()
        if not fwd_ext and not back_ext:
            return g                      # host dfs returns an empty graph too
        k = self.k
        path = (km.revcomp(back_ext) if back_ext else "") + seed + fwd_ext
        sp = len(back_ext)                # seed window index
        codes = km.string_to_codes_permissive(path)
        windows = km.kmerize_codes(codes, k)
        canon, _ = km.canonicalize_codes(windows)
        recs = self.graph.find_records(km.pack_codes(canon, k))
        wins = km.codes_to_strings(windows)

        n = len(wins)
        verts: list = [None] * n
        occ: dict = {}
        for i in range(sp, n):
            c = occ.get(wins[i], 0)
            occ[wins[i]] = c + 1
            verts[i] = Vertex(wins[i], int(recs[i]), c, 1 if i > sp else 0)
        occ = {}
        for i in range(sp, -1, -1):
            c = occ.get(wins[i], 0)
            occ[wins[i]] = c + 1
            if i == sp:
                continue                  # seed vertex from the forward pass
            verts[i] = Vertex(wins[i], int(recs[i]), -c, -1)
        if verts[sp] is None:             # back_ext only
            verts[sp] = Vertex(wins[sp], int(recs[sp]), 0, 0)
        for v in verts:
            g.add_vertex(v)
        for i in range(n - 1):
            g.add_edge(verts[i], verts[i + 1], color)
        return g

    def assemble_candidate_haplotypes(self, ws: list, parent_name: str) -> dict:
        # sub-phase timers (asm/ prefix): nested inside the call loop's
        # mixed:assemble_haplotypes section, so their sum ~= that phase —
        # the attribution CALL_PHASES needs to steer optimization
        tmr = self.timer
        colors = self.graph.colors_for_samples([parent_name])
        g = Subgraph()
        g_kmers: set = set()

        contigs: set = set()
        seeds, seen_seeds = [], set()
        for v in ws:
            has_cov = any(v.rec >= 0 and self.graph.coverage(v.rec, c) > 0
                          for c in colors)
            if has_cov and v.kmer not in seen_seeds:
                seen_seeds.add(v.kmer)
                seeds.append(v.kmer)
        with tmr.section("asm/chain_walks"):
            exts = self._batched_chain_exts(colors, seeds,
                                            max_branch=len(ws))

        if exts is None:
            e = self._engine(colors, BOTH, ContigStopper, max_branch=len(ws))
            for s in seeds:
                if s in g_kmers:
                    continue
                gs = e.dfs(s)
                if gs is not None and gs.num_vertices() > 0:
                    contigs.add(to_contig(to_walk(gs, s, colors[0])))
                    g.add_graph(gs)
                    g_kmers.update(x.kmer for x in gs.vertices())
        else:
            replay_engine = None
            with tmr.section("asm/path_graphs"):
                for s, ext in zip(seeds, exts):
                    if s in g_kmers:
                        continue
                    if ext is None:       # device link-cap overflow lane
                        if replay_engine is None:
                            replay_engine = self._engine(colors, BOTH,
                                                         ContigStopper,
                                                         max_branch=len(ws))
                        gs = replay_engine.dfs(s)
                        if gs is not None and gs.num_vertices() > 0:
                            contigs.add(to_contig(to_walk(gs, s, colors[0])))
                            g.add_graph(gs)
                            g_kmers.update(x.kmer for x in gs.vertices())
                        continue
                    fwd_ext, back_ext = ext
                    gs = self._path_graph_from_exts(s, fwd_ext, back_ext,
                                                    colors[0])
                    if gs.num_vertices() > 0:
                        contigs.add((km.revcomp(back_ext) if back_ext
                                     else "") + s + fwd_ext)
                        g.add_graph(gs)
                        g_kmers.update(x.kmer for x in gs.vertices())

        with tmr.section("asm/graph_ends"):
            in_ends = self.get_closeable_graph_ends(colors, g, outgoing=False)
            out_ends = self.get_closeable_graph_ends(colors, g, outgoing=True)
        with tmr.section("asm/close_gaps"):
            self.close_gaps(colors, g, in_ends, out_ends)
        with tmr.section("asm/extend_flanks"):
            self.extend_flanks(colors, g, in_ends, out_ends)

        targets: dict = {}
        if g.num_edges() > 0:
            rep_color = colors[0]
            walks = []
            with tmr.section("asm/components_walks"):
                for cs in tu.connected_components(g):
                    w = []
                    for cv in sorted(cs,
                                     key=lambda v: (v.kmer, v.copy, v.index)):
                        wa = to_walk(g, cv.kmer, rep_color)
                        if len(wa) == len(w):
                            break
                        elif len(wa) > len(w):
                            w = wa
                    if w:
                        walks.append(w)

            indices = {cv.canonical for cv in ws}
            for w in walks:
                actual_start, actual_end = None, -1
                shared = 0
                for i, cv in enumerate(w):
                    if cv.canonical in indices:
                        shared += 1
                        if actual_start is None:
                            actual_start = i
                        actual_end = i
                if actual_start is None:
                    actual_start = 0
                if actual_end == -1 or actual_end == actual_start:
                    # the reference keeps the walk's entire tail here
                    # (Call.java:2210: actualEnd = w.size()-1), which lets a
                    # single-shared-kmer component carry a multi-10kb
                    # closeGaps detour into the Tesserae DP (observed: a
                    # 32 kb target -> 69 GB device DP; the reference's own
                    # 8 GiB JVM would OOM equally).  Deliberate deviation:
                    # clamp the tail to section length + 2*window — ample
                    # candidate-haplotype context for any section variant.
                    actual_end = min(len(w) - 1,
                                     actual_start + len(ws) + 2 * self.window)
                if shared > 0:
                    contigs.add(to_contig(w[actual_start:actual_end]))

            i = 0
            for contig in sorted(contigs):  # deterministic (Java: HashSet order)
                if contig:
                    cid = f"{parent_name}:{parent_name}_unknown:{parent_name}_contig{i}_fastasm"
                    targets[cid] = contig
                    i += 1
        return targets

    def get_closeable_graph_ends(self, colors, g: Subgraph, outgoing: bool) -> set:
        ends: set = set()
        if g.num_edges() > 0:
            for cv in g.vertices():
                if outgoing and len(g.successors(cv)) == 0:
                    ends.update(g.predecessors(cv))
                elif not outgoing and len(g.predecessors(cv)) == 0:
                    ends.update(g.successors(cv))

        ef = self._engine(colors, FORWARD, ContigStopper, max_branch=10)
        er = self._engine(colors, REVERSE, ContigStopper, max_branch=10)

        # ContigStopper never reads the sink, so the forward probe depends
        # only on e0 and the reverse probe only on e1 (Call.java:2288-2346
        # behavior) — cache one probe per end instead of O(ends^2) dfs calls;
        # the pair loop and removal order below are unchanged.
        fwd_ok: dict = {}
        rev_ok: dict = {}
        to_remove: set = set()
        ends_sorted = sorted(ends, key=lambda v: (v.kmer, v.copy, v.index))
        for e0 in ends_sorted:
            for e1 in ends_sorted:
                if e0 != e1 and e0 not in to_remove and e1 not in to_remove:
                    if e0 not in fwd_ok:
                        gf = ef.dfs(e0.kmer, km.revcomp(e1.kmer))
                        fwd_ok[e0] = gf is not None and gf.num_vertices() > 0
                    if e1 not in rev_ok:
                        rc = km.revcomp(e1.kmer)
                        gr = er.dfs(rc, e0.kmer)
                        rev_ok[e1] = gr is not None and gr.num_vertices() > 0
                    if fwd_ok[e0] or rev_ok[e1]:
                        to_remove.add(e0)
                        to_remove.add(e1)
        return ends - to_remove

    def close_gaps(self, colors, g: Subgraph, in_ends, out_ends) -> None:
        pairs = [(ie, oe) for ie in sorted(in_ends, key=lambda v: v.kmer)
                 for oe in sorted(out_ends, key=lambda v: v.kmer)]
        if not pairs:
            return
        _, _, linked = self._chain_walker(colors)
        if linked is not None:
            # batched native probes (exact engine/DestinationStopper twin);
            # reverse probes run forward from the revcomp seed
            use_links = bool(self.links)
            fs, fed = linked.dfs_dest([ie.kmer for ie, _ in pairs],
                                      [oe.kmer for _, oe in pairs],
                                      use_links=use_links)
            retry = [i for i in range(len(pairs)) if not (fs[i] and fed[i])]
            if retry:
                rs, red = linked.dfs_dest(
                    [km.revcomp(pairs[i][1].kmer) for i in retry],
                    [km.revcomp(pairs[i][0].kmer) for i in retry],
                    use_links=use_links)
                rpos = {p: j for j, p in enumerate(retry)}
            for i, (ie, oe) in enumerate(pairs):
                if fs[i] and fed[i]:
                    g.add_graph(graph_from_dfs_edges(
                        self.graph, fed[i], ie.kmer, colors[0],
                        reverse=False))
                else:
                    j = rpos[i]
                    if rs[j] and red[j]:
                        g.add_graph(graph_from_dfs_edges(
                            self.graph, red[j], oe.kmer, colors[0],
                            reverse=True))
            return
        ef = self._engine(colors, FORWARD, DestinationStopper)
        er = self._engine(colors, REVERSE, DestinationStopper)
        for ie, oe in pairs:
            gg = ef.dfs(ie.kmer, oe.kmer)
            if gg is None or gg.num_vertices() == 0:
                gg = er.dfs(oe.kmer, ie.kmer)
            if gg is not None and gg.num_vertices() > 0:
                g.add_graph(gg)

    def extend_flanks(self, colors, g: Subgraph, in_ends, out_ends) -> None:
        seeds = [cv.kmer for cvs in (in_ends, out_ends)
                 for cv in sorted(cvs, key=lambda v: v.kmer)]
        exts = self._batched_chain_exts(colors, seeds, max_branch=500)
        if exts is None:
            eb = self._engine(colors, BOTH, ContigStopper, max_branch=500)
            for s in seeds:
                gg = eb.dfs(s)
                if gg is not None and gg.num_vertices() > 0:
                    g.add_graph(gg)
            return
        replay_engine = None
        for s, ext in zip(seeds, exts):
            if ext is None:               # device link-cap overflow lane
                if replay_engine is None:
                    replay_engine = self._engine(colors, BOTH, ContigStopper,
                                                 max_branch=500)
                gg = replay_engine.dfs(s)
                if gg is not None and gg.num_vertices() > 0:
                    g.add_graph(gg)
                continue
            gg = self._path_graph_from_exts(s, ext[0], ext[1], colors[0])
            if gg.num_vertices() > 0:
                g.add_graph(gg)

    # ------------------------------------------------------------------
    # query trimming + target labelling (Call.java:1920-1986)
    # ------------------------------------------------------------------
    def sort_alignments(self, background: str, target: str) -> list:
        if background not in self.references:
            return []
        a = self.references[background].align(target)
        # stable sort: length desc, NM asc (the reference's mapq tiebreak
        # compares s1 to itself, so it is a no-op — replicated by omission)
        return sorted(a, key=lambda s: (-(s.end - s.start), s.nm))

    def trim_query(self, ws: list, targets: dict, rois: set):
        """Same semantics as the reference's trimQuery (Call.java:1946-1986)
        but vectorized: the old per-target per-window python loop (string
        slice + revcomp + dict probe per window) dominated the Call stage's
        host time; here the section's canonical kmers become one sorted key
        array and every target kmerizes/canonicalizes in numpy."""
        first_index, last_index = None, 0
        first_novel, last_novel = -1, -1
        for i, v in enumerate(ws):
            if v.canonical in rois:
                if first_novel == -1:
                    first_novel = i
                last_novel = i

        k = self.k
        keys = km.words_to_bytes_be(km.pack_codes(km.canonicalize_codes(
            km.strings_to_codes([v.kmer for v in ws]))[0], k), k)
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        uniq, ustart = np.unique(sk, return_index=True)
        uend = np.append(ustart[1:], len(sk))
        firsts = np.array([order[s:e].min() for s, e in zip(ustart, uend)],
                          dtype=np.int64)
        lasts = np.array([order[s:e].max() for s, e in zip(ustart, uend)],
                         dtype=np.int64)

        for target in targets.values():
            codes = km.string_to_codes_permissive(target)
            if len(codes) < k:
                continue
            wins = km.kmerize_codes(codes, k)
            ok = (wins < 4).all(axis=1)
            if not ok.any():
                continue
            canon, _ = km.canonicalize_codes(wins[ok])
            tk = km.words_to_bytes_be(km.pack_codes(canon, k), k)
            ix = np.minimum(np.searchsorted(uniq, tk), len(uniq) - 1)
            hit = uniq[ix] == tk
            if not hit.any():
                continue
            fi = int(firsts[ix[hit]].min())
            li = int(lasts[ix[hit]].max())
            if first_index is None or fi < first_index:
                first_index = fi
            if li > last_index:
                last_index = li

        if first_index is None:
            first_index = 2 ** 31 - 1
        if first_novel < first_index:
            first_index = first_novel
        if last_novel > last_index:
            last_index = last_novel
        return first_index, last_index + 1, to_contig(ws[first_index:last_index + 1])

    def label_targets(self, targets: dict) -> dict:
        """Target labelling via the batched whole-contig aligner
        (models/contig_aligner.py, the lastz-replacement path): candidate
        windows of every target in the section are scored in one device
        banded-SW dispatch, only winners are Gotoh-tracebacked on host.
        Same ranking/sort semantics as sort_alignments (Call.java:1920-1944:
        length desc, NM asc)."""
        by_back: dict = {}
        order = []
        for c in targets:
            back = c.split(":")[0]
            if back in self.references:
                by_back.setdefault(back, {})[c] = targets[c]
                order.append(c)
        results: dict = {}
        for back, items in by_back.items():
            stats: dict = {}
            aligned = align_contigs(items, {back: self.references[back]},
                                    band=64, stats=stats, device=self.device)
            self.align_stats["device_scored_windows"] = (
                self.align_stats.get("device_scored_windows", 0)
                + stats.get("device_scored_windows", 0))
            self.align_stats["host_tracebacks"] = (
                self.align_stats.get("host_tracebacks", 0)
                + stats.get("host_tracebacks", 0))
            for c, al in aligned.items():
                results[c] = sorted(al, key=lambda s: (-(s.end - s.start),
                                                       s.nm))

        labelled: dict = {}
        target_num = 0
        for c in order:
            back = c.split(":")[0]
            ss = results.get(c, [])
            if ss:
                s = ss[0]
                label = (f"{back}:{s.contig}:{s.start}-{s.end}:"
                         f"{'-' if s.negative else '+'}")
                labelled[label] = targets[c]
            else:
                labelled[f"{back}:unknown{target_num}"] = targets[c]
                target_num += 1
        return labelled

    # ------------------------------------------------------------------
    # lps column helpers (Call.java:1988-2065)
    # ------------------------------------------------------------------
    @staticmethod
    def num_columns(lps) -> int:
        return len(lps[0][1])

    @staticmethod
    def child_column(lps, column) -> str:
        if 0 <= column < len(lps[0][1]):
            c = lps[0][1][column]
            if c != " ":
                return c
        return "N"

    @staticmethod
    def parental_column(lps, column) -> str:
        if 0 <= column < len(lps[0][1]):
            for i in range(1, len(lps)):
                if column < len(lps[i][1]) and lps[i][1][column] != " ":
                    return lps[i][1][column]
        return "N"

    @staticmethod
    def parental_row(lps, column) -> int:
        if 0 <= column < len(lps[0][1]):
            for i in range(1, len(lps)):
                if column < len(lps[i][1]) and lps[i][1][column] != " ":
                    return i
        return 0

    @staticmethod
    def is_recomb(lps, column) -> bool:
        if len(lps) > 2:
            for i in range(1, len(lps) - 1):
                t_i, t_n = lps[i][1], lps[i + 1][1]
                if (column == len(t_i) - 1 and t_i[column] != " "
                        and column + 1 < len(t_n) and t_n[column] == " "
                        and t_n[column + 1] != " "):
                    return True
        return False

    @staticmethod
    def recomb_partners(lps, column):
        if len(lps) > 2:
            for i in range(1, len(lps) - 1):
                t_i, t_n = lps[i][1], lps[i + 1][1]
                if (column == len(t_i) - 1 and t_i[column] != " "
                        and column + 1 < len(t_n) and t_n[column] == " "
                        and t_n[column + 1] != " "):
                    return i, i + 1
        return -1, -1

    # ------------------------------------------------------------------
    # novelty track (Call.java:2067-2124)
    # ------------------------------------------------------------------
    def make_novelty_track(self, rois, lps, expand: bool) -> str:
        query = lps[0][1].replace("-", "").replace(" ", "")
        sb = [" "] * (len(query) + 1)
        for i in range(len(query) - self.k + 1):
            ck = min(query[i:i + self.k], km.revcomp(query[i:i + self.k]))
            if ck in rois:
                for j in range(i, i + self.k):
                    sb[j] = "*"

        for i in range(self.num_columns(lps)):
            if self.child_column(lps, i) == "-":
                sb.insert(i, "*" if (i < len(sb) and sb[i] == "*") else " ")

        if expand:
            for i in range(1, self.num_columns(lps)):
                if i < len(sb) and sb[i] == "*":
                    if sb[i - 1] != "*" and self.parental_column(lps, i - 1) == "-":
                        j = i - 1
                        while j >= 0 and self.parental_column(lps, j) == "-":
                            sb[j] = "*"
                            j -= 1
                    if i + 1 < len(sb) and sb[i + 1] != "*" and self.parental_column(lps, i + 1) == "-":
                        j = i + 1
                        while j < self.num_columns(lps) and self.parental_column(lps, j) == "-":
                            if j < len(sb):
                                sb[j] = "*"
                            j += 1
        return "".join(sb)

    def novelty_regions(self, rois, lps, expand: bool) -> list:
        track = self.make_novelty_track(rois, lps, expand)
        regions = []
        start = -1
        stop = len(track) - 1
        for i, c in enumerate(track):
            if c == "*":
                if start == -1:
                    start = i
                stop = i
            else:
                if start >= 0:
                    regions.append((start, stop))
                    start = -1
                    stop = len(track) - 1
        if start >= 0:
            regions.append((start, stop))
        return regions

    # ------------------------------------------------------------------
    # child flank helper shared by the callers
    # ------------------------------------------------------------------
    def _child_hap(self, lps, nr) -> str:
        # flank bounds per Call.java:1409-1424
        child_left = nr[0]
        num_left = 0
        while child_left > 0 and num_left <= self.k:
            if self.child_column(lps, child_left) != "-":
                num_left += 1
            child_left -= 1
        child_right = nr[1]
        num_right = 0
        while child_right < len(lps[0][1]) and num_right <= self.k:
            if self.child_column(lps, child_right) != "-":
                num_right += 1
            child_right += 1
        return lps[0][1][child_left:child_right].replace("-", "")

    # ------------------------------------------------------------------
    # variant extractors (Call.java:1367-1790)
    # ------------------------------------------------------------------
    def call_small_bubbles(self, lps, nrs, contig_name, section_start, section_stop) -> list:
        vcbs = []
        for nr in nrs:
            start = nr[0] - 1
            prev_base = self.child_column(lps, start)
            prev_row = self.parental_row(lps, start)
            c_builder = None
            p_builder = None
            for i in range(nr[0], nr[1] + 1):
                child_c = self.child_column(lps, i)
                parent_c = self.parental_column(lps, i)
                if child_c.upper() == parent_c.upper() or i == self.num_columns(lps) - 1:
                    if c_builder is not None:
                        if i == self.num_columns(lps) - 1:
                            if child_c != "-":
                                c_builder.append(child_c)
                            if parent_c != "-":
                                p_builder.append(parent_c)
                            c_builder.append(".")

                        cb = "".join(c_builder)
                        pb = "".join(p_builder)
                        is_symbolic_start = len(cb) > 0 and cb[0] == "."
                        is_symbolic_end = len(cb) > 0 and cb[-1] == "."

                        variant_start = section_start + start
                        variant_stop = section_start + i
                        next_base = "N" if i == self.num_columns(lps) - 1 else child_c
                        next_row = self.parental_row(lps, i)

                        if len(cb) == len(pb) and len(cb) == 1:
                            variant_start += 1
                            variant_stop -= 1
                        else:
                            if not is_symbolic_start:
                                cb = prev_base + cb
                                pb = prev_base + pb
                            else:
                                variant_start = variant_stop
                                start = i
                                cb = cb + next_base
                                pb = pb + next_base

                        child_hap = self._child_hap(lps, nr)
                        row = next_row if prev_row == 0 else prev_row
                        back = lps[row][0].split(":")[0] if row > 0 else "unknown"

                        vcb = Variant(
                            chrom=contig_name, start=variant_start,
                            alleles=[pb, cb],
                            attributes={
                                "start": start, "stop": i,
                                "sectionStart": section_start,
                                "sectionStop": section_stop,
                                "variantStart": variant_start,
                                "variantStop": variant_stop,
                                "prevBase": prev_base, "nextBase": next_base,
                                "CALL_FUNC": "smallBubble",
                                "CHILD_HAP": child_hap,
                                "PARTITION_NAME": contig_name,
                                "BACKGROUND": back,
                            })
                        if is_symbolic_start or is_symbolic_end:
                            vcb.stop = variant_stop
                            vcb.attr("SVTYPE", "BND")
                        else:
                            vcb.compute_end_from_alleles(variant_start)
                        vcbs.append(vcb)

                    prev_base = child_c
                    start = i
                    c_builder = None
                    p_builder = None
                else:
                    if c_builder is None:
                        c_builder = []
                    if p_builder is None:
                        p_builder = []
                    if i == 0:
                        c_builder.insert(0, ".")
                    if child_c != "-":
                        c_builder.append(child_c)
                    if parent_c != "-":
                        p_builder.append(parent_c)
        return vcbs

    def _recomb_flank_bases(self, lps, i):
        q = -1
        prev_base = "-"
        while True:
            q += 1
            prev_base = self.parental_column(lps, i - q).upper()
            if not (prev_base == "-" and i - q > 1):
                break
        q = -1
        next_base = "-"
        while True:
            q += 1
            next_base = self.parental_column(lps, i + 1 + q).upper()
            if next_base != "-":
                break
        return prev_base, next_base

    def call_large_bubbles(self, lps, nrs, targets, contig_name, section_start, section_stop) -> list:
        vcbs = []
        for nr in nrs:
            for i in range(nr[0], nr[1] + 1):
                if self.is_recomb(lps, i):
                    pa, pb_ = self.recomb_partners(lps, i)
                    name0, name1 = lps[pa][0], lps[pb_][0]
                    if name0 == name1:
                        target = targets.get(name0)
                        start = lps[pa][2][1] + 1
                        stop = lps[pb_][2][0]
                        if target is not None and stop > start:
                            variant_start = section_start + i
                            variant_stop = section_start + i + 1
                            prev_base, next_base = self._recomb_flank_bases(lps, i)
                            subtarget = target[start:stop]
                            alleles = [prev_base, prev_base + subtarget]
                            back = name0.split(":")[0]
                            child_hap = self._child_hap(lps, nr)
                            vcb = Variant(
                                chrom=contig_name, start=variant_start,
                                alleles=alleles,
                                attributes={
                                    "start": i, "stop": i + 1,
                                    "sectionStart": section_start,
                                    "sectionStop": section_stop,
                                    "variantStart": variant_start,
                                    "variantStop": variant_stop,
                                    "prevBase": prev_base, "nextBase": next_base,
                                    "CALL_FUNC": "largeBubble",
                                    "CHILD_HAP": child_hap,
                                    "PARTITION_NAME": contig_name,
                                    "BACKGROUND": back,
                                }).compute_end_from_alleles(section_start + i)
                            vcbs.append(vcb)
        return vcbs

    def call_repeats(self, lps, nrs, targets, contig_name, section_start, section_stop) -> list:
        vcbs = []
        for nr in nrs:
            for i in range(nr[0], nr[1] + 1):
                if self.is_recomb(lps, i):
                    pa, pb_ = self.recomb_partners(lps, i)
                    name0, name1 = lps[pa][0], lps[pb_][0]
                    if name0 == name1:
                        target = targets.get(name0)
                        start0, stop0 = lps[pa][2][0], lps[pa][2][1] + 1
                        start1, stop1 = lps[pb_][2][0], lps[pb_][2][1] + 1
                        if target is not None and start0 == start1 and stop0 == stop1:
                            variant_start = section_start + i
                            variant_stop = section_start + i + 1
                            prev_base, next_base = self._recomb_flank_bases(lps, i)
                            subtarget = target[start0:stop0]
                            alleles = [prev_base, prev_base + subtarget]
                            back = name0.split(":")[0]
                            child_hap = self._child_hap(lps, nr)
                            vcb = Variant(
                                chrom=contig_name, start=variant_start,
                                alleles=alleles,
                                attributes={
                                    "start": i, "stop": i + 1,
                                    "sectionStart": section_start,
                                    "sectionStop": section_stop,
                                    "variantStart": variant_start,
                                    "variantStop": variant_stop,
                                    "prevBase": prev_base, "nextBase": next_base,
                                    "CALL_FUNC": "repeats",
                                    "CHILD_HAP": child_hap,
                                    "PARTITION_NAME": contig_name,
                                    "BACKGROUND": back,
                                }).compute_end_from_alleles(section_start + i)
                            vcbs.append(vcb)
        return vcbs

    def call_breakpoints(self, lps, nrs, contig_name, section_start, section_stop) -> list:
        vcbs = []
        for nr in nrs:
            for i in range(nr[0], nr[1] + 1):
                if self.is_recomb(lps, i):
                    pa, pb_ = self.recomb_partners(lps, i)
                    name0, name1 = lps[pa][0], lps[pb_][0]
                    if name0 != name1:
                        prev_pos, next_pos = i, i + 1
                        next_ins = []
                        while self.parental_column(lps, prev_pos) == "-":
                            next_ins.insert(0, self.child_column(lps, prev_pos))
                            prev_pos -= 1
                        next_ins.insert(0, self.child_column(lps, prev_pos))
                        prev_base = self.child_column(lps, prev_pos)

                        prev_ins = []
                        while self.parental_column(lps, next_pos) == "-":
                            prev_ins.append(self.child_column(lps, next_pos))
                            next_pos += 1
                        prev_ins.append(self.child_column(lps, next_pos))
                        next_base = self.child_column(lps, next_pos)

                        a0 = [prev_base, "]" + name1 + ":" + str(next_pos) + "]" + "".join(next_ins)]
                        a1 = [next_base, "".join(prev_ins) + "[" + name0 + ":" + str(prev_pos) + "["]

                        mate0 = f"bnd_{contig_name}_{section_start + prev_pos}"
                        mate1 = f"bnd_{contig_name}_{section_start + next_pos}"
                        back0 = name0.split(":")[0]
                        back1 = name1.split(":")[0]
                        child_hap = self._child_hap(lps, nr)

                        common = {
                            "sectionStart": section_start, "sectionStop": section_stop,
                            "prevBase": prev_base, "nextBase": next_base,
                            "CHILD_HAP": child_hap, "PARTITION_NAME": contig_name,
                            "SVTYPE": "BND",
                        }
                        vcb0 = Variant(
                            chrom=contig_name, start=section_start + prev_pos,
                            stop=section_start + prev_pos, alleles=a0, id_=mate0,
                            attributes={**common,
                                        "start": prev_pos, "stop": prev_pos + 1,
                                        "variantStart": section_start + prev_pos,
                                        "variantStop": section_start + prev_pos,
                                        "targetName": name0,
                                        "targetStart": lps[pa][2][0],
                                        "targetStop": lps[pa][2][1],
                                        "CALL_FUNC": "breakpoints",
                                        "BACKGROUND": back0,
                                        "MATEID": mate1})
                        vcb1 = Variant(
                            chrom=contig_name, start=section_start + next_pos,
                            stop=section_start + next_pos, alleles=a1, id_=mate1,
                            attributes={**common,
                                        "start": next_pos, "stop": next_pos + 1,
                                        "variantStart": section_start + next_pos,
                                        "variantStop": section_start + next_pos,
                                        "targetName": name1,
                                        "targetStart": lps[pb_][2][0],
                                        "targetStop": lps[pb_][2][1],
                                        "BACKGROUND": back1,
                                        "MATEID": mate0})
                        vcbs.append(vcb0)
                        vcbs.append(vcb1)
        return vcbs

    # ------------------------------------------------------------------
    # merging (Call.java:615-683, 1233-1365)
    # ------------------------------------------------------------------
    def merge_bubbles(self, lps, calls: list) -> list:
        if len(calls) <= 1:
            return calls
        merged = []
        i = 0
        while i < len(calls):
            if i + 1 <= len(calls) - 1:
                start0 = calls[i].get_attr("start", 0)
                stop0 = calls[i].get_attr("stop", 0)
                stop1 = calls[i + 1].get_attr("stop", 500)
                start1 = calls[i + 1].get_attr("start", 500)
                if (start1 - stop0 < 10 and not calls[i].is_symbolic_or_sv()
                        and not calls[i + 1].is_symbolic_or_sv()):
                    cb, pb = [], []
                    for j in range(start0, stop1):
                        c = self.child_column(lps, j)
                        p = self.parental_column(lps, j)
                        if c != "-":
                            cb.append(c)
                        if p != "-":
                            pb.append(p)
                    if cb and pb:
                        cbs, pbs = "".join(cb), "".join(pb)
                        prev_base = self.child_column(lps, start0)
                        next_base = self.child_column(lps, stop1)
                        section_start = calls[i].get_attr("sectionStart", 0)
                        vcb = calls[i].copy()
                        vcb.alleles = [pbs, cbs]
                        vcb.start = section_start + start0
                        vcb.compute_end_from_alleles(section_start + start0)
                        vcb.attr("start", start0).attr("stop", stop1)
                        vcb.attr("variantStart", section_start + start0)
                        vcb.attr("variantStop", section_start + stop1)
                        vcb.attr("prevBase", prev_base).attr("nextBase", next_base)
                        if len(cbs) > 1 and cbs[1:] == km.revcomp(pbs[1:]):
                            vcb.attr("SVTYPE", "INV")
                        merged.append(vcb)
                        i += 2
                        continue
                    merged.append(calls[i])
                else:
                    merged.append(calls[i])
            else:
                merged.append(calls[i])
            i += 1
        return merged

    def merge_double_breakpoints(self, seq: str, callset: VariantSorterSet) -> VariantSorterSet:
        calls = callset.to_list()
        if len(calls) <= 1:
            return callset

        bnds = [c for c in calls
                if c.is_symbolic_or_sv() and c.get_attr("SVTYPE", "unknown") == "BND"]

        replacements: dict = {}
        removals: set = set()

        if len(bnds) >= 4 and len(bnds) % 2 == 0:
            for i in range(0, len(bnds) - 1, 2):
                outer0, inner0 = bnds[i], bnds[i + 1]
                lps0 = outer0.get_attr("lps")
                pos0 = outer0.get_attr("start", 0)
                kmer0 = []
                while len(kmer0) < self.k:
                    c = self.child_column(lps0, pos0)
                    if c != "-" and c != " ":
                        kmer0.insert(0, c)
                    else:
                        break  # guard: the reference would spin forever here
                q0 = self.parental_row(lps0, pos0)

                for j in range(i + 2, len(bnds) - 1, 2):
                    inner1, outer1 = bnds[j], bnds[j + 1]
                    lps1 = outer1.get_attr("lps")
                    pos1 = outer1.get_attr("start", 0)
                    kmer1 = []
                    while len(kmer1) < self.k and pos1 < len(lps1[0][1]):
                        c = self.child_column(lps1, pos1)
                        if c != "-" and c != " ":
                            kmer1.append(c)
                        else:
                            break  # guard (see above)
                    q1 = self.parental_row(lps1, pos1)

                    back0 = lps0[q0][0].split(":")[0]
                    back1 = lps1[q1][0].split(":")[0]
                    if back0 != back1:
                        continue
                    for parent_name in self.backgrounds:
                        if (back0 in parent_name
                                and self.parental_row(lps0, pos0 + 1) == self.parental_row(lps1, pos1 - 1)):
                            inner_row = self.parental_row(lps0, pos0 + 1)
                            ref_rev = lps0[self.parental_row(lps0, pos0)][0].endswith("-")
                            alt_rev = lps0[inner_row][0].endswith("-")

                            sbalt, sbref = [], []
                            for f in range(pos0 + 1, pos1):
                                sbalt.append(self.child_column(lps0, f))
                                sbref.append(self.parental_column(lps0, f))
                            alt = "".join(sbalt)
                            ref = "".join(sbref)
                            if ref_rev:
                                ref = km.revcomp(ref)
                            if alt_rev:
                                alt = km.revcomp(alt)
                            alt = alt.replace("-", "")
                            ref = ref.replace("-", "")

                            svtype = "unknown"
                            if len(alt) > len(ref):
                                svtype = "INS"
                            elif len(alt) < len(ref):
                                svtype = "DEL"
                            else:
                                svtype = "MNP"
                            if ref_rev != alt_rev and ref == km.revcomp(alt):
                                svtype = "INV"

                            if (alt or ref) and ref.upper() != alt.upper():
                                vcb = outer0.copy()
                                vcb.alleles = [ref, alt]
                                vcb.compute_end_from_alleles(outer0.start)
                                vcb.attr("SVTYPE", svtype)
                                vcb.attr("prevBase", outer0.get_attr("prevBase", "N"))
                                vcb.attr("nextBase", outer1.get_attr("nextBase", "N"))
                                vcb.rm_attrs(["MATEID"])
                                vcb.id_ = outer0.id_
                                replacements[outer0.id_] = vcb
                                replacements[inner0.id_] = None
                                replacements[inner1.id_] = None
                                replacements[outer1.id_] = None
                                for v in (outer0, inner0, inner1, outer1):
                                    removals.add((v.chrom, v.start))

        out = VariantSorterSet(callset.seq_index)
        for vcb in calls:
            if not vcb.is_symbolic() and (vcb.chrom, vcb.start) in removals:
                continue
            if vcb.id_ not in replacements:
                out.add(vcb)
            elif replacements[vcb.id_] is not None:
                out.add(replacements[vcb.id_])
        return out

    # ------------------------------------------------------------------
    # coordinate assignment (Call.java:313-613)
    # ------------------------------------------------------------------
    def _flank_up(self, lps, start):
        """Parental flank ending at `start` on the same parental row."""
        row = self.parental_row(lps, start)
        flank = []
        q = start
        while q >= 0 and self.parental_row(lps, q) == row:
            c = self.parental_column(lps, q)
            if c != "-":
                flank.insert(0, c)
            q -= 1
        return lps[row][0].split(":")[0], "".join(flank)

    def _flank_down(self, lps, stop):
        while (self.parental_column(lps, stop) == "-"
               and stop < len(lps[0][1])):
            stop += 1
        row = self.parental_row(lps, stop)
        flank = []
        q = stop
        while q < len(lps[0][1]) and self.parental_row(lps, q) == row:
            c = self.parental_column(lps, q)
            if c != "-":
                flank.append(c)
            q += 1
        return lps[row][0].split(":")[0], "".join(flank), stop

    def assign_coordinates_all(self, calls: VariantSorterSet) -> VariantSorterSet:
        out = VariantSorterSet(calls.seq_index)
        bnds = []
        for vcb in calls:
            if vcb.get_attr("MATEID") is None:
                out.add(self.assign_coordinates_one(vcb))
            else:
                bnds.append(vcb)
        bnds.sort(key=lambda v: v.start)
        for i in range(0, len(bnds) - 1, 2):
            for v in self.assign_coordinates_pair(bnds[i], bnds[i + 1]):
                out.add(v)
        return out

    def assign_coordinates_pair(self, vcb0: Variant, vcb1: Variant):
        if vcb0.get_attr("MATEID", "") == vcb1.id_:
            lps = vcb0.get_attr("lps")

            start0 = vcb0.get_attr("start", 0) + (1 if vcb0.is_snp() else 0)
            prev_back, prev_flank = self._flank_up(lps, start0)
            prev_srs = self.sort_alignments(prev_back, prev_flank)
            prev_sr = prev_srs[0] if prev_srs else None
            if prev_sr is not None:
                # NB: the reference's +1s compensate jbwa's 0-based starts
                # (see IndexedReference.find, KmerLookupTest); our Alignment
                # is 1-based so the +1 is already folded in.
                vcb0.attr("prevChrom", prev_sr.contig)
                vcb0.attr("prevStart", prev_sr.ref_pos_at_read_pos(1))
                vcb0.attr("prevStop", prev_sr.ref_pos_at_read_pos(prev_sr.read_length))
                vcb0.attr("prevStrand", "-" if prev_sr.negative else "+")
                vcb0.chrom = prev_sr.contig
                if prev_sr.negative:
                    vcb0.start = prev_sr.start
                    vcb0.stop = prev_sr.start
                else:
                    vcb0.start = prev_sr.end
                    vcb0.stop = prev_sr.end
                vcb0.attr("flankMappingQuality", prev_sr.mapq)

            start1 = vcb1.get_attr("start", 0) - (1 if vcb1.is_snp() else 0)
            next_back, next_flank, _ = self._flank_down(lps, start1)
            next_srs = self.sort_alignments(next_back, next_flank)
            next_sr = next_srs[0] if next_srs else None
            if next_sr is not None:
                vcb1.attr("nextChrom", next_sr.contig)
                vcb1.attr("nextStart", next_sr.ref_pos_at_read_pos(1))
                vcb1.attr("nextStop", next_sr.ref_pos_at_read_pos(next_sr.read_length))
                vcb1.attr("nextStrand", "-" if next_sr.negative else "+")
                vcb1.chrom = next_sr.contig
                if next_sr.negative:
                    vcb1.start = next_sr.end
                    vcb1.stop = next_sr.end
                else:
                    vcb1.start = next_sr.start - 1
                    vcb1.stop = next_sr.start - 1
                vcb1.attr("flankMappingQuality", next_sr.mapq)
        return [vcb0, vcb1]

    def assign_coordinates_one(self, vcb: Variant) -> Variant:
        vcbn = vcb.copy()
        lps = vcbn.get_attr("lps")

        start = vcbn.get_attr("start", 0) + (1 if vcbn.is_snp() else 0)
        prev_back, prev_flank = self._flank_up(lps, start)
        prev_srs = self.sort_alignments(prev_back, prev_flank)
        prev_sr = prev_srs[0] if prev_srs else None
        if prev_sr is not None:
            vcbn.attr("prevChrom", prev_sr.contig)
            vcbn.attr("prevStart", prev_sr.ref_pos_at_read_pos(1))
            vcbn.attr("prevStop", prev_sr.ref_pos_at_read_pos(prev_sr.read_length))
            vcbn.attr("prevStrand", "-" if prev_sr.negative else "+")

        stop = vcbn.get_attr("stop", 0) - (1 if vcbn.is_snp() else 0)
        next_back, next_flank, _ = self._flank_down(lps, stop)
        next_srs = self.sort_alignments(next_back, next_flank)
        next_sr = next_srs[0] if next_srs else None

        if prev_sr is not None and next_srs:
            for nsr in next_srs:
                if prev_sr.contig == nsr.contig:
                    next_sr = nsr
                    break

        if next_sr is not None:
            vcbn.attr("nextChrom", next_sr.contig)
            vcbn.attr("nextStart", next_sr.ref_pos_at_read_pos(1))
            vcbn.attr("nextStop", next_sr.ref_pos_at_read_pos(next_sr.read_length))
            vcbn.attr("nextStrand", "-" if next_sr.negative else "+")

        sr, srs = None, None
        align_start = 0
        if prev_sr is not None and next_sr is not None:
            if prev_sr.start < next_sr.start:
                next_sr = None
            else:
                prev_sr = None
        if prev_sr is not None:
            sr, srs = prev_sr, prev_srs
            align_start = sr.start if sr.negative else sr.end
        elif next_sr is not None:
            sr, srs = next_sr, next_srs
            align_start = sr.end if sr.negative else sr.start - 1

        if sr is not None:
            flip = sr.negative
            alleles = list(vcbn.alleles)

            vcbn.chrom = sr.contig
            old_span = vcb.stop - vcb.start
            vcbn.start = align_start
            vcbn.stop = align_start + old_span
            vcbn.attr("flankMappingQuality", sr.mapq)

            if flip:
                alleles_rc = []
                for a in alleles:
                    pieces = _split_breakend(a)
                    for pi, piece in enumerate(pieces):
                        if _is_seq_piece(piece):
                            pieces[pi] = km.revcomp(piece)
                    new_allele = "".join(pieces)
                    if not vcbn.is_snp() and not vcbn.is_symbolic():
                        new_ref_base = km.revcomp(sr.read[0])
                        new_allele = new_ref_base + new_allele[:-1]
                    alleles_rc.append(new_allele)
                alleles = alleles_rc

            alleles_revised = []
            for a in alleles:
                pieces = _split_breakend(a)
                if len(pieces) == 4:
                    newpieces = [None] * 4
                    if _is_seq_piece(pieces[3]):
                        newpieces[0] = pieces[3]
                        newpieces[1] = "]" if pieces[0] == "[" else "["
                        newpieces[2] = pieces[1]
                        newpieces[3] = "]" if pieces[2] == "[" else "["
                        mate_locus_index = 2
                        contig_piece = pieces[1]
                    else:
                        newpieces[0] = "]" if pieces[1] == "[" else "["
                        newpieces[1] = pieces[2]
                        newpieces[2] = "]" if pieces[3] == "[" else "["
                        newpieces[3] = pieces[0]
                        mate_locus_index = 1
                        contig_piece = pieces[2]
                    subpieces = contig_piece.split(":")
                    back = subpieces[0]
                    contig_name = ":".join(subpieces[:3]) if len(subpieces) >= 3 else contig_piece
                    for m in range(1, len(lps)):
                        if lps[m][0] == contig_name:
                            if back in self.references:
                                mrs = self.sort_alignments(back, lps[m][1].replace(" ", ""))
                                if mrs:
                                    mr = mrs[0]
                                    newpos = mr.ref_pos_at_read_pos(1) - 1
                                    newpieces[mate_locus_index] = f"{mr.contig}:{newpos}"
                            break
                    alleles_revised.append("".join(newpieces))
                else:
                    alleles_revised.append(a)

            vcbn.alleles = alleles_revised
            vcbn.attr("flipped", flip)
            alt_loci = [f"{sra.contig}:{sra.start}" for sra in srs]
            vcbn.attr("alt_loci", ",".join(alt_loci))

            # VCF spec: REF must match the reference at the assigned
            # position.  A flank alignment ending inside a tandem repeat
            # can land the lift one repeat-rotation away from the
            # contig-space anchor base, leaving indel alleles whose shared
            # anchor disagrees with the reference (and an unapplyable
            # haplotype); re-anchoring the shared first base from the
            # actual reference restores spec-consistency — and, when the
            # inserted/deleted string itself is right, the exact
            # haplotype.  SNVs and symbolic alleles are untouched
            # (Call.java:314-613 lift parity otherwise).
            back = vcbn.get_attr("BACKGROUND")
            ref_ir = self.references.get(back) if back else None
            if (ref_ir is not None and not vcbn.is_symbolic()
                    and not vcbn.is_snp() and len(vcbn.alleles) >= 2):
                a0, a1 = vcbn.alleles[0], vcbn.alleles[1]
                seq = getattr(ref_ir, "seqs", {}).get(vcbn.chrom)
                if (seq and a0 and a1 and a0[0] == a1[0]
                        and 1 <= vcbn.start <= len(seq)):
                    rb = seq[vcbn.start - 1].upper()
                    if rb != a0[0].upper() and rb in "ACGT":
                        vcbn.alleles = [rb + a0[1:], rb + a1[1:]]
        return vcbn

    # ------------------------------------------------------------------
    # main loop (Call.java:101-258) + VCF emission (:1792-1827)
    # ------------------------------------------------------------------
    def sequence_dictionary(self) -> list:
        """[(name, length)] merged across references + <ref>_unknown entries
        (Call.java:1890-1906)."""
        out = []
        seen = set()
        for rid, ir in self.references.items():
            for name, seq in ir.seqs.items():
                if name not in seen:
                    out.append((name, len(seq)))
                    seen.add(name)
            unk = f"{rid}_unknown"
            if unk not in seen:
                out.append((unk, len(self.partitions)))
                seen.add(unk)
        return out

    def call(self):
        """Run the full pipeline.  Returns (variants list, accounting dict)."""
        rois = self.load_rois()
        rseqs = [(h, s) for h, s in self.partitions
                 if self.partition_names is None or h.split(" ")[0] in self.partition_names]

        sd = self.sequence_dictionary()
        seq_index = {name: i for i, (name, _) in enumerate(sd)}
        svcs = VariantSorterSet(seq_index)

        tmr = self.timer
        device_ma = type(self.ma).__name__ == "TesseraeDevice"
        ma_section = "device:tesserae" if device_ma else "host:tesserae"

        for rseq_index, (header, seq) in enumerate(rseqs):
            contig_name = header.split(" ")[0]
            with tmr.section("host:load_walk"):
                w = self.load_child_walk(seq)
                sections = self.section_contig(rois, w)
            vcs = VariantSorterSet(seq_index)

            if sections is None:
                self.log(f"partition {rseq_index} skipped (no novel kmers)")
            else:
                self.log(f"partition {rseq_index}: {len(sections)} sections")
                for section_index, (sec_start, sec_stop, ws) in enumerate(sections):
                    targets: dict = {}
                    with tmr.section("mixed:assemble_haplotypes"):
                        for parent_name in self.backgrounds:
                            targets.update(self.assemble_candidate_haplotypes(ws, parent_name))

                    if not targets:
                        continue
                    with tmr.section("host:trim_query"):
                        tq_start, tq_stop, tq_seq = self.trim_query(ws, targets, rois)
                    with tmr.section("mixed:label_targets"):
                        labelled = self.label_targets(targets)
                    if not labelled:
                        continue

                    with tmr.section(ma_section):
                        lps = self.ma.align(tq_seq, labelled)
                    with tmr.section("host:extract_variants"):
                        nrs = self.novelty_regions(rois, lps, True)

                        calls = []
                        calls += self.call_small_bubbles(lps, nrs, contig_name,
                                                         sec_start + tq_start, sec_stop + tq_start)
                        calls += self.call_large_bubbles(lps, nrs, labelled, contig_name,
                                                         sec_start + tq_start, sec_stop + tq_start)
                        calls += self.call_repeats(lps, nrs, labelled, contig_name,
                                                   sec_start + tq_start, sec_stop + tq_start)
                        calls += self.call_breakpoints(lps, nrs, contig_name,
                                                       sec_start + tq_start, sec_stop + tq_start)

                        merged = self.merge_bubbles(lps, calls)

                    section_rois = sorted(
                        ck for ck in (
                            min(tq_seq[i:i + self.k], km.revcomp(tq_seq[i:i + self.k]))
                            for i in range(len(tq_seq) - self.k + 1))
                        if ck in rois)

                    survivors = []
                    for vcb in merged:
                        vcb.attr("targets", targets)
                        vcb.attr("lps", lps)
                        vcb.attr("sectionIndex", section_index)
                        vcb.attr("novels", ",".join(section_rois))
                        if (len(vcb.alleles) >= 2
                                and vcb.alleles[0] == vcb.alleles[1]):
                            continue
                        survivors.append(vcb)
                    vcs.add_all(survivors)

            with tmr.section("host:merge_coords"):
                vcs = self.merge_double_breakpoints(seq, vcs)
                vcs = self.assign_coordinates_all(vcs)

            for vcb in vcs:
                vcb.rm_attrs(["targets", "lps"])
                if not vcb.is_filtered():
                    svcs.add(vcb)

        # attribute the device mosaic-alignment phase: first call per shape
        # bucket pays the remote AOT compile, the rest is dispatch+DP
        if device_ma and getattr(self.ma, "compile_s", 0):
            tmr.sections["device:tesserae_compile"] = self.ma.compile_s
            tmr.sections["device:tesserae_dispatch"] = self.ma.dispatch_s
            tmr.sections.pop(ma_section, None)

        return svcs.to_list(), rois

    def write_outputs(self, vcf_path, accounting_path):
        variants, rois = self.call()
        sd = self.sequence_dictionary()

        acct = {ck: "absent" for ck in rois}
        final = []
        for variant_id, vc in enumerate(variants):
            cc_id = f"CC{variant_id}"
            out_vc = vc.copy()
            out_vc.rm_attrs(["novels"])
            out_vc.attr("CALL_ID", variant_id)
            novels = vc.get_attr("novels", "")
            # NOVEL_KMERS carries the event's novel-kmer support into the
            # VCF so FilterCalls can apply the manuscript's FDR rule
            # (reject events with <5 novel kmers; BASELINE.md FDR row);
            # NOVEL_KMER_COV (median child coverage over those kmers) powers
            # the depth-relative noise filter — the low-depth analog of the
            # reference's `mccortex clean -m 10` at 75-100x
            # (Simulate.wdl:620-666): recurrent-read-error chains sit near
            # the cleaning threshold, real DNM chains near full depth
            nlist = [s for s in novels.split(",") if s]
            out_vc.attr("NOVEL_KMERS", len(nlist))
            if nlist:
                covs = sorted(self._roi_coverage(s) for s in nlist)
                out_vc.attr("NOVEL_KMER_COV", covs[len(covs) // 2])
            final.append(out_vc)
            for sk in novels.split(","):
                if sk and sk in acct:
                    acct[sk] = cc_id

        write_vcf(vcf_path, final, sd)
        with open(accounting_path, "w") as f:
            for ck in sorted(acct):
                f.write(f"{ck}\t{acct[ck]}\n")
        return final, acct


def _split_breakend(allele: str) -> list:
    """Split an allele string on '[' / ']' keeping the delimiters
    (the reference's lookahead/lookbehind regex split, Call.java:506)."""
    out = []
    cur = []
    for ch in allele:
        if ch in "[]":
            if cur:
                out.append("".join(cur))
                cur = []
            out.append(ch)
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _is_seq_piece(piece: str) -> bool:
    import re
    return bool(re.match(r"^(\.?)[ACTGacgt]+(\.?)$", piece))
