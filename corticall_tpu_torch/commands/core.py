"""Command-layer core: graph algebra, ROI discovery, prefilters, Partition.

The host functions (join, remove, FindROIs, the prefilters with
FindShared, FindUnanchored and FindContamination, the greedy partition emit
and the exact host engine) are copies of
corticall_tpu/commands/core.py.  Partition takes the routes of the JAX
package's partition:

- link_novels: the exact host engine (_partition_host).
- with links (core.py:623-779): the native C++ linked walker when the native
  core loads and the seed batch is at most linked_device_min(records) — the
  route the pipeline takes at P. falciparum scale; otherwise the jump-table
  device route: link-free jump walks of every seed on the device
  (ops/jump.py), then an exact linked replay (the native walker, or the host
  engine without the native core) of each walk that touched a link-carrying
  k-mer and stopped at a junction, around a cycle or at the cap.
- without links (core.py:782-851): a host walk (native WalkTable, or its
  numpy twin) with replay_walk for at most SMALL_BATCH seeds, else the
  jump-table device route.

The routing thresholds keep the JAX package's values but are this module's
own, so that forcing one package's route leaves the other's alone.  Chunk
checkpoints carry their route's mode ("native_links", "jump_table",
"unlinked_jump"); a checkpoint of another mode is ignored and the run starts
over.
"""

from __future__ import annotations

import gzip
import time

import numpy as np
import torch

from .. import graph as gr
from .. import kmer as km
from .. import native as nat
from ..io import ctx as ctxio
from ..ops import jump
from ..ops import walk_np as wnp
from ..device import resolve
from ..traversal import (AND, BOTH, OR, TraversalConfig, TraversalEngine,
                         to_contig, to_walk)
from ..traversal import utils as tu
from ..traversal.stopping import (ContaminantStopper, ContigStopper,
                                  NovelPartitionStopper, OrphanStopper)
from ..utils import checkpoint as ckpt


# ---------------------------------------------------------------------------
# graph algebra (Join / Remove — commands/utils/Join.java, Remove.java)
# ---------------------------------------------------------------------------

def join(graphs: list) -> gr.CortexGraph:
    """Merge graphs into one multi-color graph; colors concatenate in input
    order, kmers union, missing colors zero-filled (CortexCollection.java:34-63)."""
    k = graphs[0].kmer_size
    for g in graphs:
        if g.kmer_size != k:
            raise ValueError(f"kmer size mismatch: {g.kmer_size} != {k}")

    total_colors = sum(g.num_colors for g in graphs)
    colors: list[ctxio.CtxColor] = []

    from .. import native as nat
    merged = nat.merge_runs_native([g.kmers for g in graphs])
    if merged is not None:
        # native k-way merge of the already-sorted runs: O(total) with the
        # per-key union index returned, so payload columns scatter directly
        kmers, idx_all = merged
        n = len(kmers)
        cov = np.zeros((n, total_colors), dtype=np.uint32)
        edges = np.zeros((n, total_colors), dtype=np.uint8)
        ac = ofs = 0
        for g in graphs:
            idx = idx_all[ofs:ofs + g.num_records]
            ofs += g.num_records
            cov[idx, ac:ac + g.num_colors] = g.coverages
            edges[idx, ac:ac + g.num_colors] = g.edges
            colors.extend(g.header.colors)
            ac += g.num_colors
        uniq = km.words_to_bytes_be(kmers, k)
        header = ctxio.CtxHeader(6, k, km.containers_per_kmer(k), list(colors))
        return gr.CortexGraph(ctxio.CtxData(header, kmers, cov, edges, uniq))

    # numpy fallback: each graph's keys are already sorted (record-order
    # invariant), so an adaptive stable sort merges the runs in near-linear
    # time (~5x np.unique)
    all_keys = np.concatenate([g.data.kmer_bytes for g in graphs])
    srt = np.sort(all_keys, kind="stable")
    keep = np.ones(len(srt), dtype=bool)
    keep[1:] = srt[1:] != srt[:-1]
    uniq = srt[keep]
    n = len(uniq)

    cov = np.zeros((n, total_colors), dtype=np.uint32)
    edges = np.zeros((n, total_colors), dtype=np.uint8)
    ac = 0
    for g in graphs:
        idx = np.searchsorted(uniq, g.data.kmer_bytes)
        cov[idx, ac:ac + g.num_colors] = g.coverages
        edges[idx, ac:ac + g.num_colors] = g.edges
        colors.extend(g.header.colors)
        ac += g.num_colors

    kmers = km.bytes_be_to_words(uniq, k)
    header = ctxio.CtxHeader(6, k, km.containers_per_kmer(k), list(colors))
    return gr.CortexGraph(ctxio.CtxData(header, kmers, cov, edges, uniq))


def remove(primary: gr.CortexGraph, secondaries: list) -> gr.CortexGraph:
    """Keep union kmers with zero coverage in every secondary color, sliced to
    the primary's colors (Remove.java:31-86)."""
    merged = join([primary] + list(secondaries))
    pc = primary.num_colors
    sec_cov = merged.coverages[:, pc:]
    keep = ~(sec_cov > 0).any(axis=1)
    data = ctxio.CtxData(
        primary.header,
        merged.kmers[keep],
        merged.coverages[keep][:, :pc].copy(),
        merged.edges[keep][:, :pc].copy(),
        merged.data.kmer_bytes[keep],
    )
    return gr.CortexGraph(data)


def subset_colors(g: gr.CortexGraph, colors: list, mask: np.ndarray,
                  sample_names=None) -> gr.CortexGraph:
    """Records where mask is True, restricted to the given colors."""
    names = sample_names or [g.sample_name(c) for c in colors]
    header = ctxio.CtxHeader.make(names, g.kmer_size)
    for i, c in enumerate(colors):
        header.colors[i] = g.header.colors[c]
    data = ctxio.CtxData(
        header,
        g.kmers[mask],
        g.coverages[mask][:, colors].copy(),
        g.edges[mask][:, colors].copy(),
        g.data.kmer_bytes[mask],
    )
    return gr.CortexGraph(data)


# ---------------------------------------------------------------------------
# ROI discovery (FindROIs.java:31-105)
# ---------------------------------------------------------------------------

def find_rois(g: gr.CortexGraph, child: str, parents: list) -> gr.CortexGraph:
    """Novel kmers: child coverage > 0 and every parent coverage == 0.
    Output: single-color graph carrying the child's coverage/edges."""
    child_color = g.color_for_sample(child)
    parent_colors = g.colors_for_samples(parents)
    child_cov = g.coverages[:, child_color] > 0
    parents_lack = np.ones(g.num_records, dtype=bool)
    for c in parent_colors:
        parents_lack &= g.coverages[:, c] == 0
    mask = child_cov & parents_lack
    out = subset_colors(g, [child_color], mask)
    # FindROIs writes a fresh single-color header with default flags
    out.header.colors[0] = ctxio.CtxColor(sample_name=g.sample_name(child_color))
    return out


# ---------------------------------------------------------------------------
# prefilters — each returns the EXCLUDED kmers as a 1-color graph with the
# ROI's header (the WDL pipeline then subtracts them via Remove)
# ---------------------------------------------------------------------------

def _excluded_subset(roi: gr.CortexGraph, excluded_canon: set) -> gr.CortexGraph:
    mask = np.zeros(roi.num_records, dtype=bool)
    for i in range(roi.num_records):
        if roi.kmer_string(i) in excluded_canon:
            mask[i] = True
    return subset_colors(roi, list(range(roi.num_colors)), mask)


def adaptive_lowcov_threshold(joined: gr.CortexGraph, child: str,
                              lo: int = 2, hi: int = 10) -> int:
    """Coverage-adaptive FindLowCoverage threshold.  The reference WDL fixes
    `-m 10` (Simulate.wdl:936) for its ~75-100x Pf crosses; a fixed cutoff is
    exactly the round-2 robustness cliff at 15-20x read depth, where real
    novel kmers routinely sit at coverage 4-6.  Scale the cutoff with the
    child sample's median kmer coverage (threshold ~ depth/5, so ~10 at the
    reference's depth) and clamp to [lo, hi]."""
    c = joined.color_for_sample(child)
    cov = joined.coverages[:, c]
    cov = cov[cov > 0]
    if cov.size == 0:
        return lo
    lam = float(np.median(cov))
    return int(np.clip(int(np.ceil(lam / 5.0)), lo, hi))


def find_low_coverage(roi: gr.CortexGraph, min_coverage: int = 10) -> gr.CortexGraph:
    """Excluded = ROI records with coverage < min (FindLowCoverage.java:32-66)."""
    mask = roi.coverages[:, 0] < min_coverage
    return subset_colors(roi, [0], mask)


def find_dust(graph: gr.CortexGraph, roi: gr.CortexGraph, parents: list) -> gr.CortexGraph:
    """Excluded = ROI records whose own in+out degree > 4 (FindDust.java:44-80,
    using the ROI's color-0 edges)."""
    e = roi.edges[:, 0].astype(np.uint16)
    deg = np.zeros(roi.num_records, dtype=np.int32)
    for b in range(8):
        deg += ((e >> b) & 1).astype(np.int32)
    mask = deg > 4
    return subset_colors(roi, [0], mask)


def compression_ratio(s: str) -> float:
    """gzip-compressed length / raw length (SequenceUtils.java:794-813)."""
    b = s.encode()
    c = gzip.compress(b, compresslevel=6, mtime=0)
    return len(c) / len(b)


def find_low_complexity(graph: gr.CortexGraph, roi: gr.CortexGraph, parents: list,
                        threshold: float = 0.70) -> gr.CortexGraph:
    """Excluded = ROI kmers whose gzip compression ratio < threshold
    (FindLowComplexity.java:41-100)."""
    mask = np.array([compression_ratio(roi.kmer_string(i)) < threshold
                     for i in range(roi.num_records)])
    return subset_colors(roi, [0], mask.astype(bool))


def find_shared(graph: gr.CortexGraph, roi: gr.CortexGraph, parents: list,
                ignore: list = ()) -> gr.CortexGraph:
    """Excluded = ROI kmers covered in any joined-graph color that is neither
    the child, a parent, nor ignored (FindShared.java)."""
    child = roi.sample_name(0)
    child_color = graph.color_for_sample(child)
    parent_colors = set(graph.colors_for_samples(parents))
    ignore_colors = set(graph.colors_for_samples(list(ignore))) if ignore else set()
    other = [c for c in range(graph.num_colors)
             if c != child_color and c not in parent_colors and c not in ignore_colors]
    idx = graph.find_records(roi.kmers)
    mask = np.zeros(roi.num_records, dtype=bool)
    if other:
        present = idx >= 0
        cov = graph.coverages[np.maximum(idx, 0)][:, other]
        mask = present & (cov > 0).any(axis=1)
    return subset_colors(roi, [0], mask)


def find_tips(graph: gr.CortexGraph, roi: gr.CortexGraph, parents: list,
              links=(), max_walk: int = 75000) -> gr.CortexGraph:
    """Excluded = novel-kmer chains anchored at one end only (FindTips.java:43-140).

    The production configuration (Simulate.wdl:890-904 passes no links) runs
    ALL chain walks as one native/numpy batch plus one vectorized end-degree
    pass — the per-ROI host engine survives only for the linked variant."""
    child = roi.sample_name(0)
    child_color = graph.color_for_sample(child)
    parent_colors = graph.colors_for_samples(parents)

    roi_set = {roi.kmer_string(i) for i in range(roi.num_records)}
    used = {s: False for s in roi_set}
    tips: set = set()

    if links:
        for s in sorted(used):
            if used[s]:
                continue
            e = TraversalEngine(TraversalConfig(
                graph=graph, traversal_colors=[child_color],
                joining_colors=list(parent_colors), direction=BOTH,
                combination=AND, stopping_rule=ContigStopper, rois=roi,
                links=list(links)))
            walk = e.walk(s)
            if not walk:
                continue
            left, right = walk[0], walk[-1]
            left_novel = left.canonical in roi_set
            no_left = len(e.get_prev_vertices(left.kmer)) == 0
            right_novel = right.canonical in roi_set
            no_right = len(e.get_next_vertices(right.kmer)) == 0
            is_tip = (left_novel and no_left) or (right_novel and no_right)
            for v in walk:
                if v.canonical in used:
                    used[v.canonical] = True
                    if is_tip:
                        tips.add(v.canonical)
        return _excluded_subset(roi, tips)

    cks = sorted(used)
    contigs = _batched_contigs(graph, child_color, cks, max_walk)
    # vectorized end-degree pass: popcount of the oriented prev/next basemask
    # of each chain's first/last kmer in child color
    k = graph.kmer_size
    lefts = [contigs[s][:k] for s in cks]
    rights = [contigs[s][-k:] for s in cks]
    lc, lf = km.canonicalize_codes(km.strings_to_codes(lefts))
    rc_, rf = km.canonicalize_codes(km.strings_to_codes(rights))
    li = graph.find_records(km.pack_codes(lc, k))
    ri = graph.find_records(km.pack_codes(rc_, k))
    le = np.where(li >= 0, graph.edges[np.maximum(li, 0), child_color], 0)
    re_ = np.where(ri >= 0, graph.edges[np.maximum(ri, 0), child_color], 0)
    lprev, _ = gr.edges_to_masks(le.astype(np.uint8), lf)
    _, rnext = gr.edges_to_masks(re_.astype(np.uint8), rf)
    pc4 = np.array([bin(x).count("1") for x in range(16)], dtype=np.uint8)
    no_left_arr = pc4[lprev] == 0
    no_right_arr = pc4[rnext] == 0
    left_novel_arr = np.array(
        [min(s, km.revcomp(s)) in roi_set for s in lefts])
    right_novel_arr = np.array(
        [min(s, km.revcomp(s)) in roi_set for s in rights])
    novel_in = _novel_in_factory(roi, k)
    for i, s in enumerate(cks):
        if used[s]:
            continue
        is_tip = bool((left_novel_arr[i] and no_left_arr[i])
                      or (right_novel_arr[i] and no_right_arr[i]))
        for canon in novel_in(contigs[s]):
            if canon in used:
                used[canon] = True
                if is_tip:
                    tips.add(canon)
    return _excluded_subset(roi, tips)


def find_orphans(graph: gr.CortexGraph, roi: gr.CortexGraph, parents: list) -> gr.CortexGraph:
    """Excluded = novel chains that never touch parental colors (FindOrphans.java)."""
    child = roi.sample_name(0)
    child_color = graph.color_for_sample(child)
    parent_colors = graph.colors_for_samples(parents)

    e = TraversalEngine(TraversalConfig(
        graph=graph, traversal_colors=[child_color],
        joining_colors=list(parent_colors), direction=BOTH, combination=AND,
        stopping_rule=OrphanStopper, rois=roi))

    orphans: set = set()
    for i in range(roi.num_records):
        canon = roi.kmer_string(i)
        if canon in orphans:
            continue
        if (len(e.get_next_vertices(canon)) == 0
                or len(e.get_prev_vertices(canon)) == 0):
            dfs = e.dfs(canon)
            if dfs is not None and dfs.num_vertices() > 0:
                for v in dfs.vertices():
                    orphans.add(v.canonical)
    return _excluded_subset(roi, orphans)


def _combine_kmers(piece: list) -> str:
    out = []
    for s in piece:
        out.append(s if not out else s[-1])
    return "".join(out)


def _split_contig_at_rois(contig: str, rois: set, k: int):
    """(non-novel pieces, novel canonical kmers seen) — the piece splitting
    shared by FindContamination/FindUnanchored (FindContamination.java:48-66)."""
    pieces = []
    piece: list = []
    seen: set = set()
    for i in range(len(contig) - k + 1):
        sk = contig[i:i + k]
        ck = min(sk, km.revcomp(sk))
        if ck in rois:
            if piece:
                pieces.append(_combine_kmers(piece))
                piece = []
            seen.add(ck)
        else:
            piece.append(sk)
    if piece:
        pieces.append(_combine_kmers(piece))
    return pieces, seen


def find_unanchored(graph: gr.CortexGraph, roi: gr.CortexGraph, parents: list,
                    lookups: dict, links=()) -> gr.CortexGraph:
    """Excluded = novel chains whose flanking pieces place confidently on no
    draft reference (FindUnanchored.java).  lookups: {name: IndexedReference}."""
    child_color = graph.color_for_sample(roi.sample_name(0))
    parent_colors = graph.colors_for_samples(parents)
    k = graph.kmer_size
    rois = {roi.kmer_string(i) for i in range(roi.num_records)}

    e = TraversalEngine(TraversalConfig(
        graph=graph, traversal_colors=[child_color],
        joining_colors=list(parent_colors), direction=BOTH, combination=OR,
        stopping_rule=ContigStopper, rois=roi, links=list(links)))

    used: set = set()
    unanchored: set = set()
    for rk in sorted(rois):
        if rk in used:
            continue
        contig = to_contig(e.walk(rk))
        pieces, seen = _split_contig_at_rois(contig, rois, k)
        has_alignments = False
        for p in pieces:
            for ir in lookups.values():
                srs = ir.align(p)
                if any(sr.mapq > 0 for sr in srs):
                    has_alignments = True
                    break
            if has_alignments:
                break
        if not has_alignments:
            unanchored |= seen
        used |= seen
    return _excluded_subset(roi, unanchored)


def find_contamination(graph: gr.CortexGraph, roi: gr.CortexGraph, parents: list,
                       contam: gr.CortexGraph, lookups: dict, links=()) -> gr.CortexGraph:
    """Excluded = ROI kmers on contaminant-seeded chains whose pieces never
    place confidently on any draft (FindContamination.java)."""
    child_color = graph.color_for_sample(roi.sample_name(0))
    parent_colors = graph.colors_for_samples(parents)
    k = graph.kmer_size
    rois = {roi.kmer_string(i) for i in range(roi.num_records)}

    e = TraversalEngine(TraversalConfig(
        graph=graph, traversal_colors=[child_color],
        joining_colors=list(parent_colors), direction=BOTH, combination=OR,
        stopping_rule=ContaminantStopper, rois=roi, links=list(links)))

    seen_rois: dict = {s: False for s in rois}
    contam_kmers: set = set()
    for i in range(contam.num_records):
        ck = contam.kmer_string(i)
        if ck not in seen_rois or seen_rois[ck]:
            continue
        walk = e.walk(ck)
        contig = to_contig(walk)
        pieces, _ = _split_contig_at_rois(contig, rois, k)
        well_aligned = False
        for p in pieces:
            for ir in lookups.values():
                srs = ir.align(p)
                if sum(1 for sr in srs if sr.mapq > 0) == 1:
                    well_aligned = True
        for v in walk:
            canon = v.canonical
            if canon in seen_rois:
                seen_rois[canon] = True
                if not well_aligned:
                    contam_kmers.add(canon)
    return _excluded_subset(roi, contam_kmers)


# ---------------------------------------------------------------------------
# Partition (discover/call/Partition.java:55-269)
# ---------------------------------------------------------------------------

def _batched_contigs(graph: gr.CortexGraph, color: int, cks: list,
                     max_walk: int, first_chunk: int = 512) -> dict:
    """Bidirectional single-path contig per seed kmer string (ContigStopper
    walk semantics, link-free) as one batch.  Returns {seed: contig}.

    Walks run in growing rounds (first_chunk, 4x, 16x, ... up to max_walk
    total): each round re-seeds only the walks that consumed the whole
    previous allotment, so 20k short error-tip chains cost one small kernel
    call while the rare chromosome-length chain still walks to its true end —
    the classification the per-ROI host loop gave at 15x the wall-clock."""
    k = graph.kmer_size
    if not cks:
        return {}

    from .. import native as nat
    wt = (nat.WalkTableNative(graph.kmers, graph.edges[:, color], k)
          if nat.available() else None)

    def batch_walk(seeds: list, steps: int):
        if wt is not None:
            b, cy, st = wt.walk(
                km.pack_codes(km.strings_to_codes(seeds), k), steps)
        else:
            from ..ops import walk_np as wnp
            b, cy, st = wnp.walk_forward_np(
                graph, [color], km.strings_to_codes(seeds), steps)
        return np.asarray(b).T, np.asarray(cy), np.asarray(st)

    def extend_all(seeds: list) -> list:
        """Full forward extension per seed (iterative rounds).  Replay and
        revisit gates run BATCHED (ops/walk_np.batch_replay_exts /
        batch_dedup_extensions — one rolling-hash pass per round instead of
        a per-seed kmerize/unique, which dominated the flagship prefilter
        at 96 s of its 103 s)."""
        from ..ops import walk_np as wnp
        exts = [""] * len(seeds)
        live = list(range(len(seeds)))
        cur = list(seeds)
        done_steps = 0
        chunk = min(first_chunk, max_walk)
        while live and done_steps < max_walk:
            chunk = min(chunk, max_walk - done_steps)
            seeds_live = [cur[i] for i in live]
            b, cy, st = batch_walk(seeds_live, chunk)
            round_exts = wnp.batch_replay_exts(seeds_live, b, cy, chunk)
            nxt_live = []
            for row, i in enumerate(live):
                ext = round_exts[row]
                exts[i] += ext
                cur[i] = (cur[i] + ext)[-k:]
                if not cy[row] and st[row] == chunk:
                    nxt_live.append(i)
            live = nxt_live
            done_steps += chunk
            chunk *= 4
        # chunk-local seen-sets can leak an extra lap around cycles longer
        # than one chunk; a final whole-extension replay is the oracle
        return wnp.batch_dedup_extensions(seeds, exts, max_walk)

    rc = [km.revcomp(s) for s in cks]
    fwd = extend_all(cks)
    back = extend_all(rc)
    return {s: (km.revcomp(b) if b else "") + s + f
            for s, f, b in zip(cks, fwd, back)}


# linked batches of at most max(NATIVE_LINK_THRESHOLD, records // 256) seeds
# go to the native walker (core.py:614-620); a negative value forces the
# device route.  Unlinked batches of at most SMALL_BATCH seeds walk on the
# host (core.py:783).  Both are the JAX package's TPU-tuned values.
NATIVE_LINK_THRESHOLD = 2048
SMALL_BATCH = 32768
CHUNK = 65536                 # seeds a walk chunk (and a checkpoint step)


def linked_device_min(num_records: int) -> int:
    """Largest linked seed batch the native walker takes."""
    if NATIVE_LINK_THRESHOLD < 0:
        return -1
    return max(NATIVE_LINK_THRESHOLD, num_records // 256)


def partition(graph: gr.CortexGraph, roi: gr.CortexGraph, links=(),
              link_novels: bool = False, max_walk: int = 20000,
              stats: dict | None = None, checkpoint: str | None = None,
              device=None) -> list:
    """Group novel kmers into partition contigs, as core.partition does.
    Returns [(name_header, contig_sequence), ...] in the reference's emit
    order.  `device` holds the jump table on the device routes (default: the
    CUDA card, and RuntimeError without one; "cpu" runs the plain twins);
    the host and native routes never read it."""
    if link_novels:
        return _partition_host(graph, roi, links, link_novels, max_walk)
    if links:
        return _partition_links(graph, roi, list(links), max_walk, stats,
                                checkpoint, device)
    return _partition_unlinked(graph, roi, max_walk, stats, checkpoint, device)


def _resume(checkpoint: str | None, fp: str, mode: str):
    """(next seed index, payload) of a checkpoint this route wrote, else
    (0, None): a checkpoint of another mode is not resumed."""
    saved = ckpt.load_chunk_state(checkpoint, fp) if checkpoint else None
    if saved is None:
        return 0, None
    start_at, payload = saved
    if not isinstance(payload, dict) or payload.get("mode") != mode:
        return 0, None
    return start_at, payload


def _save(checkpoint: str, fp: str, next_index: int, mode: str, **payload):
    ckpt.save_chunk_state(checkpoint, fp, next_index, {"mode": mode, **payload})


def _jump_table(graph: gr.CortexGraph, child_color: int, device, flags=None):
    """(jump table of the child colour on the device, build seconds)."""
    dev = resolve(device)
    t0 = time.perf_counter()
    jt = jump.build_jump_table(graph.kmers, graph.edges[:, child_color],
                               graph.kmer_size, flags=flags, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return jt, time.perf_counter() - t0


def _jump_walks(jt: jump.JumpTable, seqs: list, k: int, max_walk: int):
    """walk_forward_jumps' 6-tuple for walk-oriented seed strings."""
    seeds = km.pack_codes(km.strings_to_codes(seqs), k)
    return jump.walk_forward_jumps(jt.buckets, jt.rows, seeds, k, max_walk)


def _walk_stats(stats: dict, build_s: float, walk_s: float, dev_steps: int):
    stats["walk_kernel"] = "jump_table"
    stats["jump_table_build_s"] = round(build_s, 2)
    stats["device_walk_s"] = round(walk_s, 2)
    stats["device_steps"] = dev_steps
    stats["device_steps_per_s"] = round(dev_steps / walk_s) if walk_s > 0 else 0


def _partition_links(graph: gr.CortexGraph, roi: gr.CortexGraph, links: list,
                     max_walk: int, stats: dict | None = None,
                     checkpoint: str | None = None, device=None) -> list:
    """core._partition_links_device's two routes, with tagged checkpoints."""
    k = graph.kmer_size
    cks = sorted(roi.kmer_string(i) for i in range(roi.num_records))
    if not cks:
        return []
    child_color = graph.color_for_sample(roi.sample_name(0))
    fp = ckpt.graph_fingerprint(graph) if checkpoint else ""

    def native_assemble(walker, seeds):
        f, jf = walker.walk(seeds, max_walk)
        bk, jb = walker.walk([km.revcomp(s) for s in seeds], max_walk)
        return [(km.revcomp(bb) if bb else "") + s + ff
                for s, ff, bb in zip(seeds, f, bk)], jf + jb

    if nat.available() and len(cks) <= linked_device_min(graph.num_records):
        walker = nat.LinksWalkerNative(graph, [child_color], links)
        start_at, payload = _resume(checkpoint, fp, "native_links")
        contig_list: list = payload["contigs"] if payload else []
        junctions = np.asarray(payload["junctions"] if payload else [],
                               dtype=np.int64)
        for lo in range(start_at, len(cks), CHUNK):
            cl, jn = native_assemble(walker, cks[lo:lo + CHUNK])
            contig_list.extend(cl)
            junctions = np.concatenate([junctions, jn.astype(np.int64)])
            if checkpoint and lo + CHUNK < len(cks):
                _save(checkpoint, fp, lo + CHUNK, "native_links",
                      contigs=contig_list, junctions=junctions.tolist())
        if checkpoint:
            ckpt.clear_chunk_state(checkpoint)
        if stats is not None:
            stats["walk_kernel"] = "native_links"
            stats["link_junctions_resolved"] = int(junctions.sum())
            stats["link_replays"] = len(cks)
        return _greedy_emit(cks, dict(zip(cks, contig_list)), roi, k)

    # --- device jump walks + exact linked replay of link-touching walks ---
    jt, build_s = _jump_table(graph, child_color, device,
                              flags=link_kmer_flags(graph, links))
    rc = [km.revcomp(s) for s in cks]
    contigs: dict = {}
    start_at, payload = _resume(checkpoint, fp, "jump_table")
    relink: list = list(payload["relink"]) if payload else []
    if payload:
        contigs.update({s: c for s, c in zip(cks[:start_at], payload["contigs"])
                        if c is not None})
    t0 = time.perf_counter()
    dev_steps = 0
    for lo in range(start_at, len(cks), CHUNK):
        batch, rbatch = cks[lo:lo + CHUNK], rc[lo:lo + CHUNK]
        fpk, fcy, fst, fsat, ftch, fej = _jump_walks(jt, batch, k, max_walk)
        rpk, rcy, rst, rsat, rtch, rej = _jump_walks(jt, rbatch, k, max_walk)
        dev_steps += int(fst.sum()) + int(rst.sum())
        fwds = wnp.jump_extensions_batch(batch, fpk, fst, fcy, fsat, max_walk)
        backs = wnp.jump_extensions_batch(rbatch, rpk, rst, rcy, rsat, max_walk)
        for i, s in enumerate(batch):
            # links can change a link-free walk only when its path touched a
            # link-carrying k-mer and it stopped at a junction or around a
            # cycle; a saturated lane is replayed conservatively
            f_need = ftch[i] and (fej[i] or fcy[i] or fsat[i])
            r_need = rtch[i] and (rej[i] or rcy[i] or rsat[i])
            if f_need or r_need:
                relink.append(lo + i)
            else:
                contigs[s] = ((km.revcomp(backs[i]) if backs[i] else "")
                              + s + fwds[i])
        if checkpoint and lo + CHUNK < len(cks):
            _save(checkpoint, fp, lo + CHUNK, "jump_table",
                  contigs=[contigs.get(s) for s in cks[:lo + CHUNK]],
                  relink=relink)
    walk_s = time.perf_counter() - t0

    junctions_total = 0
    if relink:
        seeds = [cks[i] for i in relink]
        if nat.available():
            rw = nat.LinksWalkerNative(graph, [child_color], links)
            cl, jn = native_assemble(rw, seeds)
            junctions_total = int(jn.sum())
            for i, c in zip(relink, cl):
                contigs[cks[i]] = c
        else:
            e = TraversalEngine(TraversalConfig(
                graph=graph, traversal_colors=[child_color], direction=BOTH,
                combination=OR, stopping_rule=ContigStopper, rois=roi,
                links=links, max_branch_length=max_walk))
            for s in seeds:
                w = to_walk(e.dfs(s), s, child_color, graph=graph)
                contigs[s] = to_contig(w) if w else s

    if checkpoint:
        ckpt.clear_chunk_state(checkpoint)
    if stats is not None:
        _walk_stats(stats, build_s, walk_s, dev_steps)
        stats["link_replays"] = len(relink)
        stats["link_junctions_resolved"] = junctions_total
    return _greedy_emit(cks, contigs, roi, k)


def _partition_unlinked(graph: gr.CortexGraph, roi: gr.CortexGraph,
                        max_walk: int, stats: dict | None = None,
                        checkpoint: str | None = None, device=None) -> list:
    """core._partition_device: host walks replayed with the reference's
    stopping rule for small batches, jump walks on the device above
    SMALL_BATCH seeds."""
    k = graph.kmer_size
    cks = sorted(roi.kmer_string(i) for i in range(roi.num_records))
    if not cks:
        return []
    child_color = graph.color_for_sample(roi.sample_name(0))
    rc = [km.revcomp(s) for s in cks]
    contigs: dict = {}
    if len(cks) <= SMALL_BATCH:
        if nat.available():
            wt = nat.WalkTableNative(graph.kmers, graph.edges[:, child_color], k)
            fb, fc, _ = wt.walk(km.pack_codes(km.strings_to_codes(cks), k), max_walk)
            rb, rcy, _ = wt.walk(km.pack_codes(km.strings_to_codes(rc), k), max_walk)
        else:
            fb, fc, _ = wnp.walk_forward_np(
                graph, [child_color], km.strings_to_codes(cks), max_walk)
            rb, rcy, _ = wnp.walk_forward_np(
                graph, [child_color], km.strings_to_codes(rc), max_walk)
        fb, rb = fb.T, rb.T
        for i, s in enumerate(cks):
            fwd_ext = wnp.replay_walk(s, fb[i], bool(fc[i]), max_walk)
            back_ext = wnp.replay_walk(rc[i], rb[i], bool(rcy[i]), max_walk)
            contigs[s] = (km.revcomp(back_ext) if back_ext else "") + s + fwd_ext
        return _greedy_emit(cks, contigs, roi, k)

    fp = ckpt.graph_fingerprint(graph) if checkpoint else ""
    start_at, payload = _resume(checkpoint, fp, "unlinked_jump")
    if payload:
        contigs.update(zip(cks[:start_at], payload["contigs"]))
    jt, build_s = _jump_table(graph, child_color, device)
    t0 = time.perf_counter()
    dev_steps = 0
    for lo in range(start_at, len(cks), CHUNK):
        batch, rbatch = cks[lo:lo + CHUNK], rc[lo:lo + CHUNK]
        fpk, fcy, fst, fsat, _, _ = _jump_walks(jt, batch, k, max_walk)
        rpk, rcy, rst, rsat, _, _ = _jump_walks(jt, rbatch, k, max_walk)
        dev_steps += int(fst.sum()) + int(rst.sum())
        fwds = wnp.jump_extensions_batch(batch, fpk, fst, fcy, fsat, max_walk)
        backs = wnp.jump_extensions_batch(rbatch, rpk, rst, rcy, rsat, max_walk)
        for i, s in enumerate(batch):
            contigs[s] = (km.revcomp(backs[i]) if backs[i] else "") + s + fwds[i]
        if checkpoint and lo + CHUNK < len(cks):
            _save(checkpoint, fp, lo + CHUNK, "unlinked_jump",
                  contigs=[contigs[s] for s in cks[:lo + CHUNK]])
    if checkpoint:
        ckpt.clear_chunk_state(checkpoint)
    if stats is not None:
        _walk_stats(stats, build_s, time.perf_counter() - t0, dev_steps)
    return _greedy_emit(cks, contigs, roi, k)


def _novel_in_factory(roi: gr.CortexGraph, k: int):
    """contig -> sorted list of canonical novel kmer strings it contains."""
    roi_keys = np.sort(km.words_to_bytes_be(roi.kmers, k))

    def novel_in(contig: str) -> list:
        codes = km.string_to_codes_permissive(contig)
        if len(codes) < k:
            return []
        windows = km.kmerize_codes(codes, k)
        ok = (windows < 4).all(axis=1)
        if not ok.any():
            return []
        canon, _ = km.canonicalize_codes(windows[ok])
        keys = km.words_to_bytes_be(km.pack_codes(canon, k), k)
        i = np.minimum(np.searchsorted(roi_keys, keys), roi_keys.size - 1)
        hit = roi_keys[i] == keys
        return km.codes_to_strings(canon[hit])

    return novel_in


def _greedy_emit(cks: list, contigs: dict, roi: gr.CortexGraph, k: int) -> list:
    """The reference's greedy walk assignment + dedup + FASTA emit
    (Partition.java:169-219, markUsedRois :238-256): iterate novel kmers in
    sorted order, claim each novel kmer for the longest contig containing it,
    dedup fwd/rc, emit sorted."""
    novel_in = _novel_in_factory(roi, k)

    used: dict = {s: None for s in cks}
    for s in cks:
        if used[s] is not None:
            continue
        contig = contigs[s]
        for canon in novel_in(contig):
            if canon in used and (used[canon] is None
                                  or len(contig) > len(used[canon])):
                used[canon] = contig

    contig_set: set = set()
    for s in cks:
        c = used[s]
        if c is not None and c not in contig_set and km.revcomp(c) not in contig_set:
            contig_set.add(c)

    out = []
    for i, contig in enumerate(sorted(contig_set)):
        num_novels = len(novel_in(contig))
        header = f"partition{i} len={len(contig) - k + 1} numNovels={num_novels}"
        out.append((header, contig))
    return out


def link_kmer_flags(graph: gr.CortexGraph, links) -> np.ndarray:
    """bool[N] over graph records: True where the kmer carries link records
    in ANY of the given link sets — the per-kmer attribute the jump-table
    build propagates along runs (build_jump_table flags) so walked lanes
    learn link contact with zero host hashing."""
    key_strs: set = set()
    for lm in links:
        idx = getattr(lm, "index", None)
        key_strs |= set(idx if idx is not None
                        else getattr(lm, "records", {}))
    flags = np.zeros(graph.num_records, dtype=bool)
    if key_strs:
        canon, _ = km.canonicalize_codes(
            km.strings_to_codes(sorted(key_strs)))
        idxs = graph.find_records(km.pack_codes(canon, graph.kmer_size))
        flags[idxs[idxs >= 0]] = True
    return flags


def _partition_host(graph: gr.CortexGraph, roi: gr.CortexGraph, links,
                    link_novels: bool, max_walk: int = 20000) -> list:
    child_color = graph.color_for_sample(roi.sample_name(0))

    e = TraversalEngine(TraversalConfig(
        graph=graph, traversal_colors=[child_color], direction=BOTH,
        combination=OR,
        stopping_rule=NovelPartitionStopper if link_novels else ContigStopper,
        rois=roi, links=list(links),
        max_branch_length=max_walk,
    ))

    # used: canonical kmer -> assigned walk (or None), iterated in sorted order
    # (reference uses a TreeMap, Partition.java:258-265)
    used: dict = {roi.kmer_string(i): None for i in range(roi.num_records)}

    from ..traversal.subgraph import Vertex

    for ck in sorted(used):
        if used[ck] is not None:
            continue
        g = e.dfs(ck)
        w = to_walk(g, ck, child_color, graph=graph)
        if not w:
            w = [Vertex(ck, graph.find_record(ck))]
        # claim novel kmers on the walk; keep the longest walk per kmer
        for v in w:
            canon = v.canonical
            if canon in used and (used[canon] is None or len(w) > len(used[canon])):
                used[canon] = w

    contigs: list = []
    contig_set: set = set()
    for ck in used:
        if used[ck] is not None:
            fw = to_contig(used[ck])
            rc = km.revcomp(fw)
            if fw not in contig_set and rc not in contig_set:
                contig_set.add(fw)

    out = []
    k = graph.kmer_size
    for i, contig in enumerate(sorted(contig_set)):
        num_novels = sum(
            1 for j in range(len(contig) - k + 1)
            if min(contig[j:j + k], km.revcomp(contig[j:j + k])) in used)
        header = f"partition{i} len={len(contig) - k + 1} numNovels={num_novels}"
        out.append((header, contig))
    return out
