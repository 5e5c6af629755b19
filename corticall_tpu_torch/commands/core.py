"""Partition for the port: the three routes of corticall_tpu.commands.core.

- link_novels: the exact host engine (core._partition_host).
- with links: the native C++ linked walker (core.py's `native_links` route)
  when the seed batch is at most max(2048, records // 256) — the route the
  pipeline takes at P. falciparum scale.
- without links: the native (or numpy) host walk with replay_walk for at
  most 32768 seeds.

The JAX package's jump-table device routes take the larger batches; their
port is a ROADMAP item ("jump-table build and walk", then "Partition's device
routes").  Until then those batches raise NotImplementedError — they never
fall back to the host.
"""

from __future__ import annotations

import numpy as np

from corticall_tpu import graph as gr
from corticall_tpu import kmer as km
from corticall_tpu import native as nat
from corticall_tpu.commands import core as _core
from corticall_tpu.ops import walk_np as wnp
from corticall_tpu.utils import checkpoint as ckpt

_NOT_PORTED = ("the jump-table device walk is not ported yet "
               "(ROADMAP.md §2: jump-table build and walk, then Partition's "
               "device routes)")

# core._partition_device's host-walk limit
SMALL_BATCH = 32768


def partition(graph: gr.CortexGraph, roi: gr.CortexGraph, links=(),
              link_novels: bool = False, max_walk: int = 20000,
              stats: dict | None = None,
              checkpoint: str | None = None) -> list:
    """Group novel kmers into partition contigs, as core.partition does.
    Returns [(name_header, contig_sequence), ...] in the reference's emit
    order."""
    if link_novels:
        return _core._partition_host(graph, roi, links, link_novels, max_walk)
    if links:
        return _partition_links(graph, roi, list(links), max_walk, stats,
                                checkpoint)
    return _partition_unlinked(graph, roi, max_walk)


def _partition_links(graph: gr.CortexGraph, roi: gr.CortexGraph, links: list,
                     max_walk: int, stats: dict | None = None,
                     checkpoint: str | None = None,
                     chunk: int = 65536) -> list:
    """core._partition_links_device's native-only route (exact unbounded
    LinkStore walks), with its chunk checkpoints."""
    k = graph.kmer_size
    cks = sorted(roi.kmer_string(i) for i in range(roi.num_records))
    if not cks:
        return []
    if not (nat.available()
            and len(cks) <= _core._linked_device_min(graph.num_records)):
        raise NotImplementedError(
            f"linked Partition of {len(cks)} seeds over {graph.num_records} "
            f"records (native core available: {nat.available()}): {_NOT_PORTED}")
    child_color = graph.color_for_sample(roi.sample_name(0))
    walker = nat.LinksWalkerNative(graph, [child_color], links)

    def native_assemble(seeds):
        f, jf = walker.walk(seeds, max_walk)
        bk, jb = walker.walk([km.revcomp(s) for s in seeds], max_walk)
        return [(km.revcomp(bb) if bb else "") + s + ff
                for s, ff, bb in zip(seeds, f, bk)], jf + jb

    fp = ckpt.graph_fingerprint(graph) if checkpoint else ""
    start_at = 0
    contig_list: list = []
    junctions = np.zeros(0, dtype=np.int64)
    if checkpoint:
        saved = ckpt.load_chunk_state(checkpoint, fp)
        if saved is not None:
            start_at, payload = saved
            contig_list = payload["contigs"]
            junctions = np.asarray(payload["junctions"], dtype=np.int64)
    for lo in range(start_at, len(cks), chunk):
        cl, jn = native_assemble(cks[lo:lo + chunk])
        contig_list.extend(cl)
        junctions = np.concatenate([junctions, jn.astype(np.int64)])
        if checkpoint and lo + chunk < len(cks):
            ckpt.save_chunk_state(checkpoint, fp, lo + chunk, {
                "contigs": contig_list, "junctions": junctions.tolist()})
    if checkpoint:
        ckpt.clear_chunk_state(checkpoint)
    if stats is not None:
        stats["walk_kernel"] = "native_links"
        stats["link_junctions_resolved"] = int(junctions.sum())
        stats["link_replays"] = len(cks)
    return _core._greedy_emit(cks, dict(zip(cks, contig_list)), roi, k)


def _partition_unlinked(graph: gr.CortexGraph, roi: gr.CortexGraph,
                        max_walk: int) -> list:
    """core._partition_device's host route: native WalkTable (or the numpy
    twin) walks, replayed with the reference's stopping rule."""
    k = graph.kmer_size
    cks = sorted(roi.kmer_string(i) for i in range(roi.num_records))
    if not cks:
        return []
    if len(cks) > SMALL_BATCH:
        raise NotImplementedError(
            f"unlinked Partition of {len(cks)} seeds: {_NOT_PORTED}")
    child_color = graph.color_for_sample(roi.sample_name(0))
    rc = [km.revcomp(s) for s in cks]
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
    contigs: dict = {}
    for i, s in enumerate(cks):
        fwd_ext = wnp.replay_walk(s, fb[i], bool(fc[i]), max_walk)
        back_ext = wnp.replay_walk(rc[i], rb[i], bool(rcy[i]), max_walk)
        contigs[s] = (km.revcomp(back_ext) if back_ext else "") + s + fwd_ext
    return _core._greedy_emit(cks, contigs, roi, k)
