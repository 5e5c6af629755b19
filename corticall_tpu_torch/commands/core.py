"""Partition for the port: the routes of corticall_tpu.commands.core.partition.

- link_novels: the exact host engine (core._partition_host).
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

import time

import numpy as np
import torch

from corticall_tpu import graph as gr
from corticall_tpu import kmer as km
from corticall_tpu import native as nat
from corticall_tpu.commands import core as _core
from corticall_tpu.ops import walk_np as wnp
from corticall_tpu.traversal import (BOTH, OR, TraversalConfig, TraversalEngine,
                                     to_contig, to_walk)
from corticall_tpu.traversal.stopping import ContigStopper
from corticall_tpu.utils import checkpoint as ckpt

from ..device import resolve
from ..ops import jump

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
    order.  `device` holds the jump table on the device routes (default:
    CUDA when present)."""
    if link_novels:
        return _core._partition_host(graph, roi, links, link_novels, max_walk)
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
        return _core._greedy_emit(cks, dict(zip(cks, contig_list)), roi, k)

    # --- device jump walks + exact linked replay of link-touching walks ---
    jt, build_s = _jump_table(graph, child_color, device,
                              flags=_core.link_kmer_flags(graph, links))
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
    return _core._greedy_emit(cks, contigs, roi, k)


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
        return _core._greedy_emit(cks, contigs, roi, k)

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
    return _core._greedy_emit(cks, contigs, roi, k)
