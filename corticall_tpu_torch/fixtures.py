"""In-memory graph/link fixture builders — the test backbone.

Replicates the reference's fake-backend pattern (TempGraphAssembler.java:19-99,
TempLinksAssembler.java:29-105): literal haplotype strings -> spec-conformant
multi-color graph; simulated reads -> link annotations.  Everything downstream
is tested against graphs built here, asserting the exact same golden record
strings as the reference test suite (TraversalEngineTest.java:48-95).
"""

from __future__ import annotations

import numpy as np

from . import kmer as km
from . import graph as gr
from .io import ctx as ctxio


def build_graph(haplotypes: dict, kmer_size: int) -> gr.CortexGraph:
    """haplotypes: {sample_name: [sequence, ...]} -> multi-color CortexGraph.

    Per occurrence of each kmer in a sample's sequences: coverage +1 for that
    color; in/out edges recorded in canonical orientation (flipped kmers get
    complemented, swapped edges — TempGraphAssembler.java:81-98).
    """
    sample_names = list(haplotypes.keys())
    num_colors = len(sample_names)
    k = kmer_size

    all_words = []
    all_color = []
    all_in = []
    all_out = []

    for c, name in enumerate(sample_names):
        for seq in haplotypes[name]:
            seq = seq.upper()
            if len(seq) < k:
                continue
            codes = km.string_to_codes(seq)
            windows = km.kmerize_codes(codes, k)          # [M, k]
            m = windows.shape[0]
            canon, flipped = km.canonicalize_codes(windows)
            words = km.pack_codes(canon, k)

            prev_base = np.full(m, -1, dtype=np.int8)
            next_base = np.full(m, -1, dtype=np.int8)
            prev_base[1:] = codes[:m - 1]
            next_base[:-1] = codes[k:]

            # canonical-orientation edge masks per occurrence
            in_mask = np.zeros(m, dtype=np.uint8)
            out_mask = np.zeros(m, dtype=np.uint8)
            has_prev, has_next = prev_base >= 0, next_base >= 0

            fwd = ~flipped
            in_mask |= np.where(fwd & has_prev, (1 << np.maximum(prev_base, 0)).astype(np.uint8), 0)
            out_mask |= np.where(fwd & has_next, (1 << np.maximum(next_base, 0)).astype(np.uint8), 0)
            in_mask |= np.where(flipped & has_next, (1 << (3 - np.maximum(next_base, 0))).astype(np.uint8), 0)
            out_mask |= np.where(flipped & has_prev, (1 << (3 - np.maximum(prev_base, 0))).astype(np.uint8), 0)

            all_words.append(words)
            all_color.append(np.full(m, c, dtype=np.int32))
            all_in.append(in_mask)
            all_out.append(out_mask)

    if not all_words:
        w = km.words_per_kmer(k)
        return gr.from_arrays(sample_names, k,
                              np.zeros((0, w), np.uint32),
                              np.zeros((0, num_colors), np.uint32),
                              np.zeros((0, num_colors), np.uint8))

    words = np.concatenate(all_words)
    color = np.concatenate(all_color)
    in_mask = np.concatenate(all_in)
    out_mask = np.concatenate(all_out)

    keys = km.words_to_bytes_be(words, k)
    uniq, inv = np.unique(keys, return_inverse=True)
    n = len(uniq)

    cov = np.zeros((n, num_colors), dtype=np.uint32)
    np.add.at(cov, (inv, color), 1)

    in_masks = np.zeros((n, num_colors), dtype=np.uint8)
    out_masks = np.zeros((n, num_colors), dtype=np.uint8)
    np.bitwise_or.at(in_masks, (inv, color), in_mask)
    np.bitwise_or.at(out_masks, (inv, color), out_mask)

    edges = (gr.rev4(in_masks).astype(np.uint8) << np.uint8(4)) | out_masks

    kmers = km.bytes_be_to_words(uniq, k)
    return gr.from_arrays(sample_names, k, kmers, cov, edges)


def write_graph(g: gr.CortexGraph, path) -> gr.CortexGraph:
    ctxio.write_ctx(path, g.data)
    return gr.CortexGraph.load(path)
