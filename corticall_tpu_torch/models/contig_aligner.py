"""Whole-contig aligner with the banded-SW pre-score on the CUDA kernel.

Counterpart of corticall_tpu/models/contig_aligner.py: the same seed-chain
candidates, survivor rule (>= 0.8 x the query's best pre-score, plus the
length-aware guard), host Gotoh traceback of the survivors and stats keys.
The pre-score runs through ops/sw_device.sw_banded.

The JAX package pads every batch to one (DEV_Q, DEV_S) shape to bound TPU
compiles; here a batch pads to its own maxima rounded up to a multiple of 8.
Padding with code 4 leaves every score unchanged.  DEV_Q and DEV_S stay as
the limits on which batches go to the device, so the same batches do.
"""

from __future__ import annotations

import torch

from .. import kmer as km
from ..device import resolve
from ..ops import sw_device as swd

# largest query / window the device pre-score takes (the JAX package's pad
# shape), the pre-score band, and the smallest batch sent to the device
DEV_Q = 4096
DEV_S = 8192
DEV_BAND = 512
MIN_DEVICE_BATCH = 8


def _device_ok(device: torch.device) -> bool:
    return device.type == "cuda"


def _round8(n: int) -> int:
    return max(8, (n + 7) // 8 * 8)


def align_contigs(queries: dict, references: dict, band: int = 512,
                  max_chains: int = 8, use_device: bool | None = None,
                  stats: dict | None = None, device=None) -> dict:
    """{query_name: [Alignment...]} per contig across ALL references.

    queries: {name: sequence}; references: {ref_name: IndexedReference}.
    band: the host window extension's band.  The device pre-score always
    uses DEV_BAND, as the JAX package does.  device: the pre-score's device
    (default: the CUDA card, and RuntimeError without one; "cpu" runs the
    plain twin).  use_device defaults to "the device is CUDA"; False keeps
    every window on the host and never reads `device`.
    """
    if use_device is not False:
        device = resolve(device)
        if use_device is None:
            use_device = _device_ok(device)

    # 1. seed-chain candidates per (query, reference)
    cand: dict = {qn: [] for qn in queries}
    for qn, qseq in queries.items():
        for rn, ir in references.items():
            for name, neg, r0, window in ir.candidate_windows(
                    qseq, max_chains=max_chains, band=band):
                cand[qn].append((ir, rn, name, neg, r0, window))

    # 2. batched device pre-score; per query only candidates within 0.8 of
    # its device-best go to host traceback
    survivors: dict = {qn: list(range(len(cand[qn]))) for qn in cand}
    n_scored = 0
    items = [(qn, ci) for qn in cand for ci in range(len(cand[qn]))
             if len(cand[qn]) > 1]
    fits = items and all(len(queries[qn]) <= DEV_Q
                         and len(cand[qn][ci][5]) <= DEV_S
                         for qn, ci in items)
    if use_device and fits and len(items) >= MIN_DEVICE_BATCH:
        qs_list, ws_list = [], []
        for qn, ci in items:
            ir, rn, name, neg, r0, window = cand[qn][ci]
            qseq = queries[qn]
            qs_list.append(km.revcomp(qseq) if neg else qseq)
            ws_list.append(window)
        qcodes = swd.codes_batch(qs_list, _round8(max(map(len, qs_list))))
        wcodes = swd.codes_batch(ws_list, _round8(max(map(len, ws_list))))
        sc, _, _ = swd.sw_banded(torch.from_numpy(qcodes).to(device),
                                 torch.from_numpy(wcodes).to(device),
                                 band=DEV_BAND)
        sc = sc.cpu().numpy()
        n_scored = len(items)
        scores = {key: float(s) for key, s in zip(items, sc)}
        for qn in cand:
            if len(cand[qn]) <= 1:
                continue
            ss = [scores.get((qn, ci), 0.0)
                  for ci in range(len(cand[qn]))]
            best = max(ss) if ss else 0.0
            keep = [ci for ci, s in enumerate(ss) if s >= 0.8 * best]
            # length-aware guard: final ranking is by alignment LENGTH desc
            # then NM asc, so a long, diverged placement must not be pruned
            # because a short exact repeat hit out-scores it — also keep any
            # candidate whose window span exceeds the longest survivor's
            max_span = max((len(cand[qn][ci][5]) for ci in keep), default=0)
            keep += [ci for ci in range(len(cand[qn]))
                     if ci not in keep and len(cand[qn][ci][5]) > max_span]
            survivors[qn] = sorted(keep)

    # 3. host traceback of the surviving candidates only
    out: dict = {}
    for qn in cand:
        alignments = []
        for ci in survivors[qn]:
            ir, rn, name, neg, r0, window = cand[qn][ci]
            a = ir.extend_window(queries[qn], name, neg, r0, window)
            if a is not None:
                a.reference = rn
                alignments.append(a)
        if alignments:
            type(next(iter(references.values()))).rank(alignments)
        out[qn] = alignments
    if stats is not None:
        stats["device_scored_windows"] = n_scored
        stats["host_tracebacks"] = sum(len(v) for v in survivors.values())
    return out
