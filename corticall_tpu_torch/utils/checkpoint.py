"""Checkpoint/resume for long device computations.

The reference checkpoints only at pipeline granularity (every intermediate
file lands on GCS between Cromwell tasks; SURVEY §5).  Here the in-process
walk state is checkpointable too: the batched walk kernels carry all state in
arrays, so a checkpoint is an npz of (cursor kmers, activity, emitted bases so
far) plus the graph identity, and resume re-enters the scan from the saved
frontier.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np


def graph_fingerprint(g) -> str:
    """Stable identity for a graph's record set."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(g.kmers).tobytes())
    h.update(np.ascontiguousarray(g.coverages).tobytes())
    h.update(np.ascontiguousarray(g.edges).tobytes())
    return h.hexdigest()[:16]


def save_walk_state(path, *, cur, active, bases_so_far, graph_fp: str,
                    meta=None) -> None:
    np.savez_compressed(
        path,
        cur=np.asarray(cur), active=np.asarray(active),
        bases=np.asarray(bases_so_far),
        meta=json.dumps({"graph": graph_fp, **(meta or {})}))


def load_walk_state(path) -> dict:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    return {"cur": z["cur"], "active": z["active"], "bases": z["bases"],
            "meta": meta}


def save_chunk_state(path, graph_fp: str, next_index: int, contigs: list) -> None:
    """Checkpoint a chunked batch computation (e.g. Partition's walk chunks):
    contigs computed so far + the next chunk start.  Written atomically so a
    kill mid-write leaves the previous checkpoint intact."""
    import gzip
    import os
    tmp = str(path) + ".tmp"
    with gzip.open(tmp, "wt") as f:
        json.dump({"graph": graph_fp, "next": next_index,
                   "contigs": contigs}, f)
    os.replace(tmp, path)


def load_chunk_state(path, graph_fp: str):
    """(next_index, contigs) if a checkpoint for this graph exists, else None."""
    import gzip
    import os
    if not path or not os.path.exists(path):
        return None
    try:
        with gzip.open(path, "rt") as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    if d.get("graph") != graph_fp:
        return None
    return d["next"], d["contigs"]


def clear_chunk_state(path) -> None:
    import os
    if path and os.path.exists(path):
        os.remove(path)


def resume_walks(dg, colors, state: dict, num_steps: int):
    """Continue interrupted walks from a saved frontier: the saved cursor
    k-mers walked by ops/cuckoo.walk_forward_spec over the DeviceGraph's walk
    table, on its device.  Returns (bases int8 [T, B] continuing the saved
    stream, cycled bool [B], steps int32 [B])."""
    from ..ops import cuckoo as ck
    from ..ops.kmer import words_tensor

    seeds = words_tensor(state["cur"], dg.device)
    return ck.walk_forward_spec(dg.walk_buckets(colors), seeds, dg.kmer_size, num_steps)
