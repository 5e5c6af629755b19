"""Port's align_contigs (corticall_tpu_torch/models/contig_aligner.py) against
the JAX package's, both with the device pre-score engaged (the port's plain
twin on the CPU, the JAX package's Pallas kernel in interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import kmer as km  # noqa: E402
from corticall_tpu.models.reference_index import IndexedReference  # noqa: E402
from corticall_tpu_torch.models import contig_aligner as tca  # noqa: E402


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _per_contig_case():
    """tests/test_align_contigs.py's first case."""
    rng = np.random.default_rng(31)
    ref = _genome(rng, 20000)
    queries = {}
    for i, (a, n) in enumerate([(500, 800), (3000, 1500), (7000, 2500),
                                (12000, 600)]):
        q = ref[a:a + n]
        queries[f"c{i}"] = km.revcomp(q) if i % 2 else q
    return queries, IndexedReference({"chr1": ref}), 64


def _nahr_case():
    """tests/test_align_contigs.py's second case: a mosaic contig."""
    rng = np.random.default_rng(37)
    ref = _genome(rng, 30000)
    mosaic = ref[2000:2600] + ref[20000:20700] + ref[2600:3200]
    return {"m": mosaic}, IndexedReference({"chr1": ref}), 512


def _repeat_case():
    """Contigs over a segmental duplication: every contig has two placements,
    so the batch reaches MIN_DEVICE_BATCH without forcing it."""
    rng = np.random.default_rng(41)
    unit = _genome(rng, 900)
    diverged = "".join(c if rng.random() > 0.03 else "ACGT"[(("ACGT".index(c)) + 1) % 4]
                       for c in unit)
    ref = _genome(rng, 3000) + unit + _genome(rng, 4000) + diverged + _genome(rng, 2000)
    queries = {f"r{i}": (unit[a:a + 300] if i % 2 == 0
                         else km.revcomp(unit[a:a + 300]))
               for i, a in enumerate(range(0, 600, 100))}
    return queries, IndexedReference({"chr1": ref}), 64


def _summary(out):
    return {qn: [vars(a) for a in als] for qn, als in out.items()}


@pytest.mark.parametrize("make,force,dev_q,dev_s", [
    (_per_contig_case, True, 4096, 8192),
    (_nahr_case, True, 2048, 4096),
    (_repeat_case, False, 512, 1024)])
def test_align_contigs_matches_jax(monkeypatch, make, force, dev_q, dev_s):
    pytest.importorskip("jax")
    from corticall_tpu.models import contig_aligner as jca
    queries, ir, band = make()
    # the JAX side pads every batch to (DEV_Q, DEV_S); shrink that shape so
    # interpret mode stays fast — every device-scored window here still fits
    monkeypatch.setattr(jca, "DEV_Q", dev_q)
    monkeypatch.setattr(jca, "DEV_S", dev_s)
    if force:
        monkeypatch.setattr(jca, "MIN_DEVICE_BATCH", 1)
        monkeypatch.setattr(tca, "MIN_DEVICE_BATCH", 1)
    want_stats, got_stats = {}, {}
    want = jca.align_contigs(queries, {"mom": ir}, band=band, use_device=True,
                             stats=want_stats)
    got = tca.align_contigs(queries, {"mom": ir}, band=band, use_device=True,
                            stats=got_stats, device="cpu")
    assert _summary(got) == _summary(want)
    assert got_stats == want_stats
    if make is not _per_contig_case:
        assert got_stats["device_scored_windows"] > 0


def test_default_use_device_follows_device():
    queries, ir, band = _repeat_case()
    stats = {}
    tca.align_contigs(queries, {"mom": ir}, band=band, stats=stats, device="cpu")
    assert stats["device_scored_windows"] == 0
    stats_dev = {}
    tca.align_contigs(queries, {"mom": ir}, band=band, stats=stats_dev,
                      device="cpu", use_device=True)
    assert stats_dev["device_scored_windows"] >= tca.MIN_DEVICE_BATCH
