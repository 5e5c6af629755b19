"""The port's Partition (corticall_tpu_torch/commands/core.py) against the
JAX package's core.partition and the exact host engine, with each device
route forced; its own routing thresholds; and its tagged chunk checkpoints.
The graphs are built by the JAX package and carried to the port through
their .ctx and .ctp bytes.  Partitions are lists of strings: every
comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu.commands import core  # noqa: E402
from corticall_tpu_torch.commands import core as tcore  # noqa: E402
from corticall_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_partition_links import _mk_graph_with_repeats  # noqa: E402
from test_torch_host import port_graph, port_links  # noqa: E402


def _carried(jg, jrois, jlinks):
    return port_graph(jg), port_graph(jrois), port_links(jlinks)


@pytest.fixture(scope="module")
def jax_case():
    return _mk_graph_with_repeats(np.random.default_rng(17), 15)


@pytest.fixture(scope="module")
def case(jax_case):
    """The port's graph, ROIs and links, and the JAX package's host-engine
    partitions of them."""
    jg, jrois, jlinks = jax_case
    host_linked = core._partition_host(jg, jrois, [jlinks], link_novels=False,
                                       max_walk=4096)
    host_unlinked = core._partition_host(jg, jrois, [], link_novels=False,
                                         max_walk=4096)
    return (*_carried(jg, jrois, jlinks), host_linked, host_unlinked)


def test_linked_device_route_matches_jax_and_host(monkeypatch, jax_case, case):
    pytest.importorskip("jax")
    g, rois, links, host_linked, _ = case
    jg, jrois, jlinks = jax_case
    monkeypatch.setattr(core, "_NATIVE_LINK_THRESHOLD", -1)
    monkeypatch.setattr(tcore, "NATIVE_LINK_THRESHOLD", -1)
    want_stats, got_stats = {}, {}
    want = core.partition(jg, jrois, links=[jlinks], max_walk=4096, stats=want_stats)
    got = tcore.partition(g, rois, links=[links], max_walk=4096, stats=got_stats,
                          device="cpu")
    assert got == want == host_linked
    assert got_stats["walk_kernel"] == want_stats["walk_kernel"] == "jump_table"
    assert got_stats["link_replays"] == want_stats["link_replays"] > 0
    for key in ("device_steps", "link_junctions_resolved"):
        assert got_stats[key] == want_stats[key]
    assert set(got_stats) == set(want_stats)


def test_unlinked_device_route_matches_jax_and_host(monkeypatch, jax_case, case):
    pytest.importorskip("jax")
    g, rois, _, _, host_unlinked = case
    jg, jrois, _ = jax_case
    monkeypatch.setattr(tcore, "SMALL_BATCH", -1)
    stats = {}
    got = tcore.partition(g, rois, max_walk=4096, stats=stats, device="cpu")
    want = core._partition_device(jg, jrois, 4096, small_batch=-1)
    assert got == want == host_unlinked
    assert stats["walk_kernel"] == "jump_table" and stats["device_steps"] > 0


def test_default_routes_match_host(case):
    g, rois, links, host_linked, host_unlinked = case
    stats = {}
    assert tcore.partition(g, rois, links=[links], max_walk=4096,
                           stats=stats, device="cpu") == host_linked
    assert stats["walk_kernel"] == ("native_links" if tcore.nat.available()
                                    else "jump_table")
    assert tcore.partition(g, rois, max_walk=4096) == host_unlinked


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("linked", [True, False])
def test_jump_route_without_device_raises(monkeypatch, no_card, case, linked):
    g, rois, links = case[:3]
    monkeypatch.setattr(tcore, "NATIVE_LINK_THRESHOLD", -1)
    monkeypatch.setattr(tcore, "SMALL_BATCH", -1)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tcore.partition(g, rois, links=[links] if linked else (), max_walk=4096)


def test_host_routes_need_no_device(monkeypatch, no_card, case):
    """The host routes (native linked walker, host unlinked walks,
    link_novels) never read `device`, so None does not raise there."""
    g, rois, links, host_linked, host_unlinked = case
    assert tcore.partition(g, rois, max_walk=4096) == host_unlinked
    assert tcore.partition(g, rois, links=[links], link_novels=True,
                           max_walk=4096)
    if tcore.nat.available():
        stats = {}
        assert tcore.partition(g, rois, links=[links], max_walk=4096,
                               stats=stats) == host_linked
        assert stats["walk_kernel"] == "native_links"


def test_without_native_core_the_device_route_runs(monkeypatch):
    """The JAX package routes a linked batch to the device when the native
    core is missing, and replays the link-touching walks on the host
    engine; the port does the same (it used to raise)."""
    rng = np.random.default_rng(19)
    jg, jrois, jlinks = _mk_graph_with_repeats(rng, 15, n=500, unit_len=30)
    host_linked = core._partition_host(jg, jrois, [jlinks], link_novels=False,
                                       max_walk=1024)
    g, rois, links = _carried(jg, jrois, jlinks)
    monkeypatch.setattr(tcore.nat, "available", lambda: False)
    stats = {}
    got = tcore.partition(g, rois, links=[links], max_walk=1024, stats=stats,
                          device="cpu")
    assert got == host_linked
    assert stats["walk_kernel"] == "jump_table" and stats["link_replays"] > 0
    assert stats["link_junctions_resolved"] == 0      # the host engine's replay


def test_routing_constants_are_the_ports_own(monkeypatch, case):
    g = case[0]
    n = 1 << 22
    assert tcore.linked_device_min(n) == core._linked_device_min(n) == n // 256
    assert tcore.SMALL_BATCH == 32768
    monkeypatch.setattr(tcore, "NATIVE_LINK_THRESHOLD", -1)
    assert tcore.linked_device_min(n) == -1
    assert core._linked_device_min(n) == n // 256
    monkeypatch.setattr(tcore, "NATIVE_LINK_THRESHOLD", 2048)
    monkeypatch.setattr(core, "_NATIVE_LINK_THRESHOLD", -1)
    assert core._linked_device_min(n) == -1
    assert tcore.linked_device_min(g.num_records) == 2048
    if tcore.nat.available():
        stats = {}
        tcore.partition(g, case[1], links=[case[2]], max_walk=4096, stats=stats)
        assert stats["walk_kernel"] == "native_links"


class _Stop(Exception):
    """A run cut short after a checkpoint was written."""


def _interrupt_after(monkeypatch, calls: int):
    """Count the jump walk's calls; raise _Stop after `calls` of them."""
    real = tcore._jump_walks
    seen = []

    def walks(*args):
        if len(seen) == calls:
            raise _Stop
        seen.append(1)
        return real(*args)
    monkeypatch.setattr(tcore, "_jump_walks", walks)
    return seen


@pytest.mark.parametrize("linked", [True, False])
def test_checkpoint_resumes_its_own_mode(monkeypatch, tmp_path, case, linked):
    g, rois, links, host_linked, host_unlinked = case
    monkeypatch.setattr(tcore, "NATIVE_LINK_THRESHOLD", -1)
    monkeypatch.setattr(tcore, "SMALL_BATCH", -1)
    monkeypatch.setattr(tcore, "CHUNK", 16)
    assert rois.num_records > 3 * 16
    kw = dict(links=[links] if linked else (), max_walk=4096, device="cpu")
    path = str(tmp_path / "partition.ckpt")
    with monkeypatch.context() as m:
        _interrupt_after(m, 4)                        # two chunks, both ways
        with pytest.raises(_Stop):
            tcore.partition(g, rois, checkpoint=path, **kw)
    saved = ckpt.load_chunk_state(path, ckpt.graph_fingerprint(g))
    assert saved[0] == 32
    assert saved[1]["mode"] == ("jump_table" if linked else "unlinked_jump")
    seen = _interrupt_after(monkeypatch, 10 ** 6)
    got = tcore.partition(g, rois, checkpoint=path, **kw)
    assert got == (host_linked if linked else host_unlinked)
    n_chunks = -(-rois.num_records // 16)
    assert len(seen) == 2 * (n_chunks - 2)            # resumed at chunk 2
    assert not (tmp_path / "partition.ckpt").exists()


@pytest.mark.parametrize("payload", [
    {"mode": "native_links", "contigs": ["ACGT"] * 32, "junctions": [0] * 32},
    {"mode": "unlinked_jump", "contigs": ["ACGT"] * 32},
    {"contigs": ["ACGT"] * 32, "relink": []},      # the JAX package's, untagged
    ["ACGT"] * 32,
])
def test_checkpoint_of_another_mode_restarts(monkeypatch, tmp_path, case, payload):
    g, rois, links, host_linked, _ = case
    monkeypatch.setattr(tcore, "NATIVE_LINK_THRESHOLD", -1)
    monkeypatch.setattr(tcore, "CHUNK", 16)
    path = str(tmp_path / "partition.ckpt")
    ckpt.save_chunk_state(path, ckpt.graph_fingerprint(g), 32, payload)
    seen = _interrupt_after(monkeypatch, 10 ** 6)
    got = tcore.partition(g, rois, links=[links], max_walk=4096,
                          checkpoint=path, device="cpu")
    assert got == host_linked
    assert len(seen) == 2 * -(-rois.num_records // 16)   # started over
    assert not (tmp_path / "partition.ckpt").exists()


def test_native_checkpoint_is_tagged_and_resumed(monkeypatch, tmp_path, case):
    if not tcore.nat.available():
        pytest.skip("needs the native core")
    g, rois, links, host_linked, _ = case
    monkeypatch.setattr(tcore, "CHUNK", 16)
    path = str(tmp_path / "partition.ckpt")
    real = tcore.nat.LinksWalkerNative
    calls = []
    stop_at = [4]

    class Walker(real):
        def walk(self, seeds, max_walk):
            if len(calls) == stop_at[0]:
                raise _Stop
            calls.append(len(seeds))
            return super().walk(seeds, max_walk)
    monkeypatch.setattr(tcore.nat, "LinksWalkerNative", Walker)
    with pytest.raises(_Stop):
        tcore.partition(g, rois, links=[links], max_walk=4096, checkpoint=path)
    saved = ckpt.load_chunk_state(path, ckpt.graph_fingerprint(g))
    assert saved[0] == 32 and saved[1]["mode"] == "native_links"
    calls.clear()
    stop_at[0] = 10 ** 6
    got = tcore.partition(g, rois, links=[links], max_walk=4096, checkpoint=path)
    assert got == host_linked
    assert len(calls) == 2 * (-(-rois.num_records // 16) - 2)   # resumed
    assert not (tmp_path / "partition.ckpt").exists()
