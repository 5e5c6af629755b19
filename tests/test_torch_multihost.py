"""The hash-sharded graph across processes (torch.distributed, gloo on the
CPU): corticall_tpu_torch/tools/dryrun_multihost.py's two workers on a
global mesh of eight shards against the JAX package's dry run's oracles on
the same fixture (tools/dryrun_multihost.py's _fixture: the host numpy
walker, FindROIs and the JAX LinkedWalker) and against the port's
in-process ShardMesh(["cpu"] * 8); the byte-range load against
ShardedGraph.from_graph; the mesh's shard cap; and the weak-scaling sweep
at one and two shards.  Each launch has its own worker timeout (at most
300 s)."""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from corticall_tpu_torch import graph as gr, kmer as km  # noqa: E402
from corticall_tpu_torch.io import ctx as ctxio, links as lkio  # noqa: E402
from corticall_tpu_torch.ops import sharding as sh  # noqa: E402
from corticall_tpu_torch.parallel import mesh as pm  # noqa: E402
from corticall_tpu_torch.tools import dryrun_multihost as dm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_dryrun_fixture(workdir):
    """The JAX package's dry run's fixture and oracles
    (tools/dryrun_multihost.py::_fixture), written to `workdir`."""
    pytest.importorskip("jax")
    path = os.path.join(REPO, "tools", "dryrun_multihost.py")
    spec = importlib.util.spec_from_file_location("jax_dryrun_multihost", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._fixture(str(workdir))


def test_two_process_dryrun_matches_jax_and_the_in_process_mesh(tmp_path):
    """Two gloo processes, eight global shards: every owned shard equals
    from_graph's; the contigs, the ROI set and the linked walks are the JAX
    package's dry-run oracles' bit for bit, and the in-process mesh's."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = dm.dryrun(2, 8, "cpu", str(tmp_path / "port"))
    assert got["ok"] and got["processes"] == 2 and got["global_shards"] == 8
    assert got["backend"] == "gloo" and got["devices"] == ["cpu", "cpu"]
    assert got["shards_identical"]
    assert sum(got["owned_records"]) == sum(got["per_process_byte_range_records"])
    assert got["exchange_bytes"] > 0

    want = _jax_dryrun_fixture(tmp_path / "jax")
    assert got["contigs"] == want["contigs"] and len(got["contigs"]) == dm.SEED_COUNT
    assert got["roi_kmers"] == want["rois"] and got["roi_kmers"]
    assert got["linked"] == want["linked"]
    assert got["link_junctions"] == want["linked_junctions"] > 0
    # the JAX fixture's .ctx is the port's, byte for byte
    assert (tmp_path / "port" / "mh_graph.ctx").read_bytes() == \
        (tmp_path / "jax" / "mh_graph.ctx").read_bytes()

    g = gr.CortexGraph(ctxio.read_ctx(str(tmp_path / "port" / "mh_graph.ctx")))
    links = lkio.open_links(str(tmp_path / "port" / "mh_links.ctp.bgz"))
    mesh = pm.ShardMesh(["cpu"] * 8)
    sg = pm.ShardedGraph.from_graph(g, mesh)
    seeds = list(got["contigs"])
    assert pm.sharded_assemble(mesh, sg, [0], seeds, dm.NUM_STEPS) == got["contigs"]
    words = pm.sharded_find_rois_kmers(mesh, sg, 0, [1, 2])
    rois = sorted(km.words_row_to_string(row, dm.K) for row in words)
    assert rois == got["roi_kmers"]
    sl = pm.ShardedLinks.from_graph(g, [links], sg)
    linked, overflow, junctions = pm.sharded_assemble_links(mesh, sg, sl, [0], rois,
                                                            dm.NUM_STEPS)
    assert linked == got["linked"] and not overflow.any()
    assert int(junctions.sum()) == got["link_junctions"]


def test_a_failing_worker_fails_the_run(tmp_path):
    """A worker that raises (its .ctx is missing) fails run_workers with
    the worker's error, and no worker is left running."""
    spec = {"ctx": str(tmp_path / "missing.ctx"), "links": [], "shards": 2,
            "out": str(tmp_path / "out.npz")}
    with pytest.raises(RuntimeError, match=r"worker \d failed"):
        dm.run_workers(spec, 2, "cpu", str(tmp_path), timeout=120)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_group():
    """A gloo group of this process alone, destroyed after the test."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    backend = pm.init_process_mesh(0, 1, f"tcp://localhost:{_free_port()}", "cpu")
    assert backend == "gloo"
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("shards", [sh.MAX_SHARDS + 1, 0])
def test_a_mesh_past_max_shards_raises(shards):
    with pytest.raises(ValueError, match="MAX_SHARDS"):
        pm.ShardMesh.across(shards, "cpu")


def test_the_process_mesh_holds_its_ranks_shards(one_rank_group):
    mesh = pm.ShardMesh.across(sh.MAX_SHARDS, "cpu")
    assert mesh.size == sh.MAX_SHARDS and mesh.local == sh.MAX_SHARDS
    assert mesh.shards == list(range(sh.MAX_SHARDS)) and mesh.backend == "gloo"
    assert mesh.rank == 0 and mesh.world == 1 and "gloo" in repr(mesh)
    with pytest.raises(ValueError, match="MAX_SHARDS"):
        pm.ShardMesh.across(sh.MAX_SHARDS + 1, "cpu")


def test_backend_choice():
    assert pm.choose_backend("cpu", 2) == "gloo"
    # two ranks on a host without two cards cannot share one under NCCL
    if torch.cuda.device_count() < 2:
        assert pm.choose_backend("cuda", 2) == "gloo"


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_byte_range_load_of_one_rank_equals_from_graph(tmp_path, one_rank_group, shards):
    """ShardedGraph.from_ctx_range on a one-rank group (the whole file as
    its range, the exchange to itself) equals from_graph's shards."""
    spec, _ = dm.fixture(str(tmp_path), shards, "cpu")
    g = gr.CortexGraph(ctxio.read_ctx(spec["ctx"]))
    mesh = pm.ShardMesh.across(shards, "cpu")
    got = pm.ShardedGraph.from_ctx_range(spec["ctx"], mesh)
    assert dm._same_shards(got, pm.ShardedGraph.from_graph(g, pm.ShardMesh(["cpu"] * shards)))
    assert mesh.stats["collectives"] == 3


def test_byte_range_load_in_one_process_equals_from_graph(tmp_path):
    """On a mesh of one process (no group) from_ctx_range reads the whole
    file and equals from_graph."""
    spec, _ = dm.fixture(str(tmp_path), 4, "cpu")
    g = gr.CortexGraph(ctxio.read_ctx(spec["ctx"]))
    mesh = pm.ShardMesh(["cpu"] * 4)
    assert dm._same_shards(pm.ShardedGraph.from_ctx_range(spec["ctx"], mesh),
                           pm.ShardedGraph.from_graph(g, mesh))


def test_weak_scaling_at_one_and_two_shards(tmp_path):
    """corticall_tpu_torch/tools/weak_scaling.py on the CPU at one and two
    shards (a fresh process group each), small sizes: a row a point, the
    genome and batch growing with the shards, efficiency 1 at one shard."""
    out = tmp_path / "ws.json"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "corticall_tpu_torch", "tools", "weak_scaling.py"),
         str(out), "--device", "cpu", "--shards", "1,2", "--bases-per-shard", "5000",
         "--batch-per-shard", "64", "--steps", "32", "--repeats", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-4000:]
    data = json.loads(out.read_text())
    rows = data["rows"]
    assert [r["shards"] for r in rows] == [1, 2] and [r["processes"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0 and rows[1]["efficiency"] > 0
    assert rows[1]["batch"] == 2 * rows[0]["batch"] and rows[1]["records"] > rows[0]["records"]
    assert all(r["walk_steps"] > 0 and r["backend"] == "gloo" for r in rows)
