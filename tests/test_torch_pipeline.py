"""The port's linked pipeline (corticall_tpu_torch/pipeline.py) against the
JAX package's, with every device route forced on both sides, and the port
run in a process where jax cannot be imported."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import simulate as sim  # noqa: E402
from corticall_tpu.models.reference_index import IndexedReference  # noqa: E402
from corticall_tpu_torch.models import contig_aligner as tca  # noqa: E402
from corticall_tpu_torch.pipeline import run_pipeline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 21
ARTIFACTS = ("partitions.fa", "calls.vcf", "accounting.txt", "calls.filtered.vcf")


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def make_trio():
    """tests/test_pipeline.py's trio (a 10 bp de novo insertion, a 60 bp
    repeat for links), with a repeat copy of the insertion's locus added to
    the parental references as chr2: each target then has two candidate
    placements, so label_targets sends windows to the SW pre-score."""
    rng = np.random.default_rng(41)
    rep = _genome(rng, 60)
    parent = (_genome(rng, 1200) + rep + _genome(rng, 1400) + rep
              + _genome(rng, 1300))
    pos = 2000
    ins = "TGACGTAGGC"
    child = parent[:pos] + ins + parent[pos:]
    reads = {
        "kid": sim.simulate_reads([child], coverage=40, read_length=150,
                                  error_rate=0.002, seed=1),
        "mom": sim.simulate_reads([parent], coverage=40, read_length=150,
                                  error_rate=0.002, seed=2),
        "dad": sim.simulate_reads([parent], coverage=40, read_length=150,
                                  error_rate=0.002, seed=3),
    }
    seqs = {"chr1": parent, "chr2": parent[1500:2700]}
    refs = {"mom": IndexedReference(seqs), "dad": IndexedReference(seqs)}
    return reads, refs


@pytest.fixture(scope="module")
def trio():
    return make_trio()


def test_pipeline_matches_jax_with_device_routes(tmp_path, monkeypatch, trio):
    pytest.importorskip("jax")
    from corticall_tpu.models import contig_aligner as jca
    from corticall_tpu.pipeline import run_pipeline as jax_run_pipeline
    reads, refs = trio
    monkeypatch.setattr(jca, "_device_ok", lambda: True)
    monkeypatch.setattr(jca, "MIN_DEVICE_BATCH", 1)
    # smaller pad shape for the interpret-mode Pallas kernel; the trio's
    # windows fit it, so the same batches go to the device on both sides
    monkeypatch.setattr(jca, "DEV_Q", 1024)
    monkeypatch.setattr(jca, "DEV_S", 1536)
    monkeypatch.setattr(tca, "_device_ok", lambda device: True)
    monkeypatch.setattr(tca, "MIN_DEVICE_BATCH", 1)
    opts = dict(references=refs, k=K, min_coverage=2,
                caller_opts={"tesserae": "device"})
    want = jax_run_pipeline(str(tmp_path / "jax"), reads, "kid", ["mom", "dad"],
                            **opts)
    got = run_pipeline(str(tmp_path / "torch"), reads, "kid", ["mom", "dad"],
                       device="cpu", **opts)
    for name in ARTIFACTS:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    want_al = want["stats"]["call"]["contig_aligner"]
    got_al = got["stats"]["call"]["contig_aligner"]
    assert got_al == want_al
    assert got_al["device_scored_windows"] > 0
    assert got["stats"]["call"]["tesserae"]["device_sections"] > 0
    assert "device:tesserae_compile" in got["stats"]["call"]["call_breakdown"]
    assert len(got["variants"]) > 0


def test_pipeline_matches_jax_with_linked_partition_on_device(tmp_path,
                                                             monkeypatch, trio):
    """Partition's linked jump-table route forced in both packages."""
    pytest.importorskip("jax")
    from corticall_tpu.commands import core as jcore
    from corticall_tpu.pipeline import run_pipeline as jax_run_pipeline
    from corticall_tpu_torch.commands import core as tcore
    reads, refs = trio
    monkeypatch.setattr(jcore, "_NATIVE_LINK_THRESHOLD", -1)
    monkeypatch.setattr(tcore, "NATIVE_LINK_THRESHOLD", -1)
    opts = dict(references=refs, k=K, min_coverage=2)
    want = jax_run_pipeline(str(tmp_path / "jax"), reads, "kid", ["mom", "dad"],
                            **opts)
    got = run_pipeline(str(tmp_path / "torch"), reads, "kid", ["mom", "dad"],
                       device="cpu", **opts)
    for name in ARTIFACTS:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    got_p, want_p = got["stats"]["partition"], want["stats"]["partition"]
    assert got_p["walk_kernel"] == want_p["walk_kernel"] == "jump_table"
    for key in ("link_replays", "device_steps", "link_junctions_resolved",
                "partitions"):
        assert got_p[key] == want_p[key], key
    assert len(got["variants"]) > 0


def test_port_runs_without_jax(tmp_path):
    """Every module of the port imports, and the pipeline runs, in a process
    where `import jax` fails."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        import corticall_tpu_torch
        for m in pkgutil.walk_packages(corticall_tpu_torch.__path__,
                                       "corticall_tpu_torch."):
            importlib.import_module(m.name)
        from test_torch_pipeline import make_trio
        from corticall_tpu_torch.pipeline import run_pipeline
        reads, refs = make_trio()
        res = run_pipeline({str(tmp_path / "wd")!r}, reads, "kid", ["mom", "dad"],
                           references=refs, k={K}, device="cpu",
                           caller_opts={{"tesserae": "device"}})
        assert res["variants"], "no calls"
        assert not any(n == "jax" or n.startswith("jax.")
                       for n, m in sys.modules.items() if m is not None)
        print("OK", len(res["variants"]))
    """)
    env = {**os.environ, "CORTICALL_TPU_TESTS_ON_TPU": "1"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")
