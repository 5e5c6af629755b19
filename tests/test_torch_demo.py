"""The port's flagship demo (corticall_tpu_torch/demo.py) against the JAX
package's (demo_pf_cross.py) on the CPU, at a small cross: the same simulated
trio, every JSON key but the stage seconds equal and the PF_DUMP detail
byte-identical, in the reads mode (run_reads_pipeline) and the haplotype mode
(run_haplotype_flow); and the port's main in a process where jax and the JAX
package cannot be imported."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import demo_pf_cross as ref  # noqa: E402
from corticall_tpu import simulate as ref_sim  # noqa: E402
from corticall_tpu_torch import demo  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PF_MBP, PF_CHROMS, PF_DNMS, PF_K, PF_DIVERGENCE of the small cross
MBP, CHROMS, DNMS, K, DIVERGENCE = 0.15, 2, 4, 47, 0.003
COVERAGE, READ_LEN, ERR = 20.0, 150, 0.002


def _jax_cross():
    """demo_pf_cross.main's simulation, seeds 42 and 7."""
    import numpy as np
    mom, dad = ref.make_cross(np.random.default_rng(42), MBP, CHROMS, DIVERGENCE)
    res = ref_sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"), mu=2.0,
                                         num_variants=DNMS, k=K, seed=7)
    return mom, dad, res


def _same_cross(theirs, ours):
    (jm, jd, jres), (pm, pd, pres) = theirs, ours
    assert (jm, jd) == (pm, pd)
    assert jres["child"] == pres["child"]
    assert [str(v) for v in jres["truth_vcf"]] == [str(v) for v in pres["truth_vcf"]]


def _without_seconds(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "stages"}


def _run(fn, dump, monkeypatch, *args, **kwargs):
    monkeypatch.setenv("PF_DUMP", str(dump))
    stages = {}
    out = fn(*args, stages, **kwargs)
    return out, stages, dump.read_bytes()


@pytest.fixture(scope="module")
def crosses():
    theirs, ours = _jax_cross(), demo.simulate_cross(MBP, CHROMS, DNMS, K, DIVERGENCE)
    _same_cross(theirs, ours)
    return theirs, ours


def test_reads_pipeline_matches_jax(crosses, tmp_path, monkeypatch):
    (jm, jd, jres), (pm, pd, pres) = crosses
    want, want_stages, want_dump = _run(
        ref.run_reads_pipeline, tmp_path / "ref.json", monkeypatch, jres, jm, jd,
        jres["truth_vcf"], K, COVERAGE, READ_LEN, ERR, str(tmp_path / "ref"))
    got, got_stages, got_dump = _run(
        demo.run_reads_pipeline, tmp_path / "port.json", monkeypatch, pres, pm, pd,
        pres["truth_vcf"], K, COVERAGE, READ_LEN, ERR, str(tmp_path / "port"), device="cpu")
    assert _without_seconds(got) == _without_seconds(want)
    assert set(got["stages"]) == set(want["stages"])
    assert set(got_stages) == set(want_stages) == {"simulate_reads_s"}
    assert got_dump == want_dump
    assert got["calls"] > 0 and got["kmer_venn"]["tp"] > 0
    assert got["partition_links"]["walk_kernel"] == "native_links"


def test_haplotype_flow_matches_jax(crosses, tmp_path, monkeypatch):
    (jm, jd, jres), (pm, pd, pres) = crosses
    want, want_stages, want_dump = _run(
        ref.run_haplotype_flow, tmp_path / "ref.json", monkeypatch, jres, jm, jd,
        jres["truth_vcf"], K)
    got, got_stages, got_dump = _run(
        demo.run_haplotype_flow, tmp_path / "port.json", monkeypatch, pres, pm, pd,
        pres["truth_vcf"], K, device="cpu")
    assert got == want
    assert set(got_stages) == set(want_stages)
    assert got_dump == want_dump
    assert got["calls"] > 0


def test_main_runs_without_jax(tmp_path):
    """demo.main with a tiny PF_* environment in a fresh process where `import
    jax` and `import corticall_tpu` fail: one JSON line with the JAX demo's
    keys, and the dump written.  Without a card, `python -m
    corticall_tpu_torch.demo` refuses to run."""
    env = {**os.environ, "PF_MBP": "0.05", "PF_CHROMS": "1", "PF_DNMS": "2",
           "PF_WORKDIR": str(tmp_path / "wd"), "PF_DUMP": str(tmp_path / "detail.json")}
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["corticall_tpu"] = None
sys.path.insert(0, {REPO!r})
from corticall_tpu_torch import demo
demo.main(device="cpu")
assert not any(m == "jax" or m.startswith(("jax.", "corticall_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["genome_mbp"] == 0.05 and out["k"] == 47 and out["colors"] == 3
    assert out["injected_dnms"] == 2 and out["mode"] == "reads+links+prefilters"
    assert {"simulate_s", "simulate_reads_s", "call"} <= set(out["stages"])
    assert json.loads((tmp_path / "detail.json").read_text())["truth"]
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "corticall_tpu_torch.demo"],
                              capture_output=True, text=True, timeout=300, env=env,
                              cwd=REPO)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
        assert not proc.stdout.strip()
