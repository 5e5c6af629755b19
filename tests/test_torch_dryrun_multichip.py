"""The port's multi-shard dry run (corticall_tpu_torch/tools/dryrun_multichip.py,
the counterpart of __graft_entry__.dryrun_multichip) at 4 and 8 shards of
the CPU, in a fresh process: every sharded path must equal the single-device
port, and without a card and without --cpu it must refuse to run."""

import json
import os
import subprocess
import sys

import pytest

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "corticall_tpu_torch", "tools", "dryrun_multichip.py")


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_shards(n, tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, TOOL, "--shards", str(n), "--cpu"],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["dryrun_multichip"] == n and out["devices"] == ["cpu"] * n
    assert len(out["shard_records"]) == n and out["vcf_identical"] and out["calls"] > 0
    assert out["contigs"] == out["rois"] > 0 and out["linked_junctions"] > 0
    assert "walk_steps_per_s" not in out          # a rate is measured on cards only


def test_dryrun_multichip_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    code = ("import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = [{TOOL!r}, '--shards', '2']; runpy.run_path({TOOL!r}, run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
