"""The port stands alone: no module of corticall_tpu_torch/, nor
chip_smoke.py, imports the JAX package, jax, bench or demo_pf_cross (at top
level or inside a function), and the small trio pipeline runs in a process
where both jax and corticall_tpu fail to import."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("corticall_tpu", "jax", "bench", "demo_pf_cross")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "corticall_tpu_torch")):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    """(line, absolute module name) of every import in the file; relative
    imports stay inside their package and are skipped."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_sources_found():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("corticall_tpu_torch", "caller", "call.py") in names
    assert os.path.join("corticall_tpu_torch", "native.py") in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imported(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_trio_pipeline_runs_without_jax_and_corticall_tpu(tmp_path):
    """tests/test_torch_pipeline.py's trio through the port's pipeline, with
    Partition's linked jump-table route forced, in a fresh process in which
    `import jax` and `import corticall_tpu` both fail."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["corticall_tpu"] = None
sys.path.insert(0, {REPO!r})
sys.path.insert(0, {os.path.join(REPO, "tests")!r})
from test_torch_pipeline import make_trio
from corticall_tpu_torch.commands import core
from corticall_tpu_torch.pipeline import run_pipeline
core.NATIVE_LINK_THRESHOLD = -1
reads, refs = make_trio()
out = run_pipeline({str(tmp_path / "wd")!r}, reads, child="kid", parents=["mom", "dad"],
                   references=refs, k=21, min_coverage=2, device="cpu")
assert out["stats"]["partition"]["walk_kernel"] == "jump_table"
assert out["variants"], "no calls"
assert not any(m == "jax" or m.startswith(("jax.", "corticall_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("calls", len(out["variants"]))
"""
    env = {**os.environ, "CORTICALL_TPU_TESTS_ON_TPU": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("calls ")
