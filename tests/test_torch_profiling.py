"""The port's trace hook (corticall_tpu_torch/utils/profiling.torch_trace),
the counterpart of corticall_tpu/utils/profiling.jax_trace: a traced region
writes one Chrome trace that parses and names what ran inside it; None traces
nothing.  On a card the trace holds the Tesserae kernel's launch."""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from corticall_tpu_torch.utils.profiling import torch_trace  # noqa: E402


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_names_the_ops_run_inside(tmp_path):
    a = torch.ones(16, 16)
    torch.mm(a, a)                       # outside: not traced
    with torch_trace(str(tmp_path / "trace")) as prof:
        torch.mm(a, a).sum()
    names = {e.get("name") for e in _events(str(tmp_path / "trace"))}
    assert "aten::mm" in names and "aten::sum" in names
    assert any(row.key == "aten::mm" for row in prof.key_averages())


def test_trace_of_none_writes_nothing(tmp_path):
    with torch_trace(None) as prof:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_trace_is_written_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError):
        with torch_trace(str(tmp_path / "trace")):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert any(e.get("name") == "aten::sum" for e in _events(str(tmp_path / "trace")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_holds_the_tesserae_kernel_on_card(cuda, tmp_path):
    """A ctk_tesserae launch inside the region: the trace holds the CUDA
    kernel it launched (the device function's name, tesserae_kernel) with a
    duration, and the runtime call that launched it."""
    from corticall_tpu_torch.ops import tesserae_torch as tt
    args = tt.section_inputs("ACGTACGGTCA" * 8, ["ACGTACGGTCA" * 7, "ACGTTCGGTCA" * 9],
                             (0.35, 0.90, 6e-4, 1e-3), cuda)
    tt.tesserae_fused(*args)                 # the kernels' build, outside the trace
    torch.cuda.synchronize()
    with torch_trace(str(tmp_path / "trace")):
        tt.tesserae_fused(*args)
    events = _events(str(tmp_path / "trace"))
    kernels = [e for e in events if e.get("cat") == "kernel" and "tesserae_kernel" in e["name"]]
    assert kernels and all(e["dur"] > 0 for e in kernels)
    assert any("LaunchKernel" in e.get("name", "") for e in events
               if e.get("cat") == "cuda_runtime")
