"""The port's device rule (corticall_tpu_torch/device.py): an entry point
given no device runs on the CUDA card and raises RuntimeError when none is
visible; only an explicit "cpu" runs the plain twins.  The card is hidden by
monkeypatching torch.cuda.is_available, so these cases run the same with or
without one.  Partition's routes are held to the rule in
test_torch_partition.py."""

import types

import pytest

torch = pytest.importorskip("torch")

from corticall_tpu_torch import device as tdev  # noqa: E402
from corticall_tpu_torch.caller.call import Caller  # noqa: E402
from corticall_tpu_torch.models import contig_aligner as tca  # noqa: E402
from corticall_tpu_torch.models.reference_index import IndexedReference  # noqa: E402
from corticall_tpu_torch.models.tesserae import Tesserae  # noqa: E402
from corticall_tpu_torch.ops import tesserae_torch as tt  # noqa: E402
from corticall_tpu_torch.pipeline import run_pipeline  # noqa: E402
from test_torch_aligner import _repeat_case, _summary  # noqa: E402

NO_CUDA = "no CUDA device is available"
GRAPH = types.SimpleNamespace(kmer_size=21)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_needs_the_card_unless_asked_for_the_cpu(no_card):
    with pytest.raises(RuntimeError, match=NO_CUDA):
        tdev.resolve(None)
    with pytest.raises(RuntimeError, match=NO_CUDA):
        tdev.require_cuda()
    assert tdev.resolve("cpu") == torch.device("cpu")
    assert tdev.resolve(torch.device("cpu")) == torch.device("cpu")
    assert not hasattr(tdev, "default_device")


@pytest.mark.parametrize("entry", [
    lambda tmp: run_pipeline(str(tmp / "wd"), {}, "kid", ["mom", "dad"]),
    lambda tmp: Caller(None, None, [], ["mom", "dad"]),
    lambda tmp: tt.TesseraeDevice(),
    lambda tmp: tca.align_contigs({"q": "ACGT" * 20}, {}),
], ids=["run_pipeline", "Caller", "TesseraeDevice", "align_contigs"])
def test_entry_point_without_device_raises(no_card, tmp_path, entry):
    with pytest.raises(RuntimeError, match=NO_CUDA):
        entry(tmp_path)
    assert not (tmp_path / "wd").exists()        # raised before any work


def test_caller_on_cpu_takes_the_twins(no_card):
    assert isinstance(Caller(GRAPH, None, [], ["mom"], device="cpu").ma, Tesserae)
    ma = Caller(GRAPH, None, [], ["mom"], tesserae="device", device="cpu").ma
    assert isinstance(ma, tt.TesseraeDevice) and ma.device == torch.device("cpu")


def test_tesserae_device_on_cpu_runs_the_twin(no_card):
    query = "ACGTTGCAAGGCTTACGATCGGATCCATGCA"
    targets = {"a": query[:20] + "T" + query[21:], "b": query[::-1]}
    dev = tt.TesseraeDevice(device="cpu")
    host = Tesserae()
    assert dev.align(query, targets) == host.align(query, targets)
    assert dev.device_sections == 1 and dev.host_sections == 0


def test_align_contigs_on_cpu_and_host_only(no_card):
    """device="cpu" pre-scores on the plain twin; use_device=False is a
    host-only route and does not need a device at all."""
    queries, seqs, band = _repeat_case()
    ir = IndexedReference(seqs)
    stats = {}
    got = tca.align_contigs(queries, {"mom": ir}, band=band, stats=stats,
                            device="cpu", use_device=True)
    assert stats["device_scored_windows"] >= tca.MIN_DEVICE_BATCH
    host_stats = {}
    host = tca.align_contigs(queries, {"mom": ir}, band=band, stats=host_stats,
                             use_device=False)
    assert host_stats["device_scored_windows"] == 0
    assert _summary(host) == _summary(tca.align_contigs(
        queries, {"mom": ir}, band=band, device="cpu"))
    assert set(got) == set(host)
