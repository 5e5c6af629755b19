"""Port's banded and full-matrix SW (corticall_tpu_torch/ops/sw_device.py)
against the JAX package's scan twin and Pallas kernels (sw_banded_pallas,
sw_pallas, banded_sw_pallas), and its CUDA kernels against the plain twins.
Every value is a multiple of 0.5, so all comparisons are bit-exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu_torch.ops import sw_device as tsw  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_sw():
    pytest.importorskip("jax")
    from corticall_tpu.ops import sw_device
    return sw_device


def _mutated_pairs(rng, batch, qlen, slen, ragged=True):
    """Random subject windows and queries copied from them with substitutions
    and indels; ragged lengths padded with 4, plus an all-pad row."""
    q = np.full((batch, qlen), 4, np.int32)
    s = np.full((batch, slen), 4, np.int32)
    for b in range(batch):
        sl = int(rng.integers(slen // 2, slen + 1)) if ragged else slen
        subj = rng.integers(0, 4, sl).astype(np.int32)
        off = int(rng.integers(0, max(1, sl - qlen // 2)))
        qq = subj[off:off + qlen].copy()
        mut = rng.random(len(qq)) < 0.05
        qq[mut] = (qq[mut] + rng.integers(1, 4, mut.sum())) % 4
        if len(qq) > 20 and b % 3 == 1:        # deletion from the query
            p = int(rng.integers(5, len(qq) - 10))
            qq = np.concatenate([qq[:p], qq[p + 6:]])
        elif len(qq) > 20 and b % 3 == 2:      # insertion into the query
            p = int(rng.integers(5, len(qq) - 10))
            qq = np.concatenate([qq[:p], rng.integers(0, 4, 5), qq[p:]])[:qlen]
        ql = int(rng.integers(qlen // 2, qlen + 1)) if ragged else qlen
        qq = qq[:ql]
        q[b, :len(qq)] = qq
        s[b, :sl] = subj
    q[-1] = 4                                  # all-pad query: zero result
    return q, s


def _tandem_pairs(rng, batch, qlen, slen):
    """Tie-heavy windows: query and subject cut from one tandem repeat of a
    2-7 base unit, so one best value recurs on several rows and cells;
    ragged ends, a substitution in every fourth query, an all-pad query."""
    q = np.full((batch, qlen), 4, np.int32)
    s = np.full((batch, slen), 4, np.int32)
    for b in range(batch):
        unit = rng.integers(0, 4, int(rng.integers(2, 8)))
        rep = np.tile(unit, (qlen + slen) // len(unit) + 2)
        ql = int(rng.integers(qlen // 2, qlen + 1))
        sl = int(rng.integers(slen // 2, slen + 1))
        off = int(rng.integers(0, len(unit)))
        q[b, :ql] = rep[off:off + ql]
        s[b, :sl] = rep[:sl]
        if b % 4 == 3:
            p = int(rng.integers(0, ql))
            q[b, p] = (q[b, p] + 1) % 4
    q[-1] = 4
    return q, s


# the main path's batches on the 2 Mbp trio (B, Q, S after _round8), band 512
MAIN_SHAPES = [(8, 248, 376), (32, 80, 208), (64, 80, 208), (8, 336, 464)]


def _bits(x):
    """int32 view of float32 outputs (bit-exact compare), as numpy."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_codes_batch_matches_jax():
    swd = _jax_sw()
    strings = ["ACGTN", "acgt", "", "GGGGGGGGGGG"]
    np.testing.assert_array_equal(tsw.codes_batch(strings, 8),
                                  swd.codes_batch(strings, 8))


@pytest.mark.parametrize("band", [64, 128])
def test_plain_matches_jax_scan_and_pallas(band):
    swd = _jax_sw()
    from test_sw_device import _cases
    rng = np.random.default_rng(201)
    qs, ss = _cases(rng, 13)
    qc = swd.codes_batch(qs, max(map(len, qs)))
    sc = swd.codes_batch(ss, max(map(len, ss)))
    got = tsw.banded_sw_scores(torch.from_numpy(qc), torch.from_numpy(sc), band)
    _assert_same(got, swd.banded_sw_scores(qc, sc, band=band))
    _assert_same(got, swd.sw_banded_pallas(qc, sc, band=band, interpret=True))


@pytest.mark.parametrize("band", [64, 128])
def test_plain_matches_jax_ragged_and_all_pad(band):
    swd = _jax_sw()
    rng = np.random.default_rng(202)
    q, s = _mutated_pairs(rng, 12, 90, 130)
    got = tsw.banded_sw_scores(torch.from_numpy(q), torch.from_numpy(s), band)
    assert float(got[0][-1]) == 0 and int(got[1][-1]) == 0 and int(got[2][-1]) == 0
    _assert_same(got, swd.banded_sw_scores(q, s, band=band))
    _assert_same(got, swd.sw_banded_pallas(q, s, band=band, interpret=True))


@pytest.mark.parametrize("shape", MAIN_SHAPES[:2], ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("pairs", [_mutated_pairs, _tandem_pairs],
                         ids=["mutated", "tandem"])
def test_plain_matches_jax_at_main_path_shapes(shape, pairs):
    """Band 512 over subjects narrower than the band, as on the main path."""
    swd = _jax_sw()
    batch, qlen, slen = shape
    q, s = pairs(np.random.default_rng(210 + batch), batch, qlen, slen)
    got = tsw.banded_sw_scores(torch.from_numpy(q), torch.from_numpy(s), 512)
    assert float(got[0][-1]) == 0 and int(got[1][-1]) == 0 and int(got[2][-1]) == 0
    assert (got[0][:-1] > 0).all()
    _assert_same(got, swd.banded_sw_scores(q, s, band=512))
    _assert_same(got, swd.sw_banded_pallas(q, s, band=512, interpret=True))


def test_sw_kernel_config_picks_and_limits():
    cfg = tsw.sw_kernel_config
    assert cfg(336, 464, 512) == 16        # slots = the subject
    assert cfg(80, 208, 512) == 8
    assert cfg(248, 376, 512) == 12
    assert cfg(4096, 8192, 512) == 16      # slots = the band
    assert cfg(512, 1024, 64) == 2
    assert cfg(700, 1500, 1024) == 32
    assert cfg(10, 0, 8) == 1
    assert cfg(100, 40, 8) == 1
    for qlen, slen, band in [(80, 208, 1032), (80, 208, 60), (80, 208, 0),
                             (tsw.MAX_Q + 1, 208, 64), (80, tsw.MAX_S + 1, 64),
                             (-1, 208, 64)]:
        with pytest.raises(ValueError):
            cfg(qlen, slen, band)
    for slen, band in ((208, 512), (8192, 512), (2000, 1024), (300, 8)):
        cells = cfg(80, slen, band)
        smaller = [c for c in tsw.SW_CELLS if c < cells]
        assert 32 * cells >= min(band, slen)
        assert not smaller or 32 * smaller[-1] < min(band, slen)


def test_wrapper_refuses_shapes_beyond_the_kernel():
    """The wrapper checks the kernel's limits before it runs either side,
    so a CPU call refuses what a CUDA call would."""
    q = torch.full((1, tsw.MAX_Q + 1), 4, dtype=torch.int32)
    s = torch.full((1, 64), 4, dtype=torch.int32)
    before = tsw.LAUNCHES
    with pytest.raises(ValueError, match="qlen"):
        tsw.sw_banded(q, s, 64)
    with pytest.raises(ValueError, match="qlen"):
        tsw.banded_sw_pallas(q, s, 64)
    assert tsw.LAUNCHES == before


def test_padding_with_n_leaves_scores_unchanged():
    rng = np.random.default_rng(203)
    q, s = _mutated_pairs(rng, 10, 70, 100)
    want = tsw.banded_sw_scores(torch.from_numpy(q), torch.from_numpy(s), 64)
    qp = np.pad(q, ((0, 0), (0, 26)), constant_values=4)
    sp = np.pad(s, ((0, 0), (0, 45)), constant_values=4)
    got = tsw.banded_sw_scores(torch.from_numpy(qp), torch.from_numpy(sp), 64)
    _assert_same(got, want)


def test_wrapper_on_cpu_runs_plain_twin_and_validates():
    rng = np.random.default_rng(204)
    q, s = _mutated_pairs(rng, 6, 40, 60)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    before = tsw.LAUNCHES
    _assert_same(tsw.sw_banded(qt, st, 64), tsw.banded_sw_scores(qt, st, 64))
    assert tsw.LAUNCHES == before
    with pytest.raises(ValueError):
        tsw.sw_banded(qt, st, 60)
    with pytest.raises(TypeError):
        tsw.sw_banded(qt.long(), st, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,qlen,slen,band", [
    (24, 300, 420, 64), (9, 250, 400, 512), (5, 100, 130, 24),
    *[(b, q, s, 512) for b, q, s in MAIN_SHAPES],    # the main path's batches
    (16, 200, 300, 8), (6, 700, 1500, 1024),         # the narrowest and widest band
    (1, 300, 420, 64), (1, 336, 464, 512),           # a single window
    (2, 3000, 2200, 512),                            # slots slide, then pin right
    (4, 9, 300, 512), (6, 40, 64, 64),               # fewer rows than lanes; S == band
    (2, 2500, 300, 512)])                            # rows past one 2048-row key chunk
def test_kernel_matches_plain_on_card(cuda, batch, qlen, slen, band):
    rng = np.random.default_rng(205 + band)
    q, s = _mutated_pairs(rng, batch, qlen, slen)
    qt, st = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    before = tsw.LAUNCHES
    got = tsw.sw_banded(qt, st, band)
    torch.cuda.synchronize()
    assert tsw.LAUNCHES == before + 1
    _assert_same(got, tsw.banded_sw_scores(qt, st, band))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,qlen,slen,band", [(8, 248, 376, 512), (32, 80, 208, 512),
                                                  (12, 160, 700, 64), (7, 90, 60, 8)])
def test_kernel_matches_plain_on_tandem_repeats(cuda, batch, qlen, slen, band):
    q, s = _tandem_pairs(np.random.default_rng(212 + band), batch, qlen, slen)
    qt, st = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    _assert_same(tsw.sw_banded(qt, st, band), tsw.banded_sw_scores(qt, st, band))


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [32, 16, 12, 24])
def test_kernel_with_forced_config_on_card(cuda, monkeypatch, cells):
    """More cells a lane than the slots need (idle slots at the warp's end)
    on an odd batch."""
    q, s = _mutated_pairs(np.random.default_rng(213), 13, 336, 376)
    qt, st = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    monkeypatch.setattr(tsw, "sw_kernel_config", lambda qlen, slen, band: cells)
    for band in (512, 256):
        _assert_same(tsw.sw_banded(qt, st, band), tsw.banded_sw_scores(qt, st, band))


# ---------------------------------------------------------------------------
# the full-matrix / band-masked contract (sw_pallas) and banded_sw_pallas
# ---------------------------------------------------------------------------

def _sw_device_cases():
    """tests/test_sw_device.py's cases: Gotoh-checked pairs (SNPs, indels)
    and the random junk pairs whose best paths drift off the diagonal."""
    from test_sw_device import _cases
    swd = _jax_sw()
    qs, ss = _cases(np.random.default_rng(105), 24)
    out = [(swd.codes_batch(qs, max(map(len, qs))),
            swd.codes_batch(ss, max(map(len, ss))))]
    rng = np.random.default_rng(106)
    qn = rng.integers(0, 4, (64, 96)).astype(np.int32)
    sn = rng.integers(0, 4, (64, 120)).astype(np.int32)
    for i in range(0, 64, 2):
        sn[i, :96] = qn[i]
    out.append((qn, sn))
    out.append(_mutated_pairs(np.random.default_rng(107), 13, 90, 130))
    return out


@pytest.mark.parametrize("band", [None, 64])
def test_full_plain_matches_jax_sw_pallas(band):
    swd = _jax_sw()
    for q, s in _sw_device_cases():
        got = tsw.sw_full_scores(torch.from_numpy(q), torch.from_numpy(s), band)
        _assert_same(got, swd.sw_pallas(q, s, band=band, interpret=True))


def test_full_plain_band_masked_matches_banded_twin():
    # with a band the masked full matrix scores the banded twin's cells
    for q, s in _sw_device_cases()[1:]:
        qt, st = torch.from_numpy(q), torch.from_numpy(s)
        _assert_same(tsw.sw_full_scores(qt, st, 64), tsw.banded_sw_scores(qt, st, 64))


def test_banded_sw_pallas_matches_jax():
    swd = _jax_sw()
    from test_sw_device import _cases
    qs, ss = _cases(np.random.default_rng(102), 13)
    q = swd.codes_batch(qs, max(map(len, qs)))
    s = swd.codes_batch(ss, max(map(len, ss)))
    got = tsw.banded_sw_pallas(torch.from_numpy(q), torch.from_numpy(s), 128)
    _assert_same(got, swd.banded_sw_pallas(q, s, band=128, interpret=True))


def test_full_wrapper_on_cpu_runs_plain_twin_and_validates():
    rng = np.random.default_rng(208)
    q, s = _mutated_pairs(rng, 6, 40, 60)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    before = tsw.FULL_LAUNCHES
    _assert_same(tsw.sw_full(qt, st), tsw.sw_full_scores(qt, st))
    _assert_same(tsw.sw_full(qt, st, 24), tsw.sw_full_scores(qt, st, 24))
    assert tsw.FULL_LAUNCHES == before
    with pytest.raises(ValueError):
        tsw.sw_full(qt, st, 0)
    with pytest.raises(ValueError):
        tsw.sw_full(qt, torch.full((6, tsw.MAX_FULL_S + 1), 4, dtype=torch.int32))
    with pytest.raises(TypeError):
        tsw.sw_full(qt.long(), st)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,qlen,slen,band", [(24, 300, 420, None),
                                                  (24, 300, 420, 64),
                                                  (5, 100, 4500, None),
                                                  (4, 60, 8192, 256),
                                                  (7, 40, 30, None)])
def test_full_kernel_matches_plain_on_card(cuda, batch, qlen, slen, band):
    rng = np.random.default_rng(209 + slen)
    q, s = _mutated_pairs(rng, batch, qlen, slen)
    qt, st = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    before = tsw.FULL_LAUNCHES
    got = tsw.sw_full(qt, st, band)
    torch.cuda.synchronize()
    assert tsw.FULL_LAUNCHES == before + 1
    _assert_same(got, tsw.sw_full_scores(qt, st, band))
