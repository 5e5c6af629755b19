"""The port's device graph build (corticall_tpu_torch/ops/build_device.py)
against corticall_tpu/ops/build_device.py and the host counting oracle
(build.count_kmers): keys, coverage and edge masks bit for bit, on the cases
of tests/test_build_device.py and at k = 16, 32, 48, where the top word is
full.  Then the route through build_graph_from_reads and the pipeline
(CORTICALL_DEVICE_BUILD=1).  The CUDA kernels against the plain twins run
only on a card.  Everything is integer: every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import build as bd, kmer as km  # noqa: E402
from corticall_tpu_torch import build as tbd  # noqa: E402
from corticall_tpu_torch.ops import build_device as tbdv, kmer as tk  # noqa: E402
from test_torch_pipeline import ARTIFACTS, K, make_trio  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_bdv():
    pytest.importorskip("jax")
    from corticall_tpu.ops import build_device
    return build_device


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _check(sequences, k, chunk_bases=1 << 14):
    """The port's twin route against the host count and the JAX package's
    device count."""
    want = bd.count_kmers(sequences, k)
    got = tbdv.count_kmers_device(sequences, k, chunk_bases=chunk_bases, device="cpu")
    jax_got = _jax_bdv().count_kmers_device(sequences, k, chunk_bases=chunk_bases)
    for name, a, b, c in zip(("keys", "coverage", "in", "out"), got, want, jax_got):
        assert a.dtype == b.dtype == np.asarray(c).dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=name)
    return got


def _short_reads(seed=7, n=20000, count=600, length=150):
    rng = np.random.default_rng(seed)
    genome = _genome(rng, n)
    return [genome[i:i + length] for i in rng.integers(0, n - length, size=count)]


@pytest.mark.parametrize("k", [21, 31, 47])
def test_count_short_reads(k):
    _check(_short_reads(), k)


def test_count_multichunk_boundaries():
    """Reads spanning many flush boundaries: chunk joins must not create or
    lose windows (separator-aligned cuts)."""
    rng = np.random.default_rng(11)
    genome = _genome(rng, 30000)
    reads = [genome[i:i + 150] for i in rng.integers(0, 30000 - 150, size=1500)]
    _check(reads, 31, chunk_bases=1 << 12)


@pytest.mark.parametrize("k,chunk", [(31, 1 << 12), (47, 1 << 13)])
def test_count_long_sequence_pieces(k, chunk):
    """A sequence longer than a chunk: overlapping pieces with explicit
    window ownership, every window counted once, edge masks seeing the true
    neighbours through the overlap."""
    rng = np.random.default_rng(13)
    _check([_genome(rng, 40000)], k, chunk_bases=chunk)


def test_count_handles_n_bases():
    rng = np.random.default_rng(17)
    g = list(_genome(rng, 5000))
    for pos in rng.integers(50, 4950, size=25):
        g[pos] = "N"
    seq = "".join(g)
    _check([seq[i:i + 200] for i in range(0, 4800, 90)], 21)


def test_count_duplicate_and_revcomp_reads():
    """Coverage accumulates across chunks; forward and reverse-complement
    reads hit the same canonical records."""
    rng = np.random.default_rng(19)
    genome = _genome(rng, 3000)
    reads = [genome[i:i + 100] for i in range(0, 2900, 40)]
    reads += [km.revcomp(r) for r in reads]
    reads += reads
    _check(reads, 31, chunk_bases=1 << 12)


@pytest.mark.parametrize("k", [16, 32, 48])
def test_count_full_top_word(k):
    """At k = 16, 32, 48 the top word is full, so a canonical k-mer's top
    word can be all ones (T^16 A^16 is its own reverse complement): only a
    whole row of ones is the invalid windows' key.  Poly-T and poly-A reads
    give the all-A k-mer, never the all-T key."""
    reads = _short_reads(seed=k, n=6000, count=200)
    reads += ["T" * 16 + "A" * 16 + "C" * 40, "T" * 80, "A" * 80, "G" * 20 + "T" * 60]
    keys = _check(reads + [km.revcomp(r) for r in reads[:50]], k, chunk_bases=1 << 12)[0]
    assert (keys == 0).all(axis=1).any()                        # all-A
    assert not (keys == 0xFFFFFFFF).all(axis=1).any()
    if k == 32:
        assert (keys[:, 0] == 0xFFFFFFFF).any()


def test_pack_helpers_match_jax():
    jbdv = _jax_bdv()
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 1001).astype(np.uint8)
    np.testing.assert_array_equal(tbdv.pack_stream(codes), jbdv.pack_stream(codes))
    bits = rng.random(1001) < 0.5
    np.testing.assert_array_equal(tbdv.pack_bits(bits), jbdv._pack_bits(bits))


@pytest.mark.parametrize("k", [21, 32, 47])
def test_windows_twin_matches_jax_extract_windows(k):
    """windows_plain on a piece's n bases equals _extract_windows on the
    stream padded to the chunk (its keys, and its masks as in << 4 | out),
    with N bases, ownership gaps and windows at the piece's end."""
    import jax.numpy as jnp
    jbdv = _jax_bdv()
    rng = np.random.default_rng(100 + k)
    seq = list(_genome(rng, 3000))
    for pos in rng.integers(0, 3000, size=12):
        seq[pos] = "N"
    seq = "".join(seq)
    own = rng.random(3000) < 0.9
    c = 1 << 12
    stream, valid, own_w, n = tbdv.pack_piece(seq, own, c)
    keys, masks = tbdv.windows_plain(*(tk.words_tensor(a, "cpu") for a in (stream, valid, own_w)),
                                     k, n)
    codes = km.string_to_codes_permissive(seq)
    pad = c - n
    jk, jc, ji, jo = jbdv._extract_windows(
        jnp.asarray(jbdv.pack_stream(np.concatenate([np.minimum(codes, 3).astype(np.uint8),
                                                     np.zeros(pad, np.uint8)]))),
        jnp.asarray(jbdv._pack_bits(np.concatenate([codes <= 3, np.zeros(pad, bool)]))),
        jnp.asarray(jbdv._pack_bits(np.concatenate([own, np.zeros(pad, bool)]))), k, c)
    np.testing.assert_array_equal(keys.numpy().view(np.uint32), np.asarray(jk)[:n])
    np.testing.assert_array_equal(masks.numpy(), (np.asarray(ji)[:n] << 4) | np.asarray(jo)[:n])
    assert (np.asarray(jc)[:n] == (keys != -1).any(1).numpy()).all()
    assert not np.asarray(jc)[n:].any()


def test_sort_order_is_the_unsigned_word_order():
    """Rows with the sign bit set in any word sort as uint32 words, the order
    of the host's big-endian byte keys."""
    rng = np.random.default_rng(5)
    for w in (1, 2, 3, 4):
        words = rng.integers(0, 2 ** 32, size=(4000, w), dtype=np.uint64).astype(np.uint32)
        words[::7, 0] = words[1::7, 0][:len(words[::7])]                # equal top words
        words[::11] = words[5]                                           # equal rows
        order = tbdv.sort_order(torch.from_numpy(words.view(np.int32))).numpy()
        raw = words.byteswap().view(f"|S{4 * w}").ravel()              # big-endian keys
        np.testing.assert_array_equal(raw[order], np.sort(raw))


def test_reduce_twin_matches_jax_sort_reduce():
    """Sort + segment reduction against _sort_reduce, with coverage sums
    that wrap past 2^32 as uint32 sums do."""
    import jax.numpy as jnp
    jbdv = _jax_bdv()
    rng = np.random.default_rng(9)
    m, w = 3000, 3
    keys = rng.integers(0, 40, size=(m, w)).astype(np.uint32) * np.uint32(0x0A000001)
    cov = rng.integers(2 ** 31, 2 ** 32, size=m, dtype=np.uint64).astype(np.uint32)
    masks = rng.integers(0, 256, size=m).astype(np.uint8)
    got = tbdv.sort_reduce(torch.from_numpy(keys.view(np.int32)),
                           torch.from_numpy(cov.view(np.int32)), torch.from_numpy(masks))
    uk, uc, ui, uo, nu = jbdv._sort_reduce(jnp.asarray(keys), jnp.asarray(cov),
                                           jnp.asarray(masks >> 4, dtype=jnp.uint32),
                                           jnp.asarray(masks & 15, dtype=jnp.uint32), w)
    nu = int(nu)
    assert got[0].shape == (nu, w)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), np.asarray(uk)[:nu])
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), np.asarray(uc)[:nu])
    np.testing.assert_array_equal(got[2].numpy(), (np.asarray(ui)[:nu] << 4) | np.asarray(uo)[:nu])


def _run_rows(runs, w, rng, big_cov=False):
    """Sorted rows made of runs of the given lengths (distinct keys in
    increasing unsigned order, sign bits set in some words), coverage near
    2^32 when `big_cov`, random masks."""
    keys = np.sort(rng.choice(2 ** 32, size=(len(runs), w), replace=False).astype(np.uint32),
                   axis=0)
    keys[:, 0] = np.sort(rng.choice(2 ** 32, size=len(runs), replace=False)).astype(np.uint32)
    rows = np.repeat(keys, runs, axis=0)
    m = len(rows)
    lo = 2 ** 32 - 2 ** 20 if big_cov else 0
    hi = 2 ** 32 if big_cov else 50
    cov = rng.integers(lo, hi, size=m, dtype=np.uint64).astype(np.uint32)
    return rows, cov, rng.integers(0, 256, m).astype(np.uint8)


TILE = 8
REDUCE_CASES = {
    "crosses-one-boundary": [3, 7, 2, 1, 5],          # the 7 spans rows 3-9 across row 8
    "longer-than-tiles": [2, 41, 1, 30, 4],           # runs of 5 and 4 tiles
    "one-key": [77],
    "distinct": [1] * 37,
    "one-row": [1],
    "ragged": [1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 1],    # 59 rows: not a multiple of 8
    "wraps": [13, 1, 26, 2],                          # sums past 2^32
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_reduce_tiles_model_matches_twin_and_jax(case):
    """ctk_segment_reduce's tile decomposition (reduce_tiles_plain at 8-row
    tiles: heads and tails, aggregates, look-back in tile order, reversed
    and shuffled) equals reduce_plain and the JAX package's _sort_reduce:
    keys, uint32 coverage sums that wrap, ORed masks, the unique count."""
    import jax.numpy as jnp
    jbdv = _jax_bdv()
    rng = np.random.default_rng(len(case))
    w = 3
    keys, cov, masks = _run_rows(REDUCE_CASES[case], w, rng, big_cov=case == "wraps")
    if case == "wraps":
        assert (cov.astype(np.uint64).sum() >> 32) > 0
    kt, ct, mt = (torch.from_numpy(keys.view(np.int32)), torch.from_numpy(cov.view(np.int32)),
                  torch.from_numpy(masks))
    want = tbdv.reduce_plain(kt, ct, mt)
    uk, uc, ui, uo, nu = jbdv._sort_reduce(jnp.asarray(keys), jnp.asarray(cov),
                                           jnp.asarray(masks >> 4, dtype=jnp.uint32),
                                           jnp.asarray(masks & 15, dtype=jnp.uint32), w)
    nu = int(nu)
    assert nu == len(REDUCE_CASES[case]) == want[0].shape[0]
    np.testing.assert_array_equal(want[0].numpy().view(np.uint32), np.asarray(uk)[:nu])
    np.testing.assert_array_equal(want[1].numpy().view(np.uint32), np.asarray(uc)[:nu])
    np.testing.assert_array_equal(want[2].numpy(), (np.asarray(ui)[:nu] << 4) | np.asarray(uo)[:nu])
    tiles = -(-len(keys) // TILE)
    for order in (None, list(reversed(range(tiles))), rng.permutation(tiles).tolist()):
        got = tbdv.reduce_tiles_plain(kt, ct, mt, TILE, order)
        for name, a, b in zip(("keys", "coverage", "masks"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, order)


def test_reduce_scratch_grows_and_wraps_its_epochs(monkeypatch):
    """The look-back scratch stays between launches: a new epoch each, a
    zeroed, larger buffer when more tiles are needed, and the statuses
    zeroed when the epochs run out."""
    monkeypatch.setattr(tbdv, "_REDUCE_SCRATCH", {})
    cpu = torch.device("cpu")
    scratch, tiles, epoch = tbdv.reduce_scratch(cpu, 5000)
    assert tiles == 3 and scratch.numel() == 8 and epoch == 1 and not scratch.any()
    again, tiles, epoch = tbdv.reduce_scratch(cpu, 100)
    assert again is scratch and tiles == 3 and epoch == 2
    scratch.fill_(7)
    grown, tiles, epoch = tbdv.reduce_scratch(cpu, 20000)
    assert tiles == 10 and grown.numel() == 22 and epoch == 1 and not grown.any()
    tbdv._REDUCE_SCRATCH[cpu][1] = tbdv.EPOCH_LIMIT - 1
    grown.fill_(7)
    same, _, epoch = tbdv.reduce_scratch(cpu, 100)
    assert same is grown and epoch == 1 and not same.any()


def test_build_graph_from_reads_device_matches_jax():
    reads = _short_reads(seed=23, n=8000, count=400, length=120)
    want = bd.build_graph_from_reads(reads, 31, "s", use_device=False)
    got = tbd.build_graph_from_reads(reads, 31, "s", use_device=True, device="cpu")
    assert got.num_records == want.num_records
    for name in ("kmers", "coverages", "edges"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_build_graph_from_reads_routes(monkeypatch):
    """use_device=None reads CORTICALL_DEVICE_BUILD; the device route runs
    the invariant fence with source "device"; the native and numpy routes
    never read `device`."""
    reads = _short_reads(seed=29, n=4000, count=150)
    calls = []
    real = tbdv.count_kmers_device

    def counted(seqs, k, **kw):
        calls.append(kw)
        return real(seqs, k, **kw)

    monkeypatch.setattr(tbdv, "count_kmers_device", counted)
    native = tbd.build_graph_from_reads(reads, 21, "s", device="no such device")
    assert calls == []
    monkeypatch.setenv("CORTICALL_DEVICE_BUILD", "1")
    dev = tbd.build_graph_from_reads(reads, 21, "s", device="cpu")
    assert calls == [{"device": "cpu"}]
    np.testing.assert_array_equal(dev.kmers, native.kmers)
    np.testing.assert_array_equal(dev.edges, native.edges)

    def lossy(seqs, k, **kw):
        kmers, cov, i, o = real(seqs, k, **kw)
        return kmers[1:], cov[1:], i[1:], o[1:]

    monkeypatch.setattr(tbdv, "count_kmers_device", lossy)
    with pytest.raises(RuntimeError, match=r"conservation violated \(device\)"):
        tbd.build_graph_from_reads(reads, 21, "s", device="cpu")


def test_device_build_needs_a_device_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reads = _short_reads(seed=31, n=2000, count=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbdv.count_kmers_device(reads, 21)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbd.build_graph_from_reads(reads, 21, "s", use_device=True)
    tbd.build_graph_from_reads(reads, 21, "s", use_device=False)   # native: no device


def test_pipeline_device_build_env(tmp_path, monkeypatch):
    """CORTICALL_DEVICE_BUILD=1 takes the port's pipeline through the device
    count (on the pipeline's device) and writes the default run's bytes."""
    from corticall_tpu_torch.pipeline import run_pipeline
    reads, refs = make_trio()
    opts = dict(k=K, min_coverage=2, device="cpu", resume=False)
    run_pipeline(str(tmp_path / "native"), reads, "kid", ["mom", "dad"], references=refs, **opts)
    calls = []
    real = tbdv.count_kmers_device

    def counted(seqs, k, **kw):
        calls.append(kw["device"])
        return real(seqs, k, **kw)

    monkeypatch.setattr(tbdv, "count_kmers_device", counted)
    monkeypatch.setenv("CORTICALL_DEVICE_BUILD", "1")
    run_pipeline(str(tmp_path / "device"), reads, "kid", ["mom", "dad"], references=refs, **opts)
    assert calls == [torch.device("cpu")] * 3                  # kid, mom, dad
    for name in ARTIFACTS + ("kid.clean.ctx", "joined.ctx"):
        assert (tmp_path / "device" / name).read_bytes() == \
            (tmp_path / "native" / name).read_bytes(), name


def test_wrappers_validate_and_run_the_twins_on_cpu():
    before = dict(tbdv.LAUNCHES)
    stream, valid, own, n = tbdv.pack_piece("ACGTTGCA" * 10, None, 1 << 10)
    st, vt, ot = (tk.words_tensor(a, "cpu") for a in (stream, valid, own))
    keys, masks = tbdv.extract_windows(st, vt, ot, 21, n)
    assert keys.shape == (80, 2) and keys.dtype == torch.int32 and masks.dtype == torch.uint8
    with pytest.raises(TypeError):
        tbdv.extract_windows(st.long(), vt, ot, 21, n)
    with pytest.raises(ValueError):
        tbdv.extract_windows(st, vt, ot, 21, 10 ** 4)
    with pytest.raises(ValueError):
        tbdv.extract_windows(st, vt, ot, 64, n)
    cov = torch.ones(keys.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError):
        tbdv.segment_reduce(keys, cov.long(), masks)
    with pytest.raises(ValueError):
        tbdv.segment_reduce(keys.long(), cov, masks)
    with pytest.raises(ValueError, match="piece exceeds"):
        tbdv.pack_piece("A" * 100, None, 64)
    assert tbdv.LAUNCHES == before                     # no kernel on the CPU
    empty = tbdv.count_kmers_device(["ACG"], 21, device="cpu")
    assert empty[0].shape == (0, 2) and all(len(x) == 0 for x in empty[1:])


# ---------------------------------------------------------------------------
# kernels against the plain twins (card only)
# ---------------------------------------------------------------------------

def _piece(rng, k, n=5000, with_own=True):
    seq = list(_genome(rng, n))
    for pos in rng.integers(0, n, size=20):
        seq[pos] = "N"
    seq = "".join(seq) + "T" * 16 + "A" * 16 + "N" * k + "A" * 40
    own = rng.random(len(seq)) < 0.95 if with_own else None
    return tbdv.pack_piece(seq, own, 1 << 14)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 21, 31, 32, 47, 48, 63])
def test_windows_kernel_matches_twin_on_card(cuda, k):
    """Launched into poison-filled buffers, every window's key and masks
    equal the twin's, at the piece's end too; nothing past n is written."""
    rng = np.random.default_rng(k)
    stream, valid, own, n = _piece(rng, k)
    st, vt, ot = (tk.words_tensor(a, cuda) for a in (stream, valid, own))
    w = tk.words(k)
    keys = torch.full((n + 40, w), 0x5A5A5A5A, dtype=torch.int32, device=cuda)
    masks = torch.full((n + 40,), 0x5A, dtype=torch.uint8, device=cuda)
    before = tbdv.LAUNCHES["count_windows"]
    tbdv.windows_kernel(st, vt, ot, k, n, keys[:n], masks[:n])
    torch.cuda.synchronize()
    assert tbdv.LAUNCHES["count_windows"] == before + 1
    want = tbdv.windows_plain(st, vt, ot, k, n)
    assert torch.equal(keys[:n], want[0]) and torch.equal(masks[:n], want[1])
    assert (keys[n:] == 0x5A5A5A5A).all() and (masks[n:] == 0x5A).all()
    got = tbdv.extract_windows(st, vt, ot, k, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _sorted_rows_for_card(rng, k, rows, shape):
    """Rows for the reduce kernel (uint32 keys [m, W], coverage, masks):
    "random" draws rows from rows // 5 keys; "one-run" puts a run of 100,000
    rows of one key among 20,000 others; "merge" is a merge's input, every
    key twice (an accumulator row and a chunk's) with coverage near 2^32 and
    a few keys once; "big" draws 2^20 + 7 rows."""
    w = tk.words(k)
    if shape == "one-run":
        others = rng.integers(0, 2 ** 32, size=(20000, w), dtype=np.uint64)
        keys = np.concatenate([others, np.repeat(others[:1] ^ np.uint64(0x55), 100000, axis=0)])
    elif shape == "merge":
        distinct = rng.integers(0, 2 ** 32, size=(rows, w), dtype=np.uint64)
        keys = np.concatenate([distinct, distinct[: rows - rows // 10]])
    else:
        rows = (1 << 20) + 7 if shape == "big" else rows
        distinct = rng.integers(0, 2 ** 32, size=(max(rows // 5, 1), w), dtype=np.uint64)
        keys = distinct[rng.integers(0, len(distinct), rows)]
    m = len(keys)
    lo = 2 ** 31 if shape == "merge" else 0
    cov = rng.integers(lo, 2 ** 32, m, dtype=np.uint64).astype(np.uint32)
    return keys.astype(np.uint32), cov, rng.integers(0, 256, m).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows,shape", [(21, 1, "random"), (31, 257, "random"),
                                          (47, 30000, "random"), (63, 5000, "random"),
                                          (47, 0, "one-run"), (31, 0, "one-run"),
                                          (47, 400000, "merge"), (63, 100000, "merge"),
                                          (47, 0, "big"), (21, 0, "big")])
def test_reduce_kernel_matches_twin_on_card(cuda, k, rows, shape):
    """Runs of equal sorted rows, coverage sums that wrap, masks ORed; the
    unique rows written in order into poison-filled buffers, by two launches
    back to back (the second reads the look-back words the first left)."""
    rng = np.random.default_rng(rows + k)
    keys, cov, masks = _sorted_rows_for_card(rng, k, rows, shape)
    kd = torch.from_numpy(keys.view(np.int32)).to(cuda)
    cov = torch.from_numpy(cov.view(np.int32)).to(cuda)
    masks = torch.from_numpy(masks).to(cuda)
    order = tbdv.sort_order(kd)
    kd, cov, masks = kd[order], cov[order], masks[order]
    runs = []
    for _ in range(2):
        out = (torch.full_like(kd, 0x5A5A5A5A), torch.full_like(cov, 0x5A5A5A5A),
               torch.full_like(masks, 0x5A))
        count = torch.full((1,), -7, dtype=torch.int32, device=cuda)
        before = tbdv.LAUNCHES["segment_reduce"]
        tbdv.reduce_kernel(kd, cov, masks, *out, count)
        assert tbdv.LAUNCHES["segment_reduce"] == before + 1
        runs.append((out, count))
    torch.cuda.synchronize()
    want = tbdv.reduce_plain(kd, cov, masks)
    for out, count in runs:
        n = int(count.item())
        assert n == want[0].shape[0]
        for a, b in zip(out, want):
            assert torch.equal(a[:n], b)
        assert (out[0][n:] == 0x5A5A5A5A).all() and (out[1][n:] == 0x5A5A5A5A).all()
        assert (out[2][n:] == 0x5A).all()
    got = tbdv.segment_reduce(kd, cov, masks)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if kd.shape[0] > 1:              # views one row in: copied to 16-byte boundaries
        got = tbdv.segment_reduce(kd[1:], cov[1:], masks[1:])
        for a, b in zip(got, tbdv.reduce_plain(kd[1:], cov[1:], masks[1:])):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,chunk", [(21, 1 << 12), (31, 1 << 14), (47, 1 << 13), (63, 1 << 12)])
def test_count_on_card_matches_host_without_any_twin(cuda, monkeypatch, k, chunk):
    """The whole device count on the card, with chunk boundaries and long
    pieces, equals the host count; the card path never reaches a twin."""
    rng = np.random.default_rng(k)
    genome = _genome(rng, 30000)
    reads = [genome[i:i + 150] for i in rng.integers(0, 30000 - 150, size=800)]
    reads.append(genome[:20000])
    want = bd.count_kmers(reads, k)

    def refuse(*a, **kw):
        raise AssertionError("a twin ran on the card")

    monkeypatch.setattr(tbdv, "windows_plain", refuse)
    monkeypatch.setattr(tbdv, "reduce_plain", refuse)
    before = dict(tbdv.LAUNCHES)
    got = tbdv.count_kmers_device(reads, k, chunk_bases=chunk, device=cuda)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tbdv.LAUNCHES["count_windows"] > before["count_windows"]
    assert tbdv.LAUNCHES["segment_reduce"] > before["segment_reduce"] + 1     # chunks + merges
