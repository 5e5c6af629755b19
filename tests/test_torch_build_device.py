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
    codes = km.string_to_codes_permissive(seq)
    n = len(codes)
    packed = (tbdv.pack_stream(np.minimum(codes, 3)), tbdv.pack_bits(codes <= 3),
              tbdv.pack_bits(own))
    keys, masks = tbdv.windows_plain(*(tk.words_tensor(a, "cpu") for a in packed), k, n)
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


IUPAC_AND_OTHER = b"NnRYKMSWBDHVrykmswbdhv-.*0 \x00\x80\xff"


def _messy_bytes(rng, n, odd=0.015):
    """n bytes from a seed: upper- and lower-case bases, with `odd` of them
    N or n, IUPAC letters or other bytes, and 60 valid bases at the end."""
    b = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, n)]
    other = rng.random(n) < odd
    other[-60:] = False
    b[other] = np.frombuffer(IUPAC_AND_OTHER, np.uint8)[
        rng.integers(0, len(IUPAC_AND_OTHER), int(other.sum()))]
    return b.tobytes()


def _jax_live_windows(data, own_lo, own_hi, k, c=1 << 13):
    """The JAX package's path for a piece: its host packing (pack_stream and
    _pack_bits of string_to_codes_permissive, padded to the chunk) through
    _extract_windows, the invalid (sentinel) rows dropped: (keys uint32,
    masks in << 4 | out)."""
    import jax.numpy as jnp
    jbdv = _jax_bdv()
    codes = km.string_to_codes_permissive(data)
    n = len(codes)
    own = np.zeros(c, bool)
    own[own_lo:own_hi] = True
    pad = c - n
    jk, jc, ji, jo = jbdv._extract_windows(
        jnp.asarray(jbdv.pack_stream(np.concatenate([np.minimum(codes, 3).astype(np.uint8),
                                                     np.zeros(pad, np.uint8)]))),
        jnp.asarray(jbdv._pack_bits(np.concatenate([codes <= 3, np.zeros(pad, bool)]))),
        jnp.asarray(jbdv._pack_bits(own)), k, c)
    live = np.asarray(jc) != 0
    assert not live[n:].any()
    return np.asarray(jk)[live], (np.asarray(ji)[live] << 4) | np.asarray(jo)[live]


@pytest.mark.parametrize("k", [21, 32, 47])
def test_count_windows_twin_matches_jax(k):
    """count_windows on a piece's bytes (CPU: the twin) equals the JAX
    package's host packing and _extract_windows with the sentinel rows
    dropped, row for row in stream order: upper- and lower-case bases, N and
    n, IUPAC letters and other bytes, windows at the piece's end, owned
    windows from inside the piece to inside it and to its end."""
    rng = np.random.default_rng(200 + k)
    data = _messy_bytes(rng, 5000)
    bases = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    for own_lo, own_hi in ((37, 4900), (1, 5000), (0, 5000)):
        keys, masks = tbdv.count_windows(bases, own_lo, own_hi, k)
        want_keys, want_masks = _jax_live_windows(data, own_lo, own_hi, k)
        assert keys.shape == (len(want_keys), tk.words(k)) and len(want_keys) > 100
        np.testing.assert_array_equal(keys.numpy().view(np.uint32), want_keys)
        np.testing.assert_array_equal(masks.numpy(), want_masks)
    ends_at_n = tbdv.count_windows(bases, 0, 5000, k)[0]
    assert torch.equal(ends_at_n[-1], tbdv.count_windows(bases, 5000 - k, 5000, k)[0][0])


def test_device_count_packs_nothing_on_the_host(monkeypatch):
    """count_kmers_device on the CPU equals build.count_kmers with the host
    packers refused: the JAX package's codes (string_to_codes_permissive)
    never, pack_stream and pack_bits only inside the twin that stands in for
    ctk_count_windows."""
    reads = _short_reads(seed=41, n=6000, count=300)
    reads.append(_genome(np.random.default_rng(43), 9000))       # pieces of a long sequence
    inside = [0]

    def refuse(*a, **kw):
        raise AssertionError("a numpy packer ran on the device route")

    def only_in_twin(fn):
        def run(*a, **kw):
            if not inside[0]:
                refuse()
            return fn(*a, **kw)
        return run

    def twin(*a, **kw):
        inside[0] += 1
        try:
            return real_twin(*a, **kw)
        finally:
            inside[0] -= 1

    real_twin = tbdv.count_windows_plain
    monkeypatch.setattr(tbdv.km, "string_to_codes_permissive", refuse)
    monkeypatch.setattr(tbdv, "pack_stream", only_in_twin(tbdv.pack_stream))
    monkeypatch.setattr(tbdv, "pack_bits", only_in_twin(tbdv.pack_bits))
    monkeypatch.setattr(tbdv, "count_windows_plain", twin)
    got = tbdv.count_kmers_device(reads, 31, chunk_bases=1 << 12, device="cpu")
    monkeypatch.undo()
    for a, b in zip(got, bd.count_kmers(reads, 31)):
        np.testing.assert_array_equal(a, b)


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
    bases = torch.from_numpy(np.frombuffer(b"ACGTTGCA" * 10, np.uint8).copy())
    keys, masks = tbdv.count_windows(bases, 0, 80, 21)
    assert keys.shape == (60, 2) and keys.dtype == torch.int32 and masks.dtype == torch.uint8
    with pytest.raises(TypeError):
        tbdv.count_windows(bases.to(torch.int32), 0, 80, 21)
    with pytest.raises(TypeError):
        tbdv.count_windows(bases.reshape(8, 10), 0, 80, 21)
    with pytest.raises(ValueError, match="contiguous"):
        tbdv.count_windows(bases[::2], 0, 40, 21)
    for lo, hi in ((-1, 80), (10, 9), (0, 81)):
        with pytest.raises(ValueError, match="owned windows"):
            tbdv.count_windows(bases, lo, hi, 21)
    for k in (0, 64):
        with pytest.raises(ValueError, match="outside 1..63"):
            tbdv.count_windows(bases, 0, 80, k)
    with pytest.raises(ValueError, match="unsupported device"):
        tbdv.count_windows(torch.empty(80, dtype=torch.uint8, device="meta"), 0, 80, 21)
    assert tbdv.count_windows(bases[:20], 0, 20, 21)[0].shape == (0, 2)   # shorter than k
    cov = torch.ones(keys.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError):
        tbdv.segment_reduce(keys, cov.long(), masks)
    with pytest.raises(ValueError):
        tbdv.segment_reduce(keys.long(), cov, masks)
    with pytest.raises(ValueError, match="piece exceeds"):
        tbdv.DeviceCounter(21, 64, "cpu")._count_piece(b"A" * 100)
    assert tbdv.LAUNCHES == before                     # no kernel on the CPU
    empty = tbdv.count_kmers_device(["ACG"], 21, device="cpu")
    assert empty[0].shape == (0, 2) and all(len(x) == 0 for x in empty[1:])


def test_count_scratch_is_the_counts_own():
    """ctk_count_windows' look-back scratch is its own (one status word a
    tile of 4,096 windows), apart from ctk_segment_reduce's, with epochs of
    its own."""
    cpu = torch.device("cpu")
    saved = tbdv._COUNT_SCRATCH.pop(cpu, None), tbdv._REDUCE_SCRATCH.pop(cpu, None)
    try:
        scratch, tiles, epoch = tbdv.count_scratch(cpu, 3 * 4096 + 1)
        assert tiles == 4 and scratch.numel() == 6 and epoch == 1 and not scratch.any()
        rs, _, repoch = tbdv.reduce_scratch(cpu, 100)
        assert rs is not scratch and repoch == 1
        assert tbdv.count_scratch(cpu, 100)[2] == 2 and tbdv.reduce_scratch(cpu, 100)[2] == 2
    finally:
        for table, entry in zip((tbdv._COUNT_SCRATCH, tbdv._REDUCE_SCRATCH), saved):
            table.pop(cpu, None)
            if entry is not None:
                table[cpu] = entry


# ---------------------------------------------------------------------------
# kernels against the plain twins (card only)
# ---------------------------------------------------------------------------

def _card_pieces(rng, k):
    """(name, bytes, own_lo, own_hi) of the pieces the card tests hold the
    count kernel to: mixed bytes with owned windows inside, every byte value
    between runs of bases, all invalid, all valid, n not a multiple of 16, n
    below one tile, n below k, and n over many tiles."""
    mixed = _messy_bytes(rng, 5000) + b"T" * 16 + b"A" * 16 + b"N" * k + b"A" * 40
    every = b"".join(_genome(rng, int(rng.integers(k, k + 30))).encode() + bytes([v])
                     for v in range(256))
    return [("mixed", mixed, 29, len(mixed) - 33), ("mixed, all owned", mixed, 0, len(mixed)),
            ("every byte value", every, 0, len(every)),
            ("all invalid", b"N" * 4000 + b"n" * 1000, 0, 5000),
            ("all valid", _genome(rng, 9000).encode(), 0, 9000),
            ("ragged", _messy_bytes(rng, 4099), 1, 4099),
            ("below a tile", _messy_bytes(rng, 100), 0, 100),
            ("below k", b"ACGTA" * (k // 5), 0, 5 * (k // 5)),
            ("many tiles", _messy_bytes(rng, 200_003, odd=0.004), 7, 199_990)]


def _count_into_poison(cuda, data, own_lo, own_hi, k, offset=0):
    """One count_kernel launch on the piece's bytes (a view `offset` bytes
    into its buffer, copied to 16-byte alignment) into poison-filled
    buffers: (keys, masks, count tensor, room)."""
    buf = torch.from_numpy(np.frombuffer(b"x" * offset + data, np.uint8).copy()).to(cuda)
    bases = tbdv.aligned(buf[offset:])
    room = max(0, min(own_hi, len(data) - k + 1) - own_lo)
    keys = torch.full((room + 40, tk.words(k)), 0x5A5A5A5A, dtype=torch.int32, device=cuda)
    masks = torch.full((room + 40,), 0x5A, dtype=torch.uint8, device=cuda)
    count = torch.full((1,), -7, dtype=torch.int32, device=cuda)
    tbdv.count_kernel(bases, own_lo, own_hi, k, keys, masks, count)
    return keys, masks, count, room


def _held_to_twin(cuda, got, data, own_lo, own_hi, k, what):
    keys, masks, count, room = got
    bases = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    want = tbdv.count_windows_plain(bases, own_lo, own_hi, k)
    m = int(count.item())
    assert m == want[0].shape[0] <= room, what
    assert torch.equal(keys[:m], want[0]) and torch.equal(masks[:m], want[1]), what
    assert (keys[m:] == 0x5A5A5A5A).all() and (masks[m:] == 0x5A).all(), what   # nothing past m
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 21, 31, 32, 47, 48, 63])
def test_windows_kernel_matches_twin_on_card(cuda, k):
    """Launched into poison-filled buffers, ctk_count_windows writes the
    twin's rows in stream order and its count, and no row past the count,
    on every piece of _card_pieces (and one a byte off its alignment);
    then after its scratch's epochs wrap, with a ctk_segment_reduce launch
    between two counts on one stream, and through count_windows."""
    rng = np.random.default_rng(k)
    pieces = _card_pieces(rng, k)
    before = tbdv.LAUNCHES["count_windows"]
    for name, data, lo, hi in pieces:
        m = _held_to_twin(cuda, _count_into_poison(cuda, data, lo, hi, k), data, lo, hi, k, name)
        assert (m == 0) == (name in ("all invalid", "below k")), name
    name, data, lo, hi = pieces[0]
    _held_to_twin(cuda, _count_into_poison(cuda, data, lo, hi, k, offset=1), data, lo, hi, k,
                  "a byte off")
    assert tbdv.LAUNCHES["count_windows"] == before + len(pieces) + 1

    dev = torch.device("cuda", torch.cuda.current_device())        # the tensors' device
    tbdv._COUNT_SCRATCH[dev][1] = tbdv.EPOCH_LIMIT - 2
    name, data, lo, hi = pieces[-1]
    runs = []
    for i in range(4):                                              # epochs L - 1, 1, 2, 3
        runs.append(_count_into_poison(cuda, data, lo, hi, k))
        if i == 1:
            kd, cov, mk = runs[-1][0][:1000], torch.ones(1000, dtype=torch.int32, device=cuda), \
                runs[-1][1][:1000]
            order = tbdv.sort_order(kd)
            tbdv.segment_reduce(kd[order], cov, mk[order])
    assert tbdv._COUNT_SCRATCH[dev][1] == 3
    for got in runs:
        _held_to_twin(cuda, got, data, lo, hi, k, "epochs wrapped")
    got = tbdv.count_windows(torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda),
                             lo, hi, k)
    want = tbdv.count_windows_plain(torch.from_numpy(np.frombuffer(data, np.uint8).copy()), lo,
                                    hi, k)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


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
    monkeypatch.setattr(tbdv, "count_windows_plain", refuse)
    monkeypatch.setattr(tbdv, "reduce_plain", refuse)
    before = dict(tbdv.LAUNCHES)
    got = tbdv.count_kmers_device(reads, k, chunk_bases=chunk, device=cuda)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tbdv.LAUNCHES["count_windows"] > before["count_windows"]
    assert tbdv.LAUNCHES["segment_reduce"] > before["segment_reduce"] + 1     # chunks + merges
