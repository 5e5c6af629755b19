"""The port's jump table (corticall_tpu_torch/ops/jump.py) against
corticall_tpu/ops/cuckoo.py: rows and buckets of build_jump_table, and the
walk_forward_jumps 6-tuple, on the cases of tests/test_cuckoo.py.  For
49 <= k <= 63, which the JAX package's flat bucket layout cannot hold, the
walks are held against the host walkers instead.  Its CUDA kernels against
the plain twins run only on a card.  Everything is integer: every
comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import fixtures, kmer as km, native as nat  # noqa: E402
from corticall_tpu.ops import walk_np as wnp  # noqa: E402
from corticall_tpu_torch.ops import jump as tj, kmer as tk  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ck():
    pytest.importorskip("jax")
    from corticall_tpu.ops import cuckoo
    return cuckoo


def _branchy(k, seed=23, n=24000):
    """test_cuckoo.py's branchy two-sample graph (40 child SNPs)."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), n))
    child = list(genome)
    for pos in rng.integers(31, n - 31, size=40):
        child[pos] = "ACGT"[(ord(child[pos]) + 1) % 4]
    g = fixtures.build_graph({"kid": ["".join(child)], "mom": [genome]}, k)
    return g, genome, rng


def _cycle(k, length, seed=5):
    """A circular chromosome: every walk from it is on one cycle."""
    rng = np.random.default_rng(seed + length)
    cyc = "".join(rng.choice(list("ACGT"), length))
    hap = cyc + cyc[:k]
    g = fixtures.build_graph({"s": [hap]}, k)
    assert g.num_records == length
    return g, hap


def _pack(strs, k):
    return km.pack_codes(km.strings_to_codes(strs), k)


def _assert_same_walks(got, want):
    names = ("packed", "cycled", "steps", "saturated", "touched", "ends_junction")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("k", [31, 47])
@pytest.mark.parametrize("with_flags", [False, True])
def test_rows_and_buckets_match_jax(k, with_flags):
    ck = _ck()
    g, _, rng = _branchy(k)
    flags = rng.random(g.num_records) < 0.02 if with_flags else None
    want = ck.build_jump_table(g.kmers, g.edges[:, 0], k, flags=flags)
    got = tj.build_jump_table(g.kmers, g.edges[:, 0], k, flags=flags, device="cpu")
    n, w = g.kmers.shape
    rows = got.rows.numpy().view(np.uint32)
    assert rows.shape == (2 * n, 4)
    np.testing.assert_array_equal(rows, np.asarray(want.rows).reshape(-1, 4)[:2 * n])
    # JAX's flat buckets: fixed 4-word entries, keys at 0..w-1, tag at 3
    jb = np.asarray(want.buckets).reshape(-1, 2, 4)
    pb = got.buckets.numpy().view(np.uint32)
    assert pb.shape == (jb.shape[0], 2, w + 1)
    np.testing.assert_array_equal(pb[..., :w], jb[..., :w])
    np.testing.assert_array_equal(pb[..., w], jb[..., 3])
    if with_flags:
        meta = rows[:, 3]
        assert ((meta >> 30) & 1).any()


@pytest.mark.parametrize("cap", [7, 300])
def test_walks_match_jax_branchy(cap):
    ck = _ck()
    import jax.numpy as jnp
    k = 31
    g, genome, rng = _branchy(k)
    flags = rng.random(g.num_records) < 0.02
    jt = ck.build_jump_table(g.kmers, g.edges[:, 0], k, flags=flags)
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], k, flags=flags, device="cpu")
    starts = rng.integers(0, len(genome) - k, size=96)
    seeds = _pack([genome[i:i + k] for i in starts], k)
    want = ck.walk_forward_jumps(jt.buckets, jt.rows, jnp.asarray(seeds), k, cap)
    _assert_same_walks(tj.walk_forward_jumps(pt.buckets, pt.rows, seeds, k, cap), want)


def test_missing_seed_matches_jax():
    ck = _ck()
    import jax.numpy as jnp
    rng = np.random.default_rng(29)
    genome = "".join(rng.choice(list("ACGT"), 20000))
    g = fixtures.build_graph({"s": [genome]}, 31)
    jt = ck.build_jump_table(g.kmers, g.edges[:, 0], 31)
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], 31, device="cpu")
    seeds = _pack([genome[:31], "A" * 31], 31)
    got = tj.walk_forward_jumps(pt.buckets, pt.rows, seeds, 31, 50)
    _assert_same_walks(got, ck.walk_forward_jumps(jt.buckets, jt.rows,
                                                  jnp.asarray(seeds), 31, 50))
    assert got[2][1] == 0 and not got[1][1] and got[2][0] > 0


@pytest.mark.parametrize("length", [616, 600, 90])
def test_cycles_match_jax(length):
    ck = _ck()
    import jax.numpy as jnp
    k = 31
    g, hap = _cycle(k, length)
    jt = ck.build_jump_table(g.kmers, g.edges[:, 0], k)
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], k, device="cpu")
    seed_strs = [hap[:k], hap[7:7 + k]]
    seeds = _pack(seed_strs, k)
    for cap in (3000, length + 50):
        got = tj.walk_forward_jumps(pt.buckets, pt.rows, seeds, k, cap)
        _assert_same_walks(got, ck.walk_forward_jumps(jt.buckets, jt.rows,
                                                      jnp.asarray(seeds), k, cap))
        packed, cycled, steps, saturated = got[:4]
        for i, s in enumerate(seed_strs):
            assert cycled[i] or saturated[i]
            assert (wnp.replay_jump_walk(s, packed[i], int(steps[i]), cap)
                    == _host_extension(g, s, cap))


def _host_extension(g, seed, cap):
    """The host oracle's walk extension: the numpy single-step walker and
    the reference's seen-set replay."""
    bases, cycled, _ = wnp.walk_forward_np(g, [0], km.strings_to_codes([seed]), cap)
    return wnp.replay_walk(seed, bases[:, 0], bool(cycled[0]), cap)


@pytest.mark.parametrize("k", [49, 55, 63])
def test_long_k_walks_match_host_walkers(k):
    """k > 48 has four-word k-mers: the port's [NB, 2, W+1] buckets hold
    them; the JAX package asserts there, so the host walkers are the
    reference."""
    g, genome, rng = _branchy(k, seed=k, n=6000)
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], k, device="cpu")
    assert pt.buckets.shape[2] == 5
    starts = rng.integers(0, len(genome) - k, size=48)
    seed_strs = [genome[i:i + k] for i in starts] + ["C" * k]
    seed_strs += [km.revcomp(s) for s in seed_strs[:8]]
    cap = 700
    packed, cycled, steps, saturated, _, _ = tj.walk_forward_jumps(
        pt.buckets, pt.rows, _pack(seed_strs, k), k, cap)
    got = wnp.jump_extensions_batch(seed_strs, packed, steps, cycled,
                                    saturated, cap)
    want = [_host_extension(g, s, cap) for s in seed_strs]
    assert got == want
    assert steps[len(seed_strs) - 9] == 0          # the missing seed
    if nat.available():
        wt = nat.WalkTableNative(g.kmers, g.edges[:, 0], k)
        nb, nc, _ = wt.walk(_pack(seed_strs, k), cap)
        assert [wnp.replay_walk(s, nb[:, i], bool(nc[i]), cap)
                for i, s in enumerate(seed_strs)] == want


@pytest.mark.parametrize("k", [55, 63])
def test_long_k_cycle_matches_host_walker(k):
    g, hap = _cycle(k, 300, seed=k)
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], k, device="cpu")
    seed_strs = [hap[:k], hap[11:11 + k]]
    for cap in (2000, 350):
        packed, cycled, steps, saturated, _, _ = tj.walk_forward_jumps(
            pt.buckets, pt.rows, _pack(seed_strs, k), k, cap)
        for i, s in enumerate(seed_strs):
            assert cycled[i] or saturated[i]
            assert (wnp.replay_jump_walk(s, packed[i], int(steps[i]), cap)
                    == _host_extension(g, s, cap))


def test_wrappers_on_cpu_run_the_twins_and_validate():
    g, genome, _ = _branchy(31, n=3000)
    before = dict(tj.LAUNCHES)
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], 31, device="cpu")
    seeds = tj.words_tensor(_pack([genome[:31], genome[100:131]], 31), "cpu")
    out = tj.walk_jumps(pt.buckets, pt.rows, seeds, 31, 100)
    assert out[0].shape == (2, 2 * tj.jump_iters(100)) and out[0].dtype == torch.int32
    assert tj.LAUNCHES == before                     # no kernel on the CPU
    with pytest.raises(ValueError):
        tj.walk_jumps(pt.buckets, pt.rows, seeds, 47, 100)
    with pytest.raises(ValueError):
        tj.walk_jumps(pt.buckets, pt.rows.long(), seeds, 31, 100)
    kd = tj.words_tensor(g.kmers, "cpu")
    ed = torch.from_numpy(g.edges[:, 0].copy())
    fl = torch.zeros(g.num_records, dtype=torch.bool)
    with pytest.raises(TypeError):
        tj.jump_rows(kd, ed.long(), fl, pt.buckets, 31)
    with pytest.raises(ValueError):
        tj.jump_rows(kd, ed, fl, pt.buckets, 47)
    assert tj.jump_iters(2000) == 65 and tj.jump_iters(32) == 3


@pytest.mark.parametrize("k", [21, 31, 47, 63])
@pytest.mark.parametrize("with_flags", [False, True])
def test_narrow_rows_round_trip_the_twin_states(k, with_flags):
    """The narrow rows that stage 0 and the first NARROW_PASSES compose
    passes write on the card decode (widen_rows) to the wide rows of the
    plain twins' state after each of those stages; the next pass's runs no
    longer fit, and a state is not taken for another stage's."""
    g, _, rng = _branchy(k, seed=k, n=5000)
    flags = rng.random(g.num_records) < 0.05 if with_flags else None
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], k, flags=flags, device="cpu")
    kd = tj.words_tensor(g.kmers, "cpu")
    ed = torch.from_numpy(g.edges[:, 0].copy())
    fl = torch.from_numpy(np.zeros(g.num_records, bool) if flags is None else flags)
    state = tj.stage0_plain(kd, ed, fl, pt.buckets, k)
    for stage in range(tj.NARROW_PASSES + 1):
        narrow = tj.narrow_rows(*state, stage)
        assert narrow.shape == (2 * g.num_records, 2) and narrow.dtype == torch.int32
        assert torch.equal(tj.widen_rows(narrow, stage), tj.pack_rows(*state)), stage
        with pytest.raises(ValueError):
            tj.narrow_rows(*state, stage + 1)
        state = tj.jump_compose(*state)
    meta = tj.pack_rows(*state)[:, 3]
    assert int((meta & 0x3F).max()) == 2 * tj.NARROW_MAX     # runs this graph fills
    with pytest.raises(ValueError):
        tj.narrow_rows(*state, tj.NARROW_PASSES + 1)
    link = tk.from_bits32(tj.narrow_rows(*tj.stage0_plain(kd, ed, fl, pt.buckets, k), 0)[:, 1])
    assert int((link >> 31).sum()) == 2 * int(fl.sum())       # the flag bit, both rows


@pytest.mark.parametrize("k,n", [(21, 900), (31, 6000), (47, 20000), (63, 3000)])
def test_place_stores_every_key_once(k, n):
    """ctk_jump_stage0 and ctk_jump_walk stop a lookup at the first bucket
    that holds the key: that equals the twin's maximum over both buckets'
    matches because the placement stores each of a graph's keys in exactly
    one slot, in one of its two candidate buckets."""
    from corticall_tpu_torch.ops import placement as tp
    rng = np.random.default_rng(k + n)
    g = fixtures.build_graph({"s": ["".join(rng.choice(list("ACGT"), n))]}, k)
    nb, bucket_of, pos_of = tp.place(g.kmers)
    slot = bucket_of * 2 + pos_of
    assert (bucket_of >= 0).all() and len(np.unique(slot)) == g.num_records
    h = tp.np_hash_words(g.kmers)
    first = (h & np.uint32(nb - 1)).astype(np.int64)
    second = (tp.np_h2(h) & np.uint32(nb - 1)).astype(np.int64)
    assert ((bucket_of == first) | (bucket_of == second)).all()
    assert (bucket_of == first).mean() > 0.5               # most sit in their first
    # the scattered buckets hold each key once across its two candidates
    buckets, _ = tj.build_buckets(g.kmers, "cpu")
    ent = tk.from_bits32(buckets).numpy()
    w = g.kmers.shape[1]

    def matches(cand):
        e = ent[cand]                                      # [N, 2, W+1]
        return ((e[..., w] >= 1 << 31) & (e[..., :w] == g.kmers[:, None, :]).all(-1)).sum(-1)
    hits = matches(first) + np.where(second != first, matches(second), 0)
    assert (hits == 1).all()


def test_kernel_wrappers_check_row_formats():
    n2 = 8
    wide = torch.zeros((n2, 4), dtype=torch.int32)
    narrow = torch.zeros((n2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tj.compose_kernel(wide, narrow, 0)                   # rows in are narrow
    with pytest.raises(ValueError, match="at most 16 bases"):
        tj.compose_kernel(narrow, narrow.clone(), tj.NARROW_PASSES)
    with pytest.raises(ValueError):
        tj.compose_kernel(narrow, torch.zeros((n2, 3), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        tj.compose_kernel(narrow, torch.zeros((n2 + 2, 4), dtype=torch.int32), 0)
    kd = torch.zeros((n2 // 2, 2), dtype=torch.int32)
    buckets = torch.zeros((4, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        tj.stage0_kernel(kd, torch.zeros(n2 // 2, dtype=torch.uint8),
                         torch.zeros(n2 // 2, dtype=torch.bool), buckets, 31, wide)


# ---------------------------------------------------------------------------
# kernels against the plain twins (card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31, 47, 63])
def test_table_kernels_match_plain_on_card(cuda, k):
    g, _, rng = _branchy(k, seed=k, n=8000)
    flags = rng.random(g.num_records) < 0.05
    buckets, kd = tj.build_buckets(g.kmers, cuda)
    ed = torch.from_numpy(g.edges[:, 0].copy()).to(cuda)
    fl = torch.from_numpy(flags).to(cuda)
    before = dict(tj.LAUNCHES)
    got = tj.jump_rows(kd, ed, fl, buckets, k)
    torch.cuda.synchronize()
    assert tj.LAUNCHES["jump_stage0"] == before["jump_stage0"] + 1
    assert tj.LAUNCHES["jump_compose"] == before["jump_compose"] + 5
    want = tj.jump_rows_plain(kd, ed, fl, buckets, k)
    assert torch.equal(got, want)
    cpu = tj.build_jump_table(g.kmers, g.edges[:, 0], k, flags=flags, device="cpu")
    assert torch.equal(got.cpu(), cpu.rows) and torch.equal(buckets.cpu(), cpu.buckets)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31, 47, 63])
def test_each_build_kernel_matches_its_twin_on_card(cuda, k):
    """Stage 0 and every compose pass on their own, each from the previous
    kernel's rows: narrow rows through pass NARROW_PASSES, then wide."""
    g, _, rng = _branchy(k, seed=k + 1, n=8000)
    buckets, kd = tj.build_buckets(g.kmers, cuda)
    ed = torch.from_numpy(g.edges[:, 0].copy()).to(cuda)
    fl = torch.from_numpy(rng.random(g.num_records) < 0.05).to(cuda)
    n2 = 2 * g.num_records
    src = torch.empty((n2, 2), dtype=torch.int32, device=cuda)
    tj.stage0_kernel(kd, ed, fl, buckets, k, src)
    state = tj.stage0_plain(kd, ed, fl, buckets, k)
    assert torch.equal(tj.widen_rows(src, 0), tj.pack_rows(*state))
    for p in range(tj.COMPOSE_PASSES):
        dst = torch.empty((n2, 2 if p < tj.NARROW_PASSES else 4), dtype=torch.int32,
                          device=cuda)
        tj.compose_kernel(src, dst, p)
        state = tj.jump_compose(*state)
        got = dst if dst.shape[1] == 4 else tj.widen_rows(dst, p + 1)
        assert torch.equal(got, tj.pack_rows(*state)), p
        src = dst


@pytest.mark.cuda
@pytest.mark.parametrize("k,cap", [(31, 7), (31, 300), (47, 2000), (63, 500)])
def test_walk_kernel_matches_plain_on_card(cuda, k, cap):
    g, genome, rng = _branchy(k, seed=k + cap, n=8000)
    flags = rng.random(g.num_records) < 0.05
    pt = tj.build_jump_table(g.kmers, g.edges[:, 0], k, flags=flags, device=cuda)
    starts = rng.integers(0, len(genome) - k, size=300)
    strs = [genome[i:i + k] for i in starts] + ["A" * k]
    strs += [km.revcomp(s) for s in strs[:50]]
    seeds = tj.words_tensor(_pack(strs, k), cuda)
    before = tj.LAUNCHES["jump_walk"]
    got = tj.walk_jumps(pt.buckets, pt.rows, seeds, k, cap)
    torch.cuda.synchronize()
    assert tj.LAUNCHES["jump_walk"] == before + 1
    start = tj.seed_rows(pt.buckets, tk.from_bits32(seeds), k)
    packed, steps, cycled, touched, endj = tj.jump_walk(pt.rows, start, cap)
    assert torch.equal(got[0], tk.to_bits32(packed))
    assert torch.equal(got[1], steps.to(torch.int32))
    for a, b in zip(got[2:], (cycled, touched, endj)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_walk_kernel_on_cycles_matches_plain_on_card(cuda):
    for length in (616, 90):
        g, hap = _cycle(31, length)
        pt = tj.build_jump_table(g.kmers, g.edges[:, 0], 31, device=cuda)
        cpu = tj.build_jump_table(g.kmers, g.edges[:, 0], 31, device="cpu")
        seeds = _pack([hap[:31], hap[7:38]], 31)
        for cap in (3000, length + 50):
            got = tj.walk_forward_jumps(pt.buckets, pt.rows, seeds, 31, cap)
            _assert_same_walks(got, tj.walk_forward_jumps(cpu.buckets, cpu.rows,
                                                          seeds, 31, cap))
