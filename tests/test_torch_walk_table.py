"""The port's DeviceGraph, open-addressing table and walk table
(corticall_tpu_torch/device.py, ops/hashtable.py, ops/cuckoo.py,
ops/placement.place_cuckoo) against corticall_tpu's device.py, ops/hashtable.py
and ops/cuckoo.py: slots, buckets, lookups and speculative walks bit for bit
on the cases of tests/test_device.py, tests/test_cuckoo.py and
tests/test_more_commands.py's checkpoint resume.  The CUDA kernels against the
plain twins run only on a card.  Everything is integer: every comparison is
exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import fixtures, kmer as km  # noqa: E402
from corticall_tpu_torch import device as tdev  # noqa: E402
from corticall_tpu_torch.ops import cuckoo as tck, hashtable as tht, jump as tj  # noqa: E402
from corticall_tpu_torch.ops import placement as tp  # noqa: E402
from corticall_tpu_torch.utils import checkpoint as tcp  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from corticall_tpu import device
    from corticall_tpu.ops import cuckoo, hashtable
    return jnp, device, cuckoo, hashtable


def _graph(seed, n, k):
    """test_cuckoo.py's one-sample random genome graph."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), n))
    return fixtures.build_graph({"s": [genome]}, k), genome, rng


def _pack(strs, k):
    return km.pack_codes(km.strings_to_codes(strs), k)


def _bits(words):
    return tj.words_tensor(words, "cpu")


def _unique_kmers(seed, n, k):
    """test_device.py's table keys: unique canonical random k-mers."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, k)).astype(np.uint8)
    canon, _ = km.canonicalize_codes(codes)
    return km.bytes_be_to_words(np.unique(km.words_to_bytes_be(km.pack_codes(canon), k)), k)


def _jax_buckets(ct):
    """The port's [NB, BS, W+1] buckets as the JAX package's uint32 rows."""
    return ct.buckets.cpu().numpy().view(np.uint32).reshape(ct.buckets.shape[0], -1)


# ---------------------------------------------------------------------------
# the open-addressing table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,table_size", [(31, 5000, None), (5, 300, None), (47, 2000, 1 << 13),
                                            (63, 3000, None)])
def test_hashtable_build_and_lookup_match_jax(k, n, table_size):
    """test_device.py:72-90: every key found at its record, keys with a
    flipped bit missed unless present; build and lookup equal the JAX
    package's."""
    jnp, _, _, jht = _jax()
    kmers = _unique_kmers(8 + k, n, k)
    want = jht.build(kmers, table_size=table_size)
    got = tht.build(kmers, table_size=table_size)
    np.testing.assert_array_equal(got.slots, want.slots)
    assert (got.max_probe, got.table_bits, got.size) == (want.max_probe, want.table_bits,
                                                         want.size)
    missing = kmers.copy()
    missing[:, -1] ^= np.uint32(2)
    queries = np.concatenate([kmers, missing])
    res = tht.lookup(torch.from_numpy(got.slots), _bits(kmers), _bits(queries), got.max_probe)
    assert res.dtype == torch.int32
    np.testing.assert_array_equal(res.numpy(), np.asarray(jht.lookup(
        jnp.asarray(want.slots), jnp.asarray(kmers), jnp.asarray(queries), want.max_probe)))
    np.testing.assert_array_equal(res.numpy()[:len(kmers)], np.arange(len(kmers)))
    in_set = np.isin(km.words_to_bytes_be(missing, k), km.words_to_bytes_be(kmers, k))
    assert ((res.numpy()[len(kmers):] >= 0) == in_set).all()


def test_lookup_with_too_few_probes_matches_jax():
    """A probe budget below the longest probe: the lanes that run out answer
    -1 in both packages."""
    jnp, _, _, jht = _jax()
    kmers = _unique_kmers(2, 4000, 21)
    table = tht.build(kmers, load_factor=0.95)
    assert table.max_probe > 2
    for probes in (0, 1, 2):
        got = tht.lookup(torch.from_numpy(table.slots), _bits(kmers), _bits(kmers), probes)
        want = jht.lookup(jnp.asarray(table.slots), jnp.asarray(kmers), jnp.asarray(kmers),
                          probes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# placement and the cuckoo tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(seed=5, n=30000, k=21, load=0.5, nb=None, bs=4, bias=False),
    dict(seed=12, n=30000, k=21, load=0.5, nb=None, bs=2, bias=True),
    dict(seed=9, n=60000, k=17, load=0.9, nb=None, bs=4, bias=False),
    dict(seed=10, n=20000, k=31, load=0.9, nb=None, bs=2, bias=True),
    dict(seed=11, n=20000, k=31, load=0.5, nb=1 << 13, bs=4, bias=False),
], ids=["bs4", "walk", "load0.9", "bs2-load0.9", "fixed-buckets"])
def test_place_cuckoo_matches_jax(case):
    _, _, jck, _ = _jax()
    g, _, _ = _graph(case["seed"], case["n"], case["k"])
    args = (case["load"], case["nb"], case["bs"], case["bias"])
    got = tp.place_cuckoo(g.kmers, *args)
    want = jck._place(g.kmers, *args)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if case["load"] == 0.9:
        # the batched rounds left stragglers: the eviction walk placed them
        counts = np.bincount(got[1], minlength=got[0])
        assert (counts <= case["bs"]).all() and (got[1] != got[3]).any()


def test_place_cuckoo_walk_table_paths_equal_place():
    """The walk table's placement is the jump table's (ops/placement.place)."""
    g, _, _ = _graph(12, 30000, 21)
    nb, bucket_of, pos_of, _ = tp.place_cuckoo(g.kmers, 0.5, None, 2, True)
    want = tp.place(g.kmers)
    assert nb == want[0]
    np.testing.assert_array_equal(bucket_of, want[1])
    np.testing.assert_array_equal(pos_of, want[2])


@pytest.mark.parametrize("bs", [2, 4])
def test_build_tables_and_lookup_payload_match_jax(bs):
    """test_cuckoo.py:16-38, 82-101: every key placed, payload = edge byte on
    hits and 0 on misses, at bucket sizes 2 (the walk table) and 4; the
    buckets equal the JAX package's."""
    jnp, _, jck, _ = _jax()
    g, genome, rng = _graph(13, 20000, 31)
    edges = g.edges[:, 0]
    if bs == 2:
        got, want = tck.build_walk_table(g.kmers, edges, device="cpu"), \
            jck.build_walk_table(g.kmers, edges)
        assert got.primary_fraction > 0.85
    else:
        got, want = tck.build_cuckoo(g.kmers, edges, device="cpu"), \
            jck.build_cuckoo(g.kmers, edges)
    assert got.buckets.shape == (want.num_buckets, bs, got.words + 1)
    assert (got.nb_bits, got.words, got.bucket_size, got.primary_fraction) == \
        (want.nb_bits, want.words, want.bucket_size, want.primary_fraction)
    np.testing.assert_array_equal(_jax_buckets(got), want.buckets)
    assert int((got.buckets[..., -1] < 0).sum()) == g.num_records     # tags: bit 31 set
    idx = rng.integers(0, g.num_records, size=300)
    rnd = ["".join(rng.choice(list("ACGT"), 31)) for _ in range(50)]
    rnd = [min(s, km.revcomp(s)) for s in rnd if g.find_record(s) < 0]
    canon = np.concatenate([g.kmers[idx], _pack(rnd, 31)])
    pay = tck.lookup_payload(got.buckets, _bits(canon))
    assert pay.dtype == torch.int32
    np.testing.assert_array_equal(pay.numpy()[:300], edges[idx].astype(np.int32))
    assert not pay.numpy()[300:].any()
    np.testing.assert_array_equal(pay.numpy().view(np.uint32), np.asarray(
        jck.lookup_payload(jnp.asarray(want.buckets), jnp.asarray(canon), want.words)))


def test_scatter_buckets_payload_default_is_the_record_ids():
    g, _, _ = _graph(3, 5000, 21)
    nb, bucket_of, pos_of = tp.place(g.kmers)
    entry = bucket_of * 2 + pos_of
    jump_buckets, _ = tj.build_buckets(g.kmers, "cpu")
    ids, _ = tj.scatter_buckets(g.kmers, nb, entry, "cpu",
                                payload=np.arange(g.num_records, dtype=np.uint32))
    assert torch.equal(ids, jump_buckets)
    walk, _ = tj.scatter_buckets(g.kmers, nb, entry, "cpu", payload=g.edges[:, 0])
    assert torch.equal(walk, tck.build_walk_table(g.kmers, g.edges[:, 0], device="cpu").buckets)


# ---------------------------------------------------------------------------
# the speculative walk
# ---------------------------------------------------------------------------

def _spec_both(jnp, jck, g, seeds, k, steps, colors_edges=None):
    edges = g.edges[:, 0] if colors_edges is None else colors_edges
    pt = tck.build_walk_table(g.kmers, edges, device="cpu")
    jt = jck.build_walk_table(g.kmers, edges)
    got = tck.walk_forward_spec(pt.buckets, _bits(seeds), k, steps)
    want = jck.walk_forward_spec(jnp.asarray(jt.buckets), jnp.asarray(seeds), k, steps)
    assert got[0].shape == (tck.spec_iters(steps), seeds.shape[0])
    for name, a, b in zip(("bases", "cycled", "steps"), got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    return got


@pytest.mark.parametrize("k", [15, 47])
def test_walk_spec_matches_jax(k):
    """test_cuckoo.py:104-124's seeds, plus a missing seed and reverse
    complements."""
    jnp, _, jck, _ = _jax()
    g, genome, rng = _graph(200 + k, 30000, k)
    starts = rng.integers(0, 30000 - k, size=96)
    strs = [genome[i:i + k] for i in starts] + ["A" * k]
    strs += [km.revcomp(s) for s in strs[:16]]
    _, _, steps = _spec_both(jnp, jck, g, _pack(strs, k), k, 120)
    assert steps.numpy().max() == 120


def test_walk_spec_branchy_two_colours_matches_jax():
    """Junctions from SNPs between two colours, walked over their union."""
    jnp, _, jck, _ = _jax()
    rng = np.random.default_rng(23)
    genome = "".join(rng.choice(list("ACGT"), 12000))
    child = list(genome)
    for pos in rng.integers(31, 12000 - 31, size=40):
        child[pos] = "ACGT"[("ACGT".index(child[pos]) + 1) % 4]
    g = fixtures.build_graph({"kid": ["".join(child)], "mom": [genome]}, 31)
    starts = rng.integers(0, 12000 - 31, size=128)
    seeds = _pack([genome[i:i + 31] for i in starts], 31)
    _spec_both(jnp, jck, g, seeds, 31, 400, g.edges[:, 0] | g.edges[:, 1])


def test_walk_spec_cycle_detection_matches_jax():
    """test_cuckoo.py:127-141: a circular chromosome is walked one lap plus
    one base and flagged as a cycle."""
    jnp, _, jck, _ = _jax()
    from corticall_tpu.ops import walk_np as wnp
    k = 21
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 600))
    cyc = genome + genome[:k]
    g = fixtures.build_graph({"s": [cyc]}, k)
    bases, cycled, _ = _spec_both(jnp, jck, g, _pack([cyc[:k], cyc[9:9 + k]], k), k, 3000)
    assert bool(cycled[0])
    ext = wnp.replay_walk(cyc[:k], bases.numpy().T[0], True, 3000)
    assert (cyc[:k] + ext) in (genome + genome + genome)
    assert len(ext) == len(genome) + 1


@pytest.mark.parametrize("cap", [0, 7])
def test_walk_spec_caps_emission_matches_jax(cap):
    """test_cuckoo.py:144-151: emission stops at num_steps."""
    jnp, _, jck, _ = _jax()
    g, genome, rng = _graph(14, 20000, 31)
    starts = rng.integers(0, 10000, size=32)
    _, _, steps = _spec_both(jnp, jck, g, _pack([genome[i:i + 31] for i in starts], 31), 31, cap)
    assert int(steps.max()) == cap and int(steps.min()) >= 0


def test_walk_spec_long_k_matches_host_walker():
    """k = 63: four-word k-mers; the walks' bases equal the host numpy
    walker's contigs (the JAX package's own spec walk agrees too)."""
    jnp, _, jck, _ = _jax()
    from corticall_tpu.ops import walk_np as wnp
    k = 63
    g, genome, rng = _graph(63, 8000, k)
    strs = [genome[i:i + k] for i in rng.integers(0, 8000 - k, size=48)]
    bases, cycled, steps = _spec_both(jnp, jck, g, _pack(strs, k), k, 300)
    nb, nc, _ = wnp.walk_forward_np(g, [0], km.strings_to_codes(strs), 300)
    for i, s in enumerate(strs):
        assert (wnp.replay_walk(s, bases.numpy()[:, i], bool(cycled[i]), 300)
                == wnp.replay_walk(s, nb[:, i], bool(nc[i]), 300))


@pytest.mark.parametrize("bs,load", [(1, 0.25), (4, 0.5)])
def test_walk_spec_any_bucket_size_matches_jax(bs, load):
    """Tables of 1- and 4-entry buckets (the kernel's word-at-a-time path):
    the twin's walks equal the JAX package's over the same table."""
    jnp, _, jck, _ = _jax()
    k = 31
    g, genome, rng = _graph(40 + bs, 8000, k)
    pt = tck.build_cuckoo(g.kmers, g.edges[:, 0], load_factor=load, bucket_size=bs,
                          device="cpu")
    jt = jck.build_cuckoo(g.kmers, g.edges[:, 0], load_factor=load, bucket_size=bs)
    np.testing.assert_array_equal(_jax_buckets(pt), jt.buckets)
    seeds = _pack([genome[i:i + k] for i in rng.integers(0, 8000 - k, size=64)] + ["A" * k], k)
    got = tck.walk_forward_spec(pt.buckets, _bits(seeds), k, 150)
    want = jck.walk_forward_spec(jnp.asarray(jt.buckets), jnp.asarray(seeds), k, 150)
    for name, a, b in zip(("bases", "cycled", "steps"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got[2].max()) == 150 and int(got[2].min()) == 0


def test_walk_spec_wrapper_validates():
    g, genome, _ = _graph(4, 3000, 21)
    pt = tck.build_walk_table(g.kmers, g.edges[:, 0], device="cpu")
    seeds = _bits(_pack([genome[:21]], 21))
    before = dict(tck.LAUNCHES)
    tck.walk_forward_spec(pt.buckets, seeds, 21, 10)
    assert tck.LAUNCHES == before                       # no kernel on the CPU
    with pytest.raises(ValueError):
        tck.walk_forward_spec(pt.buckets, seeds, 47, 10)
    with pytest.raises(ValueError):
        tck.walk_forward_spec(pt.buckets.long(), seeds, 21, 10)
    with pytest.raises(ValueError):
        tck.walk_forward_spec(pt.buckets[:3], seeds, 21, 10)
    with pytest.raises(ValueError):
        tht.lookup(torch.zeros(6, dtype=torch.int32), seeds, seeds, 2)
    assert tck.spec_iters(120) == 182


# ---------------------------------------------------------------------------
# DeviceGraph and the checkpointed walk
# ---------------------------------------------------------------------------

def test_device_graph_matches_jax():
    """find_records (hits, misses), combined_edges, combined_coverage (uint32
    sums that wrap) and walk_buckets of each colour set."""
    jnp, jdev, _, jht = _jax()
    g = fixtures.build_graph({
        "mom": ["AGTTCTGATCTGGGCTATATGCTAGGCTTAACG" * 3],
        "dad": ["AGTTCGAATCTGGGCTATATGCTTTGACCAGTA" * 3],
        "kid": ["AGTTCGAATCTGGCCTATATGCTTTGACCAGTA" * 2]}, 11)
    cov = g.coverages.copy()
    cov[::3] = np.uint32(0xFFFFFFF0)                   # sums past 2^32 wrap
    got = tdev.DeviceGraph.from_arrays(11, g.kmers, cov, g.edges, g.sample_names, device="cpu")
    want = jdev.DeviceGraph.from_arrays(11, g.kmers, cov, g.edges, g.sample_names)
    assert (got.num_records, got.num_colors, got.max_probe, got.sample_names) == \
        (want.num_records, want.num_colors, want.max_probe, want.sample_names)
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(want.slots))
    w = g.kmers.shape[1]
    assert torch.equal(got.probe, tht.probe_table(got.slots, got.kmers))
    np.testing.assert_array_equal(
        tht.probe_table(got.slots, got.kmers, "key").numpy().view(np.uint32)[:, :w + 1],
        jht.build(g.kmers).build_entries(g.kmers))
    miss = g.kmers.copy()
    miss[:, -1] ^= np.uint32(1)
    q = np.concatenate([g.kmers, miss])
    np.testing.assert_array_equal(got.find_records(_bits(q)).numpy(),
                                  np.asarray(want.find_records(jnp.asarray(q))))
    for colors in ([0], [1, 2], [0, 1, 2]):
        np.testing.assert_array_equal(got.combined_edges(colors).numpy(),
                                      np.asarray(want.combined_edges(colors)))
        np.testing.assert_array_equal(got.combined_coverage(colors).numpy().view(np.uint32),
                                      np.asarray(want.combined_coverage(colors)))
        buckets = got.walk_buckets(colors)
        assert got.walk_buckets(colors) is buckets                     # cached
        np.testing.assert_array_equal(buckets.numpy().view(np.uint32).reshape(
            buckets.shape[0], -1), np.asarray(want.walk_buckets(colors)))
    pg = tdev.DeviceGraph.from_graph(g, device="cpu")
    assert torch.equal(pg.kmers, got.kmers) and pg.sample_names == tuple(g.sample_names)


def test_walk_checkpoint_resume(tmp_path):
    """After tests/test_more_commands.py:93-125: a 300-step walk, a
    checkpoint of its frontier, and resume_walks for 300 more emit the bases
    of one 600-step walk_forward_spec; the resumed walk equals the JAX
    package's resume_walks."""
    jnp, jdev, _, _ = _jax()
    from corticall_tpu.utils import checkpoint as jcp
    rng = np.random.default_rng(113)
    genome = "".join(rng.choice(list("ACGT"), 1200))
    k = 15
    g = fixtures.build_graph({"s": [genome]}, k)
    dg = tdev.DeviceGraph.from_graph(g, device="cpu")
    seeds = _bits(_pack([genome[:k]], k))
    buckets = dg.walk_buckets([0])
    full = tck.walk_forward_spec(buckets, seeds, k, 600)[0].numpy()[:, 0]
    half = tck.walk_forward_spec(buckets, seeds, k, 300)[0].numpy()[:, 0]
    cur_str = genome[:k]
    for b in half[half >= 0]:
        cur_str = cur_str[1:] + "ACGT"[b]
    p = tmp_path / "walk.npz"
    tcp.save_walk_state(p, cur=_pack([cur_str], k), active=np.array([True]),
                        bases_so_far=half, graph_fp=tcp.graph_fingerprint(g))
    state = tcp.load_walk_state(p)
    assert state["meta"]["graph"] == tcp.graph_fingerprint(g)
    rest, cycled, steps = tcp.resume_walks(dg, [0], state, 300)
    combined = np.concatenate([state["bases"], rest.numpy()[:, 0]])
    np.testing.assert_array_equal(combined[combined >= 0], full[full >= 0])
    assert int((full >= 0).sum()) == 600
    want = jcp.resume_walks(jdev.DeviceGraph.from_graph(g), [0], state, 300)
    for a, b in zip((rest, cycled, steps), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_device_graph_needs_a_device_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _, _ = _graph(1, 500, 11)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.DeviceGraph.from_graph(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.build_walk_table(g.kmers, g.edges[:, 0])
    assert tdev.DeviceGraph.from_graph(g, device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# kernels against the plain twins (card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 31, 47, 63])
def test_lookup_kernel_matches_twin_on_card(cuda, k):
    """Hits and misses on a load-0.9 table (and a probe budget that runs
    out) over the key and tag probe tables at 1, 2, 4 and 8 lanes a query,
    each launched twice back to back into poison-filled buffers; the table
    built on the card equals the host's."""
    kmers = _unique_kmers(k, 20000, k)
    table = tht.build(kmers, load_factor=0.9)
    assert table.max_probe > 32 or k == 5          # k = 5: 512 k-mers, a 1,024-slot table
    missing = kmers.copy()
    missing[:, -1] ^= np.uint32(2)
    q = tj.words_tensor(np.concatenate([kmers, missing]), cuda)
    slots, kd = torch.from_numpy(table.slots).to(cuda), tj.words_tensor(kmers, cuda)
    b = q.shape[0]
    for form in ("key", "tag"):
        probe = tht.probe_table(slots, kd, form)
        assert torch.equal(probe.cpu(), tht.probe_table(slots.cpu(), kd.cpu(), form))
        for probes in (table.max_probe, 2, 13):
            want = tht.lookup_plain(slots, kd, q, probes)
            for group in tht.GROUPS:
                outs = [torch.full((b + 40,), 0x5A5A5A5A, dtype=torch.int32, device=cuda)
                        for _ in range(2)]
                before = tht.LAUNCHES["ht_lookup"]
                for out in outs:
                    tht.lookup_kernel(probe, kd, q, probes, out[:b], group)
                torch.cuda.synchronize()
                assert tht.LAUNCHES["ht_lookup"] == before + 2
                for out in outs:
                    assert torch.equal(out[:b], want), (form, probes, group)
                    assert (out[b:] == 0x5A5A5A5A).all()
    assert torch.equal(tht.lookup(slots, kd, q, table.max_probe),
                       tht.lookup_plain(slots, kd, q, table.max_probe))


@pytest.mark.cuda
@pytest.mark.parametrize("k,cap,bs", [(15, 120, 2), (31, 7, 2), (47, 2000, 2), (63, 300, 2),
                                      (31, 300, 4)])
def test_spec_walk_kernel_matches_twin_on_card(cuda, k, cap, bs):
    """Every byte of bases [T, B], cycled and steps equal the twin's,
    launched into poison-filled buffers; lanes that stop fill -1."""
    rng = np.random.default_rng(k + cap)
    genome = "".join(rng.choice(list("ACGT"), 8000))
    child = list(genome)
    for pos in rng.integers(31, 8000 - 31, size=30):
        child[pos] = "ACGT"[("ACGT".index(child[pos]) + 1) % 4]
    g = fixtures.build_graph({"s": [genome], "c": ["".join(child)]}, k)
    edges = g.edges[:, 0] | g.edges[:, 1]
    ct = tck.build_cuckoo(g.kmers, edges, bucket_size=bs, primary_bias=bs == 2, device=cuda)
    strs = [genome[i:i + k] for i in rng.integers(0, 8000 - k, size=300)] + ["A" * k]
    strs += [km.revcomp(s) for s in strs[:40]]
    seeds = tj.words_tensor(_pack(strs, k), cuda)
    b, t = seeds.shape[0], tck.spec_iters(cap)
    bases = torch.full((t + 3, b), 0x5A, dtype=torch.int8, device=cuda)
    cycled = torch.full((b,), 7, dtype=torch.uint8, device=cuda).view(torch.bool)
    steps = torch.full((b,), -9, dtype=torch.int32, device=cuda)
    before = tck.LAUNCHES["spec_walk"]
    tck.spec_walk_kernel(ct.buckets, seeds, k, cap, bases[:t], cycled, steps)
    torch.cuda.synchronize()
    assert tck.LAUNCHES["spec_walk"] == before + 1
    want = tck.spec_walk_plain(ct.buckets, seeds, k, cap)
    assert torch.equal(bases[:t], want[0]) and (bases[t:] == 0x5A).all()
    assert torch.equal(cycled.view(torch.uint8), want[1].to(torch.uint8))
    assert torch.equal(steps, want[2])


def _launch_poisoned(buckets, seeds, k, cap):
    """One ctk_spec_walk launch into poison-filled buffers, one row wider
    than the walk: (bases [T, B], cycled, steps), the poison past them
    untouched."""
    b, t, dev = seeds.shape[0], tck.spec_iters(cap), seeds.device
    bases = torch.full((t + 1, b), 0x5A, dtype=torch.int8, device=dev)
    cycled = torch.full((b + 8,), 7, dtype=torch.uint8, device=dev)
    steps = torch.full((b + 8,), -9, dtype=torch.int32, device=dev)
    before = tck.LAUNCHES["spec_walk"]
    tck.spec_walk_kernel(buckets, seeds, k, cap, bases[:t], cycled[:b].view(torch.bool),
                         steps[:b])
    torch.cuda.synchronize()
    assert tck.LAUNCHES["spec_walk"] == before + 1
    assert (bases[t:] == 0x5A).all() and (cycled[b:] == 7).all() and (steps[b:] == -9).all()
    return bases[:t], cycled[:b].view(torch.bool), steps[:b]


def _word_path_table(buckets):
    """A copy of the table 4 bytes off its rows' vector alignment, which
    ctk_spec_walk reads a word at a time."""
    flat = torch.empty(buckets.numel() + 1, dtype=buckets.dtype, device=buckets.device)
    table = flat[1:].view(buckets.shape)
    table.copy_(buckets)
    return table


def _assert_paths_match_twin(buckets, seeds, k, cap):
    """ctk_spec_walk on each path the table can take (2-entry rows: as
    vectors, and a copy off their alignment a word at a time; other bucket
    sizes: a word at a time) against the twin, bit for bit; returns the
    twin's (bases, cycled, steps)."""
    want = tck.spec_walk_plain(buckets, seeds, k, cap)
    tables = {"words": buckets}
    if buckets.shape[1] == 2:
        tables = {"vector": buckets, "words": _word_path_table(buckets)}
    for path, table in tables.items():
        got = _launch_poisoned(table, seeds, k, cap)
        for name, a, w in zip(("bases", "cycled", "steps"), got, want):
            assert torch.equal(a, w), (path, name)
        info = tck.kernel_info(table, seeds.shape[0])
        assert info["registers"] > 0 and info["resident_lanes"] > 0 and info["waves"] >= 1
        assert info["path"] == path and info["walks_per_thread"] == 1
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs", [(15, 2), (31, 2), (47, 2), (63, 2), (31, 1), (47, 4)])
def test_spec_walk_paths_match_twin_on_card(cuda, k, bs):
    """Each path on a two-colour graph with junctions: 2-entry rows at
    every vector width (16, 24, 32 and 40 bytes) and a word at a time, 1-
    and 4-entry buckets (a word at a time); 341 walks (not a multiple of
    the block), walks that end at different iterations and a missing seed
    that ends at its second probe."""
    rng = np.random.default_rng(k * 7 + bs)
    genome = "".join(rng.choice(list("ACGT"), 8000))
    child = list(genome)
    for pos in rng.integers(31, 8000 - 31, size=30):
        child[pos] = "ACGT"[("ACGT".index(child[pos]) + 1) % 4]
    g = fixtures.build_graph({"s": [genome], "c": ["".join(child)]}, k)
    ct = tck.build_cuckoo(g.kmers, g.edges[:, 0] | g.edges[:, 1], load_factor=0.25 if bs == 1
                          else 0.5, bucket_size=bs, primary_bias=bs == 2, device=cuda)
    strs = [genome[i:i + k] for i in rng.integers(0, 8000 - k, size=300)] + ["A" * k]
    strs += [km.revcomp(s) for s in strs[:40]]
    seeds = tj.words_tensor(_pack(strs, k), cuda)
    assert seeds.shape[0] == 341 and seeds.shape[0] % 128
    _, _, steps = _assert_paths_match_twin(ct.buckets, seeds, k, 400)
    assert len(set(steps.tolist())) > 2 and int(steps.min()) == 0


@pytest.mark.cuda
def test_spec_walk_paths_find_cycles_on_card(cuda):
    """Brent's anchor on each path: walks on a 600-base circle (k = 21)
    cycle after more than a lap, beside walks that run off a line."""
    k = 21
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 600))
    line = "".join(rng.choice(list("ACGT"), 900))
    g = fixtures.build_graph({"s": [genome + genome[:k], line]}, k)
    ct = tck.build_walk_table(g.kmers, g.edges[:, 0], device=cuda)
    strs = [genome[i:i + k] for i in range(0, 600 - k, 7)] + [line[i:i + k] for i in
                                                              range(0, 900 - k, 11)]
    seeds = tj.words_tensor(_pack(strs, k), cuda)
    _, cycled, steps = _assert_paths_match_twin(ct.buckets, seeds, k, 3000)
    assert cycled.any() and not cycled.all() and (steps[cycled] > 600).all()


@pytest.mark.cuda
def test_device_graph_on_card_matches_cpu_without_any_twin(cuda, monkeypatch):
    """DeviceGraph on the card: find_records, the walk table and a resumed
    walk equal the CPU twins' results; the card path never reaches a twin."""
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 20000))
    k = 31
    g = fixtures.build_graph({"s": [genome], "t": [genome[5000:15000]]}, k)
    cpu = tdev.DeviceGraph.from_graph(g, device="cpu")
    strs = [genome[i:i + k] for i in rng.integers(0, 20000 - k, size=500)]
    canon = _pack([min(s, km.revcomp(s)) for s in strs] + ["A" * k], k)
    want_rec = cpu.find_records(_bits(canon))
    want_walk = tck.walk_forward_spec(cpu.walk_buckets([0, 1]), _bits(_pack(strs, k)), k, 700)

    def refuse(*a, **kw):
        raise AssertionError("a twin ran on the card")

    monkeypatch.setattr(tht, "lookup_plain", refuse)
    monkeypatch.setattr(tck, "spec_walk_plain", refuse)
    dg = tdev.DeviceGraph.from_graph(g, device=cuda)
    got_rec = dg.find_records(tj.words_tensor(canon, cuda))
    assert torch.equal(got_rec.cpu(), want_rec)
    assert torch.equal(dg.walk_buckets([0, 1]).cpu(), cpu.walk_buckets([0, 1]))
    assert torch.equal(dg.combined_coverage([0, 1]).cpu(), cpu.combined_coverage([0, 1]))
    state = {"cur": _pack(strs, k)}
    got_walk = tcp.resume_walks(dg, [0, 1], state, 700)
    for a, b in zip(got_walk, want_walk):
        assert torch.equal(a.cpu(), b)
