"""The port's linked device walker (corticall_tpu_torch/ops/walk_links.py)
against corticall_tpu/ops/walk_links.py: the link CSR, the LinkStore steps
`store_add` and `store_advance`, the walk `walk_links_forward`, and
`LinkedWalker`'s contigs, bit for bit on the graphs of tests/test_walk_links.py
and on k = 47 and k = 55 trios with threaded links; the walker's contigs also
against the port's host engine and native walker where no walk overflowed.
Everything is integer or string: every comparison is exact equality.  The
kernel (`ctk_link_walk`) against its plain twin runs only on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import fixtures, kmer as jkm  # noqa: E402
from corticall_tpu.io import links as jlk  # noqa: E402
from corticall_tpu_torch import kmer as km, native as tnat  # noqa: E402
from corticall_tpu_torch.io import links as tlk  # noqa: E402
from corticall_tpu_torch.ops import walk_links as twl  # noqa: E402
from corticall_tpu_torch.traversal import TraversalConfig, TraversalEngine, to_contig  # noqa: E402
from corticall_tpu_torch.traversal.stopping import ContigStopper  # noqa: E402
from test_torch_host import port_graph, port_links  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The twins run thousands of small ops a walk: on one thread they are
    faster, and they do not contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from corticall_tpu.ops import walk_links as jwl
    return jnp, jwl


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _trio(seed, k, spacing=150, reads=(300, 60)):
    """A trio whose child carries a tandem repeat, a segment copied
    elsewhere and a hub sequence every `spacing` bases (junctions that only
    links resolve); the child's links threaded from reads of reads[0] bases
    tiled reads[1] apart, or from its whole haplotype (reads=None: link
    records of more than MAX_J choices).  Hubs 90 bases apart give k-mers
    with more than MAX_ADD link records and walks that fill their store."""
    rng = np.random.default_rng(seed)
    mom = _genome(rng, 2400)
    dad = list(mom)
    for pos in rng.integers(0, len(mom), 12):
        dad[pos] = "ACGT"[("ACGT".index(dad[pos]) + 1) % 4]
    dad = "".join(dad)
    hub = _genome(rng, k + 12)
    kid = mom[:700] + mom[300:300 + 2 * k] + mom[700:1200] + dad[1200:1500] * 2 + dad[1500:]
    kid = hub.join(kid[i:i + spacing] for i in range(0, len(kid), spacing))
    g = fixtures.build_graph({"mom": [mom], "dad": [dad], "kid": [kid]}, k)
    threaded = [kid] if reads is None else [kid[i:i + reads[0]]
                                            for i in range(0, len(kid) - reads[0], reads[1])]
    links = jlk.build_links(g, {"kid": threaded}, "kid")
    seeds = [kid[i:i + k] for i in range(0, len(kid) - k, 41)]
    return g, [links], g.color_for_sample("kid"), seeds


def case(name):
    """(JAX graph, JAX links list, walk colour, seed strings, num_steps)."""
    if name == "cycle":
        g = fixtures.build_graph({"test": ["ACTGATTTCGATGCGATGCGATGCCACGGTGG"]}, 5)
        links = jlk.build_links(g, {"test": ["TTTCGATGCGATGCGATGCCACG"]}, "test")
        return g, [links], 0, ["ACTGA"], 128
    if name == "unlinked":
        rng = np.random.default_rng(31)
        genome = _genome(rng, 800)
        g = fixtures.build_graph({"s": [genome]}, 15)
        return g, [], 0, [genome[i:i + 15] for i in range(0, 700, 173)], 1024
    if name == "repeat":
        rng = np.random.default_rng(37)
        unit = _genome(rng, 60)
        genome = _genome(rng, 300) + unit * 3 + _genome(rng, 300)
        g = fixtures.build_graph({"s": [genome]}, 11)
        links = jlk.build_links(g, {"s": [genome]}, "s")
        return g, [links], 0, [genome[i:i + 11] for i in (0, 100, 250, 500, 620)], 2048
    if name == "dfs_sink":
        hap = "GTGTGCTAGGTCTATAGTTATAGGCGCGTCTCCGCAAAAATCGT"
        g = fixtures.build_graph({"mom": [hap]}, 5)
        links = jlk.build_links(g, {"mom": [hap]}, "mom")
        return g, [links], 0, [hap[:5]], 256
    if name == "trio47":
        return (*_trio(47, 47), 1024)
    if name == "hub47":
        return (*_trio(47, 47, spacing=90), 1024)
    if name == "trio55":
        return (*_trio(55, 55), 1024)
    raise KeyError(name)


JAX_CASES = ["cycle", "unlinked", "repeat", "dfs_sink", "trio47", "hub47"]


def _words(strs, k):
    return jkm.pack_codes(jkm.strings_to_codes(strs), k)


def _both_ways(seeds, k):
    return _words(list(seeds) + [jkm.revcomp(s) for s in seeds], k)


def _jax_walker_arrays(g, links, colour):
    """np.asarray of the JAX LinkedWalker's args, and its truncated count."""
    _, jwl = _jax()
    walker = jwl.LinkedWalker(g, [colour], links)
    return [np.asarray(a) for a in walker.args], walker.truncated


def _port(g, links):
    return port_graph(g), [port_links(ld) for ld in links]


def _host_contig(pg, colour, seed, plinks, max_len):
    e = TraversalEngine(TraversalConfig(graph=pg, traversal_colors=[colour],
                                        stopping_rule=ContigStopper, links=list(plinks),
                                        max_branch_length=max_len))
    return to_contig(e.assemble(seed))


def _step_successors(seed, row, successors) -> list:
    """The successor count of the k-mer each step of an emitted row left."""
    out, cur = [], seed
    for v in row:
        out.append(successors(cur))
        if v < 0:
            break
        cur = cur[1:] + "ACGT"[v & 3]
    return out


def _against_host(pg, colour, plinks, walker, seeds, steps, contigs, overflow) -> int:
    """Every walk without overflow: its stream decoded by the host's seen
    rule equals the host engine's contig and the native walker's (walked as
    Partition walks it).  Returns how many of the walker's own contigs
    (decode_linked_walk's rule) differ from them."""
    edges = np.bitwise_or.reduce(pg.edges[:, [colour]], axis=1)

    def successors(kmer):
        rec, flipped = pg.find_record_oriented(kmer)
        return bin(int(edges[rec]) >> 4 if flipped else int(edges[rec]) & 0xF).count("1")

    rows, _, _, _, rc = walker.walk(seeds, steps)
    native = tnat.LinksWalkerNative(pg, [colour], plinks) if tnat.available() else None
    b, differ, checked = len(seeds), 0, 0
    for i, seed in enumerate(seeds):
        if overflow[i]:
            continue
        host = _host_contig(pg, colour, seed, plinks, steps)
        fwd, back = (twl.decode_host_walk(s, row, _step_successors(s, row, successors), steps)
                     for s, row in ((seed, rows[i].tolist()), (rc[i], rows[b + i].tolist())))
        assert (km.revcomp(back) if back else "") + seed + fwd == host, seed
        if native is not None:
            f, _ = native.walk([seed], steps)
            bk, _ = native.walk([rc[i]], steps)
            assert (km.revcomp(bk[0]) if bk[0] else "") + seed + f[0] == host, seed
        differ += contigs[i] != host
        checked += 1
    assert checked
    return differ


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal_walks(got, want):
    for name, a, b in zip(("emitted", "overflow", "steps", "junctions"), got, want):
        np.testing.assert_array_equal(_numpy(a), _numpy(b), err_msg=name)


# ---------------------------------------------------------------------------
# the link CSR
# ---------------------------------------------------------------------------

def _assert_link_arrays(got, want):
    for field in ("offsets", "choices", "lengths", "forward"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.truncated == want.truncated


@pytest.mark.parametrize("name", ["cycle", "repeat", "dfs_sink", "trio47", "unlinked"])
def test_build_link_arrays_matches_jax(name):
    _, jwl = _jax()
    g, links, _, _, _ = case(name)
    pg, plinks = _port(g, links)
    _assert_link_arrays(twl.build_link_arrays(pg, plinks), jwl.build_link_arrays(g, links))


def test_build_link_arrays_counts_truncated_records():
    """Link records of more than MAX_J choices are dropped and counted; a
    file of another sample is skipped; records keyed by a k-mer absent from
    the graph are neither packed nor counted."""
    _, jwl = _jax()
    g, links, _, _ = _trio(47, 47, reads=None)
    want = jwl.build_link_arrays(g, links)
    assert want.truncated > 0 and want.lengths.max() <= twl.MAX_J
    other = jlk.LinksData(sample_name="nobody", kmer_size=47,
                          records=dict(list(links[0].records.items())[:5]))
    stray = jlk.LinksData(sample_name="kid", kmer_size=47,
                          records={"A" * 47: [jlk.JunctionRecord(True, 40, (1,), "A" * 40)]})
    pg, plinks = _port(g, links + [other, stray])
    _assert_link_arrays(twl.build_link_arrays(pg, plinks),
                        jwl.build_link_arrays(g, links + [other, stray]))


def test_build_link_arrays_from_indexed_links(tmp_path):
    """Links from an indexed .ctp.bgz (LinksRandomAccess) give the arrays of
    the in-memory links, in the index's key order."""
    _, jwl = _jax()
    g, links, _, _, _ = case("repeat")
    jlk.write_links_indexed(str(tmp_path / "l.ctp.bgz"), links[0], "test")
    jra = jlk.LinksRandomAccess(str(tmp_path / "l.ctp.bgz"))
    tra = tlk.LinksRandomAccess(str(tmp_path / "l.ctp.bgz"))
    got = twl.build_link_arrays(port_graph(g), [tra])
    _assert_link_arrays(got, jwl.build_link_arrays(g, [jra]))
    assert got.offsets[-1] == sum(len(v) for v in links[0].records.values())


# ---------------------------------------------------------------------------
# the LinkStore steps on seeded states
# ---------------------------------------------------------------------------

def _states(seed, b=64):
    """Seeded LinkStore states: choice words drawn from a small pool (so
    that oldest elements agree and junction lists repeat), ages with ties,
    zero-length and exhausted elements, full stores, both orientations,
    record counts past MAX_ADD."""
    rng = np.random.default_rng(seed)
    cap, jw, ma = twl.CAP, twl.JW, twl.MAX_ADD
    pool = rng.integers(0, 1 << 32, size=(4, jw), dtype=np.uint64).astype(np.uint32)
    el_choices = pool[rng.integers(0, 4, size=(b, cap))]
    el_len = rng.integers(0, 33, size=(b, cap)).astype(np.int32)
    el_pos = np.minimum(rng.integers(0, 33, size=(b, cap)), 31).astype(np.int32)
    el_age = rng.integers(0, 3, size=(b, cap)).astype(np.int32)
    el_valid = rng.random((b, cap)) < rng.random((b, 1))
    el_valid[:4] = True                                  # full stores
    el_seq = rng.integers(0, 4000, size=(b, cap)).astype(np.int32)
    rec_choices = pool[rng.integers(0, 4, size=(b, ma))]
    rec_len = rng.integers(0, 33, size=(b, ma)).astype(np.int32)
    rec_fw = rng.random((b, ma)) < 0.5
    rec_cnt = rng.integers(0, 21, size=b).astype(np.int32)
    return dict(el_choices=el_choices, el_len=el_len, el_pos=el_pos, el_age=el_age,
                el_valid=el_valid, el_seq=el_seq,
                seq_counter=(16 * rng.integers(0, 100, size=b)).astype(np.int32),
                overflow=rng.random(b) < 0.2, active=rng.random(b) < 0.8,
                flipped=rng.random(b) < 0.5, rec_choices=rec_choices, rec_len=rec_len,
                rec_fw=rec_fw, rec_cnt=rec_cnt,
                edge=rng.integers(0, 256, size=b).astype(np.uint32))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype != np.bool_ else a)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_store_add_matches_jax(seed):
    jnp, jwl = _jax()
    s = _states(seed)
    names = ("el_choices", "el_len", "el_pos", "el_age", "el_valid", "el_seq", "seq_counter",
             "overflow", "active", "flipped", "rec_choices", "rec_len", "rec_fw", "rec_cnt")
    want = jwl.store_add(*(jnp.asarray(s[n]) for n in names))
    got = twl.store_add(*(_t(s[n]) for n in names))
    for name, a, b in zip(names[:8], got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype),
                                      err_msg=name)
    overflowed = np.asarray(want[7]) & ~s["overflow"]
    assert overflowed.any() and (s["rec_cnt"] > twl.MAX_ADD).any()


@pytest.mark.parametrize("seed,is_first", [(4, False), (5, False), (6, True)])
def test_store_advance_matches_jax(seed, is_first):
    jnp, jwl = _jax()
    s = _states(seed)
    k = 21
    rng = np.random.default_rng(seed)
    cur = _words(["".join(rng.choice(list("ACGT"), k)) for _ in range(len(s["edge"]))], k)
    names = ("el_choices", "el_len", "el_pos", "el_age", "el_valid", "el_seq")
    want = jwl.store_advance(jnp.asarray(cur), jnp.asarray(s["active"]),
                             *(jnp.asarray(s[n]) for n in names), jnp.asarray(s["edge"]),
                             jnp.asarray(s["flipped"]), is_first, k)
    got = twl.store_advance(_t(cur), _t(s["active"]), *(_t(s[n]) for n in names),
                            _t(s["edge"]), _t(s["flipped"]), is_first, k)
    for name, a, b in zip(("cur", "active", "el_pos", "el_valid", "el_age", "emitted",
                           "take_choice"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype),
                                      err_msg=name)
    if not is_first:
        assert np.asarray(want[6]).any()         # some walks take a link's choice


# ---------------------------------------------------------------------------
# the walk, the twin against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_CASES)
def test_walk_links_forward_matches_jax(name):
    """The JAX package's buckets and link arrays (as numpy), and the port's
    own cuckoo table and CSR, both give the JAX walk bit for bit."""
    jnp, jwl = _jax()
    g, links, colour, seeds, steps = case(name)
    k = g.kmer_size
    arrays, _ = _jax_walker_arrays(g, links, colour)
    words = _both_ways(seeds, k)
    want = jwl.walk_links_forward(*(jnp.asarray(a) for a in arrays), jnp.asarray(words), k,
                                  steps)
    _equal_walks(twl.walk_links_forward(*arrays, words, k, steps, device="cpu"), want)
    pg, plinks = _port(g, links)
    own = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    np.testing.assert_array_equal(own.args[0].numpy().view(np.uint32).reshape(arrays[0].shape),
                                  arrays[0])
    _equal_walks(twl.walk_links_forward(*own.args, words, k, steps), want)
    if name in ("trio47", "hub47"):
        assert np.asarray(want[3]).sum() > 0
        assert np.asarray(want[1]).any() == (name == "hub47")


def test_walk_at_w4_matches_jax_and_the_host_engine():
    """k = 55 (W = 4): the twin equals the JAX walk, and each walk without
    overflow decodes to the port's host engine's and native walker's
    contig."""
    jnp, jwl = _jax()
    g, links, colour, seeds, steps = case("trio55")
    k = g.kmer_size
    arrays, _ = _jax_walker_arrays(g, links, colour)
    words = _both_ways(seeds, k)
    want = jwl.walk_links_forward(*(jnp.asarray(a) for a in arrays), jnp.asarray(words), k,
                                  steps)
    _equal_walks(twl.walk_links_forward(*arrays, words, k, steps, device="cpu"), want)
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    contigs, overflow, junctions = walker.assemble(seeds, steps)
    assert not overflow.any() and junctions.sum() > 0
    assert _against_host(pg, colour, plinks, walker, seeds, steps, contigs, overflow) == 0


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_CASES)
def test_linked_walker_matches_jax_and_host_walkers(name):
    """assemble and walk_split equal the JAX LinkedWalker's; every walk
    without overflow, decoded by the host's seen rule, also equals the port's
    host engine and its native walker (walked as Partition walks it)."""
    _, jwl = _jax()
    g, links, colour, seeds, steps = case(name)
    jw = jwl.LinkedWalker(g, [colour], links)
    pg, plinks = _port(g, links)
    tw = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    assert tw.truncated == jw.truncated
    want = jw.assemble(seeds, steps)
    got = tw.assemble(seeds, steps)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    want_split = jw.walk_split(seeds, steps, max_branch=steps // 2)
    got_split = tw.walk_split(seeds, steps, max_branch=steps // 2)
    assert got_split[:2] == want_split[:2]
    np.testing.assert_array_equal(got_split[2], want_split[2])
    np.testing.assert_array_equal(got_split[3], want_split[3])

    differ = _against_host(pg, colour, plinks, tw, seeds, steps, got[0], got[1])
    # decode_linked_walk's seen rule (ROADMAP §3) shortens 10 of trio47's 93
    # contigs by a base or more; the streams themselves are the host's
    assert differ == (10 if name == "trio47" else 0)


def test_truncated_link_records_are_not_flagged():
    """ROADMAP §3: link records of more than MAX_J choices are dropped (and
    counted in `truncated`) but no walk is flagged for them, so a walk
    without overflow can end where the host engine, which keeps them,
    walks on."""
    g, links, colour, seeds = _trio(47, 47, reads=None)
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    assert walker.truncated > 0
    seeds = seeds[:24]
    contigs, overflow, _ = walker.assemble(seeds, 2048)
    differ = [c != _host_contig(pg, colour, s, plinks, 2048)
              for s, c, ov in zip(seeds, contigs, overflow) if not ov]
    assert any(differ) and not all(differ)


def test_links_gate_on_every_graph_sample():
    """ROADMAP §3: LinkedWalker takes the links files of every sample of the
    graph (as the JAX package's build_link_arrays does); the host engine and
    the native walker take only the walk colours' samples.  The kid walks
    the Fig-1 cycle with only the mother's links: resolved here, not there."""
    hap = "ACTGATTTCGATGCGATGCGATGCCACGGTGG"
    g = fixtures.build_graph({"mom": [hap], "kid": [hap]}, 5)
    links = [jlk.build_links(g, {"mom": ["TTTCGATGCGATGCGATGCCACG"]}, "mom")]
    pg, plinks = _port(g, links)
    kid = pg.color_for_sample("kid")
    contigs, overflow = twl.assemble_batch_links(pg, [kid], plinks, ["ACTGA"], 128,
                                                 device="cpu")
    assert contigs == [hap] and not overflow[0]
    host = _host_contig(pg, kid, "ACTGA", plinks, 128)
    native = tnat.LinksWalkerNative(pg, [kid], plinks).walk(["ACTGA"], 128)[0][0]
    assert host == "ACTGA" + native and len(host) < len(hap)


# (case, the k-mer of a link record, its choices): a second record beside it
SAME_WORDS = [("cycle", "ATGCG", "CA"), ("repeat", "AAGGGCATGCC", "GC")]


@pytest.mark.parametrize("name,kmer,choices", SAME_WORDS, ids=[c[0] for c in SAME_WORDS])
def test_link_records_of_equal_words_and_other_lengths(name, kmer, choices):
    """ROADMAP §3's same_list rider: beside a link record, a second one at
    the same k-mer and orientation whose choices add a trailing A ("CA" and
    "CAA", as "AC" and "ACA"): their choice words are equal and their
    lengths differ, so store_add's same_list
    (corticall_tpu/ops/walk_links.py:158) takes them for one junction list
    where the host engine keeps two.  walk_links_forward, LinkedWalker and
    the sharded linked walk (two CPU shards) equal the JAX walker bit for
    bit, the pair's k-mer walked both ways.  Recorded: here the host engine
    and LinksWalkerNative give the JAX walker's contigs too (the two records
    agree on every junction the walks reach while both are in the store).
    The JAX behaviour is kept."""
    jnp, jwl = _jax()
    from corticall_tpu.io.links import JunctionRecord
    from corticall_tpu_torch.parallel import mesh as tpm
    g, links, colour, seeds, steps = case(name)
    records = links[0].records
    jr = next(j for j in records[kmer] if j.choices == choices)
    records[kmer] = records[kmer] + [JunctionRecord(jr.forward, len(choices) + 1, jr.coverages,
                                                    choices + "A")]
    seeds = list(seeds) + [kmer]
    k = g.kmer_size
    arrays, _ = _jax_walker_arrays(g, links, colour)
    rec = g.find_record(kmer)
    rows = np.arange(arrays[2][rec], arrays[2][rec + 1])
    pair = rows[np.isin(arrays[4][rows], (len(choices), len(choices) + 1))]
    assert len(pair) == 2 and (arrays[3][pair[0]] == arrays[3][pair[1]]).all()

    words = _both_ways(seeds, k)
    want = jwl.walk_links_forward(*(jnp.asarray(a) for a in arrays), jnp.asarray(words), k,
                                  steps)
    _equal_walks(twl.walk_links_forward(*arrays, words, k, steps, device="cpu"), want)
    pg, plinks = _port(g, links)
    want_contigs = jwl.LinkedWalker(g, [colour], links).assemble(seeds, steps)
    got = twl.LinkedWalker(pg, [colour], plinks, device="cpu").assemble(seeds, steps)
    assert got[0] == want_contigs[0]
    for a, b in zip(got[1:], want_contigs[1:]):
        np.testing.assert_array_equal(a, b)
    mesh = tpm.ShardMesh(["cpu"] * 2)
    sg = tpm.ShardedGraph.from_graph(pg, mesh)
    sl = tpm.ShardedLinks.from_graph(pg, plinks, sg)
    sharded = tpm.make_sharded_linked_walk_run(mesh, sg, sl, [colour], k, steps)(
        words, np.ones(len(words), bool))
    for a, b in zip(sharded, (want[0], want[1], want[3])):
        np.testing.assert_array_equal(_numpy(a), _numpy(b))
    assert int(np.asarray(want[3]).sum()) > 0 and not np.asarray(want[1]).any()

    native = tnat.LinksWalkerNative(pg, [colour], plinks) if tnat.available() else None
    for seed, contig in zip(seeds, want_contigs[0]):
        assert kmer in contig or km.revcomp(kmer) in contig
        assert _host_contig(pg, colour, seed, plinks, steps) == contig
        if native is not None:
            fwd, _ = native.walk([seed], steps)
            back, _ = native.walk([km.revcomp(seed)], steps)
            assert (km.revcomp(back[0]) if back[0] else "") + seed + fwd[0] == contig


def test_linked_walker_from_jax_arrays():
    _, jwl = _jax()
    g, links, colour, seeds, steps = case("repeat")
    arrays, truncated = _jax_walker_arrays(g, links, colour)
    tw = twl.LinkedWalker.from_arrays(g.kmer_size, *arrays, truncated=truncated, device="cpu")
    assert tw.assemble(seeds, steps)[0] == jwl.LinkedWalker(g, [colour], links).assemble(
        seeds, steps)[0]


def test_assemble_batch_links_cycle():
    """test_walk_links.py's McCortex Fig-1 cycle, resolved only by links."""
    g, links, colour, seeds, steps = case("cycle")
    pg, plinks = _port(g, links)
    contigs, overflow = twl.assemble_batch_links(pg, [colour], plinks, seeds, steps,
                                                 device="cpu")
    assert not overflow[0]
    assert contigs == ["ACTGATTTCGATGCGATGCGATGCCACGGTGG"]


def test_decode_linked_walk_matches_jax():
    _, jwl = _jax()
    rng = np.random.default_rng(3)
    for _ in range(20):
        emitted = rng.integers(0, 16, size=200).astype(np.int8)
        emitted[rng.integers(50, 200):] = -1
        emitted[rng.random(200) < 0.3] &= 3        # an inactive store: revisits stop
        seed = "".join(rng.choice(list("AC"), 6))
        for mb in (10, 1000):
            assert twl.decode_linked_walk(seed, emitted, mb) == \
                jwl.decode_linked_walk(seed, emitted, mb)


# ---------------------------------------------------------------------------
# stopping early, and devices
# ---------------------------------------------------------------------------

def _stop_case():
    """A linear genome whose last k-mer (a dead end) and a junction k-mer
    carry 20 link records each, of both orientations and of zero length, and
    seeds that stop there, on the seed step and later."""
    rng = np.random.default_rng(8)
    k = 9
    genome = _genome(rng, 200)
    branch = genome[100:100 + k - 1] + "ACGT"[("ACGT".index(genome[100 + k - 1]) + 1) % 4] \
        + _genome(rng, 30)
    g = fixtures.build_graph({"s": [genome, branch]}, k)
    _, jwl = _jax()
    base = jwl.LinkedWalker(g, [0], [])
    n = g.num_records
    heavy = {g.find_record(genome[-k:]), g.find_record(genome[100 - 1:100 - 1 + k])}
    counts = np.zeros(n, dtype=np.int64)
    for r in heavy:
        counts[r] = 20
    offsets = np.zeros(n + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(counts)
    p = int(offsets[-1])
    choices = rng.integers(0, 1 << 32, size=(p, twl.JW), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, 6, size=p).astype(np.int32)
    forward = rng.random(p) < 0.5
    arrays = [np.asarray(base.args[0]), np.asarray(base.args[1]), offsets, choices, lengths,
              forward]
    seeds = [genome[-k:], genome[-k - 5:-5], genome[90:90 + k], genome[100:100 + k],
             branch[:k]]
    return g, arrays, seeds


def test_walks_that_stop_early_match_jax():
    """A walk that stops on a k-mer with more than MAX_ADD link records sets
    overflow and emits -1 for good, and one that stops on its seed step
    emits nothing: the twin leaves its loop when every walk has stopped, the
    JAX walk runs every step, and the outputs are the same."""
    jnp, jwl = _jax()
    g, arrays, seeds = _stop_case()
    k = g.kmer_size
    words = _both_ways(seeds, k)
    want = jwl.walk_links_forward(*(jnp.asarray(a) for a in arrays), jnp.asarray(words), k, 256)
    got = twl.walk_links_forward(*arrays, words, k, 256, device="cpu")
    _equal_walks(got, want)
    steps, overflow = got[2].numpy(), got[1].numpy()
    assert steps[0] == 0 and overflow[0]          # the dead end with 20 records, at the seed
    assert steps[1] == 5 and overflow[1]          # reaches it after 5 steps
    assert (steps < 256).all()                    # so the twin left its loop early


def test_twin_store_sizes_follow_its_stream():
    """The twin's `store_sizes` (the valid elements after each step) leave
    its outputs as they are, reach CAP where walks fill their store, and
    are non-zero exactly where an emitted base carries store_active."""
    g, links, colour, seeds, steps = case("hub47")
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    words = torch.from_numpy(_both_ways(seeds, g.kmer_size).view(np.int32))
    sizes = torch.full((steps, words.shape[0]), -1, dtype=torch.int8)
    got = twl.walk_links_forward_plain(*walker.args, words, g.kmer_size, steps,
                                       store_sizes=sizes)
    _equal_walks(got, twl.walk_links_forward(*walker.args, words, g.kmer_size, steps))
    emitted, sizes = got[0].numpy(), sizes.numpy()
    ran = (sizes >= 0).all(1)
    assert ran[0] and sizes.max() == twl.CAP and got[1].any()
    assert (sizes[ran] <= twl.CAP).all() and (sizes[~ran] == -1).all()
    moved = emitted >= 0
    np.testing.assert_array_equal((emitted[moved] & 8) != 0, sizes[moved] > 0)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    g, links, colour, seeds, _ = case("cycle")
    pg, plinks = _port(g, links)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twl.LinkedWalker(pg, [colour], plinks)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twl.assemble_batch_links(pg, [colour], plinks, seeds, 16)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    arrays = [x.numpy() for x in walker.args]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twl.walk_links_forward(*arrays, _words(seeds, 5), 5, 16)


def test_walk_refuses_bad_inputs():
    g, links, colour, seeds, _ = case("cycle")
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    words = torch.from_numpy(_words(seeds, 5).view(np.int32))
    with pytest.raises(ValueError):
        twl.walk_links_forward(*walker.args, words, 21, 16)        # W does not fit k
    with pytest.raises(ValueError):
        twl.walk_links_forward(*walker.args[:4], walker.args[4][:0], walker.args[5][:0], words,
                               5, 16)                              # an empty link pool
    with pytest.raises(ValueError):
        twl.walk_links_forward(*walker.args, words, 5, -1)


def _walk_words_want(walker, words, steps):
    """What walk_words must return: the plain twin's outputs on the walker's
    tables, emitted as [B, T]."""
    seeds = torch.from_numpy(words.view(np.int32)).to(walker.device)
    emitted, *lane = twl.walk_links_forward_plain(*walker.args, seeds, walker.k, steps)
    return [x.cpu().numpy() for x in (emitted.t(), *lane)]


WALK_WORDS_DTYPES = (np.int8, np.bool_, np.int32, np.int32)


def test_walk_words_on_the_cpu_takes_no_pinned_route():
    """On the CPU walk_words returns the twin's arrays as views, in the
    dtypes callers take, and copies nothing into pinned memory."""
    g, links, colour, seeds, _ = case("repeat")
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    words = _both_ways(seeds, g.kmer_size)
    before = dict(twl.LAUNCHES)
    got = walker.walk_words(words, 77)
    assert twl.LAUNCHES == before
    assert [x.dtype for x in got] == list(WALK_WORDS_DTYPES)
    assert got[0].shape == (len(words), 77) and got[2].shape == (len(words),)
    _equal_walks(got, _walk_words_want(walker, words, 77))
    assert int(got[2].sum()) > 0


# ---------------------------------------------------------------------------
# the kernel against the twin (a card only)
# ---------------------------------------------------------------------------

def _kernel_vs_twin(arrays, seeds_words, k, steps, dev):
    """Both on the card; every output of the kernel's run equal to the twin's
    (the stream's padding too: -1 past the walk)."""
    before = twl.LAUNCHES["link_walk"]
    got = twl.walk_links_forward(*arrays, seeds_words, k, steps, device=dev)
    torch.cuda.synchronize()
    assert twl.LAUNCHES["link_walk"] == before + 1
    assert got[0].shape == (steps, seeds_words.shape[0])
    args = (*twl.link_tables(*arrays, k, dev),
            torch.from_numpy(seeds_words.view(np.int32)).to(dev))
    want = twl.walk_links_forward_plain(*args, k, steps)
    _equal_walks(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", JAX_CASES + ["trio55"])
def test_kernel_matches_twin(cuda, name):
    g, links, colour, seeds, steps = case(name)
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device=cuda)
    got = _kernel_vs_twin(walker.args, _both_ways(seeds, g.kmer_size), g.kmer_size, steps, cuda)
    assert int(got[2].sum()) > 0


@pytest.mark.cuda
def test_kernel_stops_early_like_twin(cuda):
    g, arrays, seeds = _stop_case()
    got = _kernel_vs_twin(arrays, _both_ways(seeds, g.kmer_size), g.kmer_size, 256, cuda)
    assert got[1].cpu().numpy()[0] and got[2].cpu().numpy()[0] == 0


def _graph_100k(rng, k=31):
    """A 100k-record graph whose genome repeats an 80-base unit every 400
    bases, with links threaded from 2 kbp reads: (port graph, port links,
    genome)."""
    genome = _genome(rng, 100_000)
    unit = _genome(rng, 80)
    pieces = [genome[i:i + 400] for i in range(0, len(genome), 400)]
    genome = unit.join(pieces)
    g = fixtures.build_graph({"s": [genome]}, k)
    assert g.num_records >= 100_000
    reads = [genome[i:i + 2000] for i in range(0, len(genome) - 2000, 1000)]
    links = jlk.build_links(g, {"s": reads}, "s")
    return (*_port(g, [links]), genome)


@pytest.mark.cuda
def test_kernel_at_100k_records(cuda):
    """A 100k-record graph with threaded links, 4,096 lanes x 1,024 steps."""
    rng = np.random.default_rng(100)
    k = 31
    pg, plinks, genome = _graph_100k(rng, k)
    walker = twl.LinkedWalker(pg, [0], plinks, device=cuda)
    idx = rng.integers(0, len(genome) - k, 2048)
    seeds = [genome[i:i + k] for i in idx]
    got = _kernel_vs_twin(walker.args, _both_ways(seeds, k), k, 1024, cuda)
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
def test_kernel_at_the_roi_batch(cuda):
    """The ROI walks' batch of chip_smoke.py's phase 11 (1,406 seeds both
    ways: 2,812 walks, 88 warps in 32-thread blocks) at Partition's 2,000
    steps, on the 100k-record graph."""
    rng = np.random.default_rng(101)
    k = 31
    pg, plinks, genome = _graph_100k(rng, k)
    walker = twl.LinkedWalker(pg, [0], plinks, device=cuda)
    seeds = [genome[i:i + k] for i in rng.integers(0, len(genome) - k, 1406)]
    got = _kernel_vs_twin(walker.args, _both_ways(seeds, k), k, 2000, cuda)
    assert got[0].shape == (2000, 2812) and int(got[3].sum()) > 0


# ---------------------------------------------------------------------------
# the kernel's lanes: needy and idle walks in one warp, at each width
# ---------------------------------------------------------------------------

WIDTHS = [15, 31, 47, 63]                  # k at W = 1, 2, 3, 4


def width_case(k):
    """A trio at k whose child has a hub every 90 bases, the child's links
    threaded from its reads, its seeds both ways cut to a batch that is not
    a multiple of 32: (walker arrays on the CPU, seed words, steps)."""
    g, links, colour, seeds = _trio(k, k, spacing=90)
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    words = _both_ways(seeds, k)
    return walker.args, words[:len(words) - 3], 512


@pytest.mark.parametrize("k", WIDTHS)
def test_width_cases_mix_needy_and_idle_lanes(k):
    """The inputs of test_kernel_at_each_width hold what the kernel's lanes
    must get right: a warp whose active walks are needy and idle at one
    step, walks that end at different steps inside one warp, overflow, and
    a ragged last warp."""
    arrays, words, steps = width_case(k)
    b = words.shape[0]
    mixed = []

    def trace(t, rec):
        active, needy = rec["active"], rec["needy"]
        pad = (-b) % 32
        act = torch.cat([active, torch.zeros(pad, dtype=torch.bool)]).view(-1, 32)
        nd = torch.cat([needy & active, torch.zeros(pad, dtype=torch.bool)]).view(-1, 32)
        mixed.append(int((nd.any(1) & (act & ~nd).any(1)).sum()))

    seeds = torch.from_numpy(words.view(np.int32))
    emitted, overflow, walked, _ = twl.walk_links_forward_plain(*arrays, seeds, k, steps,
                                                                trace=trace)
    assert b % 32 and sum(mixed) > 0 and overflow.any()
    ends = torch.cat([walked, walked[-1:].expand((-b) % 32)]).view(-1, 32)
    assert int((ends.amax(1) > ends.amin(1)).sum()) > 0


def two_entry_case():
    """hub47's walks (256 steps) over a cuckoo table of 2-entry buckets,
    which takes the kernel's word-at-a-time lookup: (arrays on the CPU,
    seed words, k, steps)."""
    from corticall_tpu_torch.ops import cuckoo as tck
    g, links, colour, seeds, _ = case("hub47")
    steps = 256
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    table = tck.build_cuckoo(pg.kmers, np.arange(pg.num_records, dtype=np.uint32) + 1,
                             bucket_size=2, device="cpu")
    assert table.buckets.shape[1] == 2
    return (table.buckets, *walker.args[1:]), _both_ways(seeds, g.kmer_size), g.kmer_size, steps


def test_two_entry_buckets_walk_as_four():
    """The twin gives the same walks over 2-entry and 4-entry buckets (the
    payload of a k-mer does not depend on the table's shape)."""
    arrays, words, k, steps = two_entry_case()
    g, links, colour, _, _ = case("hub47")
    pg, plinks = _port(g, links)
    four = twl.LinkedWalker(pg, [colour], plinks, device="cpu").args
    _equal_walks(twl.walk_links_forward(*arrays, words, k, steps, device="cpu"),
                 twl.walk_links_forward(*four, words, k, steps, device="cpu"))


@pytest.mark.cuda
def test_kernel_on_two_entry_buckets(cuda):
    arrays, words, k, steps = two_entry_case()
    got = _kernel_vs_twin([a.to(cuda) for a in arrays], words, k, steps, cuda)
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", WIDTHS)
def test_kernel_at_each_width(cuda, k):
    arrays, words, steps = width_case(k)
    got = _kernel_vs_twin([a.to(cuda) for a in arrays], words, k, steps, cuda)
    assert int(got[3].sum()) > 0 and bool(got[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("steps, lanes", [(1000, None), (0, None), (77, 0)])
def test_walk_words_on_the_card_equals_the_twin(cuda, steps, lanes):
    """walk_words' pinned route: the four arrays bit for bit the twin's, C-
    contiguous numpy in the dtypes callers take, one pinned copy a call; at
    a num_steps off the 32-byte pitch (the padding dropped), at none, and
    with no seeds."""
    g, links, colour, seeds, _ = case("trio47")
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device=cuda)
    words = _both_ways(seeds, g.kmer_size)[:lanes]
    before = twl.LAUNCHES["link_walk_copy"]
    got = walker.walk_words(words, steps)
    assert twl.LAUNCHES["link_walk_copy"] == before + 1
    assert [x.dtype for x in got] == list(WALK_WORDS_DTYPES)
    assert all(isinstance(x, np.ndarray) and x.flags.c_contiguous for x in got)
    assert got[0].shape == (len(words), steps)
    _equal_walks(got, _walk_words_want(walker, words, steps))


@pytest.mark.cuda
def test_walk_words_arrays_outlive_later_calls(cuda):
    """A call's arrays stay the caller's own: a later call on other seeds,
    once the first call's host memory could be reused, leaves them as they
    were."""
    g, links, colour, seeds, steps = case("trio47")
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device=cuda)
    words = _both_ways(seeds, g.kmer_size)
    first = walker.walk_words(words, steps)
    kept = [x.copy() for x in first]
    assert not np.array_equal(kept[0], kept[0][::-1])     # the later calls' rows differ
    for _ in range(2):
        later = walker.walk_words(words[::-1].copy(), steps)
        _equal_walks(later, [x[::-1] for x in kept])
        del later
    _equal_walks(first, kept)
