"""The port's hash-sharded graph (corticall_tpu_torch/parallel/mesh.py and
ops/sharding.py) against corticall_tpu/parallel/mesh.py.

The JAX package runs on the virtual 8-device CPU mesh of tests/conftest.py;
the port on a ShardMesh of ["cpu"] * n, where every wrapper runs its plain
twin.  The same graphs (through the .ctx bytes), links, seeds and queries go
to both: shard tables and link arrays, single steps (balanced and skewed),
FindROIs, multi-step and linked walks, and the sharded Call's VCF bytes must
be equal; each twin is held against the JAX expression it replaces, on the
states of a sharded run.  Everything is integer or string: every comparison
is exact.  The `cuda` tests replay the twins' recorded calls through the
kernels on a card."""

import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import fixtures, kmer as jkm  # noqa: E402
from corticall_tpu.io import links as jlk  # noqa: E402
from corticall_tpu_torch.ops import sharding as sh  # noqa: E402
from corticall_tpu_torch.parallel import mesh as tpm  # noqa: E402
from test_torch_host import port_graph, port_links  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The twins run many small ops a step: one thread is faster and leaves
    the other test workers alone."""
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
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh
    from corticall_tpu.parallel import mesh as jpm
    return jax, Mesh, jpm


def _jmesh(n):
    jax, Mesh, jpm = _jax()
    if len(jax.devices()) < n:
        pytest.skip("not enough JAX devices")
    return Mesh(np.array(jax.devices()[:n]), (jpm.AXIS,))


def _graph(k=17, n=3000, seed=3):
    """test_mesh.py's graph: a genome in colour 0, its first half in 1."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), n))
    return fixtures.build_graph({"a": [genome], "b": [genome[: n // 2]]}, k), genome


def _trio(k=17, seed=1):
    """test_mesh.py's trio: a genome with a 40-base repeat, the child with 6
    substitutions, the child's links threaded from its haplotype."""
    rng = np.random.default_rng(seed)
    core_seq = "".join(rng.choice(list("ACGT"), 2400))
    genome = core_seq[:1200] + core_seq[300:340] + core_seq[1200:]
    child = list(genome)
    for pos in rng.integers(k, len(child) - k, size=6):
        child[pos] = "ACGT"[(ord(child[pos]) + 1) % 4]
    child = "".join(child)
    g = fixtures.build_graph({"kid": [child], "mom": [genome], "dad": [genome]}, k)
    return g, jlk.build_links(g, {"kid": [child]}, "kid"), genome


def _rois(g):
    from corticall_tpu.commands import core
    return core.find_rois(g, "kid", ["mom", "dad"])


def _sorted_roi_strings(g):
    rois = _rois(g)
    return sorted(rois.kmer_string(i) for i in range(rois.num_records))


def _port(g, n):
    pg = port_graph(g)
    mesh = tpm.ShardMesh(["cpu"] * n)
    return pg, mesh, tpm.ShardedGraph.from_graph(pg, mesh)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _words(strs, k):
    return jkm.pack_codes(jkm.strings_to_codes(strs), k)


# ---------------------------------------------------------------------------
# the mesh, the routing hash, the shard tables and the link arrays
# ---------------------------------------------------------------------------

def test_mesh_devices_and_the_card_rule(monkeypatch):
    mesh = tpm.ShardMesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.devices == [torch.device("cpu")] * 3
    assert tpm.AXIS == "shards"
    with pytest.raises(ValueError):
        tpm.ShardMesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tpm.ShardMesh()


def test_routing_hash_matches_jax():
    _, _, jpm = _jax()
    import jax.numpy as jnp
    words = np.random.default_rng(0).integers(0, 1 << 32, (500, 3), dtype=np.uint64)
    words = words.astype(np.uint32)
    want = np.asarray(jpm.routing_hash_np(words))
    np.testing.assert_array_equal(tpm.routing_hash_np(words), want)
    np.testing.assert_array_equal(np.asarray(jpm.routing_hash(jnp.asarray(words))), want)
    got = tpm.routing_hash(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert (want >= 1 << 31).any()            # the unsigned modulo matters at n = 3
    np.testing.assert_array_equal(tpm.shard_of(words, 3), (want % np.uint32(3)).astype(np.int64))


def _graph_without_last_shard(n, k=17, count=400, seed=4):
    """A graph of `count` random k-mers (one read each), none of which the
    routing hash sends to shard n - 1."""
    rng = np.random.default_rng(seed)
    reads = []
    while len(reads) < count:
        s = "".join(rng.choice(list("ACGT"), k))
        canon = min(s, jkm.revcomp(s))
        if tpm.shard_of(_words([canon], k), n)[0] != n - 1:
            reads.append(s)
    return fixtures.build_graph({"a": reads, "b": reads[::3]}, k)


TABLE_CASES = [(1, False), (3, False), (4, False), (3, True), (4, True)]


@pytest.mark.parametrize("n,empty_last", TABLE_CASES,
                         ids=[f"n{n}{'-empty' if e else ''}" for n, e in TABLE_CASES])
def test_shard_tables_and_link_arrays_match_jax(n, empty_last):
    _, _, jpm = _jax()
    if empty_last:
        g, links = _graph_without_last_shard(n), []
    else:
        g, link, _ = _trio()
        links = [link]
    jsg = jpm.ShardedGraph.from_graph(g, n)
    pg, mesh, sg = _port(g, n)
    np.testing.assert_array_equal(sg.counts, jsg.counts)
    assert sg.counts.sum() == g.num_records and sg.num_shards == n
    assert (sg.counts[-1] == 0) == empty_last
    seen = []
    for s in range(n):
        c = int(jsg.counts[s])
        np.testing.assert_array_equal(_np(sg.kmers[s]).view(np.uint32), np.asarray(jsg.kmers[s])[:c])
        np.testing.assert_array_equal(_np(sg.edges[s]), np.asarray(jsg.edges[s])[:c])
        np.testing.assert_array_equal(_np(sg.coverages[s]).view(np.uint32),
                                      np.asarray(jsg.coverages[s])[:c])
        nb = sg.buckets[s].shape[0]
        np.testing.assert_array_equal(_np(sg.buckets[s]).view(np.uint32).reshape(nb, -1),
                                      np.asarray(jsg.buckets[s]))
        np.testing.assert_array_equal(pg.kmers[sg.records[s]], _np(sg.kmers[s]).view(np.uint32))
        seen.append(sg.records[s])
    assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(g.num_records))

    jsl = jpm.ShardedLinks.from_graph(g, links, n, n_max=jsg.kmers.shape[1])
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(ld) for ld in links], sg)
    assert sl.truncated == jsl.truncated
    for s in range(n):
        c = int(sg.counts[s])
        offs = _np(sl.offsets[s])
        rows = int(offs[-1])
        np.testing.assert_array_equal(offs, np.asarray(jsl.offsets[s])[:c + 1])
        assert (np.asarray(jsl.offsets[s])[c:] == rows).all()
        assert sl.lengths[s].shape[0] == max(rows, 1)
        for got, want in ((_np(sl.choices[s]).view(np.uint32), jsl.choices[s]),
                          (_np(sl.lengths[s]), jsl.lengths[s]),
                          (_np(sl.forward[s]).astype(bool), jsl.forward[s])):
            want = np.asarray(want)
            np.testing.assert_array_equal(got[:rows], want[:rows])
            assert not want[rows:].any() and not got[rows:].any()
    if not empty_last:
        assert sum(int(_np(o)[-1]) for o in sl.offsets) > 0


# ---------------------------------------------------------------------------
# the twins against the JAX expressions they replace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 8])
def test_route_twin_matches_jax(n):
    """canonicalize_words, the owner and the argsort packing of
    _routed_exchange (mesh.py:111-118); inactive queries are not sent."""
    _, _, jpm = _jax()
    import jax.numpy as jnp
    from corticall_tpu.ops import kmer_jax as kj
    k = 31
    rng = np.random.default_rng(n)
    cur = rng.integers(0, 1 << 32, (300, 2), dtype=np.uint64).astype(np.uint32)
    cur[:, 0] &= np.uint32((1 << 30) - 1)
    canon, flipped = kj.canonicalize_words(jnp.asarray(cur), k)
    owner = np.asarray(jpm.routing_hash(canon) % jnp.uint32(n)).astype(np.int64)
    order = np.asarray(jnp.argsort(jnp.asarray(owner)))
    got = sh.route(torch.from_numpy(cur.view(np.int32)), None, k, n)
    np.testing.assert_array_equal(_np(got.owner), owner)
    np.testing.assert_array_equal(_np(got.flipped).astype(bool), np.asarray(flipped))
    np.testing.assert_array_equal(_np(got.counts), np.bincount(owner, minlength=n))
    np.testing.assert_array_equal(_np(got.send).view(np.uint32), np.asarray(canon)[order])
    sent, _, _, _ = sh.route_by_query(got)
    np.testing.assert_array_equal(_np(sent).view(np.uint32), np.asarray(canon))

    active = rng.random(300) < 0.6
    part = sh.route(torch.from_numpy(cur.view(np.int32)),
                    torch.from_numpy(active.astype(np.uint8)), k, n)
    np.testing.assert_array_equal(_np(part.counts), np.bincount(owner[active], minlength=n))
    assert (_np(part.slot)[~active] == -1).all()
    sent, _, _, _ = sh.route_by_query(part)
    np.testing.assert_array_equal(_np(sent).view(np.uint32)[active], np.asarray(canon)[active])


def _jax_payload(jsg, jsl, s, colors, idx):
    """mesh.py:278-292's payload on shard s of the JAX arrays."""
    import jax.numpy as jnp
    from corticall_tpu.ops import walk_links as jwl
    edges_s, loff, lch, llen, lfw = (jsg.edges[s], jsl.offsets[s], jsl.choices[s],
                                     jsl.lengths[s], jsl.forward[s])
    e = edges_s[jnp.maximum(idx, 0)][:, colors]
    edge = e[:, 0]
    for i in range(1, len(colors)):
        edge = edge | e[:, i]
    edge = jnp.where(idx >= 0, edge, 0).astype(jnp.uint8)
    off = jnp.where(idx >= 0, loff[jnp.maximum(idx, 0)], 0)
    cnt = jnp.where(idx >= 0, loff[jnp.maximum(idx, 0) + 1] - off, 0)
    jj = jnp.arange(jwl.MAX_ADD)[None, :]
    src = jnp.minimum(off[:, None] + jj, lch.shape[0] - 1)
    return [np.asarray(x) for x in (edge, lch[src], llen[src], lfw[src], cnt)]


def test_shard_answer_twin_matches_jax():
    """The local answer (mesh.py:180-185, :205-209): cuckoo.lookup_payload,
    the combined edge byte and the link rows, on every record of each shard
    and as many misses; rows past the count are zero in the port."""
    _, _, jpm = _jax()
    import jax.numpy as jnp
    from corticall_tpu.ops import cuckoo as jck
    g, links, _ = _trio()
    n, colors = 3, [0, 2]
    jsg = jpm.ShardedGraph.from_graph(g, n)
    jsl = jpm.ShardedLinks.from_graph(g, [links], n, n_max=jsg.kmers.shape[1])
    pg, mesh, sg = _port(g, n)
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    w = g.kmers.shape[1]
    for s in range(n):
        own = pg.kmers[sg.records[s]]
        miss = own.copy()
        miss[:, -1] ^= np.uint32(4)
        queries = np.resize(np.concatenate([own, miss, pg.kmers[:50]]),
                            (2 * int(sg.counts.max()) + 50, w))   # one shape: one JAX compile
        idx = np.asarray(jck.lookup_payload(jsg.buckets[s], jnp.asarray(queries), w)).astype(
            np.int64) - 1
        edge, ch, ln, fw, cnt = _jax_payload(jsg, jsl, s, colors, jnp.asarray(idx, jnp.int32))
        ans = _np(sh.shard_answer(torch.from_numpy(queries.view(np.int32)), sg.buckets[s],
                                  sg.edges[s], colors, sl.csr(s)))
        assert (idx[:len(own)] == np.arange(len(own))).all()
        np.testing.assert_array_equal(ans[:, sh.ANS_REC], idx)
        np.testing.assert_array_equal(ans[:, sh.ANS_EDGE], edge)
        np.testing.assert_array_equal(ans[:, sh.ANS_CNT], cnt)
        take = np.arange(16)[None, :] < np.minimum(cnt, 16)[:, None]
        got_ch = ans[:, sh.ANS_CHOICES:sh.ANS_LEN].reshape(-1, 16, 2).view(np.uint32)
        np.testing.assert_array_equal(got_ch[take], ch[take])
        np.testing.assert_array_equal(ans[:, sh.ANS_LEN:sh.ANS_FW][take], ln[take])
        np.testing.assert_array_equal(ans[:, sh.ANS_FW:][take].astype(bool), fw[take])
        assert not got_ch[~take].any() and not ans[:, sh.ANS_LEN:][np.tile(~take, 2)].any()
        walk = _np(sh.shard_answer(torch.from_numpy(queries.view(np.int32)), sg.buckets[s],
                                   sg.edges[s], colors))
        np.testing.assert_array_equal(walk, ans[:, :sh.WALK_ANSWER])


def _recording(monkeypatch, names):
    """Wrap the sharding wrappers `names` to record each call's inputs
    (cloned before the call) and its outputs: [(name, args, result)]."""
    calls = []

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (sh.WalkState, sh.LinkState)):
            return type(x)(*(clone(v) for v in vars(x).values()))
        if isinstance(x, tuple):
            return type(x)(*(clone(v) for v in x)) if hasattr(x, "_fields") else \
                tuple(clone(v) for v in x)
        if isinstance(x, list):
            return [clone(v) for v in x]
        return x

    for name in names:
        real = getattr(sh, name)

        def wrapped(*args, _real=real, _name=name):
            before = clone(args)
            out = _real(*args)
            calls.append((_name, before, clone(out), clone(args)))
            return out
        monkeypatch.setattr(sh, name, wrapped)
    return calls


def _cyclic_graph(k=17, seed=6):
    """A 60-base circle (four copies of a unit: every walk on it cycles)
    beside a linear 600-base sequence, both in colour 0; colour 1 holds
    half the line."""
    rng = np.random.default_rng(seed)
    unit = "".join(rng.choice(list("ACGT"), 60))
    line = "".join(rng.choice(list("ACGT"), 600))
    return fixtures.build_graph({"a": [unit * 4, line], "b": [line[:300]]}, k)


def test_walk_step_twin_matches_jax(monkeypatch):
    """Each step of a sharded walk run (mesh.py:419-438, Brent's cycle
    test included) against the JAX step on the same state and returned edge
    bytes."""
    import jax.numpy as jnp
    from corticall_tpu.ops import kmer_jax as kj
    g = _cyclic_graph()
    k = g.kmer_size
    pg, mesh, sg = _port(g, 2)
    calls = _recording(monkeypatch, ["shard_walk_step"])
    seeds = pg.kmers[np.arange(64) * 7 % pg.num_records]
    _, cycled, _ = tpm.make_sharded_walk_run(mesh, sg, [0], k, 160)(seeds, np.ones(64, bool))
    assert len(calls) >= 2 * 30 and cycled.any() and not cycled.all()
    for _, (state, route, back, _, step, _), _, (after, *_) in calls:
        live = state.active.numpy().astype(bool)
        ans = np.zeros((len(live), 2), np.int64)
        ans[live] = back.numpy()[route.slot.numpy()[live]]
        idx, e = jnp.asarray(ans[:, 0], jnp.int32), jnp.asarray(ans[:, 1], jnp.uint32)
        cur = jnp.asarray(state.cur.numpy().view(np.uint32))
        flipped = jnp.asarray(route.flipped.numpy().astype(bool))
        saved = jnp.asarray(state.saved.numpy().view(np.uint32))
        power, lam = jnp.asarray(state.power.numpy()), jnp.asarray(state.lam.numpy())
        active = jnp.asarray(live)
        next_mask = jnp.where(flipped, e >> 4, e & 0xF)
        base = kj.lowest_set_base(next_mask)
        nxt = kj.shift_append(cur, base.astype(jnp.uint32), k)
        single = (kj.popcount4(next_mask) == 1) & (idx >= 0)
        is_cycle = jnp.all(nxt == saved, axis=-1) & single & active
        advance = active & single & ~is_cycle
        teleport = (power == lam) & advance
        want = {"stream": jnp.where(advance, base, -1).astype(jnp.int8),
                "saved": jnp.where(teleport[:, None], nxt, saved),
                "power": jnp.where(teleport, power * 2, power),
                "lam": jnp.where(advance, jnp.where(teleport, 0, lam) + 1, lam),
                "cur": jnp.where(advance[:, None], nxt, cur), "active": advance}
        np.testing.assert_array_equal(after.stream[step].numpy(), np.asarray(want["stream"]))
        for name in ("saved", "cur"):
            np.testing.assert_array_equal(getattr(after, name).numpy().view(np.uint32),
                                          np.asarray(want[name]))
        for name in ("power", "lam", "active"):
            np.testing.assert_array_equal(getattr(after, name).numpy(),
                                          np.asarray(want[name]).astype(np.int64))
        np.testing.assert_array_equal(after.cycled.numpy() - state.cycled.numpy(),
                                      np.asarray(is_cycle & (state.cycled.numpy() == 0)))


def test_link_step_twin_matches_jax(monkeypatch):
    """Each step of a sharded linked run (mesh.py:300-325) against the JAX
    package's store_add and store_advance on the same state and payload."""
    import jax.numpy as jnp
    from corticall_tpu.ops import walk_links as jwl
    g, links, _ = _trio()
    k = g.kmer_size
    pg, mesh, sg = _port(g, 2)
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    calls = _recording(monkeypatch, ["link_step"])
    cks = _sorted_roi_strings(g)
    seeds = _words(cks + [jkm.revcomp(s) for s in cks], k)
    tpm.make_sharded_linked_walk_run(mesh, sg, sl, [0], k, 256)(seeds, np.ones(len(seeds), bool))
    assert len(calls) >= 2 * 64
    juncs = 0
    for _, (state, route, back, _, step), _, (after, *_) in calls:
        if step % 32 and (after.junctions == state.junctions).all():
            continue           # every step that took a link choice, and every 32nd
        routed = route.slot.numpy() >= 0
        ans = np.zeros((len(routed), sh.LINK_ANSWER), np.int64)
        ans[routed] = back.numpy()[route.slot.numpy()[routed]]
        st = state.store.numpy()
        u32 = lambda a: jnp.asarray(a.astype(np.int64) & 0xFFFFFFFF, jnp.uint32)  # noqa: E731
        el_choices = jnp.stack([u32(st[:, 0]), u32(st[:, 1])], axis=-1)
        b = len(routed)
        active = jnp.asarray(state.active.numpy().astype(bool))
        flipped = jnp.asarray(route.flipped.numpy().astype(bool))
        out = jwl.store_add(
            el_choices, jnp.asarray(st[:, 2]), jnp.asarray(st[:, 3]), jnp.asarray(st[:, 4]),
            jnp.asarray(st[:, 6] != 0), jnp.asarray(st[:, 5]),
            jnp.full(b, 16 * step, jnp.int32), jnp.asarray(state.overflow.numpy().astype(bool)),
            active, flipped, u32(ans[:, sh.ANS_CHOICES:sh.ANS_LEN]).reshape(b, 16, 2),
            jnp.asarray(ans[:, sh.ANS_LEN:sh.ANS_FW], jnp.int32),
            jnp.asarray(ans[:, sh.ANS_FW:] != 0), jnp.asarray(ans[:, sh.ANS_CNT], jnp.int32))
        el_choices, el_len, el_pos, el_age, el_valid, el_seq, _, overflow = out
        cur, adv, el_pos, el_valid, el_age, emitted, take = jwl.store_advance(
            jnp.asarray(state.cur.numpy().view(np.uint32)), active, el_choices, el_len, el_pos,
            el_age, el_valid, el_seq, jnp.asarray(ans[:, sh.ANS_EDGE], jnp.uint32), flipped,
            step == 0, k)
        want_store = np.stack([np.asarray(el_choices[..., 0]).view(np.int32),
                               np.asarray(el_choices[..., 1]).view(np.int32),
                               *(np.asarray(x).astype(np.int32) for x in (
                                   el_len, el_pos, el_age, el_seq, el_valid))], axis=1)
        np.testing.assert_array_equal(after.store.numpy(), want_store)
        np.testing.assert_array_equal(after.cur.numpy().view(np.uint32), np.asarray(cur))
        np.testing.assert_array_equal(after.active.numpy().astype(bool), np.asarray(adv))
        np.testing.assert_array_equal(after.overflow.numpy().astype(bool), np.asarray(overflow))
        np.testing.assert_array_equal(after.stream[step].numpy(), np.asarray(emitted))
        np.testing.assert_array_equal(after.junctions.numpy() - state.junctions.numpy(),
                                      np.asarray(take).astype(np.int32))
        juncs += int(np.asarray(take).sum())
    assert juncs > 0


# ---------------------------------------------------------------------------
# the sharded paths against the JAX package's
# ---------------------------------------------------------------------------

def _jax_step(n, g, seeds, active, colors):
    _, _, jpm = _jax()
    import jax.numpy as jnp
    mesh = _jmesh(n)
    jsg = jpm.ShardedGraph.from_graph(g, n)
    step = jpm.make_sharded_walk_step(mesh, jsg, colors=colors, k=g.kmer_size)
    with mesh:
        cur, act, live = step(jnp.asarray(seeds), jnp.asarray(active))
    return np.asarray(cur), np.asarray(act), int(live)


def _port_step(n, g, seeds, active, colors):
    _, mesh, sg = _port(g, n)
    cur, act, live = tpm.make_sharded_walk_step(mesh, sg, colors, g.kmer_size)(seeds, active)
    return _np(cur).view(np.uint32), _np(act), live


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_step_matches_jax(n):
    """test_mesh.py::test_sharded_step_matches_single_device, on both
    packages: cur, advanced and the live count."""
    g, genome = _graph()
    k = g.kmer_size
    b = 8 * n
    starts = np.random.default_rng(0).integers(0, len(genome) - k, size=b)
    seeds = _words([genome[i:i + k] for i in starts], k)
    active = np.ones(b, dtype=bool)
    active[::5] = False
    want = _jax_step(n, g, seeds, active, [0, 1])
    got = _port_step(n, g, seeds, active, [0, 1])
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert 0 < got[2] < b


def test_skewed_exchange_matches_jax():
    """test_mesh.py::test_routed_exchange_skewed_queries_need_multiple_rounds:
    every query routes to shard 3 of 8; the answers must be equal (the port
    sends each owner exactly its queries: no rounds)."""
    _, _, jpm = _jax()
    g, _ = _graph(k=17, n=4000, seed=9)
    n = 8
    sel = np.nonzero(jpm.routing_hash_np(g.kmers) % n == 3)[0][:64]
    assert len(sel) == 64
    queries = np.tile(g.kmers[sel], (n, 1))
    active = np.ones(len(queries), dtype=bool)
    want = _jax_step(n, g, queries, active, [0])
    got = _port_step(n, g, queries, active, [0])
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert got[2] > 0
    pg, mesh, sg = _port(g, n)
    idx, owner, edge = tpm.sharded_lookup_fn(mesh, sg, [0])(queries)
    assert (_np(owner) == 3).all()
    np.testing.assert_array_equal(sg.records[3][_np(idx)], pg.find_records(queries))
    np.testing.assert_array_equal(_np(edge), pg.edges[pg.find_records(queries), 0])


def test_sharded_find_rois_matches_jax():
    _, _, jpm = _jax()
    g, _, _ = _trio()
    k = g.kmer_size
    mesh = _jmesh(8)
    want = jpm.sharded_find_rois_kmers(mesh, jpm.ShardedGraph.from_graph(g, 8), 0, [1, 2])
    _, tmesh, sg = _port(g, 8)
    got = tpm.sharded_find_rois_kmers(tmesh, sg, 0, [1, 2])
    np.testing.assert_array_equal(got, want)
    rois = _rois(g)
    assert np.array_equal(jkm.words_to_bytes_be(got, k),
                          np.sort(jkm.words_to_bytes_be(rois.kmers, k)))
    masks, total = tpm.make_sharded_find_rois(tmesh, sg, 0, [1, 2])()
    assert total == rois.num_records == sum(int(m.sum()) for m in masks)


def _both_ways_seeds(g, n):
    """The trio's sorted ROI k-mers, then their reverse complements, cut to
    a multiple of n (the walks that sharded_assemble makes)."""
    cks = _sorted_roi_strings(g)
    seeds = _words(cks + [jkm.revcomp(s) for s in cks], g.kmer_size)
    return cks, seeds[:len(seeds) // n * n]


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_walks_match_jax(n):
    """make_sharded_walk_run's streams, cycle flags and steps, bit for bit,
    on the ROI seeds of the trio both ways; their contigs (and at n = 2
    sharded_assemble's) equal the single-device walker's
    (test_mesh.py::test_sharded_multistep_walks_match_single_device)."""
    _, _, jpm = _jax()
    import jax.numpy as jnp
    from corticall_tpu.commands import core
    from corticall_tpu_torch.ops.walk_np import replay_walk
    g, _, _ = _trio()
    k = g.kmer_size
    cks, seeds = _both_ways_seeds(g, n)
    mesh = _jmesh(n)
    jsg = jpm.ShardedGraph.from_graph(g, n)
    with mesh:
        want = jpm.make_sharded_walk_run(mesh, jsg, [0], k, 256)(
            jnp.asarray(seeds), jnp.ones(len(seeds), dtype=bool))
    _, tmesh, sg = _port(g, n)
    got = tpm.make_sharded_walk_run(tmesh, sg, [0], k, 256)(seeds, np.ones(len(seeds), bool))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(w))
    rows, cycled = _np(got[0]).T, _np(got[1])
    b = len(cks)
    ext = [replay_walk(jkm.words_row_to_string(w, k), rows[i], bool(cycled[i]), 256)
           for i, w in enumerate(seeds)]
    want_contigs = core._batched_contigs(g, 0, cks, 256)
    for i, s in enumerate(cks[:len(seeds) - b]):
        assert (jkm.revcomp(ext[b + i]) if ext[b + i] else "") + s + ext[i] == want_contigs[s]
    if n == 2:
        assert tpm.sharded_assemble(tmesh, sg, [0], cks, 256) == want_contigs


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_linked_walks_match_jax(n):
    """make_sharded_linked_walk_run's streams, overflow and junctions, bit
    for bit, on the ROI seeds both ways (some inactive from the start); at
    n = 2 sharded_assemble_links's contigs equal the JAX package's
    single-device LinkedWalker's
    (test_mesh.py::test_sharded_linked_walks_match_device_kernel)."""
    _, _, jpm = _jax()
    import jax.numpy as jnp
    from corticall_tpu.ops.walk_links import LinkedWalker
    g, links, _ = _trio()
    k = g.kmer_size
    cks, seeds = _both_ways_seeds(g, n)
    active = np.ones(len(seeds), dtype=bool)
    active[3::29] = False
    mesh = _jmesh(n)
    jsg = jpm.ShardedGraph.from_graph(g, n)
    jsl = jpm.ShardedLinks.from_graph(g, [links], n, n_max=jsg.kmers.shape[1])
    with mesh:
        want = jpm.make_sharded_linked_walk_run(mesh, jsg, jsl, [0], k, 256)(
            jnp.asarray(seeds), jnp.asarray(active))
    pg, tmesh, sg = _port(g, n)
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    got = tpm.make_sharded_linked_walk_run(tmesh, sg, sl, [0], k, 256)(seeds, active)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(w))
    assert int(_np(got[2]).sum()) > 0
    if n == 2:
        contigs, overflow, junctions = tpm.sharded_assemble_links(tmesh, sg, sl, [0], cks, 256)
        wcontigs, wof, wjn = LinkedWalker(g, [0], [links]).assemble(cks, num_steps=256)
        assert [contigs[s] for s in cks] == list(wcontigs)
        np.testing.assert_array_equal(overflow, np.asarray(wof))
        np.testing.assert_array_equal(junctions, np.asarray(wjn))
        assert int(junctions.sum()) > 0 and not overflow.any()


def test_sharded_lookup_tree_matches_the_link_csr():
    """sharded_lookup_tree_fn's payload equals the graph-wide link CSR's
    rows of each query's record (mesh.py:199, :278-292)."""
    from corticall_tpu_torch.ops import walk_links as twl
    g, links, _ = _trio()
    pg, mesh, sg = _port(g, 4)
    plinks = [port_links(links)]
    sl = tpm.ShardedLinks.from_graph(pg, plinks, sg)
    la = twl.build_link_arrays(pg, plinks)
    linked = np.nonzero(np.diff(la.offsets))[0]
    queries = pg.kmers[np.concatenate([linked, np.arange(200 - len(linked) % 4) * 13 % pg.num_records])]
    edge, ch, ln, fw, cnt = (_np(x) for x in tpm.sharded_lookup_tree_fn(mesh, sg, sl, [0, 1])(
        queries))
    rec = pg.find_records(queries)
    np.testing.assert_array_equal(edge, pg.edges[rec, 0] | pg.edges[rec, 1])
    np.testing.assert_array_equal(cnt, la.offsets[rec + 1] - la.offsets[rec])
    for i, r in enumerate(rec):
        rows = np.arange(la.offsets[r], la.offsets[r] + min(cnt[i], 16))
        np.testing.assert_array_equal(ch[i, :len(rows)].view(np.uint32), la.choices[rows])
        np.testing.assert_array_equal(ln[i, :len(rows)], la.lengths[rows])
        np.testing.assert_array_equal(fw[i, :len(rows)], la.forward[rows])
    assert cnt.sum() > 0


def test_sharded_call_vcf_matches_jax():
    """The partition-sharded Call's VCF bytes equal the JAX package's single
    Caller and its sharded_call (test_mesh.py::test_sharded_call_vcf_bit_identical)."""
    _, _, jpm = _jax()
    from corticall_tpu.caller.call import Caller
    from corticall_tpu.caller.variants import write_vcf
    from corticall_tpu.commands import core
    from corticall_tpu.models.reference_index import IndexedReference
    from corticall_tpu_torch.caller.variants import write_vcf as twrite_vcf
    from corticall_tpu_torch.models.reference_index import IndexedReference as TRef
    g, _, genome = _trio()
    rois = _rois(g)
    parts = core.partition(g, rois, max_walk=256)
    refs = {p: IndexedReference({"chr1": genome}) for p in ("mom", "dad")}
    single = Caller(g, rois, parts, backgrounds=["mom", "dad"], references=refs)
    want, _ = single.call()
    sd = single.sequence_dictionary()
    pg, mesh, _ = _port(g, 3)
    trefs = {p: TRef({"chr1": genome}) for p in ("mom", "dad")}
    got, roi_set = tpm.sharded_call(mesh, pg, port_graph(rois), parts, ["mom", "dad"], trefs)
    assert len(want) > 0 and len(parts) > 3
    assert roi_set == {rois.kmer_string(i) for i in range(rois.num_records)}
    with tempfile.TemporaryDirectory() as td:
        paths = [os.path.join(td, f"{i}.vcf") for i in range(2)]
        write_vcf(paths[0], want, sd)
        twrite_vcf(paths[1], got, sd)
        blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1]


def test_sharded_call_asserts_on_an_unknown_partition(monkeypatch):
    """A call whose PARTITION_NAME its shard was not given raises, where the
    JAX package sorts it last (mesh.py:639)."""
    from corticall_tpu.commands import core
    from corticall_tpu_torch.caller import call as tcall
    from corticall_tpu_torch.models.reference_index import IndexedReference as TRef
    g, _, genome = _trio()
    rois = _rois(g)
    parts = core.partition(g, rois, max_walk=256)
    real = tcall.Caller.call

    def renamed(self):
        vs, rois_set = real(self)
        for v in vs:
            v.attr("PARTITION_NAME", "elsewhere")
        return vs, rois_set

    monkeypatch.setattr(tcall.Caller, "call", renamed)
    pg, mesh, _ = _port(g, 2)
    trefs = {p: TRef({"chr1": genome}) for p in ("mom", "dad")}
    with pytest.raises(RuntimeError, match="elsewhere"):
        tpm.sharded_call(mesh, pg, port_graph(rois), parts, ["mom", "dad"], trefs)


def test_bad_inputs_raise():
    g, _ = _graph()
    pg, mesh, sg = _port(g, 3)
    k = g.kmer_size
    run = tpm.make_sharded_walk_run(mesh, sg, [0], k, 8)
    with pytest.raises(ValueError, match="split"):
        run(pg.kmers[:4], np.ones(4, bool))
    with pytest.raises(ValueError):
        tpm.make_sharded_walk_run(mesh, sg, [0], k + 1, 8)
    with pytest.raises(ValueError, match="colour"):
        tpm.sharded_lookup_fn(mesh, sg, [5])(pg.kmers[:3])
    with pytest.raises(ValueError):
        sh.route(torch.zeros((4, 3), dtype=torch.int32), None, k, 3)
    with pytest.raises(ValueError):
        sh.route(torch.zeros((4, 2), dtype=torch.int32), None, k, sh.MAX_SHARDS + 1)


# ---------------------------------------------------------------------------
# the kernels against their twins (on a card)
# ---------------------------------------------------------------------------

def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (sh.WalkState, sh.LinkState)):
        return type(x)(*(_to(v, dev) for v in vars(x).values()))
    if isinstance(x, tuple):
        return type(x)(*(_to(v, dev) for v in x)) if hasattr(x, "_fields") else \
            tuple(_to(v, dev) for v in x)
    if isinstance(x, list):
        return [_to(v, dev) for v in x]
    return x


def _replay_on_card(calls, dev):
    """Every recorded twin call again through its wrapper on the card (the
    kernel), against the twin's outputs and updated state."""
    before = dict(sh.LAUNCHES)
    for name, args, out, after in calls:
        card = _to(args, dev)
        got = getattr(sh, name)(*card)
        if name == "route":
            for a, w in zip(sh.route_by_query(got), sh.route_by_query(out)):
                np.testing.assert_array_equal(_np(a), _np(w))
        elif name == "shard_answer":
            np.testing.assert_array_equal(_np(got), _np(out))
        else:
            for field, value in vars(after[0]).items():
                np.testing.assert_array_equal(_np(getattr(card[0], field)), _np(value),
                                              err_msg=f"{name} {field}")
    torch.cuda.synchronize()
    for name in {c[0] for c in calls}:
        assert sh.LAUNCHES[name] - before[name] == sum(c[0] == name for c in calls)


KERNELS = ["route", "shard_answer", "shard_walk_step", "link_step"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4])
def test_walk_kernels_match_twins(cuda, n, monkeypatch):
    """ctk_route, ctk_shard_answer and ctk_shard_walk_step on every call of
    sharded walk runs (the trio's, and the cyclic graph's for Brent's cycle
    test) and of single steps."""
    calls = _recording(monkeypatch, KERNELS)
    for g in (_trio()[0], _cyclic_graph()):
        pg, mesh, sg = _port(g, n)
        seeds = pg.kmers[np.arange(n * 40) * 17 % pg.num_records]
        ones = np.ones(len(seeds), bool)
        tpm.make_sharded_walk_run(mesh, sg, [0, 1], g.kmer_size, 200)(seeds, ones)
        tpm.make_sharded_walk_step(mesh, sg, [0], g.kmer_size)(seeds, ones)
    monkeypatch.undo()
    assert {c[0] for c in calls} == {"route", "shard_answer", "shard_walk_step"}
    _replay_on_card(calls, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_link_kernels_match_twins(cuda, n, monkeypatch):
    """ctk_route, ctk_shard_answer (with the link rows) and ctk_link_step on
    every call of a sharded linked run, walks inactive from the start
    included."""
    g, links, _ = _trio()
    pg, mesh, sg = _port(g, n)
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    calls = _recording(monkeypatch, KERNELS)
    cks = _sorted_roi_strings(g)
    seeds = _words(cks[:len(cks) // n * n], g.kmer_size)
    active = np.ones(len(seeds), dtype=bool)
    active[::9] = False
    tpm.make_sharded_linked_walk_run(mesh, sg, sl, [0], g.kmer_size, 256)(seeds, active)
    monkeypatch.undo()
    assert {c[0] for c in calls} == {"route", "shard_answer", "link_step"}
    _replay_on_card(calls, cuda)


@pytest.mark.cuda
def test_sharded_paths_on_one_card_match_the_cpu(cuda):
    """Four shards on one card: the walk and linked runs, FindROIs and the
    lookups equal the same mesh of CPU shards."""
    g, links, _ = _trio()
    k = g.kmer_size
    pg = port_graph(g)
    plinks = [port_links(links)]
    cks = _sorted_roi_strings(g)
    seeds = _words(cks[:len(cks) // 4 * 4], k)
    out = []
    for devices in (["cpu"] * 4, [cuda] * 4):
        mesh = tpm.ShardMesh(devices)
        sg = tpm.ShardedGraph.from_graph(pg, mesh)
        sl = tpm.ShardedLinks.from_graph(pg, plinks, sg)
        ones = np.ones(len(seeds), bool)
        out.append([_np(x) for x in (
            *tpm.make_sharded_walk_run(mesh, sg, [0], k, 256)(seeds, ones),
            *tpm.make_sharded_linked_walk_run(mesh, sg, sl, [0], k, 256)(seeds, ones),
            *tpm.sharded_lookup_fn(mesh, sg, [0, 1, 2])(pg.kmers[:400]))]
                   + [tpm.sharded_find_rois_kmers(mesh, sg, 0, [1, 2])])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
