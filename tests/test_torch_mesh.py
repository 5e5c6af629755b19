"""The port's hash-sharded graph (corticall_tpu_torch/parallel/mesh.py and
ops/sharding.py) against corticall_tpu/parallel/mesh.py.

The JAX package runs on the virtual 8-device CPU mesh of tests/conftest.py;
the port on a ShardMesh of ["cpu"] * n, where every wrapper runs its plain
twin.  The same graphs (through the .ctx bytes), links, seeds and queries go
to both: shard tables and link arrays, single steps (balanced and skewed),
FindROIs, multi-step and linked walks, and the sharded Call's VCF bytes must
be equal; each twin is held against the JAX expression it replaces, on the
states of a sharded run, and the walk loops' lagged end test against the
loop that tests every step.  Everything is integer or string: every
comparison is exact.  The `cuda` tests replay the twins' recorded calls
through the kernels on a card, hold both exchange kernels to their twins
from 2,812 to 65,536 queries and at 64 shards, and run a mesh of CPU and
card shards through the exchange between devices."""

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
    np.testing.assert_array_equal(_np(got.counts), [np.bincount(owner, minlength=n)])
    np.testing.assert_array_equal(_np(got.offsets),
                                  np.r_[0, np.cumsum(np.bincount(owner, minlength=n))])
    np.testing.assert_array_equal(_np(got.send).view(np.uint32), np.asarray(canon)[order])
    np.testing.assert_array_equal(_np(got.send)[_np(got.slot)].view(np.uint32), np.asarray(canon))

    active = rng.random(300) < 0.6
    part = sh.route(torch.from_numpy(cur.view(np.int32)),
                    torch.from_numpy(active.astype(np.uint8)), k, n)
    np.testing.assert_array_equal(_np(part.counts), [np.bincount(owner[active], minlength=n)])
    assert (_np(part.slot)[~active] == -1).all()
    sent = _np(part.send)[_np(part.slot)[active]].view(np.uint32)
    np.testing.assert_array_equal(sent, np.asarray(canon)[active])
    np.testing.assert_array_equal(_np(part.slot)[active][np.argsort(owner[active], kind="stable")],
                                  np.arange(active.sum()))


# (shards, each asker's queries): uneven, one asker empty past one shard
CARD_ROUTES = [(1, (300,)), (2, (37, 0)), (3, (100, 0, 257)), (4, (513, 20, 0, 64)),
               (8, (40, 0, 300, 1, 77, 256, 0, 90))]


@pytest.mark.parametrize("n,batches", CARD_ROUTES, ids=[f"n{n}" for n, _ in CARD_ROUTES])
def test_card_route_twin_matches_jax(n, batches):
    """The route of a device's askers' queries (one asker a shard, uneven,
    some empty) packs owner t's block asker after asker, each asker's
    queries to t in the order of JAX's _routed_exchange packing (mesh.py
    :111-118: canonicalize_words, the owner, the argsort); the askers'
    counts, the owners' offsets and every slot follow, and with active
    flags only the active queries are sent."""
    _, _, jpm = _jax()
    import jax.numpy as jnp
    from corticall_tpu.ops import kmer_jax as kj
    k = 31
    rng = np.random.default_rng(40 + n)
    b = sum(batches)
    cur = rng.integers(0, 1 << 32, (b, 2), dtype=np.uint64).astype(np.uint32)
    cur[:, 0] &= np.uint32((1 << 30) - 1)
    canon, flipped = kj.canonicalize_words(jnp.asarray(cur), k)
    canon = np.asarray(canon)
    owner = np.asarray(jpm.routing_hash(jnp.asarray(canon)) % jnp.uint32(n)).astype(np.int64)
    starts = np.cumsum((0,) + batches)
    packed = [np.asarray(jnp.argsort(jnp.asarray(owner[lo:hi]))) + lo
              for lo, hi in zip(starts, starts[1:])]            # JAX's order, an asker
    for active in (np.ones(b, bool), rng.random(b) < 0.6):
        got = sh.route(torch.from_numpy(cur.view(np.int32)),
                       torch.from_numpy(active.astype(np.uint8)), k, n, batches)
        np.testing.assert_array_equal(_np(got.owner), owner)
        np.testing.assert_array_equal(_np(got.flipped).astype(bool), np.asarray(flipped))
        want = np.array([i for t in range(n) for order in packed for i in order
                         if owner[i] == t and active[i]], dtype=np.int64)
        total = len(want)
        counts = [np.bincount(owner[lo:hi][active[lo:hi]], minlength=n)
                  for lo, hi in zip(starts, starts[1:])]
        np.testing.assert_array_equal(_np(got.counts), counts)
        np.testing.assert_array_equal(_np(got.offsets),
                                      np.r_[0, np.cumsum(np.sum(counts, axis=0))])
        np.testing.assert_array_equal(_np(got.send)[:total].view(np.uint32), canon[want])
        slot = np.full(b, -1)
        slot[want] = np.arange(total)
        np.testing.assert_array_equal(_np(got.slot), slot)
        assert total == int(active.sum()) and (n == 1 or 0 in batches)


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


def _answer_alone(queries, sg, s, colors, links=None):
    """The answers of shard s alone to `queries` (numpy uint32 [R, W]),
    through the wrapper: one owner, one block."""
    q = torch.from_numpy(queries.view(np.int32))
    return _np(sh.shard_answer(q, torch.tensor([0, len(q)], dtype=torch.int32), [sg.buckets[s]],
                               [sg.edges[s]], colors, None if links is None else [links]))


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
        ans = _answer_alone(queries, sg, s, colors, sl.csr(s))
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
        walk = _answer_alone(queries, sg, s, colors)
        np.testing.assert_array_equal(walk, ans[:, :sh.WALK_ANSWER])


def test_card_answer_twin_matches_shard_answer():
    """The answers of a device's four owners at once, each from its block
    of one received buffer (one block empty, every owner's own k-mers,
    misses and others' k-mers), equal shard_answer_plain on each block row
    for row, with and without the link rows; rows past the total stay
    zero."""
    g, links, _ = _trio()
    pg, mesh, sg = _port(g, 4)
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    rng = np.random.default_rng(8)
    blocks = []
    for s in range(4):
        own = pg.kmers[sg.records[s]]
        miss = own[:20].copy()
        miss[:, -1] ^= np.uint32(4)
        block = np.concatenate([own, miss, pg.kmers[rng.integers(0, pg.num_records, 30)]])
        blocks.append(block[rng.permutation(len(block))][:0 if s == 2 else None])
    offsets = np.r_[0, np.cumsum([len(b) for b in blocks])]
    recv = np.concatenate(blocks + [np.zeros((5, blocks[0].shape[1]), np.uint32)])
    q = torch.from_numpy(recv.view(np.int32))
    for csr in (None, [sl.csr(t) for t in range(4)]):
        got = _np(sh.shard_answer(q, torch.from_numpy(offsets.astype(np.int32)), sg.buckets,
                                  sg.edges, [0, 2], csr))
        assert got.shape == (len(recv), sh.WALK_ANSWER if csr is None else sh.LINK_ANSWER)
        for t, (lo, hi) in enumerate(zip(offsets, offsets[1:])):
            want = sh.shard_answer_plain(q[lo:hi], sg.buckets[t], sg.edges[t], [0, 2],
                                         None if csr is None else csr[t])
            np.testing.assert_array_equal(got[lo:hi], _np(want))
        assert not got[offsets[-1]:].any() and (got[:offsets[-1], sh.ANS_REC] >= 0).sum() > 0
        assert (got[:offsets[-1], sh.ANS_REC] == -1).sum() >= 60


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


def _jax_walk_step(state, route, back, k, cycle_check=True):
    """mesh.py's walk step in jax.numpy on a state and its returned answers:
    Brent's cycle test (:419-438) when `cycle_check`, else the plain
    advance (:568-583).  The fields it sets, and is_cycle."""
    import jax.numpy as jnp
    from corticall_tpu.ops import kmer_jax as kj
    live = state.active.numpy().astype(bool)
    ans = np.zeros((len(live), 2), np.int64)
    ans[live] = back.numpy()[route.slot.numpy()[live]][:, :2]
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
    if cycle_check:
        is_cycle = jnp.all(nxt == saved, axis=-1) & single & active
    else:
        is_cycle = jnp.zeros_like(active)
    advance = active & single & ~is_cycle
    want = {"stream": jnp.where(advance, base, -1).astype(jnp.int8),
            "cur": jnp.where(advance[:, None], nxt, cur), "active": advance,
            "is_cycle": is_cycle}
    if cycle_check:
        teleport = (power == lam) & advance
        want.update(saved=jnp.where(teleport[:, None], nxt, saved),
                    power=jnp.where(teleport, power * 2, power),
                    lam=jnp.where(advance, jnp.where(teleport, 0, lam) + 1, lam))
    return want


def _assert_walk_step(state, after, step, want):
    """A stepped state (`after`, from `state`) against _jax_walk_step's."""
    np.testing.assert_array_equal(after.stream[step].numpy(), np.asarray(want["stream"]))
    for name in ("saved", "cur"):
        np.testing.assert_array_equal(getattr(after, name).numpy().view(np.uint32),
                                      np.asarray(want.get(name, state.saved.numpy().view(
                                          np.uint32))))
    for name in ("power", "lam", "active"):
        np.testing.assert_array_equal(getattr(after, name).numpy(),
                                      np.asarray(want.get(name, getattr(state, name).numpy()))
                                      .astype(np.int64))
    np.testing.assert_array_equal(after.cycled.numpy() - state.cycled.numpy(),
                                  np.asarray(want["is_cycle"] & (state.cycled.numpy() == 0)))
    np.testing.assert_array_equal(after.steps.numpy() - state.steps.numpy(),
                                  np.asarray(want["active"]).astype(np.int64))


def test_walk_step_twin_matches_jax(monkeypatch):
    """Each step of a sharded walk run (mesh.py:419-438, Brent's cycle
    test included) against the JAX step on the same state and returned edge
    bytes."""
    g = _cyclic_graph()
    k = g.kmer_size
    pg, mesh, sg = _port(g, 2)
    calls = _recording(monkeypatch, ["shard_walk_step"])
    seeds = pg.kmers[np.arange(64) * 7 % pg.num_records]
    _, cycled, _ = tpm.make_sharded_walk_run(mesh, sg, [0], k, 160)(seeds, np.ones(64, bool))
    assert len(calls) >= 2 * 30 and cycled.any() and not cycled.all()
    for _, (state, route, back, _, step, _), _, (after, *_) in calls:
        _assert_walk_step(state, after, step, _jax_walk_step(state, route, back, k))


def _walk_step_case(k, b, seed, answer_cols=sh.WALK_ANSWER):
    """One walk step's inputs made to reach every branch of it, walks of
    each kind side by side in every warp: inactive walks (three in ten,
    their slots -1), live walks whose record is missing, whose successor is
    not single, that advance, that close a cycle (their anchor set to the
    k-mer they reach), that teleport (power == lam) and that were cycled
    before; the answers at their slots in a random order, `answer_cols`
    columns.  (state, route, back, step)."""
    from corticall_tpu_torch.ops import kmer as tk
    rng = np.random.default_rng(seed)
    w = tk.words(k)
    cur = rng.integers(0, 1 << 32, size=(b, w), dtype=np.uint64)
    cur[:, 0] &= (1 << (2 * k - 32 * (w - 1))) - 1
    active = rng.random(b) < 0.7
    live = np.flatnonzero(active)
    slot = np.full(b, -1, np.int32)
    slot[live] = rng.permutation(len(live))
    flipped = rng.random(b) < 0.5
    base = rng.integers(0, 4, size=b)
    nibble = np.where(rng.random(b) < 0.8, 1 << base, rng.integers(0, 16, size=b))
    other = rng.integers(0, 16, size=b)
    edge = np.where(flipped, nibble << 4 | other, other << 4 | nibble)
    rec = np.where(rng.random(b) < 0.1, -1, rng.integers(0, 1 << 20, size=b))
    back = rng.integers(-5, 1 << 20, size=(len(live), answer_cols)).astype(np.int32)
    back[slot[live], 0] = rec[live]
    back[slot[live], 1] = edge[live]
    words = torch.from_numpy(cur.astype(np.int64))
    nxt = tk.shift_append(words, torch.from_numpy(base.astype(np.int64)), k).numpy()
    saved = rng.integers(0, 1 << 32, size=(b, w), dtype=np.uint64)
    closes = rng.random(b) < 0.2
    saved[closes] = nxt[closes]
    power = rng.integers(1, 9, size=b)
    lam = np.where(rng.random(b) < 0.4, power, rng.integers(0, 9, size=b))
    i32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.uint64).astype(np.uint32)
                                     .view(np.int32))
    state = sh.WalkState(
        i32(cur), torch.from_numpy(active.astype(np.uint8)), i32(saved),
        torch.from_numpy(power.astype(np.int32)), torch.from_numpy(lam.astype(np.int32)),
        torch.from_numpy((rng.random(b) < 0.1).astype(np.uint8)),
        torch.from_numpy(rng.integers(0, 200, size=b).astype(np.int32)),
        torch.from_numpy(rng.integers(-1, 4, size=(4, b)).astype(np.int8)))
    route = sh.Route(torch.zeros((len(live), w), dtype=torch.int32), torch.from_numpy(slot),
                     torch.zeros(b, dtype=torch.int32),
                     torch.from_numpy(flipped.astype(np.uint8)),
                     torch.tensor([[len(live)]], dtype=torch.int32),
                     torch.tensor([0, len(live)], dtype=torch.int32))
    return state, route, torch.from_numpy(back), 2


def _clone_state(state):
    return sh.WalkState(*(v.clone() for v in vars(state).values()))


@pytest.mark.parametrize("k,cycle_check", [(17, True), (47, True), (63, False)])
def test_walk_step_twin_on_every_branch_matches_jax(k, cycle_check):
    """The twin's step on _walk_step_case's walks (every branch in each
    warp) against the JAX step, with and without the cycle test."""
    state, route, back, step = _walk_step_case(k, 300, k)
    after = _clone_state(state)
    sh.shard_walk_step_plain(after, route, back, k, step, cycle_check)
    want = _jax_walk_step(state, route, back, k, cycle_check)
    _assert_walk_step(state, after, step, want)
    live = state.active.numpy().astype(bool)
    advanced = np.asarray(want["active"])
    assert (~live[:32]).any() and (live[:32] & ~advanced[:32]).any() and advanced[:32].any()
    assert bool(np.asarray(want["is_cycle"]).any()) == cycle_check
    if cycle_check:
        assert (np.asarray(want["power"]) != state.power.numpy()).any()


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
    # one call a step for the two shards (one device, its walks one state)
    assert all(len(c[1][0]) == 1 for c in calls) and len(calls) >= 64
    shard_steps = [(state, route, back, step, after)
                   for _, (states, routes, backs, _, step), _, (afters, *_) in calls
                   for state, route, back, after in zip(states, routes, backs, afters)]
    juncs = 0
    for state, route, back, step, after in shard_steps:
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
        valid, age = np.asarray(el_valid), np.asarray(el_age)
        np.testing.assert_array_equal(after.bits.numpy(), valid.any(1) * sh.STORE_NONEMPTY
                                      + (valid & (age == 0)).any(1) * sh.STORE_PENDING)
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


def _counting(monkeypatch, module, name):
    """Wrap module.name to count its calls: the counter (a list of one)."""
    real, calls = getattr(module, name), [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("n", [2, 8])
def test_lagged_end_test_matches_jax(n, monkeypatch):
    """The walk loops stop END_TEST_LAG steps after the first step that
    routed no walk, reading each step's total late; the steps run past it
    change nothing: the walks' streams, cycle flags and steps, and the
    linked walks' streams, overflow and junctions at lags 2 and 5 equal the
    loop that tests every step (lag 0) and JAX's.  The seeds lie in the
    genome's last 200 bases, so that every walk ends before the cap."""
    _, _, jpm = _jax()
    import jax.numpy as jnp
    g, links, genome = _trio()
    k, steps = g.kmer_size, 256
    ends = np.linspace(len(genome) - 200, len(genome), 48).astype(int)
    seeds = _words([genome[i - k:i] for i in ends], k)
    active = np.ones(len(seeds), dtype=bool)
    active[5::13] = False
    mesh = _jmesh(n)
    jsg = jpm.ShardedGraph.from_graph(g, n)
    jsl = jpm.ShardedLinks.from_graph(g, [links], n, n_max=jsg.kmers.shape[1])
    with mesh:
        want = [np.asarray(x) for x in (
            *jpm.make_sharded_walk_run(mesh, jsg, [0], k, steps)(
                jnp.asarray(seeds), jnp.asarray(active)),
            *jpm.make_sharded_linked_walk_run(mesh, jsg, jsl, [0], k, steps)(
                jnp.asarray(seeds), jnp.asarray(active)))]
    pg, tmesh, sg = _port(g, n)
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    exchanges = {}
    for lag in (0, 2, 5):
        monkeypatch.setattr(tpm, "END_TEST_LAG", lag)
        calls = _counting(monkeypatch, tpm, "routed_exchange")
        got = [*tpm.make_sharded_walk_run(tmesh, sg, [0], k, steps)(seeds, active)]
        walk_steps = calls[0]
        got += tpm.make_sharded_linked_walk_run(tmesh, sg, sl, [0], k, steps)(seeds, active)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(_np(a), w)
        exchanges[lag] = (walk_steps, calls[0] - walk_steps)
        monkeypatch.undo()
    # both loops end well before their cap, each lag's extra steps run
    for kind in range(2):
        ends = [exchanges[lag][kind] for lag in (0, 2, 5)]
        assert ends[0] + 5 < steps and ends == [ends[0], ends[0] + 2, ends[0] + 5], exchanges


def test_exchange_across_devices_matches_jax(monkeypatch):
    """The exchange between devices (one host read of each device's owner
    offsets, each owner's block copied to its device, the answers copied
    back), taken by four CPU shards held as if by two devices, shards 0, 2
    and 1, 3: the walk and linked runs and the lookups equal the one-device
    mesh's, and the runs JAX's."""
    _, _, jpm = _jax()
    import jax.numpy as jnp
    g, links, _ = _trio()
    k, n = g.kmer_size, 4
    _, seeds = _both_ways_seeds(g, n)
    pg = port_graph(g)
    plinks = [port_links(links)]
    ones = np.ones(len(seeds), bool)
    mesh = _jmesh(n)
    jsg = jpm.ShardedGraph.from_graph(g, n)
    jsl = jpm.ShardedLinks.from_graph(g, [links], n, n_max=jsg.kmers.shape[1])
    with mesh:
        want = [np.asarray(x) for x in (
            *jpm.make_sharded_walk_run(mesh, jsg, [0], k, 256)(jnp.asarray(seeds),
                                                               jnp.ones(len(seeds), bool)),
            *jpm.make_sharded_linked_walk_run(mesh, jsg, jsl, [0], k, 256)(
                jnp.asarray(seeds), jnp.ones(len(seeds), bool)))]
    out = []
    for split in (False, True):
        tmesh = tpm.ShardMesh(["cpu"] * n)
        if split:
            cpu = torch.device("cpu")
            monkeypatch.setattr(tmesh, "groups", lambda: [(cpu, [0, 2]), (cpu, [1, 3])])
        across = _counting(monkeypatch, tpm, "_exchange_across")
        sg = tpm.ShardedGraph.from_graph(pg, tmesh)
        sl = tpm.ShardedLinks.from_graph(pg, plinks, sg)
        runs = [_np(x) for x in (
            *tpm.make_sharded_walk_run(tmesh, sg, [0], k, 256)(seeds, ones),
            *tpm.make_sharded_linked_walk_run(tmesh, sg, sl, [0], k, 256)(seeds, ones))]
        for a, w in zip(runs, want):
            np.testing.assert_array_equal(a, w)
        out.append(runs + [_np(x) for x in (
            *tpm.sharded_lookup_fn(tmesh, sg, [0, 1, 2])(pg.kmers[:400]),
            *tpm.sharded_lookup_tree_fn(tmesh, sg, sl, [0])(pg.kmers[:400]))])
        assert (across[0] > 0) == split
        monkeypatch.undo()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


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


def _same_route(got, want):
    """Two routes bit for bit (the send buffers' routed rows)."""
    total = int(want.offsets[-1])
    for field, a, w in zip(sh.Route._fields, got, want):
        a, w = _np(a), _np(w)
        if field == "send":
            a, w = a[:total], w[:total]
        np.testing.assert_array_equal(a, w, err_msg=f"route {field}")


def _replay_on_card(calls, dev):
    """Every recorded twin call again through its wrapper on the card (the
    kernel), against the twin's outputs and updated state."""
    before = dict(sh.LAUNCHES)
    for name, args, out, after in calls:
        card = _to(args, dev)
        got = getattr(sh, name)(*card)
        if name == "route":
            _same_route(got, out)
        elif name == "shard_answer":
            total = int(args[1][-1])
            np.testing.assert_array_equal(_np(got)[:total], _np(out)[:total])
        else:
            pairs = (zip(card[0], after[0]) if name == "link_step"
                     else [(card[0], after[0])])
            for got_state, want_state in pairs:
                for field, value in vars(want_state).items():
                    np.testing.assert_array_equal(_np(getattr(got_state, field)), _np(value),
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
@pytest.mark.parametrize("k", [17, 47, 63])
@pytest.mark.parametrize("cycle_check", [True, False])
def test_walk_step_kernel_on_every_branch_on_card(cuda, k, cycle_check):
    """ctk_shard_walk_step on _walk_step_case's walks (inactive, ending,
    advancing, cycling and teleporting walks in each warp; 300 walks, two
    blocks, the second partly idle) against the twin, field for field and
    the whole stream, with 2-column answers (the walk's) and 3-column ones
    (a wider row read by its first two columns)."""
    for cols in (sh.WALK_ANSWER, sh.WALK_ANSWER + 1):
        state, route, back, step = _walk_step_case(k, 300, k + cols, cols)
        want = _clone_state(state)
        sh.shard_walk_step_plain(want, route, back, k, step, cycle_check)
        card = _to(_clone_state(state), cuda)
        before = sh.LAUNCHES["shard_walk_step"]
        sh.shard_walk_step(card, _to(route, cuda), back.to(cuda), k, step, cycle_check)
        torch.cuda.synchronize()
        assert sh.LAUNCHES["shard_walk_step"] == before + 1
        for field, value in vars(want).items():
            np.testing.assert_array_equal(_np(getattr(card, field)), _np(value),
                                          err_msg=f"{field}, {cols} answer columns")


def _uneven_link_steps(sizes=(37, 0, 70), steps=160):
    """The trio's linked walks (ROI seeds both ways) split over 3 CPU shards
    of uneven sizes, one of them empty, held as one device's state, each
    step routed (the three shards as askers) and answered by the three
    owners and stepped by one link_step call over the three shards (views
    of the state and of the route); the calls recorded as _recording
    records them."""
    g, links, _ = _trio()
    k = g.kmer_size
    pg, mesh, sg = _port(g, len(sizes))
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    cks = _sorted_roi_strings(g)
    words = _words(cks + [jkm.revcomp(s) for s in cks], k)
    assert len(words) >= sum(sizes)
    b = sum(sizes)
    card = sh.LinkState.start(torch.from_numpy(words[:b].view(np.int32)),
                              torch.ones(b, dtype=torch.uint8), steps)
    cuts = list(zip(np.r_[0, np.cumsum(sizes)], np.cumsum(sizes)))
    states = [sh.LinkState(**{f: v[:, lo:hi] if f == "stream" else v[lo:hi]
                              for f, v in vars(card).items()}) for lo, hi in cuts]
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        calls = _recording(mp, ["link_step"])
        for step in range(steps):
            r = sh.route(card.cur, None if step == 0 else card.active, k, len(sizes), sizes)
            if not int(r.offsets[-1]):
                break
            back = sh.shard_answer(r.send, r.offsets, sg.buckets, sg.edges, [0],
                                   [sl.csr(t) for t in range(len(sizes))])
            parts = [sh.Route(r.send, r.slot[lo:hi], r.owner[lo:hi], r.flipped[lo:hi],
                              r.counts[i:i + 1], r.offsets) for i, (lo, hi) in enumerate(cuts)]
            sh.link_step(states, parts, [back] * len(sizes), k, step)
    return calls, states


def test_link_step_over_uneven_shards():
    """One link_step call over shards of 37, 0 and 70 walks gives each shard
    what its own call gives (the twin, shard by shard), with needy and idle
    walks among them and junctions resolved."""
    calls, states = _uneven_link_steps()
    assert len(calls) > 32 and int(sum(st.junctions.sum() for st in states)) > 0
    for _, (before, routes, backs, k, step), _, (after, *_) in calls[::8]:
        for i, (state, route, back) in enumerate(zip(before, routes, backs)):
            alone = sh.LinkState(*(v.clone() for v in vars(state).values()))
            sh.link_step([alone], [route], [back], k, step)
            for field, value in vars(after[i]).items():
                np.testing.assert_array_equal(_np(getattr(alone, field)), _np(value))
    assert before[1].cur.shape[0] == 0


@pytest.mark.cuda
def test_link_kernel_over_uneven_shards(cuda):
    """ctk_link_step: one launch a step over the three uneven shards (one
    empty), against the twin's every step."""
    calls, _ = _uneven_link_steps()
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


def _exchange_inputs(k, queries, shards, seed=5):
    """An 8 kbp genome with a 100- and an 80-base repeat (junctions past
    k = 63) and its links, over `shards` CPU shards, and `queries`
    walk-oriented k-mers split over as many askers, unevenly, the second
    empty: records in either orientation, half of them records with link
    rows, a tenth random words; seven in ten active."""
    from corticall_tpu_torch.ops import kmer as tk
    from corticall_tpu_torch.ops import walk_links as twl
    rng = np.random.default_rng(1)
    core_seq = "".join(rng.choice(list("ACGT"), 8000))
    genome = (core_seq[:3000] + core_seq[500:600] + core_seq[3000:6000]
              + core_seq[4000:4080] + core_seq[6000:])
    g = fixtures.build_graph({"kid": [genome]}, k)
    links = jlk.build_links(g, {"kid": [genome]}, "kid")
    pg, mesh, sg = _port(g, shards)
    plinks = [port_links(links)]
    sl = tpm.ShardedLinks.from_graph(pg, plinks, sg)
    linked = np.nonzero(np.diff(twl.build_link_arrays(pg, plinks).offsets))[0]
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, pg.num_records, queries)
    rec[::2] = linked[rng.integers(0, len(linked), len(rec[::2]))]
    words = torch.from_numpy(pg.kmers[rec].astype(np.int64))
    flip = torch.from_numpy(rng.random(queries) < 0.5)
    words = torch.where(flip[:, None], tk.revcomp_words(words, k), words)
    miss = torch.from_numpy(rng.random(queries) < 0.1)
    noise = torch.from_numpy(rng.integers(0, 1 << 32, words.shape, dtype=np.uint64).astype(np.int64))
    noise[:, 0] &= tk.top_word_mask(k)
    cur = tk.to_bits32(torch.where(miss[:, None], noise, words))
    cuts = np.sort(rng.integers(0, queries, shards - 1))
    cuts[0] = cuts[1]
    batches = np.diff(np.r_[0, cuts, queries]).tolist()
    active = torch.from_numpy((rng.random(queries) < 0.7).astype(np.uint8))
    return sg, sl, cur, active, batches


EXCHANGE_CASES = [(15, 2812, 4), (31, 65536, 4), (47, 2812, 4), (47, 65536, 4), (63, 2812, 4),
                  (63, 65536, 4), (31, 2812, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,queries,shards", EXCHANGE_CASES,
                         ids=[f"k{k}-q{q}-n{n}" for k, q, n in EXCHANGE_CASES])
def test_exchange_kernels_match_twins(cuda, k, queries, shards):
    """ctk_route and ctk_shard_answer against their twins, bit for bit, at
    a linked step's size (2,812 queries), at 65,536 queries, at k = 15, 31,
    47 and 63, and over 64 shards on one card: the route of every query and
    of the active ones, the walk's and the linked answers of every owner."""
    sg, sl, cur, active, batches = _exchange_inputs(k, queries, shards)
    tables = [_to(x, cuda) for x in (sg.buckets, sg.edges)]
    csr = [sl.csr(t) for t in range(shards)]
    before = dict(sh.LAUNCHES)
    for act in (None, active):
        want = sh.route(cur, act, k, shards, batches)
        got = sh.route(cur.to(cuda), None if act is None else act.to(cuda), k, shards, batches)
        _same_route(got, want)
        total = int(want.offsets[-1])
        assert total == (queries if act is None else int(act.sum()))
        for links in (None, csr):
            want_ans = sh.shard_answer(want.send, want.offsets, sg.buckets, sg.edges, [0],
                                       links)
            got_ans = sh.shard_answer(got.send, got.offsets, *tables, [0],
                                      None if links is None else _to(links, cuda))
            np.testing.assert_array_equal(_np(got_ans)[:total], _np(want_ans)[:total])
    torch.cuda.synchronize()
    assert sh.LAUNCHES["route"] - before["route"] == 2
    assert sh.LAUNCHES["shard_answer"] - before["shard_answer"] == 4


@pytest.mark.cuda
def test_mixed_mesh_takes_the_host_exchange(cuda, monkeypatch):
    """A mesh of CPU and card shards (["cpu", card, "cpu", card]) takes
    the exchange between devices, the card's route and answers by the
    kernels: the walk and linked runs and the lookups equal the mesh of
    CPU shards."""
    g, links, _ = _trio()
    k = g.kmer_size
    pg = port_graph(g)
    plinks = [port_links(links)]
    cks = _sorted_roi_strings(g)
    seeds = _words(cks[:len(cks) // 4 * 4], k)
    ones = np.ones(len(seeds), bool)
    out = []
    for devices in (["cpu"] * 4, ["cpu", cuda, "cpu", cuda]):
        mesh = tpm.ShardMesh(devices)
        across = _counting(monkeypatch, tpm, "_exchange_across")
        before = dict(sh.LAUNCHES)
        sg = tpm.ShardedGraph.from_graph(pg, mesh)
        sl = tpm.ShardedLinks.from_graph(pg, plinks, sg)
        out.append([_np(x) for x in (
            *tpm.make_sharded_walk_run(mesh, sg, [0], k, 256)(seeds, ones),
            *tpm.make_sharded_linked_walk_run(mesh, sg, sl, [0], k, 256)(seeds, ones),
            *tpm.sharded_lookup_fn(mesh, sg, [0, 1, 2])(pg.kmers[:400]))])
        mixed = len(mesh.groups()) == 2
        assert (across[0] > 0) == mixed
        assert (sh.LAUNCHES["route"] > before["route"]) == mixed
        assert (sh.LAUNCHES["shard_answer"] > before["shard_answer"]) == mixed
        monkeypatch.undo()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_one_card_step_is_three_launches(cuda, monkeypatch):
    """Four shards on one card: every step of the walk and linked runs is
    one ctk_route, one ctk_shard_answer and one walk or linked step launch,
    with no exchange between devices and no torch.cat."""
    g, links, _ = _trio()
    k = g.kmer_size
    pg = port_graph(g)
    mesh = tpm.ShardMesh([cuda] * 4)
    sg = tpm.ShardedGraph.from_graph(pg, mesh)
    sl = tpm.ShardedLinks.from_graph(pg, [port_links(links)], sg)
    cks = _sorted_roi_strings(g)
    seeds = _words(cks[:len(cks) // 4 * 4], k)
    ones = np.ones(len(seeds), bool)
    steps = _counting(monkeypatch, tpm, "routed_exchange")
    across = _counting(monkeypatch, tpm, "_exchange_across")
    cats = _counting(monkeypatch, torch, "cat")
    before = dict(sh.LAUNCHES)
    walk = tpm.make_sharded_walk_run(mesh, sg, [0], k, 256)
    linked = tpm.make_sharded_linked_walk_run(mesh, sg, sl, [0], k, 256)
    states = [tpm._walk(mesh, sg, seeds, ones, [0], 256),
              tpm._walk(mesh, sg, seeds, ones, [0], 256, links=sl)]
    torch.cuda.synchronize()
    launched = {name: sh.LAUNCHES[name] - before[name] for name in sh.LAUNCHES}
    assert cats[0] == 0 and across[0] == 0 and steps[0] > 2
    assert launched["route"] == launched["shard_answer"] == steps[0] == (
        launched["shard_walk_step"] + launched["link_step"])
    monkeypatch.undo()
    assert len(states[0]) == len(states[1]) == 1
    for got, run in zip(states, (walk, linked)):
        want = run(seeds, ones)
        np.testing.assert_array_equal(_np(got[0].stream), _np(want[0]))
