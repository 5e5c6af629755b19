"""The needy rule of the port's linked kernels on the CPU.

ctk_link_walk and ctk_link_step run a walk's LinkStore step by a whole warp
only when the step is needy (ops/walk_links.py::needy_steps,
csrc/link_store.cuh::needy_step): its k-mer has link records, or it is a
junction and the store holds an element, or a valid element has age 0.
Every other step of an active walk is taken by the walk's own lane from two
bits, so it must leave all seven store fields, the overflow and the
junction count as they were and emit base | 8 * non-empty, or -1 at a dead
end or a junction.  These tests hold the plain twins to that on every step
of every walk: walk_links_forward_plain on the walk cases of
tests/test_torch_walk_links.py, and link_step_plain (with LinkState's bits)
on sharded linked runs over 2 and 4 shards.  They also count the needy
share, which is what the kernels' speed rests on."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import kmer as jkm  # noqa: E402
from corticall_tpu_torch.ops import kmer as tk, sharding as sh  # noqa: E402
from corticall_tpu_torch.ops import walk_links as twl  # noqa: E402
from corticall_tpu_torch.parallel import mesh as tpm  # noqa: E402
from test_torch_host import port_graph, port_links  # noqa: E402
from test_torch_walk_links import JAX_CASES, _both_ways, _port, case  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _idle_emission(edge, flipped, nonempty):
    """What an idle step emits: the one successor's base | 8 * non-empty,
    else -1 (a dead end, or a junction with nothing to choose by)."""
    next_mask = torch.where(flipped, edge >> 4, edge & 0xF)
    base = tk.lowest_set_base(next_mask) | torch.where(nonempty, 8, 0)
    return torch.where(tk.popcount4(next_mask) == 1, base, -1)


class Tally:
    """Active walk steps, needy ones, and idle steps checked."""

    def __init__(self):
        self.active = self.needy = self.idle = 0

    def add(self, active, needy):
        self.active += int(active.sum())
        self.needy += int((active & needy).sum())
        self.idle += int((active & ~needy).sum())


def _check_walk_step(tally, t, rec):
    active, needy = rec["active"], rec["needy"]
    idle = active & ~needy
    tally.add(active, needy)
    for name, a, b in zip(("choices", "len", "pos", "age", "valid", "seq"),
                          rec["store_before"], rec["store_after"]):
        assert torch.equal(a[idle], b[idle]), f"step {t}: {name} changed on an idle step"
    assert torch.equal(rec["overflow_before"][idle], rec["overflow_after"][idle])
    assert not rec["take_choice"][idle].any()
    nonempty = rec["store_before"][4].any(1)
    want = _idle_emission(rec["edge"], rec["flipped"], nonempty)
    assert torch.equal(rec["emitted"][idle], want[idle]), f"step {t}"
    if t > 0:        # no element keeps age 0 past a step after the seed's
        _, pending = twl.store_flags(rec["store_after"][4], rec["store_after"][3])
        assert not pending[active].any()


@pytest.mark.parametrize("name", JAX_CASES + ["trio55"])
def test_idle_walk_steps_leave_the_store(name):
    g, links, colour, seeds, steps = case(name)
    k = g.kmer_size
    pg, plinks = _port(g, links)
    walker = twl.LinkedWalker(pg, [colour], plinks, device="cpu")
    words = torch.from_numpy(_both_ways(seeds, k).view(np.int32))
    tally = Tally()
    twl.walk_links_forward_plain(*walker.args, words, k, steps,
                                 trace=lambda t, rec: _check_walk_step(tally, t, rec))
    assert tally.idle > 0 and tally.idle + tally.needy == tally.active
    if name != "unlinked":
        assert tally.needy > 0
    else:
        assert tally.needy == 0
    print(f"{name}: {tally.needy} needy of {tally.active} walk steps")
    if name.startswith(("trio", "hub")):
        # on the threaded trios the warp steps a store a few times in a hundred
        assert tally.needy < 0.1 * tally.active, (tally.needy, tally.active)


def _linked_run(n, monkeypatch):
    """test_torch_mesh's trio walked over n CPU shards both ways at 256
    steps, link_step_plain wrapped to check each shard's step: the bits
    before it are its store's flags, and its idle walks (active, not needy
    by the bits and the returned answer) keep store, bits, overflow and
    junctions and emit what an idle step emits."""
    from test_torch_mesh import _sorted_roi_strings, _trio

    g, links, _ = _trio()
    k = g.kmer_size
    pg, plinks = port_graph(g), [port_links(links)]
    mesh = tpm.ShardMesh(["cpu"] * n)
    sg = tpm.ShardedGraph.from_graph(pg, mesh)
    sl = tpm.ShardedLinks.from_graph(pg, plinks, sg)
    tally = Tally()
    real = sh.link_step_plain

    def checked(state, route, back, k, step):
        before = sh.LinkState(*(v.clone() for v in vars(state).values()))
        real(state, route, back, k, step)
        st = before.store
        nonempty, pending = twl.store_flags(st[:, 6] != 0, st[:, 4])
        assert torch.equal(before.bits.to(torch.int64),
                           nonempty * sh.STORE_NONEMPTY + pending * sh.STORE_PENDING)
        live = before.active.to(torch.bool)
        got = sh._answers(route, back, route.slot >= 0)
        edge, flipped = got[:, sh.ANS_EDGE] & 0xFF, route.flipped.to(torch.bool)
        next_mask = torch.where(flipped, edge >> 4, edge & 0xF)
        needy = live & ((got[:, sh.ANS_CNT] > 0)
                        | ((before.bits & sh.STORE_PENDING) != 0)
                        | ((tk.popcount4(next_mask) > 1)
                           & ((before.bits & sh.STORE_NONEMPTY) != 0)))
        idle = live & ~needy
        tally.add(live, needy)
        for f in ("store", "bits", "overflow", "junctions"):
            assert torch.equal(getattr(before, f)[idle], getattr(state, f)[idle]), f
        assert torch.equal(state.stream[step][idle].to(torch.int64),
                           _idle_emission(edge, flipped, nonempty)[idle])
        assert torch.equal(state.active[idle].to(torch.bool),
                           (tk.popcount4(next_mask) == 1)[idle])

    monkeypatch.setattr(sh, "link_step_plain", checked)
    cks = _sorted_roi_strings(g)
    words = jkm.pack_codes(jkm.strings_to_codes(cks + [jkm.revcomp(s) for s in cks]), k)
    words = words[:len(words) // n * n]
    out = tpm.make_sharded_linked_walk_run(mesh, sg, sl, [0], k, 256)(
        words, np.ones(len(words), bool))
    return tally, out


@pytest.mark.parametrize("n", [2, 4])
def test_idle_link_steps_leave_the_store(n, monkeypatch):
    tally, out = _linked_run(n, monkeypatch)
    assert int(out[2].sum()) > 0                 # junctions resolved by links
    print(f"{n} shards: {tally.needy} needy of {tally.active} walk steps")
    assert tally.idle > 0 and 0 < tally.needy < 0.1 * tally.active, (tally.needy,
                                                                      tally.active)
