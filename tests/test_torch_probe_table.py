"""The interleaved probe table that ctk_ht_lookup reads
(corticall_tpu_torch/ops/hashtable.py: probe_table, lookup_rounds_plain)
against corticall_tpu/ops/hashtable.py: the key entries equal
HashTable.build_entries at W = 1-4, and the tiled probe (rounds of g
consecutive entries, the first resolving slot of a round answering, lanes
past max_probe masked) answers as the JAX package's lookup on a load-0.9
table whose longest probe passes 32 slots, with max_probe cut in the middle
of a round, on a cluster that wraps past slot M - 1 and on misses that end at
an empty slot.  Everything is integer: every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu import kmer as km  # noqa: E402
from corticall_tpu_torch.ops import hashtable as tht, jump as tj  # noqa: E402
from corticall_tpu_torch.ops.placement import GOLDEN, np_hash_words  # noqa: E402


def _jht():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from corticall_tpu.ops import hashtable
    return jnp, hashtable


def _unique_kmers(seed, n, k):
    """Unique canonical random k-mers (test_device.py's table keys)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, k)).astype(np.uint8)
    canon, _ = km.canonicalize_codes(codes)
    return km.bytes_be_to_words(np.unique(km.words_to_bytes_be(km.pack_codes(canon), k)), k)


def _bits(words):
    return tj.words_tensor(words, "cpu")


def _np_mix32(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


@pytest.mark.parametrize("k", [5, 31, 47, 63])
def test_probe_table_is_the_jax_build_entries_padded(k):
    """Key entries: build_entries' (key words, record + 1) columns, zeros
    after them to 4 words (W <= 3) or 8 (W = 4); tag entries: record + 1
    and mix32(hash ^ GOLDEN) of the key, both 0 for an empty slot."""
    _, jht = _jht()
    kmers = _unique_kmers(70 + k, 3000, k)
    w = kmers.shape[1]
    table = jht.build(kmers)
    want = table.build_entries(kmers)
    got = tht.probe_table(torch.from_numpy(table.slots), _bits(kmers), "key").numpy()
    got = got.view(np.uint32)
    assert got.shape == (table.size, 4 if w <= 3 else 8)
    np.testing.assert_array_equal(got[:, :w + 1], want)
    assert not got[:, w + 1:].any()
    tags = tht.probe_table(torch.from_numpy(table.slots), _bits(kmers), "tag").numpy()
    tags = tags.view(np.uint32)
    occ = table.slots >= 0
    rec = table.slots[occ]
    np.testing.assert_array_equal(tags[occ, 0], rec.astype(np.uint32) + 1)
    np.testing.assert_array_equal(tags[occ, 1], _np_mix32(np_hash_words(kmers[rec])
                                                          ^ np.uint32(GOLDEN)))
    assert not tags[~occ].any()


def _wrapping_keys(k, m):
    """Unique k-mers of which a dozen hash to slot m - 1, so their cluster
    wraps past it to slots 0, 1, ..., and 500 others."""
    pool = _unique_kmers(5, 40000, k)
    home = np_hash_words(pool) & np.uint32(m - 1)
    last = np.flatnonzero(home == m - 1)[:12]
    assert len(last) == 12
    rest = np.flatnonzero(home != m - 1)[:500]
    return pool[np.sort(np.concatenate([last, rest]))]


def _cases():
    """(name, kmers, table_size, load_factor)."""
    return {
        "load0.9": (_unique_kmers(2, 6000, 21), None, 0.9),
        "wrap": (_wrapping_keys(31, 1024), 1024, 0.7),
        "load0.9-k63": (_unique_kmers(3, 3000, 63), None, 0.9),
    }


@pytest.mark.parametrize("form", ["key", "tag"])
@pytest.mark.parametrize("case", ["load0.9", "wrap", "load0.9-k63"])
def test_rounds_answer_as_the_jax_lookup(case, form):
    """lookup_rounds_plain at 1, 2, 4 and 8 lanes a query against
    hashtable.lookup: every key and as many flipped keys, at the full probe
    count and cut to counts that end inside a round."""
    jnp, jht = _jht()
    kmers, size, load = _cases()[case]
    table = jht.build(kmers, load_factor=load, table_size=size)
    slots, m = table.slots, table.size
    assert (tht.build(kmers, load_factor=load, table_size=size).slots == slots).all()
    home = np_hash_words(kmers) & np.uint32(m - 1)
    at = np.empty(len(kmers), dtype=np.int64)
    at[slots[slots >= 0]] = np.flatnonzero(slots >= 0)
    if case == "wrap":
        assert (at < home).any()                       # a key past slot M - 1
    else:
        assert table.max_probe > 32
    miss = kmers.copy()
    miss[:, -1] ^= np.uint32(2)
    queries = np.concatenate([kmers, miss])
    # the misses whose probes meet an empty slot before max_probe
    qh = np_hash_words(miss) & np.uint32(m - 1)
    empty_at = np.array([next((p for p in range(table.max_probe)
                               if slots[(h + p) & (m - 1)] < 0), -1) for h in qh])
    assert (empty_at > 0).sum() > len(miss) // 4
    probe = tht.probe_table(torch.from_numpy(slots), _bits(kmers), form)
    for probes in sorted({0, 1, 3, 5, 6, 13, table.max_probe - 1, table.max_probe}):
        want = np.asarray(jht.lookup(jnp.asarray(slots), jnp.asarray(kmers),
                                     jnp.asarray(queries), probes))
        for group in tht.GROUPS:
            got = tht.lookup_rounds_plain(probe, _bits(kmers), _bits(queries), probes, group)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{probes} probes, g={group}")
    full = tht.lookup_rounds_plain(probe, _bits(kmers), _bits(queries), table.max_probe, 8)
    np.testing.assert_array_equal(full.numpy()[:len(kmers)], np.arange(len(kmers)))


def test_probe_table_validates():
    kmers = _unique_kmers(4, 200, 21)
    slots = torch.from_numpy(tht.build(kmers).slots)
    with pytest.raises(ValueError, match="unknown probe table form"):
        tht.probe_table(slots, _bits(kmers), "wide")
    assert tht.entry_words(3, "key") == 4 and tht.entry_words(4, "key") == 8
    assert tht.entry_words(4, "tag") == 2
