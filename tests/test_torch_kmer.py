"""The port's k-mer primitives (corticall_tpu_torch/ops/kmer.py) against
corticall_tpu/ops/kmer_jax.py, and its host hashing and cuckoo placement
(ops/placement.py) against hashtable.np_hash_words and cuckoo._place.
Everything is integer: every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from corticall_tpu import fixtures, kmer as km  # noqa: E402
from corticall_tpu.ops import cuckoo as ck, hashtable as ht, kmer_jax as kj  # noqa: E402
from corticall_tpu_torch.ops import kmer as tk, placement as tp  # noqa: E402

KS = [21, 31, 47, 63]


def _words(rng, k, n=257):
    codes = rng.integers(0, 4, (n, k)).astype(np.uint8)
    codes[0] = 0                              # all A: revcomp all T
    codes[1] = codes[1, ::-1] ^ 3             # a palindrome-like row
    return km.pack_codes(codes, k)


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("k", KS)
def test_revcomp_canonical_lex_match_jax(k):
    rng = np.random.default_rng(k)
    w = _words(rng, k)
    got = tk.revcomp_words(_t(w), k)
    np.testing.assert_array_equal(got.numpy(), _np(kj.revcomp_words(jnp.asarray(w), k)))
    canon, fl = tk.canonicalize_words(_t(w), k)
    jc, jf = kj.canonicalize_words(jnp.asarray(w), k)
    np.testing.assert_array_equal(canon.numpy(), _np(jc))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jf))
    other = np.roll(w, 1, axis=0)
    other[::3] = w[::3]                       # equal pairs too
    np.testing.assert_array_equal(
        tk.lex_less(_t(w), _t(other)).numpy(),
        np.asarray(kj.lex_less(jnp.asarray(w), jnp.asarray(other))))


@pytest.mark.parametrize("k", KS)
def test_shifts_and_bases_match_jax(k):
    rng = np.random.default_rng(100 + k)
    w = _words(rng, k)
    base = rng.integers(0, 4, len(w)).astype(np.uint32)
    np.testing.assert_array_equal(
        tk.shift_append(_t(w), torch.from_numpy(base.astype(np.int64)), k).numpy(),
        _np(kj.shift_append(jnp.asarray(w), jnp.asarray(base), k)))
    np.testing.assert_array_equal(
        tk.shift_prepend(_t(w), torch.from_numpy(base.astype(np.int64)), k).numpy(),
        _np(kj.shift_prepend(jnp.asarray(w), jnp.asarray(base), k)))
    np.testing.assert_array_equal(tk.first_base(_t(w), k).numpy(),
                                  _np(kj.first_base(jnp.asarray(w), k)))
    np.testing.assert_array_equal(tk.last_base(_t(w)).numpy(),
                                  _np(kj.last_base(jnp.asarray(w))))


@pytest.mark.parametrize("k", KS)
def test_hash_matches_jax_and_numpy(k):
    rng = np.random.default_rng(200 + k)
    w = _words(rng, k)
    got = tk.hash_words(_t(w)).numpy()
    np.testing.assert_array_equal(got, _np(kj.hash_words(jnp.asarray(w))))
    np.testing.assert_array_equal(got, ht.np_hash_words(w).astype(np.int64))
    np.testing.assert_array_equal(tp.np_hash_words(w), ht.np_hash_words(w))
    x = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tk.mix32(_t(x)).numpy(), _np(kj.mix32(jnp.asarray(x))))
    np.testing.assert_array_equal(tp.np_mix32(x), ht._np_mix32(x))
    np.testing.assert_array_equal(tp.np_h2(x), ck._np_h2(x))


def test_mask_primitives_match_jax():
    m = np.arange(16, dtype=np.uint32)
    np.testing.assert_array_equal(tk.popcount4(_t(m)).numpy(),
                                  _np(kj.popcount4(jnp.asarray(m))))
    np.testing.assert_array_equal(tk.lowest_set_base(_t(m)).numpy(),
                                  _np(kj.lowest_set_base(jnp.asarray(m))))


def test_bits32_round_trip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    b = tk.to_bits32(_t(x))
    np.testing.assert_array_equal(b.numpy(), x.view(np.int32))
    np.testing.assert_array_equal(tk.from_bits32(b).numpy(), x.astype(np.int64))


@pytest.mark.parametrize("k,n", [(17, 60000), (21, 900), (31, 6000),
                                 (47, 5000), (63, 3000)])
def test_place_matches_cuckoo(monkeypatch, k, n):
    """place() is cuckoo._place at the jump table's settings (load 0.5, two
    entries a bucket, primary bucket first), eviction walk included."""
    rng = np.random.default_rng(k + n)
    g = fixtures.build_graph({"s": ["".join(rng.choice(list("ACGT"), n))]}, k)
    walks = []
    real_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: walks.append(seed) or real_rng(seed))
    got = tp.place(g.kmers)
    want = ck._place(g.kmers, 0.5, None, 2, True)
    assert len(got) == 3 and got[0] == want[0]
    for a, b in zip(got[1:], want[1:3]):
        np.testing.assert_array_equal(a, b)
    # every case reaches the serial eviction walk, which seeds its generator
    # with 0, once a placement
    assert walks == [0, 0]
