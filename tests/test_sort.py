"""Multi-word key sorts of the sketch step and the Gram presort
(ops/sketch._sort_rows, merge_sketches, ops/gram._sort_packed) vs numpy."""
import numpy as np
import pytest

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops import gram
from spaced_kmer_sketching_tpu.ops.sketch import (_compact_unique, _sort_rows,
                                                  merge_sketches)


def lexsorted(keys):
    order = np.lexsort(tuple(keys[:, q] for q in range(keys.shape[1])))
    return keys[order]


def _sort(keys, extra=()):
    words, rest = _sort_rows([jnp.asarray(keys[:, q])
                              for q in range(keys.shape[1])],
                             tuple(jnp.asarray(e) for e in extra))
    return np.stack([np.asarray(w) for w in words], axis=1), rest


@pytest.mark.parametrize("n", [1024, 4096, 1000])
def test_sort_rows_random_keys(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint64).astype(
        np.uint32)
    got, _ = _sort(keys)
    np.testing.assert_array_equal(got, lexsorted(keys))


def test_sort_rows_duplicates_and_sentinels():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2 ** 32, size=(2048, 4), dtype=np.uint64).astype(
        np.uint32)
    keys[::3] = keys[1]                      # heavy duplication
    keys[-100:] = 0xFFFFFFFF                 # sentinel padding
    keys[:50, 2:] = 0                        # low-entropy high words
    got, _ = _sort(keys)
    np.testing.assert_array_equal(got, lexsorted(keys))


def test_sort_rows_extra_operands_ride_along():
    """A ride-along operand travels with its key (keys may repeat, so
    compare (key, tag) multisets)."""
    rng = np.random.default_rng(21)
    n = 2048
    keys = rng.integers(0, 64, size=(n, 1)).astype(np.uint32)
    tag = np.arange(n, dtype=np.uint32)
    got, (tag_out,) = _sort(keys, (tag,))
    tag_out = np.asarray(tag_out)
    np.testing.assert_array_equal(got[:, 0], np.sort(keys[:, 0]))
    np.testing.assert_array_equal(keys[tag_out, 0], got[:, 0])
    assert sorted(tag_out.tolist()) == tag.tolist()


@pytest.mark.parametrize("key_bits,gidbits", [(20, 4), (40, 9), (60, 9)])
def test_sort_packed_matches_lexsort(key_bits, gidbits):
    """The packed (key, gid) presort orders by key then gid, with
    sentinel rows last, for 1-, 2- and 3-plane packings."""
    rng = np.random.default_rng(key_bits)
    g, cap = 1 << (gidbits - 1), 64
    pw = gram.pack_plan(key_bits, gidbits)
    keys = np.full((g, cap, 2), 0xFFFFFFFF, np.uint32)
    for i in range(g):
        c = int(rng.integers(0, cap + 1))
        v = np.unique(rng.integers(0, 1 << min(key_bits, 60), c)
                      .astype(np.uint64))
        keys[i, :v.size, 0] = (v & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :v.size, 1] = (v >> np.uint64(32)).astype(np.uint32)
    gid = jnp.broadcast_to(jnp.arange(g, dtype=jnp.uint32)[:, None], (g, cap))
    kw = min(2, gram._guard_words(key_bits))
    planes = gram._pack_gid_planes(jnp.asarray(keys[:, :, :kw]), gid,
                                   key_bits, gidbits, pw)
    got = np.stack([np.asarray(p) for p in gram._sort_packed(planes)], 1)
    flat = np.stack([np.asarray(p).reshape(-1) for p in planes], 1)
    np.testing.assert_array_equal(got, lexsorted(flat))
    assert got.shape == (g * cap, pw)


def test_merge_sketches_duplicates_and_sentinels():
    """merge_sketches == sorted unique union of the valid rows; rows past
    each count are ignored even when they hold real-looking keys."""
    rng = np.random.default_rng(5)
    s, cap = 4, 256
    keys = np.full((s, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.array([200, 0, 130, 256], np.int32)
    pool = rng.integers(0, 1 << 30, 400).astype(np.uint32)
    union = set()
    for i in range(s):
        v = np.unique(rng.choice(pool, counts[i]))
        counts[i] = v.size
        keys[i, :v.size, 0] = v
        keys[i, :v.size, 1:] = 0
        keys[i, v.size:v.size + 3, 0] = 5      # garbage past the count
        union |= set(v.tolist())
    out = merge_sketches(jnp.asarray(keys), jnp.asarray(counts), 1024)
    c = int(out.count)
    assert c == len(union)
    np.testing.assert_array_equal(np.asarray(out.keys[:c, 0]),
                                  np.array(sorted(union), np.uint32))
    assert np.all(np.asarray(out.keys[c:]) == 0xFFFFFFFF)
    assert int(out.raw_kept) == int(counts.sum())


def test_merge_sketches_truncates_to_capacity():
    """A merged sketch larger than the capacity keeps its smallest keys
    and reports the pre-dedup total for the caller's retry."""
    keys = np.full((2, 128, 4), 0xFFFFFFFF, np.uint32)
    keys[0, :, :] = 0
    keys[0, :, 0] = np.arange(0, 256, 2)
    keys[1, :, :] = 0
    keys[1, :, 0] = np.arange(1, 257, 2)
    out = merge_sketches(jnp.asarray(keys),
                         jnp.asarray(np.array([128, 128], np.int32)), 64)
    np.testing.assert_array_equal(np.asarray(out.keys[:, 0]), np.arange(64))
    assert int(out.count) == 64 and int(out.raw_kept) == 256


def test_compact_unique_preserves_order():
    """Rows not flagged unique become sentinels and sort to the back; the
    flagged rows keep their sorted order."""
    vals = np.arange(10, 266, dtype=np.uint32)
    uniq = np.zeros(256, bool)
    uniq[::3] = True
    words = [jnp.asarray(vals)] + [jnp.zeros(256, jnp.uint32)] * 3
    out = _compact_unique(words, jnp.asarray(uniq))
    m = int(uniq.sum())
    np.testing.assert_array_equal(np.asarray(out[0][:m]), vals[uniq])
    assert np.all(np.asarray(out[0][m:]) == 0xFFFFFFFF)
