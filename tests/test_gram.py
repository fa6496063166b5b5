"""Gram-matrix all-pairs intersection vs sets and the C++ merge.

Reference semantics: per-pair hash-probe counts (src/kmer_set.cpp:23-41)
over the ordered all-pairs list incl. self-pairs (src/generators.hpp:45-58).
"""
import numpy as np
import pytest

from spaced_kmer_sketching_tpu.ops.gram import (build_rank_layout,
                                                gram_all_pairs)
from spaced_kmer_sketching_tpu.utils import native


def make_sketches(rng, g, cap, *, shared=300, priv=150, wide=False):
    pool = np.unique(rng.integers(0, 1 << 62, size=2 * shared)
                     .astype(np.uint64))
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    sets = []
    for i in range(g):
        s = rng.choice(pool, size=min(shared, pool.size), replace=False)
        p = rng.integers(0, 1 << 62, size=priv).astype(np.uint64)
        u = np.unique(np.concatenate([s, p]))
        hi = (u % np.uint64(97)) if wide else np.zeros_like(u)
        ordv = np.lexsort((u, hi))
        u, hi = u[ordv], hi[ordv]
        counts[i] = u.size
        keys[i, :u.size, 0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        keys[i, :u.size, 1] = (u >> np.uint64(32)).astype(np.uint32)
        keys[i, :u.size, 2] = (hi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        keys[i, :u.size, 3] = (hi >> np.uint64(32)).astype(np.uint32)
        sets.append({(int(a), int(b)) for a, b in zip(u, hi)})
    return keys, counts, sets


@pytest.mark.parametrize("wide", [False, True])
def test_matches_python_sets(wide):
    rng = np.random.default_rng(3)
    keys, counts, sets = make_sketches(rng, 12, 512, wide=wide)
    mat = gram_all_pairs(keys, counts, tile=256)
    for i in range(12):
        for j in range(12):
            assert mat[i, j] == len(sets[i] & sets[j]), (i, j)
    assert np.array_equal(np.diag(mat), counts.astype(np.int64))


def test_matches_native_merge():
    rng = np.random.default_rng(5)
    keys, counts, _ = make_sketches(rng, 8, 512)
    mat = gram_all_pairs(keys, counts, tile=256)
    for i in range(8):
        for j in range(8):
            ci, cj = counts[i], counts[j]
            a = np.ascontiguousarray(np.stack(
                [keys[i, :ci, 0].astype(np.uint64)
                 | (keys[i, :ci, 1].astype(np.uint64) << 32),
                 keys[i, :ci, 2].astype(np.uint64)
                 | (keys[i, :ci, 3].astype(np.uint64) << 32)], axis=1))
            b = np.ascontiguousarray(np.stack(
                [keys[j, :cj, 0].astype(np.uint64)
                 | (keys[j, :cj, 1].astype(np.uint64) << 32),
                 keys[j, :cj, 2].astype(np.uint64)
                 | (keys[j, :cj, 3].astype(np.uint64) << 32)], axis=1))
            assert mat[i, j] == native.intersect_sorted(a, b)


def test_empty_and_identical_sketches():
    rng = np.random.default_rng(9)
    keys, counts, _ = make_sketches(rng, 6, 256, shared=60, priv=40)
    counts[2] = 0                      # empty sketch
    keys[4] = keys[1]                  # identical pair
    counts[4] = counts[1]
    mat = gram_all_pairs(keys, counts, tile=128)
    assert mat[2].sum() == 0 and mat[:, 2].sum() == 0
    assert mat[4, 1] == mat[1, 1] == mat[4, 4]
    assert np.array_equal(mat, mat.T)


def test_nonmultiple_g_and_tile_edges():
    # G=5 (not a multiple of 32) and a union that is not a tile multiple
    rng = np.random.default_rng(11)
    keys, counts, sets = make_sketches(rng, 5, 128, shared=50, priv=33)
    mat = gram_all_pairs(keys, counts, tile=64)
    for i in range(5):
        for j in range(5):
            assert mat[i, j] == len(sets[i] & sets[j])


@pytest.mark.parametrize("g,cap", [(8, 128), (6, 256)])
def test_gram_ondevice_matches_sets(g, cap):
    import jax
    from spaced_kmer_sketching_tpu.ops.gram import gram_all_pairs_ondevice

    rng = np.random.default_rng(31)
    keys, counts, sets = make_sketches(rng, g, cap, shared=40, priv=30,
                                       wide=True)
    mat = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128,
))
    for i in range(g):
        for j in range(g):
            assert mat[i, j] == len(sets[i] & sets[j]), (i, j)


def test_gram_ondevice_boundary_straddle():
    # a key shared by EVERY genome, G == chunk/16 copies landing around
    # chunk boundaries: exercises the carry correction
    import jax
    from spaced_kmer_sketching_tpu.ops.gram import gram_all_pairs_ondevice

    rng = np.random.default_rng(33)
    g, cap = 8, 128
    keys, counts, sets = make_sketches(rng, g, cap, shared=90, priv=20)
    mat = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128,
))
    for i in range(g):
        for j in range(g):
            assert mat[i, j] == len(sets[i] & sets[j]), (i, j)
    assert np.array_equal(np.diag(mat), counts)


def test_gram_ondevice_key_words():
    """Reduced-word sort/scan (key_words < 4) must agree with the full
    4-word path and with python sets; key_words_for_window covers the
    sweep geometry."""
    import jax
    from spaced_kmer_sketching_tpu.ops.gram import (gram_all_pairs_ondevice,
                                                    key_words_for_window)

    assert key_words_for_window(10) == 1
    assert key_words_for_window(16) == 2
    assert key_words_for_window(20) == 2
    assert key_words_for_window(31) == 2
    assert key_words_for_window(32) == 3
    assert key_words_for_window(48) == 4
    assert key_words_for_window(64) == 4

    rng = np.random.default_rng(41)
    g, cap = 8, 128
    # values < 2^62: words 0,1 used, word1 < 2^30 so never all-ones
    keys, counts, sets = make_sketches(rng, g, cap, shared=60, priv=30)
    full = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128,
))
    red = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128,
        key_words=2))
    np.testing.assert_array_equal(red, full)
    for i in range(g):
        for j in range(g):
            assert red[i, j] == len(sets[i] & sets[j]), (i, j)

    # wide keys (word 2 nonzero, < 97): key_words=3 keeps the guard word
    keys3, counts3, sets3 = make_sketches(rng, g, cap, shared=50, priv=25,
                                          wide=True)
    red3 = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys3), jax.numpy.asarray(counts3), chunk=128,
        key_words=3))
    for i in range(g):
        for j in range(g):
            assert red3[i, j] == len(sets3[i] & sets3[j]), (i, j)

    # reduced words without an explicit key_bits
    redx = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128,
        key_words=2))
    np.testing.assert_array_equal(redx, full)

    # key_words=1 — the sweep's (w=10, k=10) config: keys fit 20 bits
    keys1 = keys.copy()
    m = np.arange(keys1.shape[1])[None, :] < counts[:, None]
    keys1[:, :, 0] = np.where(m, keys1[:, :, 0] & 0xFFFFF, keys1[:, :, 0])
    keys1[:, :, 1] = np.where(m, 0, keys1[:, :, 1])
    sets1 = []
    counts = counts.copy()
    for i in range(g):
        c = counts[i]
        # re-sort and dedup rows to keep the sorted-unique invariant
        u = np.unique(keys1[i, :c, 0])
        keys1[i, :u.size, 0] = u
        keys1[i, :u.size, 1:] = 0
        keys1[i, u.size:] = 0xFFFFFFFF
        counts[i] = u.size
        sets1.append(set(u.tolist()))
    red1 = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys1), jax.numpy.asarray(counts), chunk=128,
        key_words=1))
    for i in range(g):
        for j in range(g):
            assert red1[i, j] == len(sets1[i] & sets1[j]), (i, j)


def test_rank_layout_bit_budget():
    rng = np.random.default_rng(2)
    keys, counts, sets = make_sketches(rng, 12, 512)
    packed, n_union = build_rank_layout(keys, counts, tile=256)
    union = set()
    for s in sets:
        union |= s
    assert n_union == len(union)
    # total set bits == total valid keys
    bits = np.unpackbits(packed.view(np.uint8))
    assert int(bits.sum()) == int(counts.sum())


def test_gram_ondevice_xla_fallback():
    # wide keys: word significance in the packed sort must match the
    # 128-bit key order
    import jax
    from spaced_kmer_sketching_tpu.ops.gram import gram_all_pairs_ondevice

    rng = np.random.default_rng(37)
    g, cap = 8, 128
    keys, counts, sets = make_sketches(rng, g, cap, shared=50, priv=25,
                                       wide=True)
    mat = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128))
    for i in range(g):
        for j in range(g):
            assert mat[i, j] == len(sets[i] & sets[j]), (i, j)
    assert np.array_equal(np.diag(mat), counts)


def test_gram_ondevice_chunk_below_g():
    """chunk < G: a key shared by EVERY genome makes runs span multiple
    chunk boundaries — the cumulative open-run carry must count every
    cross-chunk pair exactly once (the old scheme required chunk >= G)."""
    import jax
    from spaced_kmer_sketching_tpu.ops.gram import gram_all_pairs_ondevice

    rng = np.random.default_rng(51)
    g, cap = 160, 128                   # g > chunk = 128
    keys, counts, sets = make_sketches(rng, g, cap, shared=100, priv=20)
    mat = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128))
    rs = rng.integers(0, g, size=(64, 2))
    for i, j in rs:
        assert mat[i, j] == len(sets[i] & sets[j]), (i, j)
    assert np.array_equal(np.diag(mat), counts.astype(np.int64))
    assert np.array_equal(mat, mat.T)


def test_gram_ondevice_key_bits_packing():
    """key_bits packing: gids ride inside the key words' spare low bits.
    40-bit keys (the w=20 sweep geometry) pack with an 8-genome gid into
    2 planes; results must match the default path and python sets."""
    import jax
    from spaced_kmer_sketching_tpu.ops.gram import (gram_all_pairs_ondevice,
                                                    pack_plan)

    assert pack_plan(40, 3) == 2
    assert pack_plan(40, 24) == 3
    assert pack_plan(54, 9) == 2
    assert pack_plan(128, 10) == 5

    rng = np.random.default_rng(61)
    g, cap = 8, 128
    keys, counts, sets = make_sketches(rng, g, cap, shared=60, priv=30)
    m = np.arange(cap)[None, :] < counts[:, None]
    keys[:, :, 1] = np.where(m, keys[:, :, 1] & 0xFF, keys[:, :, 1])
    sets = []
    for i in range(g):
        c = counts[i]
        u = np.unique(keys[i, :c, 0].astype(np.uint64)
                      | (keys[i, :c, 1].astype(np.uint64) << 32))
        keys[i, :u.size, 0] = (u & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :u.size, 1] = (u >> 32).astype(np.uint32)
        keys[i, :u.size, 2:] = 0
        keys[i, u.size:] = 0xFFFFFFFF
        counts[i] = u.size
        sets.append(set(u.tolist()))
    packed = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128,
        key_words=2, key_bits=40))
    dflt = np.asarray(gram_all_pairs_ondevice(
        jax.numpy.asarray(keys), jax.numpy.asarray(counts), chunk=128,
        key_words=2))
    np.testing.assert_array_equal(packed, dflt)
    for i in range(g):
        for j in range(g):
            assert packed[i, j] == len(sets[i] & sets[j]), (i, j)


@pytest.mark.parametrize("key_bits", [62, 40])
def test_gram_pair_tiles_matches_sets(key_bits):
    """Block-cache schedule: presort each block once, then batched rect
    macro-tiles from the cache — vs python sets, incl. the diagonal tile
    (ii == jj) and empty sketches, at a 2-plane and a 3-plane packing."""
    import jax
    import jax.numpy as jnp
    from spaced_kmer_sketching_tpu.ops.gram import (gram_pair_tiles,
                                                    pack_plan,
                                                    presort_block_packed)

    rng = np.random.default_rng(71)
    blk, cap, nb = 128, 128, 3
    g = nb * blk
    keys, counts, sets = make_sketches(rng, g, cap, shared=80, priv=30)
    if key_bits < 62:
        # keep only key_bits live bits, re-sorted and deduplicated
        for i in range(g):
            c = counts[i]
            u = np.unique((keys[i, :c, 0].astype(np.uint64)
                           | (keys[i, :c, 1].astype(np.uint64) << 32))
                          & np.uint64((1 << key_bits) - 1))
            keys[i] = 0xFFFFFFFF
            keys[i, :u.size, 0] = (u & 0xFFFFFFFF).astype(np.uint32)
            keys[i, :u.size, 1] = (u >> 32).astype(np.uint32)
            keys[i, :u.size, 2:] = 0
            counts[i] = u.size
            sets[i] = {(int(v), 0) for v in u}
    counts[5] = 0                         # empty sketch in block 0
    keys[5] = 0xFFFFFFFF
    sets[5] = set()
    gidbits = 9                           # 2*blk = 256 needs 9 bits
    pw = pack_plan(key_bits, gidbits)
    cache = jnp.stack([
        presort_block_packed(jnp.asarray(keys[b * blk:(b + 1) * blk]),
                             key_bits=key_bits, gidbits=gidbits, pw=pw)
        for b in range(nb)])
    ii = jnp.asarray([0, 0, 1, 0, 2], jnp.int32)
    jj = jnp.asarray([1, 2, 2, 0, 2], jnp.int32)
    tiles = np.asarray(gram_pair_tiles(cache, ii, jj, block=blk,
                                       gidbits=gidbits))
    rs = rng.integers(0, blk, size=(40, 2))
    for p, (bi, bj) in enumerate(zip([0, 0, 1, 0, 2], [1, 2, 2, 0, 2])):
        for a, b in rs:
            i, j = bi * blk + a, bj * blk + b
            assert tiles[p, a, b] == len(sets[i] & sets[j]), (p, i, j)
    # diagonal tile is symmetric with counts on the diagonal
    np.testing.assert_array_equal(
        np.diag(tiles[3]), counts[:blk].astype(np.int32))
    np.testing.assert_array_equal(tiles[3], tiles[3].T)


def test_tight_key_roundtrip():
    """Bit-tight slab transport (pack_keys_tight_np -> unpack_keys_tight)
    reproduces the sentinel-padded key layout exactly for every live-bit
    width it is used at."""
    import jax.numpy as jnp
    from spaced_kmer_sketching_tpu.ops.gram import (_guard_words,
                                                    pack_keys_tight_np,
                                                    tight_words4,
                                                    unpack_keys_tight)
    rng = np.random.default_rng(17)
    for kb in (24, 40, 48, 56, 62):
        g, cap = 5, 64
        kw = _guard_words(kb)
        keys = np.full((g, cap, kw), 0xFFFFFFFF, np.uint32)
        counts = rng.integers(0, cap + 1, g).astype(np.int32)
        counts[0] = cap                       # full sketch edge
        counts[1] = 0                         # empty sketch edge
        for i in range(g):
            v = np.sort(rng.integers(0, 1 << kb, counts[i]).astype(np.uint64))
            keys[i, :counts[i], 0] = (v & 0xFFFFFFFF).astype(np.uint32)
            if kw > 1:
                keys[i, :counts[i], 1] = (v >> 32).astype(np.uint32)
        tight = pack_keys_tight_np(keys, counts, kb, use_native=False)
        assert tight.shape[2] == tight_words4(kb)
        from spaced_kmer_sketching_tpu.utils import native
        if native.available():
            # the native C packer and the numpy fallback must agree
            np.testing.assert_array_equal(
                tight, native.pack_keys_tight(keys[:, :, :2], counts, kb))
        back = np.asarray(unpack_keys_tight(jnp.asarray(tight),
                                            jnp.asarray(counts), kb, kw))
        np.testing.assert_array_equal(back, keys)


def test_blocked_gram_tight_slab_matches_tile():
    """The block-cache schedule with bit-tight transport (key_bits=40, the
    window-20 shape) reproduces the probe-tile matrix."""
    import jax
    import jax.numpy as jnp
    from spaced_kmer_sketching_tpu.ops.intersect import intersection_tile
    from spaced_kmer_sketching_tpu.parallel.allpairs import blocked_all_pairs
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(23)
    g, cap, kb = 20, 256, 40
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    pool = np.unique(rng.integers(0, 1 << kb, 400).astype(np.uint64))
    for i in range(g):
        vals = np.unique(rng.choice(pool, 150))
        counts[i] = vals.size
        keys[i, :vals.size, 0] = (vals & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :vals.size, 1] = (vals >> 32).astype(np.uint32)
        keys[i, :vals.size, 2:] = 0
    mesh = make_mesh(devices=jax.devices()[:8])
    want = np.asarray(intersection_tile(jnp.asarray(keys),
                                        jnp.asarray(counts),
                                        jnp.asarray(keys),
                                        jnp.asarray(counts)))
    got = blocked_all_pairs(mesh, keys, counts, block=128, engine="gram",
                            key_words=2, key_bits=kb)
    np.testing.assert_array_equal(got, want)
