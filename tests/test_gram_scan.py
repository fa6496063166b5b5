"""Exactness of the Gram tile scan (ops/gram._gram_chunks_packed) and of the
packed (key, gid) planes it reads.

Both compute exact integer pair intersections, so equality is exact, not
approximate.  Streams are built to exercise the boundary machinery: small
key universes force multi-entry runs that straddle chunk (128-entry) and
scan-step (binner * 128-entry) boundaries, including runs spanning >= 3
chunks.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops import gram


def _stream(rng, g, cap, key_bits, gidbits, universe_size):
    """Random sorted packed (key, gid) stream + per-genome key sets.
    Keys draw from the FULL key_bits range (both uint32 words live for
    key_bits > 32) so multi-plane packing carries real entropy."""
    pw = gram.pack_plan(key_bits, gidbits)
    keys = np.full((g, cap, 2), 0xFFFFFFFF, np.uint32)
    counts = rng.integers(0, cap + 1, size=g)
    universe = rng.choice(1 << min(key_bits, 60), size=universe_size,
                          replace=False).astype(np.uint64)
    sets = []
    for i in range(g):
        ks = np.sort(rng.choice(universe, size=min(counts[i], universe.size),
                                replace=False))
        keys[i, :ks.size, 0] = (ks & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :ks.size, 1] = (ks >> np.uint64(32)).astype(np.uint32)
        sets.append(set(ks.tolist()))
    gid = jnp.broadcast_to(jnp.arange(g, dtype=jnp.uint32)[:, None],
                           (g, cap))
    kw = min(2, gram._guard_words(key_bits))
    planes = gram._pack_gid_planes(jnp.asarray(keys[:, :, :kw]), gid,
                                   key_bits, gidbits, pw)
    return gram._sort_packed(planes), sets


@pytest.mark.parametrize("seed,g,cap,key_bits,universe", [
    (0, 8, 256, 20, 128),      # dense runs, straddling everywhere
    (1, 16, 128, 16, 64),      # tiny universe -> long runs (>= 3 chunks)
    (2, 8, 256, 33, 1024),     # pw = 2 live words, sparse runs
    (3, 4, 512, 24, 16),       # runs up to 4 long crossing step boundaries
    (4, 8, 256, 60, 128),      # pw = 3 packed planes (window >= 28 shape:
                               # 60 key bits + 5 gid bits + guard > 64)
])
def test_scan_matches_brute(seed, g, cap, key_bits, universe):
    """The chunk scan equals brute-force set intersections for any
    binner (including one that does not divide the chunk count) and in
    its rect-split form."""
    rng = np.random.default_rng(seed)
    gidbits = max(2, (g - 1).bit_length() + 1)
    sw, sets = _stream(rng, g, cap, key_bits, gidbits, universe)
    gp = 256
    ref = np.asarray(gram._gram_chunks_packed(sw, gidbits, gp, 128,
                                              binner=8))
    brute = np.array([[len(a & b) for b in sets] for a in sets], np.int64)
    np.testing.assert_array_equal(ref[:g, :g].astype(np.int64), brute)
    alt = np.asarray(gram._gram_chunks_packed(sw, gidbits, gp, 128,
                                              binner=5))
    np.testing.assert_array_equal(alt, ref)
    rect = np.asarray(gram._gram_chunks_packed(sw, gidbits, gp, 128,
                                               binner=8, split=128))
    np.testing.assert_array_equal(rect, ref[:128, 128:])


def test_pack_gid_planes_fields():
    """gid, guard bit and key bits of the packed planes on a hand-built
    stream: every key twice, gids alternating 0/1, sentinels all-ones."""
    gidbits, key_bits = 4, 20
    pw = gram.pack_plan(key_bits, gidbits)
    assert pw == 1
    keys = np.repeat(np.arange(128, dtype=np.uint32), 2)
    keys[-2:] = 0xFFFFFFFF                    # one sentinel pair
    gids = np.tile(np.array([0, 1], np.uint32), 128)
    hi = np.where(keys == 0xFFFFFFFF, np.uint32(0xFFFFFFFF), np.uint32(0))
    kj = jnp.asarray(np.stack([keys, hi], axis=-1))
    (plane,) = gram._pack_gid_planes(kj, jnp.asarray(gids), key_bits,
                                     gidbits, pw)
    plane = np.asarray(plane)
    valid = (plane >> 31) == 0
    np.testing.assert_array_equal(valid, keys != 0xFFFFFFFF)
    np.testing.assert_array_equal(plane[valid] & 0xF, gids[valid])
    np.testing.assert_array_equal(plane[valid] >> gidbits, keys[valid])
    assert np.all(plane[~valid] == 0xFFFFFFFF)


def test_straddle_run_correction():
    """A key shared by every genome spans many chunks: the open-run carry
    must add the cross-chunk products exactly once."""
    g, cap, key_bits = 8, 128, 20
    gidbits = 4
    pw = gram.pack_plan(key_bits, gidbits)
    keys = np.full((g, cap, 2), 0xFFFFFFFF, np.uint32)
    # every genome holds keys {1..96}: runs of length 8 = entries 8..775
    for i in range(g):
        keys[i, :96, 0] = np.arange(1, 97, dtype=np.uint32)
        keys[i, :96, 1] = 0
    gid = jnp.broadcast_to(jnp.arange(g, dtype=jnp.uint32)[:, None],
                           (g, cap))
    planes = gram._pack_gid_planes(jnp.asarray(keys), gid, key_bits,
                                   gidbits, pw)
    sw = gram._sort_packed(planes)
    out = np.asarray(gram._gram_chunks_packed(sw, gidbits, 128, 128,
                                              binner=8))
    np.testing.assert_array_equal(out[:g, :g], np.full((g, g), 96.0))


def test_ondevice_gram_packed_keys():
    """gram_all_pairs_ondevice with 40 live key bits (the window-20
    geometry, 2 key words) and a G that is not a power of two matches
    brute-force sets."""
    rng = np.random.default_rng(7)
    g, cap = 11, 256
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    sets = []
    for i in range(g):
        c = int(rng.integers(1, cap))
        ks = np.sort(rng.choice(1 << 20, size=c, replace=False))
        keys[i, :c, 0] = ks.astype(np.uint32)
        keys[i, :c, 1:] = 0
        sets.append(set(ks.tolist()))
    counts = np.array([len(s) for s in sets], np.int32)
    out = np.asarray(gram.gram_all_pairs_ondevice(
        jnp.asarray(keys), jnp.asarray(counts), key_words=2, key_bits=40))
    brute = np.array([[len(a & b) for b in sets] for a in sets], np.int64)
    np.testing.assert_array_equal(out.astype(np.int64), brute)


def test_pair_tiles_under_shard_map():
    """gram_pair_tiles composes with shard_map (device-varying tile indices
    against a replicated cache, vary_axes for the scan carries) and
    stays exact."""
    from jax.sharding import Mesh, PartitionSpec as P

    rng = np.random.default_rng(11)
    block, cap, key_bits, gidbits = 128, 256, 40, 8
    pw = gram.pack_plan(key_bits, gidbits)
    nb = 2
    slab = np.full((nb * block, cap, 2), 0xFFFFFFFF, np.uint32)
    for i in range(nb * block):
        c = int(rng.integers(1, cap))
        ks = np.sort(rng.choice(1 << 22, size=c, replace=False)) \
            .astype(np.uint64)
        slab[i, :c, 0] = (ks & 0xFFFFFFFF).astype(np.uint32)
        slab[i, :c, 1] = (ks >> 32).astype(np.uint32)
    cache = gram.presort_blocks_packed(
        jnp.asarray(slab), block=block, key_bits=key_bits,
        gidbits=gidbits, pw=pw)
    devs = jax.devices()
    nd = 2 if len(devs) >= 2 else 1
    mesh = Mesh(np.array(devs[:nd]), ("d",))
    ii = jnp.array([0, 1] * nd, jnp.int32)
    jj = jnp.array([1, 1] * nd, jnp.int32)

    def local(cache, ii, jj):
        return gram.gram_pair_tiles(cache, ii, jj, block=block,
                                    gidbits=gidbits, vary_axes=("d",))

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), P("d"), P("d")),
                       out_specs=P("d"))
    tiles = np.asarray(jax.jit(fn)(cache, ii, jj))
    direct = np.asarray(gram.gram_pair_tiles(cache, ii[:2], jj[:2],
                                             block=block, gidbits=gidbits))
    np.testing.assert_array_equal(tiles[:2], direct)
    sets = [set(slab[i, slab[i, :, 1] != 0xFFFFFFFF, 0].tolist())
            for i in range(nb * block)]
    for a, b in ((0, 0), (5, 77), (127, 127)):
        assert direct[0, a, b] == len(sets[a] & sets[block + b])
