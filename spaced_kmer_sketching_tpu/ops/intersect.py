"""Batched sketch-set intersection counts on device.

The reference probes a hash map per element of the smaller set
(src/kmer_set.cpp:23-41).  Data-parallel replacement: sketches are SORTED
unique arrays (capacity a power of two, sentinel-padded), so |A ∩ B| is a
vectorized branchless binary search — every valid A row probes B with
log2(cap) gather+compare steps over the 4 uint32 lanes.  This replaced an
earlier concat-and-sort merge formulation: the multi-operand sort dominated
runtime (XLA TPU sorts are expensive), the probe is ~10x cheaper and batches
identically.

All shapes static; rows beyond `count` are all-ones sentinels which sort
last, so the probe's `pos < count_b` guard also disambiguates a REAL
all-ones key (possible when mask == full window) from padding.  Batched over
pairs with vmap — the all-pairs driver tiles G x G into such batches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

KEY_WORDS = 4


def _lex_lt(a_words, b_words):
    """128-bit a < b over little-endian 4-lane words (elementwise)."""
    lt = a_words[0] < b_words[0]
    for q in range(1, KEY_WORDS):
        lt = (a_words[q] < b_words[q]) | ((a_words[q] == b_words[q]) & lt)
    return lt


def _pair_intersection(keys_a, count_a, keys_b, count_b):
    """Intersection size of two sketches (cap, 4) uint32 sorted-unique."""
    cap = keys_a.shape[0]
    assert cap & (cap - 1) == 0, "sketch capacity must be a power of two"
    idx = lax.broadcasted_iota(jnp.int32, (cap, 1), 0)[:, 0]
    a = [keys_a[:, q] for q in range(KEY_WORDS)]
    bt = [keys_b[:, q] for q in range(KEY_WORDS)]

    # branchless lower_bound: pos = #elements of B < a, per A row
    pos = jnp.zeros((cap,), jnp.int32)
    step = cap >> 1
    while step:
        cand = pos + step
        probe = [bt[q][cand - 1] for q in range(KEY_WORDS)]
        pos = jnp.where(_lex_lt(probe, a), cand, pos)
        step >>= 1

    hit = [bt[q][jnp.minimum(pos, cap - 1)] for q in range(KEY_WORDS)]
    eq = jnp.ones((cap,), jnp.bool_)
    for q in range(KEY_WORDS):
        eq = eq & (hit[q] == a[q])
    found = eq & (pos < count_b) & (idx < count_a)
    return jnp.sum(found).astype(jnp.int32)


# vmap over a batch of pairs: keys (B, cap, 4), counts (B,)
pair_intersection_batch = jax.jit(jax.vmap(_pair_intersection))


@jax.jit
def intersection_tile(keys_rows, count_rows, keys_cols, count_cols):
    """All intersections of a (R-genome x C-genome) tile -> (R, C) int32.

    Double-vmap: rows x cols.  This is the device kernel the sharded
    all-pairs schedule calls per mesh tile.
    """
    def one_row(ka, ca):
        return jax.vmap(lambda kb, cb: _pair_intersection(ka, ca, kb, cb))(
            keys_cols, count_cols)
    return jax.vmap(one_row)(keys_rows, count_rows)


def all_pairs_matrix(keys, counts, *, row_tile: int = 8):
    """Full (G, G) intersection matrix in ONE jittable program: an on-device
    lax.map over row tiles bounds the (row_tile, G, cap) probe intermediates
    without host round-trips per tile.  G must divide by row_tile.

    row_tile stays small: each binary-search step materializes
    (row_tile, G, cap) x 5 word planes — at cap 8192, G 128, row_tile 8
    that is ~170 MB live; 32 took the worker down."""
    g, cap, _ = keys.shape
    assert g % row_tile == 0, (g, row_tile)

    def block(args):
        krow, crow = args
        def one_row(ka, ca):
            return jax.vmap(
                lambda kb, cb: _pair_intersection(ka, ca, kb, cb))(
                    keys, counts)
        return jax.vmap(one_row)(krow, crow)

    blocks = lax.map(block, (keys.reshape(g // row_tile, row_tile, cap,
                                          KEY_WORDS),
                             counts.reshape(g // row_tile, row_tile)))
    return blocks.reshape(g, g)
