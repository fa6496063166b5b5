"""All-pairs sketch intersection as a Gram matrix on the tensor cores.

The reference computes |A ∩ B| per pair by probing a hash map
(src/kmer_set.cpp:23-41, driven all-pairs by the cilk_for at
kmer_set.cpp:179).  This module reformulates the WHOLE G x G problem as
matrix products, which run on the accelerator's matrix units:

  - host: sort-dedup the union of all sketch keys once; every distinct
    128-bit key gets a global rank r < U,
  - each sketch g is then the 0/1 indicator column X[:, g] over ranks,
  - intersection counts = X^T X  -- exact, no hashing, no collisions.

X is shipped BIT-PACKED ((U, G/32) uint32, 1 bit per (key, genome) --
~n_union * G / 8 bytes) and a lax.scan unpacks one (T, G) tile at a time
with shifts/masks (no scatters, no gathers) and accumulates X_t^T X_t as
a matrix product.  bfloat16 inputs are
exact for 0/1 values and the f32 accumulation is exact for counts < 2^24,
so the result is bit-exact against the reference hash-probe semantics;
self-pairs land on the diagonal as |A| (the reference's ordered all-pairs
includes them, src/generators.hpp:45-58).

Work: unpack ~ 3*U*G elementwise ops, product 2*U*G^2 FLOPs -- per-pair
cost 2*U FLOPs, so throughput IMPROVES with
G at fixed union size, the opposite of the per-pair probe.  Memory is
O(U*G) bits; for collections too large for that, run this per macro-tile
of the blocked all-pairs schedule (parallel/allpairs.py) so U is the
union of one genome block pair.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_WORD = 32
LANES = 128                 # packed-plane row width of the presort caches


def build_rank_layout(keys: np.ndarray, counts: np.ndarray, *,
                      tile: int = 2048):
    """Host preprocessing: global ranks + bit-packed indicator matrix.

    keys: (G, cap, 4) uint32 sketch key lanes (sorted-unique per sketch,
    padding past counts ignored); counts: (G,) valid rows.

    Returns (packed, n_union): packed (n_tiles, tile, ceil(G/32)) uint32
    where bit g%32 of word [t, r, g//32] says genome g contains the key
    of global rank t*tile + r.  The rank order is any consistent total
    order over 128-bit keys -- only identity matters for intersection.
    """
    G, cap, _ = keys.shape
    counts = np.asarray(counts)
    valid_g, valid_p = np.nonzero(np.arange(cap)[None, :] < counts[:, None])
    kv = keys[valid_g, valid_p]                              # (N, 4) u32
    lo = kv[:, 0].astype(np.uint64) | (kv[:, 1].astype(np.uint64) << 32)
    hi = kv[:, 2].astype(np.uint64) | (kv[:, 3].astype(np.uint64) << 32)

    order = np.lexsort((lo, hi))
    ls, hs = lo[order], hi[order]
    first = np.ones(ls.size, bool)
    first[1:] = (ls[1:] != ls[:-1]) | (hs[1:] != hs[:-1])
    inv = np.empty(ls.size, np.int64)
    inv[order] = np.cumsum(first) - 1
    n_union = int(inv[order[-1]]) + 1 if ls.size else 0

    n_tiles = max(1, -(-n_union // tile))
    words = -(-G // _WORD)
    packed = np.zeros((n_tiles * tile * words,), np.uint32)
    if ls.size:
        # OR together bits sharing a (rank, word) cell without ufunc.at
        # (unbuffered .at is ~10 us/element): sort by flat address, then
        # one reduceat per address run
        addr = inv * words + valid_g // _WORD
        bitv = np.uint32(1) << (valid_g % _WORD).astype(np.uint32)
        o2 = np.argsort(addr, kind="stable")
        a_s, b_s = addr[o2], bitv[o2]
        run = np.ones(a_s.size, bool)
        run[1:] = a_s[1:] != a_s[:-1]
        starts = np.nonzero(run)[0]
        packed[a_s[starts]] = np.bitwise_or.reduceat(b_s, starts)
    return packed.reshape(n_tiles, tile, words), n_union


def gram_accumulate(packed, *, vary_axes=()):
    """(n_tiles, T, W) packed bits -> (32*W, 32*W) float32 partial Gram.

    Traceable building block: also used under shard_map with the tiles
    axis sharded over the mesh (parallel/allpairs.sharded_gram_fn), where
    per-device partials are psum-merged — all-zero padding tiles
    contribute nothing, so tile-count padding is free.  Under shard_map
    pass the mesh axis names as vary_axes so the scan carry matches the
    device-varying operand type."""
    nt, t, w = packed.shape
    bit = lax.broadcasted_iota(jnp.uint32, (1, 1, _WORD), 2)

    def body(acc, pk):
        bits = (pk[:, :, None] >> bit) & jnp.uint32(1)        # (T, W, 32)
        x = bits.reshape(t, w * _WORD).astype(jnp.bfloat16)
        return acc + jnp.dot(x.T, x, preferred_element_type=jnp.float32), None

    acc0 = jnp.zeros((w * _WORD, w * _WORD), jnp.float32)
    if vary_axes:
        acc0 = lax.pcast(acc0, tuple(vary_axes), to="varying")
    acc, _ = lax.scan(body, acc0, packed)
    return acc


@jax.jit
def gram_intersections_device(packed):
    """(n_tiles, T, W) packed bits -> exact (32*W, 32*W) int32 matrix."""
    return gram_accumulate(packed).astype(jnp.int32)


def gram_all_pairs(keys, counts, *, tile: int = 2048) -> np.ndarray:
    """Exact (G, G) int64 all-pairs intersection matrix (host entry)."""
    keys = np.asarray(keys)
    g = keys.shape[0]
    packed, _ = build_rank_layout(keys, np.asarray(counts), tile=tile)
    out = gram_intersections_device(jnp.asarray(packed))
    return np.asarray(out)[:g, :g].astype(np.int64)


# --- fully device-side variant -------------------------------------------
#
# build_rank_layout is host NumPy: it downloads every sketch, pays host
# first-touch page faults (utils/hostmem.py), and re-uploads the packed
# matrix; its (union keys x G/32) bitmap also grows past host memory for
# large collections.  The device formulation never leaves the device: the
# G sorted sketches (already on device, the sketch step's output) are
# sorted into one global (key, genome) order with the genome id packed
# into the key words, then scanned in
# C-entry chunks where each chunk contributes S^T E S to the Gram matrix:
#   S (C, G)  = one-hot genome indicators (0 for sentinel rows),
#   E (C, C)  = key-equality indicator (equal keys are contiguous after
#               the sort, but E needs no rank bookkeeping at all),
# so intersections accumulate as two matrix products per chunk — 0/1 values
# are exact in bfloat16 and counts < 2^24 are exact in the f32
# accumulator.  Key runs straddling chunk boundaries are repaired by a
# cumulative open-run carry (see _gram_chunks_packed), so the chunk size
# is a free parameter (128 by default) rather than being bounded
# below by G.


# --- packed (key, gid) planes ---------------------------------------------
#
# The sort's cost is linear in the number of planes it carries, and
# canonical masked keys only occupy 2*window bits (utils/masks.py), so the
# genome id rides INSIDE the key words instead of as a separate tag plane:
#   packed = (key << gidbits) | gid
# over pw = ceil((key_bits + gidbits + 1) / 32) uint32 words.  The +1 is a
# guard bit: every valid packed value has the top bit of its top word clear,
# while sentinel rows are forced to all-ones in every word — validity is a
# single top-bit test, key equality is packed equality with the low gidbits
# of word 0 masked off, and the gid is word 0's low bits.  Equal keys sort
# by gid within a run, which is irrelevant for the Gram scan.  (This also
# retires the all-ones/poly-T sentinel collision edge case of the old
# 4-word layout: an all-ones VALID key still has its guard bit clear.)


def pack_plan(key_bits: int, gidbits: int) -> int:
    """Packed word count pw for key_bits-bit keys + gidbits-bit gids."""
    return (key_bits + gidbits + 1 + 31) // 32


def _guard_words(key_bits: int) -> int:
    """Input key words needed for unambiguous sentinel detection: the
    kw_in packed words, plus the guard word above them when key_bits is
    an exact word multiple (a valid key could then be all-ones in every
    packed word; its guard word is all-zero, the sentinel's all-ones).
    Capped at 4 (the full key layout — at key_bits=128 the all-ones
    ambiguity is impossible for canonical keys, same argument as
    ops/sketch.finish_words)."""
    kw_in = (key_bits + 31) // 32
    return min(4, kw_in + (1 if key_bits % 32 == 0 else 0))


def _pack_gid_planes(keys, gid, key_bits: int, gidbits: int, pw: int):
    """keys (..., cap, >= kw_in) uint32 little-endian key words (sorted
    unique per sketch, all-ones sentinel padding), gid (..., cap) uint32 —
    returns pw planes (..., cap) of (key << gidbits) | gid, sentinels
    forced to all-ones in every word.

    Sentinel detection reads EVERY provided key word, not just the kw_in
    packed ones: when key_bits is an exact word multiple, a valid key of
    all-ones in its kw_in words is otherwise indistinguishable from the
    sentinel, so callers should include the (all-zero for valid keys)
    guard word above key_bits — _guard_words() says how many words; the
    entry points slice that many automatically."""
    kw_in = (key_bits + 31) // 32
    s = gidbits
    assert 0 < s < 32
    sent = keys[..., 0] == jnp.uint32(0xFFFFFFFF)
    for q in range(1, keys.shape[-1]):
        sent = sent & (keys[..., q] == jnp.uint32(0xFFFFFFFF))
    ones = jnp.uint32(0xFFFFFFFF)
    planes = []
    for q in range(pw):
        hi = keys[..., q] << s if q < kw_in else jnp.zeros_like(gid)
        lo = (keys[..., q - 1] >> (32 - s)) if 0 < q <= kw_in else (
            gid if q == 0 else jnp.zeros_like(gid))
        planes.append(jnp.where(sent, ones, hi | lo))
    return planes


def _gram_chunks_packed(sw, gidbits: int, gp: int, chunk: int,
                        binner: int = 32, split: int | None = None,
                        vary_axes=()):
    """Gram accumulation over a SORTED packed (key, gid) stream.

    sw: pw x (N,) sorted packed words (see _pack_gid_planes).  Returns the
    (gp, gp) f32 Gram, or with split = r the (r, gp - r) RECT part only —
    rows are gids < r, columns gids >= r — at a quarter of the S^T·T matmul
    work (the blocked schedule's macro-tiles only need the rect part).

    Validity, key equality and gid all come from the packed words: valid
    = guard bit clear, key equality = packed equality with gid bits
    masked, gid = low bits of word 0.

    A key run straddling chunk boundaries contributes Σ_parts p^T p
    instead of (Σ_parts p)^T (Σ_parts p); the missing cross terms are
    added via a CUMULATIVE open-run carry: P[t] = multi-hot of all
    earlier-chunk entries of the run open at chunk t's start, updated as
    P[t+1] = P[t] + a[t] when chunk t purely continues a run (its last
    key equals its carried key — sorted order then makes the whole chunk
    one run) else a[t], where a[t] is chunk t's last-run multi-hot.
    Every (earlier-parts x this-part) cross product is then P[t] b[t]^T
    + b[t] P[t]^T with b[t] = this chunk's carried-key prefix multi-hot
    — counted exactly once however many boundaries the run spans, so
    `chunk` is NOT constrained by G.  Within a scan step the carry
    recurrence over the `binner` chunks is a segmented (multiplier in
    {0,1}) affine prefix scan, log2(binner) rounds over (B, gp) f32."""
    n = sw[0].shape[0]
    pw = len(sw)
    nchunks = n // chunk
    binner = max(1, min(binner, nchunks))
    while nchunks % binner:
        binner -= 1
    outer = nchunks // binner
    xs = [w.reshape(outer, binner, chunk) for w in sw]

    gmask = jnp.uint32((1 << gidbits) - 1)
    gids = jnp.arange(gp, dtype=jnp.int32)
    r = gp if split is None else split
    c0 = 0 if split is None else split

    def body(carry, x):
        acc, pk, pa = carry            # pk: pw x () u32, pa: (gp,) f32
        valid = (x[pw - 1] >> 31) == 0               # guard bit (B, C)
        kf = [x[0] & ~gmask] + [x[q] for q in range(1, pw)]
        gid = (x[0] & gmask).astype(jnp.int32)
        # S: one-hot genome rows, zeroed for sentinel entries   (B, C, gp)
        s = ((gid[:, :, None] == gids[None, None, :]) & valid[:, :, None]) \
            .astype(jnp.bfloat16)
        # E: key-equality indicator within each chunk (B, C, C).  Equal
        # keys are CONTIGUOUS (the stream is sorted), so E = run-id
        # equality with run ids from a lane cumsum over neighbor-change
        # flags — one (B, C, C) compare instead of pw of them.
        lane = lax.broadcasted_iota(jnp.int32, (binner, chunk), 1)
        bnd = lane == 0
        for q in range(pw):
            prev = jnp.concatenate([kf[q][:, :1], kf[q][:, :-1]], axis=1)
            bnd = bnd | (kf[q] != prev)
        rid_c = jnp.cumsum(bnd.astype(jnp.int32), axis=1)       # (B, C)
        e = (rid_c[:, :, None] == rid_c[:, None, :]).astype(jnp.bfloat16)
        sc = s[:, :, c0:]
        # bf16 operands, exact: S and E are 0/1, and T = E S is 0/1 too
        # (gids are unique within an equal-key run: sketch keys are unique
        # per genome); the f32 accumulator is exact below 2^24
        t = lax.dot_general(e, sc, (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.bfloat16)
        acc = acc + jnp.dot(s[:, :, :r].reshape(binner * chunk, r).T,
                            t.reshape(binner * chunk, gp - c0),
                            preferred_element_type=jnp.float32)
        # per-chunk last key + its genome vector a              (B, gp)
        lk = [kf[q][:, -1] for q in range(pw)]
        eql = valid
        for q in range(pw):
            eql = eql & (kf[q] == lk[q][:, None])
        pk_all = [jnp.concatenate([pk[q][None], lk[q][:-1]])
                  for q in range(pw)]
        eqp = valid
        for q in range(pw):
            eqp = eqp & (kf[q] == pk_all[q][:, None])
        # a/b as ONE masked reduce over the chunk axis (two separate
        # reduces would pay the (B, C, gp) select twice).  Both counts
        # are <= chunk, so
        # r = a + base*b with base the next power of two above chunk is
        # exact in f32 (r < 2^24 for chunk <= 2048) and splits back
        # losslessly (base is a power of two: the scaling is exact).
        base = float(1 << chunk.bit_length())
        assert chunk * (base + 1) < (1 << 24)
        w = (eql.astype(jnp.float32)
             + base * eqp.astype(jnp.float32))                   # (B, C)
        r_ab = jnp.sum(w[:, :, None] * s.astype(jnp.float32), axis=1,
                       dtype=jnp.float32)                        # (B, gp)
        b = jnp.floor(r_ab * (1.0 / base))
        a = r_ab - base * b
        # cumulative open-run carry (segmented affine prefix — see the
        # docstring's derivation)
        cont = jnp.ones((binner,), jnp.bool_)
        for q in range(pw):
            cont = cont & (lk[q] == pk_all[q])
        xv = jnp.concatenate([pa[None], a[:-1]], axis=0)       # (B, gp)
        fv = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                              cont[:-1].astype(jnp.float32)])  # (B,)
        d = 1
        while d < binner:
            xs_ = jnp.concatenate([jnp.zeros((d, gp), jnp.float32),
                                   xv[:-d]], axis=0)
            fs_ = jnp.concatenate([jnp.zeros((d,), jnp.float32), fv[:-d]])
            xv = xv + fv[:, None] * xs_
            fv = fv * fs_
            d *= 2
        # bf16 operands, exact: P and b hold 0/1 per genome (a genome
        # appears at most once in a key run); f32 accumulation
        p_all = xv.astype(jnp.bfloat16)                        # (B, gp)
        b16 = b.astype(jnp.bfloat16)
        if split is None:
            corr = jnp.dot(p_all.T, b16,
                           preferred_element_type=jnp.float32)  # (gp, gp)
            acc = acc + corr + corr.T
        else:
            acc = acc + jnp.dot(p_all[:, :r].T, b16[:, c0:],
                                preferred_element_type=jnp.float32) \
                      + jnp.dot(b16[:, :r].T, p_all[:, c0:],
                                preferred_element_type=jnp.float32)
        p_out = jnp.where(cont[-1], xv[-1] + a[-1], a[-1])
        return (acc, [lk[q][-1] for q in range(pw)], p_out), None

    acc0 = jnp.zeros((r, gp - c0), jnp.float32)
    pk0 = [jnp.full((), 0xFFFFFFFF, jnp.uint32) for _ in range(pw)]
    pa0 = jnp.zeros((gp,), jnp.float32)
    if vary_axes:
        # under shard_map with device-varying operands the carry inits must
        # match the body's varying output type (same as gram_accumulate)
        acc0 = lax.pcast(acc0, tuple(vary_axes), to="varying")
        pk0 = [lax.pcast(p, tuple(vary_axes), to="varying") for p in pk0]
        pa0 = lax.pcast(pa0, tuple(vary_axes), to="varying")
    (acc, _, _), _ = lax.scan(body, (acc0, pk0, pa0), xs)
    return acc


def _sort_packed(planes):
    """Sort packed (key, gid) planes (any shape, flattened) as one
    multi-word key, most significant plane last."""
    pw = len(planes)
    n = planes[0].size
    srt = lax.sort(tuple(p.reshape(n) for p in planes[::-1]), num_keys=pw)
    return list(srt[::-1])


def key_words_for_window(window: int) -> int:
    """Number of uint32 key words that can be nonzero for masked canonical
    keys of `window` nucleotides, PLUS a sentinel guard bit: valid keys
    have bit positions < 2*window (spaced-seed masks only set bits there,
    utils/masks.py), so the word holding bit 2*window is zero for every
    valid key and all-ones for the sentinel.  Capped at 4; at window=64
    the guard does not exist and the documented all-ones/poly-T sentinel
    collision edge case of the 4-word layout applies unchanged."""
    return min(4, 2 * window // 32 + 1)


@functools.partial(jax.jit, static_argnames=("chunk", "key_words",
                                             "key_bits"))
def gram_rect_ondevice(keys_r, counts_r, keys_c, counts_c, *,
                       chunk: int | None = None, key_words: int = 4,
                       key_bits: int | None = None):
    """One-dispatch macro-tile: stacks the row and column blocks ON DEVICE
    and returns the full (R+C, R+C) on-device Gram — callers slice
    [:R, R:] for the rect tile and its transpose for the mirror.
    Superseded on the hot path by the cached presort_block_packed +
    gram_pair_tiles schedule (parallel/allpairs.py); kept as the
    arbitrary-shape fallback."""
    keys = jnp.concatenate([keys_r, keys_c])
    counts = jnp.concatenate([counts_r, counts_c])
    return gram_all_pairs_ondevice(keys, counts, chunk=chunk,
                                   key_words=key_words, key_bits=key_bits)


@functools.partial(jax.jit, static_argnames=("chunk", "key_words",
                                             "key_bits", "binner"))
def gram_all_pairs_ondevice(keys, counts, *, chunk: int | None = None,
                            key_words: int = 4, key_bits: int | None = None,
                            binner: int | None = None):
    """Exact (G, G) int32 all-pairs intersection matrix, computed without
    any host round-trip: keys (G, cap, W) uint32 device sketches (sorted
    unique, sentinel padded — SketchBatch.keys layout; W >= key_words, so
    callers may upload only the low key-word planes), counts (G,).

    The genome id is PACKED into the key words' spare low bits
    (_pack_gid_planes) — the sort carries pw = ceil((key_bits +
    gidbits + 1)/32) planes instead of key_words + 1, and the chunked
    S^T E S scan (cumulative open-run carry, so chunk is NOT constrained
    by G) reads validity/equality/gid straight from the packed words.

    key_bits: how many low key bits can be nonzero for valid keys —
    callers that know the window pass 2*window (spaced-seed masks set no
    bits past that, utils/masks.py); defaults to 32*key_words.  Pads
    genomes to gp = ceil128(G), the one-hot width of the scan."""
    g, cap, _ = keys.shape
    if key_bits is None:
        key_bits = 32 * key_words
    assert key_bits <= 32 * keys.shape[2]
    if chunk is None:
        chunk = LANES
    gp = max(LANES, -(-g // LANES) * LANES)
    n = g * cap
    gidbits = max(1, (g - 1).bit_length())
    pw = pack_plan(key_bits, gidbits)

    gid = jnp.broadcast_to(jnp.arange(g, dtype=jnp.uint32)[:, None],
                           (g, cap))
    kw_use = min(keys.shape[2], _guard_words(key_bits))
    planes = _pack_gid_planes(keys[:, :, :kw_use], gid, key_bits, gidbits, pw)
    sw = _sort_packed(planes)

    npad = -n % chunk
    if npad:
        sw = [jnp.concatenate([w, jnp.full((npad,), 0xFFFFFFFF, jnp.uint32)])
              for w in sw]
    if binner is None:
        # more chunks per scan step amortize the per-step overhead, but
        # the (binner, chunk, gp) one-hot temporary must stay bounded
        binner = max(8, min(256, (1 << 24) // (chunk * gp)))
    acc = _gram_chunks_packed(sw, gidbits, gp, chunk, binner=binner)
    return acc[:g, :g].astype(jnp.int32)


# --- block-cache programs for the blocked all-pairs schedule ---------------
#
# The blocked 10k-genome sweep (parallel/allpairs.blocked_all_pairs) was
# re-sorting both blocks from scratch inside every macro-tile and paying a
# dispatch per tile.  These programs restructure it: every block's
# (key, gid) stream is packed + sorted ONCE (presort_block_packed) into a
# device-resident cache, and macro-tiles are then batched MANY per
# dispatch (gram_pair_tiles) — each tile sorts the concatenation of two
# cached streams and runs the rect-split chunk scan.


# --- bit-tight slab transport ----------------------------------------------
#
# The blocked schedule's host->device slab is pure transfer cost (the
# sketches were downloaded from earlier sweeps or a store); canonical keys
# only carry key_bits = 2*window live bits, so shipping whole uint32 word
# planes moves zero ballast — e.g. 64 bits/key for window-20's 40-bit keys.
# Tight transport packs groups of 4 keys bit-contiguously into
# ceil(4*key_bits/32) words (static per-slot word/shift offsets: unpacking
# is vectorized shifts, no gathers) and reconstructs sentinel rows from the
# sketch counts instead of a flag bit.


def tight_words4(key_bits: int) -> int:
    """Words per 4-key group of bit-tight packed keys."""
    return (4 * key_bits + 31) // 32


def pack_keys_tight_np(keys, counts, key_bits: int, use_native: bool = True):
    """Host side: keys (G, cap, >=ceil(key_bits/32)) uint32 sorted-unique
    sketches (anything at/past counts[g] ignored), cap % 4 == 0 ->
    (G, cap/4, tight_words4(key_bits)) uint32.

    Routed through the native C++ packer when available: the numpy
    formulation's u64 temporaries pay host first-touch page faults."""
    import numpy as np
    g, cap = keys.shape[:2]
    assert cap % 4 == 0
    kb = key_bits
    assert kb <= 64
    from ..utils import native as _native
    if use_native and _native.available():
        kw2 = min(keys.shape[2], 2)
        return _native.pack_keys_tight(
            np.ascontiguousarray(keys[:, :, :kw2]), counts, kb)
    w4 = tight_words4(kb)
    lo = keys[:, :, 0].astype(np.uint64)
    hi = (keys[:, :, 1].astype(np.uint64) if keys.shape[2] > 1
          else np.zeros_like(lo))
    v = (lo | (hi << np.uint64(32)))
    if kb < 64:
        v &= (np.uint64(1) << np.uint64(kb)) - np.uint64(1)
    # zero the sentinel tail (reconstructed from counts on device)
    idx = np.arange(cap, dtype=np.int64)[None, :]
    v = np.where(idx < np.asarray(counts).astype(np.int64)[:, None], v, 0)
    v = v.reshape(g, cap // 4, 4)
    out = np.zeros((g, cap // 4, w4), np.uint32)
    m32 = np.uint64(0xFFFFFFFF)
    for j in range(4):
        o = j * kb
        w, s = divmod(o, 32)
        out[:, :, w] |= ((v[:, :, j] << np.uint64(s)) & m32).astype(np.uint32)
        rem = kb - (32 - s)          # bits spilling past word w
        if rem > 0:
            out[:, :, w + 1] |= ((v[:, :, j] >> np.uint64(32 - s))
                                 & m32).astype(np.uint32)
        if rem > 32:
            out[:, :, w + 2] |= (v[:, :, j] >> np.uint64(64 - s)) \
                .astype(np.uint32)
    return out


def unpack_keys_tight(tight, counts, key_bits: int, kw_out: int):
    """Device side: inverse of pack_keys_tight_np -> (G, cap, kw_out)
    uint32 with all-ones sentinel rows at/past counts (bit-identical to
    the original sentinel-padded sketch layout)."""
    g, cap4, w4 = tight.shape
    kb = key_bits
    cap = cap4 * 4
    slots = []
    for j in range(4):
        words = []
        for q in range(kw_out):
            if 32 * q >= kb:                 # word past the key's live bits
                words.append(jnp.zeros((g, cap4), jnp.uint32))
                continue
            o = j * kb + 32 * q
            w, s = divmod(o, 32)
            val = tight[:, :, w] >> s if w < w4 else jnp.zeros(
                (g, cap4), jnp.uint32)
            if s and w + 1 < w4:
                val = val | (tight[:, :, w + 1] << (32 - s))
            live = kb - 32 * q           # live bits in this output word
            if 0 < live < 32:
                val = val & jnp.uint32((1 << live) - 1)
            words.append(val)
        slots.append(jnp.stack(words, axis=-1))         # (G, cap4, kw_out)
    keys = jnp.stack(slots, axis=2).reshape(g, cap, kw_out)
    idx = lax.broadcasted_iota(jnp.int32, (g, cap), 1)
    sent = idx >= counts.astype(jnp.int32)[:, None]
    return jnp.where(sent[:, :, None], jnp.uint32(0xFFFFFFFF), keys)


def _presort_core(keys, key_bits: int, gidbits: int, pw: int):
    blk, cap = keys.shape[:2]
    n = blk * cap
    gid = jnp.broadcast_to(jnp.arange(blk, dtype=jnp.uint32)[:, None],
                           (blk, cap))
    kw_use = min(keys.shape[2], _guard_words(key_bits))
    planes = _pack_gid_planes(keys[:, :, :kw_use], gid, key_bits, gidbits, pw)
    return jnp.stack([p.reshape(n // LANES, LANES)
                      for p in _sort_packed(planes)])


@functools.partial(jax.jit, static_argnames=("key_bits", "gidbits", "pw"))
def presort_block_packed(keys, *, key_bits: int, gidbits: int, pw: int):
    """keys (blk, cap, >= ceil(key_bits/32)) uint32 sorted-unique sketches
    (sentinel padded; blk*cap a multiple of 128) -> (pw, blk*cap/128, 128)
    sorted packed planes with LOCAL gids [0, blk)."""
    return _presort_core(keys, key_bits, gidbits, pw)


@functools.partial(jax.jit, static_argnames=("block", "key_bits", "gidbits",
                                             "pw"))
def presort_blocks_packed(slab, *, block: int, key_bits: int, gidbits: int,
                          pw: int):
    """Presort EVERY block of a (nb*block, cap, kw) slab in one dispatch
    (lax.scan over blocks) -> (nb, pw, block*cap/128, 128) cache.  The
    slab crosses the host->device boundary as ONE transfer."""
    g, cap, kw = slab.shape
    nb = g // block
    assert g % block == 0

    def body(_, kb):
        return None, _presort_core(kb, key_bits, gidbits, pw)

    _, cache = lax.scan(body, None, slab.reshape(nb, block, cap, kw))
    return cache


@functools.partial(jax.jit, static_argnames=("block", "key_bits", "gidbits",
                                             "pw"))
def presort_blocks_tight(tight, counts, *, block: int, key_bits: int,
                         gidbits: int, pw: int):
    """presort_blocks_packed fed by a BIT-TIGHT slab (pack_keys_tight_np,
    tight (nb*block, cap/4, tight_words4(key_bits)) + counts (nb*block,)):
    the host->device transfer carries only the live key bits — 5/8 of the
    word-plane bytes for window-20's 40-bit keys — and each block is
    unpacked to full words inside the per-block scan step, so the
    full-width slab never materializes at once."""
    g, cap4, w4 = tight.shape
    nb = g // block
    assert g % block == 0
    kw = _guard_words(key_bits)

    def body(_, tc):
        tb, cb = tc
        kb_full = unpack_keys_tight(tb, cb, key_bits, kw)
        return None, _presort_core(kb_full, key_bits, gidbits, pw)

    _, cache = lax.scan(
        body, None, (tight.reshape(nb, block, cap4, w4),
                     counts.reshape(nb, block)))
    return cache


@functools.partial(jax.jit, static_argnames=("block", "gidbits", "chunk",
                                             "binner", "out_dtype",
                                             "vary_axes"))
def gram_pair_tiles(cache, ii, jj, *, block: int, gidbits: int,
                    chunk: int = 128, binner: int = 32,
                    out_dtype=jnp.int32, vary_axes=()):
    """Batched macro-tiles: cache (nb, pw, rows, 128) per-block sorted
    packed planes (presort_block_packed), ii/jj (P,) int32 block indices
    with ii <= jj -> (P, block, block) int32 rect intersection tiles
    (rows = block ii's genomes, cols = block jj's).  ii == jj yields the
    full symmetric diagonal tile.  One dispatch covers all P tiles — a
    lax.scan whose body sorts the two cached streams together and runs
    the rect-split chunk scan.

    block must be a multiple of 128 (the rect one-hot width is 2*block)
    and gidbits must cover 2*block (the jj side's gids are offset by
    +block inside the packed gid field)."""
    nb, pw, rows, _ = cache.shape
    assert block % LANES == 0
    assert (1 << gidbits) >= 2 * block

    def body(_, ij):
        i, j = ij[0], ij[1]
        pi = lax.dynamic_slice(cache, (i, 0, 0, 0), (1, pw, rows, LANES))[0]
        pj = lax.dynamic_slice(cache, (j, 0, 0, 0), (1, pw, rows, LANES))[0]
        # offset the jj side's gids by +block (low gid field of word 0;
        # no carry: local gid < block <= 2^(gidbits-1)).  Sentinels stay
        # all-ones (their guard bit is set).
        validj = (pj[pw - 1] >> 31) == 0
        pj0 = pj[0] + jnp.where(validj, jnp.uint32(block), jnp.uint32(0))
        pjs = [pj0 if q == 0 else pj[q] for q in range(pw)]
        sw = _sort_packed([jnp.concatenate([pi[q], pjs[q]], axis=0)
                           for q in range(pw)])
        acc = _gram_chunks_packed(sw, gidbits, 2 * block, chunk,
                                  binner=binner, split=block,
                                  vary_axes=vary_axes)
        # int16 when the caller knows counts fit (cap <= 32767): half the
        # result download bytes
        return None, acc.astype(out_dtype)

    _, tiles = lax.scan(body, None, jnp.stack([ii, jj], axis=1))
    return tiles
