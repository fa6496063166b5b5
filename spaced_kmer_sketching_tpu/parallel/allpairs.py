"""Sharded all-pairs sketch intersections: 2-D tiling over the device mesh.

The reference parallelizes the O(G^2) pair loop with `cilk_for`
(src/kmer_set.cpp:167-184).  Here the (G x G) intersection matrix is tiled
over the ("r", "c") mesh: device (i, j) receives row-block i (sharded over
"r") and column-block j (sharded over "c") of the stacked sketch array and
computes its tile with the batched merge-intersection kernel — XLA inserts
the all-gathers implied by the two different shardings of the same operand.

ANI math stays on device (f32) for the throughput path; the CSV/parity path
recomputes containment/ANI in host f64 (ani.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.intersect import intersection_tile
from .mesh import COL_AXIS, ROW_AXIS, pad_to_multiple


def sharded_all_pairs_fn(mesh: Mesh):
    """Jitted (keys (G, cap, 4), counts (G,)) -> (G, G) int32 intersections,
    G divisible by both mesh axis sizes; output sharded (r, c)."""
    def tile(keys_r, counts_r, keys_c, counts_c):
        return intersection_tile(keys_r, counts_r, keys_c, counts_c)

    sharded = shard_map(
        tile, mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(COL_AXIS), P(COL_AXIS)),
        out_specs=P(ROW_AXIS, COL_AXIS))

    @jax.jit
    def run(keys, counts):
        return sharded(keys, counts, keys, counts)
    return run


def sharded_all_pairs_rect_fn(mesh: Mesh):
    """Jitted rectangular tile: (keys_r (R, cap, 4), counts_r, keys_c
    (C, cap, 4), counts_c) -> (R, C) int32; R divisible by the "r" axis, C
    by the "c" axis.  The building block of the blocked 10k-genome schedule
    (blocked_all_pairs): row blocks stay device-resident while column
    blocks stream through."""
    sharded = shard_map(
        intersection_tile, mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(COL_AXIS), P(COL_AXIS)),
        out_specs=P(ROW_AXIS, COL_AXIS))
    return jax.jit(sharded)


def blocked_all_pairs(mesh: Mesh, keys, counts, *, block: int = 512,
                      out=None, engine: str = "auto", key_words: int = 4,
                      key_bits: int | None = None, pair_batch: int = 256):
    """Memory-bounded all-pairs schedule for genome counts whose stacked
    sketches exceed device memory: the (G, G) matrix is computed in
    (block x block) macro-tiles.  `keys` may be a numpy array or a callable
    block-provider `keys(i0, i1) -> (np keys (i1-i0, cap, 4), np counts)`
    (e.g. reading from store.SketchStore) so the full matrix operand never
    materializes in host memory either.

    engine='probe' tiles each macro-tile over the mesh with the
    binary-search kernel (sharded_all_pairs_rect_fn; row blocks stay
    device-resident while column blocks stream — the block-row/column
    reuse schedule of SURVEY.md §7).  engine='gram' stacks the row and
    column blocks and runs the fully on-device Gram engine
    (ops/gram.gram_all_pairs_ondevice) per macro-tile; intersection counts
    are symmetric, so one stacked tile fills BOTH (bi, bj) and (bj, bi)
    and only the upper triangle of macro-tiles is computed.  'auto' picks
    gram.  Reference semantics: ordered pairs incl. self,
    src/generators.hpp:45-58."""
    import numpy as np

    if callable(keys):
        provider = keys
        g = counts
    else:
        all_keys_np, all_counts_np = keys, counts
        g = all_keys_np.shape[0]

        def provider(i0, i1):
            return all_keys_np[i0:i1], all_counts_np[i0:i1]

    if engine == "auto":
        engine = "gram"
    out = out if out is not None else np.zeros((g, g), np.int32)
    nb = (g + block - 1) // block
    if (engine == "gram" and block % 128 == 0
            and block & (block - 1) == 0):
        # block-cache schedule: presort each block ONCE into a
        # device-resident packed cache, then batch many macro-tiles per
        # dispatch instead of paying one dispatch per tile as the
        # per-tile schedule below does.  It materializes the
        # whole key slab on host and a presorted cache per device, so
        # collections too large for that (the store-backed out-of-core
        # case) fall through to the streaming per-tile schedule, which
        # only ever holds O(block) uploads plus a bounded column cache.
        from ..ops.gram import _guard_words, pack_plan

        kb = key_bits if key_bits is not None else 32 * key_words
        k0, _ = provider(0, min(block, g))
        cap0, words0 = np.asarray(k0).shape[1], np.asarray(k0).shape[2]
        nb_l = (g + block - 1) // block
        gidbits = max(1, (2 * block - 1).bit_length())
        kw_slice = min(words0, _guard_words(kb))
        slab_b = nb_l * block * cap0 * kw_slice * 4
        cache_b = nb_l * block * cap0 * pack_plan(kb, gidbits) * 4
        import os as _os
        budget = int(_os.environ.get("SKS_BLOCKED_CACHE_BUDGET", 8 << 30))
        if slab_b + cache_b <= budget:
            devs = list(mesh.devices.flat) if mesh is not None else [None]
            return _gram_blocked_cached(provider, g, block, out, devs, kb,
                                        pair_batch)
    if engine == "gram":
        # pair-level data parallelism, the reference's cilk_for over pairs
        # (src/kmer_set.cpp:179): macro-tiles are independent, so they
        # round-robin over the mesh devices and execute concurrently
        # (dispatch is async; results are collected after the full sweep)
        from collections import deque

        from ..ops.gram import gram_all_pairs_ondevice, gram_rect_ondevice
        devs = list(mesh.devices.flat) if mesh is not None else [None]
        max_inflight = 8 * len(devs)

        def put(x, dev):
            x = jnp.asarray(x)
            return jax.device_put(x, dev) if dev is not None else x

        def slim(k):
            # upload only the key words the engine reads — canonical keys
            # have no bits at or above 2*window, so the high planes are
            # zero/sentinel ballast
            return np.ascontiguousarray(np.asarray(k)[:, :, :key_words])

        pending = deque()

        def collect_one():
            r0, r1, c0, c1, dmat = pending.popleft()
            mat = np.asarray(dmat)
            if c0 == r0:
                out[r0:r1, c0:c1] = mat
            else:
                r = r1 - r0
                out[r0:r1, c0:c1] = mat[:r, r:]
                out[c0:c1, r0:r1] = mat[r:, :r]

        # every tile of row bi runs on one device: its row block uploads
        # once per row, column blocks are cached device-side up to a byte
        # budget (single device covers the whole sweep; multi-device runs
        # re-upload a column block at most once per row), and the stacked
        # operand is concatenated ON device instead of re-uploading both
        # blocks per tile.  Per-tile dispatch is deliberate: dispatches are
        # async and the runtime pipelines them, and multi-tile groups
        # straddling the diagonal would recompute known tiles.
        cache_budget = 2 << 30
        col_cache, cached_bytes = {}, 0
        single = len(devs) == 1
        for bi in range(nb):
            dev = devs[bi % len(devs)]
            r0, r1 = bi * block, min(g, (bi + 1) * block)
            krow, crow = provider(r0, r1)
            kr, cr = put(slim(krow), dev), put(crow, dev)
            pending.append((r0, r1, r0, r1, gram_all_pairs_ondevice(
                kr, cr, key_words=key_words)))
            if len(pending) >= max_inflight:
                collect_one()
            for bj in range(bi + 1, nb):
                c0, c1 = bj * block, min(g, (bj + 1) * block)
                hit = single and bj in col_cache
                if hit:
                    kc, cc = col_cache[bj]
                else:
                    kcol, ccol = provider(c0, c1)
                    kc, cc = put(slim(kcol), dev), put(ccol, dev)
                    add = kc.nbytes + cc.nbytes
                    if single and cached_bytes + add <= cache_budget:
                        col_cache[bj] = (kc, cc)
                        cached_bytes += add
                pending.append((r0, r1, c0, c1, gram_rect_ondevice(
                    kr, cr, kc, cc, key_words=key_words)))
                if len(pending) >= max_inflight:
                    collect_one()
        while pending:
            collect_one()
        return out

    fn = sharded_all_pairs_rect_fn(mesh)
    for bi in range(nb):
        r0, r1 = bi * block, min(g, (bi + 1) * block)
        krow, crow = provider(r0, r1)
        dk_r, dc_r = jnp.asarray(krow), jnp.asarray(crow)
        for bj in range(nb):
            c0, c1 = bj * block, min(g, (bj + 1) * block)
            kcol, ccol = (dk_r, dc_r) if bj == bi else provider(c0, c1)
            tile = fn(dk_r, dc_r, jnp.asarray(kcol), jnp.asarray(ccol))
            out[r0:r1, c0:c1] = np.asarray(tile)
    return out


def _gram_blocked_cached(provider, g: int, block: int, out, devs,
                         key_bits: int, pair_batch: int):
    """Block-cache gram schedule (ops/gram.presort_block_packed +
    gram_pair_tiles): every block's (key, gid) stream is packed and
    merge-sorted ONCE into a device-resident cache; the upper triangle of
    macro-tiles is then computed in pair_batch-sized batches, ONE dispatch
    each (a lax.scan over tiles — each is a single bitonic pair-merge of
    two pre-sorted streams plus the rect-split chunk scan).  Pair-level
    data parallelism (the reference's cilk_for over pairs,
    src/kmer_set.cpp:179) maps to batches round-robining over the mesh
    devices, each holding its own cache replica."""
    import numpy as np

    nb = (g + block - 1) // block
    gidbits = max(1, (2 * block - 1).bit_length())
    from ..ops.gram import (_guard_words, gram_pair_tiles, pack_keys_tight_np,
                            pack_plan, presort_blocks_packed,
                            presort_blocks_tight, tight_words4)
    pw = pack_plan(key_bits, gidbits)
    kw_in = max(1, _guard_words(key_bits))
    # the dominant scan temporary scales with 2*block; larger batches of
    # chunks amortize XLA scan-step overhead but grow that temporary
    binner = 128 if block <= 256 else 32

    # host slab: one contiguous array so the host->device boundary is
    # crossed by ONE transfer per device.  When the bit-tight
    # layout saves words (pack_keys_tight_np: only the 2*window live key
    # bits travel, e.g. 5/8 of the word planes at window 20), the slab is
    # packed tight on host and unpacked inside the presort scan.
    blocks_np, counts_np_l = [], []
    use_tight = None
    for b in range(nb):
        i0, i1 = b * block, min(g, (b + 1) * block)
        kb, cb = provider(i0, i1)
        kb = np.asarray(kb)[:, :, :kw_in]
        cb = np.asarray(cb)
        if use_tight is None:
            use_tight = (kb.shape[1] % 4 == 0
                         and tight_words4(key_bits) < 4 * kw_in)
        if kb.shape[0] < block:             # ragged tail: sentinel sketches
            pad = np.full((block - kb.shape[0],) + kb.shape[1:],
                          0xFFFFFFFF, np.uint32)
            kb = np.concatenate([kb, pad])
            cb = np.concatenate([cb, np.zeros(block - cb.shape[0],
                                              cb.dtype)])
        blocks_np.append(pack_keys_tight_np(kb, cb, key_bits)
                         if use_tight else kb)
        counts_np_l.append(cb)
    slab_np = np.ascontiguousarray(np.concatenate(blocks_np))
    counts_all = np.concatenate(counts_np_l).astype(np.int32)
    del blocks_np

    caches = []
    for d in devs:
        slab = jnp.asarray(slab_np) if d is None else jax.device_put(
            slab_np, d)
        if use_tight:
            cnts = (jnp.asarray(counts_all) if d is None
                    else jax.device_put(counts_all, d))
            caches.append(presort_blocks_tight(
                slab, cnts, block=block, key_bits=key_bits,
                gidbits=gidbits, pw=pw))
        else:
            caches.append(presort_blocks_packed(
                slab, block=block, key_bits=key_bits, gidbits=gidbits,
                pw=pw))

    return pair_tile_sweep(caches, g, block, out, devs, gidbits=gidbits,
                           binner=binner, pair_batch=pair_batch)


def pair_tile_sweep(caches, g: int, block: int, out, devs, *, gidbits: int,
                    binner: int, pair_batch: int = 256):
    """Upper-triangle macro-tile sweep over per-device presorted caches:
    batches of pair_batch tiles dispatch round-robin over `devs` (pair-level
    data parallelism, the reference's cilk_for over pairs,
    src/kmer_set.cpp:179), each batch ONE gram_pair_tiles program; results
    are collected after the full dispatch sweep and mirrored into `out`
    (intersections are symmetric).  `caches[d]` is device d's replica of
    the (nb, pw, rows, 128) presort_blocks_packed cache."""
    import numpy as np

    from ..ops.gram import gram_pair_tiles

    nb = (g + block - 1) // block
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    pb = min(pair_batch, len(pairs))
    pend = []
    for k in range(0, len(pairs), pb):
        chunk_pairs = pairs[k:k + pb]
        arr = np.array(chunk_pairs + [(0, 0)] * (pb - len(chunk_pairs)),
                       np.int32).reshape(pb, 2)
        di = (k // pb) % len(devs)
        ii, jj = jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1])
        if devs[di] is not None:
            ii = jax.device_put(ii, devs[di])
            jj = jax.device_put(jj, devs[di])
        cap = caches[di].shape[2] * 128 // block
        dt = gram_pair_tiles(
            caches[di], ii, jj, block=block, gidbits=gidbits,
            binner=binner,
            out_dtype=jnp.int16 if cap <= 32767 else jnp.int32)
        # schedule D2H now, read later: batch k's tile download overlaps
        # batch k+1's device scan instead of serializing after the sweep
        dt.copy_to_host_async()
        pend.append((chunk_pairs, dt))
    for chunk_pairs, dt in pend:
        tiles = np.asarray(dt)
        for p, (bi, bj) in enumerate(chunk_pairs):
            r0, r1 = bi * block, min(g, (bi + 1) * block)
            c0, c1 = bj * block, min(g, (bj + 1) * block)
            t = tiles[p]
            out[r0:r1, c0:c1] = t[:r1 - r0, :c1 - c0]
            if bj != bi:
                out[c0:c1, r0:r1] = t[:r1 - r0, :c1 - c0].T
    return out


@functools.lru_cache(maxsize=32)
def _mesh_tiles_fn(mesh: Mesh, block: int, gidbits: int, binner: int,
                   int16: bool):
    """Jitted (cache (nb, pw, rows, 128) replicated, ii/jj (P,) sharded)
    -> (P, block, block) tiles sharded over every mesh device: each device
    scans ITS slice of the macro-tile list against its cache replica —
    pair-level data parallelism in one program."""
    from ..ops.gram import gram_pair_tiles

    def local(cache, ii, jj):
        return gram_pair_tiles(cache, ii, jj, block=block, gidbits=gidbits,
                               binner=binner,
                               out_dtype=jnp.int16 if int16 else jnp.int32,
                               vary_axes=(ROW_AXIS, COL_AXIS))

    sharded = shard_map(local, mesh=mesh,
                        in_specs=(P(), P((ROW_AXIS, COL_AXIS)),
                                  P((ROW_AXIS, COL_AXIS))),
                        out_specs=P((ROW_AXIS, COL_AXIS)))
    return jax.jit(sharded)


def mesh_all_pairs_packed(mesh: Mesh, put, get, keys_np, counts_np, *,
                          block: int = 128, key_bits: int = 128):
    """(G, G) int32 all-pairs intersections over the mesh via the on-device
    packed (key, gid) engine — the HOST-FREE mesh path: one replicated slab
    upload, a single scanned presort of every block (replicated per
    device), and the upper-triangle macro-tiles sharded over every mesh
    device in ONE program.  Replaces the host rank-layout build
    (ops/gram.build_rank_layout), which is host-bound; bit-identical to the single-device gram engines (the
    scan/merge machinery is shared).  The reference's cilk_for over pairs
    at mesh scale, src/kmer_set.cpp:179.

    put/get: placement callables (MeshSketcher._put/_get) handling the
    multi-process global-array conventions."""
    import numpy as np

    from ..ops.gram import _guard_words, pack_plan, presort_blocks_packed

    g, cap, kw_in = keys_np.shape
    kw = min(kw_in, _guard_words(key_bits))
    nb = max(1, (g + block - 1) // block)
    capp = pad_to_multiple(max(cap, 128), 128)
    gp = nb * block
    slab = np.full((gp, capp, kw), 0xFFFFFFFF, np.uint32)
    slab[:g, :cap] = keys_np[:, :, :kw]
    # sentinel rows past each sketch's count are already in keys_np's
    # padding; rows past g are whole sentinel pseudo-sketches (sort to the
    # back, contribute nothing)

    gidbits = max(1, (2 * block - 1).bit_length())
    pw = pack_plan(key_bits, gidbits)
    dslab = put(slab, P())
    cache = presort_blocks_packed(dslab, block=block, key_bits=key_bits,
                                  gidbits=gidbits, pw=pw)

    mesh_size = int(np.prod(list(mesh.shape.values())))
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    npairs = len(pairs)
    pp = pad_to_multiple(npairs, mesh_size)
    arr = np.array(pairs + [(0, 0)] * (pp - npairs), np.int32)
    binner = 128 if block <= 256 else 32
    fn = _mesh_tiles_fn(mesh, block, gidbits, binner, capp <= 32767)
    tiles = get(fn(cache, put(arr[:, 0], P((ROW_AXIS, COL_AXIS))),
                   put(arr[:, 1], P((ROW_AXIS, COL_AXIS)))))

    out = np.zeros((g, g), np.int32)
    for p, (bi, bj) in enumerate(pairs):
        r0, r1 = bi * block, min(g, (bi + 1) * block)
        c0, c1 = bj * block, min(g, (bj + 1) * block)
        if r0 >= g or c0 >= g:
            continue
        t = tiles[p]
        out[r0:r1, c0:c1] = t[:r1 - r0, :c1 - c0]
        if bj != bi:
            out[c0:c1, r0:r1] = t[:r1 - r0, :c1 - c0].T
    return out


def sharded_gram_fn(mesh: Mesh):
    """Jitted (packed (nt, T, W) uint32) -> (32W, 32W) int32 all-pairs
    intersections via the Gram formulation (ops/gram.py), with the
    union-rank tile axis sharded over EVERY mesh device (pure data
    parallelism over rank space — each device multiplies its tile slice
    and a psum over both mesh axes merges the partial Grams).
    nt must be divisible by mesh.size; pad with all-zero tiles (free)."""
    from jax import lax as _lax

    from ..ops.gram import gram_accumulate

    def part(pk):
        return _lax.psum(gram_accumulate(pk, vary_axes=(ROW_AXIS, COL_AXIS)),
                         (ROW_AXIS, COL_AXIS))

    sharded = shard_map(part, mesh=mesh,
                        in_specs=(P((ROW_AXIS, COL_AXIS)),),
                        out_specs=P())

    @jax.jit
    def run(packed):
        return sharded(packed).astype(jnp.int32)
    return run


def sharded_ani_fn(mesh: Mesh, care_positions: int):
    """Jitted (keys, counts) -> (inter (G, G) int32, ani (G, G) f32) with the
    reference's containment/estimator semantics on device
    (src/ani_estimation.cpp:24-42; denominator = row genome's sketch size,
    the FIRST of the ordered pair per src/kmer-sketching.cpp:198)."""
    pairs = sharded_all_pairs_fn(mesh)
    inv_k = 1.0 / float(care_positions)

    @jax.jit
    def run(keys, counts):
        inter = pairs(keys, counts)
        c = jnp.where(inter == 0, 0.0,
                      inter.astype(jnp.float32)
                      / jnp.maximum(counts[:, None], 1).astype(jnp.float32))
        ani = jnp.where(c <= 0, 0.0, jnp.power(c, inv_k))
        return inter, ani
    return run
