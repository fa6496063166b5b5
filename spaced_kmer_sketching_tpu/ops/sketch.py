"""FracMinHash sketch construction: filter + sort + dedup, all on device.

Replaces the reference's hash-map dedup (src/kmer.hpp:160-190) with a
data-parallel formulation: a sketch is a SORTED UNIQUE array of 128-bit keys
(4 x uint32 lanes) padded to a static capacity with all-ones sentinel rows,
plus a count.  Sorted arrays make intersection a merge instead of hash
probing and batch trivially across genomes.

Every stage is plain jax.numpy / lax left to XLA: extract_windows builds the
canonical keys, u64ops.fmh_keep filters them, chunked top_k compacts the
survivors and lax.sort establishes the sorted-unique invariant.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from . import u64ops
from .extract import extract_windows, run_ids_from_bounds, unpack_2bit

# Host-side constant, NOT jnp: a module-level jnp array would be committed to
# whatever backend is default at import time, and jits for another backend
# would then fetch it per lowering as a cross-device constant.
import numpy as _np
SENTINEL = _np.uint32(0xFFFFFFFF)
KEY_WORDS = 4


class SketchBatch(NamedTuple):
    """A batch of sketches: keys (..., cap, 4) uint32 sorted ascending with
    sentinel padding; count (...,) int32 unique keys; raw_kept (...,) int32
    pre-dedup kept windows (for capacity-overflow detection)."""
    keys: jnp.ndarray
    count: jnp.ndarray
    raw_kept: jnp.ndarray


def _sort_rows(words, extra=()):
    """Ascending multi-word lexicographic sort of little-endian key lanes
    `words`, carrying the `extra` operands along."""
    kw = len(words)
    operands = tuple(reversed(words)) + tuple(extra)
    out = lax.sort(operands, num_keys=kw)
    return list(reversed(out[:kw])), out[kw:]


def sketch_core(codes, run_id, mask_words, *, window: int, salt,
                scale: int, variant: str, capacity: int) -> SketchBatch:
    """Full single-genome sketch step: extract -> FracMinHash filter -> sort
    -> unique -> compact to `capacity`.

    codes/run_id: (n,) device arrays (see ops/extract.py).  `salt` is either
    a static python int or a traced (hi, lo) uint32 pair — the latter lets
    multi-seed sketching vmap over (mask, salt) without recompiling.
    Not jitted: compose under jit/vmap/shard_map.
    """
    canon, valid = extract_windows(codes, run_id, window, mask_words)
    keep = valid & u64ops.fmh_keep(*canon, salt=salt, scale=scale,
                                   variant=variant)
    return _finish_sketch(canon, keep, capacity)


def _finish_sketch(canon, keep, capacity: int) -> SketchBatch:
    """Compact kept windows -> sort -> adjacent-unique -> SketchBatch.

    Compaction chunks the window axis and runs a per-chunk top_k with
    k = capacity / n_chunks, which is much cheaper than one top_k over the
    whole axis.  A chunk can theoretically exceed its share (FracMinHash
    survivors are i.i.d. uniform, so chunk counts concentrate hard around
    the mean); overflow is detected exactly and reported via
    raw_kept > capacity, which makes the caller retry at double capacity —
    correctness never depends on the concentration, only speed does."""
    src, slot_valid, raw_kept = _compact_chunked(keep, capacity)
    words = [jnp.where(slot_valid, canon[q][src], SENTINEL)
             for q in range(KEY_WORDS)]
    # sort only the small buffer to establish the sorted-unique invariant
    words, _ = _sort_rows(words)

    # adjacent-unique inside the prefix
    idx = lax.broadcasted_iota(jnp.int32, (capacity, 1), 0)[:, 0]
    neq_prev = jnp.zeros((capacity,), jnp.bool_)
    for q in range(KEY_WORDS):
        prev = jnp.roll(words[q], 1)
        neq_prev = neq_prev | (words[q] != prev)
    in_prefix = idx < raw_kept
    uniq = in_prefix & ((idx == 0) | neq_prev)

    count = jnp.sum(uniq).astype(jnp.int32)
    keys = jnp.stack(_compact_unique(words, uniq), axis=-1)
    return SketchBatch(keys=keys, count=count, raw_kept=raw_kept)


def sketch_batch(codes, run_id, mask_words, *, window: int, salt: int,
                 scale: int, variant: str, capacity: int) -> SketchBatch:
    """Batched sketch step: codes/run_id (G, n) -> SketchBatch with leading
    G axis (a vmap of sketch_core).  Not jitted: compose under
    jit/shard_map."""
    fn = functools.partial(sketch_core, window=window, salt=salt, scale=scale,
                           variant=variant, capacity=capacity)
    return jax.vmap(fn, in_axes=(0, 0, None))(codes, run_id, mask_words)


def packed_body(n: int) -> int:
    """Code count of a compact upload for genomes of up to n codes: n
    rounded up to whole 16-code words."""
    return -(-n // 16) * 16


def sketch_batch_compact(p, bounds, rid0, valid_len, mask_words, *, n: int,
                         window: int, salt, scale: int, variant: str,
                         capacity: int) -> SketchBatch:
    """Sketch step from COMPACT uploads (0.25 B/nt instead of the 8 B/nt of
    uint32 codes + int32 run ids): p (G, body/16) uint32 raw 2-bit packed
    codes (16 per word LSB-first, utils/native.pack2bit — positions past
    the genome packed as code 0), bounds (G, K) int32 sorted interior
    run-start positions (padded with body, which never triggers), rid0
    (G,) int32 id of the run open at position 0, valid_len (G,) int32 real
    code count.  Codes and run ids are expanded on device and fed to
    sketch_batch, so the result is bit-identical to the full-plane
    upload."""
    g, pw = p.shape
    body = pw * 16
    assert body == packed_body(n), (body, packed_body(n))
    codes = unpack_2bit(p)
    pos = lax.broadcasted_iota(jnp.int32, (g, body), 1)
    run_id = run_ids_from_bounds(pos, bounds, rid0, valid_len)
    return sketch_batch(codes, run_id, mask_words, window=window, salt=salt,
                        scale=scale, variant=variant, capacity=capacity)


@functools.lru_cache(maxsize=128)
def jitted_sketch_batch_compact(n: int, window: int, salt: int, scale: int,
                                variant: str, capacity: int):
    return jax.jit(functools.partial(
        sketch_batch_compact, n=n, window=window, salt=salt, scale=scale,
        variant=variant, capacity=capacity))


@functools.lru_cache(maxsize=128)
def jitted_sketch_batch(window: int, salt: int, scale: int, variant: str,
                        capacity: int):
    """Cached jitted sketch_batch for a static config (callers construct
    partials per call; caching here keeps XLA's jit cache effective)."""
    return jax.jit(functools.partial(sketch_batch, window=window, salt=salt,
                                     scale=scale, variant=variant,
                                     capacity=capacity))


_CHUNK_WINDOWS = 32768


def _compact_chunked(keep, capacity: int):
    """Indices of kept windows, compacted chunk-locally.

    Splits the window axis into power-of-two chunks and takes the first
    (capacity / n_chunks) kept positions of each with a per-chunk top_k.
    Returns (src (capacity,) int32 indices into keep, slot_valid
    (capacity,) bool, raw_kept int32) where raw_kept > capacity signals the
    caller to retry with a larger capacity — either a true global overflow
    or a chunk exceeding its share."""
    nw = keep.shape[0]
    ch = max(1, min(nw // _CHUNK_WINDOWS,
                    capacity // 256 if capacity >= 256 else 1))
    ch = 1 << (ch.bit_length() - 1)              # power of two
    k = capacity // ch
    csz = (nw + ch - 1) // ch
    pad = ch * csz - nw
    keep_p = jnp.concatenate([keep, jnp.zeros((pad,), keep.dtype)]) \
        if pad else keep
    grid = keep_p.reshape(ch, csz)

    pos = lax.broadcasted_iota(jnp.int32, (ch, csz), 1)
    rank = jnp.where(grid, pos, jnp.int32(0x7FFFFFFF))
    kk = min(k, csz)                             # tiny inputs: chunk < share
    neg, idx = lax.top_k(-rank, kk)              # (ch, kk), ascending rank
    valid = neg != -0x7FFFFFFF
    base = lax.broadcasted_iota(jnp.int32, (ch, kk), 0) * csz
    src = (idx + base).reshape(ch * kk)
    slot_valid = valid.reshape(ch * kk)
    if ch * kk < capacity:
        fill = capacity - ch * kk
        src = jnp.concatenate([src, jnp.zeros((fill,), jnp.int32)])
        slot_valid = jnp.concatenate(
            [slot_valid, jnp.zeros((fill,), jnp.bool_)])

    counts = jnp.sum(grid, axis=1).astype(jnp.int32)
    total = jnp.sum(counts)
    overflow = jnp.any(counts > kk)
    raw_kept = jnp.where(overflow,
                         jnp.maximum(total, jnp.int32(capacity + 1)), total)
    return jnp.minimum(src, nw - 1), slot_valid, raw_kept


def _compact_unique(words, uniq):
    """Compact rows flagged `uniq` to the front, preserving sorted order:
    sentinel the duplicates and re-sort the (small) capacity buffer."""
    words = [jnp.where(uniq, w, SENTINEL) for w in words]
    words, _ = _sort_rows(words)
    return words


@functools.partial(jax.jit, static_argnames=("window", "salt", "scale",
                                             "variant", "capacity"))
def sketch_from_codes(codes, run_id, mask_words, *, window: int, salt: int,
                      scale: int, variant: str, capacity: int) -> SketchBatch:
    """Jitted single-genome sketch step (static salt)."""
    return sketch_core(codes, run_id, mask_words, window=window, salt=salt,
                       scale=scale, variant=variant, capacity=capacity)


@functools.lru_cache(maxsize=64)
def jitted_merge_sketches(capacity: int):
    """Cached jitted merge_sketches — eager composition would dispatch every
    operation as its own device program, so host-driven callers
    (streaming accumulation) jit it."""
    return jax.jit(functools.partial(merge_sketches, capacity=capacity))


def merge_sketches(keys, counts, capacity: int) -> SketchBatch:
    """Merge S sorted-unique sketches into one: keys (S, cap, 4) uint32,
    counts (S,) int32 -> SketchBatch with `capacity` rows.

    Used to combine per-chunk sketches from sequence-parallel extraction and
    per-chip partial sketches in the multi-host path.  Not jitted: compose
    under jit/shard_map.
    """
    s, cap = keys.shape[0], keys.shape[1]
    n = s * cap
    flat = keys.reshape(n, KEY_WORDS)
    idx_in = lax.broadcasted_iota(jnp.int32, (s, cap), 1)
    valid = (idx_in < counts[:, None]).reshape(n)
    words = [jnp.where(valid, flat[:, q], SENTINEL) for q in range(KEY_WORDS)]
    total = jnp.sum(counts).astype(jnp.int32)

    words, _ = _sort_rows(words)
    if n < capacity:
        pad = jnp.full((capacity - n,), SENTINEL)
        words = [jnp.concatenate([w, pad]) for w in words]
    else:
        words = [w[:capacity] for w in words]
    idx = lax.broadcasted_iota(jnp.int32, (capacity, 1), 0)[:, 0]
    neq_prev = jnp.zeros((capacity,), jnp.bool_)
    for q in range(KEY_WORDS):
        neq_prev = neq_prev | (words[q] != jnp.roll(words[q], 1))
    uniq = (idx < total) & ((idx == 0) | neq_prev)
    count = jnp.sum(uniq).astype(jnp.int32)
    keys = jnp.stack(_compact_unique(words, uniq), axis=-1)
    return SketchBatch(keys=keys, count=count, raw_kept=total)


@functools.partial(jax.jit, static_argnames=("window", "scale", "variant",
                                             "capacity"))
def sketch_from_codes_multiseed(codes, run_id, masks_words, salt_pairs, *,
                                window: int, scale: int, variant: str,
                                capacity: int) -> SketchBatch:
    """Fused multi-seed sketching: S spaced seeds evaluated over one genome
    in a single compiled program (the EP analog of SURVEY.md §2.1 — "experts"
    = seeds, all dense; BASELINE.json config 3).

    masks_words: (S, 4) uint32; salt_pairs: (S, 2) uint32 [hi, lo] rows.
    Returns a SketchBatch with a leading S axis (a vmap of sketch_core over
    the seeds).
    """
    def one(mask_w, sp):
        return sketch_core(codes, run_id, mask_w, window=window,
                           salt=(sp[0], sp[1]), scale=scale, variant=variant,
                           capacity=capacity)
    return jax.vmap(one)(masks_words, salt_pairs)
