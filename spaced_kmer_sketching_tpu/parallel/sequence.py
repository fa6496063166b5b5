"""Sequence-parallel (context-parallel) extraction for chromosome-scale input.

The reference walks each sequence serially, one nucleotide per iteration
(src/kmer_sliding.cpp:144-185).  The recurrence only depends on the trailing
`window` nucleotides, so the sequence splits exactly into contiguous chunks
with a (window-1)-nt halo: each device extracts its chunk's windows
independently after receiving the halo from its right neighbor via
`lax.ppermute` (ring exchange between devices), then per-chunk sketches
merge with one all-gather + sort-unique.  This is the CP/ring analog of SURVEY.md §2.1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.extract import run_ids_from_bounds, unpack_2bit
from ..ops.sketch import SketchBatch, merge_sketches, sketch_core
from .mesh import COL_AXIS, ROW_AXIS


def sequence_parallel_sketch_fn(mesh: Mesh, *, window: int, salt: int,
                                scale: int, variant: str, capacity: int):
    """Jitted (codes (n,), run_id (n,), mask_words (4,)) -> merged
    (replicated) SketchBatch for ONE long sequence.

    n must be divisible by the mesh size; the sequence is chunked
    contiguously over the flattened ("r", "c") ring.  Bit-exact with the
    serial path: windows never cross chunk boundaries thanks to the halo,
    and global run ids keep non-ACGT splits intact across chunks.
    """
    axes = (ROW_AXIS, COL_AXIS)
    ns = mesh.devices.size
    halo = window - 1
    recv_from_right = [((i + 1) % ns, i) for i in range(ns)]

    def step(codes, run_id, mask_words):
        me = lax.axis_index(axes)
        halo_codes = lax.ppermute(codes[:halo], axes, perm=recv_from_right)
        halo_rid = lax.ppermute(run_id[:halo], axes, perm=recv_from_right)
        # the last chunk's halo wraps around to chunk 0 — invalidate it
        halo_rid = jnp.where(me == ns - 1, jnp.full_like(halo_rid, -1),
                             halo_rid)

        local = sketch_core(jnp.concatenate([codes, halo_codes]),
                            jnp.concatenate([run_id, halo_rid]),
                            mask_words, window=window, salt=salt,
                            scale=scale, variant=variant, capacity=capacity)
        # merge across the ring: gather all chunk sketches, dedup everywhere
        all_keys = lax.all_gather(local.keys, axes, tiled=False)
        all_counts = lax.all_gather(local.count, axes, tiled=False)
        merged = merge_sketches(all_keys, all_counts, capacity)
        raw = lax.psum(local.raw_kept, axes)
        return SketchBatch(keys=merged.keys, count=merged.count, raw_kept=raw)

    spec = P((ROW_AXIS, COL_AXIS))
    # check_vma=False: the all-gather + identical dedup makes the output
    # bit-identical on every device, but JAX cannot prove the replication.
    sharded = shard_map(step, mesh=mesh, in_specs=(spec, spec, P()),
                        out_specs=SketchBatch(keys=P(), count=P(),
                                              raw_kept=P()),
                        check_vma=False)
    return jax.jit(sharded)


def sequence_parallel_sketch_compact_fn(mesh: Mesh, *, window: int,
                                        salt: int, scale: int, variant: str,
                                        capacity: int):
    """sequence_parallel_sketch_fn fed by a COMPACT upload: p (n/16,)
    uint32 raw 2-bit packed codes sharded over the ring (16 codes per
    word LSB-first, utils/native.pack2bit), bounds (K,) int32 sorted
    interior run-start positions (padded with n, which never triggers),
    rid0/valid_len (1,) int32 — each device expands ITS chunk's codes and
    run ids on device from global positions, so the host never
    materializes the O(n) uint32 code / int32 run-id arrays (8 B/nt — 2 GB
    for a chr1-scale genome) that the full-plane path uploads.  Bit-exact
    with sequence_parallel_sketch_fn: same halo ring, same merge.

    Jitted (p, bounds, rid0, valid_len, mask_words) -> replicated
    SketchBatch; p's length must be divisible by the mesh size."""
    axes = (ROW_AXIS, COL_AXIS)
    ns = mesh.devices.size
    halo = window - 1
    recv_from_right = [((i + 1) % ns, i) for i in range(ns)]

    def step(p_local, bounds, rid0, valid_len, mask_words):
        me = lax.axis_index(axes)
        codes = unpack_2bit(p_local)
        chunk = codes.shape[0]
        pos = me * chunk + lax.broadcasted_iota(jnp.int32, (chunk,), 0)
        run_id = run_ids_from_bounds(pos, bounds, rid0[0], valid_len[0])

        halo_codes = lax.ppermute(codes[:halo], axes, perm=recv_from_right)
        halo_rid = lax.ppermute(run_id[:halo], axes, perm=recv_from_right)
        halo_rid = jnp.where(me == ns - 1, jnp.full_like(halo_rid, -1),
                             halo_rid)
        local = sketch_core(jnp.concatenate([codes, halo_codes]),
                            jnp.concatenate([run_id, halo_rid]),
                            mask_words, window=window, salt=salt,
                            scale=scale, variant=variant, capacity=capacity)
        all_keys = lax.all_gather(local.keys, axes, tiled=False)
        all_counts = lax.all_gather(local.count, axes, tiled=False)
        merged = merge_sketches(all_keys, all_counts, capacity)
        raw = lax.psum(local.raw_kept, axes)
        return SketchBatch(keys=merged.keys, count=merged.count, raw_kept=raw)

    spec = P((ROW_AXIS, COL_AXIS))
    sharded = shard_map(step, mesh=mesh,
                        in_specs=(spec, P(), P(), P(), P()),
                        out_specs=SketchBatch(keys=P(), count=P(),
                                              raw_kept=P()),
                        check_vma=False)
    return jax.jit(sharded)
