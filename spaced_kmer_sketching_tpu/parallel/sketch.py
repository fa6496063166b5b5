"""Genome-level data-parallel sketching over the device mesh.

Device-mesh replacement for the reference's `cilk_for` over FASTA files
(src/kmer_set.cpp:112-133): a batch of 2-bit-packed genomes, padded to one
static length, is sharded over the flattened ("r", "c") mesh axes; every
device sketches its local genomes with the same fused extract-filter-dedup
step (ops/sketch.py), with zero cross-device communication.
"""
from __future__ import annotations

import functools
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.sketch import SketchBatch, sketch_batch
from .mesh import data_spec, pad_to_multiple


def _batch_sketch(codes, run_ids, mask_words, *, window, salt, scale,
                  variant, capacity):
    return sketch_batch(codes, run_ids, mask_words, window=window, salt=salt,
                        scale=scale, variant=variant, capacity=capacity)


def sharded_sketch_fn(mesh: Mesh, *, window: int, salt: int, scale: int,
                      variant: str, capacity: int):
    """Build the jitted sharded sketch step for a mesh.

    Takes codes (G, n) uint32 and run_ids (G, n) int32 with G divisible by
    the mesh size (pad with all -1 run_id rows); returns a SketchBatch whose
    arrays keep the genome axis sharded over the mesh.
    """
    spec = data_spec()
    fn = functools.partial(_batch_sketch, window=window, salt=salt,
                           scale=scale, variant=variant, capacity=capacity)
    sharded = shard_map(fn, mesh=mesh,
                        in_specs=(spec, spec, P()),
                        out_specs=SketchBatch(keys=spec, count=spec,
                                              raw_kept=spec))
    return jax.jit(sharded)


def sharded_sketch_compact_fn(mesh: Mesh, *, n: int, window: int, salt: int,
                              scale: int, variant: str, capacity: int):
    """Sharded COMPACT sketch step: p (G, body/16) uint32 raw 2-bit
    packed codes, bounds (G, K) int32 interior run starts (padded with
    body), rid0 (G,) int32, valid_len (G,) int32 — G divisible by the mesh
    size.  Each device expands ITS genomes' window planes on device
    (ops/sketch.sketch_batch_compact — 0.25 B/nt crosses the host
    boundary) and sketches them with zero cross-device communication; the
    output genome axis stays sharded."""
    from ..ops.sketch import sketch_batch_compact

    spec = data_spec()
    fn = functools.partial(sketch_batch_compact, n=n, window=window,
                           salt=salt, scale=scale, variant=variant,
                           capacity=capacity)
    sharded = shard_map(fn, mesh=mesh,
                        in_specs=(spec, spec, spec, spec, P()),
                        out_specs=SketchBatch(keys=spec, count=spec,
                                              raw_kept=spec))
    return jax.jit(sharded)


def pack_genome_batch(packed_list: Sequence, mesh_size: int, window: int,
                      n_codes: int = None):
    """Host-side batcher: pad G genomes to one static length and a multiple
    of the mesh size.  Returns (codes (G', n), run_ids (G', n), G).

    n_codes: GLOBAL max genome length, for multi-process callers whose
    local packed_list holds placeholders for other hosts' genomes — the
    padded length must agree across processes or the jitted programs
    diverge."""
    g = len(packed_list)
    gp = pad_to_multiple(max(g, 1), mesh_size)
    n = max([p.codes.size for p in packed_list] + [window, n_codes or 0]) \
        + window
    n = pad_to_multiple(n, 128)
    codes = np.zeros((gp, n), dtype=np.uint32)
    run_ids = np.full((gp, n), -1, dtype=np.int32)
    for i, p in enumerate(packed_list):
        t = p.codes.size
        codes[i, :t] = p.codes
        pos = 0
        for rid, ln in enumerate(p.run_lens):
            run_ids[i, pos:pos + int(ln)] = rid
            pos += int(ln)
    return codes, run_ids, g
