"""Per-stage device times of the portable FASTA-to-ANI path.

    python tools/time_stages.py [--genomes 128] [--nt 1550000] [--reps 5]

Times, on whatever device JAX picks (the report names it), what XLA makes
of each stage at the pipeline's dispatch shapes:

  * the sketch step per dispatch of --genomes genomes of --nt codes, split
    into extract + FracMinHash filter and finish (chunked top_k compaction
    + sort-unique), and whole, from full code planes and from the compact
    2-bit upload;
  * the presort of one --genomes block of sketches into packed
    (key, genome) planes;
  * the tile scan per macro-tile (gram_pair_tiles);
  * the two all-pairs engines on one block-pair macro-tile: the
    binary-search probe (ops/intersect.intersection_tile) and the Gram
    tile, whose results must be identical.

Each time is the median of --reps runs after a warm-up run, host clock
around work that ends in block_until_ready.  Prints one line per stage
and a JSON object as the last line.
"""
import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_s(fn, reps):
    import jax
    jax.block_until_ready(fn())                  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=128)
    ap.add_argument("--nt", type=int, default=1_550_000)
    ap.add_argument("--window", type=int, default=20)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--scale", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from spaced_kmer_sketching_tpu.utils.jaxcache import (
        enable_compilation_cache)
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.ops import gram, u64ops
    from spaced_kmer_sketching_tpu.ops import sketch as sk_ops
    from spaced_kmer_sketching_tpu.ops.extract import (extract_windows,
                                                       unpack_2bit)
    from spaced_kmer_sketching_tpu.ops.intersect import intersection_tile
    from spaced_kmer_sketching_tpu.utils import boosthash, native
    from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = "not available"
    print(f"nvidia-smi: {smi}")

    g, n, w = args.genomes, args.nt, args.window
    cfg = SketchConfig(window=w, k=args.k, scale=args.scale)
    mask = spaced_seed_mask(w, args.k, cfg.mask_seed)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, w, cfg.nonce, "modern")
    cap = cfg.capacity_for(n - w + 1)
    mw = jnp.asarray(mask.words_u32)
    key = jax.random.PRNGKey(0)
    body = sk_ops.packed_body(n)
    p = jax.random.bits(key, (g, body // 16), jnp.uint32)
    codes = jax.jit(lambda p: unpack_2bit(p)[:, :n])(p)
    rid = jnp.zeros((g, n), jnp.int32)
    bounds = jnp.full((g, 8), body, jnp.int32)
    rid0 = jnp.zeros((g,), jnp.int32)
    vlen = jnp.full((g,), n, jnp.int32)
    out = {"device_kind": dev.device_kind, "nvidia_smi": smi,
           "genomes": g, "nt": n, "window": w, "capacity": cap}

    def extract_filter(c, r):
        canon, valid = extract_windows(c, r, w, mw)
        return canon, valid & u64ops.fmh_keep(*canon, salt=salt,
                                              scale=args.scale,
                                              variant="modern")

    ef = jax.jit(jax.vmap(extract_filter))
    canon, keep = ef(codes, rid)
    fin = jax.jit(jax.vmap(functools.partial(sk_ops._finish_sketch,
                                             capacity=cap)))
    full = sk_ops.jitted_sketch_batch(w, salt, args.scale, "modern", cap)
    comp = sk_ops.jitted_sketch_batch_compact(n, w, salt, args.scale,
                                              "modern", cap)
    out["extract_filter_ms"] = 1e3 * _median_s(lambda: ef(codes, rid),
                                               args.reps)
    out["finish_ms"] = 1e3 * _median_s(lambda: fin(canon, keep), args.reps)
    out["sketch_step_ms"] = 1e3 * _median_s(
        lambda: full(codes, rid, mw), args.reps)
    out["sketch_step_compact_ms"] = 1e3 * _median_s(
        lambda: comp(p, bounds, rid0, vlen, mw), args.reps)
    del canon, keep
    res = comp(p, bounds, rid0, vlen, mw)
    a = full(codes, rid, mw)
    assert np.array_equal(np.asarray(res.keys), np.asarray(a.keys)), \
        "compact and full-plane sketch steps differ"
    counts = np.asarray(res.count)
    assert int(np.asarray(res.raw_kept).max()) <= cap, "capacity overflow"
    if native.available():
        c0 = np.asarray(codes[0]).astype(np.uint8)
        ref = native.sketch_codes(c0, np.array([n], np.int64), mask.lo,
                                  mask.hi, w, salt, args.scale, False)
        k0 = np.asarray(res.keys[0, :counts[0]]).astype(np.uint64)
        assert ref.shape[0] == counts[0] and np.array_equal(
            k0[:, 0] | (k0[:, 1] << np.uint64(32)), ref[:, 0]), \
            "sketch differs from the native oracle"
    for name in ("extract_filter_ms", "finish_ms", "sketch_step_ms",
                 "sketch_step_compact_ms"):
        print(f"{name} (per {g} x {n} dispatch): {out[name]:.3f}")

    # presort of one block, then macro-tiles from a two-block cache
    key_bits = 2 * w
    kw = gram._guard_words(key_bits)
    cap_b = max(128, 1 << int(counts.max() - 1).bit_length())
    kb = res.keys[:, :cap_b, :kw]
    gidbits = max(1, (2 * g - 1).bit_length())
    pw = gram.pack_plan(key_bits, gidbits)
    pre = functools.partial(gram.presort_block_packed, key_bits=key_bits,
                            gidbits=gidbits, pw=pw)
    out["presort_ms"] = 1e3 * _median_s(lambda: pre(kb), args.reps)
    print(f"presort_ms (per {g}-genome block, cap {cap_b}): "
          f"{out['presort_ms']:.3f}")
    res2 = comp(jax.random.bits(jax.random.PRNGKey(1), p.shape, jnp.uint32),
                bounds, rid0, vlen, mw)
    kb2 = res2.keys[:, :cap_b, :kw]
    cache = jnp.stack([pre(kb), pre(kb2)])
    ntile = 8
    ii = jnp.zeros((ntile,), jnp.int32)
    jj = jnp.ones((ntile,), jnp.int32)
    tiles = functools.partial(gram.gram_pair_tiles, block=g,
                              gidbits=gidbits, binner=256 if g <= 256
                              else 32)
    out["tile_ms"] = 1e3 * _median_s(lambda: tiles(cache, ii, jj),
                                     args.reps) / ntile
    print(f"tile_ms (per {g}x{g} macro-tile): {out['tile_ms']:.3f}")

    # the two all-pairs engines on one macro-tile
    one_i, one_j = ii[:1], jj[:1]
    kr = res.keys[:, :cap_b]
    kc = res2.keys[:, :cap_b]
    out["gram_tile_ms"] = 1e3 * _median_s(lambda: tiles(cache, one_i, one_j),
                                          args.reps)
    out["probe_tile_ms"] = 1e3 * _median_s(
        lambda: intersection_tile(kr, res.count, kc, res2.count), args.reps)
    gt = np.asarray(tiles(cache, jnp.zeros((2,), jnp.int32),
                          jnp.arange(2, dtype=jnp.int32)))
    for t, (kx, cx) in enumerate(((kr, res.count), (kc, res2.count))):
        pt = np.asarray(intersection_tile(kr, res.count, kx, cx))
        assert np.array_equal(gt[t], pt), "probe and Gram tiles differ"
    assert np.array_equal(np.diag(gt[0]), counts), "diagonal != counts"
    print(f"one macro-tile: gram {out['gram_tile_ms']:.3f} ms, probe "
          f"{out['probe_tile_ms']:.3f} ms (identical counts)")
    out["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
