"""Benchmark harness — prints ONE JSON line for the driver.

Headline metric: spaced k-mers/s/chip through the device sketch step
(extraction + FracMinHash filter + sort-unique dedup), the hot loop of the
reference (src/kmer_sliding.cpp:144-185 + kmer_set insert).  vs_baseline
compares against the native C++ scalar pipeline (native/sketchlib.cpp,
an -O3 single-thread re-statement of the reference algorithm), measured
live on the same host — the reference itself publishes no numbers
(BASELINE.md).

Usage: python bench.py [--platform cpu] [--nt N] [--iters I]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _first_mismatch(lo, hi, ref):
    n = min(lo.shape[0], ref.shape[0])
    bad = np.nonzero((lo[:n] != ref[:n, 0]) | (hi[:n] != ref[:n, 1]))[0]
    return int(bad[0]) if bad.size else f"len {lo.shape[0]} vs {ref.shape[0]}"


def _device_fields() -> dict:
    """The device every result was measured on, as JAX reports it."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="override JAX platform (default: JAX's own choice)")
    ap.add_argument("--nt", type=int, default=1 << 21,
                    help="genome length in nucleotides")
    ap.add_argument("--iters", type=int, default=16, metavar="I",
                    help="steady-state timing iterations (>= 1; 16 "
                         "amortizes the per-loop completion sync — 8 "
                         "measured ~3%% slower cadence for identical "
                         "device work)")
    ap.add_argument("--window", type=int, default=20)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--scale", type=int, default=200)
    ap.add_argument("--mode",
                    choices=("sketch", "allpairs", "multiseed", "stream",
                             "e2e"),
                    default="sketch",
                    help="sketch: fused extraction step (headline); "
                         "allpairs: G x G ANI matrix throughput; "
                         "multiseed: S seeds fused over one genome "
                         "(BASELINE config 3); "
                         "stream: bounded-memory FASTA-to-sketch of one "
                         "long genome (BASELINE config 5); "
                         "e2e: genomes -> (G, G) ANI matrix in ONE flow "
                         "with device-resident sketches (pipeline.py, "
                         "BASELINE config 4)")
    ap.add_argument("--genomes", type=int, default=128,
                    help="G for --mode allpairs")
    ap.add_argument("--seeds", type=int, default=8,
                    help="S for --mode multiseed")
    ap.add_argument("--segment-nt", type=int, default=1 << 24,
                    help="streaming segment size for --mode stream")
    ap.add_argument("--batch", type=int, default=8,
                    help="genomes per device dispatch in --mode sketch")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the on-hardware key-level parity gate")
    ap.add_argument("--probe", action="store_true",
                    help="allpairs: use the XLA binary-search probe instead "
                         "of the Gram-matrix path")
    ap.add_argument("--blocked", action="store_true",
                    help="allpairs: run the memory-bounded macro-tile "
                         "schedule (parallel.allpairs.blocked_all_pairs, "
                         "BASELINE config 4) over --genomes genomes with "
                         "--block-size blocks")
    ap.add_argument("--block-size", type=int, default=256,
                    help="macro-tile block for --blocked")
    ap.add_argument("--pair-batch", type=int, default=256,
                    help="macro-tiles per dispatch for --blocked (the "
                         "block-cache schedule)")
    ap.add_argument("--ondevice", action="store_true",
                    help="allpairs: fully on-device Gram engine (sort of "
                         "packed (key, genome) pairs + chunked S^T E S "
                         "matmuls; no host rank-layout build)")
    ap.add_argument("--e2e-source", choices=("files", "codes", "device"),
                    default="codes",
                    help="e2e genome source: files = synthesized FASTA "
                         "files on disk (full ingest path); codes = host "
                         "RNG genomes (skips the FASTA text parse); "
                         "device = genomes synthesized on device (zero "
                         "ingest — the pure device-resident number)")
    ap.add_argument("--e2e-repeat", type=int, default=1,
                    help="runs of the e2e flow in one process; the last "
                         "run is reported (strips per-process program-load "
                         "latency)")
    ap.add_argument("--e2e-mesh", action="store_true",
                    help="e2e: run the sharded MeshDevicePipeline over all "
                         "local devices instead of DevicePipeline")
    ap.add_argument("--dispatch", type=int, default=128,
                    help="genomes per sketch dispatch in --mode e2e")
    args = ap.parse_args()
    if args.iters < 1:
        ap.error("--iters must be >= 1")

    import os
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from spaced_kmer_sketching_tpu.utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    from spaced_kmer_sketching_tpu.utils.hostmem import tune as _malloc_tune
    _malloc_tune()
    import jax.numpy as jnp

    from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
    from spaced_kmer_sketching_tpu.ops.sketch import jitted_sketch_batch
    from spaced_kmer_sketching_tpu.utils import boosthash, native
    from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

    if args.mode == "allpairs":
        return bench_allpairs(args)
    if args.mode == "multiseed":
        return bench_multiseed(args)
    if args.mode == "stream":
        return bench_stream(args)
    if args.mode == "e2e":
        return bench_e2e(args)

    window, k, scale = args.window, args.k, args.scale
    n, g = args.nt, args.batch
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (g, n)).astype(np.uint32)
    run_id = np.stack([run_ids_from_lens([n], n)] * g)
    capacity = 1 << max(10, (max(1, 2 * n // scale)).bit_length())

    dev_mask = jnp.asarray(mask.words_u32)
    dev_args = (jnp.asarray(codes), jnp.asarray(run_id))
    fn = jitted_sketch_batch(window, salt, scale, "modern", capacity)

    def step():
        return fn(*dev_args, dev_mask)

    out = step()                      # compile + warm
    np.asarray(out.count)             # forced completion
    assert int(np.asarray(out.raw_kept).max()) <= capacity
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = step()
    np.asarray(out.count)
    dt = (time.perf_counter() - t0) / args.iters
    windows = g * (n - window + 1)
    dev_rate = windows / dt

    # --- CPU baselines: native C++ pipeline, 1 thread and whole host -------
    # (the reference is Cilk-parallel over files, kmer_set.cpp:124, so the
    # honest machine-level comparison is the multi-threaded number)
    cpu_rate = cpu_mt_rate = None
    if native.available():
        import os as _os
        runs_lens = np.array([n], dtype=np.int64)
        codes8 = codes[0].astype(np.uint8)       # scalar path: one genome
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            native.sketch_codes(codes8, runs_lens, mask.lo, mask.hi,
                                window, salt, scale, False)
        cpu_dt = (time.perf_counter() - t0) / reps
        cpu_rate = (n - window + 1) / cpu_dt

        nthreads = _os.cpu_count() or 1
        codes8b = codes.astype(np.uint8)
        t0 = time.perf_counter()
        native.sketch_batch_mt(codes8b, mask.lo, mask.hi, window, salt,
                               scale, False, nthreads)
        cpu_mt_rate = windows / (time.perf_counter() - t0)

    # --- on-hardware parity gate: KEY ARRAYS (not just counts) vs the -----
    # independent native C++ pipeline, plus intersection cross-checks.
    # This runs on the device every bench invocation and fails loudly.
    verified = None
    if native.available() and not args.no_verify:
        verified = True
        runs_lens = np.array([n], dtype=np.int64)
        keys_dev = np.asarray(out.keys).astype(np.uint64)
        cnt_dev = np.asarray(out.count)
        ref_keys = []
        for i in range(g):
            ref = native.sketch_codes(codes[i].astype(np.uint8), runs_lens,
                                      mask.lo, mask.hi, window, salt, scale,
                                      False)
            ref_keys.append(ref)
            c = int(cnt_dev[i])
            lo = keys_dev[i, :c, 0] | (keys_dev[i, :c, 1] << np.uint64(32))
            hi = keys_dev[i, :c, 2] | (keys_dev[i, :c, 3] << np.uint64(32))
            if (c != ref.shape[0] or not np.array_equal(lo, ref[:, 0])
                    or not np.array_equal(hi, ref[:, 1])):
                verified = False
                print(f"VERIFY FAIL genome {i}: device count {c} vs native "
                      f"{ref.shape[0]}; first mismatch at "
                      f"{_first_mismatch(lo, hi, ref)}", file=sys.stderr)
        # device intersection tile vs native sorted-merge counts
        from spaced_kmer_sketching_tpu.ops.intersect import intersection_tile
        t = min(g, 4)
        tile = np.asarray(intersection_tile(
            jnp.asarray(np.asarray(out.keys)[:t]), jnp.asarray(cnt_dev[:t]),
            jnp.asarray(np.asarray(out.keys)[:t]), jnp.asarray(cnt_dev[:t])))
        for i in range(t):
            for j in range(t):
                want = native.intersect_sorted(ref_keys[i], ref_keys[j])
                if int(tile[i, j]) != want:
                    verified = False
                    print(f"VERIFY FAIL intersect ({i},{j}): device "
                          f"{int(tile[i, j])} vs native {want}",
                          file=sys.stderr)

    result = {
        "metric": "spaced_kmers_per_s_per_chip",
        "value": round(dev_rate, 1),
        "unit": "windows/s",
        "vs_baseline": (round(dev_rate / cpu_rate, 3)
                        if cpu_rate else None),
        "baseline_cpu_scalar_windows_per_s": (round(cpu_rate, 1)
                                              if cpu_rate else None),
        "vs_host_mt": (round(dev_rate / cpu_mt_rate, 3)
                       if cpu_mt_rate else None),
        "baseline_cpu_host_windows_per_s": (round(cpu_mt_rate, 1)
                                            if cpu_mt_rate else None),
        **_device_fields(),
        "nt": n, "batch": g, "window": window, "k": k, "scale": scale,
        "sketch_count": int(np.asarray(out.count)[0]),
        "step_ms": round(dt * 1e3, 3),
        "verified": verified,
    }
    print(json.dumps(result))
    return 0 if verified in (True, None) else 1


def bench_allpairs(args) -> int:
    """G x G all-pairs ANI matrix throughput (BASELINE.json config 2).

    Default path: the Gram-matrix formulation (ops/gram.py) — global rank
    layout built host-side once per experiment, intersections as one
    scanned X^T X matmul on device, full-matrix verification against the
    native C++ sorted-merge.  --probe selects the XLA binary-search probe;
    --ondevice the fully on-device Gram engine."""
    import time
    import jax
    import jax.numpy as jnp
    from spaced_kmer_sketching_tpu.utils import native

    g = args.genomes
    cap = 1 << 13                      # 8192 keys/sketch, typical E. coli size
    rng = np.random.default_rng(0)
    # synthetic sorted-unique sketches sharing a common core (realistic hit
    # rates): 60% shared pool + 40% private keys per genome.  Key values are
    # bounded by 2*window bits like real masked canonical keys, so the
    # key_words reduction measured here matches driver behavior.
    kbits = min(62, 2 * args.window)
    pool = np.unique(rng.integers(0, 1 << kbits,
                                  size=2 * cap).astype(np.uint64))
    keys_np = np.full((g, cap, 4), 0xFFFFFFFF, dtype=np.uint32)
    counts_np = np.zeros((g,), np.int32)
    for i in range(g):
        shared = rng.choice(pool, size=int(cap * 0.6), replace=False)
        priv = rng.integers(0, 1 << kbits,
                            size=cap - shared.size).astype(np.uint64)
        u = np.unique(np.concatenate([shared, priv]))
        counts_np[i] = u.size
        keys_np[i, :u.size, 0] = (u & 0xFFFFFFFF).astype(np.uint32)
        keys_np[i, :u.size, 1] = (u >> 32).astype(np.uint32)
        keys_np[i, :u.size, 2] = 0
        keys_np[i, :u.size, 3] = 0
    if args.blocked:
        # BASELINE config 4 at reduced scale: the memory-bounded macro-tile
        # schedule end to end (host block slicing + device tiles), verified
        # on a random pair sample (full G^2 native verification would take
        # longer than the run itself at ~9e3 pairs/s)
        from spaced_kmer_sketching_tpu.ops.gram import key_words_for_window
        from spaced_kmer_sketching_tpu.parallel.allpairs import (
            blocked_all_pairs)
        from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(devices=jax.devices()[:1])
        blk = args.block_size
        kw = key_words_for_window(args.window)
        kb = 2 * args.window
        # warm with one full-shape sweep (the cache and pair-batch program
        # shapes depend on the block count, so a prefix warm would still
        # compile inside the timed run)
        blocked_all_pairs(mesh, keys_np, counts_np, block=blk,
                          key_words=kw, key_bits=kb,
                          pair_batch=args.pair_batch)
        t0 = time.perf_counter()
        mat = blocked_all_pairs(mesh, keys_np, counts_np, block=blk,
                                key_words=kw, key_bits=kb,
                                pair_batch=args.pair_batch)
        dt = time.perf_counter() - t0
        mat = mat.astype(np.int64)

        verified = None
        if native.available() and not args.no_verify:
            verified = True
            rngv = np.random.default_rng(1)
            sample = rngv.integers(0, g, size=(256, 2))
            u64s_s = {}

            def u64(i):
                if i not in u64s_s:
                    c = counts_np[i]
                    lo = (keys_np[i, :c, 0].astype(np.uint64)
                          | (keys_np[i, :c, 1].astype(np.uint64) << 32))
                    hi = (keys_np[i, :c, 2].astype(np.uint64)
                          | (keys_np[i, :c, 3].astype(np.uint64) << 32))
                    u64s_s[i] = np.ascontiguousarray(
                        np.stack([lo, hi], axis=1))
                return u64s_s[i]

            for i, j in sample:
                want = native.intersect_sorted(u64(i), u64(j))
                if int(mat[i, j]) != want:
                    verified = False
                    print(f"VERIFY FAIL blocked ({i},{j}): {int(mat[i, j])}"
                          f" vs native {want}", file=sys.stderr)
                    break
            if not np.array_equal(np.diag(mat), counts_np.astype(np.int64)):
                verified = False
                print("VERIFY FAIL blocked: diagonal != sketch sizes",
                      file=sys.stderr)

        pairs = g * g
        result = {
            "metric": "ani_pairs_per_s_blocked",
            "value": round(pairs / dt, 1),
            "unit": "pairs/s",
            **_device_fields(),
            "genomes": g, "sketch_cap": cap, "block": blk,
            "wall_s": round(dt, 3),
            "verified": verified,
        }
        print(json.dumps(result))
        return 0 if verified in (True, None) else 1

    if args.probe:
        keys = jnp.asarray(keys_np)
        counts = jnp.asarray(counts_np)

        # one jitted program computes the whole G x G matrix: lax.map over
        # row tiles keeps the (T, G, cap) probe intermediates bounded while
        # leaving the loop on-device
        from spaced_kmer_sketching_tpu.ops.intersect import all_pairs_matrix
        tile = min(g, 8)

        @jax.jit
        def allpairs():
            return all_pairs_matrix(keys, counts, row_tile=tile)

        out = allpairs()
        checksum = int(np.asarray(out.sum()))    # forced completion
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = allpairs()
        assert int(np.asarray(out.sum())) == checksum
        dt = (time.perf_counter() - t0) / args.iters
        mat = np.asarray(out).astype(np.int64)
        build_ms = corr_ms = 0.0
        build_warm_ms = None
    elif args.ondevice:
        from spaced_kmer_sketching_tpu.ops.gram import (
            gram_all_pairs_ondevice, key_words_for_window)
        kw = key_words_for_window(args.window)
        keys_dev = jnp.asarray(keys_np)
        counts_dev = jnp.asarray(counts_np)

        def allpairs():
            return gram_all_pairs_ondevice(keys_dev, counts_dev,
                                           key_words=kw,
                                           key_bits=2 * args.window)

        out = allpairs()
        checksum = int(np.asarray(out.sum()))    # compile + force
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = allpairs()
        assert int(np.asarray(out.sum())) == checksum
        dt = (time.perf_counter() - t0) / args.iters
        mat = np.asarray(out).astype(np.int64)
        build_ms = corr_ms = 0.0                 # nothing runs on host
        build_warm_ms = None
    else:
        from spaced_kmer_sketching_tpu.ops.gram import (
            build_rank_layout, gram_intersections_device)
        t0 = time.perf_counter()
        packed_np, n_union = build_rank_layout(keys_np, counts_np)
        build_ms = (time.perf_counter() - t0) * 1e3
        # warm build: the first call pays this sandbox's first-touch page
        # faults (utils/hostmem.py); a sweep's later experiments reuse the
        # heap and pay only this
        t0 = time.perf_counter()
        build_rank_layout(keys_np, counts_np)
        build_warm_ms = (time.perf_counter() - t0) * 1e3
        packed = jnp.asarray(packed_np)

        def allpairs():
            return gram_intersections_device(packed)

        out = allpairs()
        checksum = int(np.asarray(out.sum()))    # compile + force
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = allpairs()
        assert int(np.asarray(out.sum())) == checksum
        dt = (time.perf_counter() - t0) / args.iters
        mat = np.asarray(out)[:g, :g].astype(np.int64)
        corr_ms = 0.0
    pairs = g * g
    dev_rate = pairs / dt

    verified = None
    if native.available() and not args.no_verify:
        # FULL-matrix parity vs the independent native sorted-merge
        verified = True
        u64s_v = []
        for i in range(g):
            c = counts_np[i]
            lo = (keys_np[i, :c, 0].astype(np.uint64)
                  | (keys_np[i, :c, 1].astype(np.uint64) << 32))
            hi = (keys_np[i, :c, 2].astype(np.uint64)
                  | (keys_np[i, :c, 3].astype(np.uint64) << 32))
            u64s_v.append(np.ascontiguousarray(np.stack([lo, hi], axis=1)))
        for i in range(g):
            for j in range(g):
                want = native.intersect_sorted(u64s_v[i], u64s_v[j])
                if int(mat[i, j]) != want:
                    verified = False
                    print(f"VERIFY FAIL allpairs ({i},{j}): device "
                          f"{int(mat[i, j])} vs native {want}",
                          file=sys.stderr)
                    break
            if verified is False:
                break

    cpu_rate = None
    if native.available():
        # native layout: (count, 2) u64 rows [lo, hi]
        u64s = []
        for i in range(g):
            c = counts_np[i]
            lo = (keys_np[i, :c, 0].astype(np.uint64)
                  | (keys_np[i, :c, 1].astype(np.uint64) << 32))
            hi = (keys_np[i, :c, 2].astype(np.uint64)
                  | (keys_np[i, :c, 3].astype(np.uint64) << 32))
            u64s.append(np.ascontiguousarray(np.stack([lo, hi], axis=1)))
        sample = min(g, 16)
        t0 = time.perf_counter()
        npairs = 0
        for i in range(sample):
            for j in range(sample):
                native.intersect_sorted(u64s[i], u64s[j])
                npairs += 1
        cpu_rate = npairs / (time.perf_counter() - t0)

    result = {
        "metric": "ani_pairs_per_s",
        "value": round(dev_rate, 1),
        "unit": "pairs/s",
        "vs_baseline": (round(dev_rate / cpu_rate, 3)
                        if cpu_rate else None),
        "baseline_cpu_scalar_pairs_per_s": (round(cpu_rate, 1)
                                            if cpu_rate else None),
        **_device_fields(),
        "genomes": g, "sketch_cap": cap, "step_ms": round(dt * 1e3, 3),
        "layout_build_ms": round(build_ms, 3),
        "layout_build_warm_ms": (round(build_warm_ms, 3)
                                 if build_warm_ms is not None else None),
        "correction_ms": round(corr_ms, 3),
        "verified": verified,
    }
    print(json.dumps(result))
    return 0 if verified in (True, None) else 1


def bench_stream(args) -> int:
    """Bounded-memory whole-file sketch of one long genome (BASELINE
    config 5): synthesize an --nt FASTA on disk, run the full streaming
    pipeline (native two-pass parse -> host 2-bit pack -> device
    extract/filter/dedup per segment -> on-device sketch merge) end to end,
    and verify the final key array bit-exactly against the native C++
    whole-genome pipeline.  Reported rate is wall-clock nt/s including all
    host work — the honest config-5 number, not a kernel number."""
    import os
    import resource
    import tempfile

    import jax

    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu.utils import native

    window, k, scale, n = args.window, args.k, args.scale, args.nt
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    fd, path = tempfile.mkstemp(suffix=".fa", prefix="sks_stream_")
    line = 1 << 22
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(b">stream_bench\n")
            for off in range(0, n, line):
                m = min(line, n - off)
                codes = rng.integers(0, 4, m).astype(np.uint8)
                f.write(lut[codes].tobytes())
                f.write(b"\n")

        sk = FracMinHashSketcher(SketchConfig(window=window, k=k,
                                              scale=scale))
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # first pass pays XLA compiles on a cold cache; the steady-state
        # second pass is the honest pipeline number
        t0 = time.perf_counter()
        sk.sketch_file_streaming(path, segment_nt=args.segment_nt)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sketch = sk.sketch_file_streaming(path, segment_nt=args.segment_nt)
        dt = time.perf_counter() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        rate = (n - window + 1) / dt

        cpu_rate = None
        verified = None
        if native.available() and not args.no_verify:
            # whole-genome native oracle (O(nt) host memory, verify only)
            rng2 = np.random.default_rng(0)
            codes = np.concatenate(
                [rng2.integers(0, 4, min(line, n - off)).astype(np.uint8)
                 for off in range(0, n, line)])
            t0 = time.perf_counter()
            ref = native.sketch_codes(codes, np.array([n], np.int64),
                                      sk.mask.lo, sk.mask.hi, window,
                                      sk.salt, scale, False)
            cpu_rate = (n - window + 1) / (time.perf_counter() - t0)
            lo = (sketch.keys[:, 0].astype(np.uint64)
                  | (sketch.keys[:, 1].astype(np.uint64) << 32))
            hi = (sketch.keys[:, 2].astype(np.uint64)
                  | (sketch.keys[:, 3].astype(np.uint64) << 32))
            verified = (sketch.count == ref.shape[0]
                        and np.array_equal(lo, ref[:, 0])
                        and np.array_equal(hi, ref[:, 1]))
            if not verified:
                print(f"VERIFY FAIL stream: device count {sketch.count} vs "
                      f"native {ref.shape[0]}; first mismatch at "
                      f"{_first_mismatch(lo, hi, ref)}", file=sys.stderr)
    finally:
        os.unlink(path)

    result = {
        "metric": "stream_nt_per_s",
        "value": round(rate, 1),
        "unit": "nt/s",
        "vs_baseline": (round(rate / cpu_rate, 3) if cpu_rate else None),
        "baseline_cpu_scalar_nt_per_s": (round(cpu_rate, 1)
                                         if cpu_rate else None),
        **_device_fields(),
        "nt": n, "segment_nt": args.segment_nt, "window": window, "k": k,
        "scale": scale, "sketch_count": int(sketch.count),
        "wall_s": round(dt, 3),
        "cold_wall_s": round(cold_s, 3),
        "peak_rss_gb": round(rss / 1e6, 3),
        "peak_rss_before_gb": round(rss0 / 1e6, 3),
        "verified": verified,
    }
    print(json.dumps(result))
    return 0 if verified in (True, None) else 1


def bench_e2e(args) -> int:
    """Genomes -> (G, G) ANI matrix in ONE flow with DEVICE-RESIDENT
    sketches (pipeline.py): sketch step keys feed the block presort cache
    directly — no sketch download + slab re-upload.  BASELINE config 4
    measured as the
    reference runs it: sketching and comparison in one experiment
    (src/kmer-sketching.cpp:151-212).

    --e2e-source files runs the full ingest path from real FASTA files on
    disk; codes skips the text parse (host RNG genomes); device
    synthesizes genomes on device (zero-ingest — the pure device-resident
    number).  Verification: up to 8 sampled genomes' device key arrays
    are checked against the independent native C++ pipeline (sources with
    host-visible codes), and sampled pair counts + the full diagonal
    against native sorted-merge intersection."""
    import os
    import tempfile

    import jax

    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu.pipeline import (DevicePipeline,
                                                    codes_source,
                                                    device_source,
                                                    file_source)
    from spaced_kmer_sketching_tpu.utils import native

    g, n = args.genomes, args.nt
    cfg = SketchConfig(window=args.window, k=args.k, scale=args.scale)
    sk = FracMinHashSketcher(cfg)
    # e2e default block is 128; --block-size 256 stays the default only
    # for --blocked
    blk0 = args.block_size if "--block-size" in sys.argv else 128
    if args.e2e_mesh:
        # the sharded one-flow pipeline over every local device (single
        # controller) — on one device this measures the mesh path's
        # shard_map/put overheads vs DevicePipeline; on several the same
        # program divides tiles across them
        from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh
        from spaced_kmer_sketching_tpu.pipeline import MeshDevicePipeline
        mesh = make_mesh(devices=jax.devices())
        pipe = MeshDevicePipeline(sk, mesh, block=blk0,
                                  pair_batch=args.pair_batch)
    else:
        pipe = DevicePipeline(sk, block=blk0,
                              dispatch=args.dispatch,
                              pair_batch=args.pair_batch)
    rngv = np.random.default_rng(1)
    verify_ids = sorted(set(
        int(x) for x in rngv.integers(0, g, size=min(8, g)))) \
        if not args.no_verify else []

    tmpdir = None
    try:
        if args.e2e_source == "files":
            tmpdir = tempfile.mkdtemp(prefix="sks_e2e_")
            lut = np.frombuffer(b"ACGT", dtype=np.uint8)
            paths = []
            host_src = codes_source(g, n, seed=0)
            for i in range(g):
                pk = host_src(i, i + 1)[0]
                p = os.path.join(tmpdir, f"g{i:05d}.fa")
                with open(p, "wb") as f:
                    f.write(f">g{i}\n".encode())
                    f.write(lut[pk.codes].tobytes())
                    f.write(b"\n")
                paths.append(p)
            src = file_source(paths)
            nominal = max(os.path.getsize(p) for p in paths)
        elif args.e2e_source == "codes":
            src = host_src = codes_source(g, n, seed=0)
            nominal = n
        else:
            src = device_source(g, n, seed=0)
            host_src = None
            nominal = n

        res = pipe.all_pairs(src, g, nominal, verify_ids=verify_ids)
        # --e2e-repeat N re-runs the whole flow in-process and reports the
        # LAST run: strips one-time per-process compile and executable-load
        # latency from the steady-state number; every run still verifies.
        for _ in range(max(0, args.e2e_repeat - 1)):
            res = pipe.all_pairs(src, g, nominal, verify_ids=verify_ids)
        wall = res.phases["total_s"]

        verified = None
        if verify_ids and native.available():
            verified = True
            # (a) device sketch keys vs the independent native pipeline
            if host_src is not None:
                for i in verify_ids:
                    pk = host_src(i, i + 1)[0] if args.e2e_source != "files" \
                        else None
                    if pk is None:
                        from spaced_kmer_sketching_tpu.ingest.fasta import (
                            read_fasta)
                        pk = read_fasta(paths[i])
                    ref = native.sketch_codes(
                        pk.codes, pk.run_lens.astype(np.int64), sk.mask.lo,
                        sk.mask.hi, cfg.window, sk.salt, cfg.scale,
                        cfg.hash_variant == "legacy")
                    got = res.sample_keys[i]
                    if (got.shape[0] != ref.shape[0]
                            or not np.array_equal(got, ref)):
                        verified = False
                        print(f"VERIFY FAIL e2e sketch {i}: {got.shape[0]} "
                              f"keys vs native {ref.shape[0]}",
                              file=sys.stderr)
            # (b) sampled pair counts vs native sorted-merge
            for i in verify_ids:
                for j in verify_ids:
                    want = native.intersect_sorted(res.sample_keys[i],
                                                   res.sample_keys[j])
                    if int(res.inter[i, j]) != want:
                        verified = False
                        print(f"VERIFY FAIL e2e pair ({i},{j}): "
                              f"{int(res.inter[i, j])} vs native {want}",
                              file=sys.stderr)
            # (c) diagonal = sketch sizes, symmetry
            if not np.array_equal(np.diag(res.inter), res.counts):
                verified = False
                print("VERIFY FAIL e2e: diagonal != sketch sizes",
                      file=sys.stderr)
    finally:
        if tmpdir is not None:
            import shutil
            shutil.rmtree(tmpdir, ignore_errors=True)

    pairs = g * g
    blk = blk0
    cap = res.cache_cap
    result = {
        "metric": "e2e_ani_pairs_per_s",
        "value": round(pairs / wall, 1),
        "unit": "pairs/s",
        **_device_fields(),
        "source": args.e2e_source,
        "genomes": g, "nt": n, "window": args.window, "k": args.k,
        "scale": args.scale, "block": blk, "sketch_cap": cap,
        "wall_s": round(wall, 3),
        "phases": {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in res.phases.items()},
        "bytes_h2d": int(res.bytes_h2d),
        "bytes_d2h": int(res.bytes_d2h),
        # peak device-memory evidence for the bounded-parking pipeline
        # (per-block presort); None when the runtime does not expose
        # allocator stats
        "peak_hbm_bytes": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
        "verified": verified,
    }
    print(json.dumps(result))
    return 0 if verified in (True, None) else 1


def bench_multiseed(args) -> int:
    """S spaced seeds fused over one genome in a single dispatch
    (BASELINE.json config 3 — the EP analog: "experts" = seeds, all dense).
    Verifies every per-seed sketch key array against the native pipeline."""
    import jax
    import jax.numpy as jnp

    from spaced_kmer_sketching_tpu.ops import u64ops
    from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
    from spaced_kmer_sketching_tpu.ops.sketch import sketch_from_codes_multiseed
    from spaced_kmer_sketching_tpu.utils import boosthash, native
    from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

    window, k, scale, s = args.window, args.k, args.scale, args.seeds
    n = args.nt
    masks = [spaced_seed_mask(window, k, seed) for seed in range(s)]
    salts = [boosthash.fmh_salt(m.lo, m.hi, window, 1, "modern")
             for m in masks]
    masks_np = np.stack([m.words_u32 for m in masks])
    salts_np = np.stack([u64ops.salt_pair(x) for x in salts])
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, n).astype(np.uint32)
    run_id = run_ids_from_lens([n], n)
    capacity = 1 << max(10, (max(1, 2 * n // scale)).bit_length())

    masks_w = jnp.asarray(masks_np)
    salt_pairs = jnp.asarray(salts_np)
    codes_d, rid_d = jnp.asarray(codes), jnp.asarray(run_id)

    def step():
        return sketch_from_codes_multiseed(
            codes_d, rid_d, masks_w, salt_pairs, window=window,
            scale=scale, variant="modern", capacity=capacity)

    out = step()
    np.asarray(out.count)             # compile + forced completion
    assert int(np.asarray(out.raw_kept).max()) <= capacity
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = step()
    np.asarray(out.count)
    dt = (time.perf_counter() - t0) / args.iters
    window_seeds = s * (n - window + 1)
    dev_rate = window_seeds / dt

    cpu_rate = None
    if native.available():
        runs_lens = np.array([n], dtype=np.int64)
        codes8 = codes.astype(np.uint8)
        t0 = time.perf_counter()
        for m, salt in zip(masks, salts):
            native.sketch_codes(codes8, runs_lens, m.lo, m.hi, window, salt,
                                scale, False)
        cpu_rate = window_seeds / (time.perf_counter() - t0)

    verified = None
    if native.available() and not args.no_verify:
        verified = True
        runs_lens = np.array([n], dtype=np.int64)
        keys_dev = np.asarray(out.keys).astype(np.uint64)
        cnt_dev = np.asarray(out.count)
        for i, (m, salt) in enumerate(zip(masks, salts)):
            ref = native.sketch_codes(codes.astype(np.uint8), runs_lens,
                                      m.lo, m.hi, window, salt, scale, False)
            c = int(cnt_dev[i])
            lo = keys_dev[i, :c, 0] | (keys_dev[i, :c, 1] << np.uint64(32))
            hi = keys_dev[i, :c, 2] | (keys_dev[i, :c, 3] << np.uint64(32))
            if (c != ref.shape[0] or not np.array_equal(lo, ref[:, 0])
                    or not np.array_equal(hi, ref[:, 1])):
                verified = False
                print(f"VERIFY FAIL seed {i}: device count {c} vs native "
                      f"{ref.shape[0]}; first mismatch at "
                      f"{_first_mismatch(lo, hi, ref)}", file=sys.stderr)

    result = {
        "metric": "multiseed_window_seeds_per_s",
        "value": round(dev_rate, 1),
        "unit": "window-seeds/s",
        "vs_baseline": (round(dev_rate / cpu_rate, 3)
                        if cpu_rate else None),
        "baseline_cpu_scalar_window_seeds_per_s": (
            round(cpu_rate, 1) if cpu_rate else None),
        **_device_fields(),
        "nt": n, "seeds": s, "window": window, "k": k, "scale": scale,
        "step_ms": round(dt * 1e3, 3),
        "verified": verified,
    }
    print(json.dumps(result))
    return 0 if verified in (True, None) else 1


if __name__ == "__main__":
    sys.exit(main())
