"""Experiment driver + CLI — the reference `main` re-expressed in JAX.

Mirrors src/kmer-sketching.cpp:151-240:
  * one experiment = generate mask (seed 0) -> sketch all FASTA files ->
    all-pairs intersections (ordered, incl. self) -> containment (denominator
    = FIRST set of each ordered pair) -> ANI -> append CSV rows;
  * wall-clock spans printed to stdout in the reference's exact format
    ("Time taken for sketching = X ms" / "Time taken for comparison = X ms",
    src/kmer-sketching.cpp:175,203);
  * the argv contract `prog OUTPUT_CSV FASTA...` and the hard-coded sweep —
    (w=10,k=10) fresh CSV, then k=11..40 with w=k, then k=10..40 with w=k+10,
    all appended (src/kmer-sketching.cpp:214-240).

Extra (non-reference) flags are opt-in and keyword-only so the positional
contract stays exact.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

from .config import SketchConfig
from .csvout import write_to_csv
from .generators import all_pair_indices, ring_pair_indices
from .models.fracminhash import FracMinHashSketcher, Sketch
from .observability import get_logger

log = get_logger(__name__)


#: collections above this size route through the device-resident pipeline
#: (with a padding-economics guard for heterogeneous collections below)
_PIPELINE_MIN_GENOMES = 512


def _use_device_pipeline(sk, filenames, pairing: str, store) -> bool:
    """Route large collections through the DEVICE-RESIDENT one-flow
    pipeline (pipeline.py): sketches born on device feed the block presort
    cache directly, skipping the download + slab re-upload the two-step
    path pays.  Bit-exact with the two-step path (tests/test_pipeline.py).
    The choice is made from the input alone: more than
    _PIPELINE_MIN_GENOMES genomes of similar length.
    SKS_DEVICE_PIPELINE=0 disables the routing; =1 forces it regardless of
    collection size (the structural constraints still apply).
    Mirrors the reference experiment's one flow
    (src/kmer-sketching.cpp:151-212)."""
    import os as _os

    if not (pairing == "all" and store is None):
        return False
    if type(sk) is not FracMinHashSketcher:
        # mesh runs route through MeshDevicePipeline, single controller
        # only (multi-process collectives follow MeshSketcher conventions)
        from .parallel.sketcher import MeshSketcher
        import jax
        if not (type(sk) is MeshSketcher and jax.process_count() == 1):
            return False
    env = _os.environ.get("SKS_DEVICE_PIPELINE")
    if env == "0":
        return False
    try:
        sizes = [_os.path.getsize(f) for f in filenames]
        small = all(s < sk._STREAM_THRESHOLD_BYTES for s in sizes)
    except OSError:
        sizes, small = [], True  # missing files keep read_fasta's parity
    if not small:
        return False       # huge genomes need the streaming sketch path
    if env == "1":
        return True
    if len(filenames) <= _PIPELINE_MIN_GENOMES:
        return False
    # padding economics: the pipeline shapes EVERY genome to the largest
    # file, so a heterogeneous collection would pay device work on padding
    # (windows masked invalid); the two-step path buckets genomes by
    # padded shape instead.  Route only when padding at most doubles the
    # device work.
    return bool(sizes) and max(sizes) * len(sizes) <= 2 * sum(sizes)


def run_experiment(window_size: int, kmer_size: int, filenames: Sequence[str],
                   output_filename: str, is_append: bool,
                   config: Optional[SketchConfig] = None,
                   sketcher: Optional[FracMinHashSketcher] = None,
                   echo_timings: bool = True,
                   store=None, pairing: str = "all",
                   make_sketcher=None, resume_done=None) -> np.ndarray:
    """One (window, k) experiment over `filenames`; returns the flat ANI list
    in reference pair order (all ordered pairs incl. self, row-major).

    `make_sketcher` (cfg -> sketcher) selects the execution engine — the
    driver passes parallel.sketcher.MeshSketcher under --mesh.

    `resume_done` (a Counter from store.completed_pairs_in_csv, consumed
    in place) makes the experiment resumable at PAIR level: rows already
    present in the output CSV are neither recomputed (a fully-finished
    config skips sketching entirely) nor rewritten, so a killed sweep
    rerun appends exactly the missing rows in order — the final CSV is
    byte-identical to an uninterrupted run (the reference's append-mode
    accumulation contract, src/kmer-sketching.cpp:53-70).

    Parity with test_compute_ANI_estimation_random_spaced_kmers
    (src/kmer-sketching.cpp:151-212)."""
    cfg = config or SketchConfig(window=window_size, k=kmer_size)
    if (cfg.window, cfg.k) != (window_size, kmer_size):
        cfg = SketchConfig(window=window_size, k=kmer_size,
                           mask_seed=cfg.mask_seed, scale=cfg.scale,
                           nonce=cfg.nonce, hash_variant=cfg.hash_variant,
                           sketch_capacity=cfg.sketch_capacity)
    sk = sketcher or (make_sketcher(cfg) if make_sketcher
                      else FracMinHashSketcher(cfg))

    write_row = None
    if resume_done is not None:
        g = len(filenames)
        idx_pairs = (ring_pair_indices(g) if pairing == "ring"
                     else all_pair_indices(g))
        bits = sk.mask.bitstring()
        write_row = []
        for i, j in idx_pairs:
            key = (str(filenames[i]), str(filenames[j]), str(window_size),
                   bits)
            if resume_done.get(key, 0) > 0:
                resume_done[key] -= 1
                write_row.append(False)
            else:
                write_row.append(True)
        if not any(write_row):
            log.info("resume: config (w=%d, k=%d) already complete, skipped",
                     window_size, kmer_size)
            return np.empty(0)

    if _use_device_pipeline(sk, filenames, pairing, store):
        from .pipeline import all_pairs_from_files
        t0 = time.perf_counter()
        res = all_pairs_from_files(sk, filenames,
                                   mesh=getattr(sk, "mesh", None))
        t1 = time.perf_counter()
        counts = res.counts.astype(np.int64)
        g = len(filenames)
        pairs = all_pair_indices(g)
        ani = sk.ani_from_intersections(res.inter.reshape(-1).astype(np.int64),
                                        np.repeat(counts, max(g, 1)))
        t2 = time.perf_counter()
        if echo_timings:
            # one flow: the phases interleave, so attribute ingest +
            # sketch + presort to "sketching" and the tile sweep + host
            # ANI math to "comparison" (reference print format,
            # src/kmer-sketching.cpp:175,203)
            ph = res.phases
            sk_ms = (ph["ingest_s"] + ph["sketch_s"] + ph["presort_s"]) * 1e3
            cmp_ms = ph["allpairs_s"] * 1e3 + (t2 - t1) * 1e3
            print(f"Time taken for sketching = {sk_ms} ms")
            print(f"Time taken for comparison = {cmp_ms} ms")
        names1 = [str(filenames[i]) for i, _ in pairs]
        names2 = [str(filenames[j]) for _, j in pairs]
        values = list(map(float, ani))
        if write_row is not None:
            names1 = [n for n, w in zip(names1, write_row) if w]
            names2 = [n for n, w in zip(names2, write_row) if w]
            values = [v for v, w in zip(values, write_row) if w]
        write_to_csv(names1, names2, values, window_size, sk.mask,
                     output_filename, is_append)
        return ani

    t0 = time.perf_counter()
    if store is not None:
        sketches: List[Sketch] = store.sketch_files_resumable(sk, filenames)
    else:
        sketches = sk.sketch_files(filenames)
    t1 = time.perf_counter()
    if echo_timings:
        print(f"Time taken for sketching = {(t1 - t0) * 1e3} ms")

    counts = np.array([s.count for s in sketches], dtype=np.int64)
    g = len(sketches)
    if pairing == "ring":
        # adjacent ring pairing (src/generators.hpp:21-34)
        pairs = ring_pair_indices(g)
        inter_flat = sk.intersections([sketches[i] for i, _ in pairs],
                                      [sketches[j] for _, j in pairs])
        ani = sk.ani_from_intersections(
            np.asarray(inter_flat), np.array([counts[i] for i, _ in pairs]))
    else:
        inter = sk.all_pairs_intersections(sketches)      # (G, G) int32
        # ordered pairs row-major: pair (i, j) -> denominator |set_i|
        pairs = all_pair_indices(g)
        ani = sk.ani_from_intersections(inter.reshape(-1),
                                        np.repeat(counts, max(g, 1)))
    t2 = time.perf_counter()
    if echo_timings:
        print(f"Time taken for comparison = {(t2 - t1) * 1e3} ms")
    names1 = [str(filenames[i]) for i, _ in pairs]
    names2 = [str(filenames[j]) for _, j in pairs]
    values = list(map(float, ani))
    if write_row is not None:
        names1 = [n for n, w in zip(names1, write_row) if w]
        names2 = [n for n, w in zip(names2, write_row) if w]
        values = [v for v, w in zip(values, write_row) if w]
    write_to_csv(names1, names2, values, window_size, sk.mask,
                 output_filename, is_append)
    return ani


def reference_sweep_schedule():
    """The 62 (window, k, is_append) configs of the reference main
    (src/kmer-sketching.cpp:219-239)."""
    sched = [(10, 10, False)]
    sched += [(k, k, True) for k in range(11, 41)]
    sched += [(k + 10, k, True) for k in range(10, 41)]
    return sched


def run_reference_sweep(output_filename: str, filenames: Sequence[str],
                        config: Optional[SketchConfig] = None,
                        echo_timings: bool = True, store=None,
                        make_sketcher=None) -> None:
    """The reference's 62-config main loop.  With a --store and an existing
    output CSV, the sweep RESUMES: rows already in the CSV are skipped at
    pair level (fully-finished configs skip sketching entirely; a config
    killed mid-write appends only its missing rows), so the final CSV is
    byte-identical to an uninterrupted run."""
    import os

    resume_done = None
    if store is not None and os.path.exists(output_filename):
        from .store import completed_pairs_in_csv
        resume_done = completed_pairs_in_csv(output_filename)
        if resume_done:
            log.info("resume: %d rows already in %s",
                     sum(resume_done.values()), output_filename)
    for window, k, is_append in reference_sweep_schedule():
        if resume_done:
            is_append = True       # never truncate a CSV being resumed
        run_experiment(window, k, filenames, output_filename, is_append,
                       config=config, echo_timings=echo_timings, store=store,
                       make_sketcher=make_sketcher, resume_done=resume_done)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="spaced-kmer-sketching-tpu",
        description="Spaced k-mer FracMinHash ANI estimation in JAX")
    parser.add_argument("output_csv")
    parser.add_argument("fastas", nargs="+")
    parser.add_argument("--window", type=int, default=None,
                        help="run ONE experiment at this window (with --k) "
                             "instead of the reference's 62-config sweep")
    parser.add_argument("--k", type=int, default=None)
    parser.add_argument("--scale", type=int, default=SketchConfig.scale)
    parser.add_argument("--nonce", type=int, default=SketchConfig.nonce)
    parser.add_argument("--mask-seed", type=int, default=SketchConfig.mask_seed)
    parser.add_argument("--hash-variant", choices=("modern", "legacy"),
                        default=SketchConfig.hash_variant)
    parser.add_argument("--append", action="store_true",
                        help="append to the CSV (single-experiment mode)")
    parser.add_argument("--pairing", choices=("all", "ring"), default="all",
                        help="all: full ordered n^2 incl. self-pairs "
                             "(reference main); ring: adjacent (i, i+1 mod n)")
    parser.add_argument("--store", default=None, metavar="DIR",
                        help="sketch checkpoint directory: reruns reuse "
                             "already-computed sketches")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a jax.profiler trace to DIR")
    parser.add_argument("--platform", default=None,
                        help="JAX platform override (e.g. cpu)")
    parser.add_argument("--mesh", default=None, metavar="RxC|auto",
                        help="run sketching and all-pairs sharded over a "
                             "2-D device mesh (e.g. 2x4); 'auto' uses every "
                             "device in the (possibly multi-host) job")
    args = parser.parse_args(argv)

    if args.platform:
        import os
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax
        jax.config.update("jax_platforms", args.platform)
    from .utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    from .utils.hostmem import tune as _malloc_tune
    _malloc_tune()

    if (args.window is None) != (args.k is None):
        parser.error("--window and --k must be given together")
    base = SketchConfig(
        window=args.window or 10, k=args.k or 10, scale=args.scale,
        nonce=args.nonce, mask_seed=args.mask_seed,
        hash_variant=args.hash_variant)

    store = None
    if args.store:
        from .store import SketchStore
        store = SketchStore(args.store)

    make_sketcher = None
    if args.mesh:
        from .parallel.distributed import global_mesh, init_distributed
        from .parallel.sketcher import MeshSketcher
        init_distributed()
        shape = None if args.mesh == "auto" else tuple(
            int(x) for x in args.mesh.lower().replace(",", "x").split("x"))
        mesh = global_mesh(shape)
        make_sketcher = lambda cfg: MeshSketcher(cfg, mesh)  # noqa: E731

    import contextlib
    ctx = contextlib.nullcontext()
    if args.profile:
        import jax
        ctx = jax.profiler.trace(args.profile)
    try:
        with ctx:
            if args.window is not None:
                run_experiment(args.window, args.k, args.fastas,
                               args.output_csv, args.append, config=base,
                               store=store, pairing=args.pairing,
                               make_sketcher=make_sketcher)
            else:
                run_reference_sweep(args.output_csv, args.fastas, config=base,
                                    store=store, make_sketcher=make_sketcher)
    except FileNotFoundError as e:
        # reference CLI error parity: an unopenable FASTA prints to stderr
        # and exits 1 (src/fasta_processing.cpp:86-90) — the exact bytes,
        # including the trailing space and the leading space on the second
        # line ("Unable to open <f>. \n Exiting..." << std::endl)
        msg = str(e)
        prefix = "Unable to open "
        fname = msg[len(prefix):] if msg.startswith(prefix) else msg
        print(f"Unable to open {fname}. \n Exiting...", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
