#!/usr/bin/env python3
"""Smoke test of the FASTA-to-ANI path on the GPU, checked exactly.

    python chip_smoke.py            # one card
    python chip_smoke.py --cards 4  # the paths that span four cards

One card runs three phases through the normal entry points at the size of
a bacterial genome collection (genomes of ~1.55 Mnt):

  a. CLI, two-step path: 16 FASTA files (a base genome and mutated copies
     at 1-10% divergence; every fourth file has two records and an N run)
     at (w, k) = (10, 10), (20, 16) and (50, 40), which cover 1, 2 and 4
     live key words.  The CSV must equal, byte for byte, the one built
     from the native C++ scalar oracle's sketches and intersections.
  b. CLI, device-resident pipeline: 1,024 such files at (20, 16).  The
     driver must route them to DevicePipeline; 8 sampled sketches, the
     diagonal, symmetry, 8 full rows of the matrix and their CSV rows must
     equal the oracle.
  c. Streaming: one 128 Mnt single-sequence genome through
     FracMinHashSketcher.sketch_file_streaming (compact uploads) must equal
     the oracle's sketch.

--cards 4 runs only what spans cards, each against its one-card result:
the driver with --mesh auto on the phase-a files (CSV byte-identical),
MeshDevicePipeline against DevicePipeline on the phase-b genomes
(identical matrices) and the sequence-parallel ring on the phase-c genome
(identical keys), and checks that every card held data.

Each phase prints its wall time and the device's peak memory so far.  The
last line of stdout is one JSON object naming the device; on any mismatch
or exception, or when JAX finds no GPU, the script exits non-zero without
printing it.  Generated FASTA files live under .smoke_data/ (git-ignored)
and are removed at the end.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / ".smoke_data"
LUT = np.frombuffer(b"ACGT", np.uint8)
SEED = 20261016
GENOME_NT = 1_550_000
PHASE_A_GENOMES = 16
PHASE_A_CONFIGS = ((10, 10), (20, 16), (50, 40))
PHASE_B_GENOMES = 1024
PHASE_B_CONFIG = (20, 16)
STREAM_NT = 128 << 20
SAMPLE_ROWS = 8
N_RUN = 50


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --- genomes ------------------------------------------------------------------

def genome_runs(base: np.ndarray, i: int):
    """Genome i of a collection: `base` with 1-10% substitutions.  Every
    fourth genome is two records, the first with an N run inside, so it
    has three ACGT runs.  Returns (records, runs): records is a list of
    byte strings of sequence text, runs the ACGT runs in file order."""
    rng = np.random.default_rng([SEED, i])
    div = 0.01 + 0.09 * (i % 10) / 9
    codes = base.copy()
    k = int(rng.binomial(codes.size, div))
    pos = rng.integers(0, codes.size, k)
    codes[pos] = (codes[pos] + rng.integers(1, 4, k, dtype=np.uint8)) % 4
    if i % 4 != 3:
        return [LUT[codes]], [codes]
    n = codes.size
    a, b = n // 3, 2 * n // 3
    runs = [codes[:a], codes[a + N_RUN:b], codes[b:]]
    rec0 = np.concatenate([LUT[runs[0]], np.full(N_RUN, ord("N"), np.uint8),
                           LUT[runs[1]]])
    return [rec0, LUT[runs[2]]], runs


def _wrap(seq: np.ndarray, width: int = 80) -> bytes:
    full = seq.size // width
    lines = np.empty((full, width + 1), np.uint8)
    lines[:, :width] = seq[:full * width].reshape(full, width)
    lines[:, width] = ord("\n")
    tail = seq[full * width:].tobytes()
    return lines.tobytes() + (tail + b"\n" if tail else b"")


def write_fasta(path: pathlib.Path, name: str, records) -> None:
    with open(path, "wb") as f:
        for r, seq in enumerate(records):
            f.write(f">{name}_{r}\n".encode())
            f.write(_wrap(seq))


def make_collection(d: pathlib.Path, g: int):
    """g FASTA files of mutated copies of one base genome; returns (paths,
    oracle inputs [(codes, run_lens)]) built from the generator, not from
    the files."""
    d.mkdir(parents=True, exist_ok=True)
    base = np.random.default_rng(SEED).integers(0, 4, GENOME_NT,
                                                dtype=np.uint8)

    def one(i):
        records, runs = genome_runs(base, i)
        p = d / f"g{i:04d}.fa"
        write_fasta(p, f"g{i}", records)
        return str(p), (np.concatenate(runs),
                        np.array([r.size for r in runs], np.int64))

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        out = list(ex.map(one, range(g)))
    return [p for p, _ in out], [x for _, x in out]


# --- oracle -------------------------------------------------------------------

def oracle_sketches(inputs, window: int, k: int):
    """Native C++ scalar sketches ((count, 2) uint64 [lo, hi]) of every
    genome at (window, k), with the mask and salt the driver derives."""
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.utils import boosthash, native
    from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

    cfg = SketchConfig(window=window, k=k)
    mask = spaced_seed_mask(window, k, cfg.mask_seed)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, cfg.nonce,
                              cfg.hash_variant)

    def one(x):
        codes, run_lens = x
        return native.sketch_codes(codes, run_lens, mask.lo, mask.hi,
                                   window, salt, cfg.scale,
                                   cfg.hash_variant == "legacy")

    with cf.ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        return list(ex.map(one, inputs)), mask


def oracle_rows(paths, refs, mask, window: int, rows) -> list:
    """Expected CSV lines (reference format) for the given row genomes
    against every genome."""
    from spaced_kmer_sketching_tpu.utils import native

    kc = mask.care_positions
    bits = mask.bitstring()
    out = []
    for i in rows:
        for j in range(len(refs)):
            inter = native.intersect_sorted(refs[i], refs[j])
            c = 0.0 if inter == 0 else inter / refs[i].shape[0]
            ani = 0.0 if c <= 0 else float(np.power(c, 1.0 / kc))
            out.append(f"{paths[i]},{paths[j]},{ani:g},{window},{bits}")
    return out


def as_u64(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.uint64)
    return np.stack([k[:, 0] | (k[:, 1] << np.uint64(32)),
                     k[:, 2] | (k[:, 3] << np.uint64(32))], axis=1)


# --- reporting ------------------------------------------------------------------

def peak_bytes(dev=None) -> int | None:
    import jax
    dev = dev or jax.devices()[0]
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"[{self.name}] start", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[{self.name}] ok wall_s={time.perf_counter() - self.t0:.3f}"
                  f" peak_bytes_in_use={peak_bytes()}", flush=True)


class RouteSpy:
    """Records the driver's calls into the device-resident pipeline and
    asks it for the sampled genomes' sketch keys."""

    def __init__(self, verify_ids=()):
        from spaced_kmer_sketching_tpu import pipeline
        self.mod = pipeline
        self.orig = pipeline.all_pairs_from_files
        self.verify_ids = list(verify_ids)
        self.results = []

    def __enter__(self):
        def spy(sketcher, paths, **kw):
            kw.setdefault("verify_ids", self.verify_ids)
            res = self.orig(sketcher, paths, **kw)
            self.results.append(res)
            return res
        self.mod.all_pairs_from_files = spy
        return self

    def __exit__(self, *exc):
        self.mod.all_pairs_from_files = self.orig


def run_cli(out_csv: pathlib.Path, paths, window: int, k: int,
            extra=()) -> None:
    from spaced_kmer_sketching_tpu.driver import main as driver_main
    rc = driver_main([str(out_csv), *paths, "--window", str(window),
                      "--k", str(k), *extra])
    check(rc == 0, f"driver exited {rc}")


# --- one card -------------------------------------------------------------------

def phase_a(work: pathlib.Path, g: int = PHASE_A_GENOMES,
            configs=PHASE_A_CONFIGS) -> None:
    paths, inputs = make_collection(work / "a", g)
    for window, k in configs:
        refs, mask = oracle_sketches(inputs, window, k)
        out = work / f"a_w{window}_k{k}.csv"
        with RouteSpy() as spy:
            run_cli(out, paths, window, k)
        check(not spy.results, "phase a took the device pipeline route")
        want = "\n".join(["File 1,File 2,Estimated Value,Window Size,Mask"]
                         + oracle_rows(paths, refs, mask, window,
                                       range(g))) + "\n"
        check(out.read_text() == want,
              f"phase a CSV differs from the oracle at (w={window}, k={k})")
        print(f"  (w={window}, k={k}): {g * g} CSV rows equal the oracle; "
              f"sketch sizes {min(r.shape[0] for r in refs)}-"
              f"{max(r.shape[0] for r in refs)}", flush=True)


def phase_b(work: pathlib.Path, g: int = PHASE_B_GENOMES,
            config=PHASE_B_CONFIG) -> None:
    window, k = config
    paths, inputs = make_collection(work / "b", g)
    rng = np.random.default_rng(SEED)
    rows = sorted(int(x) for x in rng.choice(g, SAMPLE_ROWS, replace=False))
    out = work / "b.csv"
    with RouteSpy(verify_ids=rows) as spy:
        run_cli(out, paths, window, k)
    check(len(spy.results) == 1,
          "the driver did not route the collection to DevicePipeline")
    res = spy.results[0]
    refs, mask = oracle_sketches(inputs, window, k)
    for i in rows:
        check(np.array_equal(res.sample_keys[i], refs[i]),
              f"phase b sketch of genome {i} differs from the oracle")
    counts = np.array([r.shape[0] for r in refs])
    check(np.array_equal(res.counts, counts), "phase b sketch sizes differ")
    check(np.array_equal(np.diag(res.inter), counts),
          "phase b diagonal differs from the sketch sizes")
    check(np.array_equal(res.inter, res.inter.T),
          "phase b matrix is not symmetric")
    from spaced_kmer_sketching_tpu.utils import native
    for i in rows:
        want = [native.intersect_sorted(refs[i], refs[j]) for j in range(g)]
        check(np.array_equal(res.inter[i], want),
              f"phase b row {i} differs from the oracle")
    with open(out) as f:
        lines = f.read().split("\n")
    check(len(lines) == g * g + 2 and lines[-1] == "",
          "phase b CSV has the wrong row count")
    want = oracle_rows(paths, refs, mask, window, rows)
    got = [lines[1 + i * g + j] for i in rows for j in range(g)]
    check(got == want, "phase b CSV rows differ from the oracle")
    print(f"  {g} genomes via DevicePipeline: {len(rows)} sketches, "
          f"{len(rows)} full rows and their CSV rows equal the oracle; "
          f"phases {json.dumps({x: round(v, 3) for x, v in res.phases.items() if isinstance(v, float)})}",
          flush=True)


def stream_genome(work: pathlib.Path, n: int = STREAM_NT):
    codes = np.random.default_rng(SEED + 1).integers(0, 4, n, dtype=np.uint8)
    path = work / "stream.fa"
    write_fasta(path, "chr", [LUT[codes]])
    return path, codes


def phase_c(work: pathlib.Path, n: int = STREAM_NT, window: int = 20,
            k: int = 16) -> None:
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)

    path, codes = stream_genome(work, n)
    sk = FracMinHashSketcher(SketchConfig(window=window, k=k))
    t0 = time.perf_counter()
    got = sk.sketch_file_streaming(str(path))
    dt = time.perf_counter() - t0
    (ref,), _ = oracle_sketches([(codes, np.array([n], np.int64))], window, k)
    check(got.count == ref.shape[0] and np.array_equal(as_u64(got.keys), ref),
          "phase c streaming sketch differs from the oracle")
    print(f"  {n} nt streamed in {dt:.3f} s, {got.count} keys equal the "
          f"oracle", flush=True)


# --- four cards -----------------------------------------------------------------

def cards_a(work: pathlib.Path, g: int = PHASE_A_GENOMES,
            config=PHASE_B_CONFIG) -> None:
    window, k = config
    paths, _ = make_collection(work / "a", g)
    run_cli(work / "one.csv", paths, window, k)
    run_cli(work / "mesh.csv", paths, window, k, ("--mesh", "auto"))
    check((work / "one.csv").read_bytes() == (work / "mesh.csv").read_bytes(),
          "--mesh auto CSV differs from the one-device CSV")
    print(f"  --mesh auto CSV byte-identical ({g * g} rows)", flush=True)


def cards_b(g: int = PHASE_B_GENOMES, config=PHASE_B_CONFIG) -> None:
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh
    from spaced_kmer_sketching_tpu.pipeline import (DevicePipeline,
                                                    MeshDevicePipeline)

    window, k = config
    base = np.random.default_rng(SEED).integers(0, 4, GENOME_NT,
                                                dtype=np.uint8)

    def source(s0, s1):
        out = []
        for i in range(s0, s1):
            _, runs = genome_runs(base, i)
            out.append(PackedSeqs(
                codes=np.concatenate(runs),
                run_lens=np.array([r.size for r in runs], np.int64)))
        return out

    sk = FracMinHashSketcher(SketchConfig(window=window, k=k))
    one = DevicePipeline(sk, dispatch=32).all_pairs(source, g, GENOME_NT)
    mesh = make_mesh()
    print(f"  mesh {dict(mesh.shape)}", flush=True)
    many = MeshDevicePipeline(sk, mesh).all_pairs(source, g, GENOME_NT)
    check(np.array_equal(one.counts, many.counts),
          "MeshDevicePipeline sketch sizes differ from DevicePipeline")
    check(np.array_equal(one.inter, many.inter),
          "MeshDevicePipeline matrix differs from DevicePipeline")
    print(f"  MeshDevicePipeline == DevicePipeline on {g} genomes; one "
          f"card total_s={one.phases['total_s']:.3f}, mesh "
          f"total_s={many.phases['total_s']:.3f}", flush=True)


def cards_c(work: pathlib.Path, n: int = STREAM_NT, window: int = 20,
            k: int = 16) -> None:
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh
    from spaced_kmer_sketching_tpu.parallel.sketcher import MeshSketcher

    path, _ = stream_genome(work, n)
    cfg = SketchConfig(window=window, k=k)
    one = FracMinHashSketcher(cfg).sketch_file_streaming(str(path))
    ring = MeshSketcher(cfg, make_mesh(), seq_par_threshold=1) \
        .sketch_file_streaming(str(path))
    check(one.count == ring.count and np.array_equal(one.keys, ring.keys),
          "sequence-parallel ring sketch differs from the one-device sketch")
    print(f"  ring sketch == one-device sketch ({one.count} keys)",
          flush=True)


# --- entry ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="1: phases a-c on one card; 4: only the paths "
                         "that span four cards")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"JAX sees {len(devs)}", file=sys.stderr)
        return 2
    from spaced_kmer_sketching_tpu.utils import native
    from spaced_kmer_sketching_tpu.utils.jaxcache import (
        enable_compilation_cache)
    enable_compilation_cache()
    check(native.available(), "the native oracle library did not build")

    print(f"device_kind: {devs[0].device_kind}, count: {len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line}")

    shutil.rmtree(DATA, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        if args.cards == 1:
            with Phase("a: CLI two-step, 16 x 1.55 Mnt, 3 configs"):
                phase_a(DATA)
            with Phase("b: CLI DevicePipeline, 1024 x 1.55 Mnt"):
                phase_b(DATA)
            with Phase("c: streaming, 128 Mnt"):
                phase_c(DATA)
        else:
            with Phase("4 cards a: driver --mesh auto"):
                cards_a(DATA)
            with Phase("4 cards b: MeshDevicePipeline"):
                cards_b()
            with Phase("4 cards c: sequence-parallel ring"):
                cards_c(DATA)
            peaks = [peak_bytes(d) for d in devs[:args.cards]]
            print(f"per-card peak_bytes_in_use: {peaks}")
            check(all(p and p > 0.05 * max(peaks) for p in peaks),
                  "a card held almost nothing: the mesh did not spread")
    finally:
        shutil.rmtree(DATA, ignore_errors=True)
    print(f"total wall_s={time.perf_counter() - t0:.3f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:          # report the failure; never the result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
