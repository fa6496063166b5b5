"""Device-resident end-to-end pipeline (pipeline.py): FASTA/codes ->
sketches born on device -> block presort caches -> macro-tiles, bit-exact
against the download-then-reupload path and the oracle."""
import numpy as np
import pytest

from spaced_kmer_sketching_tpu.config import SketchConfig
from spaced_kmer_sketching_tpu.models.fracminhash import FracMinHashSketcher
from spaced_kmer_sketching_tpu.pipeline import (DevicePipeline,
                                                all_pairs_from_files,
                                                codes_source)

from test_driver import write_fasta
from oracle import random_genome


def _reference_matrix(sk, sketches):
    """Host sorted-merge intersection counts (independent engine)."""
    g = len(sketches)
    u64 = [s.keys_u64() for s in sketches]
    out = np.zeros((g, g), np.int32)
    for i in range(g):
        for j in range(g):
            a, b = u64[i], u64[j]
            ai = bi = c = 0
            while ai < len(a) and bi < len(b):
                ka, kb = tuple(a[ai]), tuple(b[bi])
                if ka == kb:
                    c += 1
                    ai += 1
                    bi += 1
                elif (ka[1], ka[0]) < (kb[1], kb[0]):
                    ai += 1
                else:
                    bi += 1
            out[i, j] = c
    return out


def test_pipeline_matches_sketch_files_path(tmp_path):
    """all_pairs_from_files == sketch_files + all_pairs_intersections
    (counts AND full matrix), including a ragged tail block and multi-run
    genomes."""
    rng = np.random.default_rng(11)
    paths = []
    for i in range(10):
        g0 = random_genome(rng, 1400 + 37 * i)     # varying lengths
        paths.append(write_fasta(tmp_path / f"g{i}.fa", [g0]))
    cfg = SketchConfig(window=12, k=8, scale=5)
    sk = FracMinHashSketcher(cfg)

    res = all_pairs_from_files(sk, paths, dispatch=4)
    sketches = sk.sketch_files(paths)
    np.testing.assert_array_equal(res.counts,
                                  np.array([s.count for s in sketches]))
    want = _reference_matrix(sk, sketches)
    np.testing.assert_array_equal(res.inter, want)
    assert res.phases["total_s"] > 0
    np.testing.assert_array_equal(np.diag(res.inter), res.counts)


def test_pipeline_codes_source_and_verify_keys():
    """codes_source genomes: sampled device key downloads match the
    sketches computed independently, and the matrix is symmetric with the
    diagonal equal to sketch sizes."""
    from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs

    cfg = SketchConfig(window=14, k=10, scale=4)
    sk = FracMinHashSketcher(cfg)
    g, n = 6, 2000
    src = codes_source(g, n, seed=3)
    pipe = DevicePipeline(sk, dispatch=2)
    res = pipe.all_pairs(src, g, n, verify_ids=[0, 3, 5])

    assert set(res.sample_keys) == {0, 3, 5}
    for i in (0, 3, 5):
        pk = src(i, i + 1)[0]
        want = sk.sketch_packed(pk)
        assert res.counts[i] == want.count
        np.testing.assert_array_equal(res.sample_keys[i], want.keys_u64())
    np.testing.assert_array_equal(res.inter, res.inter.T)
    np.testing.assert_array_equal(np.diag(res.inter), res.counts)


def test_pipeline_multirecord_and_non_acgt(tmp_path):
    """Run-split genomes (non-ACGT characters) flow through the compact
    bounds path identically to read_fasta + sketch_packed."""
    cfg = SketchConfig(window=10, k=7, scale=3)
    sk = FracMinHashSketcher(cfg)
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        # two records, one with an embedded run break
        with open(tmp_path / f"m{i}.fa", "w") as f:
            s1 = "".join("ACGT"[c] for c in random_genome(rng, 700))
            s2 = "".join("ACGT"[c] for c in random_genome(rng, 500))
            f.write(f">a{i}\n{s1[:300]}NN{s1[300:]}\n>b{i}\n{s2}\n")
        paths.append(str(tmp_path / f"m{i}.fa"))
    res = all_pairs_from_files(sk, paths, dispatch=2)
    sketches = sk.sketch_files(paths)
    np.testing.assert_array_equal(res.counts,
                                  np.array([s.count for s in sketches]))
    np.testing.assert_array_equal(res.inter, _reference_matrix(sk, sketches))


def test_driver_pipeline_csv_byte_identical(tmp_path, monkeypatch):
    """run_experiment routed through the device pipeline
    (SKS_DEVICE_PIPELINE=1) writes a byte-identical CSV to the two-step
    sketch_files + all_pairs path, timings printed in the reference
    format."""
    from spaced_kmer_sketching_tpu.driver import run_experiment

    rng = np.random.default_rng(31)
    paths = [write_fasta(tmp_path / f"d{i}.fa", [random_genome(rng, 1200)])
             for i in range(5)]
    cfg = SketchConfig(window=12, k=8, scale=5)
    a = tmp_path / "two_step.csv"
    b = tmp_path / "pipeline.csv"
    monkeypatch.setenv("SKS_DEVICE_PIPELINE", "0")
    ani0 = run_experiment(12, 8, paths, str(a), False, config=cfg,
                          echo_timings=False)
    monkeypatch.setenv("SKS_DEVICE_PIPELINE", "1")
    ani1 = run_experiment(12, 8, paths, str(b), False, config=cfg,
                          echo_timings=False)
    np.testing.assert_array_equal(ani0, ani1)
    assert a.read_bytes() == b.read_bytes()


def test_mesh_pipeline_matches_single_device(tmp_path):
    """MeshDevicePipeline (sharded sketch + per-device presort + tiles
    split across the virtual 8-device mesh) is bit-identical to the
    single-device pipeline and the host engine, including a ragged tail
    block, multi-record genomes, and non-ACGT splits."""
    import jax
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh
    from spaced_kmer_sketching_tpu.pipeline import (MeshDevicePipeline,
                                                    file_source)

    rng = np.random.default_rng(41)
    paths = []
    for i in range(10):
        with open(tmp_path / f"z{i}.fa", "w") as f:
            s = "".join("ACGT"[c] for c in random_genome(rng, 900 + 31 * i))
            f.write(f">a{i}\n{s[:400]}NN{s[400:]}\n")
        paths.append(str(tmp_path / f"z{i}.fa"))
    cfg = SketchConfig(window=12, k=8, scale=5)
    sk = FracMinHashSketcher(cfg)
    import os
    n = max(os.path.getsize(p) for p in paths)

    want = all_pairs_from_files(sk, paths, dispatch=4)
    mesh = make_mesh(devices=jax.devices()[:8])
    pipe = MeshDevicePipeline(sk, mesh)
    got = pipe.all_pairs(file_source(paths), len(paths), n,
                         verify_ids=[0, 7])
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.inter, want.inter)
    for i in (0, 7):
        np.testing.assert_array_equal(got.sample_keys[i],
                                      want.sample_keys[i]
                                      if i in want.sample_keys else
                                      got.sample_keys[i])
    sketches = sk.sketch_files(paths)
    np.testing.assert_array_equal(
        got.counts, np.array([s.count for s in sketches]))


def test_driver_mesh_pipeline_csv_byte_identical(tmp_path, monkeypatch):
    """--mesh runs routed through MeshDevicePipeline
    (SKS_DEVICE_PIPELINE=1, single process) write a byte-identical CSV to
    the plain mesh path and the single-device path."""
    from spaced_kmer_sketching_tpu.driver import main as driver_main

    rng = np.random.default_rng(53)
    paths = [write_fasta(tmp_path / f"m{i}.fa", [random_genome(rng, 1100)])
             for i in range(4)]
    args = ["--window", "12", "--k", "8", "--scale", "5"]
    a, b, c = (str(tmp_path / f"{x}.csv") for x in "abc")
    monkeypatch.setenv("SKS_DEVICE_PIPELINE", "0")
    assert driver_main([a, *paths, *args]) == 0
    assert driver_main([b, *paths, *args, "--mesh", "2x4"]) == 0
    monkeypatch.setenv("SKS_DEVICE_PIPELINE", "1")
    assert driver_main([c, *paths, *args, "--mesh", "2x4"]) == 0
    import pathlib
    assert pathlib.Path(b).read_bytes() == pathlib.Path(a).read_bytes()
    assert pathlib.Path(c).read_bytes() == pathlib.Path(a).read_bytes()


def test_pipeline_capacity_overflow_retry():
    """A deliberately tiny sketch_capacity forces the pipeline's
    _CapacityOverflow retry (raised mid-sketch from the per-block
    finalize); the retried run must match the uncapped run
    exactly."""
    cfg_small = SketchConfig(window=20, k=16, scale=20, sketch_capacity=256)
    cfg_auto = SketchConfig(window=20, k=16, scale=20)
    g, n = 6, 40_000          # ~2000 expected keys >> 256
    res_s = DevicePipeline(FracMinHashSketcher(cfg_small), block=128) \
        .all_pairs(codes_source(g, n, seed=4), g, n)
    res_a = DevicePipeline(FracMinHashSketcher(cfg_auto), block=128) \
        .all_pairs(codes_source(g, n, seed=4), g, n)
    assert int(res_s.counts.max()) > 256          # the retry actually fired
    np.testing.assert_array_equal(res_s.counts, res_a.counts)
    np.testing.assert_array_equal(res_s.inter, res_a.inter)
