"""End-to-end driver tests: pair generators, CSV schema, experiment parity
with the pure-Python oracle (reference semantics per src/kmer-sketching.cpp)."""
import numpy as np
import pytest

from spaced_kmer_sketching_tpu.config import SketchConfig
from spaced_kmer_sketching_tpu.csvout import CSV_HEADER, format_double, write_to_csv
from spaced_kmer_sketching_tpu.driver import (reference_sweep_schedule,
                                              run_experiment)
from spaced_kmer_sketching_tpu.generators import (all_pair_indices,
                                                  generate_all_pairs_from_vector,
                                                  generate_pairwise_from_vector,
                                                  ring_pair_indices)
from spaced_kmer_sketching_tpu.ingest.fasta import read_fasta
from spaced_kmer_sketching_tpu.utils import boosthash
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

from oracle import (mutate, oracle_ani, oracle_containment, oracle_sketch,
                    random_genome)

BASES = "ACGT"


def write_fasta(path, seqs, name="rec"):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{name}{i}\n")
            codes_str = "".join(BASES[c] for c in s)
            for j in range(0, len(codes_str), 70):
                f.write(codes_str[j:j + 70] + "\n")
    return str(path)


# ---- generators (src/generators.hpp:21-58) -----------------------------------

def test_ring_pairs():
    assert ring_pair_indices(4) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    assert ring_pair_indices(1) == [(0, 0)]
    assert generate_pairwise_from_vector(["a", "b"]) == [("a", "b"), ("b", "a")]


def test_all_pairs_ordered_incl_self():
    # full n^2, i outer, j inner, self-pairs included (generators.hpp:45-58)
    assert all_pair_indices(2) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert generate_all_pairs_from_vector(["x"]) == [("x", "x")]


# ---- CSV writer (src/kmer-sketching.cpp:46-81) -------------------------------

def test_csv_schema_and_append(tmp_path):
    mask = spaced_seed_mask(10, 10, 0)
    out = str(tmp_path / "r.csv")
    write_to_csv(["a"], ["b"], [0.987654321], 10, mask, out, is_append=False)
    write_to_csv(["c"], ["d"], [1.0], 10, mask, out, is_append=True)
    lines = open(out).read().splitlines()
    assert lines[0] == CSV_HEADER
    assert len(lines) == 3
    f1, f2, val, w, bits = lines[1].split(",")
    assert (f1, f2, w) == ("a", "b", "10")
    assert val == "0.987654"          # C++ ostream 6 sig digits
    assert bits == mask.bitstring() and len(bits) == 128
    assert lines[2].startswith("c,d,1,10,")


def test_csv_row_count_is_min_of_lengths(tmp_path):
    # numEntries = min of the three list sizes (src/kmer-sketching.cpp:73)
    mask = spaced_seed_mask(12, 8, 0)
    out = str(tmp_path / "m.csv")
    write_to_csv(["a", "b", "c"], ["x", "y"], [0.5], 12, mask, out)
    assert len(open(out).read().splitlines()) == 2


def test_format_double_matches_cpp_defaults():
    assert format_double(1.0) == "1"
    assert format_double(0.0) == "0"
    assert format_double(0.925) == "0.925"
    assert format_double(0.1234567) == "0.123457"


# ---- end-to-end experiment vs oracle -----------------------------------------

def oracle_experiment(fasta_paths, window, k, scale, nonce=1, variant="modern",
                      seed=0):
    mask = spaced_seed_mask(window, k, seed)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, nonce, variant)
    sketches = []
    for p in fasta_paths:
        packed = read_fasta(p)
        runs, pos = [], 0
        for ln in packed.run_lens:
            runs.append([int(c) for c in packed.codes[pos:pos + int(ln)]])
            pos += int(ln)
        sketches.append(oracle_sketch(runs, mask.value, window, salt, scale,
                                      variant))
    anis = []
    for i in range(len(sketches)):
        for j in range(len(sketches)):
            inter = len(sketches[i] & sketches[j])
            c = oracle_containment(inter, len(sketches[i]))
            anis.append(oracle_ani(c, mask.care_positions))
    return np.array(anis)


@pytest.mark.parametrize("window,k,scale", [(12, 8, 5), (20, 16, 20)])
def test_run_experiment_matches_oracle(tmp_path, window, k, scale):
    rng = np.random.default_rng(7)
    base = random_genome(rng, 4000)
    paths = [
        write_fasta(tmp_path / "g0.fa", [base]),
        write_fasta(tmp_path / "g1.fa", [mutate(rng, base, 0.05)]),
        write_fasta(tmp_path / "g2.fa", [random_genome(rng, 3000)]),
    ]
    cfg = SketchConfig(window=window, k=k, scale=scale)
    out = str(tmp_path / "ani.csv")
    ani = run_experiment(window, k, paths, out, False, config=cfg,
                         echo_timings=False)
    want = oracle_experiment(paths, window, k, scale)
    np.testing.assert_array_equal(ani, want)

    lines = open(out).read().splitlines()
    assert lines[0] == CSV_HEADER
    assert len(lines) == 1 + 9          # 3 genomes -> 9 ordered pairs
    # self-pair of genome 0 must be ANI 1
    row00 = lines[1].split(",")
    assert row00[0] == paths[0] and row00[1] == paths[0] and row00[2] == "1"


def test_experiment_with_non_acgt_and_multirecord(tmp_path):
    rng = np.random.default_rng(11)
    g = random_genome(rng, 1500)
    p0 = tmp_path / "n0.fa"
    with open(p0, "w") as f:
        f.write(">r0\n")
        s = "".join(BASES[c] for c in g)
        f.write(s[:700] + "NN\n" + s[700:] + "\n>r1\n" + s[:300] + "\n")
    p1 = write_fasta(tmp_path / "n1.fa", [mutate(rng, g, 0.02)])
    paths = [str(p0), str(p1)]
    cfg = SketchConfig(window=14, k=9, scale=4)
    ani = run_experiment(14, 9, paths, str(tmp_path / "o.csv"), False,
                         config=cfg, echo_timings=False)
    want = oracle_experiment(paths, 14, 9, 4)
    np.testing.assert_array_equal(ani, want)


# ---- sweep schedule (src/kmer-sketching.cpp:214-240) -------------------------

def test_reference_sweep_schedule():
    sched = reference_sweep_schedule()
    assert len(sched) == 62
    assert sched[0] == (10, 10, False)
    assert sched[1] == (11, 11, True) and sched[30] == (40, 40, True)
    assert sched[31] == (20, 10, True) and sched[61] == (50, 40, True)
    assert all(a for _, _, a in sched[1:])


def test_ring_pairing_mode(tmp_path):
    rng = np.random.default_rng(21)
    base = random_genome(rng, 2000)
    paths = [write_fasta(tmp_path / f"r{i}.fa", [g]) for i, g in enumerate(
        [base, mutate(rng, base, 0.04), random_genome(rng, 2000)])]
    cfg = SketchConfig(window=12, k=8, scale=5)
    out = str(tmp_path / "ring.csv")
    ani = run_experiment(12, 8, paths, out, False, config=cfg,
                         echo_timings=False, pairing="ring")
    lines = open(out).read().splitlines()
    assert len(lines) == 1 + 3           # ring: n pairs for n genomes
    # pair order (0,1),(1,2),(2,0) per generators.hpp:21-34
    assert lines[1].split(",")[:2] == [paths[0], paths[1]]
    assert lines[3].split(",")[:2] == [paths[2], paths[0]]
    # values match the all-pairs run's corresponding entries
    full = oracle_experiment(paths, 12, 8, 5).reshape(3, 3)
    np.testing.assert_array_equal(ani, [full[0, 1], full[1, 2], full[2, 0]])


def test_sketch_files_error_isolation(tmp_path):
    from spaced_kmer_sketching_tpu.models.fracminhash import FracMinHashSketcher
    rng = np.random.default_rng(33)
    ok = write_fasta(tmp_path / "ok.fa", [random_genome(rng, 1500)])
    missing = str(tmp_path / "nope.fa")
    sk = FracMinHashSketcher(SketchConfig(window=12, k=8, scale=5))
    # reference parity: a bad file kills the run
    with pytest.raises(FileNotFoundError):
        sk.sketch_files([ok, missing])
    # isolation mode: bad genome -> empty sketch, good one still computed
    out = sk.sketch_files([ok, missing], on_error="skip")
    assert out[0].count > 0 and out[1].count == 0


def test_legacy_hash_variant_end_to_end(tmp_path):
    """boost < 1.81 hash variant through the full experiment (the reference's
    numeric output depends on which boost it was built against)."""
    rng = np.random.default_rng(41)
    base = random_genome(rng, 3000)
    paths = [write_fasta(tmp_path / "l0.fa", [base]),
             write_fasta(tmp_path / "l1.fa", [mutate(rng, base, 0.05)])]
    cfg = SketchConfig(window=14, k=10, scale=8, hash_variant="legacy")
    ani = run_experiment(14, 10, paths, str(tmp_path / "l.csv"), False,
                         config=cfg, echo_timings=False)
    want = oracle_experiment(paths, 14, 10, 8, variant="legacy")
    np.testing.assert_array_equal(ani, want)
    # and it differs from the modern variant (different kept k-mer sets)
    modern = oracle_experiment(paths, 14, 10, 8, variant="modern")
    assert not np.array_equal(want, modern)


def test_sweep_resume_with_store(tmp_path):
    """An interrupted sweep rerun with --store recomputes nothing for
    already-sketched (mask, window, k) configs."""
    from spaced_kmer_sketching_tpu.store import SketchStore
    rng = np.random.default_rng(51)
    paths = [write_fasta(tmp_path / f"s{i}.fa", [random_genome(rng, 1200)])
             for i in range(2)]
    store = SketchStore(str(tmp_path / "st"))
    cfg = SketchConfig(window=12, k=8, scale=5)
    out = str(tmp_path / "s.csv")
    a1 = run_experiment(12, 8, paths, out, False, config=cfg,
                        echo_timings=False, store=store)
    files_before = sorted(p.name for p in (tmp_path / "st").iterdir())
    a2 = run_experiment(12, 8, paths, out, True, config=cfg,
                        echo_timings=False, store=store)
    files_after = sorted(p.name for p in (tmp_path / "st").iterdir())
    np.testing.assert_array_equal(a1, a2)
    assert files_before == files_after      # nothing new sketched


def test_mesh_driver_csv_identical(tmp_path):
    """--mesh 2x4 on the virtual 8-device mesh produces a byte-identical
    CSV to the single-device run (sketching AND all-pairs sharded)."""
    from spaced_kmer_sketching_tpu.driver import main as driver_main
    rng = np.random.default_rng(21)
    fastas = [write_fasta(tmp_path / f"g{i}.fa",
                          [rng.integers(0, 4, 4000)])
              for i in range(3)]
    single = tmp_path / "single.csv"
    meshed = tmp_path / "mesh.csv"
    for w, k, append in [(20, 16, False), (12, 12, True)]:
        args = [str(single), *fastas, "--window", str(w), "--k", str(k)]
        if append:
            args.append("--append")
        assert driver_main(args) == 0
        margs = [str(meshed), *fastas, "--window", str(w), "--k", str(k),
                 "--mesh", "2x4"]
        if append:
            margs.append("--append")
        assert driver_main(margs) == 0
    assert meshed.read_bytes() == single.read_bytes()


def test_missing_fasta_cli_error_parity(tmp_path, capsys):
    """An unopenable FASTA makes the CLI print the reference's exact stderr
    bytes and exit 1 (src/fasta_processing.cpp:86-90)."""
    from spaced_kmer_sketching_tpu.driver import main as driver_main
    missing = str(tmp_path / "nope.fa")
    rc = driver_main([str(tmp_path / "o.csv"), missing,
                      "--window", "12", "--k", "8"])
    captured = capsys.readouterr()
    assert rc == 1
    assert captured.err == f"Unable to open {missing}. \n Exiting...\n"


def test_sweep_kill_and_resume_pair_level(tmp_path, monkeypatch):
    """A sweep killed mid-config and rerun with --store resumes at PAIR
    level: finished configs are skipped entirely, the interrupted config
    appends only its missing rows, and the final CSV is byte-identical to
    an uninterrupted sweep (src/kmer-sketching.cpp:53-70 append contract).
    The mini-schedule includes two configs sharing window 20 so resume
    keys must disambiguate by mask."""
    import spaced_kmer_sketching_tpu.driver as drv
    from spaced_kmer_sketching_tpu.store import SketchStore

    sched = [(12, 8, False), (20, 20, True), (20, 10, True)]
    monkeypatch.setattr(drv, "reference_sweep_schedule", lambda: sched)
    rng = np.random.default_rng(7)
    paths = [write_fasta(tmp_path / f"g{i}.fa", [random_genome(rng, 1500)])
             for i in range(3)]
    cfg = SketchConfig(window=12, k=8, scale=5)

    full = tmp_path / "full.csv"
    drv.run_reference_sweep(str(full), paths, config=cfg, echo_timings=False,
                            store=SketchStore(str(tmp_path / "stA")))
    lines = full.read_text().splitlines(keepends=True)
    rows_per_cfg = len(paths) ** 2
    assert len(lines) == 1 + len(sched) * rows_per_cfg

    # simulate a kill 4 rows into config 3 (configs 1-2 fully written)
    resume = tmp_path / "resume.csv"
    resume.write_text("".join(lines[:1 + 2 * rows_per_cfg + 4]))
    sketch_calls = []
    orig = drv.FracMinHashSketcher.sketch_file
    monkeypatch.setattr(
        drv.FracMinHashSketcher, "sketch_file",
        lambda self, *a, **k: (sketch_calls.append(self.config.window),
                               orig(self, *a, **k))[1])
    drv.run_reference_sweep(str(resume), paths, config=cfg,
                            echo_timings=False,
                            store=SketchStore(str(tmp_path / "stB")))
    assert resume.read_bytes() == full.read_bytes()
    # only the interrupted config re-sketched (configs 1-2 never touched)
    assert set(sketch_calls) == {20} and len(sketch_calls) == len(paths)


def test_pipeline_routing_gate(tmp_path, monkeypatch):
    """The driver's one-flow routing gate, chosen from the input alone:
    more than 512 genomes, and the padding-economics guard (the pipeline
    shapes every genome to the largest file, so a heterogeneous
    collection stays on the two-step path, which buckets genomes by
    padded shape).  The backend plays no part."""
    import jax

    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.driver import _use_device_pipeline
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)

    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=20))

    def mk(n_small, n_big, big_bytes=30000):
        paths = []
        for i in range(n_small):
            p = tmp_path / f"s{i}.fa"
            p.write_bytes(b">s\n" + b"ACGT" * 750 + b"\n")
            paths.append(str(p))
        for i in range(n_big):
            p = tmp_path / f"b{i}.fa"
            p.write_bytes(b">b\n" + b"ACGT" * (big_bytes // 4) + b"\n")
            paths.append(str(p))
        return paths

    monkeypatch.delenv("SKS_DEVICE_PIPELINE", raising=False)
    homog = mk(600, 0)
    assert _use_device_pipeline(sk, homog, "all", None)
    # below the threshold
    assert not _use_device_pipeline(sk, homog[:512], "all", None)
    assert _use_device_pipeline(sk, homog[:513], "all", None)
    # heterogeneous: one 10x-larger genome makes padding dominate
    hetero = mk(600, 1)
    assert not _use_device_pipeline(sk, hetero, "all", None)
    # the same decision whatever backend JAX reports
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        assert _use_device_pipeline(sk, homog, "all", None)
        assert not _use_device_pipeline(sk, hetero, "all", None)
    # ring pairing / store-backed runs keep the two-step path
    assert not _use_device_pipeline(sk, homog, "ring", None)
    assert not _use_device_pipeline(sk, homog, "all", object())
    # the environment override still wins both ways
    monkeypatch.setenv("SKS_DEVICE_PIPELINE", "0")
    assert not _use_device_pipeline(sk, homog, "all", None)
    monkeypatch.setenv("SKS_DEVICE_PIPELINE", "1")
    assert _use_device_pipeline(sk, homog[:4], "all", None)


def test_sweep_shares_program_buckets():
    """The 62-config reference sweep runs one static sketch program per
    config (window, salt and capacity are compile-time constants); the
    persistent compile cache, not a shared program, makes reruns hot.
    Every config's sketch program is keyed distinctly, and the all-pairs
    key geometry still collapses into <= 4 key-word buckets."""
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.driver import reference_sweep_schedule
    from spaced_kmer_sketching_tpu.ops.gram import key_words_for_window
    from spaced_kmer_sketching_tpu.utils import boosthash
    from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

    configs = [(w, k) for w, k, _ in reference_sweep_schedule()]
    assert len(configs) == 62
    keys = set()
    for w, k in configs:
        cfg = SketchConfig(window=w, k=k)
        m = spaced_seed_mask(w, k, cfg.mask_seed)
        salt = boosthash.fmh_salt(m.lo, m.hi, w, cfg.nonce, cfg.hash_variant)
        keys.add((w, salt, cfg.capacity_for(1_550_000 - w + 1)))
    assert len(keys) == 62
    buckets = {key_words_for_window(w) for w, _ in configs}
    assert len(buckets) <= 4, buckets
