"""Parallel layer on a virtual 8-device CPU mesh (conftest.py forces it):
sharded sketching, 2-D tiled all-pairs, sequence-parallel halo extraction,
multi-seed fused sketching.  Everything must be bit-identical to the
single-device path / oracle — determinism across shardings is this
framework's analog of race detection (SURVEY.md §5)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
from spaced_kmer_sketching_tpu.ops.sketch import (merge_sketches,
                                                  sketch_from_codes,
                                                  sketch_from_codes_multiseed)
from spaced_kmer_sketching_tpu.ops import u64ops
from spaced_kmer_sketching_tpu.parallel import (make_mesh, pack_genome_batch,
                                                sharded_all_pairs_fn,
                                                sharded_ani_fn,
                                                sharded_sketch_fn,
                                                sequence_parallel_sketch_fn)
from spaced_kmer_sketching_tpu.utils import boosthash
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

from oracle import oracle_ani, oracle_containment, oracle_sketch

WINDOW, K, SCALE, VARIANT = 16, 12, 5, "modern"


def setup_module(module):
    assert jax.device_count() == 8, "conftest must fake 8 CPU devices"


def _mask_salt():
    mask = spaced_seed_mask(WINDOW, K, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, WINDOW, 1, VARIANT)
    return mask, salt


def _keys_to_set(keys, count):
    k = np.asarray(keys, dtype=np.uint64)
    return {int(k[i, 0]) | int(k[i, 1]) << 32 | int(k[i, 2]) << 64 |
            int(k[i, 3]) << 96 for i in range(int(count))}


class FakePacked:
    def __init__(self, runs):
        self.codes = np.concatenate([np.asarray(r, np.uint8) for r in runs])
        self.run_lens = np.array([len(r) for r in runs], dtype=np.int64)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((4, 2))


@pytest.fixture(scope="module")
def genomes():
    rng = np.random.default_rng(3)
    gs = []
    for i in range(6):
        runs = [list(rng.integers(0, 4, n))
                for n in rng.integers(200, 1200, size=rng.integers(1, 4))]
        gs.append(FakePacked(runs))
    return gs


def test_sharded_sketch_matches_oracle(mesh, genomes):
    mask, salt = _mask_salt()
    codes, run_ids, g = pack_genome_batch(genomes, mesh.devices.size, WINDOW)
    assert codes.shape[0] % 8 == 0
    fn = sharded_sketch_fn(mesh, window=WINDOW, salt=salt, scale=SCALE,
                           variant=VARIANT, capacity=512)
    out = fn(jnp.asarray(codes), jnp.asarray(run_ids),
             jnp.asarray(mask.words_u32))
    for i, gnm in enumerate(genomes):
        runs, pos = [], 0
        for ln in gnm.run_lens:
            runs.append([int(c) for c in gnm.codes[pos:pos + ln]])
            pos += int(ln)
        want = oracle_sketch(runs, mask.value, WINDOW, salt, SCALE, VARIANT)
        got = _keys_to_set(out.keys[i], out.count[i])
        assert got == want, f"genome {i}"
    # padding rows are empty
    for i in range(g, codes.shape[0]):
        assert int(out.count[i]) == 0


def test_sharded_all_pairs_and_ani(mesh, genomes):
    mask, salt = _mask_salt()
    codes, run_ids, g = pack_genome_batch(genomes, mesh.devices.size, WINDOW)
    sk = sharded_sketch_fn(mesh, window=WINDOW, salt=salt, scale=SCALE,
                           variant=VARIANT, capacity=512)
    out = sk(jnp.asarray(codes), jnp.asarray(run_ids),
             jnp.asarray(mask.words_u32))
    pairs = sharded_all_pairs_fn(mesh)
    inter = np.asarray(pairs(out.keys, out.count))
    gp = codes.shape[0]
    assert inter.shape == (gp, gp)

    sets = [_keys_to_set(out.keys[i], out.count[i]) for i in range(gp)]
    want = np.array([[len(a & b) for b in sets] for a in sets])
    np.testing.assert_array_equal(inter, want)

    _, ani = sharded_ani_fn(mesh, mask.care_positions)(out.keys, out.count)
    ani = np.asarray(ani)
    for i in range(g):
        for j in range(g):
            c = oracle_containment(int(inter[i, j]), len(sets[i]))
            assert ani[i, j] == pytest.approx(
                oracle_ani(c, mask.care_positions), rel=2e-6)
    assert np.allclose(np.diag(ani)[:g], 1.0)


def test_sequence_parallel_matches_single_device(mesh):
    rng = np.random.default_rng(9)
    n = 8 * 1024
    # two runs split mid-sequence; run ids are global so halos stay correct
    run_lens = [3000, n - 3000]
    codes = rng.integers(0, 4, n).astype(np.uint32)
    run_id = run_ids_from_lens(run_lens, n)
    mask, salt = _mask_salt()

    sp = sequence_parallel_sketch_fn(mesh, window=WINDOW, salt=salt,
                                     scale=SCALE, variant=VARIANT,
                                     capacity=4096)
    out = sp(jnp.asarray(codes), jnp.asarray(run_id),
             jnp.asarray(mask.words_u32))

    ref = sketch_from_codes(jnp.asarray(codes), jnp.asarray(run_id),
                            jnp.asarray(mask.words_u32), window=WINDOW,
                            salt=salt, scale=SCALE, variant=VARIANT,
                            capacity=4096)
    assert int(ref.raw_kept) <= 4096, "test must not overflow capacity"
    assert int(out.count) == int(ref.count)
    assert _keys_to_set(out.keys, out.count) == _keys_to_set(ref.keys,
                                                             ref.count)
    # all devices hold the same replicated sketch
    assert int(out.raw_kept) >= int(out.count)


def test_merge_sketches_dedups_across_chunks():
    mask, salt = _mask_salt()
    rng = np.random.default_rng(5)
    runs_a = [list(rng.integers(0, 4, 900))]
    runs_b = [runs_a[0][:500] + list(rng.integers(0, 4, 400))]  # overlap
    outs = []
    for runs in (runs_a, runs_b):
        total = sum(map(len, runs))
        n = total + WINDOW
        codes = np.zeros(n, np.uint32)
        codes[:total] = [c for r in runs for c in r]
        rid = run_ids_from_lens([len(r) for r in runs], n)
        outs.append(sketch_from_codes(
            jnp.asarray(codes), jnp.asarray(rid), jnp.asarray(mask.words_u32),
            window=WINDOW, salt=salt, scale=SCALE, variant=VARIANT,
            capacity=256))
    keys = jnp.stack([o.keys for o in outs])
    counts = jnp.stack([o.count for o in outs])
    merged = merge_sketches(keys, counts, 1024)
    assert int(merged.raw_kept) <= 1024  # no overflow: merge is exact here
    want = _keys_to_set(outs[0].keys, outs[0].count) | _keys_to_set(
        outs[1].keys, outs[1].count)
    assert _keys_to_set(merged.keys, merged.count) == want


def test_multiseed_fused_matches_per_seed():
    rng = np.random.default_rng(13)
    runs = [list(rng.integers(0, 4, 2500))]
    total = len(runs[0])
    n = total + WINDOW
    codes = np.zeros(n, np.uint32)
    codes[:total] = runs[0]
    rid = run_ids_from_lens([total], n)

    seeds = list(range(8))
    masks = [spaced_seed_mask(WINDOW, K, s) for s in seeds]
    salts = [boosthash.fmh_salt(m.lo, m.hi, WINDOW, 1, VARIANT)
             for m in masks]
    masks_w = jnp.asarray(np.stack([m.words_u32 for m in masks]))
    salt_pairs = jnp.asarray(np.stack([u64ops.salt_pair(s) for s in salts]))

    fused = sketch_from_codes_multiseed(
        jnp.asarray(codes), jnp.asarray(rid), masks_w, salt_pairs,
        window=WINDOW, scale=SCALE, variant=VARIANT, capacity=1024)
    for s in seeds:
        one = sketch_from_codes(
            jnp.asarray(codes), jnp.asarray(rid),
            jnp.asarray(masks[s].words_u32), window=WINDOW, salt=salts[s],
            scale=SCALE, variant=VARIANT, capacity=1024)
        assert _keys_to_set(fused.keys[s], fused.count[s]) == _keys_to_set(
            one.keys, one.count), f"seed {s}"
        want = oracle_sketch(runs, masks[s].value, WINDOW, salts[s], SCALE,
                             VARIANT)
        assert _keys_to_set(fused.keys[s], fused.count[s]) == want


def test_distributed_helpers_single_process():
    from spaced_kmer_sketching_tpu.parallel.distributed import (
        global_mesh, init_distributed, process_shard)
    init_distributed()           # no-op/idempotent in a single-process run
    init_distributed()
    mesh = global_mesh()
    assert mesh.devices.size == jax.device_count()
    assert process_shard(10) == slice(0, 10)


def test_mesh_sketcher_seq_parallel_bitexact():
    """A long genome through MeshSketcher.sketch_packed (sequence-parallel
    halo ring) is bit-identical to the single-device sketch, including when
    the initial capacity overflows and the host retry kicks in."""
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs
    from spaced_kmer_sketching_tpu.models.fracminhash import FracMinHashSketcher
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh
    from spaced_kmer_sketching_tpu.parallel.sketcher import MeshSketcher

    rng = np.random.default_rng(17)
    n = 50_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    # two runs: one non-ACGT split lands mid-sequence
    packed = PackedSeqs(codes=codes,
                        run_lens=np.array([n // 3, n - n // 3], np.int64))

    cfg = SketchConfig(window=20, k=16, scale=20)
    want = FracMinHashSketcher(cfg).sketch_packed(packed, name="g")

    mesh = make_mesh(devices=jax.devices()[:8])
    ms = MeshSketcher(cfg, mesh, seq_par_threshold=1)   # force the CP path
    got = ms.sketch_packed(packed, name="g")
    assert got.count == want.count
    np.testing.assert_array_equal(got.keys, want.keys)

    # overflow: force a tiny starting capacity via sketch_capacity
    cfg2 = SketchConfig(window=20, k=16, scale=20, sketch_capacity=256)
    ms2 = MeshSketcher(cfg2, mesh, seq_par_threshold=1)
    got2 = ms2.sketch_packed(packed, name="g")
    assert got2.count == want.count
    np.testing.assert_array_equal(got2.keys, want.keys)


def test_blocked_all_pairs_matches_tile():
    """The memory-bounded block-row/column schedule (10k-genome path)
    reproduces the monolithic tile matrix, including a store-style
    block provider."""
    from spaced_kmer_sketching_tpu.ops.intersect import intersection_tile
    from spaced_kmer_sketching_tpu.parallel.allpairs import blocked_all_pairs
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(31)
    g, cap = 16, 256
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    pool = np.unique(rng.integers(0, 1 << 30, 400).astype(np.uint32))
    for i in range(g):
        vals = np.unique(rng.choice(pool, 150))
        keys[i, :vals.size, 0] = vals
        keys[i, :vals.size, 1:3] = 0
        keys[i, :vals.size, 3] = 0
        counts[i] = vals.size
    mesh = make_mesh(devices=jax.devices()[:8])
    want = np.asarray(intersection_tile(jnp.asarray(keys),
                                        jnp.asarray(counts),
                                        jnp.asarray(keys),
                                        jnp.asarray(counts)))
    got = blocked_all_pairs(mesh, keys, counts, block=8)
    np.testing.assert_array_equal(got, want)

    def provider(i0, i1):
        return keys[i0:i1], counts[i0:i1]
    got2 = blocked_all_pairs(mesh, provider, g, block=8)
    np.testing.assert_array_equal(got2, want)

    # the macro-tile Gram engine (stacked on-device Gram, upper-triangle
    # sweep with symmetric fill) must agree tile-for-tile
    got3 = blocked_all_pairs(mesh, provider, g, block=8, engine="gram")
    np.testing.assert_array_equal(got3, want)

    # array (non-callable) input exercises the internal provider closure
    # across >2 blocks — a local rebinding once shadowed its counts
    got4 = blocked_all_pairs(mesh, keys, counts, block=4, engine="gram")
    np.testing.assert_array_equal(got4, want)

    # ragged tail block (g not a block multiple) takes the dedicated
    # rect dispatch alongside the grouped full blocks
    got5 = blocked_all_pairs(mesh, keys, counts, block=6, engine="gram")
    np.testing.assert_array_equal(got5, want)

    # key_words < 4 slims the uploads (keys here live in word 0 only;
    # word 1 is the sentinel guard)
    got6 = blocked_all_pairs(mesh, keys, counts, block=4, engine="gram",
                             key_words=2)
    np.testing.assert_array_equal(got6, want)


def test_sharded_gram_matches_sets(mesh, genomes):
    """Gram all-pairs with union tiles sharded over the mesh equals
    the Python set intersections (and thus the probe engine above)."""
    from spaced_kmer_sketching_tpu.ops.gram import build_rank_layout
    from spaced_kmer_sketching_tpu.parallel.allpairs import sharded_gram_fn

    mask, salt = _mask_salt()
    codes, run_ids, g = pack_genome_batch(genomes, mesh.devices.size, WINDOW)
    sk = sharded_sketch_fn(mesh, window=WINDOW, salt=salt, scale=SCALE,
                           variant=VARIANT, capacity=512)
    out = sk(jnp.asarray(codes), jnp.asarray(run_ids),
             jnp.asarray(mask.words_u32))
    keys = np.asarray(out.keys)
    counts = np.asarray(out.count)
    packed, _ = build_rank_layout(keys, counts, tile=256)
    nt = packed.shape[0]
    ntp = -(-nt // mesh.devices.size) * mesh.devices.size
    packed = np.concatenate(
        [packed, np.zeros((ntp - nt,) + packed.shape[1:], packed.dtype)])
    inter = np.asarray(sharded_gram_fn(mesh)(jnp.asarray(packed)))
    gp = keys.shape[0]
    sets = [_keys_to_set(out.keys[i], out.count[i]) for i in range(gp)]
    want = np.array([[len(a & b) for b in sets] for a in sets])
    np.testing.assert_array_equal(inter[:gp, :gp], want)


def test_mesh_sketcher_all_pairs_gram_matches_probe(tmp_path, genomes):
    """MeshSketcher.all_pairs_intersections (sharded gram) is identical to
    both its probe shard_map engine and the single-device sketcher."""
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.models.fracminhash import FracMinHashSketcher
    from spaced_kmer_sketching_tpu.parallel.sketcher import MeshSketcher

    paths = []
    for i, pk in enumerate(genomes[:6]):
        # FakePacked runs -> one record per ACGT run (run split semantics)
        seqs, pos = [], 0
        for ln in pk.run_lens:
            seqs.append("".join("ACGT"[c] for c in pk.codes[pos:pos + ln]))
            pos += int(ln)
        p = tmp_path / f"g{i}.fa"
        p.write_text("".join(f">s{r}\n{s}\n" for r, s in enumerate(seqs)))
        paths.append(str(p))
    cfg = SketchConfig(window=WINDOW, k=K, scale=SCALE, hash_variant=VARIANT)
    msk = MeshSketcher(cfg)
    sketches = msk.sketch_files(paths)
    got = msk.all_pairs_intersections(sketches)
    probe = msk.all_pairs_intersections_shardmap(sketches)
    single = FracMinHashSketcher(cfg).all_pairs_intersections(sketches)
    np.testing.assert_array_equal(got, probe)
    np.testing.assert_array_equal(got, single)


def test_blocked_all_pairs_cached_schedule():
    """The block-cache gram schedule (128-multiple power-of-two blocks:
    presorted packed cache + batched pair-tile dispatches) must agree with
    the probe engine, including a ragged tail block and multiple pair
    batches."""
    import jax
    from spaced_kmer_sketching_tpu.ops.intersect import intersection_tile
    from spaced_kmer_sketching_tpu.parallel.allpairs import blocked_all_pairs
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(77)
    g, cap = 300, 128                      # nb = 3, tail block of 44
    pool = np.arange(1, 4000, dtype=np.uint32) * 7919
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    for i in range(g):
        vals = np.unique(rng.choice(pool, 100))
        keys[i, :vals.size, 0] = vals
        keys[i, :vals.size, 1:] = 0
        counts[i] = vals.size
    mesh = make_mesh(devices=jax.devices()[:2])
    want = np.asarray(intersection_tile(jnp.asarray(keys),
                                        jnp.asarray(counts),
                                        jnp.asarray(keys),
                                        jnp.asarray(counts)))
    got = blocked_all_pairs(mesh, keys, counts, block=128, engine="gram",
                            key_words=2, key_bits=45, pair_batch=2)
    np.testing.assert_array_equal(got, want)


def test_blocked_all_pairs_budget_fallback(monkeypatch):
    """When the slab + presorted cache exceed the budget (out-of-core
    collections), the gram engine must fall back to the streaming
    per-tile schedule — and still produce identical counts."""
    import jax
    from spaced_kmer_sketching_tpu.ops.intersect import intersection_tile
    from spaced_kmer_sketching_tpu.parallel.allpairs import blocked_all_pairs
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(81)
    g, cap = 256, 128
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    pool = np.arange(1, 2000, dtype=np.uint32) * 104729
    for i in range(g):
        vals = np.unique(rng.choice(pool, 80))
        keys[i, :vals.size, 0] = vals
        keys[i, :vals.size, 1:] = 0
        counts[i] = vals.size
    mesh = make_mesh(devices=jax.devices()[:1])
    want = np.asarray(intersection_tile(jnp.asarray(keys),
                                        jnp.asarray(counts),
                                        jnp.asarray(keys),
                                        jnp.asarray(counts)))
    monkeypatch.setenv("SKS_BLOCKED_CACHE_BUDGET", "1024")  # force fallback
    got = blocked_all_pairs(mesh, keys, counts, block=128, engine="gram",
                            key_words=2, key_bits=45)
    np.testing.assert_array_equal(got, want)


def test_mesh_streaming_bitexact_and_routing(tmp_path, monkeypatch):
    """MeshSketcher.sketch_file_streaming (sequence-parallel segments over
    the halo ring, compact 2-bit uploads) is bit-identical to the
    single-device whole-file sketch AND the single-device streaming path,
    including non-ACGT run splits straddling segment boundaries; and
    MeshSketcher.sketch_files routes big files through it."""
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh
    from spaced_kmer_sketching_tpu.parallel.sketcher import MeshSketcher

    rng = np.random.default_rng(23)
    n = 200_000
    chars = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n)].astype(np.uint8)
    # non-ACGT splits, one of which lands near a segment boundary
    for pos in (1234, 65_530, 65_540, 150_001):
        chars[pos] = ord("N")
    body = chars.tobytes().decode()
    big = tmp_path / "big.fa"
    big.write_text(f">r0\n{body[:100_000]}\n>r1\n{body[100_000:]}\n")
    small = tmp_path / "small.fa"
    small.write_text(f">s\n{body[:3000]}\n")

    cfg = SketchConfig(window=16, k=12, scale=10)
    single = FracMinHashSketcher(cfg)
    want = single.sketch_file(str(big))
    want_stream = single.sketch_file_streaming(str(big), segment_nt=1 << 16)
    assert want_stream.count == want.count
    np.testing.assert_array_equal(want_stream.keys, want.keys)

    mesh = make_mesh(devices=jax.devices()[:8])
    ms = MeshSketcher(cfg, mesh, seq_par_threshold=1)
    got = ms.sketch_file_streaming(str(big), segment_nt=1 << 16)
    assert got.count == want.count
    np.testing.assert_array_equal(got.keys, want.keys)

    # sketch_files routes files past the threshold through mesh streaming
    calls = []
    orig = MeshSketcher.sketch_file_streaming
    monkeypatch.setattr(MeshSketcher, "_STREAM_THRESHOLD_BYTES", 50_000)
    monkeypatch.setattr(
        MeshSketcher, "sketch_file_streaming",
        lambda self, p, segment_nt=1 << 24, name="": (
            calls.append(p),
            orig(self, p, segment_nt=1 << 16, name=name))[1])
    outs = ms.sketch_files([str(big), str(small)])
    assert calls == [str(big)]
    assert outs[0].count == want.count
    np.testing.assert_array_equal(outs[0].keys, want.keys)
    want_small = single.sketch_file(str(small))
    assert outs[1].count == want_small.count
    np.testing.assert_array_equal(outs[1].keys, want_small.keys)


def test_mesh_all_pairs_packed_multiblock():
    """mesh_all_pairs_packed over several blocks (ragged tail, empty
    sketch) is bit-identical to the host gram engine on every mesh
    shape."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from spaced_kmer_sketching_tpu.ops.gram import gram_all_pairs
    from spaced_kmer_sketching_tpu.parallel.allpairs import (
        mesh_all_pairs_packed)
    from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(91)
    g, cap = 300, 256                      # nb=3 at block 128, ragged tail
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    pool = np.unique(rng.integers(0, 1 << 40, 3 * cap).astype(np.uint64))
    for i in range(g):
        vals = np.unique(rng.choice(pool, int(cap * 0.7)))
        counts[i] = vals.size
        keys[i, :vals.size, 0] = (vals & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :vals.size, 1] = (vals >> 32).astype(np.uint32)
        keys[i, :vals.size, 2:] = 0
    counts[17] = 0
    keys[17] = 0xFFFFFFFF
    want = gram_all_pairs(keys, counts).astype(np.int32)

    for nd in (1, 8):
        mesh = make_mesh(devices=jax.devices()[:nd])
        got = mesh_all_pairs_packed(
            mesh,
            lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
            np.asarray, keys, counts, key_bits=40)
        np.testing.assert_array_equal(got, want)
