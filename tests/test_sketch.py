"""Device sketch step (filter + sort + dedup) vs the oracle and the C++
scalar pipeline."""
import numpy as np
import pytest

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
from spaced_kmer_sketching_tpu.ops.sketch import sketch_from_codes
from spaced_kmer_sketching_tpu.utils import boosthash, native
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

from oracle import oracle_sketch


def device_sketch(runs, window, k, scale=200, variant="modern", capacity=512,
                  seed=0):
    mask = spaced_seed_mask(window, k, seed)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    total = sum(len(r) for r in runs)
    n = total + window  # padding
    codes = np.zeros(n, dtype=np.uint32)
    codes[:total] = [c for r in runs for c in r]
    run_id = run_ids_from_lens([len(r) for r in runs], n)
    out = sketch_from_codes(jnp.asarray(codes), jnp.asarray(run_id),
                            jnp.asarray(mask.words_u32), window=window,
                            salt=salt, scale=scale, variant=variant,
                            capacity=capacity)
    keys = np.asarray(out.keys, dtype=np.uint64)
    count = int(out.count)
    vals = set()
    for i in range(count):
        vals.add(int(keys[i, 0]) | int(keys[i, 1]) << 32 |
                 int(keys[i, 2]) << 64 | int(keys[i, 3]) << 96)
    return mask, salt, vals, count, int(out.raw_kept)


@pytest.mark.parametrize("variant", ["modern", "legacy"])
@pytest.mark.parametrize("window,k,scale", [(10, 10, 20), (20, 16, 50),
                                            (31, 17, 10), (50, 40, 100)])
def test_sketch_matches_oracle(window, k, scale, variant):
    rng = np.random.default_rng(window + k)
    runs = [list(rng.integers(0, 4, n)) for n in (2000, 500, window - 1)]
    mask, salt, got, count, raw = device_sketch(
        runs, window, k, scale=scale, variant=variant, capacity=1024)
    want = oracle_sketch(runs, mask.value, window, salt, scale, variant)
    assert got == want
    assert count == len(want)
    assert raw >= count


def test_sorted_and_padded():
    rng = np.random.default_rng(1)
    runs = [list(rng.integers(0, 4, 3000))]
    window, k, scale = 20, 16, 10
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    n = 3000 + window
    codes = np.zeros(n, dtype=np.uint32)
    codes[:3000] = runs[0]
    run_id = run_ids_from_lens([3000], n)
    out = sketch_from_codes(jnp.asarray(codes), jnp.asarray(run_id),
                            jnp.asarray(mask.words_u32), window=window,
                            salt=salt, scale=scale, variant="modern",
                            capacity=1024)
    keys = np.asarray(out.keys, np.uint64)
    count = int(out.count)
    vals = [int(keys[i, 0]) | int(keys[i, 1]) << 32 | int(keys[i, 2]) << 64 |
            int(keys[i, 3]) << 96 for i in range(count)]
    assert vals == sorted(vals) and len(set(vals)) == len(vals)
    assert (keys[count:] == 0xFFFFFFFF).all()


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_matches_cpp_scalar_pipeline():
    rng = np.random.default_rng(7)
    run_lens = [4096, 933, 5]
    codes = rng.integers(0, 4, sum(run_lens)).astype(np.uint8)
    window, k, scale = 20, 16, 20
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    cpp = native.sketch_codes(codes, np.array(run_lens), mask.lo, mask.hi,
                              window, salt, scale, legacy=False)
    cpp_vals = {int(lo) | int(hi) << 64 for lo, hi in cpp}
    pos = 0
    runs = []
    for n in run_lens:
        runs.append(list(codes[pos:pos + n]))
        pos += n
    _, _, dev_vals, _, _ = device_sketch(runs, window, k, scale=scale,
                                         capacity=2048)
    assert dev_vals == cpp_vals


def test_capacity_overflow_reported():
    rng = np.random.default_rng(3)
    runs = [list(rng.integers(0, 4, 4000))]
    # scale=2 keeps ~half the windows -> way over capacity 256
    _, _, _, count, raw = device_sketch(runs, 16, 16, scale=2, capacity=256)
    assert raw > 256  # caller must retry with bigger capacity


def _native_keys(codes_u8, run_lens, mask, window, salt, scale):
    """Native C++ scalar sketch as (count, 4) uint32 key lanes."""
    ref = native.sketch_codes(codes_u8, np.asarray(run_lens, np.int64),
                              mask.lo, mask.hi, window, salt, scale,
                              legacy=False)
    out = np.empty((ref.shape[0], 4), np.uint32)
    for q in range(4):
        out[:, q] = (ref[:, q // 2] >> np.uint64(32 * (q % 2))).astype(
            np.uint32)
    return out


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
@pytest.mark.parametrize("window,k", [(10, 10), (16, 12), (20, 16),
                                      (33, 20), (50, 30), (64, 40)])
def test_kw_finish_matches_xla_path(window, k):
    """The batched sketch step (sketch_batch, a vmap of sketch_core) is
    bit-identical to the per-genome jitted step and to the native C++
    scalar oracle at every key-word geometry (1 to 4 live words),
    including the all-ones sentinel tail."""
    from spaced_kmer_sketching_tpu.ops.sketch import sketch_batch

    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    rng = np.random.default_rng(window)
    g, n, cap, scale = 3, 4096, 1024, 20
    codes = rng.integers(0, 4, (g, n)).astype(np.uint32)
    run_id = np.stack([run_ids_from_lens([n], n)] * g)
    out = sketch_batch(
        jnp.asarray(codes), jnp.asarray(run_id), jnp.asarray(mask.words_u32),
        window=window, salt=salt, scale=scale, variant="modern", capacity=cap)
    keys, counts = np.asarray(out.keys), np.asarray(out.count)
    for i in range(g):
        one = sketch_from_codes(
            jnp.asarray(codes[i]), jnp.asarray(run_id[i]),
            jnp.asarray(mask.words_u32), window=window, salt=salt,
            scale=scale, variant="modern", capacity=cap)
        np.testing.assert_array_equal(keys[i], np.asarray(one.keys))
        want = _native_keys(codes[i].astype(np.uint8), [n], mask, window,
                            salt, scale)
        assert counts[i] == want.shape[0]
        np.testing.assert_array_equal(keys[i, :counts[i]], want)
        assert np.all(keys[i, counts[i]:] == 0xFFFFFFFF)


def test_sketcher_multiseed_matches_per_seed():
    """FracMinHashSketcher.sketch_packed_multiseed (the user-facing fused
    multi-seed entry, BASELINE config 3) is bit-identical to sketching
    each seed mask separately, including the overflow retry."""
    import numpy as np
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

    cfg = SketchConfig(window=14, k=9, scale=5)
    rng = np.random.default_rng(41)
    packed = PackedSeqs(codes=rng.integers(0, 4, 30000).astype(np.uint8),
                        run_lens=np.array([12000, 18000], np.int64))
    sk = FracMinHashSketcher(cfg)
    fused = sk.sketch_packed_multiseed(packed, seeds=range(3))
    assert len(fused) == 3
    for seed, got in zip(range(3), fused):
        mask = spaced_seed_mask(cfg.window, cfg.k, seed)
        assert got.mask == mask
        want = FracMinHashSketcher(cfg, mask=mask).sketch_packed(packed)
        assert got.count == want.count
        np.testing.assert_array_equal(got.keys, want.keys)

    # window-mismatched mask is rejected
    import pytest
    bad = spaced_seed_mask(20, 9, 0)
    with pytest.raises(ValueError):
        sk.sketch_packed_multiseed(packed, masks=[bad])

    # empty genome: one empty sketch per seed
    empty = PackedSeqs(codes=np.empty(0, np.uint8),
                       run_lens=np.empty(0, np.int64))
    outs = sk.sketch_packed_multiseed(empty, seeds=range(2))
    assert [s.count for s in outs] == [0, 0]


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
@pytest.mark.parametrize("window,k", [(10, 10), (20, 16), (31, 21),
                                      (40, 30), (50, 40), (64, 40)])
def test_dynwin_shared_program_matches_static(window, k):
    """Each reference-sweep config runs its own static program through
    FracMinHashSketcher.sketch_packed_batch, bit-identical to the native
    oracle on multi-run genomes — window validity near run ends comes
    from the run-id compare; repeated calls of a config reuse one cached
    jitted program."""
    from spaced_kmer_sketching_tpu.config import SketchConfig
    from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs
    from spaced_kmer_sketching_tpu.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu.ops.sketch import jitted_sketch_batch

    cfg = SketchConfig(window=window, k=k, scale=20)
    sk = FracMinHashSketcher(cfg)
    rng = np.random.default_rng(window)
    lens = [1500, 900, 1696]
    packed = [PackedSeqs(codes=rng.integers(0, 4, sum(lens)).astype(np.uint8),
                         run_lens=np.array(lens, np.int64)) for _ in range(3)]
    got = sk.sketch_packed_batch(packed)
    for pk, sketch in zip(packed, got):
        want = _native_keys(pk.codes, pk.run_lens, sk.mask, window, sk.salt,
                            cfg.scale)
        assert sketch.count == want.shape[0]
        np.testing.assert_array_equal(sketch.keys, want)
    cap = cfg.capacity_for(packed[0].total_windows(window))
    fn = jitted_sketch_batch(window, sk.salt, cfg.scale, "modern", cap)
    assert fn is jitted_sketch_batch(window, sk.salt, cfg.scale, "modern",
                                     cap)
