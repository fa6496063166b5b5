"""The portable sketch step (ops/sketch.py) across window geometries, the
compact 2-bit upload, chunked compaction and multi-seed, each checked
against the native C++ scalar oracle or the plain per-genome step."""
import numpy as np
import pytest

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops import sketch as sk_ops
from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
from spaced_kmer_sketching_tpu.utils import boosthash, native
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native lib unavailable")


def _mask_salt(window, k, seed=0):
    mask = spaced_seed_mask(window, k, seed)
    return mask, boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")


def _native_lanes(codes_u8, run_lens, mask, window, salt, scale):
    """Native sketch as (count, 4) uint32 little-endian key lanes."""
    ref = native.sketch_codes(codes_u8, np.asarray(run_lens, np.int64),
                              mask.lo, mask.hi, window, salt, scale,
                              legacy=False)
    out = np.empty((ref.shape[0], 4), np.uint32)
    for q in range(4):
        out[:, q] = (ref[:, q // 2] >> np.uint64(32 * (q % 2))).astype(
            np.uint32)
    return out


def _pack_np(codes_u8, body):
    c = np.zeros(body, np.uint32)
    c[:codes_u8.size] = codes_u8
    shifts = 2 * np.arange(16, dtype=np.uint32)
    return np.bitwise_or.reduce(c.reshape(-1, 16) << shifts, axis=1)


@needs_native
@pytest.mark.parametrize("window,k", [(2, 2), (15, 9), (16, 16), (17, 10),
                                      (32, 20), (33, 21), (48, 30),
                                      (64, 40), (64, 64)])
def test_sketch_batch_window_sweep(window, k):
    """Window construction across word-boundary edge cases: window
    multiples of 16, odd widths, 3- and 4-word keys and the 64-nt
    maximum, on a multi-run genome with a short middle run."""
    mask, salt = _mask_salt(window, k)
    runs = [1000, 96, 3000]
    n = sum(runs) + 64
    rng = np.random.default_rng(window * 7 + k)
    codes = np.zeros(n, np.uint8)
    codes[:sum(runs)] = rng.integers(0, 4, sum(runs))
    rid = run_ids_from_lens(runs, n)
    out = sk_ops.sketch_batch(
        jnp.asarray(codes.astype(np.uint32))[None], jnp.asarray(rid)[None],
        jnp.asarray(mask.words_u32), window=window, salt=salt, scale=3,
        variant="modern", capacity=4096)
    assert int(out.raw_kept[0]) <= 4096
    want = _native_lanes(codes[:sum(runs)], runs, mask, window, salt, 3)
    c = int(out.count[0])
    assert c == want.shape[0]
    np.testing.assert_array_equal(np.asarray(out.keys[0, :c]), want)


@needs_native
@pytest.mark.parametrize("window,k", [(10, 10), (17, 10), (32, 20),
                                      (33, 21), (48, 30), (64, 40)])
def test_sketch_batch_compact_window_sweep(window, k):
    """The compact upload (2-bit planes + run starts, expanded on device)
    is bit-identical to the full-plane sketch_batch and to the native
    oracle, across word-boundary windows."""
    mask, salt = _mask_salt(window, k)
    rng = np.random.default_rng(window * 101 + k)
    n, scale, cap = 30000, 20, 4096
    codes = rng.integers(0, 4, n).astype(np.uint8)
    runs = [n // 3, n - n // 3]
    body = sk_ops.packed_body(n)
    p = _pack_np(codes, body)[None]
    b = np.full((1, 64), body, np.int32)
    b[0, 0] = n // 3
    mw = jnp.asarray(mask.words_u32)
    got = sk_ops.sketch_batch_compact(
        jnp.asarray(p), jnp.asarray(b), jnp.asarray(np.array([0], np.int32)),
        jnp.asarray(np.array([n], np.int32)), mw, n=n, window=window,
        salt=salt, scale=scale, variant="modern", capacity=cap)
    full = sk_ops.sketch_batch(
        jnp.asarray(codes.astype(np.uint32))[None],
        jnp.asarray(run_ids_from_lens(runs, n))[None], mw, window=window,
        salt=salt, scale=scale, variant="modern", capacity=cap)
    np.testing.assert_array_equal(np.asarray(got.count),
                                  np.asarray(full.count))
    np.testing.assert_array_equal(np.asarray(got.keys), np.asarray(full.keys))
    want = _native_lanes(codes, runs, mask, window, salt, scale)
    c = int(got.count[0])
    assert c == want.shape[0]
    np.testing.assert_array_equal(np.asarray(got.keys[0, :c]), want)


def test_sketch_batch_compact_run_bounds():
    """Compact uploads with a non-zero first run id (streaming segments
    carry the open run) and two interior run starts match the full-plane
    step exactly, raw_kept included."""
    window, k, scale, cap = 20, 16, 200, 1024
    mask, salt = _mask_salt(window, k)
    rng = np.random.default_rng(9)
    n = 70000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    rid0, starts = 5, np.array([2000, 39999])
    rid = np.full(n, rid0, np.int32)
    for s in starts:
        rid[s:] += 1
    body = sk_ops.packed_body(n)
    b = np.full((1, 8), body, np.int32)
    b[0, :starts.size] = starts
    mw = jnp.asarray(mask.words_u32)
    got = sk_ops.sketch_batch_compact(
        jnp.asarray(native.pack2bit(codes, body // 16)[None]), jnp.asarray(b),
        jnp.asarray(np.array([rid0], np.int32)),
        jnp.asarray(np.array([n], np.int32)), mw, n=n, window=window,
        salt=salt, scale=scale, variant="modern", capacity=cap)
    want = sk_ops.sketch_batch(
        jnp.asarray(codes.astype(np.uint32))[None], jnp.asarray(rid)[None],
        mw, window=window, salt=salt, scale=scale, variant="modern",
        capacity=cap)
    np.testing.assert_array_equal(np.asarray(got.count),
                                  np.asarray(want.count))
    np.testing.assert_array_equal(np.asarray(got.keys), np.asarray(want.keys))
    # raw_kept counts kept windows, which only depends on the real codes
    np.testing.assert_array_equal(np.asarray(got.raw_kept),
                                  np.asarray(want.raw_kept))


def test_sketch_batch_compact_bounds_padding_independent():
    """The bounds array's pad width (K) never changes the result: padding
    entries equal to the body length never trigger."""
    window, k, scale, cap = 18, 12, 10, 1024
    mask, salt = _mask_salt(window, k)
    rng = np.random.default_rng(3)
    n = 9000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    body = sk_ops.packed_body(n)
    p = jnp.asarray(_pack_np(codes, body)[None])
    outs = []
    for kpad in (1, 8, 64):
        b = np.full((1, kpad), body, np.int32)
        b[0, 0] = 4321
        outs.append(sk_ops.sketch_batch_compact(
            p, jnp.asarray(b), jnp.asarray(np.array([3], np.int32)),
            jnp.asarray(np.array([n], np.int32)),
            jnp.asarray(mask.words_u32), n=n, window=window, salt=salt,
            scale=scale, variant="modern", capacity=cap))
    for o in outs[1:]:
        np.testing.assert_array_equal(np.asarray(o.keys),
                                      np.asarray(outs[0].keys))
        np.testing.assert_array_equal(np.asarray(o.raw_kept),
                                      np.asarray(outs[0].raw_kept))


@pytest.mark.parametrize("n,capacity", [(70000, 1024), (200000, 4096)])
def test_compact_chunked_exact_survivors(n, capacity):
    """Chunked top_k compaction returns exactly the kept positions when no
    chunk exceeds its share, and raw_kept is the true kept count."""
    rng = np.random.default_rng(n)
    keep = rng.random(n) < (capacity / 4) / n
    src, slot_valid, raw_kept = sk_ops._compact_chunked(jnp.asarray(keep),
                                                        capacity)
    src, slot_valid = np.asarray(src), np.asarray(slot_valid)
    assert int(raw_kept) == int(keep.sum())
    np.testing.assert_array_equal(np.sort(src[slot_valid]),
                                  np.flatnonzero(keep))


def test_compact_chunked_overflow_reports_true_count():
    """A chunk holding more kept windows than its capacity share (here
    every window of the first chunk) pushes raw_kept past the capacity,
    so the caller retries at a larger capacity."""
    n, capacity = 1 << 18, 1024
    keep = np.zeros(n, bool)
    keep[:2000] = True                  # far over one chunk's share
    _, _, raw_kept = sk_ops._compact_chunked(jnp.asarray(keep), capacity)
    assert int(raw_kept) > capacity


def test_multiseed_matches_per_seed_step():
    """sketch_from_codes_multiseed (vmap over (mask, salt) pairs) equals
    the single-seed jitted step for every seed."""
    from spaced_kmer_sketching_tpu.ops import u64ops

    window, k, scale, cap = 20, 16, 20, 2048
    seeds = range(3)
    masks = [spaced_seed_mask(window, k, s) for s in seeds]
    salts = [boosthash.fmh_salt(m.lo, m.hi, window, 1, "modern")
             for m in masks]
    rng = np.random.default_rng(11)
    n = 12000
    codes = jnp.asarray(rng.integers(0, 4, n).astype(np.uint32))
    rid = jnp.asarray(run_ids_from_lens([n // 2, n - n // 2], n))
    out = sk_ops.sketch_from_codes_multiseed(
        codes, rid, jnp.asarray(np.stack([m.words_u32 for m in masks])),
        jnp.asarray(np.stack([u64ops.salt_pair(x) for x in salts])),
        window=window, scale=scale, variant="modern", capacity=cap)
    for i, (m, salt) in enumerate(zip(masks, salts)):
        one = sk_ops.sketch_from_codes(
            codes, rid, jnp.asarray(m.words_u32), window=window, salt=salt,
            scale=scale, variant="modern", capacity=cap)
        np.testing.assert_array_equal(np.asarray(out.keys[i]),
                                      np.asarray(one.keys))
        assert int(out.count[i]) == int(one.count)


def test_jitted_compact_program_cache():
    """One jitted compact program per static config: repeated dispatches
    of a config reuse it, a new capacity gets its own."""
    a = sk_ops.jitted_sketch_batch_compact(4096, 20, 7, 20, "modern", 1024)
    assert a is sk_ops.jitted_sketch_batch_compact(4096, 20, 7, 20,
                                                   "modern", 1024)
    assert a is not sk_ops.jitted_sketch_batch_compact(4096, 20, 7, 20,
                                                       "modern", 2048)
