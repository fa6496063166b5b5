"""The compact 2-bit upload: host packing (native and numpy) and the device
unpack of codes and run ids, at word and run boundaries."""
import numpy as np
import pytest

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops.extract import (run_ids_from_bounds,
                                                   run_ids_from_lens,
                                                   unpack_2bit)
from spaced_kmer_sketching_tpu.ops.sketch import packed_body
from spaced_kmer_sketching_tpu.utils import native


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000])
def test_unpack_2bit_roundtrip(n):
    """unpack_2bit inverts pack2bit; positions past n unpack as code 0."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    body = packed_body(n)
    p = native.pack2bit(codes, body // 16)
    got = np.asarray(unpack_2bit(jnp.asarray(p)))
    assert got.shape == (body,)
    np.testing.assert_array_equal(got[:n], codes)
    assert not got[n:].any()


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
@pytest.mark.parametrize("n,words", [(33, 3), (1000, 63), (40, 2)])
def test_pack2bit_numpy_matches_native(n, words, monkeypatch):
    """The numpy fallback packs exactly like the C++ packer, including
    inputs longer and shorter than the word budget."""
    rng = np.random.default_rng(n + words)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    want = native.pack2bit(codes, words)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(native.pack2bit(codes, words), want)


@pytest.mark.parametrize("run_lens,rid0", [
    ([16, 16, 8], 0),          # run starts on word boundaries
    ([15, 2, 23], 0),          # starts one before / after a boundary
    ([1, 39], 0),              # a one-code first run
    ([39, 1], 0),              # a one-code last run
    ([10, 30], 7),             # the open run continues from a segment
    ([40], 3),                 # no interior starts at all
])
def test_run_ids_from_bounds_at_boundaries(run_lens, rid0):
    """Run ids derived from (bounds, rid0, valid_len) equal the host
    per-position expansion, with -1 past the real codes."""
    n = sum(run_lens)
    body = packed_body(n + 10)
    starts = np.cumsum(run_lens)[:-1]
    bounds = np.full(8, body, np.int32)
    bounds[:starts.size] = starts
    pos = jnp.arange(body, dtype=jnp.int32)
    got = np.asarray(run_ids_from_bounds(
        pos[None], jnp.asarray(bounds)[None],
        jnp.asarray(np.array([rid0], np.int32)),
        jnp.asarray(np.array([n], np.int32))))[0]
    want = run_ids_from_lens(run_lens, body)
    want = np.where(want >= 0, want + rid0, -1)
    np.testing.assert_array_equal(got, want)


def test_packed_body():
    """A compact upload covers the genome in whole 16-code words."""
    assert packed_body(1) == 16
    assert packed_body(16) == 16
    assert packed_body(17) == 32
    assert all(packed_body(n) % 16 == 0 and packed_body(n) >= n
               for n in range(1, 200))
