"""Windowed spaced-seed k-mer extraction — vectorized JAX reference path.

Reimplements the reference's per-nucleotide sliding loop
(src/kmer_sliding.cpp:112-186) as data-parallel window construction: every
output window is an independent weighted sum of 2-bit codes, so the serial
shift-register recurrence disappears entirely.

Semantics preserved exactly:
  * forward window F(i)  = sum_j codes[i + w-1-j] << 2j      (newest at bits 0-1)
  * revcomp window R(i)  = sum_j (3 - codes[i + j]) << 2j    (newest at top)
  * both strands masked with the SAME un-reversed mask
    (src/kmer_sliding.cpp:159-160 — deliberate; do not "fix")
  * canonical = forward iff masked_fwd < masked_rc numerically, else revcomp
    (strictly-less picks forward; src/kmer_sliding.cpp:164-175)
  * windows shorter than `window` per ACGT run produce nothing
    (src/kmer_sliding.cpp:121-125) — enforced here via run-id equality.

Keys are 128-bit values as 4 x uint32 little-endian lanes.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

KEY_WORDS = 4


def run_ids_from_lens(run_lens, total: int):
    """Host helper: per-position run id (int32), padding positions get -1."""
    import numpy as np
    rid = np.full(total, -1, dtype=np.int32)
    pos = 0
    for i, n in enumerate(np.asarray(run_lens)):
        rid[pos:pos + int(n)] = i
        pos += int(n)
    return rid


def unpack_2bit(p):
    """Device inverse of utils/native.pack2bit: p (..., m) uint32 words of 16
    2-bit codes each, LSB-first -> (..., 16*m) uint32 codes."""
    shifts = 2 * lax.broadcasted_iota(jnp.uint32, (16,), 0)
    codes = (p[..., None] >> shifts) & jnp.uint32(3)
    return codes.reshape(p.shape[:-1] + (16 * p.shape[-1],))


def run_ids_from_bounds(pos, bounds, rid0, valid_len):
    """Per-position run ids of a compact upload: pos (..., n) int32 absolute
    positions, bounds (..., K) int32 sorted interior run starts (padding
    entries at or past the end never trigger), rid0 (...) int32 id of the
    run open at position 0, valid_len (...) int32 real code count.
    Positions at or past valid_len get -1."""
    r = rid0[..., None].astype(jnp.int32)
    for k in range(bounds.shape[-1]):
        r = r + (pos >= bounds[..., k:k + 1]).astype(jnp.int32)
    return jnp.where(pos < valid_len[..., None], r, jnp.int32(-1))


def extract_windows(codes, run_id, window: int, mask_words) -> Tuple[tuple, jnp.ndarray]:
    """Extract canonical masked keys for every window start position.

    Args:
      codes:   (n,) uint32 in 0..3 (padding arbitrary), n static.
      run_id:  (n,) int32, -1 on padding; a window is valid iff its first and
               last positions share a non-negative run id.
      window:  static window length w.
      mask_words: (4,) uint32 mask lanes (static per jit via closure or array).

    Returns:
      (w0, w1, w2, w3): each (n-w+1,) uint32 canonical masked key lanes.
      valid: (n-w+1,) bool.
    """
    n = codes.shape[0]
    nw = n - window + 1
    codes = codes.astype(jnp.uint32)

    fw = [jnp.zeros((nw,), jnp.uint32) for _ in range(KEY_WORDS)]
    rw = [jnp.zeros((nw,), jnp.uint32) for _ in range(KEY_WORDS)]
    for j in range(window):
        q, r = divmod(2 * j, 32)
        cf = lax.dynamic_slice(codes, (window - 1 - j,), (nw,))
        cr = jnp.asarray(3, jnp.uint32) - lax.dynamic_slice(codes, (j,), (nw,))
        fw[q] = fw[q] | (cf << r)
        rw[q] = rw[q] | (cr << r)

    mf = [fw[q] & mask_words[q] for q in range(KEY_WORDS)]
    mr = [rw[q] & mask_words[q] for q in range(KEY_WORDS)]

    fwd_lt = lex_lt_128(mf, mr)
    canon = tuple(jnp.where(fwd_lt, mf[q], mr[q]) for q in range(KEY_WORDS))

    rid_a = lax.dynamic_slice(run_id, (0,), (nw,))
    rid_b = lax.dynamic_slice(run_id, (window - 1,), (nw,))
    valid = (rid_a == rid_b) & (rid_a >= 0)
    return canon, valid


def lex_lt_128(a, b):
    """a < b as 128-bit integers, given 4-lane little-endian word lists."""
    lt = a[0] < b[0]
    for q in range(1, KEY_WORDS):
        lt = (a[q] < b[q]) | ((a[q] == b[q]) & lt)
    return lt
