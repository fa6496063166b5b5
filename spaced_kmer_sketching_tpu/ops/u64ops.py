"""64-bit integer arithmetic as pairs of uint32 lanes, in JAX.

The boost-compatible FracMinHash (utils/boosthash.py documents the exact
algorithms) is implemented here over (hi, lo) uint32 pairs, so it runs
under JAX's default 32-bit mode on every backend without enabling x64.

A u64 is a tuple (hi, lo) of equal-shaped uint32 arrays.
"""
from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32

# boost constants (see utils/boosthash.py)
GOLDEN32 = 0x9E3779B9
MIX_M = (0x0E9846AF, 0x9B1A615D)      # boost>=1.81 hash_mix multiplier (hi, lo)
LEGACY_M = (0xC6A4A793, 0x5BD1E995)   # boost<1.81 murmur multiplier
LEGACY_ADD = 0xE6546B64


def _u32c(x):
    """Coerce python-int halves to uint32 (avoids int32 weak-type overflow)."""
    return jnp.asarray(x, U32) if isinstance(x, int) else x


def _pair(a):
    return _u32c(a[0]), _u32c(a[1])


def const64(value: int, like=None):
    hi = jnp.asarray((value >> 32) & 0xFFFFFFFF, U32)
    lo = jnp.asarray(value & 0xFFFFFFFF, U32)
    if like is not None:
        hi = jnp.broadcast_to(hi, like.shape)
        lo = jnp.broadcast_to(lo, like.shape)
    return hi, lo


def add64(a, b):
    ah, al = _pair(a)
    bh, bl = _pair(b)
    lo = al + bl
    carry = (lo < al).astype(U32)
    return ah + bh + carry, lo


def xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def shr64(a, r: int):
    """Logical right shift by a static amount 0 < r < 64."""
    ah, al = a
    if r >= 32:
        return jnp.zeros_like(ah), ah >> (r - 32) if r > 32 else ah
    return ah >> r, (al >> r) | (ah << (32 - r))


def mul32_full(a, b):
    """Full 64-bit product of two uint32 arrays -> (hi, lo)."""
    m16 = jnp.asarray(0xFFFF, U32)
    aL, aH = a & m16, a >> 16
    bL, bH = b & m16, b >> 16
    ll = aL * bL
    lh = aL * bH
    hl = aH * bL
    hh = aH * bH
    mid = (ll >> 16) + (lh & m16) + (hl & m16)
    lo = (ll & m16) | (mid << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def mul64(a, b):
    """Low 64 bits of a 64x64 product."""
    ah, al = _pair(a)
    bh, bl = _pair(b)
    hi, lo = mul32_full(al, bl)
    hi = hi + al * bh + ah * bl
    return hi, lo


def hash_mix64(x):
    """boost>=1.81 hash_detail::hash_mix over (hi, lo) uint32 pairs."""
    h, l = x
    l = l ^ h                      # x ^= x >> 32
    h, l = mul64((h, l), MIX_M)
    l = l ^ h                      # x ^= x >> 32
    h, l = mul64((h, l), MIX_M)
    # x ^= x >> 28
    h2 = h >> 28
    l2 = (l >> 28) | (h << 4)
    return h ^ h2, l ^ l2


def combine_modern(seed, value):
    c = const64(GOLDEN32)
    return hash_mix64(add64(add64(seed, c), value))


def combine_legacy(h, k):
    k = mul64(k, LEGACY_M)
    k = xor64(k, (jnp.zeros_like(k[0]), k[0] >> 15))  # k ^= k >> 47
    k = mul64(k, LEGACY_M)
    h = xor64(h, k)
    h = mul64(h, LEGACY_M)
    return add64(h, const64(LEGACY_ADD))


def hash_bitset128(w0, w1, w2, w3, variant: str = "modern"):
    """boost::hash_value of a 128-bit dynamic_bitset given 4 uint32 lanes
    (little-endian: w0 = bits 0..31).  Returns a (hi, lo) uint64 pair."""
    lo64 = (w1, w0)
    hi64 = (w3, w2)
    zero = (jnp.zeros_like(w0), jnp.zeros_like(w0))
    size = const64(128)
    if variant == "modern":
        inner = combine_modern(combine_modern(zero, lo64), hi64)
        return combine_modern(size, inner)
    inner = combine_legacy(combine_legacy(zero, lo64), hi64)
    return combine_legacy(size, inner)


def mod_small(x, m: int):
    """(hi,lo) uint64 mod a small static modulus m (< 2**16)."""
    h, l = x
    pow32 = (1 << 32) % m
    return ((h % m) * jnp.asarray(pow32, U32) + (l % m)) % jnp.asarray(m, U32)


def fmh_keep(w0, w1, w2, w3, salt, scale: int, variant: str = "modern"):
    """FracMinHash keep decision per key: (H(key) ^ salt) % scale == 0.

    salt = H(mask) ^ window ^ nonce, precomputed on host
    (src/kmer.hpp:144-148, src/kmer-sketching.cpp:31-33).  May be a static
    python int or a traced (hi, lo) uint32 pair (multi-seed vmap path).
    """
    h = hash_bitset128(w0, w1, w2, w3, variant)
    if isinstance(salt, int):
        h = xor64(h, const64(salt, like=w0))
    else:
        sh, sl = salt
        h = xor64(h, (jnp.broadcast_to(sh, w0.shape),
                      jnp.broadcast_to(sl, w0.shape)))
    return mod_small(h, scale) == 0


def salt_pair(salt: int):
    """Split a host-computed 64-bit salt into a (2,) uint32 [hi, lo] array."""
    import numpy as np
    return np.array([(salt >> 32) & 0xFFFFFFFF, salt & 0xFFFFFFFF],
                    dtype=np.uint32)
