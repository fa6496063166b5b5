"""Configuration for the spaced k-mer sketching framework.

The reference (bensonlzl/spaced-kmer-sketching) hard-codes all of these as
compile-time constants / literals:
  - 128-bit k-mer windows -> 64 nt max  (src/kmer.hpp:37,52-54)
  - FracMinHash scale c=200, nonce=1    (src/kmer-sketching.cpp:29-33)
  - mask RNG seed 0                     (src/kmer.hpp:64)
Here they are one frozen dataclass, defaulting to the reference's values.
"""
from __future__ import annotations

import dataclasses
import math

# --- Fixed geometry (mirrors src/kmer.hpp:37-54) -------------------------------
NUCLEOTIDE_BIT_SIZE = 2
KMER_BITSET_SIZE = 128            # bits per k-mer key
MAX_KMER_LENGTH = KMER_BITSET_SIZE // NUCLEOTIDE_BIT_SIZE  # 64 nt
KEY_WORDS = KMER_BITSET_SIZE // 32                          # 4 x uint32 lanes

# Default FracMinHash parameters (src/kmer-sketching.cpp:29-33)
DEFAULT_SCALE = 200
DEFAULT_NONCE = 1
DEFAULT_MASK_SEED = 0


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """One (window, k) sketching experiment configuration.

    Attributes:
      window:   total span of the spaced seed, in nucleotides (<= 64).
      k:        number of *care* positions in the spaced seed.
      mask_seed: RNG seed for the spaced-seed mask (reference default 0).
      scale:    FracMinHash keep-modulus c; a k-mer is kept iff hash % c == 0
                (reference hard-codes 200, src/kmer-sketching.cpp:31-33).
      nonce:    FracMinHash salt (reference hard-codes 1).
      hash_variant: 'modern' = boost >= 1.81 container_hash (hash_mix chain),
                'legacy' = boost < 1.81 (murmur-style hash_combine).  The
                reference's numeric output depends on which boost it was
                compiled against; both are supported bit-exactly.
      sketch_capacity: static per-genome sketch buffer size (padded with
                sentinel keys).  Auto-sized when 0.
    """
    window: int = 10
    k: int = 10
    mask_seed: int = DEFAULT_MASK_SEED
    scale: int = DEFAULT_SCALE
    nonce: int = DEFAULT_NONCE
    hash_variant: str = "modern"
    sketch_capacity: int = 0

    def __post_init__(self):
        if self.window > MAX_KMER_LENGTH:
            # mirrors the reference's width check (src/kmer_bitset.cpp:53-54)
            raise ValueError(
                f"window {self.window} exceeds maximum k-mer length {MAX_KMER_LENGTH}")
        if not (0 < self.k <= self.window):
            raise ValueError(f"need 0 < k <= window, got k={self.k} window={self.window}")
        if self.hash_variant not in ("modern", "legacy"):
            raise ValueError(f"unknown hash_variant {self.hash_variant!r}")
        if self.sketch_capacity and (
                self.sketch_capacity < 256
                or self.sketch_capacity & (self.sketch_capacity - 1)):
            # the device sketch/intersection kernels assume power-of-two
            # buffers; fail here instead of deep inside jit tracing
            raise ValueError(
                "sketch_capacity must be 0 (auto) or a power of two >= 256, "
                f"got {self.sketch_capacity}")

    def capacity_for(self, total_windows: int) -> int:
        """Static sketch buffer size for a genome with `total_windows` windows.

        FracMinHash keeps ~1/scale of windows; pad 2x + slack and round to a
        power of two so XLA sees few distinct shapes across genomes.
        """
        if self.sketch_capacity:
            return self.sketch_capacity
        expect = max(1, total_windows // self.scale)
        cap = 1 << max(8, math.ceil(math.log2(expect * 2 + 256)))
        return cap
