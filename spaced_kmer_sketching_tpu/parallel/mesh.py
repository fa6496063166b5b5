"""Device-mesh construction for the sharded sketching / ANI paths.

The reference scales with OpenCilk work-stealing threads in one address
space (src/kmer_set.cpp:124,179).  The JAX equivalent is an explicit
2-D `jax.sharding.Mesh`:

  * axis "r" x "c" — the all-pairs intersection matrix is tiled over the
    full mesh (rows sharded over "r", columns over "c");
  * the flattened ("r", "c") axes together act as the genome data-parallel
    axis for sketching, and as the ring for sequence-parallel halo exchange.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "r"
COL_AXIS = "c"


def _factor2d(n: int) -> Tuple[int, int]:
    """Squarest (r, c) with r * c == n."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A 2-D ("r", "c") mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = _factor2d(len(devices))
    r, c = shape
    if r * c != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(np.asarray(devices).reshape(r, c), (ROW_AXIS, COL_AXIS))


def data_spec() -> P:
    """PartitionSpec sharding a leading genome axis over the whole mesh."""
    return P((ROW_AXIS, COL_AXIS))


def replicated(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
