"""Multi-host bring-up: jax.distributed + a global mesh.

The reference has no distributed layer (single process, OpenCilk threads —
SURVEY.md §5); this is the scale-out path for BASELINE config 4 (10k-genome
all-pairs over many devices):

  * every process calls `init_distributed()` (coordinator from explicit
    args or the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID environment), then `global_mesh()` builds the 2-D
    ("r", "c") mesh over ALL devices in the job;
  * the sharded entry points in parallel/ are mesh-agnostic — the same
    shard_map programs run on the devices of one host under one process
    (tests force 8 virtual CPU devices) or across processes, with XLA
    inserting the all-pairs resharding collectives;
  * sketches checkpoint per host via store.SketchStore, so an elastic
    restart resumes from saved sketches (the reference loses everything).

Multi-process execution is validated on the CPU by
tests/test_distributed_multiprocess.py.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax

from .mesh import make_mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the jax.distributed runtime (idempotent).

    The coordinator comes from the arguments or from
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.  With
    neither, the job is one process and nothing is initialized: no
    cluster auto-detection runs."""
    if getattr(init_distributed, "_done", False):
        return
    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"])
    # initialize() must run BEFORE any backend-querying API (process_count,
    # devices, ...): touching a backend first initializes JAX single-process
    # and initialize() then always fails, silently degrading a multi-process
    # run.
    if kwargs:
        try:
            jax.distributed.initialize(**kwargs)
        except (RuntimeError, ValueError) as e:
            if "already" not in str(e).lower():
                raise  # idempotent re-init is fine; surface other failures
    init_distributed._done = True


def global_mesh(shape: Optional[Tuple[int, int]] = None):
    """2-D ("r", "c") mesh over every device in the (possibly multi-host)
    job.  Across hosts, prefer shapes whose "c" axis stays within one host
    so the all-pairs column gathers stay on the host's own links."""
    return make_mesh(shape=shape, devices=jax.devices())


def process_shard(n_items: int) -> slice:
    """This host's contiguous shard of n_items (coarse host-level work
    splitting).  For ingest feeding a SHARDED device batch use
    local_batch_rows instead — the rows a host must parse are the rows its
    own devices hold under the actual sharding, which a contiguous
    ceil-division split does not reproduce (e.g. 5 genomes, 2 hosts x 4
    devices: the padded batch puts rows 0-3 on host 0, but the ceil split
    hands row 3 to host 1 — the row would be ingested by nobody that
    places it)."""
    p, np_ = jax.process_index(), jax.process_count()
    per = (n_items + np_ - 1) // np_
    return slice(p * per, min(n_items, (p + 1) * per))


def local_batch_rows(mesh, spec, n_items: int, pad_multiple: int):
    """Indices in [0, n_items) of the leading-axis rows that THIS process's
    devices hold when an (n_items padded to pad_multiple)-row batch is
    sharded with `spec` over `mesh` — per-host FASTA ingest parses exactly
    these (SURVEY.md §2.1 genome-level data parallelism)."""
    from jax.sharding import NamedSharding

    n_pad = ((n_items + pad_multiple - 1) // pad_multiple) * pad_multiple
    sharding = NamedSharding(mesh, spec)
    me = jax.process_index()
    local = set()
    for dev, idx in sharding.devices_indices_map((n_pad,)).items():
        if dev.process_index != me:
            continue
        local.update(range(*idx[0].indices(n_pad)))
    return {i for i in local if i < n_items}
