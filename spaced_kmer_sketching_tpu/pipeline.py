"""Device-resident end-to-end pipeline: genomes -> sketches BORN ON DEVICE
-> per-block presorted (key, gid) caches -> batched macro-tiles -> (G, G)
intersections -> ANI.

The two-step flow re-uploads a sketch slab the device has just computed:
`FracMinHashSketcher.sketch_files` downloads every sketch to numpy and
`parallel.allpairs.blocked_all_pairs` re-packs and re-uploads them as a
slab.  Here the sketch step's device keys
feed `ops.gram.presort_block_packed` directly — the only bytes crossing the
host boundary are the compact 2-bit genome uploads (ingest), per-genome
count scalars, and the int16 result tiles.  Mirrors the reference's
one-flow experiment (sketch all files -> all-pairs intersections -> ANI,
src/kmer-sketching.cpp:151-212) at production scale; the store-backed /
already-downloaded-sketch cases keep the blocked_all_pairs slab path.

Flow per 128-genome block (double-buffered: host ingest of dispatch k+1
overlaps device sketching of dispatch k; each block presorts as soon as
its dispatches complete, so raw dispatch keys park at O(lookahead *
block * capacity) device memory, not O(G * capacity)):

    ingest (parse -> 2-bit pack, native C++)        [host]
    -> compact upload (~0.25 B/nt)                   [host -> device]
    -> unpack + extract + FracMinHash + sort-unique  [device]
    -> slice live key words, stack 128 genomes       [device]
    -> presort_block_packed (packed (key, gid))      [device, per block]
    -> gram_pair_tiles macro-tile batches            [device]
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .ingest.fasta import PackedSeqs, read_fasta
from .models.fracminhash import FracMinHashSketcher
from .observability import get_logger, span
from .utils import native

log = get_logger(__name__)

_SENT = np.uint32(0xFFFFFFFF)


def _tile_binner(block: int) -> int:
    """Chunks per tile-scan step: more chunks amortize XLA scan-step
    overhead, while the (binner, 128, 2*block) one-hot temporaries grow
    with it.  SKS_TILE_BINNER overrides."""
    import os
    return int(os.environ.get("SKS_TILE_BINNER",
                              "256" if block <= 256 else "32"))


@dataclasses.dataclass
class PipelineResult:
    """(G, G) intersection matrix + everything needed for ANI/verification."""
    inter: np.ndarray            # (G, G) int32 |A_i ∩ A_j|
    counts: np.ndarray           # (G,) int32 sketch sizes (ANI denominators)
    phases: Dict[str, float]     # seconds per phase (wall; phases overlap)
    bytes_h2d: int               # host->device payload bytes (ingest + idx)
    bytes_d2h: int               # device->host payload bytes (tiles, counts)
    sample_keys: Dict[int, np.ndarray]   # gid -> (count, 2) u64 sketch keys
    cache_cap: int = 0           # presort cache width (keys per genome)


class _CapacityOverflow(Exception):
    def __init__(self, capacity: int):
        self.capacity = capacity


# --- genome sources ---------------------------------------------------------
#
# A source is `load(s0, s1) -> list[PackedSeqs] | _DevicePlanes` for genome
# ids [s0, s1).  PackedSeqs batches are packed host-side (native 2-bit) and
# shipped compact; _DevicePlanes carries already-on-device packed planes
# (e.g. synthesized by the device RNG) so ingest crosses zero host bytes.

@dataclasses.dataclass
class _DevicePlanes:
    p: jnp.ndarray               # (g, body/16) uint32 2-bit packed codes
    bounds: np.ndarray           # (g, K) int32 interior run starts (pad body)
    rid0: np.ndarray             # (g,) int32
    valid_len: np.ndarray        # (g,) int32


def file_source(paths: Sequence[str], max_workers: int = 8) -> Callable:
    """Parse FASTA files [s0, s1) with a host thread pool (the reference's
    cilk_for-over-files ingest, src/kmer_set.cpp:124)."""
    import concurrent.futures as cf

    pool = cf.ThreadPoolExecutor(max_workers=max_workers)

    def load(s0: int, s1: int) -> List[PackedSeqs]:
        return list(pool.map(read_fasta, paths[s0:s1]))
    return load


def codes_source(g: int, n: int, seed: int = 0) -> Callable:
    """Synthetic host genomes: one deterministic random run per genome."""
    def load(s0: int, s1: int) -> List[PackedSeqs]:
        out = []
        for i in range(s0, s1):
            rng = np.random.default_rng(seed * 1_000_003 + i)
            out.append(PackedSeqs(
                codes=rng.integers(0, 4, n).astype(np.uint8),
                run_lens=np.array([n], np.int64)))
        return out
    return load


def device_source(g: int, n: int, seed: int = 0) -> Callable:
    """Genomes synthesized ON DEVICE (every uint32 bit pair is a valid 2-bit
    code): the zero-ingest source measuring the pure device-resident path —
    what a pipeline whose genomes already live in device memory (e.g. a
    prior stage's output) pays."""
    from .ops.sketch import packed_body

    body = packed_body(n)
    meta = {}          # per-batch-size device metadata, uploaded once

    def load(s0: int, s1: int) -> _DevicePlanes:
        gg = s1 - s0
        key = jax.random.fold_in(jax.random.PRNGKey(seed), s0)
        p = jax.random.bits(key, (gg, body // 16), jnp.uint32)
        if gg not in meta:
            meta[gg] = (jnp.full((gg, 1), body, jnp.int32),
                        jnp.zeros(gg, jnp.int32),
                        jnp.full(gg, n, jnp.int32))
        bounds, rid0, vlen = meta[gg]
        return _DevicePlanes(p=p, bounds=bounds, rid0=rid0, valid_len=vlen)
    return load


def _pack_compact(batch: Sequence[PackedSeqs], g: int, n: int):
    """Host side of the compact upload for one dispatch of host genomes:
    (p (g, body/16) uint32 2-bit planes, bounds (g, K) int32 interior run
    starts padded with body, rid0 (g,) int32, valid_len (g,) int32); rows
    past len(batch) are empty genomes."""
    from .ops.sketch import packed_body

    body = packed_body(n)
    runs_max = max([1] + [pk.run_lens.size - 1 for pk in batch])
    k = 1 << max(3, (runs_max - 1).bit_length())
    p = np.zeros((g, body // 16), np.uint32)
    bounds = np.full((g, k), body, np.int32)
    vlen = np.zeros(g, np.int32)
    for i, pk in enumerate(batch):
        if pk.codes.size:
            p[i] = native.pack2bit(pk.codes, body // 16)
        starts = np.cumsum(pk.run_lens)[:-1]
        bounds[i, :starts.size] = starts
        vlen[i] = pk.codes.size
    return p, bounds, np.zeros(g, np.int32), vlen


# --- the pipeline -----------------------------------------------------------

class DevicePipeline:
    """End-to-end FASTA/codes -> (G, G) intersections with device-resident
    sketches.  `block` is the presort-cache genome block; `dispatch` genomes
    ride each sketch program (block and dispatch divide one another)."""

    def __init__(self, sketcher: FracMinHashSketcher, *, block: int = 128,
                 dispatch: int = 128, pair_batch: int = 256):
        if block % 128 or block & (block - 1):
            raise ValueError("block must be a power-of-two multiple of 128")
        if block % dispatch and dispatch % block:
            raise ValueError(
                "block and dispatch must divide one another")
        self.sk = sketcher
        self.block = block
        self.dispatch = dispatch
        self.pair_batch = pair_batch

    # -- sketch dispatch ------------------------------------------------
    def _dispatch(self, batch, n: int, capacity: int):
        """Async-dispatch one genome sub-batch on the compact upload;
        returns (SketchBatch future (keys stay on device), uploaded
        bytes)."""
        from .ops.sketch import jitted_sketch_batch_compact

        cfg = self.sk.config
        fn = jitted_sketch_batch_compact(
            n, cfg.window, self.sk.salt, cfg.scale, cfg.hash_variant,
            capacity)
        if isinstance(batch, _DevicePlanes):
            args, h2d = (batch.p, batch.bounds, batch.rid0,
                         batch.valid_len), 0
        else:
            args = _pack_compact(batch, len(batch), n)
            h2d = sum(a.nbytes for a in args)
        return fn(*(jnp.asarray(a) for a in args), self.sk._mask_words), h2d

    # -- run --------------------------------------------------------------
    def all_pairs(self, source: Callable, g: int, n: int, *,
                  verify_ids: Sequence[int] = ()) -> PipelineResult:
        """source(s0, s1) yields genomes [s0, s1); `n` is the nominal
        (maximum) genome length shaping the static programs.  Returns the
        full ordered (G, G) intersection matrix (reference all-pairs incl.
        self, src/generators.hpp:45-58)."""
        cfg = self.sk.config
        nw = n - cfg.window + 1
        if nw <= 0:
            raise ValueError("nominal genome length below window")
        capacity = cfg.capacity_for(nw)
        while True:
            try:
                return self._all_pairs_once(source, g, n, capacity,
                                            set(verify_ids))
            except _CapacityOverflow as e:
                log.info("pipeline sketch overflow -> retry cap=%d",
                         e.capacity)
                capacity = e.capacity

    def _all_pairs_once(self, source, g: int, n: int, capacity: int,
                        verify_ids) -> PipelineResult:
        from .ops.gram import _guard_words, pack_plan, presort_block_packed
        from .parallel.allpairs import pair_tile_sweep

        cfg = self.sk.config
        block, dispatch = self.block, self.dispatch
        key_bits = min(128, 2 * cfg.window)
        kw = min(4, _guard_words(key_bits))
        gidbits = max(1, (2 * block - 1).bit_length())
        pw = pack_plan(key_bits, gidbits)
        nb = (g + block - 1) // block

        phases = {"ingest_s": 0.0, "sketch_s": 0.0, "presort_s": 0.0,
                  "allpairs_s": 0.0}
        bytes_h2d = 0
        bytes_d2h = 0
        sample_keys: Dict[int, np.ndarray] = {}
        caches: List = [None] * nb   # per-block (pw, rows_b, 128) caches
        counts = np.zeros(g, np.int32)
        t_start = time.perf_counter()

        # Dispatches are ASYNC (the loop only enqueues programs; device
        # keys and raw/count scalars stay on device), but each block is
        # PRESORTED as soon as its dispatches complete — a bounded
        # in-flight window of LOOKAHEAD blocks — so the raw dispatch keys
        # parked in device memory peak at O(lookahead * block * capacity) instead of
        # O(G * capacity).  Each block's cache is trimmed to ITS
        # tightest 128-multiple power-of-two count (the tile scan's work
        # is linear in cache width); mixed widths are sentinel-padded to
        # the global maximum before tiling — appending all-ones rows to a
        # sorted packed stream keeps it sorted, so the pad is exact.
        LOOKAHEAD = 2
        pending: List[Tuple[int, list, list, list]] = []  # per OPEN block

        def finalize(b_idx, keyparts, raws_d, counts_d):
            nonlocal bytes_d2h
            # the scalar reads below WAIT for this block's sketches —
            # device time, so it books under sketch_s; the transfers were
            # already scheduled at enqueue time (copy_to_host_async), so
            # no extra device->host request round trip is paid here
            t0 = time.perf_counter()
            raws = np.concatenate([np.asarray(x) for x in raws_d])
            cnt = np.concatenate([np.asarray(x) for x in counts_d])
            phases["sketch_s"] += time.perf_counter() - t0
            bytes_d2h += raws.nbytes + cnt.nbytes
            if int(raws.max()) > capacity:
                raise _CapacityOverflow(
                    1 << math.ceil(math.log2(int(raws.max()) + 1)))
            t0 = time.perf_counter()
            i0 = b_idx * block
            counts[i0:i0 + cnt.shape[0]] = cnt
            cap_b = max(128, 1 << int(math.ceil(math.log2(
                max(1, int(cnt.max(initial=1)))))))
            cap_b = min(cap_b, capacity)
            kb = jnp.concatenate([p[:, :cap_b] for p in keyparts]) \
                if len(keyparts) > 1 else keyparts[0][:, :cap_b]
            if kb.shape[0] < block:        # ragged tail: sentinel sketches
                pad = jnp.full((block - kb.shape[0], cap_b, kw),
                               _SENT, jnp.uint32)
                kb = jnp.concatenate([kb, pad])
            caches[b_idx] = presort_block_packed(
                kb, key_bits=key_bits, gidbits=gidbits, pw=pw)
            keyparts.clear()               # frees the raw dispatch keys
            phases["presort_s"] += time.perf_counter() - t0

        # the NEXT dispatch's source batch is prefetched on one worker
        # thread while the main thread packs/uploads/enqueues the current
        # one: ingest work (file parse / synthesis) overlaps the upload
        # and device waits (native pack and the device transfers release
        # the GIL).  ingest_s books only the VISIBLE stall waiting on the
        # prefetch; the worker's own work time is ingest_work_s, and
        # overlap_eff = hidden / min(ingest_work, sketch_work).
        import concurrent.futures as cf
        ingest_work = [0.0]

        def timed_source(a, b):
            t = time.perf_counter()
            out = source(a, b)
            ingest_work[0] += time.perf_counter() - t
            return out

        ex = cf.ThreadPoolExecutor(max_workers=1)
        t_span0 = time.perf_counter()
        with span("sketching", log):
            fut = ex.submit(timed_source, 0, min(g, dispatch))
            for s0 in range(0, g, dispatch):
                s1 = min(g, s0 + dispatch)
                t0 = time.perf_counter()
                batch = fut.result()
                phases["ingest_s"] += time.perf_counter() - t0
                if s1 < g:
                    fut = ex.submit(timed_source, s1,
                                    min(g, s1 + dispatch))
                t0 = time.perf_counter()
                res, h2d = self._dispatch(batch, n, capacity)
                bytes_h2d += h2d
                phases["sketch_s"] += time.perf_counter() - t0
                # route block-aligned slices into per-block pending slots
                # (dispatch and block divide one another, so a dispatch
                # never splits a block boundary unevenly)
                for off in range(0, s1 - s0, block):
                    i0 = s0 + off
                    b_idx = i0 // block
                    lo, hi = off, min(off + block, s1 - s0)
                    if not pending or pending[-1][0] != b_idx:
                        pending.append((b_idx, [], [], []))
                    rr, cc = res.raw_kept[lo:hi], res.count[lo:hi]
                    for x in (rr, cc):     # schedule D2H now, read later
                        x.copy_to_host_async()
                    pending[-1][1].append(res.keys[lo:hi, :, :kw])
                    pending[-1][2].append(rr)
                    pending[-1][3].append(cc)
                if i_verify := [i for i in range(s0, s1) if i in verify_ids]:
                    for i in i_verify:
                        sample_keys[i] = jnp.array(res.keys[i - s0])
                # finalize blocks that fell out of the lookahead window
                # (complete: the NEXT block has started receiving parts)
                while len(pending) > LOOKAHEAD + 1:
                    finalize(*pending.pop(0))
            while pending:
                finalize(*pending.pop(0))
            for i in list(sample_keys):
                k = np.asarray(sample_keys[i][:int(counts[i])]) \
                    .astype(np.uint64)
                sample_keys[i] = np.ascontiguousarray(np.stack(
                    [k[:, 0] | (k[:, 1] << np.uint64(32)),
                     k[:, 2] | (k[:, 3] << np.uint64(32))], axis=1))
                bytes_d2h += int(counts[i]) * 16
        ex.shutdown(wait=False)
        span_wall = time.perf_counter() - t_span0
        phases["ingest_work_s"] = ingest_work[0]
        hidden = max(0.0, ingest_work[0] + phases["sketch_s"] - span_wall)
        denom = min(ingest_work[0], phases["sketch_s"])
        phases["overlap_eff"] = round(hidden / denom, 3) if denom > 0.05 \
            else None

        assert all(c is not None for c in caches)
        t0 = time.perf_counter()
        rows_max = max(c.shape[1] for c in caches)
        cap_p = rows_max * 128 // block
        caches = [c if c.shape[1] == rows_max else jnp.concatenate(
            [c, jnp.full((pw, rows_max - c.shape[1], 128), _SENT,
                         jnp.uint32)], axis=1) for c in caches]
        phases["presort_s"] += time.perf_counter() - t0

        with span("comparison", log):
            t0 = time.perf_counter()
            cache = jnp.stack(caches)
            del caches
            out = np.zeros((g, g), np.int32)
            binner = _tile_binner(block)
            pair_tile_sweep([cache], g, block, out, [None], gidbits=gidbits,
                            binner=binner, pair_batch=self.pair_batch)
            phases["allpairs_s"] = time.perf_counter() - t0
            npairs = nb * (nb + 1) // 2
            bytes_d2h += npairs * block * block * (
                2 if cap_p <= 32767 else 4)

        phases["total_s"] = time.perf_counter() - t_start
        return PipelineResult(inter=out, counts=counts, phases=phases,
                              bytes_h2d=bytes_h2d, bytes_d2h=bytes_d2h,
                              sample_keys=sample_keys, cache_cap=cap_p)


import functools


@functools.lru_cache(maxsize=32)
def _mesh_presort_fn(mesh, block: int, cap_p: int, kw: int, key_bits: int,
                     gidbits: int, pw: int):
    """Jitted sharded presort: keys (ns*block, capacity, 4) with one whole
    presort block per device -> (ns, pw, rows, 128) cache sharded on the
    block axis.  The cap_p/kw trim happens inside the program."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .ops.gram import presort_block_packed
    from .parallel.mesh import data_spec

    spec = data_spec()

    def local(kb):                    # (block, capacity, >=kw) per device
        return presort_block_packed(kb[:, :cap_p, :kw], key_bits=key_bits,
                                    gidbits=gidbits, pw=pw)[None]

    sharded = shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)
    return jax.jit(sharded)


@functools.lru_cache(maxsize=32)
def _mesh_sketch_compact(mesh, n: int, window: int, salt: int, scale: int,
                         variant: str, capacity: int):
    from .parallel.sketch import sharded_sketch_compact_fn
    return sharded_sketch_compact_fn(mesh, n=n, window=window, salt=salt,
                                     scale=scale, variant=variant,
                                     capacity=capacity)


class MeshDevicePipeline:
    """The one-flow pipeline SHARDED over a device mesh (single
    controller): every dispatch carries mesh_size * block genomes — one
    whole presort block per device — sketched by the sharded compact step
    (0.25 B/nt host ingest, zero cross-device communication), presorted
    per device inside a shard_map, and the macro-tiles split across every
    device with the block cache all-gathered by XLA
    (parallel/allpairs._mesh_tiles_fn).  Sketches never touch the host:
    the multi-chip BASELINE config-4 flow (the reference's cilk_for over
    files + cilk_for over pairs in one program each,
    src/kmer_set.cpp:124,179).

    Scope: single-controller meshes (the cards of one host under one
    process, or the virtual CPU mesh in tests).  Multi-host jobs use MeshSketcher,
    whose collectives follow the multi-process conventions."""

    def __init__(self, sketcher: FracMinHashSketcher, mesh, *,
                 block: int = 128, pair_batch: int = 256):
        if block % 128 or block & (block - 1):
            raise ValueError("block must be a power-of-two multiple of 128")
        self.sk = sketcher
        self.mesh = mesh
        self.ns = int(mesh.devices.size)
        self.block = block
        self.pair_batch = pair_batch

    def _dispatch(self, batch, g_d: int, n: int, capacity: int):
        """One sharded dispatch of g_d genomes (padded with empties)."""
        from jax.sharding import NamedSharding

        from .parallel.mesh import data_spec

        cfg = self.sk.config
        shard = NamedSharding(self.mesh, data_spec())

        def put(x):
            return jax.device_put(jnp.asarray(x), shard)

        if isinstance(batch, _DevicePlanes):
            gg = batch.p.shape[0]
            p = batch.p
            if gg < g_d:
                p = jnp.concatenate(
                    [p, jnp.zeros((g_d - gg,) + p.shape[1:], p.dtype)])
            bounds = np.concatenate(
                [batch.bounds,
                 np.full((g_d - gg,) + batch.bounds.shape[1:],
                         batch.bounds.max(initial=1), np.int32)])
            rid0 = np.concatenate([batch.rid0, np.zeros(g_d - gg, np.int32)])
            vlen = np.concatenate([batch.valid_len,
                                   np.zeros(g_d - gg, np.int32)])
            fn = _mesh_sketch_compact(self.mesh, n, cfg.window, self.sk.salt,
                                      cfg.scale, cfg.hash_variant, capacity)
            return fn(jax.device_put(p, shard), put(bounds), put(rid0),
                      put(vlen), self.sk._mask_words), 0
        args = _pack_compact(batch, g_d, n)
        fn = _mesh_sketch_compact(self.mesh, n, cfg.window, self.sk.salt,
                                  cfg.scale, cfg.hash_variant, capacity)
        return (fn(*(put(a) for a in args), self.sk._mask_words),
                sum(a.nbytes for a in args))

    def all_pairs(self, source: Callable, g: int, n: int, *,
                  verify_ids: Sequence[int] = ()) -> PipelineResult:
        cfg = self.sk.config
        nw = n - cfg.window + 1
        if nw <= 0:
            raise ValueError("nominal genome length below window")
        capacity = cfg.capacity_for(nw)
        while True:
            try:
                return self._all_pairs_once(source, g, n, capacity,
                                            set(verify_ids))
            except _CapacityOverflow as e:
                log.info("mesh pipeline sketch overflow -> retry cap=%d",
                         e.capacity)
                capacity = e.capacity

    def _all_pairs_once(self, source, g: int, n: int, capacity: int,
                        verify_ids) -> PipelineResult:
        from jax.sharding import NamedSharding

        from .ops.gram import _guard_words, pack_plan
        from .parallel.allpairs import _mesh_tiles_fn
        from .parallel.mesh import data_spec

        cfg = self.sk.config
        block, ns = self.block, self.ns
        key_bits = min(128, 2 * cfg.window)
        kw = min(4, _guard_words(key_bits))
        gidbits = max(1, (2 * block - 1).bit_length())
        pw = pack_plan(key_bits, gidbits)
        g_d = ns * block
        nb = (g + block - 1) // block

        phases = {"ingest_s": 0.0, "sketch_s": 0.0, "presort_s": 0.0,
                  "allpairs_s": 0.0}
        bytes_h2d = bytes_d2h = 0
        sample_keys: Dict[int, np.ndarray] = {}
        counts = np.zeros(g, np.int32)
        segs: List = []      # per-dispatch (ns, pw, rows_d, 128) caches
        t_start = time.perf_counter()
        empty = PackedSeqs(codes=np.empty(0, np.uint8),
                           run_lens=np.empty(0, np.int64))

        # same bounded-parking scheme as DevicePipeline: each
        # dispatch (one block per device) presorts as soon as its scalars
        # arrive, trimmed to its own power-of-two count; segments pad to
        # the widest cache before the tile phase.  The next source batch
        # prefetches on a worker thread.
        import concurrent.futures as cf
        LOOKAHEAD = 2
        ingest_work = [0.0]

        def timed_source(a, b):
            t = time.perf_counter()
            out = source(a, b)
            ingest_work[0] += time.perf_counter() - t
            return out

        pending: List[Tuple[int, object, object, object]] = []

        def finalize(s0, keys, rr, cc):
            nonlocal bytes_d2h
            t0 = time.perf_counter()
            raws = np.asarray(rr)
            cnt = np.asarray(cc)
            phases["sketch_s"] += time.perf_counter() - t0
            bytes_d2h += raws.nbytes + cnt.nbytes
            if int(raws.max()) > capacity:
                raise _CapacityOverflow(
                    1 << math.ceil(math.log2(int(raws.max()) + 1)))
            t0 = time.perf_counter()
            hi = min(g, s0 + g_d)
            counts[s0:hi] = cnt[:hi - s0]
            cap_d = max(128, 1 << int(math.ceil(math.log2(
                max(1, int(cnt.max(initial=1)))))))
            cap_d = min(cap_d, capacity)
            pre = _mesh_presort_fn(self.mesh, block, cap_d, kw, key_bits,
                                   gidbits, pw)
            segs.append(pre(keys))
            for i in verify_ids:
                if s0 <= i < hi:
                    k = np.asarray(keys[i - s0, :int(counts[i])]) \
                        .astype(np.uint64)
                    sample_keys[i] = np.ascontiguousarray(np.stack(
                        [k[:, 0] | (k[:, 1] << np.uint64(32)),
                         k[:, 2] | (k[:, 3] << np.uint64(32))], axis=1))
                    bytes_d2h += int(counts[i]) * 16
            phases["presort_s"] += time.perf_counter() - t0

        ex = cf.ThreadPoolExecutor(max_workers=1)
        t_span0 = time.perf_counter()
        with span("sketching", log):
            fut = ex.submit(timed_source, 0, min(g, g_d))
            for s0 in range(0, g, g_d):
                s1 = min(g, s0 + g_d)
                t0 = time.perf_counter()
                batch = fut.result()
                phases["ingest_s"] += time.perf_counter() - t0
                if s1 < g:
                    fut = ex.submit(timed_source, s1, min(g, s1 + g_d))
                if not isinstance(batch, _DevicePlanes) and s1 - s0 < g_d:
                    batch = list(batch) + [empty] * (g_d - (s1 - s0))
                t0 = time.perf_counter()
                res, h2d = self._dispatch(batch, g_d, n, capacity)
                bytes_h2d += h2d
                phases["sketch_s"] += time.perf_counter() - t0
                rr, cc = res.raw_kept, res.count
                for x in (rr, cc):
                    x.copy_to_host_async()
                pending.append((s0, res.keys, rr, cc))
                while len(pending) > LOOKAHEAD:
                    finalize(*pending.pop(0))
            while pending:
                finalize(*pending.pop(0))
        ex.shutdown(wait=False)
        span_wall = time.perf_counter() - t_span0
        phases["ingest_work_s"] = ingest_work[0]
        hidden = max(0.0, ingest_work[0] + phases["sketch_s"] - span_wall)
        denom = min(ingest_work[0], phases["sketch_s"])
        phases["overlap_eff"] = round(hidden / denom, 3) if denom > 0.05 \
            else None

        t0 = time.perf_counter()
        rows_max = max(s.shape[2] for s in segs)
        cap_p = rows_max * 128 // block
        segs = [s if s.shape[2] == rows_max else jnp.concatenate(
            [s, jnp.full(s.shape[:2] + (rows_max - s.shape[2], 128),
                         _SENT, jnp.uint32)], axis=2) for s in segs]
        cache = jnp.concatenate(segs)
        segs.clear()
        phases["presort_s"] += time.perf_counter() - t0

        with span("comparison", log):
            t0 = time.perf_counter()
            pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
            # tiles dispatch in BATCHES of ns * pair_batch (one fixed-shape
            # jitted program, final batch padded with (0, 0)): batching
            # enqueues batch k+1 before forcing batch k's download, so the
            # int16 tile downloads overlap compute, same as
            # pair_tile_sweep.
            bsz = max(ns, (self.pair_batch // ns) * ns)
            pp = -(-len(pairs) // bsz) * bsz
            arr = np.array(pairs + [(0, 0)] * (pp - len(pairs)), np.int32)
            binner = _tile_binner(block)
            fn = _mesh_tiles_fn(self.mesh, block, gidbits, binner,
                                cap_p <= 32767)
            shard = NamedSharding(self.mesh, data_spec())
            futs = []
            for b0 in range(0, pp, bsz):
                sl = arr[b0:b0 + bsz]
                fut = fn(
                    cache, jax.device_put(jnp.asarray(sl[:, 0]), shard),
                    jax.device_put(jnp.asarray(sl[:, 1]), shard))
                fut.copy_to_host_async()   # schedule D2H now, read later
                futs.append(fut)
            out = np.zeros((g, g), np.int32)
            for bi0, fut in zip(range(0, pp, bsz), futs):
                tiles = np.asarray(fut)
                for pi in range(min(bsz, len(pairs) - bi0)):
                    bi, bj = pairs[bi0 + pi]
                    r0, r1 = bi * block, min(g, (bi + 1) * block)
                    c0, c1 = bj * block, min(g, (bj + 1) * block)
                    if r0 >= g or c0 >= g:
                        continue
                    t = tiles[pi]
                    out[r0:r1, c0:c1] = t[:r1 - r0, :c1 - c0]
                    if bj != bi:
                        out[c0:c1, r0:r1] = t[:r1 - r0, :c1 - c0].T
            phases["allpairs_s"] = time.perf_counter() - t0
            bytes_d2h += pp * block * block * (2 if cap_p <= 32767 else 4)

        phases["total_s"] = time.perf_counter() - t_start
        return PipelineResult(inter=out, counts=counts, phases=phases,
                              bytes_h2d=bytes_h2d, bytes_d2h=bytes_d2h,
                              sample_keys=sample_keys, cache_cap=cap_p)


def all_pairs_from_files(sketcher: FracMinHashSketcher,
                         paths: Sequence[str], *, block: int = 128,
                         dispatch: int = 32, pair_batch: int = 256,
                         max_workers: int = 8, mesh=None,
                         verify_ids: Sequence[int] = ()) -> PipelineResult:
    """One-flow FASTA files -> (G, G) intersection matrix with
    device-resident sketches (the reference experiment's sketch+compare
    flow, src/kmer-sketching.cpp:151-212).  With `mesh`, the whole flow
    shards over it (MeshDevicePipeline; single controller).  The nominal
    genome length is bounded by the largest file size (a FASTA file's
    code count never exceeds its byte size)."""
    import os

    n = max(os.path.getsize(p) for p in paths)
    n = max(n, sketcher.config.window + 1)
    if mesh is not None:
        mpipe = MeshDevicePipeline(sketcher, mesh, block=block,
                                   pair_batch=pair_batch)
        return mpipe.all_pairs(file_source(paths, max_workers), len(paths),
                               n, verify_ids=verify_ids)
    pipe = DevicePipeline(sketcher, block=block, dispatch=dispatch,
                          pair_batch=pair_batch)
    return pipe.all_pairs(file_source(paths, max_workers), len(paths), n,
                          verify_ids=verify_ids)
