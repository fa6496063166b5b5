"""Mesh-backed drop-in sketcher: the driver's `--mesh` execution engine.

Subclasses models.fracminhash.FracMinHashSketcher so the CLI driver and the
sweep (driver.py) run UNCHANGED on a device mesh: genome-level sketching is
dispatched through parallel.sketch.sharded_sketch_fn (the cilk_for-over-files
analog, src/kmer_set.cpp:112-133) and the all-pairs intersection matrix
through parallel.allpairs.sharded_all_pairs_fn (the cilk_for-over-pairs
analog, src/kmer_set.cpp:167-184).  Results are bit-identical to the
single-device path — tests/test_driver.py asserts byte-identical CSVs.

Multi-host: ingest is sharded per process (process_shard), and the global
batch is assembled with jax.make_array_from_process_local_data so each host
parses and uploads only its own genomes.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SketchConfig
from ..models.fracminhash import FracMinHashSketcher, Sketch, _next_pow2
from ..observability import get_logger, span
from .allpairs import sharded_all_pairs_fn
from .distributed import global_mesh, local_batch_rows
from .mesh import ROW_AXIS, data_spec, pad_to_multiple
from .sketch import pack_genome_batch, sharded_sketch_fn

log = get_logger(__name__)


@functools.lru_cache(maxsize=64)
def _sketch_fn(mesh: Mesh, window: int, salt: int, scale: int, variant: str,
               capacity: int):
    return sharded_sketch_fn(mesh, window=window, salt=salt, scale=scale,
                             variant=variant, capacity=capacity)


@functools.lru_cache(maxsize=8)
def _pairs_fn(mesh: Mesh):
    return sharded_all_pairs_fn(mesh)


@functools.lru_cache(maxsize=64)
def _seq_compact_fn(mesh: Mesh, window: int, salt: int, scale: int,
                    variant: str, capacity: int):
    from .sequence import sequence_parallel_sketch_compact_fn
    return sequence_parallel_sketch_compact_fn(
        mesh, window=window, salt=salt, scale=scale, variant=variant,
        capacity=capacity)


class MeshSketcher(FracMinHashSketcher):
    """FracMinHashSketcher whose batched steps run sharded over a mesh."""

    #: genomes at or above this many nucleotides switch to sequence-parallel
    #: chunked extraction (the CP analog: ppermute halo ring, SURVEY.md §2.1)
    seq_par_threshold: int = 1 << 22

    def __init__(self, config: SketchConfig, mesh: Optional[Mesh] = None,
                 mask=None, seq_par_threshold: Optional[int] = None):
        super().__init__(config, mask)
        self.mesh = mesh if mesh is not None else global_mesh()
        self.mesh_size = int(np.prod(list(self.mesh.shape.values())))
        if seq_par_threshold is not None:
            self.seq_par_threshold = seq_par_threshold

    # ---- long genomes: sequence-parallel halo-ring extraction --------------
    def sketch_packed(self, packed, name: str = "") -> Sketch:
        cfg = self.config
        nwin = packed.total_windows(cfg.window)
        if nwin <= 0 or int(packed.codes.size) < self.seq_par_threshold:
            return super().sketch_packed(packed, name)
        starts = np.cumsum(packed.run_lens)[:-1]
        out = self._seq_parallel_batch(packed.codes, starts, 0, nwin)
        count = int(self._get(out.count).ravel()[0])
        keys = self._get(out.keys).reshape(-1, 4)[:count]
        return Sketch(keys=keys.copy(), count=count, window=cfg.window,
                      mask=self.mask, name=name)

    def _seq_parallel_batch(self, codes_u8: np.ndarray, starts: np.ndarray,
                            rid0: int, nwin: int):
        """One sequence-parallel dispatch (halo-ring chunk extraction,
        SURVEY.md §2.1 CP analog) -> replicated SketchBatch, retried on
        capacity overflow.  The upload is the COMPACT 2-bit plane + run
        bounds (0.25 B/nt expanded to codes and run ids ON DEVICE,
        parallel/sequence.py compact fn)."""
        from ..utils import native

        cfg = self.config
        total = int(codes_u8.size)
        # pad to a multiple of (mesh_size * 128) so every chunk is
        # lane-tiled (also makes n/16 divide the ring size)
        quantum = self.mesh_size * 128
        n = pad_to_multiple(total + cfg.window, quantum)
        import jax.numpy as jnp
        p = native.pack2bit(np.ascontiguousarray(codes_u8, np.uint8), n // 16)
        k = 1 << max(3, int(starts.size - 1).bit_length()
                     if starts.size else 3)
        bounds = np.full(k, n, np.int32)
        bounds[:starts.size] = starts
        args = (jnp.asarray(p), jnp.asarray(bounds),
                jnp.asarray(np.array([rid0], np.int32)),
                jnp.asarray(np.array([total], np.int32)))
        capacity = cfg.capacity_for(nwin)
        while True:
            out = _seq_compact_fn(self.mesh, cfg.window, self.salt,
                                  cfg.scale, cfg.hash_variant,
                                  capacity)(*args, self._mask_words)
            raw = int(self._get(out.raw_kept).max())
            if raw <= capacity:
                return out
            # raw (total pre-dedup kept) >= the merged unique total, so a
            # chunk overflow AND a merge truncation both trip this retry
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("sequence-parallel overflow -> retry cap=%d", capacity)

    def sketch_file_streaming(self, path: str, segment_nt: int = 1 << 24,
                              name: str = "") -> Sketch:
        """Bounded-memory streaming ingest ON THE MESH: the native two-pass
        parser yields segments; each segment extracts sequence-parallel
        over the halo ring and folds into the accumulator with one jitted
        on-device merge.  Bit-exact with the single-device
        sketch_file_streaming (sketches are canonical sorted-unique sets,
        so chunking/merging order cannot show).  Peak host memory is
        O(segment), never O(genome) — BASELINE config 5 on a mesh.

        Multi-process note: every process parses the file (it must be on a
        shared filesystem) because each segment's dispatch is a collective
        program all processes join."""
        from ..ops.sketch import jitted_merge_sketches
        from ..utils import native

        if not native.available():
            return super().sketch_file_streaming(path, segment_nt, name)

        cfg = self.config
        w = cfg.window
        carry = np.empty(0, np.uint8)
        carry_starts = np.empty(0, np.int64)   # starts within the carry
        cur_run = 0
        prev_open = True
        seg_bufs, seg_counts = [], []

        for codes, run_ends, open_run in native.fasta_stream(path,
                                                             segment_nt):
            if not prev_open:
                cur_run += 1
            seg_codes = np.concatenate([carry, codes])
            starts = np.concatenate([carry_starts,
                                     run_ends + carry.size]).astype(np.int64)
            rid0 = cur_run
            cur_run += len(run_ends)
            prev_open = open_run
            if w > 1:
                carry = seg_codes[-(w - 1):]
                cut = seg_codes.size - carry.size
                keep = starts >= cut
                carry_starts = starts[keep] - cut
            nwin = seg_codes.size - w + 1
            if nwin <= 0:
                continue
            out = self._seq_parallel_batch(seg_codes, starts, rid0, nwin)
            cnt = int(self._get(out.count).ravel()[0])
            if cnt:
                # single process keeps per-segment keys ON DEVICE; multi-
                # process downloads them (eager stacking of replicated
                # global arrays is not addressable per process)
                seg_bufs.append(out.keys if jax.process_count() == 1
                                else self._get(out.keys))
                seg_counts.append(cnt)

        if not seg_bufs:
            return Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                          window=w, mask=self.mask, name=name)
        if len(seg_bufs) == 1:
            cnt = seg_counts[0]
            keys = self._get(seg_bufs[0]).reshape(-1, 4)[:cnt]
            return Sketch(keys=keys.copy(), count=cnt, window=w,
                          mask=self.mask, name=name)
        import jax.numpy as jnp
        total = int(sum(seg_counts))
        capm = max(256, 1 << max(0, (total - 1).bit_length()))
        cut = max(256, 1 << max(0, (max(seg_counts) - 1).bit_length()))
        s2 = 1 << max(0, (len(seg_bufs) - 1).bit_length())

        def fit(x):
            x = x.reshape(-1, 4)
            if x.shape[0] >= cut:
                return x[:cut]
            pad = jnp.full((cut - x.shape[0], 4), 0xFFFFFFFF, jnp.uint32)
            return jnp.concatenate([x, pad])

        stack = [fit(b) for b in seg_bufs]
        stack += [jnp.full((cut, 4), 0xFFFFFFFF, jnp.uint32)] * (
            s2 - len(seg_bufs))
        counts_all = np.zeros(s2, np.int32)
        counts_all[:len(seg_counts)] = seg_counts
        merged = jitted_merge_sketches(capm)(
            jnp.stack(stack), jnp.asarray(counts_all))
        acc = int(np.asarray(merged.count))
        return Sketch(keys=np.asarray(merged.keys[:acc]), count=acc,
                      window=w, mask=self.mask, name=name)

    # ---- ingest: each process parses only its own shard --------------------
    def sketch_files(self, paths: Sequence[str], max_workers: int = 8,
                     on_error: str = "raise") -> List[Sketch]:
        """Genome-level data parallelism over the mesh, with the base
        class's big-file routing: files past _STREAM_THRESHOLD_BYTES go
        through the MESH streaming pipeline (sequence-parallel segments,
        bounded host memory — BASELINE config 5 on a mesh) instead of a
        whole-genome resident parse; everything else shards per process."""
        import concurrent.futures as cf
        import os as _os

        from ..ingest.fasta import PackedSeqs, read_fasta
        from ..utils import native

        if on_error not in ("raise", "skip"):
            raise ValueError(f"unknown on_error {on_error!r}")

        big = set()
        if native.available():
            for p in paths:
                try:
                    if _os.path.getsize(p) >= self._STREAM_THRESHOLD_BYTES:
                        big.add(p)
                except OSError:
                    pass     # missing files keep read_fasta's error parity

        def _empty_sketch(name):
            return Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                          window=self.config.window, mask=self.mask,
                          name=name)

        small = [p for p in paths if p not in big]
        local = local_batch_rows(self.mesh, data_spec(), len(small),
                                 self.mesh_size)
        empty = PackedSeqs(codes=np.empty(0, np.uint8),
                           run_lens=np.empty(0, np.int64))

        def _read(i):
            if i not in local:
                return empty
            try:
                return read_fasta(small[i])
            except Exception:
                if on_error == "raise":
                    raise
                log.exception("skipping unreadable genome %s", small[i])
                return empty

        with span("sketching", log):
            # streaming dispatches are collective programs, so every
            # process runs them (big files are not per-process sharded)
            streamed = {}
            for p in sorted(big):
                try:
                    streamed[p] = self.sketch_file_streaming(p, name=p)
                except Exception:
                    if on_error == "raise":
                        raise
                    log.exception("skipping unreadable genome %s", p)
                    streamed[p] = _empty_sketch(p)
            with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
                packed = list(ex.map(_read, range(len(small))))
            sketched = iter(self.sketch_packed_batch(packed, names=small)
                            if small else [])
            return [streamed[p] if p in big else next(sketched)
                    for p in paths]

    # ---- sharded batched sketching -----------------------------------------
    def sketch_packed_batch(self, packed_list, names=None) -> List[Sketch]:
        cfg = self.config
        names = names or [""] * len(packed_list)
        nwins = [p.total_windows(cfg.window) for p in packed_list]
        n_codes = None
        if jax.process_count() > 1:
            # each process only parsed ITS shard (others are empty
            # placeholders), but everything derived from genome metadata
            # must be GLOBALLY consistent: the padded length and capacity
            # shape the jitted program (divergent shapes deadlock the
            # collective compile) and the per-genome window counts gate
            # the final counts (a local-only guard zeroed every non-local
            # sketch).  One tiny allgather of (sizes, windows) fixes all
            # three.
            from jax.experimental import multihost_utils
            meta = np.array([[int(p.codes.size) for p in packed_list],
                             nwins], np.int64)
            allm = np.asarray(multihost_utils.process_allgather(meta))
            n_codes = int(allm[:, 0, :].max())
            nwins = [int(x) for x in allm[:, 1, :].max(axis=0)]
        codes, run_ids, g = pack_genome_batch(packed_list, self.mesh_size,
                                              cfg.window, n_codes=n_codes)
        capacity = max([cfg.capacity_for(nw) for nw in nwins if nw > 0]
                       or [cfg.capacity_for(1)])

        spec = data_spec()
        dc = self._put(codes, spec)
        dr = self._put(run_ids, spec)
        while True:
            fn = _sketch_fn(self.mesh, cfg.window, self.salt, cfg.scale,
                            cfg.hash_variant, capacity)
            res = fn(dc, dr, self._mask_words)
            raw = int(self._get(res.raw_kept).max())
            if raw <= capacity:
                break
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("sharded sketch overflow -> retry cap=%d", capacity)

        keys = self._get(res.keys)
        counts = self._get(res.count)
        out: List[Sketch] = []
        for i in range(g):
            c = int(counts[i]) if nwins[i] > 0 else 0
            out.append(Sketch(keys=keys[i, :c].copy(), count=c,
                              window=cfg.window, mask=self.mask,
                              name=names[i]))
        return out

    def _put(self, arr: np.ndarray, spec: P):
        sharding = NamedSharding(self.mesh, spec)
        if jax.process_count() > 1:
            # arr is GLOBAL-shaped on every process (non-local genome rows
            # are zero-filled and never read — each process's addressable
            # devices map onto its own rows).  global_shape must be passed
            # explicitly: without it the API infers a global shape under
            # the each-host-holds-only-its-own-rows convention and the
            # array comes out process_count times too large.
            return jax.make_array_from_process_local_data(
                sharding, arr, global_shape=arr.shape)
        return jax.device_put(arr, sharding)

    def _get(self, x) -> np.ndarray:
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(x, tiled=True))
        return np.asarray(jax.device_get(x))

    # ---- sharded all-pairs --------------------------------------------------
    def all_pairs_intersections(self, sketches: Sequence[Sketch],
                                tile: int = 64) -> np.ndarray:
        """(G, G) intersections via the on-device packed (key, gid) engine
        sharded over the mesh (parallel/allpairs.mesh_all_pairs_packed):
        one replicated slab upload, device-side block presort, and the
        upper-triangle macro-tiles split across every mesh device in one
        program — NO host rank-layout build (build_rank_layout is
        host-bound).  The mesh
        analog of the reference's cilk_for over pairs
        (src/kmer_set.cpp:179); bit-identical to the single-device gram
        engines."""
        from ..ops.gram import _guard_words
        from .allpairs import mesh_all_pairs_packed

        g = len(sketches)
        cap = max(1, _next_pow2(max([s.count for s in sketches] or [1])))
        key_bits = min(128, 2 * self.config.window)
        kw = min(4, _guard_words(key_bits))
        keys = np.full((g, cap, kw), 0xFFFFFFFF, dtype=np.uint32)
        counts = np.zeros(g, dtype=np.int32)
        for i, s in enumerate(sketches):
            keys[i, :s.count] = s.keys[:, :kw]
            counts[i] = s.count
        return mesh_all_pairs_packed(self.mesh, self._put, self._get,
                                     keys, counts, key_bits=key_bits)

    def all_pairs_intersections_shardmap(self, sketches: Sequence[Sketch],
                                         tile: int = 64) -> np.ndarray:
        """Probe-engine 2-D mesh tiling (kept as cross-check engine)."""
        g = len(sketches)
        gp = pad_to_multiple(max(g, 1), self.mesh_size)
        cap = max(1, _next_pow2(max([s.count for s in sketches] or [1])))
        keys = np.full((gp, cap, 4), 0xFFFFFFFF, dtype=np.uint32)
        counts = np.zeros(gp, dtype=np.int32)
        for i, s in enumerate(sketches):
            keys[i, :s.count] = s.keys
            counts[i] = s.count
        fn = _pairs_fn(self.mesh)
        out = self._get(fn(self._put(keys, P(ROW_AXIS)),
                           self._put(counts, P(ROW_AXIS))))
        return out[:g, :g]
