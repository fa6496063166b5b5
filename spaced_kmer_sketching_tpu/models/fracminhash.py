"""FracMinHash spaced-seed sketcher — the framework's flagship pipeline.

Host-side orchestration around the jitted device steps:

    FASTA -> 2-bit pack (native C++) -> [device] extract + hash-filter +
    sort-unique  -> Sketch (sorted key array)  -> [device] tiled all-pairs
    intersections -> [host float64] containment -> ANI

Mirrors the reference call stack kmer_set_from_fasta_file ->
parallel_kmer_sets_from_fasta_files -> kmer_set_intersection ->
containment/binomial_estimator (src/kmer_set.cpp:54-184,
src/ani_estimation.cpp:24-42), re-architected around static-shape batches.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ani import binomial_estimator, containment
from ..config import SketchConfig
from ..ingest.fasta import PackedSeqs, read_fasta
from ..ops.intersect import intersection_tile
from ..ops.sketch import sketch_from_codes
from ..utils import boosthash, native
from ..utils.masks import SpacedSeedMask, spaced_seed_mask
from ..observability import count as obs_count, get_logger, span

log = get_logger(__name__)

_PAD_RUN = -1


@dataclasses.dataclass
class Sketch:
    """Host-side sketch: sorted unique 128-bit keys as (n, 4) uint32 lanes."""
    keys: np.ndarray           # (count, 4) uint32, sorted ascending (128-bit)
    count: int
    window: int
    mask: SpacedSeedMask
    name: str = ""

    def keys_u64(self) -> np.ndarray:
        """(count, 2) uint64 [lo, hi] view for host-side comparisons."""
        k = self.keys.astype(np.uint64)
        lo = k[:, 0] | (k[:, 1] << np.uint64(32))
        hi = k[:, 2] | (k[:, 3] << np.uint64(32))
        return np.stack([lo, hi], axis=1)

    def save(self, path: str) -> None:
        """Sketches are the natural checkpoint artifact (SURVEY.md §5)."""
        np.savez(path, keys=self.keys, count=self.count, window=self.window,
                 mask_lo=np.uint64(self.mask.lo), mask_hi=np.uint64(self.mask.hi),
                 mask_window=self.mask.window, mask_k=self.mask.k,
                 name=np.str_(self.name))

    @staticmethod
    def load(path: str) -> "Sketch":
        z = np.load(path, allow_pickle=False)
        mask = SpacedSeedMask(window=int(z["mask_window"]), k=int(z["mask_k"]),
                              lo=int(z["mask_lo"]), hi=int(z["mask_hi"]))
        return Sketch(keys=z["keys"], count=int(z["count"]),
                      window=int(z["window"]), mask=mask, name=str(z["name"]))


def _bucket_size(n: int, quantum: int = 16384) -> int:
    """Pad host arrays to few distinct sizes to bound XLA recompiles."""
    if n <= quantum:
        return quantum
    return 1 << math.ceil(math.log2(n))


class FracMinHashSketcher:
    """One (window, k) sketching experiment on a single device.

    The multi-chip variants live in parallel/ and reuse the same device steps.
    """

    def __init__(self, config: SketchConfig, mask: Optional[SpacedSeedMask] = None):
        self.config = config
        self.mask = mask if mask is not None else spaced_seed_mask(
            config.window, config.k, config.mask_seed)
        self.salt = boosthash.fmh_salt(self.mask.lo, self.mask.hi,
                                       config.window, config.nonce,
                                       config.hash_variant)
        self._mask_words = jnp.asarray(self.mask.words_u32)

    # ---- single-genome sketching -------------------------------------------------
    def sketch_packed(self, packed: PackedSeqs, name: str = "") -> Sketch:
        return self.sketch_packed_batch([packed], names=[name])[0]

    def _dispatch_sketch(self, codes: np.ndarray, run_id: np.ndarray,
                         capacity: int):
        """Asynchronously dispatch a batch to the device (upload + enqueue);
        the heavy host work for batch N+1 then overlaps the device
        sketching of batch N (the PP analog, SURVEY.md §2.1)."""
        cfg = self.config
        from ..ops.sketch import jitted_sketch_batch
        args = (jnp.asarray(codes), jnp.asarray(run_id))

        def make(cap):
            return jitted_sketch_batch(cfg.window, self.salt, cfg.scale,
                                       cfg.hash_variant, cap)

        res = make(capacity)(*args, self._mask_words)
        return (res, args, make, capacity)

    def _collect_sketch(self, handle):
        """Force a dispatched batch, running the overflow retry if needed.
        A capacity overflow re-sketches ONLY the overflowed genomes
        (raw_kept is per-genome), so one unlucky genome does not cost a
        whole-batch retry.  Returns np (keys, counts, raws)."""
        res, args, make, capacity = handle
        raws = np.asarray(res.raw_kept)
        raw = int(raws.max())
        if raw <= capacity:
            return np.asarray(res.keys), np.asarray(res.count), raws
        keys = np.asarray(res.keys)
        counts = np.asarray(res.count)
        bad = np.nonzero(raws > capacity)[0]
        sel = tuple(a[bad] for a in args)
        while True:
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("sketch overflow: retry %d/%d genomes cap=%d",
                     bad.size, raws.shape[0], capacity)
            res2 = make(capacity)(*sel, self._mask_words)
            raws2 = np.asarray(res2.raw_kept)
            raw = int(raws2.max())
            if raw <= capacity:
                break
        keys2 = np.asarray(res2.keys)
        counts2 = np.asarray(res2.count)
        # splice the retried genomes back (keys buffer may be wider: valid
        # rows fit by construction since count <= raw_kept <= old shapes)
        for bi, gi in enumerate(bad):
            c = int(counts2[bi])
            if c > keys.shape[1]:
                pad = np.full((keys.shape[0], c - keys.shape[1], 4),
                              0xFFFFFFFF, dtype=keys.dtype)
                keys = np.concatenate([keys, pad], axis=1)
            keys[gi, :c] = keys2[bi, :c]
            keys[gi, c:] = 0xFFFFFFFF
            counts[gi] = c
            raws[gi] = raws2[bi]
        return keys, counts, raws

    def _device_sketch_batch(self, codes: np.ndarray, run_id: np.ndarray,
                             capacity: int):
        return self._collect_sketch(
            self._dispatch_sketch(codes, run_id, capacity))

    def sketch_file(self, path: str, use_native: bool = True) -> Sketch:
        packed = read_fasta(path, use_native=use_native)
        return self.sketch_packed(packed, name=path)

    def sketch_packed_multiseed(self, packed: PackedSeqs,
                                masks: Optional[Sequence[SpacedSeedMask]]
                                = None,
                                seeds: Optional[Sequence[int]] = None,
                                name: str = "") -> List[Sketch]:
        """Fused multi-seed sketching: evaluate S spaced seeds over ONE
        genome in a single device dispatch (the EP analog of SURVEY.md
        §2.1 — "experts" = seeds, all dense).

        masks: explicit seed masks (must share this sketcher's window);
        seeds: RNG seeds to generate masks from at this config's
        (window, k) — default seeds 0..7.  Returns one Sketch per seed,
        each carrying its own mask (bit-exact with sketching each mask
        separately; the reference would run its whole pipeline once per
        seed, src/kmer-sketching.cpp:163)."""
        cfg = self.config
        if masks is None:
            masks = [spaced_seed_mask(cfg.window, cfg.k, s)
                     for s in (seeds if seeds is not None else range(8))]
        for m in masks:
            if m.window != cfg.window:
                raise ValueError(f"mask window {m.window} != config "
                                 f"window {cfg.window}")
        from ..ops import u64ops
        from ..ops.sketch import sketch_from_codes_multiseed

        salts = [boosthash.fmh_salt(m.lo, m.hi, cfg.window, cfg.nonce,
                                    cfg.hash_variant) for m in masks]
        nw = packed.total_windows(cfg.window)
        if nw <= 0:
            return [Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                           window=cfg.window, mask=m, name=name)
                    for m in masks]
        masks_w = jnp.asarray(np.stack([m.words_u32 for m in masks]))
        salt_pairs = jnp.asarray(np.stack([u64ops.salt_pair(s)
                                           for s in salts]))
        n = _bucket_size(int(packed.codes.size) + cfg.window)
        codes = np.zeros(n, np.uint32)
        codes[:packed.codes.size] = packed.codes
        rid = np.full(n, _PAD_RUN, np.int32)
        pos = 0
        for r, ln in enumerate(packed.run_lens):
            rid[pos:pos + int(ln)] = r
            pos += int(ln)
        dc, dr = jnp.asarray(codes), jnp.asarray(rid)
        capacity = cfg.capacity_for(nw)
        while True:
            out = sketch_from_codes_multiseed(
                dc, dr, masks_w, salt_pairs, window=cfg.window,
                scale=cfg.scale, variant=cfg.hash_variant,
                capacity=capacity)
            raw = int(np.asarray(out.raw_kept).max())
            if raw <= capacity:
                break
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("multiseed overflow: retry cap=%d", capacity)
        keys = np.asarray(out.keys)
        counts = np.asarray(out.count)
        return [Sketch(keys=keys[i, :int(counts[i])].copy(),
                       count=int(counts[i]), window=cfg.window,
                       mask=masks[i], name=name)
                for i in range(len(masks))]

    def sketch_file_streaming(self, path: str, segment_nt: int = 1 << 24,
                              name: str = "") -> Sketch:
        """Bounded-memory sketch of an arbitrarily large FASTA: the native
        two-pass streaming parser yields `segment_nt`-code chunks; each
        chunk is sketched on device with a (window-1)-code carry so windows
        spanning chunk boundaries are counted exactly once, and per-chunk
        sketches fold into the accumulator with merge_sketches.  Bit-exact
        with sketch_file: peak host memory is O(segment_nt + sketch), never
        O(genome) (SURVEY.md §2.2 item 1; the reference loads whole files,
        fasta_processing.cpp:208-211)."""
        from collections import deque

        from ..ops.sketch import jitted_merge_sketches

        cfg = self.config
        w = cfg.window
        carry_codes = np.empty(0, np.uint8)
        carry_rid = np.empty(0, np.int32)
        cur_run = 0          # id of the run open at the current position
        prev_open = True     # position 0 starts run id 0
        pending = deque()    # dispatched, not yet collected (pipeline)
        seg_bufs = []        # DEVICE (cap_i, 4) sentinel-padded buffers
        seg_counts = []

        def drain_one():
            keys_dev, count = self._collect_sketch_device(pending.popleft())
            if count:
                seg_bufs.append(keys_dev[0])
                seg_counts.append(count)

        for codes, run_ends, open_run in native.fasta_stream(path,
                                                             segment_nt):
            n = codes.size
            if not prev_open:
                cur_run += 1
            b = np.concatenate([[0], run_ends, [n]]).astype(np.int64)
            rid = (cur_run + np.repeat(np.arange(len(b) - 1),
                                       np.diff(b))).astype(np.int32)
            cur_run += len(run_ends)
            prev_open = open_run

            seg_codes = np.concatenate([carry_codes, codes])  # stays uint8
            seg_rid = np.concatenate([carry_rid, rid])
            if w > 1:
                carry_codes = seg_codes[-(w - 1):]
                carry_rid = seg_rid[-(w - 1):]

            handle = self._sketch_arrays_handle(seg_codes, seg_rid)
            if handle is None:
                continue
            pending.append(handle)
            if len(pending) >= 2:
                # collect the older dispatch while the newer one (already
                # enqueued, async) executes and the host parses onward —
                # the PP-style ingest/compute overlap of SURVEY.md §2.1
                drain_one()
        while pending:
            drain_one()

        if not seg_bufs:
            return Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                          window=w, mask=self.mask, name=name)
        if len(seg_bufs) == 1:
            cnt = seg_counts[0]
            return Sketch(keys=np.asarray(seg_bufs[0][:cnt]), count=cnt,
                          window=w, mask=self.mask, name=name)

        # one jitted on-device merge of all per-segment sketches: buffers
        # are cut to a common power-of-two >= every count so the stacked
        # sort does not spend its work on sentinel fill, and the SEGMENT
        # axis pads to a power of two with empty sketches so files of
        # different lengths share few merge programs
        total = int(sum(seg_counts))
        capm = max(256, _next_pow2(total))
        cut = max(256, _next_pow2(max(seg_counts)))
        s2 = _next_pow2(len(seg_bufs))

        def fit(x):
            if x.shape[0] >= cut:
                return x[:cut]            # valid rows <= count <= cut
            pad = jnp.full((cut - x.shape[0], 4), 0xFFFFFFFF, jnp.uint32)
            return jnp.concatenate([x, pad])

        stack = [fit(b) for b in seg_bufs]
        stack += [jnp.full((cut, 4), 0xFFFFFFFF, jnp.uint32)] * (
            s2 - len(seg_bufs))
        counts_all = np.zeros(s2, np.int32)
        counts_all[:len(seg_counts)] = seg_counts
        merged = jitted_merge_sketches(capm)(
            jnp.stack(stack), jnp.asarray(counts_all))
        acc_count = int(merged.count)
        return Sketch(keys=np.asarray(merged.keys[:acc_count]),
                      count=acc_count, window=w, mask=self.mask, name=name)

    _COMPACT_MAX_RUNS = 64
    _STREAM_THRESHOLD_BYTES = 1 << 28    # files past ~256M nt stream

    def _sketch_arrays_handle(self, codes: np.ndarray, run_id: np.ndarray):
        """Dispatch prebuilt code/run-id arrays; returns a handle for
        _collect_sketch[_device], or None when no window fits.

        Arrays with few consecutive runs (the streaming-segment shape) take
        the compact upload: native 2-bit pack + run starts, expanded on
        device (ops/sketch.sketch_batch_compact) — 0.25 B/nt crosses the
        host boundary instead of the 8 B/nt of uint32 codes + int32 run
        ids."""

        cfg = self.config
        nw = codes.size - cfg.window + 1
        if nw <= 0:
            return None
        n = _bucket_size(codes.size + cfg.window)
        capacity = cfg.capacity_for(nw)
        starts = np.nonzero(np.diff(run_id) != 0)[0] + 1
        consecutive = (starts.size <= self._COMPACT_MAX_RUNS
                       and bool(np.all(
                           run_id[starts] == int(run_id[0]) + 1
                           + np.arange(starts.size))))
        if consecutive:
            return self._dispatch_sketch_compact(
                codes, starts, int(run_id[0]), n, capacity)
        cbuf = np.zeros((1, n), np.uint32)
        cbuf[0, :codes.size] = codes
        rbuf = np.full((1, n), _PAD_RUN, np.int32)
        rbuf[0, :run_id.size] = run_id
        return self._dispatch_sketch(cbuf, rbuf, capacity)

    def _collect_sketch_device(self, handle):
        """Force a dispatched single-genome batch but keep the keys ON
        DEVICE (only raw_kept/count scalars cross the host boundary) — the
        streaming accumulator merges on device, so per-segment key arrays
        are never downloaded and re-uploaded.
        Returns (keys (1, cap, 4) device, count int)."""
        res, args, make, capacity = handle
        raw = int(np.asarray(res.raw_kept).max())
        while raw > capacity:
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("sketch overflow: retry cap=%d", capacity)
            res = make(capacity)(*args, self._mask_words)
            raw = int(np.asarray(res.raw_kept).max())
        return res.keys, int(np.asarray(res.count)[0])

    def _dispatch_sketch_compact(self, codes: np.ndarray,
                                 starts: np.ndarray, rid0: int, n: int,
                                 capacity: int):
        """Compact-upload dispatch: one raw-packed code plane + run-start
        positions; complement/reverse/window expansion happens on device
        (ops/sketch.sketch_batch_compact)."""
        from ..ops.sketch import jitted_sketch_batch_compact, packed_body

        cfg = self.config
        body = packed_body(n)
        p = native.pack2bit(codes.astype(np.uint8, copy=False),
                            body // 16)[None]
        b = np.full((1, self._COMPACT_MAX_RUNS), body, np.int32)
        b[0, :starts.size] = starts
        args = (jnp.asarray(p), jnp.asarray(b),
                jnp.asarray(np.array([rid0], np.int32)),
                jnp.asarray(np.array([codes.size], np.int32)))

        def make(cap):
            return jitted_sketch_batch_compact(
                n, cfg.window, self.salt, cfg.scale, cfg.hash_variant, cap)

        return (make(capacity)(*args, self._mask_words), args, make,
                capacity)

    def sketch_files(self, paths: Sequence[str], max_workers: int = 8,
                     on_error: str = "raise") -> List[Sketch]:
        """Genome-level data parallelism: host threads parse/pack while the
        chip sketches (replaces the reference's cilk_for over files,
        src/kmer_set.cpp:124); genomes sharing a padded shape go through the
        device in one batched dispatch.

        on_error: 'raise' mirrors the reference (a bad file kills the run,
        fasta_processing.cpp:86-90); 'skip' isolates per-genome ingest
        failures to an empty sketch + error log (SURVEY.md §5).

        Files past _STREAM_THRESHOLD_BYTES (eukaryote-scale, BASELINE
        config 5) route through sketch_file_streaming automatically:
        bounded host memory and the compact-upload device path instead of
        a whole-genome resident parse."""
        import os as _os

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

        def _read(p):
            try:
                return read_fasta(p)
            except Exception:
                if on_error == "raise":
                    raise
                log.exception("skipping unreadable genome %s", p)
                return PackedSeqs(codes=np.empty(0, np.uint8),
                                  run_lens=np.empty(0, np.int64))

        def _empty(name):
            return Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                          window=self.config.window, mask=self.mask,
                          name=name)

        with span("sketching", log):
            streamed = {}
            for p in sorted(big):
                try:
                    streamed[p] = self.sketch_file_streaming(p, name=p)
                except Exception:
                    if on_error == "raise":
                        raise
                    log.exception("skipping unreadable genome %s", p)
                    streamed[p] = _empty(p)
            small = [p for p in paths if p not in big]
            packed = {}
            with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
                for p, pk in zip(small, ex.map(_read, small)):
                    packed[p] = pk
            sketched = iter(self.sketch_packed_batch(
                [packed[p] for p in small], names=small))
            return [streamed[p] if p in big else next(sketched)
                    for p in paths]

    def sketch_packed_batch(self, packed_list: Sequence[PackedSeqs],
                            names: Optional[Sequence[str]] = None
                            ) -> List[Sketch]:
        """Sketch many genomes, batching same-shaped ones per dispatch."""
        cfg = self.config
        names = names or [""] * len(packed_list)
        out: List[Optional[Sketch]] = [None] * len(packed_list)
        groups = {}
        for i, pk in enumerate(packed_list):
            nwin = pk.total_windows(cfg.window)
            if nwin <= 0:
                out[i] = Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                                window=cfg.window, mask=self.mask,
                                name=names[i])
                continue
            n = _bucket_size(int(pk.codes.size) + cfg.window)
            groups.setdefault(n, []).append((i, pk, nwin))

        # double-buffered dispatch: host-pack chunk k+1 while the device
        # sketches chunk k (dispatch is async; collect forces completion)
        chunk_g = 8
        chunks = []
        for n, members in groups.items():
            for off in range(0, len(members), chunk_g):
                chunks.append((n, members[off:off + chunk_g]))

        def finalize(pending):
            members, handle = pending
            keys, counts, raws = self._collect_sketch(handle)
            for j, (i, pk, nw) in enumerate(members):
                c = int(counts[j])
                out[i] = Sketch(keys=keys[j, :c].copy(), count=c,
                                window=cfg.window, mask=self.mask,
                                name=names[i])
                # parity-check counters (SURVEY.md §5)
                obs_count("runs", int(pk.run_lens.size))
                obs_count("windows", nw)
                obs_count("kept_kmers", int(raws[j]))
                obs_count("unique_kmers", c)
            obs_count("genomes", len(members))

        pending = None
        for n, members in chunks:
            g = len(members)
            codes = np.zeros((g, n), dtype=np.uint32)
            run_id = np.full((g, n), _PAD_RUN, dtype=np.int32)
            for j, (_, pk, _) in enumerate(members):
                t = pk.codes.size
                codes[j, :t] = pk.codes
                pos = 0
                for rid, ln in enumerate(pk.run_lens):
                    run_id[j, pos:pos + int(ln)] = rid
                    pos += int(ln)
            capacity = max(cfg.capacity_for(nw) for _, _, nw in members)
            handle = self._dispatch_sketch(codes, run_id, capacity)
            if pending is not None:
                finalize(pending)
            pending = (members, handle)
        if pending is not None:
            finalize(pending)
        return out  # type: ignore[return-value]

    # ---- pairwise / all-pairs ANI ------------------------------------------------
    def stack_sketches(self, sketches: Sequence[Sketch], cap: Optional[int] = None):
        caps = [s.count for s in sketches]
        cap = cap or max(1, _next_pow2(max(caps) if caps else 1))
        keys = np.full((len(sketches), cap, 4), 0xFFFFFFFF, dtype=np.uint32)
        counts = np.zeros(len(sketches), dtype=np.int32)
        for i, s in enumerate(sketches):
            keys[i, :s.count] = s.keys
            counts[i] = s.count
        return jnp.asarray(keys), jnp.asarray(counts)

    def intersections(self, sketches_a: Sequence[Sketch],
                      sketches_b: Sequence[Sketch]) -> np.ndarray:
        """Pairwise |A_i ∩ B_i| for two equal-length sketch lists
        (reference kmer_set.cpp:143-184 incl. its length-mismatch error)."""
        if len(sketches_a) != len(sketches_b):
            raise ValueError("Mismatched pair-list lengths")
        cap = max(1, _next_pow2(max([s.count for s in sketches_a + list(sketches_b)]
                                    or [1])))
        ka, ca = self.stack_sketches(sketches_a, cap)
        kb, cb = self.stack_sketches(sketches_b, cap)
        from ..ops.intersect import pair_intersection_batch
        return np.asarray(pair_intersection_batch(ka, ca, kb, cb))

    #: collections above this many genomes use the memory-bounded blocked
    #: schedule instead of one whole-collection on-device Gram
    _ONDEVICE_GRAM_MAX_GENOMES = 2048

    def all_pairs_intersections(self, sketches: Sequence[Sketch],
                                tile: int = 64) -> np.ndarray:
        """(G, G) intersection matrix via the on-device Gram formulation
        (ops/gram.py): sort of packed (key, genome) pairs + chunked
        S^T E S matrix products, exact.  Up to _ONDEVICE_GRAM_MAX_GENOMES
        genomes run as one program; larger collections take the
        memory-bounded block-cache schedule (parallel/allpairs.
        blocked_all_pairs).  No path builds the host rank layout, whose
        (union keys x G/32) bitmap outgrows host memory at scale.  `tile`
        is kept for the probe engine (all_pairs_intersections_probe)."""
        from ..ops.gram import gram_all_pairs_ondevice, key_words_for_window
        g = len(sketches)
        if g <= 8 and native.available():
            # tiny collections: the native sorted-merge on the already-
            # downloaded sketches beats a device dispatch round-trip
            # (the reference's own per-pair scale, src/kmer_set.cpp:23-41)
            u64s = [s.keys_u64() for s in sketches]
            out = np.zeros((g, g), np.int32)
            for i in range(g):
                out[i, i] = sketches[i].count
                for j in range(i + 1, g):
                    out[i, j] = out[j, i] = native.intersect_sorted(
                        u64s[i], u64s[j])
            return out
        # the packed presort planes are 128 keys wide
        cap = max(128, _next_pow2(max([s.count for s in sketches] or [1])))
        keys_np = np.full((g, cap, 4), 0xFFFFFFFF, dtype=np.uint32)
        counts_np = np.zeros(g, dtype=np.int32)
        for i, s in enumerate(sketches):
            keys_np[i, :s.count] = s.keys
            counts_np[i] = s.count
        key_words = key_words_for_window(self.config.window)
        key_bits = 2 * self.config.window
        if g <= self._ONDEVICE_GRAM_MAX_GENOMES:
            return np.asarray(gram_all_pairs_ondevice(
                jnp.asarray(keys_np), jnp.asarray(counts_np),
                key_words=key_words, key_bits=key_bits))
        # One device: the schedule replicates its cache per device;
        # multi-device users call blocked_all_pairs with their mesh
        # directly.
        from ..parallel.allpairs import blocked_all_pairs
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(devices=jax.devices()[:1])
        return blocked_all_pairs(mesh, keys_np, counts_np, block=128,
                                 key_words=key_words, key_bits=key_bits)

    def all_pairs_intersections_probe(self, sketches: Sequence[Sketch],
                                      tile: int = 64) -> np.ndarray:
        """(G, G) matrix via the batched binary-search probe — kept as the
        gather-based cross-check engine (tests compare it to gram)."""
        g = len(sketches)
        cap = max(1, _next_pow2(max([s.count for s in sketches] or [1])))
        keys, counts = self.stack_sketches(sketches, cap)
        out = np.zeros((g, g), dtype=np.int32)
        for r0 in range(0, g, tile):
            r1 = min(r0 + tile, g)
            for c0 in range(0, g, tile):
                c1 = min(c0 + tile, g)
                out[r0:r1, c0:c1] = np.asarray(intersection_tile(
                    keys[r0:r1], counts[r0:r1], keys[c0:c1], counts[c0:c1]))
        return out

    def ani_from_intersections(self, inter: np.ndarray,
                               counts_first: np.ndarray) -> np.ndarray:
        """containment uses the FIRST set of the ordered pair as denominator
        (src/kmer-sketching.cpp:198); ANI = containment^(1/k) with k = care
        positions (mask.count()/2, src/kmer-sketching.cpp:164)."""
        c = containment(inter, counts_first)
        return binomial_estimator(c, self.mask.care_positions)


def _next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(n, 1))))
