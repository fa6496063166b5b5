"""ctypes loader/builder for the native host runtime (native/sketchlib.cpp).

The shared library is built lazily with the system g++ and cached next to the
source; everything in the framework that uses it has a pure-Python fallback,
so the package works (more slowly) without a toolchain.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "sketchlib.cpp"
_BUILD_DIR = _REPO / "native" / "build"
_SO = _BUILD_DIR / "libsketch.so"

_lock = threading.Lock()
_lib = None
_load_failed = False


def _build() -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [
        "g++", "-O3", "-std=c++20", "-shared", "-fPIC", "-Wall", "-pthread",
        str(_SRC), "-o", str(_SO),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def get_lib():
    """Return the loaded ctypes library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        stale = (not _SO.exists()
                 or _SO.stat().st_mtime < _SRC.stat().st_mtime)
        if stale and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            _load_failed = True
            return None
        _declare(lib)
        _lib = lib
    return _lib


def _declare(lib):
    c = ctypes
    lib.skt_mask_indices.restype = c.c_int
    lib.skt_mask_indices.argtypes = [c.c_int, c.c_int, c.c_uint64, c.POINTER(c.c_int32)]
    lib.skt_hash_bitset128.restype = c.c_uint64
    lib.skt_hash_bitset128.argtypes = [c.c_uint64, c.c_uint64, c.c_int]
    lib.skt_hash_bitset128_batch.restype = None
    lib.skt_hash_bitset128_batch.argtypes = [
        c.POINTER(c.c_uint64), c.POINTER(c.c_uint64), c.c_int64, c.c_int,
        c.POINTER(c.c_uint64)]
    lib.skt_fasta_open.restype = c.c_void_p
    lib.skt_fasta_open.argtypes = [c.c_char_p]
    lib.skt_fasta_total_codes.restype = c.c_int64
    lib.skt_fasta_total_codes.argtypes = [c.c_void_p]
    lib.skt_fasta_num_runs.restype = c.c_int64
    lib.skt_fasta_num_runs.argtypes = [c.c_void_p]
    lib.skt_fasta_copy.restype = None
    lib.skt_fasta_copy.argtypes = [c.c_void_p, c.POINTER(c.c_uint8), c.POINTER(c.c_int64)]
    lib.skt_fasta_close.restype = None
    lib.skt_fasta_close.argtypes = [c.c_void_p]
    lib.skt_sketch_codes.restype = c.c_int64
    lib.skt_sketch_codes.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.c_int64), c.c_int64,
        c.c_uint64, c.c_uint64, c.c_int,
        c.c_uint64, c.c_uint64, c.c_int,
        c.POINTER(c.c_uint64), c.c_int64]
    lib.skt_pack_keys_tight.restype = None
    lib.skt_pack_keys_tight.argtypes = [
        c.POINTER(c.c_uint32), c.POINTER(c.c_int32), c.c_int64, c.c_int64,
        c.c_int, c.c_int, c.POINTER(c.c_uint32)]
    lib.skt_intersect_sorted.restype = c.c_int64
    lib.skt_intersect_sorted.argtypes = [
        c.POINTER(c.c_uint64), c.c_int64, c.POINTER(c.c_uint64), c.c_int64]
    lib.skt_fasta_stream_open.restype = c.c_void_p
    lib.skt_fasta_stream_open.argtypes = [c.c_char_p]
    lib.skt_fasta_stream_next.restype = c.c_int64
    lib.skt_fasta_stream_next.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_int)]
    lib.skt_fasta_stream_close.restype = None
    lib.skt_fasta_stream_close.argtypes = [c.c_void_p]
    lib.skt_sketch_batch_mt.restype = None
    lib.skt_sketch_batch_mt.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.c_int,
        c.c_uint64, c.c_uint64, c.c_int,
        c.c_uint64, c.c_uint64, c.c_int,
        c.c_int, c.POINTER(c.c_int64)]
    lib.skt_pack2bit.restype = None
    lib.skt_pack2bit.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.c_int64, c.POINTER(c.c_uint32)]


def available() -> bool:
    return get_lib() is not None


# --- typed convenience wrappers -------------------------------------------------

def mask_indices(window: int, k: int, seed: int):
    """First k entries of shuffle(iota(window), mt19937(seed)) — or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(k, dtype=np.int32)
    rc = lib.skt_mask_indices(window, k, seed,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"skt_mask_indices failed for window={window} k={k}")
    return out


def hash_bitset128_batch(lo: np.ndarray, hi: np.ndarray, legacy: bool) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    out = np.empty_like(lo)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.skt_hash_bitset128_batch(lo.ctypes.data_as(u64p), hi.ctypes.data_as(u64p),
                                 lo.size, int(legacy), out.ctypes.data_as(u64p))
    return out


def fasta_parse(path: str):
    """Parse a FASTA file -> (codes uint8 array, run_lens int64 array), or None."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.skt_fasta_open(os.fsencode(path))
    if not h:
        raise FileNotFoundError(f"Unable to open {path}")
    try:
        n_codes = lib.skt_fasta_total_codes(h)
        n_runs = lib.skt_fasta_num_runs(h)
        codes = np.empty(max(n_codes, 1), dtype=np.uint8)
        run_lens = np.empty(max(n_runs, 1), dtype=np.int64)
        lib.skt_fasta_copy(h, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           run_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return codes[:n_codes], run_lens[:n_runs]
    finally:
        lib.skt_fasta_close(h)


def sketch_codes(codes: np.ndarray, run_lens: np.ndarray, mask_lo: int, mask_hi: int,
                 window: int, salt: int, scale: int, legacy: bool) -> np.ndarray:
    """Scalar CPU sketch -> sorted unique (n,2) uint64 [lo,hi] key array."""
    lib = get_lib()
    assert lib is not None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    run_lens = np.ascontiguousarray(run_lens, dtype=np.int64)
    total_windows = int(np.maximum(run_lens - window + 1, 0).sum())
    cap = max(64, total_windows // max(int(scale), 1) * 4 + 1024)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    while True:
        out = np.empty((cap, 2), dtype=np.uint64)
        n = lib.skt_sketch_codes(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            run_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), run_lens.size,
            np.uint64(mask_lo), np.uint64(mask_hi), window,
            np.uint64(salt), np.uint64(scale), int(legacy),
            out.ctypes.data_as(u64p), cap)
        if n >= 0:
            return out[:n]
        cap = -n


def fasta_stream(path: str, chunk_nt: int):
    """Generator over a FASTA file in bounded memory: yields
    (codes uint8 (n,), run_ends int64 (k,), open_run bool) chunks with the
    reference's exact record semantics (two-pass native parse; the
    space-discard quirk is retroactive, so line structure is scanned before
    any codes stream).  run_ends are exclusive code indices within the
    chunk; open_run means the last run continues into the next chunk."""
    lib = get_lib()
    assert lib is not None
    h = lib.skt_fasta_stream_open(str(path).encode())
    if not h:
        raise FileNotFoundError(f"Unable to open {path}")
    try:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        while True:
            codes = np.empty(chunk_nt, dtype=np.uint8)
            run_ends = np.empty(chunk_nt + 1, dtype=np.int64)
            n_ends = ctypes.c_int64(0)
            open_run = ctypes.c_int(0)
            n = lib.skt_fasta_stream_next(
                h, codes.ctypes.data_as(u8p), np.int64(chunk_nt),
                run_ends.ctypes.data_as(i64p), ctypes.byref(n_ends),
                ctypes.byref(open_run))
            if n <= 0:
                break
            yield (codes[:n], run_ends[:n_ends.value].copy(),
                   bool(open_run.value))
    finally:
        lib.skt_fasta_stream_close(h)


def sketch_batch_mt(codes: np.ndarray, mask_lo: int, mask_hi: int,
                    window: int, salt: int, scale: int, legacy: bool,
                    nthreads: int) -> np.ndarray:
    """Multi-threaded whole-host baseline: sketch a (G, n) single-run batch
    with `nthreads` std::threads over genomes (the reference's cilk_for over
    files, kmer_set.cpp:124).  Returns per-genome unique counts."""
    lib = get_lib()
    assert lib is not None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    g, n = codes.shape
    counts = np.zeros(g, dtype=np.int64)
    lib.skt_sketch_batch_mt(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int64(n), int(g), np.uint64(mask_lo), np.uint64(mask_hi),
        int(window), np.uint64(salt), np.uint64(scale), int(legacy),
        int(nthreads), counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return counts


def pack2bit(codes: np.ndarray, n_words: int) -> np.ndarray:
    """Pack codes (n,) uint8 values 0..3 into n_words uint32, 16 codes per
    word LSB-first, positions past n as code 0 — the compact upload plane
    for the device-side expansion path (ops/sketch.sketch_batch_compact)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if lib is None:
        c = np.zeros(16 * n_words, np.uint32)
        m = min(codes.size, c.size)
        c[:m] = codes[:m] & 3
        shifts = 2 * np.arange(16, dtype=np.uint32)
        return np.bitwise_or.reduce(c.reshape(n_words, 16) << shifts, axis=1)
    out = np.empty(n_words, dtype=np.uint32)
    lib.skt_pack2bit(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int64(codes.shape[0]), np.int64(n_words),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def pack_keys_tight(keys: np.ndarray, counts: np.ndarray,
                    key_bits: int) -> np.ndarray:
    """Bit-tight pack of (g, cap, kw) uint32 sketch keys into
    (g, cap/4, ceil(4*key_bits/32)) uint32 — see ops/gram tight
    transport; entries at/past counts pack as 0."""
    lib = get_lib()
    assert lib is not None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    g, cap, kw = keys.shape
    assert cap % 4 == 0
    w4 = (4 * key_bits + 31) // 32
    out = np.zeros((g, cap // 4, w4), np.uint32)
    lib.skt_pack_keys_tight(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int64(g), np.int64(cap), int(kw), int(key_bits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> int:
    lib = get_lib()
    assert lib is not None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    return lib.skt_intersect_sorted(a.ctypes.data_as(u64p), a.shape[0],
                                    b.ctypes.data_as(u64p), b.shape[0])
