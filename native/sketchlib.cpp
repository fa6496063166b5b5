// sketchlib.cpp — native host runtime for the spaced-kmer-sketching framework.
//
// Provides (via a plain C ABI for ctypes):
//   * spaced-seed mask generation using the real libstdc++ std::mt19937 +
//     std::shuffle (the reference uses exactly this, src/kmer_bitset.cpp:132-152,
//     so linking against libstdc++ gives bit-exact masks by construction);
//   * boost-container_hash-compatible hashing of 128-bit keys (both the
//     >=1.81 "modern" hash_mix chain and the <1.81 murmur-style combine),
//     reimplemented from the documented algorithms — used to cross-check the
//     numpy and on-chip implementations;
//   * a FASTA parser + 2-bit packer replicating the reference's record
//     semantics (src/fasta_processing.cpp:79-198), including the quirks:
//     a sequence line containing a space discards the current record, and a
//     blank line flushes the current record while keeping its name;
//   * a fast scalar CPU sketching pipeline over unsigned __int128 windows —
//     our own formulation of the reference semantics (dual-strand windows,
//     same mask on both strands, canonical = numerically smaller masked
//     value; src/kmer_sliding.cpp:112-186) — used as the CPU baseline for
//     bench.py and as a second oracle for tests.
//
// Build: g++ -O3 -std=c++20 -shared -fPIC sketchlib.cpp -o libsketch.so
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <numeric>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Spaced-seed mask generation (bit-exact with the reference via libstdc++).
// Writes the first `k` entries of shuffle(iota(window), mt19937(seed)).
// Returns 0 on success, -1 on bad arguments.
int skt_mask_indices(int window, int k, uint64_t seed, int32_t* out) {
    if (window <= 0 || k <= 0 || k > window || !out) return -1;
    std::vector<int> idx(window);
    std::iota(idx.begin(), idx.end(), 0);
    std::shuffle(idx.begin(), idx.end(), std::mt19937(seed));
    for (int i = 0; i < k; ++i) out[i] = idx[i];
    return 0;
}

// ---------------------------------------------------------------------------
// Boost-compatible hashing.
static inline uint64_t hash_mix(uint64_t x) {  // boost >=1.81 hash_detail::hash_mix
    const uint64_t m = 0x0e9846af9b1a615dULL;
    x ^= x >> 32; x *= m; x ^= x >> 32; x *= m; x ^= x >> 28;
    return x;
}
static inline uint64_t combine_modern(uint64_t seed, uint64_t v) {
    return hash_mix(seed + 0x9e3779b9ULL + v);
}
static inline uint64_t combine_legacy(uint64_t h, uint64_t k) {  // boost <1.81 impl<64>
    const uint64_t m = 0xc6a4a7935bd1e995ULL;
    k *= m; k ^= k >> 47; k *= m;
    h ^= k; h *= m; h += 0xe6546b64ULL;
    return h;
}
static inline uint64_t hash_bitset128(uint64_t lo, uint64_t hi, int legacy) {
    // boost::hash_value(dynamic_bitset): res = hash(size=128); combine(res, blocks)
    if (legacy) {
        uint64_t inner = combine_legacy(combine_legacy(0, lo), hi);
        return combine_legacy(128, inner);
    }
    uint64_t inner = combine_modern(combine_modern(0, lo), hi);
    return combine_modern(128, inner);
}

uint64_t skt_hash_bitset128(uint64_t lo, uint64_t hi, int legacy) {
    return hash_bitset128(lo, hi, legacy);
}

// Vectorized version for cross-checking arrays of keys.
void skt_hash_bitset128_batch(const uint64_t* lo, const uint64_t* hi, int64_t n,
                              int legacy, uint64_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = hash_bitset128(lo[i], hi[i], legacy);
}

// ---------------------------------------------------------------------------
// FASTA ingest: parse records with the reference's exact line semantics, then
// split into maximal ACGT runs of 2-bit codes.
struct FastaHandle {
    std::vector<uint8_t> codes;     // concatenated 2-bit codes of all runs
    std::vector<int64_t> run_lens;  // length of each ACGT run
};

static inline int code_of(char c) {
    switch (c) {
        case 'a': case 'A': return 0;
        case 'c': case 'C': return 1;
        case 'g': case 'G': return 2;
        case 't': case 'T': return 3;
        default: return 4;
    }
}

static void cut_runs(const std::string& record, FastaHandle* h) {
    int64_t cur = 0;
    for (char c : record) {
        int v = code_of(c);
        if (v & 4) {
            if (cur) { h->run_lens.push_back(cur); cur = 0; }
        } else {
            h->codes.push_back(static_cast<uint8_t>(v));
            ++cur;
        }
    }
    if (cur) h->run_lens.push_back(cur);
}

void* skt_fasta_open(const char* path) {
    std::ifstream f(path);
    if (!f.good()) return nullptr;
    auto* h = new FastaHandle();
    std::string line, name, content;
    auto flush = [&]() {
        if (!name.empty()) cut_runs(content, h);
    };
    while (std::getline(f, line)) {   // splits on '\n' only; '\r' survives as non-ACGT
        if (line.empty() || line[0] == '>') {
            flush();
            if (!line.empty()) name = line.substr(1);
            content.clear();
        } else if (!name.empty()) {
            if (line.find(' ') != std::string::npos) {
                // reference quirk: a sequence line containing a space discards
                // the whole current record (src/fasta_processing.cpp:114-118)
                name.clear();
                content.clear();
            } else {
                content += line;
            }
        }
    }
    flush();
    return h;
}

int64_t skt_fasta_total_codes(void* vh) { return static_cast<FastaHandle*>(vh)->codes.size(); }
int64_t skt_fasta_num_runs(void* vh) { return static_cast<FastaHandle*>(vh)->run_lens.size(); }
void skt_fasta_copy(void* vh, uint8_t* codes_out, int64_t* run_lens_out) {
    auto* h = static_cast<FastaHandle*>(vh);
    if (codes_out && !h->codes.empty())
        std::memcpy(codes_out, h->codes.data(), h->codes.size());
    if (run_lens_out && !h->run_lens.empty())
        std::memcpy(run_lens_out, h->run_lens.data(), h->run_lens.size() * sizeof(int64_t));
}
void skt_fasta_close(void* vh) { delete static_cast<FastaHandle*>(vh); }

// ---------------------------------------------------------------------------
// Streaming FASTA ingest for eukaryote-scale files: bounded memory, exact
// parity with the whole-file parser above (same record quirks).
//
// The space-discard quirk (fasta_processing.cpp:114-118) is RETROACTIVE — a
// space on line N kills codes already seen for the record — so streaming is
// two-pass: pass 1 scans line structure only and records the byte region of
// every emitted string (each string's content lines are one contiguous byte
// range: any delimiter line would have ended the string there); pass 2
// streams codes out of those regions, splitting runs at non-ACGT bytes and
// at string boundaries, '\n' excluded ('\r' kept: it is a run splitter).
struct StreamHandle {
    std::ifstream f;
    std::vector<std::pair<int64_t, int64_t>> regions;  // [start, end) bytes
    size_t ri = 0;
    int64_t off = 0;        // current byte offset within regions[ri]
    int64_t run_open = 0;   // length of the run continuing across next()
    std::vector<char> buf;
};

void* skt_fasta_stream_open(const char* path) {
    std::ifstream f(path, std::ios::binary);
    if (!f.good()) return nullptr;
    auto* h = new StreamHandle();

    // pass 1: line scan.  Track per-line: start, has_space, first char.
    bool have_name = false;          // a record header is active
    int64_t str_start = -1;          // current string's first content byte
    int64_t str_end = -1;            // one past the last content byte
    std::vector<char> buf(1 << 20);
    int64_t pos = 0;                 // file offset of next unread byte
    int64_t line_start = 0;
    bool line_has_space = false, line_any = false;
    char first_char = 0;
    auto end_line = [&](int64_t nl_pos) {
        const bool empty = nl_pos == line_start;
        if (empty || first_char == '>') {
            if (have_name && str_start >= 0) {
                h->regions.emplace_back(str_start, str_end);
            }
            if (!empty)                      // header: name = substr(1),
                have_name = nl_pos - line_start > 1;  // bare '>' -> empty name
            str_start = str_end = -1;
        } else if (have_name) {
            if (line_has_space) {
                have_name = false;          // discard record
                str_start = str_end = -1;
            } else {
                if (str_start < 0) str_start = line_start;
                str_end = nl_pos;           // content incl. any '\r'
            }
        }
        line_start = nl_pos + 1;
        line_has_space = false;
        line_any = false;
        first_char = 0;
    };
    while (f) {
        f.read(buf.data(), buf.size());
        const int64_t got = f.gcount();
        for (int64_t i = 0; i < got; ++i) {
            const char c = buf[i];
            if (c == '\n') {
                end_line(pos + i);
            } else {
                if (!line_any) { first_char = c; line_any = true; }
                if (c == ' ') line_has_space = true;
            }
        }
        pos += got;
    }
    if (line_start < pos) end_line(pos);     // final line without newline
    if (have_name && str_start >= 0)
        h->regions.emplace_back(str_start, str_end);

    h->f.open(path, std::ios::binary);
    h->buf.resize(1 << 20);
    return h;
}

// Fill `codes` with up to `cap` 2-bit codes.  Records each run END as an
// exclusive code index in run_ends (zero-length runs never emitted).  Sets
// *open_run when the final code's run continues into the next call.
// Returns the number of codes written (0 = end of stream).
int64_t skt_fasta_stream_next(void* vh, uint8_t* codes, int64_t cap,
                              int64_t* run_ends, int64_t* n_run_ends,
                              int* open_run) {
    auto* h = static_cast<StreamHandle*>(vh);
    int64_t n = 0, ends = 0;
    while (n < cap && h->ri < h->regions.size()) {
        const auto [rs, re] = h->regions[h->ri];
        int64_t p = rs + h->off;
        while (p < re && n < cap) {
            const int64_t want = std::min<int64_t>(re - p,
                                                   (int64_t)h->buf.size());
            h->f.seekg(p);
            h->f.read(h->buf.data(), want);
            const int64_t got = h->f.gcount();
            if (got <= 0) break;
            for (int64_t i = 0; i < got && n < cap; ++i) {
                const char c = h->buf[i];
                if (c == '\n') { ++p; continue; }
                const int v = code_of(c);
                if (v & 4) {
                    if (h->run_open) { run_ends[ends++] = n; h->run_open = 0; }
                } else {
                    codes[n++] = static_cast<uint8_t>(v);
                    ++h->run_open;
                }
                ++p;
            }
        }
        h->off = p - rs;
        if (p >= re) {                 // string boundary: close the run
            if (h->run_open) { run_ends[ends++] = n; h->run_open = 0; }
            ++h->ri;
            h->off = 0;
        }
    }
    *n_run_ends = ends;
    *open_run = h->run_open > 0 ? 1 : 0;
    return n;
}

void skt_fasta_stream_close(void* vh) { delete static_cast<StreamHandle*>(vh); }

// ---------------------------------------------------------------------------
// Scalar CPU sketching pipeline (baseline + oracle).
typedef unsigned __int128 u128;

static inline u128 make_u128(uint64_t lo, uint64_t hi) {
    return (static_cast<u128>(hi) << 64) | lo;
}

// Sketch 2-bit-coded runs: dual-strand sliding windows, same mask on both
// strands, canonical = smaller masked value (strictly-less picks forward),
// keep iff (H(masked)^salt) % scale == 0.  Output: unique keys as (lo,hi)
// pairs, sorted ascending by 128-bit value.  Returns the number of unique
// keys, or -(needed) if `capacity` is too small.
int64_t skt_sketch_codes(const uint8_t* codes, const int64_t* run_lens, int64_t n_runs,
                         uint64_t mask_lo, uint64_t mask_hi, int window,
                         uint64_t salt, uint64_t scale, int legacy,
                         uint64_t* keys_out, int64_t capacity) {
    const u128 mask = make_u128(mask_lo, mask_hi);
    const int shift_top = 2 * (window - 1);
    std::vector<u128> kept;
    const uint8_t* p = codes;
    for (int64_t r = 0; r < n_runs; ++r) {
        const int64_t n = run_lens[r];
        if (n >= window) {
            u128 fwd = 0, rc = 0;
            for (int64_t i = 0; i < n; ++i) {
                const uint8_t nuc = p[i];
                fwd = (fwd << 2) | nuc;
                rc = (rc >> 2) | (static_cast<u128>(nuc ^ 0x3u) << shift_top);
                if (i >= window - 1) {
                    const u128 mf = fwd & mask, mr = rc & mask;
                    const u128 canon = (mf < mr) ? mf : mr;
                    const uint64_t h = hash_bitset128(
                        static_cast<uint64_t>(canon),
                        static_cast<uint64_t>(canon >> 64), legacy);
                    if ((h ^ salt) % scale == 0) kept.push_back(canon);
                }
            }
        }
        p += n;
    }
    std::sort(kept.begin(), kept.end());
    kept.erase(std::unique(kept.begin(), kept.end()), kept.end());
    const int64_t cnt = static_cast<int64_t>(kept.size());
    if (cnt > capacity) return -cnt;
    for (int64_t i = 0; i < cnt; ++i) {
        keys_out[2 * i] = static_cast<uint64_t>(kept[i]);
        keys_out[2 * i + 1] = static_cast<uint64_t>(kept[i] >> 64);
    }
    return cnt;
}

// Multi-threaded batch sketching: std::thread over genomes, replicating the
// reference's cilk_for-over-files parallelism (kmer_set.cpp:124) for the
// honest whole-host baseline.  All genomes share one length n and one run.
// Writes per-genome unique-key counts; key material is discarded (the
// baseline measures throughput; parity uses the scalar entry).
void skt_sketch_batch_mt(const uint8_t* codes, int64_t n, int g,
                         uint64_t mask_lo, uint64_t mask_hi, int window,
                         uint64_t salt, uint64_t scale, int legacy,
                         int nthreads, int64_t* counts_out) {
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
        ts.emplace_back([=]() {
            std::vector<uint64_t> buf;
            for (int i = t; i < g; i += nthreads) {
                const int64_t need = n / (int64_t)scale * 4 + 1024;
                buf.resize(2 * need);
                int64_t run = n;
                int64_t cnt = skt_sketch_codes(codes + (int64_t)i * n, &run,
                                               1, mask_lo, mask_hi, window,
                                               salt, scale, legacy,
                                               buf.data(), need);
                if (cnt < 0) {
                    buf.resize(2 * -cnt);
                    cnt = skt_sketch_codes(codes + (int64_t)i * n, &run, 1,
                                           mask_lo, mask_hi, window, salt,
                                           scale, legacy, buf.data(), -cnt);
                }
                counts_out[i] = cnt;
            }
        });
    }
    for (auto& th : ts) th.join();
}

// 2-bit pack: 16 codes per uint32, code i at bits 2i..2i+1 (LSB-first),
// positions past n treated as code 0 — the compact upload layout that
// ops/extract.unpack_2bit expands on device, packed here at memory
// bandwidth instead of through numpy's (n/16, 16) u32 temporaries.
void skt_pack2bit(const uint8_t* codes, int64_t n, int64_t n_words,
                  uint32_t* out) {
    const int64_t full = std::min<int64_t>(n / 16, n_words);
    for (int64_t wi = 0; wi < full; ++wi) {
        const uint8_t* c = codes + wi * 16;
        uint32_t w = 0;
        for (int j = 0; j < 16; ++j)
            w |= uint32_t(c[j] & 3u) << (2 * j);
        out[wi] = w;
    }
    for (int64_t wi = full; wi < n_words; ++wi) {
        uint32_t w = 0;
        const int64_t base = wi * 16;
        for (int64_t j = 0; j < 16 && base + j < n; ++j)
            w |= uint32_t(codes[base + j] & 3u) << (2 * j);
        out[wi] = w;
    }
}

// Bit-tight key transport for the blocked all-pairs slab
// (ops/gram.pack_keys_tight_np semantics): keys (g, cap, kw) uint32
// little-endian word planes, counts (g,) — pack each genome's first
// counts[i] keys' low key_bits bits contiguously in groups of 4 keys
// per ceil(4*key_bits/32) words; everything at/past counts packs as 0
// (the device unpack reconstructs sentinel rows from counts).  The
// numpy formulation paid ~4 s of first-touch page faults per 1024x8192
// slab on this sandbox's allocator; this loop is ~50 ms.
void skt_pack_keys_tight(const uint32_t* keys, const int32_t* counts,
                         int64_t g, int64_t cap, int kw, int key_bits,
                         uint32_t* out) {
    const int w4 = (4 * key_bits + 31) / 32;
    const uint64_t kmask = key_bits >= 64
        ? ~uint64_t(0) : ((uint64_t(1) << key_bits) - 1);
    for (int64_t gi = 0; gi < g; ++gi) {
        const uint32_t* kp = keys + gi * cap * kw;
        uint32_t* op = out + gi * (cap / 4) * w4;
        const int64_t cnt = std::min<int64_t>(counts[gi], cap);
        for (int64_t i = 0; i < cnt; ++i) {
            uint64_t v = kp[i * kw];
            if (kw > 1) v |= uint64_t(kp[i * kw + 1]) << 32;
            v &= kmask;
            const int j = int(i & 3);
            uint32_t* grp = op + (i >> 2) * w4;
            const int o = j * key_bits, w = o >> 5, s = o & 31;
            grp[w] |= uint32_t(v << s);
            const int rem = key_bits - (32 - s);
            if (rem > 0) grp[w + 1] |= uint32_t(v >> (32 - s));
            if (rem > 32) grp[w + 2] |= uint32_t(v >> (64 - s));
        }
    }
}

// Sorted-unique 128-bit set intersection (two-pointer merge), for the CPU
// baseline ANI path.  Keys are (lo,hi) pairs sorted ascending.
int64_t skt_intersect_sorted(const uint64_t* a, int64_t na,
                             const uint64_t* b, int64_t nb) {
    int64_t i = 0, j = 0, cnt = 0;
    while (i < na && j < nb) {
        const u128 x = make_u128(a[2 * i], a[2 * i + 1]);
        const u128 y = make_u128(b[2 * j], b[2 * j + 1]);
        if (x < y) ++i;
        else if (y < x) ++j;
        else { ++cnt; ++i; ++j; }
    }
    return cnt;
}

}  // extern "C"
