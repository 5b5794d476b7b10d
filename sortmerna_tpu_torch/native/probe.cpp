// Native seed-probe kernel: the enumerate-and-probe window search
// (ops/seed_probe.py) in C++ for the host path.  Semantics identical to
// the numpy backend (and to the reference trie traversal): subsearch 1a/1b
// closed-form d<=1 neighborhoods, pw-mer occurrence gate, 0-error
// short-circuit modes, per-window id de-duplication.
//
// Parameterized over the seed half-window pw = L/2 for every even
// -L in 8..26 (options.cpp opt_L: the reference handles -L uniformly;
// so does this kernel).  The hot default pw=9 (L=18) is compiled as a
// template instantiation so its shifts and loop bounds stay constants.
//
// The hash tables are the open-addressing tables built by
// index/hashtab.py; the mixing function below must match hash_u64 there
// bit-for-bit.

#include <algorithm>
#include <cstdint>
#include <vector>

#include "pool.hpp"

namespace {

constexpr uint64_t EMPTY_KEY = 0xFFFFFFFFFFFFFFFFull;
constexpr int MAX_PROBES = 32;
// Prefetch distances, swept with tools/probe_bench.py on the fused
// tables (best-of-8 medians): 4/2 ~67ms per 2.55M windows vs 69ms at
// 8/4 and 73ms at the old 16/8 -- with one line per bucket entry the
// short pipeline wins; long distances thrash the small L2.
#ifndef PF_HEAD
#define PF_HEAD 4
#endif
#ifndef PF_PAY
#define PF_PAY 2
#endif
constexpr uint32_t M1 = 0x9E3779B1u;
constexpr uint32_t M2 = 0x85EBCA77u;

static inline uint64_t hash_slot(uint64_t key, uint64_t mask) {
    uint32_t lo = (uint32_t)(key & 0x3FFFFFFull);   // low 26 bits
    uint32_t hi = (uint32_t)(key >> 26);            // high <=26 bits
    uint32_t h = lo * M1;
    h ^= hi * M2;
    h ^= h >> 15;
    h *= M1;
    h ^= h >> 13;
    return (uint64_t)h & mask;
}

// generic lookup: returns slot index or -1
static inline int64_t find_slot(const uint64_t* keys, int64_t size,
                                uint64_t key) {
    uint64_t mask = (uint64_t)size - 1;
    uint64_t s = hash_slot(key, mask);
    for (int p = 0; p < MAX_PROBES; ++p) {
        uint64_t k = keys[s];
        if (k == key) return (int64_t)s;
        if (k == EMPTY_KEY) return -1;
        s = (s + 1) & mask;
    }
    return -1;
}

// reverse the `width` 2-bit chars of a packed value
static inline uint64_t rev_chars(uint64_t p, int width) {
    uint64_t out = 0;
    for (int i = 0; i < width; ++i) { out = (out << 2) | (p & 3); p >>= 2; }
    return out;
}

struct Tables {
    const uint64_t* fx_k; const uint32_t* fx_v; int64_t fx_n;
    const uint64_t* fp_k; const uint32_t* fp_s; const uint32_t* fp_c;
    int64_t fp_n;
    const uint64_t* rx_k; const uint32_t* rx_s; const uint32_t* rx_c;
    const uint32_t* rx_z; int64_t rx_n;
    const uint64_t* rp_k; const uint32_t* rp_s; const uint32_t* rp_c;
    int64_t rp_n;
    const uint64_t* k19_k; const uint32_t* k19_v; int64_t k19_n;
    const uint32_t* r_ids;
    const uint32_t* counts9;
    // bucket-scan tables (unique (L+1)-mers per half key).  Payload is
    // INTERLEAVED (tail << 32 | id) so one bucket entry touches one
    // cache-line stream instead of two -- the scan is memory-latency
    // bound and small buckets usually fit a single line this way.
    const uint32_t* f19_off; const uint64_t* f19_ti;
    const uint32_t* r19_off; const uint64_t* r19_ti;
};

static inline void add_id(std::vector<int64_t>& ids, int64_t v) {
    ids.push_back(v);
}

// Closed-form d<=1 tail acceptance (ops/seed_math.py accept_tail):
// w_tail: packed (PW+1)-char tail (2*PW+2 bits, first char most
// significant); p: packed PW-char pattern.  Returns 1 = hit,
// 2 = zero(+hit).
template <int PW>
static inline int accept_tail_c(uint32_t w_tail, uint32_t p) {
    constexpr uint32_t MASK_HALF = (1u << (2 * PW)) - 1;
    uint32_t w9 = (w_tail >> 2) & MASK_HALF;
    uint32_t x = w9 ^ p;
    if (x == 0) return 2;
    int nb = 32 - __builtin_clz(x);
    int L = (PW - 1) - ((nb - 1) >> 1);
    uint32_t mask = (1u << (2 * (PW - 1 - L))) - 1;
    if ((x & mask) == 0) return 1;                              // sub
    if ((((w_tail >> 4) ^ p) & mask) == 0) return 1;            // del
    uint32_t mask_ins = (1u << (2 * (PW - L))) - 1;
    if (((w_tail ^ p) & mask_ins) == 0) return 1;               // ins
    return 0;
}

// threshold above which a bucket falls back to probe enumeration
constexpr uint32_t SCAN_MAX = 1024;

// probe windows [lo, hi) into a local (win, id) vector (one thread's
// slice; window order within the slice matches the sequential scan)
template <int PW>
static void probe_range(
    const Tables& t, const int64_t* w1a, const int64_t* w2a,
    int64_t lo, int64_t hi, int32_t minoccur, int32_t full_search,
    std::vector<std::pair<int64_t, int64_t>>& out) {
    constexpr int H = 2 * PW;               // bits per half
    std::vector<int64_t> ids;
    ids.reserve(256);
    // With the default minoccur == 0 the occurrence gate is equivalent
    // to bucket-nonemptiness (a non-empty f19/r19 bucket implies the
    // half-mer occurs, and an empty bucket makes the subsearch a no-op
    // either way), so the two random counts9 loads per window are
    // skipped entirely.
    const bool use_cnt = minoccur > 0;

    for (int64_t w = lo; w < hi; ++w) {
        // the loop is memory-latency bound (4-6 dependent random
        // accesses into multi-MB tables per window); two-stage
        // prefetch pipeline: gate/offset heads at +PF_HEAD, and at
        // +PF_PAY the (now cached) offsets are READ to prefetch the
        // bucket payloads
        if (w + PF_HEAD < hi) {
            uint64_t nw1 = (uint64_t)w1a[w + PF_HEAD];
            uint64_t nw2 = (uint64_t)w2a[w + PF_HEAD];
            if (use_cnt) {
                __builtin_prefetch(&t.counts9[nw1]);
                __builtin_prefetch(&t.counts9[nw2]);
            }
            __builtin_prefetch(&t.f19_off[nw1]);
            __builtin_prefetch(&t.r19_off[nw2]);
        }
        if (w + PF_PAY < hi) {
            uint64_t nw1 = (uint64_t)w1a[w + PF_PAY];
            uint64_t nw2 = (uint64_t)w2a[w + PF_PAY];
            __builtin_prefetch(&t.f19_ti[t.f19_off[nw1]]);
            __builtin_prefetch(&t.r19_ti[t.r19_off[nw2]]);
        }
        uint64_t w1 = (uint64_t)w1a[w];
        uint64_t w2 = (uint64_t)w2a[w];
        bool gate_f = !use_cnt || t.counts9[w1] > (uint32_t)minoccur;
        bool gate_r = !use_cnt || t.counts9[w2] > (uint32_t)minoccur;
        ids.clear();
        int64_t single = -1;

        // ---------------- subsearch 1a (exact w1 half)
        if (gate_f) {
            uint32_t b0 = t.f19_off[w1], b1 = t.f19_off[w1 + 1];
            if (b1 - b0 <= SCAN_MAX) {
                // bucket scan with the closed-form acceptance
                for (uint32_t e = b0; e < b1; ++e) {
                    uint64_t ti = t.f19_ti[e];
                    int r = accept_tail_c<PW>((uint32_t)(ti >> 32),
                                              (uint32_t)w2);
                    if (r == 2 && !full_search) {
                        single = (int64_t)(uint32_t)ti;
                        break;
                    }
                    if (r) add_id(ids, (int64_t)(uint32_t)ti);
                }
            } else {
                // probe enumeration (hot bucket)
                if (!full_search) {
                    int64_t s = find_slot(t.fx_k, t.fx_n, (w1 << H) | w2);
                    if (s >= 0) single = (int64_t)t.fx_v[s];
                }
                if (single < 0) {
                    {
                        int64_t s = find_slot(t.fx_k, t.fx_n,
                                              (w1 << H) | w2);
                        if (s >= 0) add_id(ids, t.fx_v[s]);
                    }
                    for (int i = 0; i < PW; ++i) {
                        int shift = 2 * (PW - 1 - i);
                        uint64_t cleared = w2 & ~(3ull << shift);
                        for (uint64_t c = 0; c < 4; ++c) {
                            uint64_t v = cleared | (c << shift);
                            if (v == w2) continue;
                            int64_t s = find_slot(t.fx_k, t.fx_n,
                                                  (w1 << H) | v);
                            if (s >= 0) add_id(ids, t.fx_v[s]);
                        }
                    }
                    for (int k = 0; k < PW; ++k) {
                        uint64_t hi2 = w2 >> (2 * (PW - k));
                        uint64_t lo2 = w2
                            & ((1ull << (2 * (PW - 1 - k))) - 1);
                        uint64_t d8 = (hi2 << (2 * (PW - 1 - k))) | lo2;
                        int64_t s = find_slot(t.fp_k, t.fp_n,
                                              (w1 << (H - 2)) | d8);
                        if (s >= 0) {
                            uint32_t st = t.fp_s[s], c = t.fp_c[s];
                            for (uint32_t j = 0; j < c; ++j)
                                add_id(ids, st + j);
                        }
                    }
                    uint64_t p8 = w2 & 3;
                    for (int k = 0; k < PW; ++k) {
                        uint64_t hi2 = w2 >> (2 * (PW - k));
                        uint64_t mid = (w2 >> 2)
                            & ((1ull << (2 * (PW - 1 - k))) - 1);
                        for (uint64_t c = 0; c < 4; ++c) {
                            uint64_t v9 = (((hi2 << 2) | c)
                                           << (2 * (PW - 1 - k))) | mid;
                            uint64_t key = (w1 << (H + 2)) | (v9 << 2)
                                           | p8;
                            int64_t s = find_slot(t.k19_k, t.k19_n, key);
                            if (s >= 0) add_id(ids, t.k19_v[s]);
                        }
                    }
                }
            }
        }
        // ---------------- subsearch 1b (exact w2 half)
        if (single < 0 && gate_r) {
            uint64_t p_r = rev_chars(w1, PW);
            uint32_t b0 = t.r19_off[w2], b1 = t.r19_off[w2 + 1];
            bool zero_b = false;
            if (b1 - b0 <= SCAN_MAX) {
                for (uint32_t e = b0; e < b1; ++e) {
                    uint64_t ti = t.r19_ti[e];
                    int r = accept_tail_c<PW>((uint32_t)(ti >> 32),
                                              (uint32_t)p_r);
                    if (r == 2 && !full_search) {
                        zero_b = true;
                        break;
                    }
                    if (r) add_id(ids, (int64_t)(uint32_t)ti);
                }
            } else {
                if (!full_search) {
                    int64_t s = find_slot(t.rx_k, t.rx_n, (w1 << H) | w2);
                    if (s >= 0) zero_b = true;
                }
                if (!zero_b) {
                    for (int col = 0; col < 4 * PW + 1; ++col) {
                        uint64_t v;
                        if (col == 0) v = p_r;
                        else {
                            int i = (col - 1) / 4;
                            uint64_t c = (uint64_t)((col - 1) % 4);
                            int shift = 2 * (PW - 1 - i);
                            v = (p_r & ~(3ull << shift)) | (c << shift);
                            if (v == p_r) continue;
                        }
                        uint64_t key = (rev_chars(v, PW) << H) | w2;
                        int64_t s = find_slot(t.rx_k, t.rx_n, key);
                        if (s >= 0) {
                            uint32_t st = t.rx_s[s], c2 = t.rx_c[s];
                            for (uint32_t j = 0; j < c2; ++j)
                                add_id(ids, t.r_ids[st + j]);
                        }
                    }
                    for (int k = 0; k < PW; ++k) {
                        uint64_t hi2 = p_r >> (2 * (PW - k));
                        uint64_t lo2 = p_r
                            & ((1ull << (2 * (PW - 1 - k))) - 1);
                        uint64_t d8 = (hi2 << (2 * (PW - 1 - k))) | lo2;
                        uint64_t key = (rev_chars(d8, PW - 1) << H) | w2;
                        int64_t s = find_slot(t.rp_k, t.rp_n, key);
                        if (s >= 0) {
                            uint32_t st = t.rp_s[s], c2 = t.rp_c[s];
                            for (uint32_t j = 0; j < c2; ++j)
                                add_id(ids, t.r_ids[st + j]);
                        }
                    }
                    uint64_t c0 = w1 >> (H - 2);
                    for (int k = 0; k < PW; ++k) {
                        uint64_t hi2 = p_r >> (2 * (PW - k));
                        uint64_t mid = (p_r >> 2)
                            & ((1ull << (2 * (PW - 1 - k))) - 1);
                        for (uint64_t c = 0; c < 4; ++c) {
                            uint64_t v9 = (((hi2 << 2) | c)
                                           << (2 * (PW - 1 - k))) | mid;
                            uint64_t key = (c0 << (2 * H))
                                           | (rev_chars(v9, PW) << H) | w2;
                            int64_t s = find_slot(t.k19_k, t.k19_n, key);
                            if (s >= 0) add_id(ids, t.k19_v[s]);
                        }
                    }
                }
            }
            if (zero_b) {
                // first-inserted representative (traverse_bursttrie
                // 237-262) from the R-exact table
                int64_t s = find_slot(t.rx_k, t.rx_n, (w1 << H) | w2);
                if (s >= 0) single = (int64_t)t.rx_z[s];
            }
        }

        if (single >= 0) {
            out.emplace_back(w, single);
            continue;
        }
        std::sort(ids.begin(), ids.end());
        ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
        for (int64_t v : ids) out.emplace_back(w, v);
    }
}

using ProbeFn = void (*)(const Tables&, const int64_t*, const int64_t*,
                         int64_t, int64_t, int32_t, int32_t,
                         std::vector<std::pair<int64_t, int64_t>>&);

// one instantiation per even L in 8..26 (pw 4..13)
static ProbeFn probe_fn_for(int pw) {
    switch (pw) {
    case 4:  return probe_range<4>;
    case 5:  return probe_range<5>;
    case 6:  return probe_range<6>;
    case 7:  return probe_range<7>;
    case 8:  return probe_range<8>;
    case 9:  return probe_range<9>;
    case 10: return probe_range<10>;
    case 11: return probe_range<11>;
    case 12: return probe_range<12>;
    case 13: return probe_range<13>;
    default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Returns number of (win, id) pairs written, or -(needed) if cap is too
// small (caller retries with a bigger buffer).  Each 64K-window segment's
// unique keys are cut into `threads` chunks run on the native pool
// (pool.hpp; inline inside a pool task); chunk concatenation preserves
// the sequential per-window output order exactly.  pw = seed_win_len / 2
// (4..13); returns INT64_MIN on an unsupported pw.
int64_t probe_windows(
    const uint64_t* fx_k, const uint32_t* fx_v, int64_t fx_n,
    const uint64_t* fp_k, const uint32_t* fp_s, const uint32_t* fp_c,
    int64_t fp_n,
    const uint64_t* rx_k, const uint32_t* rx_s, const uint32_t* rx_c,
    const uint32_t* rx_z, int64_t rx_n,
    const uint64_t* rp_k, const uint32_t* rp_s, const uint32_t* rp_c,
    int64_t rp_n,
    const uint64_t* k19_k, const uint32_t* k19_v, int64_t k19_n,
    const uint32_t* r_ids, const uint32_t* counts9,
    const uint32_t* f19_off, const uint64_t* f19_ti,
    const uint32_t* r19_off, const uint64_t* r19_ti,
    const int64_t* w1a, const int64_t* w2a, int64_t nw,
    int32_t minoccur, int32_t full_search,
    int64_t* out_win, int64_t* out_id, int64_t cap, int32_t threads,
    int32_t pw) {

    ProbeFn fn = probe_fn_for(pw);
    if (!fn) return INT64_MIN;
    Tables t{fx_k, fx_v, fx_n, fp_k, fp_s, fp_c, fp_n,
             rx_k, rx_s, rx_c, rx_z, rx_n, rp_k, rp_s, rp_c, rp_n,
             k19_k, k19_v, k19_n, r_ids, counts9,
             f19_off, f19_ti, r19_off, r19_ti};
    if (nw <= 0) return 0;
    const int width = threads < 1 ? 1 : threads;

    // --- per-call key dedup.  Amplicon batches repeat (w1, w2) keys
    // heavily (set2: ~9-11% unique per slice-sized call, 4% across
    // 30K reads), and the probe is a pure function of the key, so
    // each unique key probes ONCE and the results fan back out in
    // window order -- bit-identical to the direct scan (every
    // duplicate window would produce the same ordered id list).
    // Windows process in segments of 64K so the intake table stays
    // L2-resident: a single 2.5M-window call with one big table
    // measured SLOWER than no dedup at all (102 vs 67ms), while
    // slice-sized tables win (90 -> 66ms per 2.55M across 48 calls).
    constexpr int64_t SEG = 64 * 1024;
    struct SegRes {
        int64_t lo, n;
        std::vector<int64_t> uoff, uids;
        std::vector<int32_t> uidx;
    };
    std::vector<SegRes> segs;
    const int shiftH = 2 * pw;              // halves are < 2^26 each
    int64_t needed = 0;
    for (int64_t slo = 0; slo < nw; slo += SEG) {
        const int64_t shi = std::min(slo + SEG, nw);
        const int64_t sn = shi - slo;
        SegRes sr;
        sr.lo = slo;
        sr.n = sn;
        sr.uidx.resize(sn);
        std::vector<int64_t> uw1, uw2;
        {
            int64_t tsize = 64;
            while (tsize < 2 * sn) tsize <<= 1;
            std::vector<uint64_t> tkey(tsize, UINT64_MAX);
            std::vector<int32_t> tval(tsize);
            const uint64_t mask = (uint64_t)tsize - 1;
            uw1.reserve(sn / 4 + 16);
            uw2.reserve(sn / 4 + 16);
            for (int64_t j = 0; j < sn; ++j) {
                if (j + 12 < sn) {  // hide the table lookup's latency
                    uint64_t kf =
                        ((uint64_t)w1a[slo + j + 12] << shiftH)
                        | (uint64_t)w2a[slo + j + 12];
                    __builtin_prefetch(&tkey[hash_slot(kf, mask)]);
                }
                uint64_t key = ((uint64_t)w1a[slo + j] << shiftH)
                               | (uint64_t)w2a[slo + j];
                uint64_t s = hash_slot(key, mask);
                for (;;) {
                    if (tkey[s] == key) { sr.uidx[j] = tval[s]; break; }
                    if (tkey[s] == UINT64_MAX) {
                        tkey[s] = key;
                        tval[s] = (int32_t)uw1.size();
                        sr.uidx[j] = tval[s];
                        uw1.push_back(w1a[slo + j]);
                        uw2.push_back(w2a[slo + j]);
                        break;
                    }
                    s = (s + 1) & mask;
                }
            }
        }
        const int64_t nu = (int64_t)uw1.size();

        int nt = width;
        if ((int64_t)nt > nu) nt = nu > 0 ? (int)nu : 1;
        std::vector<std::vector<std::pair<int64_t, int64_t>>> outs(nt);
        smr::pool_for(width, nt, [&](int64_t i) {
            fn(t, uw1.data(), uw2.data(), nu * i / nt, nu * (i + 1) / nt,
               minoccur, full_search, outs[i]);
        });

        // flatten per-unique-key id lists (outs are unique-index
        // ordered: chunks partition a contiguous unique range)
        sr.uoff.assign(nu + 1, 0);
        int64_t n_pairs = 0;
        for (auto& o : outs) n_pairs += (int64_t)o.size();
        sr.uids.reserve(n_pairs);
        for (auto& o : outs)
            for (auto& p : o) {
                ++sr.uoff[p.first + 1];
                sr.uids.push_back(p.second);
            }
        for (int64_t u = 0; u < nu; ++u) sr.uoff[u + 1] += sr.uoff[u];
        for (int64_t j = 0; j < sn; ++j)
            needed += sr.uoff[sr.uidx[j] + 1] - sr.uoff[sr.uidx[j]];
        segs.push_back(std::move(sr));
    }

    if (needed > cap) return -needed;
    int64_t n_out = 0;
    for (const SegRes& sr : segs)
        for (int64_t j = 0; j < sr.n; ++j) {
            int64_t b0 = sr.uoff[sr.uidx[j]];
            int64_t b1 = sr.uoff[sr.uidx[j] + 1];
            for (int64_t e = b0; e < b1; ++e) {
                out_win[n_out] = sr.lo + j;
                out_id[n_out] = sr.uids[e];
                ++n_out;
            }
        }
    return n_out;
}

}  // extern "C"
