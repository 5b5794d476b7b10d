// The d<=1 window seed search (--device_probe) for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device function
// sortmerna_tpu/ops/seed_search.py::_probe_kernel (with _probe_table,
// _hash26 and the variant enumerators): for each read window w1.w2 (two
// packed pw-mers) the closed-form d<=1 neighbourhood is probed in the
// part's open-addressing hash tables (index/hashtab.py: uint64 keys, EMPTY
// all ones, linear probing, at most MAX_PROBES = 32 slots), the 0-error
// mode is selected, the bounded group expansions are read, and the ids are
// sorted and de-duplicated per window; then the (window, id) pairs are
// compacted, windows ascending.  Bit for bit what _probe_kernel computes.
//
// What bounds it.  Random reads: each lookup touches a 32-byte sector of
// a key table and a hit a sector of values.  The tables of a 6 Mnt part
// come to hundreds of MB against the 50 MB L2, so the keys come from
// device memory, and a random-gather kernel runs as fast as it keeps
// sectors in flight; the work between the reads (a key, a hash, a compare
// a probe) is what the warps overlap them with.  The design, measured in
// turns against the warp-per-window kernel it replaced (PERF.md, §6):
//
//   * seed_probe -- a warp takes WPW windows.  Lanes 0..WPW-1 each do their
//     window's gates (kmer_counts > minoccur) and its two 0-error lookups
//     (F-exact and R-exact tables, both keyed by w1.w2); a window in mode
//     A or B writes its one id there.  The warp then walks its other-mode
//     windows one at a time, all 32 lanes probing: the 7pw + 1 probes a
//     side (probes_per_side) are NP a lane, each lane's place in that list
//     worked out once (recipe), its key made without a branch (describe).
//     One lookup loop, the same for every kind, reads each probe's home
//     bit first (a bitmap of the slots that are some key's home, held in
//     L2: most probes miss, and a clear bit means no DRAM read), then
//     issues the key sector of every probe still open before it compares
//     any (four keys at a time, slots counted against MAX_PROBES as
//     _probe_table counts them).  A warp scan of the found probes' id
//     counts places each id in the warp's buffer (no atomics); r_ids
//     members are fetched by all lanes, striped over the buffer.  Up to
//     128 ids sort in registers (a warp bitonic sort over shuffles, 1, 2
//     or 4 a lane), more by rank in shared memory; a neighbour compare
//     and a scan keep the first of each run, BIG = 0x7FFFFFFF ("no id")
//     dropped, and the window's count and sorted ids go to a row of
//     scratch.  Registers are capped (min_blocks) for occupancy.
//   * seed_compact -- a thread a window, 1,024 a block.  The offsets are
//     an exclusive scan of the counts taken in the same launch: a block
//     scans its counts and publishes its sum, then its first warp looks
//     back over 32 predecessors' (flag, sum) words at a time (64-bit,
//     release / acquire) until one holds an inclusive prefix; blocks take
//     their order from an atomic ticket, so a block waits only on blocks
//     that have started.  A thread then copies one output pair at a time
//     (its window found by a binary search of the block's scan), and the
//     last window's thread writes the total.
//
// Plain C interface (loaded with ctypes); each entry returns the
// cudaError_t of its launch.  Launches go on the caller's stream, never
// synchronise and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int WPW = 4;          // windows a warp of seed_probe takes
constexpr int WARPS = 4;        // warps a block of seed_probe
constexpr int CT = 1024;        // threads (windows) a block of seed_compact
                                // (seed_search.COMPACT_BLOCK)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PROBES = 32;
constexpr u64 EMPTY = ~0ull;
constexpr int BIG = 0x7FFFFFFF;
constexpr int CAP_FDEL = 4, CAP_RSUB = 4, CAP_RDEL = 16;
constexpr int MIN_PW = 4, MAX_PW = 13;   // the CLI's -L 8..26
constexpr int SORT_REGS = 128;  // most ids the register sort takes

enum { FX = 0, FP, RX, RP, K19, NONE };

__host__ __device__ __forceinline__ int ids_per_window(int pw) {
    return 7 + 48 * pw;
}

// probes of one subsearch (a side) of an other-mode window besides its
// 0-error one: 3pw substitutions, 3pw + 1 insertions and pw deletions
__host__ __device__ __forceinline__ int probes_per_side(int pw) {
    return 7 * pw + 1;
}

// probe descriptors a lane holds: both sides over 32 lanes
__host__ __device__ __forceinline__ int probes_per_lane(int pw) {
    return (2 * probes_per_side(pw) + 31) / 32;
}

struct Table {
    const u64* keys;            // 2^bits slots, bits >= 2, 32-byte aligned
    const int* vals;            // rows of int32 (uint32 wrapped)
    const unsigned* home;       // bit h: some key's home slot is h
    int bits;
};

// the five tables in the order of the enum, then r_ids
struct Probe {
    Table t[5];
    const int* r_ids;
    int n_rids;
};

// index/hashtab.hash_u64: 32-bit wrapping mixes over the 26/26 split
__device__ __forceinline__ uint32_t hash26(u64 key, int bits) {
    uint32_t h = (uint32_t)(key & 0x3FFFFFFull) * 0x9E3779B1u
                 ^ (uint32_t)(key >> 26) * 0x85EBCA77u;
    h ^= h >> 15;
    h *= 0x9E3779B1u;
    h ^= h >> 13;
    return h & ((1u << bits) - 1u);
}

// Resolve the probes whose slot is -2: slot[j] becomes the key's slot, or
// -1 when an empty slot or the MAX_PROBES-th slot came first.  A key whose
// home slot is no key's home is in no slot: the home bitmap (a bit a
// slot, 1/64 of the key bytes) answers it without a read of the keys.
// Every other probe's sector is loaded before any is
// compared; a sector's four keys are compared at once (bit q of `hit` /
// `stop`: slot q holds the key / EMPTY) and the first of them inside the
// slots still to scan decides.
template <int NP>
__device__ __forceinline__ void lookup_all(const Table* T, const int (&tab)[NP],
                                           const u64 (&key)[NP],
                                           int (&slot)[NP]) {
    uint32_t cur[NP];
    int left[NP];
    bool open[NP];
    bool any = false;
    unsigned home[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
        open[j] = slot[j] == -2;
        cur[j] = open[j] ? hash26(key[j], T[tab[j]].bits) : 0u;
        home[j] = open[j] ? __ldg(T[tab[j]].home + (cur[j] >> 5)) : 0u;
        left[j] = MAX_PROBES;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
        if (open[j] && !((home[j] >> (cur[j] & 31u)) & 1u)) {
            slot[j] = -1;
            open[j] = false;
        }
        any |= open[j];
    }
    while (any) {
        ulonglong2 lo[NP], hi[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            if (open[j]) {
                const ulonglong2* s = reinterpret_cast<const ulonglong2*>(
                    T[tab[j]].keys + (cur[j] & ~3u));
                lo[j] = __ldg(s);
                hi[j] = __ldg(s + 1);
            }
        }
        any = false;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            if (!open[j]) continue;
            const u64 k4[4] = {lo[j].x, lo[j].y, hi[j].x, hi[j].y};
            unsigned hit = 0, stop = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                hit |= (unsigned)(k4[q] == key[j]) << q;
                stop |= (unsigned)(k4[q] == EMPTY) << q;
            }
            const uint32_t base = cur[j] & ~3u;
            const int first = (int)(cur[j] & 3u);
            const int n = min(4 - first, left[j]);
            const unsigned seen = (hit | stop) & (((1u << n) - 1u) << first);
            left[j] -= n;
            if (seen) {
                const int q = __ffs(seen) - 1;
                slot[j] = (hit >> q) & 1u ? (int)(base + q) : -1;
                open[j] = false;
            } else if (left[j] == 0) {
                slot[j] = -1;
                open[j] = false;
            } else {
                cur[j] = (base + 4u) & ((1u << T[tab[j]].bits) - 1u);
                any = true;
            }
        }
    }
}

// char i (0 = the first, most significant) of the pw-mer p
__device__ __forceinline__ int char_at(u64 p, int pw, int i) {
    return (int)((p >> (2 * (pw - 1 - i))) & 3);
}

// The probes of an other-mode window.  The JAX package writes the R side's
// keys through the reversed w1 (rev(variant(rev(w1))) << 2pw | w2); the
// same set of keys comes from the variants of w1 itself, so both sides
// take a variant x of one half p (w2 on the F side, w1 on the R side):
//   substitution of char i:   F w1 << 2pw | x,    R x << 2pw | w2;
//   insertion after m chars:  F w1 << 2pw+2 | x,  R x << 2pw | w2
//                             (the 19-mers; F m = 0..pw-1, R m = 1..pw);
//   deletion of char k:       F w1 << 2pw-2 | x,  R x << 2pw | w2.
// Each is x = ((p >> A) << B) | c << D | (p & (2^D - 1)) for D = the bits
// right of the place, A = D + 2 but for an insertion, B = D + 2 but for a
// deletion.  Keys that repeat another probe's are left out, since their
// ids are that probe's and the de-dup drops repeats: the substitutions
// that put back the char in place (the 0-error key), and the insertion
// of p[m] after m chars (the string of inserting it after m + 1) but at
// the last place.  That leaves 3pw substitutions, 3pw + 1 insertions and
// pw deletions a side (probes_per_side).
//
// A probe's place in that list depends on its lane and slot only, so a
// warp works it out once: recipe() packs the kind, its char position,
// the char c (or, where the char in place is skipped, the count c' of
// chars before it: c = c' + (c' >= the char in place)), and whether it is
// the first side's (p < probes_per_side) or the second's.
enum { SUB = 0, INS = 1, DEL = 2 };
constexpr int SKIP = 1 << 4, SECOND = 1 << 10, VALID = 1 << 11;

__device__ __forceinline__ int recipe(int p, int pw) {
    const int side = probes_per_side(pw);
    if (p >= 2 * side) return 0;
    const bool second = p >= side;
    const int q = second ? p - side : p;
    int kind, pos, c, skip = SKIP;
    if (q < 3 * pw) {
        kind = SUB;
        pos = q / 3;
        c = q - 3 * pos;
    } else if (q < 6 * pw + 1) {
        const int t = q - 3 * pw;
        kind = INS;
        pos = t / 3;
        c = t - 3 * pos;
        if (t >= 3 * (pw - 1)) {                // the last place: all four
            pos = pw - 1;
            c = t - 3 * (pw - 1);
            skip = 0;
        }
    } else {
        kind = DEL;
        pos = q - 6 * pw - 1;
        c = 0;
        skip = 0;
    }
    return VALID | (second ? SECOND : 0) | (pos << 5) | skip | (c << 2)
           | kind;
}

// The table and key of the probe of recipe r for window a.b, whose F and
// R sides are open as given; tab NONE when the probe is not the window's.
__device__ __forceinline__ void describe(int r, u64 a, u64 b, int pw,
                                         bool open_f, bool open_r, int& tab,
                                         u64& key) {
    const bool second = r & SECOND;
    tab = NONE;
    key = 0;
    if (!(r & VALID) || (second ? !(open_f && open_r) : !(open_f || open_r)))
        return;
    const bool fside = !second && open_f;       // the first side is F if open
    const int kind = r & 3;
    const u64 p = fside ? b : a;
    const int pos = ((r >> 5) & 31) + (kind == INS && !fside);
    const int D = kind == INS ? 2 * (pw - pos) : 2 * (pw - 1 - pos);
    int c = (r >> 2) & 3;
    if (r & SKIP) c += c >= char_at(p, pw, min(pos, pw - 1));
    const u64 x = ((p >> (D + (kind != INS ? 2 : 0)))
                   << (D + (kind != DEL ? 2 : 0)))
                  | ((u64)c << D) | (p & ((1ull << D) - 1));
    const int s = 2 * pw, grow = kind == SUB ? 0 : kind == INS ? 1 : -1;
    key = fside ? (a << (s + 2 * grow)) | x : (x << s) | b;
    tab = kind == INS ? K19 : (kind == SUB ? FX : FP) + (fside ? 0 : RX);
}

// A found probe's first id (or range start, or r_ids start) and its id
// count; none for slot < 0.
__device__ __forceinline__ void values(const Table* T, int tab, int slot,
                                       int& v0, int& nid) {
    v0 = 0;
    nid = 0;
    if (slot < 0) return;
    const int* vals = T[tab].vals;
    if (tab == FX || tab == K19) {
        v0 = __ldg(vals + slot);
        nid = 1;
    } else if (tab == RX) {
        v0 = __ldg(vals + 3 * slot);
        nid = min(max(__ldg(vals + 3 * slot + 1), 0), CAP_RSUB);
    } else {
        const int2 v = __ldg(reinterpret_cast<const int2*>(vals) + slot);
        v0 = v.x;
        nid = min(max(v.y, 0), tab == FP ? CAP_FDEL : CAP_RDEL);
    }
}

// a found probe's ids to the warp's buffer from `at` on: an id, a range
// (ids wrap as int32, as the JAX package's do) or r_ids indices (start +
// t clamped to the last, wrapped as the JAX gather wraps a negative one)
__device__ __forceinline__ void emit(int tab, int v0, int nid, int n_rids,
                                     int at, int* buf, int* src) {
    for (int t = 0; t < nid; ++t) {
        const int id = (int)((unsigned)v0 + (unsigned)t);
        if (tab == RX || tab == RP) {
            int r = min(id, n_rids - 1);
            if (r < 0) r = max(r + n_rids, 0);
            src[at + t] = r;
        } else {
            buf[at + t] = id;
            src[at + t] = -1;
        }
    }
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, x, d);
        if (lane >= d) x += y;
    }
    return x;
}

// id i of the warp's buffer: an r_ids member where src[i] names one
__device__ __forceinline__ int fetch(const int* r_ids, const int* buf,
                                     const int* src, int i) {
    const int r = src[i];
    return r >= 0 ? __ldg(r_ids + r) : buf[i];
}

// Sort the m <= 32E ids of the buffer in registers (bitonic, E a lane,
// blocked: lane l holds elements lE .. lE+E-1), keep the first of each run
// of equal ids but BIG, write them to dst; returns their count.
template <int E>
__device__ __forceinline__ int sort_small(const int* r_ids, const int* buf,
                                          const int* src, int m, int lane,
                                          int* dst) {
    int v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        v[e] = i < m ? fetch(r_ids, buf, src, i) : BIG;
    }
#pragma unroll
    for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (j < E) {                        // partner in this lane
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int f = e ^ j;
                    if (f > e) {
                        const bool asc = ((lane * E + e) & k) == 0;
                        const int lo = min(v[e], v[f]), hi = max(v[e], v[f]);
                        v[e] = asc ? lo : hi;
                        v[f] = asc ? hi : lo;
                    }
                }
            } else {                            // partner in lane ^ (j / E)
                const int lm = j / E;
                const bool lower = (lane & lm) == 0;
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int u = __shfl_xor_sync(FULL, v[e], lm);
                    const bool asc = ((lane * E + e) & k) == 0;
                    v[e] = asc == lower ? min(v[e], u) : max(v[e], u);
                }
            }
        }
    }
    const int before = __shfl_up_sync(FULL, v[E - 1], 1);
    bool keep[E];
    int kept = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const bool head = e ? v[e] != v[e - 1] : (lane == 0 || v[0] != before);
        keep[e] = head && v[e] != BIG;
        kept += keep[e];
    }
    const int incl = warp_inclusive_sum(kept, lane);
    int o = incl - kept;
#pragma unroll
    for (int e = 0; e < E; ++e)
        if (keep[e]) dst[o++] = v[e];
    return __shfl_sync(FULL, incl, 31);
}

// The same for any m: the ids fetched into buf, sorted by rank (an
// element's place is the count of smaller ones plus equal ones before it)
// into src, then the run heads written.
__device__ __forceinline__ int sort_rank(const int* r_ids, int* buf, int* src,
                                         int m, int lane, int* dst) {
    for (int i = lane; i < m; i += 32) buf[i] = fetch(r_ids, buf, src, i);
    __syncwarp();
    for (int i = lane; i < m; i += 32) {
        const int v = buf[i];
        int rank = 0;
        for (int j = 0; j < m; ++j) {
            const int u = buf[j];
            rank += (u < v) || (u == v && j < i);
        }
        src[rank] = v;
    }
    __syncwarp();
    int kept = 0;
    for (int base = 0; base < m; base += 32) {
        const int i = base + lane;
        const bool keep = i < m && src[i] != BIG
                          && (i == 0 || src[i] != src[i - 1]);
        const unsigned ballot = __ballot_sync(FULL, keep);
        if (keep) dst[kept + __popc(ballot & ((1u << lane) - 1u))] = src[i];
        kept += __popc(ballot);
    }
    return kept;
}

// Blocks an SM should hold at NP probes a lane: the most whose register
// share (65,536 / (128 x blocks)) holds the instantiation without spills.
// Occupancy is what keeps sectors in flight: at NP = 4 (pw = 9, 65,536
// windows, tools/probe_ab.py on an H100 80GB HBM3 at 700 W) five blocks
// (96 registers) ran 0.155 ms where the uncapped 118 registers ran 0.177
// and six blocks (80 registers, spilling) 0.183.
__host__ __device__ constexpr int min_blocks(int NP) {
    return NP >= 5 ? 3 : NP == 4 ? 5 : 6;
}

template <int NP>
__global__ void __launch_bounds__(WARPS * 32, min_blocks(NP))
seed_probe_kernel(const int* __restrict__ w1s, const int* __restrict__ w2s,
                  const long long* __restrict__ counts, long long minoccur,
                  Probe P, int NW, int pw, int full_search,
                  int* __restrict__ out_count, int* __restrict__ scratch) {
    extern __shared__ int smem[];
    __shared__ Table T[5];
    if (threadIdx.x < 5) T[threadIdx.x] = P.t[threadIdx.x];
    __syncthreads();
    const int K = ids_per_window(pw);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* buf = smem + warp * 2 * K;             // ids, in probe order
    int* src = buf + K;                         // r_ids index of an id, or -1
    const int w0 = (blockIdx.x * WARPS + warp) * WPW;
    if (w0 >= NW) return;                       // whole warps only
    const int s = 2 * pw;
    int rec[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) rec[j] = recipe(j * 32 + lane, pw);

    // lane l < WPW: window w0 + l's 0-error lookups (issued beside the
    // gates' count loads), gates and mode
    const int w = w0 + lane;
    const bool mine = lane < WPW && w < NW;
    u64 a = 0, b = 0;
    int nf = 0, nr = 0, zf = -1, rzf = -1;
    if (mine) {
        a = (u64)w1s[w];
        b = (u64)w2s[w];
        const long long ca = counts[a], cb = counts[b];
        const int tab0[2] = {FX, RX};
        const u64 key0[2] = {(a << s) | b, (a << s) | b};
        int z[2] = {-2, -2};
        lookup_all<2>(T, tab0, key0, z);
        const bool gate_f = ca > minoccur, gate_r = cb > minoccur;
        zf = gate_f ? z[0] : -1;                // found behind an open gate
        rzf = gate_r ? z[1] : -1;
        nf = gate_f;
        nr = gate_r;
        const bool mode_a = !full_search && zf >= 0;
        const bool mode_b = !full_search && rzf >= 0 && !mode_a;
        if (mode_a || mode_b) {
            const int id = mode_a ? __ldg(T[FX].vals + zf)
                                  : __ldg(T[RX].vals + 3 * rzf + 2);
            if (id != BIG) scratch[(size_t)w * K] = id;
            out_count[w] = id != BIG;
            nf = nr = 0;
        } else if (!gate_f && !gate_r) {
            out_count[w] = 0;
        }
    }

    // the other-mode windows, one at a time, every lane probing; lanes 0
    // and 1 also take the window's F-exact and R-exact slots
    unsigned todo = __ballot_sync(FULL, nf + nr > 0);
    while (todo) {
        const int o = __ffs(todo) - 1;
        todo &= todo - 1;
        const u64 ra = __shfl_sync(FULL, a, o), rb = __shfl_sync(FULL, b, o);
        const int onf = __shfl_sync(FULL, nf, o);
        const int onr = __shfl_sync(FULL, nr, o);
        const int ozf = __shfl_sync(FULL, zf, o);
        const int orzf = __shfl_sync(FULL, rzf, o);

        int tab[NP], slot[NP];
        u64 key[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            describe(rec[j], ra, rb, pw, onf, onr, tab[j], key[j]);
            slot[j] = tab[j] == NONE ? -1 : -2;
        }
        lookup_all<NP>(T, tab, key, slot);

        const int xtab = lane == 0 && onf ? FX : lane == 1 && onr ? RX
                                                                  : NONE;
        int v0[NP + 1], nid[NP + 1], mine_ids = 0;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            values(T, tab[j], slot[j], v0[j], nid[j]);
            mine_ids += nid[j];
        }
        values(T, xtab, xtab == NONE ? -1 : lane == 0 ? ozf : orzf, v0[NP],
               nid[NP]);
        mine_ids += nid[NP];
        const int incl = warp_inclusive_sum(mine_ids, lane);
        const int m = __shfl_sync(FULL, incl, 31);
        const int wo = w0 + o;
        if (m == 0) {                           // no probe found an id
            if (lane == 0) out_count[wo] = 0;
            continue;
        }
        int at = incl - mine_ids;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            emit(tab[j], v0[j], nid[j], P.n_rids, at, buf, src);
            at += nid[j];
        }
        emit(xtab, v0[NP], nid[NP], P.n_rids, at, buf, src);
        __syncwarp();

        int* dst = scratch + (size_t)wo * K;
        int kept;
        if (m <= 32) kept = sort_small<1>(P.r_ids, buf, src, m, lane, dst);
        else if (m <= 64)
            kept = sort_small<2>(P.r_ids, buf, src, m, lane, dst);
        else if (m <= SORT_REGS)
            kept = sort_small<4>(P.r_ids, buf, src, m, lane, dst);
        else kept = sort_rank(P.r_ids, buf, src, m, lane, dst);
        if (lane == 0) out_count[wo] = kept;
        __syncwarp();
    }
}

__device__ __forceinline__ void store_release(u64* p, u64 v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ u64 load_acquire(const u64* p) {
    u64 v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

// a block's published word: flag in the high half, a sum in the low half
constexpr u64 AGGREGATE = 1ull << 32, PREFIX = 2ull << 32;

__global__ void __launch_bounds__(CT)
seed_compact_kernel(const int* __restrict__ count,
                    const int* __restrict__ scratch, int NW, int pw,
                    u64* __restrict__ state, int* __restrict__ out_win,
                    int* __restrict__ out_id, int* __restrict__ total) {
    __shared__ int s_block, s_prefix;
    __shared__ int s_warp[CT / 32];
    __shared__ int s_end[CT];                   // inclusive ends in the block
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0)
        s_block = (int)atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
    __syncthreads();
    const int blk = s_block;
    u64* status = state + 1;
    const int w = blk * CT + threadIdx.x;
    const int c = w < NW ? count[w] : 0;

    // the block's inclusive scan
    int incl = warp_inclusive_sum(c, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int x = s_warp[lane];
        const int y = warp_inclusive_sum(x, lane);
        s_warp[lane] = y - x;                   // exclusive
        s_prefix = __shfl_sync(FULL, y, 31);    // the block's sum, for now
    }
    __syncthreads();
    incl += s_warp[warp];
    s_end[threadIdx.x] = incl;

    // the block's prefix: publish its sum, then warp 0 looks back over 32
    // predecessors at a time, lane i at block blk - 1 - i, until one has
    // published its inclusive prefix
    if (warp == 0) {
        const uint32_t agg = (uint32_t)s_prefix;
        uint32_t prefix = 0;
        if (blk == 0) {
            if (lane == 0) store_release(status, PREFIX | agg);
        } else {
            if (lane == 0) store_release(status + blk, AGGREGATE | agg);
            for (int j = blk - 1;; j -= 32) {
                const int i = j - lane;
                u64 st = i >= 0 ? load_acquire(status + i) : PREFIX;
                while (__any_sync(FULL, (st >> 32) == 0))
                    if ((st >> 32) == 0) st = load_acquire(status + i);
                const unsigned done = __ballot_sync(FULL, (st >> 32) == 2);
                const int last = done ? __ffs(done) - 1 : 31;
                uint32_t v = lane <= last ? (uint32_t)st : 0u;
#pragma unroll
                for (int d = 16; d > 0; d >>= 1)
                    v += __shfl_xor_sync(FULL, v, d);
                prefix += v;
                if (done) break;
            }
            if (lane == 0)
                store_release(status + blk, PREFIX | (uint32_t)(prefix + agg));
        }
        __syncwarp();
        if (lane == 0) s_prefix = (int)prefix;
    }
    __syncthreads();
    // the block's pairs, a thread an output position: its window is the
    // first whose inclusive end passes it (a binary search of s_end)
    const int base = s_prefix, n = s_end[CT - 1];
    const int K = ids_per_window(pw);
    for (int i = threadIdx.x; i < n; i += CT) {
        int lo = 0, hi = CT - 1;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_end[mid] > i) hi = mid;
            else lo = mid + 1;
        }
        const int ww = blk * CT + lo;
        const int k = i - (lo ? s_end[lo - 1] : 0);
        out_win[base + i] = ww;
        out_id[base + i] = scratch[(size_t)ww * K + k];
    }
    if (w == NW - 1) *total = base + incl;
}

template <int NP>
cudaError_t launch_probe(const int* w1, const int* w2, const long long* counts,
                         long long minoccur, const Probe& P, int NW, int pw,
                         int full_search, int* out_count, int* scratch,
                         cudaStream_t stream) {
    const int per_block = WARPS * WPW;
    const size_t shmem = (size_t)WARPS * 2 * ids_per_window(pw) * sizeof(int);
    seed_probe_kernel<NP><<<(NW + per_block - 1) / per_block, WARPS * 32,
                            shmem, stream>>>(
        w1, w2, counts, minoccur, P, NW, pw, full_search, out_count,
        scratch);
    return cudaGetLastError();
}

// 64-bit words of seed_compact's state for NW windows: the ticket, then a
// word for each block (seed_search.compact_state_words)
int compact_state_words(int NW) {
    return 1 + (NW + CT - 1) / CT;
}

}  // namespace

extern "C" {

int smr_seed_probe(const int* w1, const int* w2, const long long* counts,
                   long long minoccur,
                   const u64* fx_k, const int* fx_v, const unsigned* fx_h,
                   int fx_bits,
                   const u64* fp_k, const int* fp_v, const unsigned* fp_h,
                   int fp_bits,
                   const u64* rx_k, const int* rx_v, const unsigned* rx_h,
                   int rx_bits,
                   const u64* rp_k, const int* rp_v, const unsigned* rp_h,
                   int rp_bits,
                   const u64* k19_k, const int* k19_v, const unsigned* k19_h,
                   int k19_bits,
                   const int* r_ids, int n_rids, int NW, int pw,
                   int full_search, int* out_count, int* scratch,
                   void* stream) {
    if (pw < MIN_PW || pw > MAX_PW || n_rids < 1)
        return (int)cudaErrorInvalidValue;
    const int bits[5] = {fx_bits, fp_bits, rx_bits, rp_bits, k19_bits};
    for (int t = 0; t < 5; ++t)
        if (bits[t] < 2 || bits[t] > 31) return (int)cudaErrorInvalidValue;
    if (NW <= 0) return 0;
    const Probe P{{{fx_k, fx_v, fx_h, fx_bits}, {fp_k, fp_v, fp_h, fp_bits},
                   {rx_k, rx_v, rx_h, rx_bits}, {rp_k, rp_v, rp_h, rp_bits},
                   {k19_k, k19_v, k19_h, k19_bits}}, r_ids, n_rids};
    const cudaStream_t st = (cudaStream_t)stream;
#define SMR_PROBE_ARGS w1, w2, counts, minoccur, P, NW, pw, full_search, \
        out_count, scratch, st
    switch (probes_per_lane(pw)) {
        case 2: return (int)launch_probe<2>(SMR_PROBE_ARGS);
        case 3: return (int)launch_probe<3>(SMR_PROBE_ARGS);
        case 4: return (int)launch_probe<4>(SMR_PROBE_ARGS);
        case 5: return (int)launch_probe<5>(SMR_PROBE_ARGS);
        case 6: return (int)launch_probe<6>(SMR_PROBE_ARGS);
    }
#undef SMR_PROBE_ARGS
    return (int)cudaErrorInvalidValue;
}

int smr_seed_compact(const int* count, const int* scratch, int NW, int pw,
                     void* state, int* out_win, int* out_id, int* total,
                     void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (NW <= 0) return (int)cudaMemsetAsync(total, 0, sizeof(int), st);
    const int words = compact_state_words(NW);
    cudaError_t err = cudaMemsetAsync(state, 0, words * sizeof(u64), st);
    if (err != cudaSuccess) return (int)err;
    seed_compact_kernel<<<words - 1, CT, 0, st>>>(
        count, scratch, NW, pw, static_cast<u64*>(state), out_win, out_id,
        total);
    return (int)cudaGetLastError();
}

}  // extern "C"
