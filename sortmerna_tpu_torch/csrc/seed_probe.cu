// The d<=1 window seed search (--device_probe) for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device function
// sortmerna_tpu/ops/seed_search.py::_probe_kernel (with _probe_table,
// _hash26 and the variant enumerators): for each read window w1.w2 (two
// packed pw-mers) the closed-form d<=1 neighbourhood is probed in the
// part's open-addressing hash tables (index/hashtab.py: uint64 keys, EMPTY
// all ones, linear probing, at most MAX_PROBES = 32 slots), the 0-error
// mode is selected, the bounded group expansions are read, and the ids are
// sorted and de-duplicated per window.
//
// Two kernels:
//   * seed_probe -- one warp per window.  Lanes 0 and 1 probe the 0-error
//     keys (F-exact and R-exact tables, both keyed by w1.w2) and the warp
//     picks the mode from them.  In the 0-error modes the window's one id
//     is known; otherwise the lanes share the other 18pw + 2 - 2 probes
//     (the 0-error lookups stand for the first substitution variant of
//     either subsearch, whose keys are the same), skipping a subsearch
//     whose 9-mer gate (kmer_counts > minoccur) is shut.  Each found
//     probe appends its id, or its group's ids (caps 4/4/16, start
//     indices clamped to len(r_ids)-1), to the warp's buffer in shared
//     memory (a shared atomic counter; order does not matter).  The warp
//     then sorts the buffer by rank (an element's place is the count of
//     smaller elements plus equal ones before it), keeps the first of
//     each run of equal ids, and writes the window's count and its sorted
//     unique ids to scratch.  BIG = 0x7FFFFFFF is "no id", as there.
//   * seed_compact -- one warp per window copies its ids to the output at
//     its offset (the inclusive prefix sum of the counts, taken by the
//     wrapper with torch.cumsum), beside the window index.
//
// What bounds it.  Bytes, and random ones: each lookup touches at least
// one 32-byte sector of a key table (8-byte keys) and a found one a
// sector of values; a window reads 8 bytes of input and a pair writes 8.
// There is no arithmetic to speak of (a few dozen integer operations a
// probe).  The tables of a 6 Mnt part (tens of MB) sit mostly in the 50 MB
// L2.  The design keeps the lookups of a window in flight together (one
// per lane) and writes only the ids that survive, so the output is
// O(hits), not O(windows x 439).
//
// Plain C interface (loaded with ctypes); each entry returns the
// cudaError_t of its launch.  Launches go on the caller's stream, never
// synchronise and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PROBES = 32;
constexpr u64 EMPTY = ~0ull;
constexpr int BIG = 0x7FFFFFFF;
constexpr int CAP_FDEL = 4, CAP_RSUB = 4, CAP_RDEL = 16;

__host__ __device__ __forceinline__ int ids_per_window(int pw) {
    return 7 + 48 * pw;
}

struct Table {
    const u64* keys;
    const int* vals;            // rows of `width` int32 (uint32 wrapped)
    int bits;
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

// slot of `key`, or -1: at most MAX_PROBES slots, stopping at the key or
// at an empty slot
__device__ __forceinline__ int lookup(const Table& t, u64 key) {
    const uint32_t mask = (1u << t.bits) - 1u;
    uint32_t cur = hash26(key, t.bits);
    for (int i = 0; i < MAX_PROBES; ++i) {
        const u64 k = t.keys[cur];
        if (k == key) return (int)cur;
        if (k == EMPTY) return -1;
        cur = (cur + 1) & mask;
    }
    return -1;
}

__device__ __forceinline__ u64 rev(u64 p, int width) {
    u64 out = 0;
    for (int i = 0; i < width; ++i) {
        out = (out << 2) | (p & 3);
        p >>= 2;
    }
    return out;
}

// variant v of _sub_variants: 0 is p itself, 1 + 4i + c puts char c at i
__device__ __forceinline__ u64 sub_variant(u64 p, int pw, int v) {
    if (v == 0) return p;
    const int i = (v - 1) >> 2, c = (v - 1) & 3;
    const int shift = 2 * (pw - 1 - i);
    return (p & ~(3ull << shift)) | ((u64)c << shift);
}

// _del_variants column k
__device__ __forceinline__ u64 del_variant(u64 p, int pw, int k) {
    const u64 hi = p >> (2 * (pw - k));
    const u64 lo = p & ((1ull << (2 * (pw - 1 - k))) - 1);
    return (hi << (2 * (pw - 1 - k))) | lo;
}

// _ins9_variants column 4k + c
__device__ __forceinline__ u64 ins9_variant(u64 p, int pw, int k, int c) {
    const u64 hi = p >> (2 * (pw - k));
    const u64 mid = (p >> 2) & ((1ull << (2 * (pw - 1 - k))) - 1);
    return ((((hi << 2) | (u64)c) << (2 * (pw - 1 - k)))) | mid;
}

struct Probe {
    Table fx, fp, rx, rp, k19;
    const int* r_ids;
    int n_rids;
};

__device__ __forceinline__ void emit(int* buf, int* n, int id) {
    if (id != BIG) buf[atomicAdd(n, 1)] = id;
}

// ids of group slot `slot` of an R table: r_ids[min(start + j, n-1)]
__device__ __forceinline__ void emit_group(const Probe& P, const int* val,
                                           int cap, int* buf, int* n) {
    const int start = val[0], count = min(val[1], cap);
    for (int j = 0; j < count; ++j)
        emit(buf, n, P.r_ids[min(start + j, P.n_rids - 1)]);
}

__global__ void __launch_bounds__(WARPS * 32)
seed_probe_kernel(const int* __restrict__ w1s, const int* __restrict__ w2s,
                  const long long* __restrict__ counts, long long minoccur,
                  Probe P, int NW, int pw, int full_search,
                  int* __restrict__ out_count, int* __restrict__ scratch) {
    extern __shared__ int smem[];
    const int K = ids_per_window(pw);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* buf = smem + warp * (2 * K + 1);
    int* sorted = buf + K;
    int* n = sorted + K;
    const int w = blockIdx.x * WARPS + warp;
    if (w >= NW) return;                // whole warps only: no block sync

    const u64 a = (u64)w1s[w], b = (u64)w2s[w];
    const int s = 2 * pw;
    const bool gate_f = counts[a] > minoccur;
    const bool gate_r = counts[b] > minoccur;
    const u64 key0 = (a << s) | b;
    int z = -1;
    if (lane == 0) z = lookup(P.fx, key0);
    if (lane == 1) z = lookup(P.rx, key0);
    const int zf = __shfl_sync(FULL, z, 0);     // F-exact slot of w1.w2
    const int rzf = __shfl_sync(FULL, z, 1);    // R-exact slot of w1.w2
    const bool zero_a = zf >= 0 && gate_f;
    const bool zero_b = rzf >= 0 && gate_r;
    const bool mode_a = !full_search && zero_a;
    const bool mode_b = !full_search && zero_b && !mode_a;
    if (lane == 0) *n = 0;
    __syncwarp();

    if (mode_a || mode_b) {
        if (lane == 0)
            emit(buf, n, mode_a ? P.fx.vals[zf] : P.rx.vals[rzf * 3 + 2]);
    } else {
        const int n_sub = 4 * pw + 1, n_del = pw, n_ins = 4 * pw;
        const u64 pr = rev(a, pw);
        const u64 c0 = a >> (s - 2);
        const int e_sub = n_sub, e_del = e_sub + n_del, e_ins = e_del + n_ins;
        const int e_rsub = e_ins + n_sub, e_rdel = e_rsub + n_del;
        const int e_rins = e_rdel + n_ins;
        for (int p = lane; p < e_rins; p += 32) {
            if (p < e_ins ? !gate_f : !gate_r) continue;
            if (p < e_sub) {                    // F-exact substitutions
                const int slot = p == 0 ? zf
                    : lookup(P.fx, (a << s) | sub_variant(b, pw, p));
                if (slot >= 0) emit(buf, n, P.fx.vals[slot]);
            } else if (p < e_del) {             // F-prefix deletions
                const u64 d = del_variant(b, pw, p - e_sub);
                const int slot = lookup(P.fp, (a << (s - 2)) | d);
                if (slot >= 0) {
                    const int start = P.fp.vals[2 * slot];
                    const int count = min(P.fp.vals[2 * slot + 1], CAP_FDEL);
                    for (int j = 0; j < count; ++j) emit(buf, n, start + j);
                }
            } else if (p < e_ins) {             // 19-mer insertions
                const int k = (p - e_del) >> 2, c = (p - e_del) & 3;
                const u64 v9 = ins9_variant(b, pw, k, c);
                const int slot = lookup(
                    P.k19, (a << (s + 2)) | (v9 << 2) | (b & 3));
                if (slot >= 0) emit(buf, n, P.k19.vals[slot]);
            } else if (p < e_rsub) {            // R-exact substitutions
                const int v = p - e_ins;
                const int slot = v == 0 ? rzf : lookup(
                    P.rx, (rev(sub_variant(pr, pw, v), pw) << s) | b);
                if (slot >= 0) emit_group(P, P.rx.vals + 3 * slot,
                                          CAP_RSUB, buf, n);
            } else if (p < e_rdel) {            // R-prefix deletions
                const u64 d = rev(del_variant(pr, pw, p - e_rsub), pw - 1);
                const int slot = lookup(P.rp, (d << s) | b);
                if (slot >= 0) emit_group(P, P.rp.vals + 2 * slot,
                                          CAP_RDEL, buf, n);
            } else {                            // reverse insertions
                const int k = (p - e_rdel) >> 2, c = (p - e_rdel) & 3;
                const u64 rv9 = rev(ins9_variant(pr, pw, k, c), pw);
                const int slot = lookup(
                    P.k19, (c0 << (2 * s)) | (rv9 << s) | b);
                if (slot >= 0) emit(buf, n, P.k19.vals[slot]);
            }
        }
    }
    __syncwarp();
    const int m = *n;

    // sort by rank (ties broken by position), then keep run heads
    for (int i = lane; i < m; i += 32) {
        const int v = buf[i];
        int rank = 0;
        for (int j = 0; j < m; ++j) {
            const int u = buf[j];
            rank += (u < v) || (u == v && j < i);
        }
        sorted[rank] = v;
    }
    __syncwarp();
    int* dst = scratch + (size_t)w * K;
    int kept = 0;
    for (int base = 0; base < m; base += 32) {
        const int i = base + lane;
        const bool keep = i < m && (i == 0 || sorted[i] != sorted[i - 1]);
        const unsigned ballot = __ballot_sync(FULL, keep);
        if (keep) dst[kept + __popc(ballot & ((1u << lane) - 1u))] = sorted[i];
        kept += __popc(ballot);
    }
    if (lane == 0) out_count[w] = kept;
}

__global__ void __launch_bounds__(WARPS * 32)
seed_compact_kernel(const int* __restrict__ count,
                    const long long* __restrict__ ends,
                    const int* __restrict__ scratch, int NW, int pw,
                    int* __restrict__ out_win, int* __restrict__ out_id) {
    const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (w >= NW) return;
    const int c = count[w];
    const long long off = ends[w] - c;
    const int* src = scratch + (size_t)w * ids_per_window(pw);
    for (int k = lane; k < c; k += 32) {
        out_win[off + k] = w;
        out_id[off + k] = src[k];
    }
}

}  // namespace

extern "C" {

int smr_seed_probe(const int* w1, const int* w2, const long long* counts,
                   long long minoccur,
                   const u64* fx_k, const int* fx_v, int fx_bits,
                   const u64* fp_k, const int* fp_v, int fp_bits,
                   const u64* rx_k, const int* rx_v, int rx_bits,
                   const u64* rp_k, const int* rp_v, int rp_bits,
                   const u64* k19_k, const int* k19_v, int k19_bits,
                   const int* r_ids, int n_rids, int NW, int pw,
                   int full_search, int* out_count, int* scratch,
                   void* stream) {
    if (NW <= 0) return 0;
    const Probe P{{fx_k, fx_v, fx_bits}, {fp_k, fp_v, fp_bits},
                  {rx_k, rx_v, rx_bits}, {rp_k, rp_v, rp_bits},
                  {k19_k, k19_v, k19_bits}, r_ids, n_rids};
    const size_t shmem = (size_t)WARPS * (2 * ids_per_window(pw) + 1)
                         * sizeof(int);
    seed_probe_kernel<<<(NW + WARPS - 1) / WARPS, WARPS * 32, shmem,
                        (cudaStream_t)stream>>>(
        w1, w2, counts, minoccur, P, NW, pw, full_search, out_count,
        scratch);
    return (int)cudaGetLastError();
}

int smr_seed_compact(const int* count, const long long* ends,
                     const int* scratch, int NW, int pw, int* out_win,
                     int* out_id, void* stream) {
    if (NW <= 0) return 0;
    seed_compact_kernel<<<(NW + WARPS - 1) / WARPS, WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
        count, ends, scratch, NW, pw, out_win, out_id);
    return (int)cudaGetLastError();
}

}  // extern "C"
