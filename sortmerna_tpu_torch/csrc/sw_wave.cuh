// The Smith-Waterman column scan's DP core for Hopper (sm_90a): one warp a
// pair, an anti-diagonal wavefront across the lanes, DPX arithmetic.
// Shared by both SW sources: csrc/sw_scan.cu (v1: sw_scan, sw_fused) and
// csrc/sw_scan2.cu (v2: sw_scan2, sw_fused2).  Each brings its own row
// and column readers (what a char and a validity mean differs between the
// two on odd inputs) and its own NEG, the template argument of load_tab,
// wavefront, wavefront_gmem and warp_scan.
//
// What bounds it.  The work is an int32 max-plus recurrence: a 4096 x 256 x
// 256 wave block reads about 1 MB for about 113 M DP cells, so the bound is
// integer operations (6 a cell with DPX, chip_smoke.py's OPS_PER_CELL), not
// bytes.  Tensor cores do not compute max-plus and there are no tiles for
// TMA to move; what helps is DPX and keeping the DP state out of memory.
//
// The design.
//   * One warp a pair (4 warps a block).  Lane l owns a contiguous run of
//     rows; H, E and the rows' profile codes live in registers for tiles
//     of up to 32 * MAX_K = 1,024 rows (template K, the most rows a lane
//     may need: the tile's ceil(Lq / 32) rounded up to a power of two).
//     No global scratch on this path.
//   * Rows fitted to the pair, not the tile: over the pair's span [r0, r1)
//     of rows that can change an output, k_eff = ceil((r1 - r0) / 32), and
//     the pair runs the wavefront instantiated for KE, the least of 1..8,
//     10, 12, 14, 16, 20, 24, 28, 32 that is >= k_eff.  A 120-row read in
//     a 256-row tile runs 4 rows a lane, not 8.  KE is a template, so a
//     step's KE cells are straight-line code: their table loads issue
//     together and only the F chain runs in series.
//   * An anti-diagonal wavefront instead of a scan inside each column: at
//     step t lane l computes column t - l over its rows.  One
//     __shfl_up_sync round a step passes three things from lane l-1: its
//     last row's H (the diagonal input of lane l one step later), its
//     outgoing F carry, and the column key folded so far.  No prefix scan
//     and no butterfly per column; the last lane that holds a row has the
//     column's whole key, and it alone applies improved / terminate,
//     strictly in column order.  A terminated warp learns of it within 32
//     steps (one __shfl_sync each 32 steps).  A pair takes
//     (c1 - c0) + ceil((r1 - r0) / KE) - 1 steps.
//   * The column key is the JAX scans' packed (H << s) | (Lq - 1 - row);
//     within a lane it is folded as H * P + (P - 1 - slot), P >= KE a
//     power of two, which that packing bounds.  The tie (larger H, then
//     smaller row) is the JAX scans' in both their forms: the packed key
//     while (Lq << s) < 2^24, which holds for every tile of the register
//     path, and three reductions above.
//   * F from Hpre, as the JAX closed form defines it: F_next = max(F - ge,
//     Hpre - go), Hpre taken before F is applied (not H: the two differ
//     when go < ge).  Invalid rows keep H = 0 but still feed their Hpre to
//     the F chain.  E and F are carried plus go, so each is one
//     __viaddmax_s32, H = max(F, Hpre) one more, and Hpre one
//     __viaddmax_s32_relu.  The carried forms start at e = NEG + go and
//     f0 = NEG - (rb0 - 1) * ge + go and fall by at most one ge before an
//     Hpre >= 0 lifts them, so they stay in int32 while (Lq + 1) * |ge| +
//     |go| < 2^30 with v1's NEG = -(1 << 30) (2^29 with v2's): the range
//     of the JAX closed form's own NEG - (row - 1) * ge.
//   * Ref columns decoded once a pair into a 64-byte ring per warp in
//     shared memory, 32 columns ahead of the wavefront each 32 steps; the
//     substitution score is one LDS a cell from a 7 x 6 table (a row's
//     code is kept as its byte offset, so the address is one add).
//
// Tiles of more than 1,024 rows (long reads) run the same wavefront with a
// lane's rows in a lane-interleaved global scratch (3 * 32 * ceil(Lq / 32)
// ints a pair: H, E, the codes) and the column key as a 64-bit (H, row)
// pair, exact for any H.  It is a size dispatch in the C entries (template
// K = 0), not a fallback.
//
// Data-dependent work, exact for every input: a pair's rows stop at its
// last valid row and its columns at its last valid column; a terminate-
// mode scan stops once the pair is done; with gap penalties >= 0 the scan
// also starts at the first valid row and column (before them H stays 0,
// and the first valid column's E is -go from either start).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace smr_wave {

constexpr int WARPS = 4;        // pairs per block
constexpr int INVALID = 5;      // code of an invalid row / column
constexpr int BLANK = 6;        // a valid column that scores NEG everywhere
constexpr int TAB = 7 * 6;      // table ints: column codes 0..6 x row 0..5
constexpr int RING = 64;        // ref columns decoded ahead, per warp
constexpr int MAX_K = 32;       // rows a lane on the register path
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int nibble(const uint8_t* p, int c) {
    const int b = p[c >> 1];
    return (c & 1) ? (b & 15) : (b >> 4);
}

__device__ __forceinline__ int read_i32_le(const uint8_t* p) {
    return (int)((uint32_t)p[0] | ((uint32_t)p[1] << 8)
                 | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

// ------------------------------------------------------------------ rows
// code(i): the profile row of query row i (0..4), INVALID outside the
// row mask.  span(): the first and last valid row (-1, -1 if none) and
// whether a row between them is invalid, computed by the whole warp.
// A column reader (in each source) has code(j): the column's ref char
// (0..4), INVALID where the column is invalid, BLANK for a valid column
// that scores NEG in every row.

// the profile row that the JAX package's mat.T[Q] reads: a negative index
// wraps once, then it clamps to 0..4
__device__ __forceinline__ int profile_row(int q) {
    return min(max(q < 0 ? q + 5 : q, 0), 4);
}

struct ArrayRows {              // the scan contract: Q row + row_valid
    const int* Q;
    const uint8_t* rv;
    __device__ __forceinline__ int code(int i) const {
        return rv[i] ? profile_row(Q[i]) : INVALID;
    }
    __device__ __forceinline__ void span(int Lq, int lane, int& first,
                                         int& last, bool& holes) const {
        first = -1;
        last = -1;
        int n = 0;
        for (int base = 0; base < Lq; base += 32) {
            const int i = base + lane;
            const unsigned m = __ballot_sync(FULL, i < Lq && rv[i]);
            if (m) {
                if (first < 0) first = base + __ffs(m) - 1;
                last = base + 31 - __clz(m);
                n += __popc(m);
            }
        }
        holes = n < last - first + 1;
    }
};

struct PackedRows {             // the fused entries: nibble-packed read
    const uint8_t* p;
    int lq, lo, hi;             // valid rows: lo <= i < hi
    bool flip;                  // row i reads char lq-1-i
    __device__ __forceinline__ int code(int i) const {
        if (i < lo || i >= hi) return INVALID;
        return min(nibble(p, flip ? lq - 1 - i : i), 4);
    }
    __device__ __forceinline__ void span(int Lq, int, int& first,
                                         int& last, bool& holes) const {
        first = max(lo, 0);
        last = min(hi, Lq) - 1;
        if (first > last) first = last = -1;
        holes = false;
    }
};

struct ScanResult {
    int best, end_ref, end_read;
};

// sub(ref code rc, query code qc) = mat[rc][qc] (prof = mat.T[Q]); NEG for
// an invalid row or column and for BLANK
template <int NEG>
__device__ __forceinline__ void load_tab(const int* mat, int* s_tab) {
    for (int i = threadIdx.x; i < TAB; i += blockDim.x) {
        const int rc = i / 6, qc = i % 6;
        s_tab[i] = (rc < 5 && qc < 5) ? mat[rc * 5 + qc] : NEG;
    }
    __syncthreads();
}

// -------------------------------------------- the warp wavefront scan

// [c0, c1): the columns that can change an output (see the note).
template <class Cols>
__device__ __forceinline__ void col_span(const Cols& cols, int Lr, int lane,
                                         bool nonneg, int& c0, int& c1) {
    c1 = 0;
    for (int base = (Lr - 1) & ~31; base >= 0; base -= 32) {
        const int j = base + lane;
        const unsigned m =
            __ballot_sync(FULL, j < Lr && cols.code(j) != INVALID);
        if (m) {
            c1 = base + 32 - __clz(m);
            break;
        }
    }
    c0 = 0;
    if (nonneg)
        for (int base = 0; base < c1; base += 32) {
            const int j = base + lane;
            const unsigned m =
                __ballot_sync(FULL, j < c1 && cols.code(j) != INVALID);
            if (m) {
                c0 = base + __ffs(m) - 1;
                break;
            }
        }
}

// The wavefront's steps over columns [c0, c1), shared by both storages of
// the rows.  At step t lane l computes column c0 + t - l: cells(trow,
// diag, f, bl, rev) runs the lane's rows of that column (diag: H of the
// row above its first, previous column; f: the F carry in, out), sets bl
// to its max H and rev to Lq - 1 - the smallest row holding it, and
// returns its last row's H.  One __shfl_up_sync round a step hands lane
// l+1 that H, the F carry and the column key (H << sb) + (Lq - 1 - row)
// folded so far; the last lane holding a row, ll, has the whole column's
// key and applies improved / terminate.  F is carried plus go; f0 is
// lane 0's carry at its first row.
template <class Key, class Cols, class Cells>
__device__ __forceinline__ ScanResult wave_steps(
        int Lq, const Cols& cols, int c0, int c1, int ll, int f0,
        int end_read0, int sb, const int* s_tab, uint8_t* ring,
        bool terminate, int tscore, int lane, Cells&& cells) {
    int hup = 0;                // H of the row above, previous column
    int hl = 0, fo = f0;        // this lane's last outputs, with kv
    Key kv = 0;
    int best = 0, end_ref = -1;
    Key bkey = Lq - 1 - end_read0;
    bool done = false;
    const int ncol = c1 - c0, nsteps = ncol + ll;
    for (int t0 = 0; t0 < nsteps; t0 += 32) {
        if (__shfl_sync(FULL, (int)done, ll)) break;
        __syncwarp();
        {
            const int j = c0 + t0 + lane;
            ring[(t0 + lane) & (RING - 1)] =
                (uint8_t)(j < c1 ? cols.code(j) : INVALID);
        }
        __syncwarp();
        const int t1 = min(t0 + 32, nsteps);
        for (int t = t0; t < t1; ++t) {
            // lane l-1's outputs of the last step (its column = ours)
            int din = __shfl_up_sync(FULL, hl, 1);
            int fin = __shfl_up_sync(FULL, fo, 1);
            Key kvin = __shfl_up_sync(FULL, kv, 1);
            if (lane == 0) {
                din = 0;
                fin = f0;
                kvin = 0;
            }
            const int jo = t - lane;
            if (jo >= 0 && jo < ncol) {
                const int code = ring[jo & (RING - 1)];
                const char* trow = (const char*)(s_tab + code * 6);
                const int diag = hup;
                hup = din;
                int f = fin, bl, rev;
                hl = cells(trow, diag, f, bl, rev);
                fo = f;
                kv = max(kvin, ((Key)bl << sb) + rev);
                if (lane == ll && code != INVALID && !done) {
                    const int colmax = (int)(kv >> sb);
                    if (colmax > best) {
                        best = colmax;
                        bkey = kv;
                        end_ref = c0 + jo;
                    }
                    if (terminate && colmax == tscore) done = true;
                }
            }
        }
    }
    bkey = __shfl_sync(FULL, bkey, ll);
    return {__shfl_sync(FULL, best, ll), __shfl_sync(FULL, end_ref, ll),
            Lq - 1 - (int)(bkey & (((Key)1 << sb) - 1))};
}

// The register storage: KE rows a lane, rows [r0, r1).  The cells of a
// step are straight-line code (KE is a template), so their table loads
// issue together and only the F chain runs in series.  E and F are
// carried plus go (e = E + go, f = F + go), so E is one __viaddmax_s32,
// Hpre one __viaddmax_s32_relu, H = max(F, Hpre) and the outgoing F one
// __viaddmax_s32 each.  q holds each row's code as a byte offset into a
// row of the table, so a cell's table address is one add.  The column
// key is the packed one (sb = its s); a lane folds its rows as
// H * P + (P - 1 - slot), P >= KE a power of two, which that packing
// bounds.  MASK: rows start at r0, the last lane's spare rows lie past r1,
// and rows outside the row mask are forced to H = 0.  Else (every row of
// the span valid, gap penalties >= 0) rows end at r1 and lane 0's spare
// rows lie before r0: such rows keep H = 0 by themselves and hand the
// first real row an F <= 0, which changes no H there (Hpre >= 0) nor the
// F after it; in the key they count as row 0 (their H is 0).
template <int NEG, int KE, bool MASK, class Rows, class Cols>
__device__ __forceinline__ ScanResult wavefront(
        int Lq, const Rows& rows, int r0, int r1, const Cols& cols, int c0,
        int c1, int end_read0, const int* s_tab, uint8_t* ring, int go,
        int ge, bool terminate, int tscore, int lane) {
    constexpr int P = KE <= 1 ? 1 : KE <= 2 ? 2 : KE <= 4 ? 4 : KE <= 8 ? 8
                    : KE <= 16 ? 16 : 32;
    constexpr int LP = P == 1 ? 0 : P == 2 ? 1 : P == 4 ? 2 : P == 8 ? 3
                     : P == 16 ? 4 : 5;
    const int ll = (r1 - r0 - 1) / KE;      // the last lane holding a row
    const int rb0 = MASK ? r0 : r1 - (ll + 1) * KE;
    const int rb = rb0 + lane * KE;         // this lane's first row
    int h[KE], e[KE], q[KE];
#pragma unroll
    for (int s = 0; s < KE; ++s) {
        const int i = rb + s;
        q[s] = 4 * ((i >= r0 && i < r1) ? rows.code(i) : INVALID);
        h[s] = 0;
        e[s] = NEG + go;
    }
    // lane 0's F at its first row rb0: the closed form's NEG - (rb0-1)*ge
    const int f0 = NEG - (rb0 - 1) * ge + go;
    return wave_steps<int>(
        Lq, cols, c0, c1, ll, f0, end_read0, max(32 - __clz(Lq - 1), 1),
        s_tab, ring, terminate, tscore, lane,
        [&](const char* trow, int diag, int& f, int& bl, int& rev) {
            int kk = INT32_MIN;
#pragma unroll
            for (int s = 0; s < KE; ++s) {
                const int hold = h[s];
                e[s] = __viaddmax_s32(e[s], -ge, hold);
                const int hpre = __viaddmax_s32_relu(
                    e[s], -go, diag + *(const int*)(trow + q[s]));
                diag = hold;
                int hv = __viaddmax_s32(f, -go, hpre);
                f = __viaddmax_s32(f, -ge, hpre);
                if constexpr (MASK) hv = q[s] == 4 * INVALID ? 0 : hv;
                h[s] = hv;
                kk = max(kk, hv * P + (P - 1 - s));
            }
            bl = kk >> LP;
            rev = min(Lq - rb - P + (kk & (P - 1)), Lq - 1);
            return h[KE - 1];
        });
}

// Tiles of more than 32 * MAX_K rows: the rows sit in a lane-interleaved
// global scratch (slot s of lane l is word s * 32 + l of each of three
// planes of kn * 32 words: H, E, the codes), rows from r0 on as in MASK,
// and the column key is 64-bit (sb = 32), exact for any H (the JAX scans
// pack their key only while (Lq << s) < 2^24).
template <int NEG, class Rows, class Cols>
__device__ __forceinline__ ScanResult wavefront_gmem(
        int Lq, const Rows& rows, int r0, int r1, const Cols& cols, int c0,
        int c1, int end_read0, const int* s_tab, uint8_t* ring, int go,
        int ge, bool terminate, int tscore, int lane, int* scr, int kn) {
    const int ke = (r1 - r0 + 31) >> 5;     // rows a lane
    const int ll = (r1 - r0 - 1) / ke;
    const int rb = r0 + lane * ke;
    int* H = scr + lane;
    int* E = H + kn * 32;
    int* C = E + kn * 32;
    for (int s = 0; s < ke; ++s) {
        const int i = rb + s;
        C[s * 32] = 4 * (i < r1 ? rows.code(i) : INVALID);
        H[s * 32] = 0;
        E[s * 32] = NEG + go;
    }
    return wave_steps<long long>(
        Lq, cols, c0, c1, ll, NEG - (r0 - 1) * ge + go, end_read0, 32,
        s_tab, ring, terminate, tscore, lane,
        [&](const char* trow, int diag, int& f, int& bl, int& rev) {
            int hv = 0;
            bl = -1;
            for (int s = 0; s < ke; ++s) {
                const int hold = H[s * 32];
                const int qs = C[s * 32];
                const int es = __viaddmax_s32(E[s * 32], -ge, hold);
                E[s * 32] = es;
                const int hpre = __viaddmax_s32_relu(
                    es, -go, diag + *(const int*)(trow + qs));
                diag = hold;
                hv = __viaddmax_s32(f, -go, hpre);
                f = __viaddmax_s32(f, -ge, hpre);
                hv = qs == 4 * INVALID ? 0 : hv;
                H[s * 32] = hv;
                if (hv > bl) {
                    bl = hv;
                    rev = Lq - 1 - rb - s;
                }
            }
            return hv;
        });
}

// The whole column scan of one pair on one warp (all 32 lanes, converged);
// every lane returns the result.  ring: this warp's RING bytes of shared
// memory; K: the most rows a lane holds in registers, 0 for the global
// scratch scr of kn rows a lane.
template <int NEG, int K, class Rows, class Cols>
__device__ __forceinline__ ScanResult warp_scan(
        int Lq, const Rows& rows, int Lr, const Cols& cols,
        const int* s_tab, uint8_t* ring, int go, int ge, bool terminate,
        int tscore, int lane, int* scr, int kn) {
    int first, last;
    bool holes;
    rows.span(Lq, lane, first, last, holes);
    const bool nonneg = go >= 0 && ge >= 0;
    const int end_read0 = last >= 0 ? last : Lq - 1;
    const int r0 = (nonneg && first > 0) ? first : 0;
    const int r1 = last + 1;    // rows below the last valid one change
                                // no output, nor do columns past the last
    int c0, c1;
    col_span(cols, Lr, lane, nonneg, c0, c1);
    if (r1 <= r0 || c1 <= c0) return {0, -1, end_read0};
    if constexpr (K == 0) {
        return wavefront_gmem<NEG>(Lq, rows, r0, r1, cols, c0, c1,
                                   end_read0, s_tab, ring, go, ge,
                                   terminate, tscore, lane, scr, kn);
    } else {
        if (holes || !nonneg)
            return wavefront<NEG, K, true>(Lq, rows, r0, r1, cols, c0, c1,
                                           end_read0, s_tab, ring, go, ge,
                                           terminate, tscore, lane);
        // rows a lane fitted to the pair: the least KE of the ladder that
        // holds ceil((r1 - r0) / 32)
        const int ke = (r1 - r0 + 31) >> 5;
#define SMR_KE(N)                                                        \
        if constexpr (N <= K)                                            \
            if (ke <= N)                                                 \
                return wavefront<NEG, N, false>(                         \
                    Lq, rows, r0, r1, cols, c0, c1, end_read0, s_tab,    \
                    ring, go, ge, terminate, tscore, lane);
        SMR_KE(1) SMR_KE(2) SMR_KE(3) SMR_KE(4) SMR_KE(5) SMR_KE(6)
        SMR_KE(7) SMR_KE(8) SMR_KE(10) SMR_KE(12) SMR_KE(14) SMR_KE(16)
        SMR_KE(20) SMR_KE(24) SMR_KE(28) SMR_KE(32)
#undef SMR_KE
        __builtin_unreachable();
    }
}

// Pair b of a packed SW wave block (sw_fused's input: per row the read
// and ref windows, two chars a byte, then q_len, r_len and minimal as
// little-endian int32) on one warp, as sw_jax.py::sw_fused_call computes
// it: the forward pass over rows < q_len and columns < r_len, then the
// begin pass on the flipped tile from (lq-1-end_read, lr-1-end_ref) in
// terminate mode at the forward score, only for pairs that pass (score >=
// minimal, end_ref >= 0).  Cols: the source's packed column reader,
// Cols{bytes, lr, lo, hi, flip}.  Lane 0 writes out[5, B].
template <int NEG, int K, class Cols>
__device__ __forceinline__ void fused_pair(
        const uint8_t* buf, int b, int B, int lq, int lr, int go, int ge,
        int kn, const int* s_tab, uint8_t* ring, int lane, int* out,
        int* scratch) {
    const int hq = lq / 2, hr = lr / 2;
    const uint8_t* row = buf + (size_t)b * (hq + hr + 12);
    const uint8_t* qp = row;
    const uint8_t* rp = row + hq;
    const int q_len = read_i32_le(row + hq + hr);
    const int r_len = read_i32_le(row + hq + hr + 4);
    const int minimal = read_i32_le(row + hq + hr + 8);
    int* scr = scratch + (size_t)b * 3 * kn * 32;

    // ---- forward pass: rows < q_len, columns < r_len
    const ScanResult fw = warp_scan<NEG, K>(
        lq, PackedRows{qp, lq, 0, q_len, false}, lr,
        Cols{rp, lr, 0, r_len, false}, s_tab, ring, go, ge, false, 0, lane,
        scr, kn);
    const int score = fw.best, end_ref = fw.end_ref;
    // ssw init semantics: end_read defaults to qlen-1 when nothing scored
    const int end_read = end_ref >= 0 ? fw.end_read : q_len - 1;

    // ---- begin pass on the flipped tile, terminate at `score`
    int beg_ref = -1, beg_read = -1;
    if (score >= minimal && end_ref >= 0) {
        const ScanResult bw = warp_scan<NEG, K>(
            lq, PackedRows{qp, lq, lq - 1 - end_read, lq, true}, lr,
            Cols{rp, lr, lr - 1 - end_ref, lr, true}, s_tab, ring, go, ge,
            true, score, lane, scr, kn);
        beg_ref = lr - 1 - bw.end_ref;
        beg_read = lq - 1 - bw.end_read;
    }
    if (lane == 0) {
        out[b] = score;
        out[B + b] = beg_ref;
        out[2 * B + b] = end_ref;
        out[3 * B + b] = beg_read;
        out[4 * B + b] = end_read;
    }
}

inline int rows_per_lane(int L) { return (L + 31) / 32; }

// rows a lane on the register path, rounded up to a power of two; 0 for
// tiles of more than 32 * MAX_K rows (rows in scratch)
inline int reg_k(int L) {
    const int k = rows_per_lane(L);
    for (int c = 1; c <= MAX_K; c <<= 1)
        if (k <= c) return c;
    return 0;
}

// Calls launch(std::integral_constant<int, reg_k(L)>()): the C entries
// launch the kernel instantiation a tile of L rows takes with it.
template <class Launch>
inline void by_reg_k(int L, Launch&& launch) {
    switch (reg_k(L)) {
        case 1: launch(std::integral_constant<int, 1>()); break;
        case 2: launch(std::integral_constant<int, 2>()); break;
        case 4: launch(std::integral_constant<int, 4>()); break;
        case 8: launch(std::integral_constant<int, 8>()); break;
        case 16: launch(std::integral_constant<int, 16>()); break;
        case 32: launch(std::integral_constant<int, 32>()); break;
        default: launch(std::integral_constant<int, 0>()); break;
    }
}

// Scratch ints the wrapper allocates for a tile of query width L: none on
// the register path (L <= 1024); above, planes H, E and the row codes of
// rows_per_lane(L) rows a lane.
inline long long scratch_ints(int B, int L) {
    return reg_k(L) ? 0 : 3LL * rows_per_lane(L) * 32 * B;
}

}  // namespace smr_wave
