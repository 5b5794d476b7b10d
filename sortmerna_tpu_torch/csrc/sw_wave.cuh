// The Smith-Waterman column scan's DP core for Hopper (sm_90a): one warp a
// pair, an anti-diagonal wavefront across the lanes, DPX arithmetic.
// Shared by both SW sources: csrc/sw_scan.cu (v1: sw_scan, sw_fused) and
// csrc/sw_scan2.cu (v2: sw_scan2, sw_fused2).  Each brings its own row
// and column readers (what a char and a validity mean differs between the
// two on odd inputs) and its own NEG, the template argument of load_tab,
// wavefront, warp_scan and long_scan.
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
// Tiles of more than 1,024 rows (long reads) take the long-tile route, a
// size dispatch in the C entries, not a fallback.  One warp a pair would
// put a 30,000-nt read on one SM of 132, so a pair's rows are cut into
// stripes, one a warp, over the warps of a CTA and, for tiles of more than
// 8,192 rows, over the CTAs of a thread-block cluster:
//   * Inside a stripe the same register wavefront runs (stripe_wave: KE =
//     4, 8, 12 or 16 rows a lane, fitted to the pair so that its rows
//     spread over every warp of the launch, and always the MASK layout).
//   * At column j the last lane of stripe g hands the first lane of
//     stripe g+1 what one lane hands the next: its last row's H, the F
//     carry and the column key folded so far, here the 64-bit (H << 32) +
//     (Lq - 1 - row), exact for any H (the JAX scans pack their key only
//     while (Lq << s) < 2^24; the 64-bit key gives both of their forms).
//     The hand-off goes through a ring of LINK columns in the lower
//     warp's CTA (its shared memory, written through DSMEM when the two
//     warps sit in two CTAs of the cluster), published 32 columns at a
//     time by a release store of a count that the consumer reads with an
//     acquire load; the consumer acknowledges what it has read the same
//     way, so the producer never overwrites a column not yet read.
//   * Only the bottom stripe holds a column's whole key, so it alone
//     applies improved / terminate; when it is done it raises a flag in
//     every CTA of the cluster, and every wait loop of the stripes above
//     watches that flag, so no warp waits on a consumer that stopped.
//   * Each pass starts and ends with a cluster barrier that every thread
//     of every CTA reaches (a padding pair or an empty span included):
//     the first makes the reset counters visible (and every CTA of the
//     cluster started) before a remote write, the second orders the
//     bottom stripe's result, written into every CTA, before it is read,
//     and keeps a CTA's shared memory alive while others write into it.
//   * The launch (long_geom): 32 * STRIPE_K = 512 rows a warp at most;
//     ceil(Lq / 512) warps, one CTA of up to CTA_WARPS = 16 warps for
//     tiles up to 8,192 rows, else a cluster of ceil(warps / 16) CTAs (2,
//     4 and 8 for 16,384, 32,768 and 65,536 rows); one pair a cluster.
//     No tile of the port's length ladder is past 65,536 rows (MAX_ROWS);
//     the C entries refuse a wider one.
//
// Data-dependent work, exact for every input: a pair's rows stop at its
// last valid row and its columns at its last valid column; a terminate-
// mode scan stops once the pair is done; with gap penalties >= 0 the scan
// also starts at the first valid row and column (before them H stays 0,
// and the first valid column's E is -go from either start).

#pragma once

#include <cooperative_groups.h>
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

// The register path's wavefront steps over columns [c0, c1) (stripe_wave
// runs the same steps with the boundary rings).  At step t lane l
// computes column c0 + t - l: cells(trow, diag, f, bl, rev) runs the
// lane's rows of that column (diag: H of the row above its first,
// previous column; f: the F carry in, out), sets bl to its max H and rev
// to Lq - 1 - the smallest row holding it, and returns its last row's H.
// One __shfl_up_sync round a step hands lane l+1 that H, the F carry and
// the column key (H << sb) + (Lq - 1 - row) folded so far; the last lane
// holding a row, ll, has the whole column's key and applies improved /
// terminate.  F is carried plus go; f0 is lane 0's carry at its first
// row.
template <class Cols, class Cells>
__device__ __forceinline__ ScanResult wave_steps(
        int Lq, const Cols& cols, int c0, int c1, int ll, int f0,
        int end_read0, int sb, const int* s_tab, uint8_t* ring,
        bool terminate, int tscore, int lane, Cells&& cells) {
    int hup = 0;                // H of the row above, previous column
    int hl = 0, fo = f0;        // this lane's last outputs, with kv
    int kv = 0;
    int best = 0, end_ref = -1;
    int bkey = Lq - 1 - end_read0;
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
            int kvin = __shfl_up_sync(FULL, kv, 1);
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
                kv = max(kvin, (bl << sb) + rev);
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
            Lq - 1 - (int)(bkey & ((1 << sb) - 1))};
}

// The register wavefront: KE rows a lane, rows [r0, r1).  The cells of a
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
    return wave_steps(
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


// The pair's span: [r0, r1) the rows and [c0, c1) the columns that can
// change an output (rows below the last valid one change none, nor do
// columns past the last valid one), and end_read0, the scan's end_read
// when nothing scores.  Computed alike by every warp that runs the pair.
struct Span {
    int r0, r1, c0, c1, end_read0;
    bool holes, nonneg;
    __device__ __forceinline__ bool empty() const {
        return r1 <= r0 || c1 <= c0;
    }
};

template <class Rows, class Cols>
__device__ __forceinline__ Span pair_span(int Lq, const Rows& rows, int Lr,
                                          const Cols& cols, int go, int ge,
                                          int lane) {
    Span sp;
    int first, last;
    rows.span(Lq, lane, first, last, sp.holes);
    sp.nonneg = go >= 0 && ge >= 0;
    sp.end_read0 = last >= 0 ? last : Lq - 1;
    sp.r0 = (sp.nonneg && first > 0) ? first : 0;
    sp.r1 = last + 1;
    col_span(cols, Lr, lane, sp.nonneg, sp.c0, sp.c1);
    return sp;
}

// The whole column scan of one pair on one warp (all 32 lanes, converged);
// every lane returns the result.  ring: this warp's RING bytes of shared
// memory; K: the most rows a lane holds in registers.
template <int NEG, int K, class Rows, class Cols>
__device__ __forceinline__ ScanResult warp_scan(
        int Lq, const Rows& rows, int Lr, const Cols& cols,
        const int* s_tab, uint8_t* ring, int go, int ge, bool terminate,
        int tscore, int lane) {
    const Span sp = pair_span(Lq, rows, Lr, cols, go, ge, lane);
    const int r0 = sp.r0, r1 = sp.r1, c0 = sp.c0, c1 = sp.c1;
    const int end_read0 = sp.end_read0;
    if (sp.empty()) return {0, -1, end_read0};
    if (sp.holes || !sp.nonneg)
        return wavefront<NEG, K, true>(Lq, rows, r0, r1, cols, c0, c1,
                                       end_read0, s_tab, ring, go, ge,
                                       terminate, tscore, lane);
    // rows a lane fitted to the pair: the least KE of the ladder that
    // holds ceil((r1 - r0) / 32)
    const int ke = (r1 - r0 + 31) >> 5;
#define SMR_KE(N)                                                        \
    if constexpr (N <= K)                                                \
        if (ke <= N)                                                     \
            return wavefront<NEG, N, false>(                             \
                Lq, rows, r0, r1, cols, c0, c1, end_read0, s_tab, ring,  \
                go, ge, terminate, tscore, lane);
    SMR_KE(1) SMR_KE(2) SMR_KE(3) SMR_KE(4) SMR_KE(5) SMR_KE(6)
    SMR_KE(7) SMR_KE(8) SMR_KE(10) SMR_KE(12) SMR_KE(14) SMR_KE(16)
    SMR_KE(20) SMR_KE(24) SMR_KE(28) SMR_KE(32)
#undef SMR_KE
    __builtin_unreachable();
}

// Pair b of a packed SW wave block (sw_fused's input: per row the read
// and ref windows, two chars a byte, then q_len, r_len and minimal as
// little-endian int32), as sw_jax.py::sw_fused_call computes it: the
// forward pass over rows < q_len and columns < r_len, then the begin pass
// on the flipped tile from (lq-1-end_read, lr-1-end_ref) in terminate
// mode at the forward score, only for pairs that pass (score >= minimal,
// end_ref >= 0).  Cols: the source's packed column reader, Cols{bytes,
// lr, lo, hi, flip}; scan(rows, cols, terminate, tscore): the whole scan
// of the pair (warp_scan on one warp, long_scan over a cluster), which
// every thread that runs the pair calls alike.  The thread with writer
// set writes out[5, B].
template <class Cols, class Scan>
__device__ __forceinline__ void fused_pair(const uint8_t* buf, int b, int B,
                                           int lq, int lr, bool writer,
                                           int* out, Scan&& scan) {
    const int hq = lq / 2, hr = lr / 2;
    const uint8_t* row = buf + (size_t)b * (hq + hr + 12);
    const uint8_t* qp = row;
    const uint8_t* rp = row + hq;
    const int q_len = read_i32_le(row + hq + hr);
    const int r_len = read_i32_le(row + hq + hr + 4);
    const int minimal = read_i32_le(row + hq + hr + 8);

    // ---- forward pass: rows < q_len, columns < r_len
    const ScanResult fw = scan(PackedRows{qp, lq, 0, q_len, false},
                               Cols{rp, lr, 0, r_len, false}, false, 0);
    const int score = fw.best, end_ref = fw.end_ref;
    // ssw init semantics: end_read defaults to qlen-1 when nothing scored
    const int end_read = end_ref >= 0 ? fw.end_read : q_len - 1;

    // ---- begin pass on the flipped tile, terminate at `score`
    int beg_ref = -1, beg_read = -1;
    if (score >= minimal && end_ref >= 0) {
        const ScanResult bw = scan(
            PackedRows{qp, lq, lq - 1 - end_read, lq, true},
            Cols{rp, lr, lr - 1 - end_ref, lr, true}, true, score);
        beg_ref = lr - 1 - bw.end_ref;
        beg_read = lq - 1 - bw.end_read;
    }
    if (writer) {
        out[b] = score;
        out[B + b] = beg_ref;
        out[2 * B + b] = end_ref;
        out[3 * B + b] = beg_read;
        out[4 * B + b] = end_read;
    }
}

// ------------------------------------------------ the long-tile route
// (see the top note)

constexpr int CTA_WARPS = 16;   // most warps (stripes) a CTA
constexpr int MAX_CLUSTER = 8;  // most CTAs a cluster (the portable size)
constexpr int STRIPE_K = 16;    // most rows a lane
constexpr int LINK = 128;       // columns a boundary ring holds
constexpr int MAX_ROWS = 32 * STRIPE_K * CTA_WARPS * MAX_CLUSTER;

// A CTA's shared memory on the long-tile route.  Warp w's input boundary
// (from the warp above it, in this CTA or the one before) is h / f /
// key[w], with produced[w] the columns written there; consumed[w] counts
// the columns that warp w's consumer (the warp below) has read.
struct LongShared {
    long long key[CTA_WARPS][LINK];
    int h[CTA_WARPS][LINK];
    int f[CTA_WARPS][LINK];
    int produced[CTA_WARPS];
    int consumed[CTA_WARPS];
    int done;                   // the bottom stripe is done (terminate)
    int res[3];                 // the pair's result, from the bottom stripe
    int tab[TAB];
    uint8_t ring[CTA_WARPS][RING];
};

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.cluster.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.cluster.b32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// Stripe g of a pair's span (rows r0 + g * 32 * KE on, KE rows a lane,
// MASK layout) on this warp: the register wavefront's steps with lane 0
// fed from the boundary ring above (or the top of the span) and the last
// lane ll feeding the ring below; the bottom stripe applies improved /
// terminate and writes the result into every CTA's res.
template <int NEG, int KE, class Rows, class Cols>
__device__ __forceinline__ void stripe_wave(
        int Lq, const Rows& rows, const Span& sp, const Cols& cols,
        LongShared& sh, int g, int W, int go, int ge, bool terminate,
        int tscore, int lane) {
    namespace cg = cooperative_groups;
    constexpr int SR = 32 * KE;                 // rows a stripe
    const int r0 = sp.r0, r1 = sp.r1, c0 = sp.c0, c1 = sp.c1;
    const int S = (r1 - r0 + SR - 1) / SR;      // stripes of the pair
    if (g >= S) return;
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks();
    const int w = threadIdx.x >> 5;
    const bool top = g == 0, bottom = g == S - 1;
    const int rs = r0 + g * SR, re = min(rs + SR, r1);
    const int ll = (re - rs - 1) / KE;          // the last lane holding a row
    const int rb = rs + lane * KE;              // this lane's first row
    // the ring below (warp g+1's input) and the count that acknowledges
    // this warp's reads to the warp above
    const int wb = (g + 1) % W, wa = (g - 1 + W) % W;
    LongShared* below = bottom ? &sh : cl.map_shared_rank(&sh, (g + 1) / W);
    int* ack = top ? nullptr
                   : &cl.map_shared_rank(&sh, (g - 1) / W)->consumed[wa];

    int h[KE], e[KE], q[KE];
#pragma unroll
    for (int s = 0; s < KE; ++s) {
        const int i = rb + s;
        q[s] = 4 * (i < re ? rows.code(i) : INVALID);
        h[s] = 0;
        e[s] = NEG + go;
    }
    // the top stripe's F at its first row r0: NEG - (r0-1)*ge, plus go
    const int f0 = NEG - (r0 - 1) * ge + go;
    uint8_t* ring = sh.ring[w];
    const int* s_tab = sh.tab;
    int hup = 0, hl = 0, fo = f0;
    long long kv = 0;
    int best = 0, end_ref = -1;
    long long bkey = Lq - 1 - sp.end_read0;
    bool done = false;
    const int ncol = c1 - c0, nsteps = ncol + ll;
    for (int t0 = 0; t0 < nsteps; t0 += 32) {
        const int t1 = min(t0 + 32, nsteps);
        if (bottom && __shfl_sync(FULL, (int)done, ll)) {
            if (lane == 0)
                for (int r = 0; r < C; ++r)
                    st_release(&cl.map_shared_rank(&sh, r)->done, 1);
            break;
        }
        // wait for input columns [t0, t0 + 32) from above and for room
        // below for output columns up to t1 - ll, or for the pair's end
        int stop = 0;
        if (lane == 0) {
            const int need_in = top ? 0 : min(t0 + 32, ncol);
            const int need_ack = bottom ? 0 : t1 - ll - LINK;
            while (true) {
                if (!bottom && ld_acquire(&sh.done)) {
                    stop = 1;
                    break;
                }
                if ((need_in <= 0 || ld_acquire(&sh.produced[w]) >= need_in)
                    && (need_ack <= 0
                        || ld_acquire(&sh.consumed[w]) >= need_ack))
                    break;
            }
        }
        if (__shfl_sync(FULL, stop, 0)) break;
        __syncwarp();
        {
            const int j = c0 + t0 + lane;
            ring[(t0 + lane) & (RING - 1)] =
                (uint8_t)(j < c1 ? cols.code(j) : INVALID);
        }
        __syncwarp();
        for (int t = t0; t < t1; ++t) {
            // lane l-1's outputs of the last step (its column = ours)
            int din = __shfl_up_sync(FULL, hl, 1);
            int fin = __shfl_up_sync(FULL, fo, 1);
            long long kin = __shfl_up_sync(FULL, kv, 1);
            if (lane == 0) {
                if (top) {
                    din = 0;
                    fin = f0;
                    kin = 0;
                } else if (t < ncol) {
                    const int s = t & (LINK - 1);
                    din = sh.h[w][s];
                    fin = sh.f[w][s];
                    kin = sh.key[w][s];
                }
            }
            const int jo = t - lane;
            if (jo >= 0 && jo < ncol) {
                const int code = ring[jo & (RING - 1)];
                const char* trow = (const char*)(s_tab + code * 6);
                int diag = hup;
                hup = din;
                int f = fin, bl = -1, sl = 0;
#pragma unroll
                for (int s = 0; s < KE; ++s) {
                    const int hold = h[s];
                    e[s] = __viaddmax_s32(e[s], -ge, hold);
                    const int hpre = __viaddmax_s32_relu(
                        e[s], -go, diag + *(const int*)(trow + q[s]));
                    diag = hold;
                    int hv = __viaddmax_s32(f, -go, hpre);
                    f = __viaddmax_s32(f, -ge, hpre);
                    hv = q[s] == 4 * INVALID ? 0 : hv;
                    h[s] = hv;
                    sl = hv > bl ? s : sl;      // the first slot of the max
                    bl = max(bl, hv);
                }
                hl = h[KE - 1];
                fo = f;
                kv = max(kin, ((long long)bl << 32) + (Lq - 1 - rb - sl));
                if (lane == ll) {
                    if (!bottom) {
                        const int s = jo & (LINK - 1);
                        below->h[wb][s] = hl;
                        below->f[wb][s] = fo;
                        below->key[wb][s] = kv;
                    } else if (code != INVALID && !done) {
                        const int colmax = (int)(kv >> 32);
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
        if (!bottom && lane == ll)
            st_release(&below->produced[wb], min(t1 - ll, ncol));
        if (!top && lane == 0) st_release(ack, min(t1, ncol));
    }
    if (bottom) {
        bkey = __shfl_sync(FULL, bkey, ll);
        best = __shfl_sync(FULL, best, ll);
        end_ref = __shfl_sync(FULL, end_ref, ll);
        if (lane == 0)
            for (int r = 0; r < C; ++r) {
                LongShared* o = cl.map_shared_rank(&sh, r);
                o->res[0] = best;
                o->res[1] = end_ref;
                o->res[2] = Lq - 1 - (int)(bkey & 0xffffffffLL);
            }
    }
}

// The whole column scan of one pair over every warp of its cluster (W
// warps a CTA); every thread of the cluster calls it alike and returns the
// result.  sh.tab holds the substitution table.
template <int NEG, class Rows, class Cols>
__device__ __forceinline__ ScanResult long_scan(
        LongShared& sh, int W, int Lq, const Rows& rows, int Lr,
        const Cols& cols, int go, int ge, bool terminate, int tscore) {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    const int lane = threadIdx.x & 31;
    const int g = (int)cl.block_rank() * W + (threadIdx.x >> 5);
    const int warps = (int)cl.num_blocks() * W;
    if (threadIdx.x < CTA_WARPS) {
        sh.produced[threadIdx.x] = 0;
        sh.consumed[threadIdx.x] = 0;
    }
    if (threadIdx.x == 0) sh.done = 0;
    cl.sync();
    const Span sp = pair_span(Lq, rows, Lr, cols, go, ge, lane);
    if (!sp.empty()) {
        // rows a lane that spread the span over every warp, on the ladder
        const int ke = (sp.r1 - sp.r0 + 32 * warps - 1) / (32 * warps);
        if (ke <= 4)
            stripe_wave<NEG, 4>(Lq, rows, sp, cols, sh, g, W, go, ge,
                                terminate, tscore, lane);
        else if (ke <= 8)
            stripe_wave<NEG, 8>(Lq, rows, sp, cols, sh, g, W, go, ge,
                                terminate, tscore, lane);
        else if (ke <= 12)
            stripe_wave<NEG, 12>(Lq, rows, sp, cols, sh, g, W, go, ge,
                                 terminate, tscore, lane);
        else
            stripe_wave<NEG, 16>(Lq, rows, sp, cols, sh, g, W, go, ge,
                                 terminate, tscore, lane);
    }
    cl.sync();
    if (sp.empty()) return {0, -1, sp.end_read0};
    return {sh.res[0], sh.res[1], sh.res[2]};
}

// ------------------------------------------------------------ launches

// rows a lane on the register path, rounded up to a power of two; 0 for
// tiles of more than 32 * MAX_K rows (the long-tile route)
inline int reg_k(int L) {
    const int k = (L + 31) / 32;
    for (int c = 1; c <= MAX_K; c <<= 1)
        if (k <= c) return c;
    return 0;
}

// Calls launch(std::integral_constant<int, reg_k(L)>()) for a tile of L
// <= 32 * MAX_K rows: the C entries launch the register-path kernel
// instantiation that the tile takes.
template <class Launch>
inline void by_reg_k(int L, Launch&& launch) {
    switch (reg_k(L)) {
        case 1: launch(std::integral_constant<int, 1>()); break;
        case 2: launch(std::integral_constant<int, 2>()); break;
        case 4: launch(std::integral_constant<int, 4>()); break;
        case 8: launch(std::integral_constant<int, 8>()); break;
        case 16: launch(std::integral_constant<int, 16>()); break;
        default: launch(std::integral_constant<int, 32>()); break;
    }
}

// The long-tile route's launch for a tile of L rows: warps a CTA and CTAs
// a cluster (see the top note); cluster > MAX_CLUSTER past MAX_ROWS.
struct LongGeom {
    int warps, cluster;
};

inline LongGeom long_geom(int L) {
    const int need = (L + 32 * STRIPE_K - 1) / (32 * STRIPE_K);
    const int c = (need + CTA_WARPS - 1) / CTA_WARPS;
    return {(need + c - 1) / c, c};
}

// Launches a long-tile kernel, one cluster a pair, B pairs; returns the
// cudaError_t of the launch (cudaErrorInvalidValue past MAX_ROWS; a
// cluster the card cannot place is refused by the launch itself).
template <class... Params, class... Args>
inline int launch_long(void (*kernel)(Params...), int B, int L,
                       cudaStream_t stream, Args... args) {
    const LongGeom geo = long_geom(L);
    if (geo.cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * geo.cluster);
    cfg.blockDim = dim3(32 * geo.warps);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = geo.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace smr_wave
