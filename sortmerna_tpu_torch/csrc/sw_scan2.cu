// Smith-Waterman column scan, v2 semantics, for Hopper (sm_90a): one warp
// a pair, an anti-diagonal wavefront across the lanes, DPX arithmetic.
//
// Replaces the JAX package's second Pallas TPU kernel
// sortmerna_tpu/ops/sw_pallas.py::_scan_kernel2 (wrapper sw_scan_pallas2,
// chosen by SMR_PALLAS=2), and folds in ops/sw_jax.py::sw_fused_call with
// that kernel dispatched, so a wave block is ONE launch here too.
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
//   * The column key is v2's packed (H << s) | (Lq - 1 - row); within a
//     lane it is folded as H * P + (P - 1 - slot), P >= KE a power of two,
//     which that packing bounds.  The tie (larger H, then smaller row) is
//     v2's in both its forms.
//   * F from Hpre, as the JAX closed form defines it: F_next = max(F - ge,
//     Hpre - go), Hpre taken before F is applied (not H: the two differ
//     when go < ge).  Invalid rows keep H = 0 but still feed their Hpre to
//     the F chain.  E and F are carried plus go, so each is one
//     __viaddmax_s32, H = max(F, Hpre) one more, and Hpre one
//     __viaddmax_s32_relu.
//   * Ref columns decoded once a pair into a 64-byte ring per warp in
//     shared memory, 32 columns ahead of the wavefront each 32 steps; the
//     substitution score is one LDS a cell from a 6 x 6 table (a row's
//     code is kept as its byte offset, so the address is one add).
//
// Tiles of more than 1,024 rows (long reads) run the same wavefront with a
// lane's rows in a lane-interleaved global scratch (3 * 32 * ceil(Lq / 32)
// ints a pair: H, E, the codes) and the column key as a 64-bit (H, row)
// pair, exact for any H (v2 packs its key only while (Lq << s) < 2^24).
// It is a size dispatch in the C entries (template K = 0), not a fallback.
//
// The function is v2's own, which differs from v1's (csrc/sw_scan.cu) on
// odd inputs only:
//   * an invalid ref column is encoded as char 7 (sw_pallas.py:322) and
//     read back clamped at 0 (the masked max of :211), so a column is
//     valid iff max(R_enc, 0) < 5 -- a char of 5 or more in a valid
//     column makes it invalid (v1 scores it as N);
//   * the select chain falls through to profile 0 (v1: profile 4);
//   * in a tile of 128 columns or more, column j is read from its
//     128-column chunk, and a last chunk that runs past Lr is read from
//     Lr - 128 on (the clamped dynamic slice of :210), so a tile width
//     that is not a multiple of 128 reads shifted columns there;
//   * NEG is -(1 << 29).
// The tie-break (earliest column, smallest row of the column max) is the
// one both of v2's forms give: its packed key for (Lq << s) < 2^24 and its
// three reductions above.
//
// Data-dependent work, exact for every input: a pair's rows stop at its
// last valid row and its columns at its last valid column; a terminate-
// mode scan stops once the pair is done; with gap penalties >= 0 the scan
// also starts at the first valid row and column (before them H stays 0,
// and the first valid column's E is -go from either start); the fused
// entry runs the begin pass only for pairs that pass (score >= minimal,
// end_ref >= 0).
//
// Plain C interface (loaded with ctypes); each entry returns the
// cudaError_t of its launch.  Launches go on the caller's stream, never
// synchronise and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 29);
constexpr int WARPS = 4;        // pairs per block on the register path
constexpr int CHUNK = 128;      // the TPU kernel's lane chunk of ref columns
constexpr int INVALID = 5;      // code of an invalid row / column
constexpr int RING = 64;        // ref columns decoded ahead, per warp
constexpr int MAX_K = 32;       // rows a lane on the register path
constexpr unsigned FULL = 0xffffffffu;

// tile column that column j is read from (v2's chunked read)
__device__ __forceinline__ int src_col(int j, int Lr) {
    if (Lr < CHUNK) return j;
    const int jc = j & ~(CHUNK - 1);
    return min(jc, Lr - CHUNK) + (j - jc);
}

__device__ __forceinline__ int nibble(const uint8_t* p, int c) {
    const int b = p[c >> 1];
    return (c & 1) ? (b & 15) : (b >> 4);
}

__device__ __forceinline__ int read_i32_le(const uint8_t* p) {
    return (int)((uint32_t)p[0] | ((uint32_t)p[1] << 8)
                 | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

// ------------------------------------------------------ rows and columns
// code(i): the profile row of query row i (0..4), INVALID outside the
// row mask.  code(j) of a column: its ref char (0..4), INVALID where v2
// reads it as invalid.  span(): the first and last valid row (-1, -1 if
// none) and whether a row between them is invalid, computed by the whole
// warp.

struct ArrayRows {              // sw_scan2: Q row + row_valid
    const int* Q;
    const uint8_t* rv;
    __device__ __forceinline__ int code(int i) const {
        return rv[i] ? min(max(Q[i], 0), 4) : INVALID;
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

struct PackedRows {             // sw_fused2: nibble-packed read window
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

struct ArrayCols {              // sw_scan2: R row + col_valid
    const int* R;
    const uint8_t* cv;
    int Lr;
    __device__ __forceinline__ int code(int j) const {
        const int c = src_col(j, Lr);
        const int r = max(cv[c] ? R[c] : 7, 0);
        return r < 5 ? r : INVALID;
    }
};

struct PackedCols {             // sw_fused2: nibble-packed ref window
    const uint8_t* p;
    int lr, lo, hi;             // col_valid: lo <= c < hi
    bool flip;                  // tile column c reads char lr-1-c
    __device__ __forceinline__ int code(int j) const {
        const int c = src_col(j, lr);
        if (c < lo || c >= hi) return INVALID;
        const int r = nibble(p, flip ? lr - 1 - c : c);
        return r < 5 ? r : INVALID;
    }
};

struct ScanResult {
    int best, end_ref, end_read;
};

__device__ __forceinline__ void load_tab(const int* mat, int* s_tab) {
    for (int i = threadIdx.x; i < 36; i += blockDim.x) {
        const int rc = i / 6, qc = i % 6;
        // sub(ref char rc, query char qc) = mat[rc][qc] (prof = mat.T[Q])
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
// key is v2's packed one (sb = its s); a lane folds its rows as
// H * P + (P - 1 - slot), P >= KE a power of two, which that packing
// bounds.  MASK: rows start at r0, the last lane's spare rows lie past r1,
// and rows outside the row mask are forced to H = 0.  Else (every row of
// the span valid, gap penalties >= 0) rows end at r1 and lane 0's spare
// rows lie before r0: such rows keep H = 0 by themselves and hand the
// first real row an F <= 0, which changes no H there (Hpre >= 0) nor the
// F after it; in the key they count as row 0 (their H is 0).
template <int KE, bool MASK, class Rows, class Cols>
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
// and the column key is 64-bit (sb = 32), exact for any H (v2 packs its
// key only while (Lq << s) < 2^24).
template <class Rows, class Cols>
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
template <int K, class Rows, class Cols>
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
        return wavefront_gmem(Lq, rows, r0, r1, cols, c0, c1, end_read0,
                              s_tab, ring, go, ge, terminate, tscore, lane,
                              scr, kn);
    } else {
        if (holes || !nonneg)
            return wavefront<K, true>(Lq, rows, r0, r1, cols, c0, c1,
                                      end_read0, s_tab, ring, go, ge,
                                      terminate, tscore, lane);
        // rows a lane fitted to the pair: the least KE of the ladder that
        // holds ceil((r1 - r0) / 32)
        const int ke = (r1 - r0 + 31) >> 5;
#define SMR_KE(N)                                                        \
        if constexpr (N <= K)                                            \
            if (ke <= N)                                                 \
                return wavefront<N, false>(Lq, rows, r0, r1, cols, c0,   \
                                           c1, end_read0, s_tab, ring,   \
                                           go, ge, terminate, tscore,    \
                                           lane);
        SMR_KE(1) SMR_KE(2) SMR_KE(3) SMR_KE(4) SMR_KE(5) SMR_KE(6)
        SMR_KE(7) SMR_KE(8) SMR_KE(10) SMR_KE(12) SMR_KE(14) SMR_KE(16)
        SMR_KE(20) SMR_KE(24) SMR_KE(28) SMR_KE(32)
#undef SMR_KE
        __builtin_unreachable();
    }
}

// One pair a warp.  K: the most rows a lane holds in registers; 0 for
// tiles of more than 32 * MAX_K rows, whose rows sit in scratch (kn rows a
// lane, 3 * kn * 32 words a pair).
template <int K>
__global__ void
sw_scan2_kernel(const int* __restrict__ Q, const uint8_t* __restrict__ rowv,
                const int* __restrict__ R, const uint8_t* __restrict__ colv,
                const int* __restrict__ mat, int go, int ge, int terminate,
                const int* __restrict__ tscore, int B, int Lq, int Lr,
                int kn, int* __restrict__ out, int* __restrict__ scratch) {
    __shared__ int s_tab[36];
    __shared__ uint8_t s_ring[WARPS][RING];
    load_tab(mat, s_tab);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * WARPS + w;
    if (b >= B) return;
    const ScanResult r = warp_scan<K>(
        Lq, ArrayRows{Q + (size_t)b * Lq, rowv + (size_t)b * Lq}, Lr,
        ArrayCols{R + (size_t)b * Lr, colv + (size_t)b * Lr, Lr}, s_tab,
        s_ring[w], go, ge, terminate != 0, tscore ? tscore[b] : 0, lane,
        scratch + (size_t)b * 3 * kn * 32, kn);
    if (lane == 0) {
        out[b] = r.best;
        out[B + b] = r.end_ref;
        out[2 * B + b] = r.end_read;
    }
}

template <int K>
__global__ void
sw_fused2_kernel(const uint8_t* __restrict__ buf, const int* __restrict__ mat,
                 int B, int lq, int lr, int go, int ge, int kn,
                 int* __restrict__ out, int* __restrict__ scratch) {
    __shared__ int s_tab[36];
    __shared__ uint8_t s_ring[WARPS][RING];
    load_tab(mat, s_tab);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * WARPS + w;
    if (b >= B) return;
    const int hq = lq / 2, hr = lr / 2;
    const uint8_t* row = buf + (size_t)b * (hq + hr + 12);
    const uint8_t* qp = row;
    const uint8_t* rp = row + hq;
    const int q_len = read_i32_le(row + hq + hr);
    const int r_len = read_i32_le(row + hq + hr + 4);
    const int minimal = read_i32_le(row + hq + hr + 8);
    int* scr = scratch + (size_t)b * 3 * kn * 32;

    // ---- forward pass: rows < q_len, columns < r_len
    const ScanResult fw = warp_scan<K>(
        lq, PackedRows{qp, lq, 0, q_len, false}, lr,
        PackedCols{rp, lr, 0, r_len, false}, s_tab, s_ring[w], go, ge,
        false, 0, lane, scr, kn);
    const int score = fw.best, end_ref = fw.end_ref;
    // ssw init semantics: end_read defaults to qlen-1 when nothing scored
    const int end_read = end_ref >= 0 ? fw.end_read : q_len - 1;

    // ---- begin pass on the flipped tile, terminate at `score`
    int beg_ref = -1, beg_read = -1;
    if (score >= minimal && end_ref >= 0) {
        const ScanResult bw = warp_scan<K>(
            lq, PackedRows{qp, lq, lq - 1 - end_read, lq, true}, lr,
            PackedCols{rp, lr, lr - 1 - end_ref, lr, true}, s_tab,
            s_ring[w], go, ge, true, score, lane, scr, kn);
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

int rows_per_lane(int L) { return (L + 31) / 32; }

// rows a lane on the register path, rounded up to a power of two; 0 for
// tiles of more than 32 * MAX_K rows (rows in scratch)
int reg_k(int L) {
    const int k = rows_per_lane(L);
    for (int c = 1; c <= MAX_K; c <<= 1)
        if (k <= c) return c;
    return 0;
}

}  // namespace

extern "C" {

// Scratch ints the wrapper allocates for a tile of query width L: none on
// the register path (L <= 1024); above, planes H, E and the row codes of
// rows_per_lane(L) rows a lane.
long long smr_sw2_scratch_ints(int B, int L) {
    return reg_k(L) ? 0 : 3LL * rows_per_lane(L) * 32 * B;
}

int smr_sw_scan2(const int* Q, const uint8_t* rowv, const int* R,
                 const uint8_t* colv, const int* mat, int go, int ge,
                 int terminate, const int* tscore, int B, int Lq, int Lr,
                 int* out, int* scratch, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    const int kn = rows_per_lane(Lq);
#define SMR_SCAN2(KC) sw_scan2_kernel<KC><<<grid, block, 0, s>>>( \
        Q, rowv, R, colv, mat, go, ge, terminate, tscore, B, Lq, Lr, kn, \
        out, scratch)
    switch (reg_k(Lq)) {
        case 1: SMR_SCAN2(1); break;
        case 2: SMR_SCAN2(2); break;
        case 4: SMR_SCAN2(4); break;
        case 8: SMR_SCAN2(8); break;
        case 16: SMR_SCAN2(16); break;
        case 32: SMR_SCAN2(32); break;
        default: SMR_SCAN2(0); break;
    }
#undef SMR_SCAN2
    return (int)cudaGetLastError();
}

int smr_sw_fused2(const uint8_t* buf, const int* mat, int B, int lq, int lr,
                  int go, int ge, int* out, int* scratch, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    const int kn = rows_per_lane(lq);
#define SMR_FUSED2(KC) sw_fused2_kernel<KC><<<grid, block, 0, s>>>( \
        buf, mat, B, lq, lr, go, ge, kn, out, scratch)
    switch (reg_k(lq)) {
        case 1: SMR_FUSED2(1); break;
        case 2: SMR_FUSED2(2); break;
        case 4: SMR_FUSED2(4); break;
        case 8: SMR_FUSED2(8); break;
        case 16: SMR_FUSED2(16); break;
        case 32: SMR_FUSED2(32); break;
        default: SMR_FUSED2(0); break;
    }
#undef SMR_FUSED2
    return (int)cudaGetLastError();
}

}  // extern "C"
