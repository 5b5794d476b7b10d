// Smith-Waterman column scan, batch-major layout, for Hopper (sm_90a).
//
// Replaces the JAX package's second Pallas TPU kernel
// sortmerna_tpu/ops/sw_pallas.py::_scan_kernel2 (wrapper sw_scan_pallas2,
// chosen by SMR_PALLAS=2), and folds in ops/sw_jax.py::sw_fused_call with
// that kernel dispatched, so a wave block is ONE launch here too.
//
// Layout.  The TPU kernel puts 512 pairs (SUB_B) on the sublanes of one
// grid step and the query rows on the lanes.  Here a thread block holds
// the same 512 pairs and a pair belongs to ONE thread, so the batch runs
// along the thread index.  The thread walks its pair's DP column by
// column, down the rows, as the TPU kernel's fori_loop does.  A column of
// H and E (up to Lq rows each) does not fit in a thread's registers, so
// the previous column's H and E, and the rows' profile codes, sit in a
// global scratch of three planes [Lq][B] that the wrapper allocates: row i
// of pair b is word i * B + b, so the 32 threads of a warp touch 32
// neighbouring words of each row (one 128-byte line) -- the scratch is
// interleaved across pairs.  Registers would hold only a few rows per
// thread, and shared memory (227 KB) not even one 256-row column for 512
// pairs, so global memory (L1 / L2) it is.
//
// What bounds it.  The recurrence needs 6 int32 operations per DP cell on
// sm_90a with its DPX instructions (counted in the note of csrc/sw_scan.cu
// and in chip_smoke.py's OPS_PER_CELL), so the card's bound is int32
// operations.  This kernel is far from it: it issues three loads and two
// stores of scratch per cell besides the arithmetic, and with one thread a
// pair a 4096-pair wave block is only 8 blocks of 16 warps on a card of
// 132 SMs.  It is the batch-major port, kept right and simple; csrc/
// sw_scan.cu (warp per pair, rows in registers) is the fast layout.
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
constexpr int SUB_B = 512;      // pairs per block: one grid step of the TPU
constexpr int CHUNK = 128;      // the TPU kernel's lane chunk of ref columns
constexpr int INVALID = 5;      // code of an invalid row / column

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
// reads it as invalid.

struct ArrayRows {              // sw_scan2: Q row + row_valid
    const int* Q;
    const uint8_t* rv;
    __device__ __forceinline__ int code(int i) const {
        return rv[i] ? min(max(Q[i], 0), 4) : INVALID;
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

// ------------------------------------------------------------ the scan

struct ScanResult {
    int best, end_ref, end_read;
};

// The whole column scan of one pair on one thread.  Planes H, E, C of the
// scratch hold the pair's column at stride ld (pair b's base is plane + b).
template <class Rows, class Cols>
__device__ ScanResult scan_pair(int* __restrict__ H, int* __restrict__ E,
                                int* __restrict__ C, size_t ld, int Lq,
                                const Rows& rows, int Lr, const Cols& cols,
                                const int* s_tab, int go, int ge,
                                bool terminate, int tscore) {
    // the rows' codes into the scratch; the first and last valid row
    int first = -1, last = -1;
    for (int i = 0; i < Lq; ++i) {
        const int q = rows.code(i);
        C[i * ld] = q;
        if (q != INVALID) {
            if (first < 0) first = i;
            last = i;
        }
    }
    const bool nonneg = go >= 0 && ge >= 0;
    const int end_read0 = last >= 0 ? last : Lq - 1;
    const int r0 = (nonneg && first > 0) ? first : 0;
    const int r1 = last + 1;            // rows below the last valid one
                                        // change no output
    int c1 = Lr;                        // nor do columns past the last
    while (c1 > 0 && cols.code(c1 - 1) == INVALID) --c1;
    int c0 = 0;
    if (nonneg)
        while (c0 < c1 && cols.code(c0) == INVALID) ++c0;

    for (int i = r0; i < r1; ++i) {
        H[i * ld] = 0;
        E[i * ld] = NEG;
    }
    int best = 0, end_ref = -1, end_read = end_read0;
    bool done = false;
    for (int j = c0; j < c1; ++j) {
        const int code = cols.code(j);
        const int* trow = s_tab + code * 6;
        int carry = 0;                  // H of the row above, last column
        int run = NEG;                  // prefix max of Hpre - go + row*ge
        int f_sub = (r0 - 1) * ge;      // (row - 1) * ge
        int g_ofs = r0 * ge;            // row * ge
        int bv = 0, br = 0;             // column max, its smallest row
        for (int i = r0; i < r1; ++i) {
            const size_t o = (size_t)i * ld;
            const int hold = H[o];
            const int q = C[o];
            const int diag = carry + trow[q];
            carry = hold;
            const int e = max(E[o] - ge, hold - go);
            E[o] = e;
            const int hpre = max(0, max(diag, e));
            const int f = run - f_sub;
            run = max(run, hpre - go + g_ofs);
            f_sub += ge;
            g_ofs += ge;
            const int h = q == INVALID ? 0 : max(hpre, f);
            H[o] = h;
            if (h > bv) {
                bv = h;
                br = i;
            }
        }
        if (code != INVALID && !done) {
            if (bv > best) {
                best = bv;
                end_ref = j;
                end_read = br;
            }
            if (terminate && bv == tscore) done = true;
        }
        if (done) break;
    }
    return {best, end_ref, end_read};
}

__device__ __forceinline__ void load_tab(const int* mat, int* s_tab) {
    for (int i = threadIdx.x; i < 36; i += blockDim.x) {
        const int rc = i / 6, qc = i % 6;
        // sub(ref char rc, query char qc) = mat[rc][qc] (prof = mat.T[Q])
        s_tab[i] = (rc < 5 && qc < 5) ? mat[rc * 5 + qc] : NEG;
    }
    __syncthreads();
}

// ------------------------------------------------------------- kernels

__global__ void __launch_bounds__(SUB_B)
sw_scan2_kernel(const int* __restrict__ Q, const uint8_t* __restrict__ rowv,
                const int* __restrict__ R, const uint8_t* __restrict__ colv,
                const int* __restrict__ mat, int go, int ge, int terminate,
                const int* __restrict__ tscore, int B, int Lq, int Lr,
                int* __restrict__ out, int* __restrict__ scratch) {
    __shared__ int s_tab[36];
    load_tab(mat, s_tab);
    const int b = blockIdx.x * SUB_B + threadIdx.x;
    if (b >= B) return;
    const size_t ld = (size_t)B, plane = (size_t)Lq * B;
    int* H = scratch + b;
    const ScanResult r = scan_pair(
        H, H + plane, H + 2 * plane, ld, Lq,
        ArrayRows{Q + (size_t)b * Lq, rowv + (size_t)b * Lq},
        Lr, ArrayCols{R + (size_t)b * Lr, colv + (size_t)b * Lr, Lr},
        s_tab, go, ge, terminate != 0, tscore ? tscore[b] : 0);
    out[b] = r.best;
    out[B + b] = r.end_ref;
    out[2 * B + b] = r.end_read;
}

__global__ void __launch_bounds__(SUB_B)
sw_fused2_kernel(const uint8_t* __restrict__ buf, const int* __restrict__ mat,
                 int B, int lq, int lr, int go, int ge,
                 int* __restrict__ out, int* __restrict__ scratch) {
    __shared__ int s_tab[36];
    load_tab(mat, s_tab);
    const int b = blockIdx.x * SUB_B + threadIdx.x;
    if (b >= B) return;
    const int hq = lq / 2, hr = lr / 2;
    const uint8_t* row = buf + (size_t)b * (hq + hr + 12);
    const uint8_t* qp = row;
    const uint8_t* rp = row + hq;
    const int q_len = read_i32_le(row + hq + hr);
    const int r_len = read_i32_le(row + hq + hr + 4);
    const int minimal = read_i32_le(row + hq + hr + 8);
    const size_t ld = (size_t)B, plane = (size_t)lq * B;
    int* H = scratch + b;

    // ---- forward pass: rows < q_len, columns < r_len
    const ScanResult fw = scan_pair(
        H, H + plane, H + 2 * plane, ld, lq,
        PackedRows{qp, lq, 0, q_len, false}, lr,
        PackedCols{rp, lr, 0, r_len, false}, s_tab, go, ge, false, 0);
    const int score = fw.best, end_ref = fw.end_ref;
    // ssw init semantics: end_read defaults to qlen-1 when nothing scored
    const int end_read = end_ref >= 0 ? fw.end_read : q_len - 1;

    // ---- begin pass on the flipped tile, terminate at `score`
    int beg_ref = -1, beg_read = -1;
    if (score >= minimal && end_ref >= 0) {
        const int q_start = lq - 1 - end_read;
        const int r_start = lr - 1 - end_ref;
        const ScanResult bw = scan_pair(
            H, H + plane, H + 2 * plane, ld, lq,
            PackedRows{qp, lq, q_start, lq, true}, lr,
            PackedCols{rp, lr, r_start, lr, true}, s_tab, go, ge, true,
            score);
        beg_ref = lr - 1 - bw.end_ref;
        beg_read = lq - 1 - bw.end_read;
    }
    out[b] = score;
    out[B + b] = beg_ref;
    out[2 * B + b] = end_ref;
    out[3 * B + b] = beg_read;
    out[4 * B + b] = end_read;
}

}  // namespace

extern "C" {

// Scratch ints the wrapper allocates: planes H, E and the row codes.
long long smr_sw2_scratch_ints(int B, int L) {
    return 3LL * L * B;
}

int smr_sw_scan2(const int* Q, const uint8_t* rowv, const int* R,
                 const uint8_t* colv, const int* mat, int go, int ge,
                 int terminate, const int* tscore, int B, int Lq, int Lr,
                 int* out, int* scratch, void* stream) {
    if (B <= 0) return 0;
    sw_scan2_kernel<<<(B + SUB_B - 1) / SUB_B, SUB_B, 0,
                      (cudaStream_t)stream>>>(
        Q, rowv, R, colv, mat, go, ge, terminate, tscore, B, Lq, Lr, out,
        scratch);
    return (int)cudaGetLastError();
}

int smr_sw_fused2(const uint8_t* buf, const int* mat, int B, int lq, int lr,
                  int go, int ge, int* out, int* scratch, void* stream) {
    if (B <= 0) return 0;
    sw_fused2_kernel<<<(B + SUB_B - 1) / SUB_B, SUB_B, 0,
                       (cudaStream_t)stream>>>(
        buf, mat, B, lq, lr, go, ge, out, scratch);
    return (int)cudaGetLastError();
}

}  // extern "C"
