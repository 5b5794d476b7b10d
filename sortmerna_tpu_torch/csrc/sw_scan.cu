// Smith-Waterman local-alignment column scan for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// sortmerna_tpu/ops/sw_pallas.py::_scan_kernel (and its XLA twin
// ops/sw_jax.py::_sw_scan), and folds in the device function
// ops/sw_jax.py::sw_fused_call, so the align task's SW wave is ONE launch:
// nibble unpack, forward scan, begin-coordinate scan on the flipped tile.
//
// What bounds it on this card: int32 ALU work per DP cell, not bytes -- a
// 4096 x 256 x 256 block reads about 1 MB of packed input for 268M cells.
// The recurrence needs 6 int32 instructions per cell on sm_90a with its
// DPX instructions: E = max(E - ge, Hgo) and F = max(F - ge, Hgo_up) one
// __viaddmax_s32 each, max(E, F) one, H = max(diag + sub, max(E, F), 0)
// one __viaddmax_s32_relu, Hgo = H - go one (shared by the next row's F
// and the next column's E), the column max one.  This kernel issues more
// (the closed-form F and the row of the column max cost extra).  The
// column recurrence is sequential, so the parallelism is across pairs and
// down the query rows:
//
//   * one warp per (query, ref) pair, 4 warps per block;
//   * lane l holds the contiguous rows [l*K, (l+1)*K) of the column;
//     for K <= 32 (Lq <= 1024) H, E and the query codes stay in
//     registers (template on K), wider tiles keep them in a global
//     scratch [B, 3, K, 32] that the wrapper allocates;
//   * diag: shift within the lane plus one __shfl_up_sync for the first
//     row of the chunk;
//   * F (the in-column gap run) in closed form: prefix max within the
//     lane, then a 5-step warp exclusive prefix max of the lane totals;
//   * the column max and its row by a __shfl_xor_sync butterfly over
//     (H, row) that keeps the smaller row on ties, which is exactly the
//     packed-key / 3-reduction tie-break of the JAX versions;
//   * sub comes from a 6x6 table in shared memory (the 5x5 matrix plus a
//     row and a column of NEG for invalid ref columns / query rows).
//
// Data-dependent work: a pair's forward scan stops at its r_len; a
// terminate-mode scan stops once the pair is done; the begin pass runs
// only for pairs that pass (score >= minimal, end_ref >= 0) and starts at
// the first valid flipped column (H is still all zero there).
//
// Plain C interface (loaded with ctypes); each entry returns the
// cudaError_t of its launch.  Launches go on the caller's stream, never
// synchronise and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int INVALID = 5;      // code of an invalid row / column

// -------------------------------------------------------------- storage

template <int K>
struct RegStore {               // K rows per lane in registers
    int h[K], e[K], q[K];
    __device__ __forceinline__ int& H(int k) { return h[k]; }
    __device__ __forceinline__ int& E(int k) { return e[k]; }
    __device__ __forceinline__ int& Q(int k) { return q[k]; }
};

struct GmemStore {              // rows in global scratch, lane-interleaved
    int* base;                  // scratch + pair * 3 * kn * 32 + lane
    int kn;
    __device__ __forceinline__ int& H(int k) { return base[k * 32]; }
    __device__ __forceinline__ int& E(int k) { return base[(kn + k) * 32]; }
    __device__ __forceinline__ int& Q(int k) {
        return base[(2 * kn + k) * 32];
    }
};

// ---------------------------------------------------------- col sources

struct ArrayCols {              // sw_scan: explicit R row + col_valid
    const int* R;
    const uint8_t* cv;
    int Lr;
    __device__ __forceinline__ int code(int j) const {
        if (j >= Lr || !cv[j]) return INVALID;
        int r = R[j];
        return (r >= 0 && r < 4) ? r : 4;    // where-chain: else p4
    }
};

struct PackedCols {             // sw_fused: nibble-packed ref window
    const uint8_t* p;           // packed ref bytes
    int lr, lo, hi;             // valid columns: lo <= j < hi
    bool flip;                  // column j reads char lr-1-j
    __device__ __forceinline__ int code(int j) const {
        if (j < lo || j >= hi) return INVALID;
        int c = flip ? lr - 1 - j : j;
        int b = p[c >> 1];
        int nib = (c & 1) ? (b & 15) : (b >> 4);
        return nib < 4 ? nib : 4;
    }
};

__device__ __forceinline__ int packed_char(const uint8_t* p, int c) {
    int b = p[c >> 1];
    int nib = (c & 1) ? (b & 15) : (b >> 4);
    return nib < 4 ? nib : 4;   // the profile gather clamps to row 4
}

__device__ __forceinline__ int read_i32_le(const uint8_t* p) {
    return (int)((uint32_t)p[0] | ((uint32_t)p[1] << 8)
                 | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

// ------------------------------------------------------------ the scan

struct ScanResult {
    int best, end_ref, end_read;
};

// Runs columns [j0, j1) of the SW column scan for one pair on one warp.
// The store holds H = 0, E = NEG and the query codes (0..4, INVALID for
// a row outside the row mask); end_read starts at the last valid row.
template <int KC, class Store, class Cols>
__device__ __forceinline__ ScanResult column_scan(
        Store& st, int kn, const Cols& cols, int j0, int j1,
        const int* s_tab, int go, int ge, bool terminate, int tscore,
        int lane, int end_read0) {
    const int K = KC > 0 ? KC : kn;
    const int rowbase = lane * K;
    int best = 0, end_ref = -1, end_read = end_read0;
    bool done = false;
    int chunk = -1, mycode = INVALID;
    for (int j = j0; j < j1; ++j) {
        const int cb = j & ~31;
        if (cb != chunk) {              // warp-uniform: 32 columns per load
            chunk = cb;
            mycode = cols.code(cb + lane);
        }
        const int code = __shfl_sync(FULL, mycode, j & 31);
        const int* trow = s_tab + code * 6;

        // pass 1: diag, E, Hpre (kept in H) and the lane's max of g
        int carry = __shfl_up_sync(FULL, st.H(K - 1), 1);
        if (lane == 0) carry = 0;
        int gtot = NEG;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int hold = st.H(k);
            const int diag = carry + trow[st.Q(k)];
            carry = hold;
            const int e = max(st.E(k) - ge, hold - go);
            st.E(k) = e;
            const int hpre = max(0, max(diag, e));
            st.H(k) = hpre;
            gtot = max(gtot, hpre - go + (rowbase + k) * ge);
        }
        // warp exclusive prefix max of the lane totals
        int x = gtot;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, x, d);
            if (lane >= d) x = max(x, y);
        }
        int run = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) run = NEG;

        // pass 2: F, H and the lane's (max H, smallest row)
        int bv = -1, br = 0x7fffffff;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int row = rowbase + k;
            const int hpre = st.H(k);
            const int f = run - (row - 1) * ge;
            run = max(run, hpre - go + row * ge);
            const int h = st.Q(k) == INVALID ? 0 : max(hpre, f);
            st.H(k) = h;
            if (h > bv) { bv = h; br = row; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const int ov = __shfl_xor_sync(FULL, bv, off);
            const int orow = __shfl_xor_sync(FULL, br, off);
            if (ov > bv || (ov == bv && orow < br)) { bv = ov; br = orow; }
        }
        if (code != INVALID && !done) {
            if (bv > best) { best = bv; end_ref = j; end_read = br; }
            if (terminate && bv == tscore) done = true;
        }
        if (done) break;
    }
    return {best, end_ref, end_read};
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = max(v, __shfl_xor_sync(FULL, v, off));
    return v;
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

template <int KC>
__global__ void __launch_bounds__(WARPS * 32)
sw_scan_kernel(const int* __restrict__ Q, const uint8_t* __restrict__ rowv,
               const int* __restrict__ R, const uint8_t* __restrict__ colv,
               const int* __restrict__ mat, int go, int ge, int terminate,
               const int* __restrict__ tscore, int B, int Lq, int Lr,
               int kn, int* __restrict__ out, int* __restrict__ scratch) {
    __shared__ int s_tab[36];
    load_tab(mat, s_tab);
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    const int K = KC > 0 ? KC : kn;

    typename std::conditional<(KC > 0), RegStore<(KC > 0 ? KC : 1)>,
                              GmemStore>::type st;
    if constexpr (KC == 0) {
        st.base = scratch + (size_t)b * 3 * kn * 32 + lane;
        st.kn = kn;
    }
    const int* q = Q + (size_t)b * Lq;
    const uint8_t* rv = rowv + (size_t)b * Lq;
    int last = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int row = lane * K + k;
        int c = INVALID;
        if (row < Lq && rv[row]) {
            const int qc = q[row];
            c = qc < 0 ? 0 : (qc > 4 ? 4 : qc);
            last = row;
        }
        st.Q(k) = c;
        st.H(k) = 0;
        st.E(k) = NEG;
    }
    last = warp_max(last);
    if (last < 0) last = Lq - 1;        // argmax of an all-false mask
    ArrayCols cols{R + (size_t)b * Lr, colv + (size_t)b * Lr, Lr};
    const ScanResult r = column_scan<KC>(
        st, kn, cols, 0, Lr, s_tab, go, ge, terminate != 0,
        tscore ? tscore[b] : 0, lane, last);
    if (lane == 0) {
        out[b] = r.best;
        out[B + b] = r.end_ref;
        out[2 * B + b] = r.end_read;
    }
}

template <int KC>
__global__ void __launch_bounds__(WARPS * 32)
sw_fused_kernel(const uint8_t* __restrict__ buf, const int* __restrict__ mat,
                int B, int lq, int lr, int go, int ge, int kn,
                int* __restrict__ out, int* __restrict__ scratch) {
    __shared__ int s_tab[36];
    load_tab(mat, s_tab);
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    const int K = KC > 0 ? KC : kn;
    const int hq = lq / 2, hr = lr / 2;
    const uint8_t* row = buf + (size_t)b * (hq + hr + 12);
    const uint8_t* qp = row;
    const uint8_t* rp = row + hq;
    const int q_len = read_i32_le(row + hq + hr);
    const int r_len = read_i32_le(row + hq + hr + 4);
    const int minimal = read_i32_le(row + hq + hr + 8);

    typename std::conditional<(KC > 0), RegStore<(KC > 0 ? KC : 1)>,
                              GmemStore>::type st;
    if constexpr (KC == 0) {
        st.base = scratch + (size_t)b * 3 * kn * 32 + lane;
        st.kn = kn;
    }

    // ---- forward pass: rows < q_len, columns < r_len
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int r = lane * K + k;
        st.Q(k) = (r < lq && r < q_len) ? packed_char(qp, r) : INVALID;
        st.H(k) = 0;
        st.E(k) = NEG;
    }
    const int last = (q_len >= 1 && q_len <= lq) ? q_len - 1 : lq - 1;
    const int ncols = min(r_len, lr);
    const ScanResult fw = column_scan<KC>(
        st, kn, PackedCols{rp, lr, 0, ncols, false}, 0, ncols, s_tab,
        go, ge, false, 0, lane, last);
    const int score = fw.best, end_ref = fw.end_ref;
    // ssw init semantics: end_read defaults to qlen-1 when nothing scored
    const int end_read = end_ref >= 0 ? fw.end_read : q_len - 1;

    // ---- begin pass on the flipped tile, terminate at `score`
    int beg_ref = -1, beg_read = -1;
    if (score >= minimal && end_ref >= 0) {
        const int q_start = lq - 1 - end_read;
        const int r_start = lr - 1 - end_ref;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int r = lane * K + k;
            st.Q(k) = (r < lq && r >= q_start)
                ? packed_char(qp, lq - 1 - r) : INVALID;
            st.H(k) = 0;
            st.E(k) = NEG;
        }
        // Columns before r_start are invalid and leave H all zero, so the
        // scan may start at r_start (E differs there, NEG against -go,
        // but the first valid column's E is -go either way) -- exact for
        // gap penalties >= 0.
        const int j0 = (go >= 0 && ge >= 0) ? max(r_start, 0) : 0;
        const ScanResult bw = column_scan<KC>(
            st, kn, PackedCols{rp, lr, r_start, lr, true}, j0, lr, s_tab,
            go, ge, true, score, lane, lq - 1);
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

// register path for K <= 32 (rounded up to a power of two), else 0 = gmem
int reg_k(int L) {
    const int k = rows_per_lane(L);
    for (int c = 1; c <= 32; c <<= 1)
        if (k <= c) return c;
    return 0;
}

}  // namespace

extern "C" {

// Scratch ints the wrapper allocates for a tile of query width L (0 on
// the register path).
long long smr_sw_scratch_ints(int B, int L) {
    return reg_k(L) ? 0 : (long long)B * 3 * rows_per_lane(L) * 32;
}

int smr_sw_scan(const int* Q, const uint8_t* rowv, const int* R,
                const uint8_t* colv, const int* mat, int go, int ge,
                int terminate, const int* tscore, int B, int Lq, int Lr,
                int* out, int* scratch, void* stream) {
    if (B <= 0) return 0;
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    cudaStream_t s = (cudaStream_t)stream;
    const int kn = rows_per_lane(Lq);
#define SMR_SCAN(KC) sw_scan_kernel<KC><<<grid, block, 0, s>>>( \
        Q, rowv, R, colv, mat, go, ge, terminate, tscore, B, Lq, Lr, kn, \
        out, scratch)
    switch (reg_k(Lq)) {
        case 1: SMR_SCAN(1); break;
        case 2: SMR_SCAN(2); break;
        case 4: SMR_SCAN(4); break;
        case 8: SMR_SCAN(8); break;
        case 16: SMR_SCAN(16); break;
        case 32: SMR_SCAN(32); break;
        default: SMR_SCAN(0); break;
    }
#undef SMR_SCAN
    return (int)cudaGetLastError();
}

int smr_sw_fused(const uint8_t* buf, const int* mat, int B, int lq, int lr,
                 int go, int ge, int* out, int* scratch, void* stream) {
    if (B <= 0) return 0;
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    cudaStream_t s = (cudaStream_t)stream;
    const int kn = rows_per_lane(lq);
#define SMR_FUSED(KC) sw_fused_kernel<KC><<<grid, block, 0, s>>>( \
        buf, mat, B, lq, lr, go, ge, kn, out, scratch)
    switch (reg_k(lq)) {
        case 1: SMR_FUSED(1); break;
        case 2: SMR_FUSED(2); break;
        case 4: SMR_FUSED(4); break;
        case 8: SMR_FUSED(8); break;
        case 16: SMR_FUSED(16); break;
        case 32: SMR_FUSED(32); break;
        default: SMR_FUSED(0); break;
    }
#undef SMR_FUSED
    return (int)cudaGetLastError();
}

}  // extern "C"
