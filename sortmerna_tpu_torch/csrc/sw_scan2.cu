// Smith-Waterman column scan, v2 semantics, for Hopper (sm_90a), on the
// wavefront core of sw_wave.cuh (one warp a pair, an anti-diagonal
// wavefront across the lanes, DPX arithmetic; its top note has the design
// and what bounds it).
//
// Replaces the JAX package's second Pallas TPU kernel
// sortmerna_tpu/ops/sw_pallas.py::_scan_kernel2 (wrapper sw_scan_pallas2,
// chosen by SMR_PALLAS=2), and folds in ops/sw_jax.py::sw_fused_call with
// that kernel dispatched, so a wave block is ONE launch here too.
//
// The function is v2's own, which differs from v1's (csrc/sw_scan.cu) on
// odd inputs only; this file holds v2's column readers:
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
// three reductions above.  The fused entry's two passes are
// smr_wave::fused_pair.  Tiles of more than 1,024 rows run the long-tile
// route of sw_wave.cuh (sw_scan2_long_kernel, sw_fused2_long_kernel), as
// v1's do.
//
// Plain C interface (loaded with ctypes); each entry returns the
// cudaError_t of its launch.  Launches go on the caller's stream, never
// synchronise and allocate nothing.

#include "sw_wave.cuh"

using namespace smr_wave;

namespace {

constexpr int NEG = -(1 << 29);
constexpr int CHUNK = 128;      // the TPU kernel's lane chunk of ref columns

// tile column that column j is read from (v2's chunked read)
__device__ __forceinline__ int src_col(int j, int Lr) {
    if (Lr < CHUNK) return j;
    const int jc = j & ~(CHUNK - 1);
    return min(jc, Lr - CHUNK) + (j - jc);
}

// ---------------------------------------------------------------- columns
// code(j): the column's ref char (0..4), INVALID where v2 reads it as
// invalid.

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

// One pair a warp.  K: the most rows a lane holds in registers.
template <int K>
__global__ void
sw_scan2_kernel(const int* __restrict__ Q, const uint8_t* __restrict__ rowv,
                const int* __restrict__ R, const uint8_t* __restrict__ colv,
                const int* __restrict__ mat, int go, int ge, int terminate,
                const int* __restrict__ tscore, int B, int Lq, int Lr,
                int* __restrict__ out) {
    __shared__ int s_tab[TAB];
    __shared__ uint8_t s_ring[WARPS][RING];
    load_tab<NEG>(mat, s_tab);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * WARPS + w;
    if (b >= B) return;
    const ScanResult r = warp_scan<NEG, K>(
        Lq, ArrayRows{Q + (size_t)b * Lq, rowv + (size_t)b * Lq}, Lr,
        ArrayCols{R + (size_t)b * Lr, colv + (size_t)b * Lr, Lr}, s_tab,
        s_ring[w], go, ge, terminate != 0, tscore ? tscore[b] : 0, lane);
    if (lane == 0) {
        out[b] = r.best;
        out[B + b] = r.end_ref;
        out[2 * B + b] = r.end_read;
    }
}

// One pair of a wave block a warp (fused_pair).
template <int K>
__global__ void
sw_fused2_kernel(const uint8_t* __restrict__ buf, const int* __restrict__ mat,
                 int B, int lq, int lr, int go, int ge,
                 int* __restrict__ out) {
    __shared__ int s_tab[TAB];
    __shared__ uint8_t s_ring[WARPS][RING];
    load_tab<NEG>(mat, s_tab);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * WARPS + w;
    if (b < B)
        fused_pair<PackedCols>(
            buf, b, B, lq, lr, lane == 0, out,
            [&](const PackedRows& rows, const PackedCols& cols, bool term,
                int ts) {
                return warp_scan<NEG, K>(lq, rows, lr, cols, s_tab,
                                         s_ring[w], go, ge, term, ts, lane);
            });
}

// The long-tile route: one pair a cluster (blockIdx.x / its CTAs), its
// rows in stripes over every warp of the cluster (long_scan).
__global__ void __launch_bounds__(CTA_WARPS * 32)
sw_scan2_long_kernel(const int* __restrict__ Q,
                     const uint8_t* __restrict__ rowv,
                     const int* __restrict__ R,
                     const uint8_t* __restrict__ colv,
                     const int* __restrict__ mat, int go, int ge,
                     int terminate, const int* __restrict__ tscore, int B,
                     int Lq, int Lr, int* __restrict__ out) {
    __shared__ LongShared sh;
    load_tab<NEG>(mat, sh.tab);
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    const int b = blockIdx.x / cl.num_blocks();
    const ScanResult r = long_scan<NEG>(
        sh, blockDim.x >> 5, Lq,
        ArrayRows{Q + (size_t)b * Lq, rowv + (size_t)b * Lq}, Lr,
        ArrayCols{R + (size_t)b * Lr, colv + (size_t)b * Lr, Lr}, go, ge,
        terminate != 0, tscore ? tscore[b] : 0);
    if (threadIdx.x == 0 && cl.block_rank() == 0) {
        out[b] = r.best;
        out[B + b] = r.end_ref;
        out[2 * B + b] = r.end_read;
    }
}

__global__ void __launch_bounds__(CTA_WARPS * 32)
sw_fused2_long_kernel(const uint8_t* __restrict__ buf,
                      const int* __restrict__ mat, int B, int lq, int lr,
                      int go, int ge, int* __restrict__ out) {
    __shared__ LongShared sh;
    load_tab<NEG>(mat, sh.tab);
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    const int W = blockDim.x >> 5;
    fused_pair<PackedCols>(
        buf, blockIdx.x / cl.num_blocks(), B, lq, lr,
        threadIdx.x == 0 && cl.block_rank() == 0, out,
        [&](const PackedRows& rows, const PackedCols& cols, bool term,
            int ts) {
            return long_scan<NEG>(sh, W, lq, rows, lr, cols, go, ge, term,
                                  ts);
        });
}

}  // namespace

extern "C" {

int smr_sw_scan2(const int* Q, const uint8_t* rowv, const int* R,
                 const uint8_t* colv, const int* mat, int go, int ge,
                 int terminate, const int* tscore, int B, int Lq, int Lr,
                 int* out, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (!reg_k(Lq))
        return launch_long(sw_scan2_long_kernel, B, Lq, s, Q, rowv, R, colv,
                           mat, go, ge, terminate, tscore, B, Lq, Lr, out);
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    by_reg_k(Lq, [&](auto k) {
        sw_scan2_kernel<decltype(k)::value><<<grid, block, 0, s>>>(
            Q, rowv, R, colv, mat, go, ge, terminate, tscore, B, Lq, Lr,
            out);
    });
    return (int)cudaGetLastError();
}

int smr_sw_fused2(const uint8_t* buf, const int* mat, int B, int lq, int lr,
                  int go, int ge, int* out, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (!reg_k(lq))
        return launch_long(sw_fused2_long_kernel, B, lq, s, buf, mat, B, lq,
                           lr, go, ge, out);
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    by_reg_k(lq, [&](auto k) {
        sw_fused2_kernel<decltype(k)::value><<<grid, block, 0, s>>>(
            buf, mat, B, lq, lr, go, ge, out);
    });
    return (int)cudaGetLastError();
}

}  // extern "C"
