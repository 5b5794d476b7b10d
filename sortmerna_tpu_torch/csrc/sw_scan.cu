// Smith-Waterman local-alignment column scan, v1 semantics, for Hopper
// (sm_90a), on the wavefront core of sw_wave.cuh (one warp a pair, an
// anti-diagonal wavefront across the lanes, DPX arithmetic; its top note
// has the design and what bounds it).
//
// Replaces the JAX package's Pallas TPU kernel
// sortmerna_tpu/ops/sw_pallas.py::_scan_kernel (and its XLA twin
// ops/sw_jax.py::_sw_scan, the JAX default), and folds in the device
// function ops/sw_jax.py::sw_fused_call, so the align task's SW wave is ONE
// launch: nibble unpack, forward scan, begin-coordinate scan on the
// flipped tile.
//
// This file holds v1's column readers and its entries:
//   * sw_scan (ArrayCols): a column is valid iff j < Lr and col_valid[j];
//     its char follows _sw_scan's where-chain (sw_jax.py:148-151): R for
//     R in 0..3, else profile 4.  sw_score_batch (sw_jax.py:36) reaches
//     the same entry with the gather flag set, which reads the char as its
//     jnp.take_along_axis does: -5..-1 wrap, 0..4 read their profile, and
//     any other code is a valid column whose every cell scores NEG (BLANK
//     in the table; the fill value there is INT32_MIN, and NEG is exact in
//     its place: a diagonal of H + NEG never wins max(0, diag, E) while
//     H < 2^30);
//   * sw_fused (PackedCols): valid iff lo <= j < hi; the char is the
//     nibble if it is below 4, else profile 4;
//   * NEG is -(1 << 30) (sw_jax.py:33).
// The tie-break (earliest column, smallest row of the column max) is
// _sw_scan's: its packed key, which it uses for every tile of the
// register path ((Lq << s) < 2^24 up to 2,048 rows), and the 64-bit key of
// the long-tile route, which gives its three-reduction result on wider
// tiles.  The fused entry's two passes are smr_wave::fused_pair.
//
// Tiles of more than 1,024 rows run the long-tile route (sw_wave.cuh's
// top note): a pair's rows in stripes over the warps of a CTA, or of a
// thread-block cluster past 8,192 rows (sw_scan_long_kernel,
// sw_fused_long_kernel).
//
// Plain C interface (loaded with ctypes); each entry returns the
// cudaError_t of its launch.  Launches go on the caller's stream, never
// synchronise and allocate nothing.

#include "sw_wave.cuh"

using namespace smr_wave;

namespace {

constexpr int NEG = -(1 << 30);

// ---------------------------------------------------------------- columns
// code(j): the column's ref char (0..4), INVALID where the column is
// invalid, BLANK for sw_score_batch's out-of-range codes.

struct ArrayCols {              // sw_scan: R row + col_valid
    const int* R;
    const uint8_t* cv;
    int Lr;
    bool gather;                // sw_score_batch's read of the char
    __device__ __forceinline__ int code(int j) const {
        if (j >= Lr || !cv[j]) return INVALID;
        const int r = R[j];
        if (!gather) return (r >= 0 && r < 4) ? r : 4;   // where-chain
        const int w = r < 0 ? r + 5 : r;
        return (w >= 0 && w < 5) ? w : BLANK;
    }
};

struct PackedCols {             // sw_fused: nibble-packed ref window
    const uint8_t* p;
    int lr, lo, hi;             // valid columns: lo <= j < hi
    bool flip;                  // column j reads char lr-1-j
    __device__ __forceinline__ int code(int j) const {
        if (j < lo || j >= hi) return INVALID;
        return min(nibble(p, flip ? lr - 1 - j : j), 4);
    }
};

// One pair a warp.  K: the most rows a lane holds in registers.
template <int K>
__global__ void
sw_scan_kernel(const int* __restrict__ Q, const uint8_t* __restrict__ rowv,
               const int* __restrict__ R, const uint8_t* __restrict__ colv,
               const int* __restrict__ mat, int go, int ge, int terminate,
               const int* __restrict__ tscore, int B, int Lq, int Lr,
               int gather, int* __restrict__ out) {
    __shared__ int s_tab[TAB];
    __shared__ uint8_t s_ring[WARPS][RING];
    load_tab<NEG>(mat, s_tab);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * WARPS + w;
    if (b >= B) return;
    const ScanResult r = warp_scan<NEG, K>(
        Lq, ArrayRows{Q + (size_t)b * Lq, rowv + (size_t)b * Lq}, Lr,
        ArrayCols{R + (size_t)b * Lr, colv + (size_t)b * Lr, Lr,
                  gather != 0},
        s_tab, s_ring[w], go, ge, terminate != 0, tscore ? tscore[b] : 0,
        lane);
    if (lane == 0) {
        out[b] = r.best;
        out[B + b] = r.end_ref;
        out[2 * B + b] = r.end_read;
    }
}

// One pair of a wave block a warp (fused_pair).
template <int K>
__global__ void
sw_fused_kernel(const uint8_t* __restrict__ buf, const int* __restrict__ mat,
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
sw_scan_long_kernel(const int* __restrict__ Q,
                    const uint8_t* __restrict__ rowv,
                    const int* __restrict__ R,
                    const uint8_t* __restrict__ colv,
                    const int* __restrict__ mat, int go, int ge,
                    int terminate, const int* __restrict__ tscore, int B,
                    int Lq, int Lr, int gather, int* __restrict__ out) {
    __shared__ LongShared sh;
    load_tab<NEG>(mat, sh.tab);
    cooperative_groups::cluster_group cl =
        cooperative_groups::this_cluster();
    const int b = blockIdx.x / cl.num_blocks();
    const ScanResult r = long_scan<NEG>(
        sh, blockDim.x >> 5, Lq,
        ArrayRows{Q + (size_t)b * Lq, rowv + (size_t)b * Lq}, Lr,
        ArrayCols{R + (size_t)b * Lr, colv + (size_t)b * Lr, Lr,
                  gather != 0},
        go, ge, terminate != 0, tscore ? tscore[b] : 0);
    if (threadIdx.x == 0 && cl.block_rank() == 0) {
        out[b] = r.best;
        out[B + b] = r.end_ref;
        out[2 * B + b] = r.end_read;
    }
}

__global__ void __launch_bounds__(CTA_WARPS * 32)
sw_fused_long_kernel(const uint8_t* __restrict__ buf,
                     const int* __restrict__ mat, int B, int lq, int lr,
                     int go, int ge, int* __restrict__ out) {
    __shared__ LongShared sh;
    load_tab<NEG>(mat, sh.tab);
    cooperative_groups::cluster_group cl =
        cooperative_groups::this_cluster();
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

// The long-tile route's launch for a tile of L rows (smr_wave::long_geom):
// warps a CTA and CTAs a cluster; 0 for a tile on the register path.
void smr_sw_long_geometry(int L, int* warps, int* cluster) {
    const LongGeom g = reg_k(L) ? LongGeom{0, 0} : long_geom(L);
    *warps = g.warps;
    *cluster = g.cluster;
}

// gather: 0 reads the ref chars by _sw_scan's where-chain (sw_scan), 1 by
// sw_score_batch's take_along_axis (see ArrayCols).
int smr_sw_scan(const int* Q, const uint8_t* rowv, const int* R,
                const uint8_t* colv, const int* mat, int go, int ge,
                int terminate, const int* tscore, int B, int Lq, int Lr,
                int* out, void* stream, int gather) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (!reg_k(Lq))
        return launch_long(sw_scan_long_kernel, B, Lq, s, Q, rowv, R, colv,
                           mat, go, ge, terminate, tscore, B, Lq, Lr,
                           gather, out);
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    by_reg_k(Lq, [&](auto k) {
        sw_scan_kernel<decltype(k)::value><<<grid, block, 0, s>>>(
            Q, rowv, R, colv, mat, go, ge, terminate, tscore, B, Lq, Lr,
            gather, out);
    });
    return (int)cudaGetLastError();
}

int smr_sw_fused(const uint8_t* buf, const int* mat, int B, int lq, int lr,
                 int go, int ge, int* out, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (!reg_k(lq))
        return launch_long(sw_fused_long_kernel, B, lq, s, buf, mat, B, lq,
                           lr, go, ge, out);
    const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
    by_reg_k(lq, [&](auto k) {
        sw_fused_kernel<decltype(k)::value><<<grid, block, 0, s>>>(
            buf, mat, B, lq, lr, go, ge, out);
    });
    return (int)cudaGetLastError();
}

}  // extern "C"
