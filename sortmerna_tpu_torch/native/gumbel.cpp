// Island-method Gumbel parameter estimation (lambda, K) for gapped
// local alignment -- native implementation of the Monte-Carlo procedure
// (Altschul, Bundschuh, Olsen, Hwa 2001; the statistic the reference
// obtains from its vendored ALP library, refstats.cpp:184-233).
//
// Smith-Waterman DP over pairs of iid random sequences; every positive
// "island" (connected clump of positive H reached through DP argmax
// predecessors) contributes its peak score.  The tail P(peak >= t0 + k)
// is geometric with ratio e^-lambda; K follows from the island density.
// Islands peaking within `margin` of the matrix edges are excluded to
// suppress finite-size bias.  Deterministic (splitmix64 PRNG).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed) {}
    uint64_t next() {
        s += 0x9E3779B97F4A7C15ull;
        uint64_t z = s;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

}  // namespace

extern "C" {

// Returns number of islands collected; outputs lambda/K via pointers.
// score matrix: match/mismatch; gap_open charged on the first gap char.
int64_t gumbel_island(int32_t match, int32_t mismatch, int32_t gap_open,
                      int32_t gap_ext, const double* freqs,
                      int32_t seq_len, int32_t n_pairs, int32_t t0,
                      int32_t margin, uint64_t seed,
                      double* out_lambda, double* out_k) {
    const int L = seq_len;
    std::vector<int32_t> H(L + 1, 0), E(L + 1, INT32_MIN / 2);
    std::vector<int64_t> isl(L + 1, -1);
    std::vector<int32_t> island_peak;
    std::vector<int32_t> island_edge;   // 1 if island touched the margin
    std::vector<uint8_t> a(L), b(L);
    double cum[4];
    cum[0] = freqs[0];
    for (int i = 1; i < 4; ++i) cum[i] = cum[i - 1] + freqs[i];

    Rng rng(seed);
    int64_t n_islands = 0;
    double sum_excess = 0.0;
    int64_t cells = 0;

    for (int p = 0; p < n_pairs; ++p) {
        for (int i = 0; i < L; ++i) {
            double u = rng.uniform();
            int c = 0;
            while (c < 3 && u > cum[c]) ++c;
            a[i] = (uint8_t)c;
            u = rng.uniform();
            c = 0;
            while (c < 3 && u > cum[c]) ++c;
            b[i] = (uint8_t)c;
        }
        std::fill(H.begin(), H.end(), 0);
        std::fill(E.begin(), E.end(), INT32_MIN / 2);
        std::fill(isl.begin(), isl.end(), -1);
        size_t isl_base = island_peak.size();

        for (int j = 0; j < L; ++j) {          // columns over b
            int32_t diag_h = 0;                 // H[i-1][j-1]
            int64_t diag_i = -1;
            int32_t F = INT32_MIN / 2;
            int64_t f_isl = -1;
            for (int i = 1; i <= L; ++i) {
                int32_t up_h = H[i];            // H[i][j-1] (previous col)
                int64_t up_i = isl[i];
                // E: gap along b (previous column, same row)
                int32_t e_new = up_h - gap_open;
                if (E[i] - gap_ext > e_new) e_new = E[i] - gap_ext;
                E[i] = e_new;
                // F: gap along a (same column, previous row)
                int32_t f_open = H[i - 1] - gap_open;   // updated this col
                int64_t f_src = isl[i - 1];
                if (F - gap_ext >= f_open) {
                    F = F - gap_ext;            // keep f_isl
                } else {
                    F = f_open;
                    f_isl = f_src;
                }
                int32_t sub = (a[i - 1] == b[j]) ? match : mismatch;
                int32_t d = diag_h + sub;
                int32_t h = d;
                int64_t src = diag_i;
                if (E[i] > h) { h = E[i]; src = up_i; }
                if (F > h) { h = F; src = f_isl; }
                diag_h = up_h;
                diag_i = up_i;
                if (h <= 0) {
                    H[i] = 0;
                    isl[i] = -1;
                    continue;
                }
                if (src < 0) {
                    // new island born at (i, j)
                    src = (int64_t)island_peak.size();
                    island_peak.push_back(0);
                    island_edge.push_back(
                        (i <= margin || i > L - margin || j < margin
                         || j >= L - margin) ? 1 : 0);
                }
                H[i] = h;
                isl[i] = src;
                if (h > island_peak[src]) island_peak[src] = h;
                if (i <= margin || i > L - margin || j < margin
                    || j >= L - margin)
                    island_edge[src] = 1;
            }
            cells += L;
        }
        (void)isl_base;
    }

    for (size_t s = 0; s < island_peak.size(); ++s) {
        if (island_edge[s]) continue;           // finite-size exclusion
        if (island_peak[s] >= t0) {
            ++n_islands;
            sum_excess += island_peak[s] - t0;
        }
    }
    if (n_islands < 50) return n_islands;
    double mean_excess = sum_excess / (double)n_islands;
    double lam = std::log(1.0 + 1.0 / mean_excess);
    // effective interior area per pair
    double interior = (double)(L - 2 * margin) * (double)(L - 2 * margin);
    double density = (double)n_islands / (interior * (double)n_pairs);
    *out_lambda = lam;
    *out_k = density * std::exp(lam * (double)t0);
    return n_islands;
}

// Histogram variant: fills hist[s] (s in [0, hist_len)) with counts of
// interior island peaks of score s; returns total interior cells.
int64_t gumbel_island_hist(int32_t match, int32_t mismatch,
                           int32_t gap_open, int32_t gap_ext,
                           const double* freqs, int32_t seq_len,
                           int32_t n_pairs, int32_t margin, uint64_t seed,
                           int64_t* hist, int32_t hist_len) {
    double lam_unused, k_unused;
    // reuse the main routine's DP by re-running with bookkeeping here
    // (duplicated loop kept small by calling the island collector).
    const int L = seq_len;
    std::vector<int32_t> H(L + 1, 0), E(L + 1, INT32_MIN / 2);
    std::vector<int64_t> isl(L + 1, -1);
    std::vector<int32_t> island_peak;
    std::vector<uint8_t> island_edge;
    std::vector<uint8_t> a(L), b(L);
    double cum[4];
    cum[0] = freqs[0];
    for (int i = 1; i < 4; ++i) cum[i] = cum[i - 1] + freqs[i];
    Rng rng(seed);
    (void)lam_unused; (void)k_unused;

    for (int p = 0; p < n_pairs; ++p) {
        for (int i = 0; i < L; ++i) {
            double u = rng.uniform();
            int c = 0;
            while (c < 3 && u > cum[c]) ++c;
            a[i] = (uint8_t)c;
            u = rng.uniform();
            c = 0;
            while (c < 3 && u > cum[c]) ++c;
            b[i] = (uint8_t)c;
        }
        std::fill(H.begin(), H.end(), 0);
        std::fill(E.begin(), E.end(), INT32_MIN / 2);
        std::fill(isl.begin(), isl.end(), -1);

        for (int j = 0; j < L; ++j) {
            int32_t diag_h = 0;
            int64_t diag_i = -1;
            int32_t F = INT32_MIN / 2;
            int64_t f_isl = -1;
            for (int i = 1; i <= L; ++i) {
                int32_t up_h = H[i];
                int64_t up_i = isl[i];
                int32_t e_new = up_h - gap_open;
                if (E[i] - gap_ext > e_new) e_new = E[i] - gap_ext;
                E[i] = e_new;
                int32_t f_open = H[i - 1] - gap_open;
                int64_t f_src = isl[i - 1];
                if (F - gap_ext >= f_open) {
                    F = F - gap_ext;
                } else {
                    F = f_open;
                    f_isl = f_src;
                }
                int32_t sub = (a[i - 1] == b[j]) ? match : mismatch;
                int32_t d = diag_h + sub;
                int32_t h = d;
                int64_t src = diag_i;
                if (E[i] > h) { h = E[i]; src = up_i; }
                if (F > h) { h = F; src = f_isl; }
                diag_h = up_h;
                diag_i = up_i;
                if (h <= 0) {
                    H[i] = 0;
                    isl[i] = -1;
                    continue;
                }
                if (src < 0) {
                    src = (int64_t)island_peak.size();
                    island_peak.push_back(0);
                    island_edge.push_back(
                        (i <= margin || i > L - margin || j < margin
                         || j >= L - margin) ? 1 : 0);
                }
                H[i] = h;
                isl[i] = src;
                if (h > island_peak[src]) island_peak[src] = h;
                if (i <= margin || i > L - margin || j < margin
                    || j >= L - margin)
                    island_edge[src] = 1;
            }
        }
    }
    for (size_t s = 0; s < island_peak.size(); ++s) {
        if (island_edge[s]) continue;
        int32_t v = island_peak[s];
        if (v >= 0 && v < hist_len) ++hist[v];
    }
    double interior = (double)(L - 2 * margin) * (double)(L - 2 * margin);
    return (int64_t)(interior * (double)n_pairs);
}

}  // extern "C"
