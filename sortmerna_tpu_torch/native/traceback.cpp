// Banded affine-gap DP + traceback producing packed CIGARs.
//
// Native host kernel for the post-acceptance CIGAR stage: the device
// computes scores and begin/end coordinates (ops/sw_jax.py); this kernel
// reproduces the reference's banded_sw semantics (ssw.c:577-773) --
// band doubling until the known score is reached, direction preferences
// (E/F prefer extend on ties, H prefers diagonal, E-vs-F tie goes to F),
// first read row always emitted as M -- over the clipped alignment window.
//
// Batched entry point processes many alignments per call to amortize the
// FFI overhead (ctypes binding in native/__init__.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Cell3 { int8_t de, df, dh; };

// returns cigar length (#runs) or -1 if cigar_cap too small
//
// Storage is BAND-LOCAL like the reference's banded_sw (ssw.c:590-650):
// two rolling H/E rows of width O(band) and a readLen x (2*band+1)
// direction strip -- O((rl+ql)*band) memory instead of O(rl*ql), which
// both fits MAX_READ_LEN (30K nt) alignments and keeps short-read jobs
// cache-resident.  Any cell outside the band reads as (H=0, E=-inf),
// reproducing the full-matrix fill + band-edge reset exactly; the band
// shifts one column per row, so a row's value for column c keeps the
// same local index when the row becomes "previous".
int traceback_one(const uint8_t* ref, int refLen,
                  const uint8_t* query, int readLen,
                  int score, int gap_open, int gap_ext, int band_width,
                  const int8_t* mat /* 5x5 row-major */,
                  uint32_t* cigar_out, int cigar_cap) {
    const int64_t NEG = -(1LL << 40);
    std::vector<int64_t> prevH, prevE, curH, curE;
    std::vector<Cell3> dirs;
    int64_t mx = 0;
    int bw = band_width;
    int width_d = 0;
    while (true) {
        int width = 2 * bw + 4;        // band cols + boundary sentinels
        width_d = 2 * bw + 1;
        prevH.assign(width, 0);
        prevE.assign(width, NEG);
        curH.assign(width, 0);
        curE.assign(width, NEG);
        dirs.assign((size_t)readLen * width_d, Cell3{});
        mx = 0;
        for (int i = 0; i < readLen; ++i) {
            int beg = i - bw; if (beg < 0) beg = 0;
            int end = i + bw; if (end > refLen - 1) end = refLen - 1;
            std::fill(curH.begin(), curH.end(), 0);
            std::fill(curE.begin(), curE.end(), NEG);
            int64_t f = 0;
            Cell3* drow = &dirs[(size_t)i * width_d];
            // local maps (cell coordinates): current row cell col c sits
            // at c - i + bw + 1; the previous row's cell col c sits at
            // c - (i-1) + bw + 1 = c - i + bw + 2.  The band shifts one
            // column per row, so prev cell col j-1 (the diagonal) shares
            // the index of current col j -- rows swap without remapping.
            for (int j = beg; j <= end; ++j) {
                int uc = j - i + bw + 1;
                int up = j - i + bw + 2;
                int64_t t1, t2, ecur, fcur, hcur;
                int8_t de, df, dh;
                if (i == 0) { t1 = -gap_open; t2 = -gap_ext; }
                else { t1 = prevH[up] - gap_open;
                       t2 = prevE[up] - gap_ext; }
                ecur = t1 > t2 ? t1 : t2;
                de = t1 > t2 ? 3 : 2;
                t1 = curH[uc - 1] - gap_open;
                t2 = f - gap_ext;
                fcur = t1 > t2 ? t1 : t2;
                df = t1 > t2 ? 5 : 4;
                f = fcur;
                int64_t e1 = ecur > 0 ? ecur : 0;
                int64_t f1 = fcur > 0 ? fcur : 0;
                t1 = e1 > f1 ? e1 : f1;
                t2 = prevH[uc] + mat[ref[j] * 5 + query[i]];
                hcur = t1 > t2 ? t1 : t2;
                if (hcur > mx) mx = hcur;
                dh = (t1 <= t2) ? 1 : (e1 > f1 ? de : df);
                curH[uc] = hcur;
                curE[uc] = ecur;
                Cell3& dc = drow[j - i + bw];
                dc.de = de; dc.df = df; dc.dh = dh;
            }
            prevH.swap(curH);
            prevE.swap(curE);
        }
        if (mx >= score) break;
        bw *= 2;
        if (bw > refLen + readLen) {
            bw = refLen + readLen;          // give up on next pass
            if (mx >= score) break;
        }
        if (bw >= refLen + readLen && mx < score) {
            // full band already evaluated and still below: cannot reproduce
            // score -- emit with whatever band (matches ssw abort path)
            break;
        }
    }

    // traceback (ssw.c:673-747); direction lookups are band-local
    int i = readLen - 1, j = refLen - 1;
    int table = 2;   // 0=e 1=f 2=h
    int cur_op = 0, cur_n = 0;
    // build runs end->begin
    std::vector<uint32_t> rev;
    rev.reserve(64);
    while (i > 0) {
        int du = j - i + bw;
        if (du < 0 || du >= width_d) return -2;  // left the band
        const Cell3& c = dirs[(size_t)i * width_d + du];
        int d = (table == 0) ? c.de : (table == 1) ? c.df : c.dh;
        int f_op;
        switch (d) {
        case 1: --i; --j; table = 2; f_op = 0; break;
        case 2: --i; table = 0; f_op = 1; break;
        case 3: --i; table = 2; f_op = 1; break;
        case 4: --j; table = 1; f_op = 2; break;
        case 5: --j; table = 2; f_op = 2; break;
        default: return -2;   // traceback error
        }
        if (f_op == cur_op) ++cur_n;
        else {
            if (cur_n > 0) rev.push_back(((uint32_t)cur_n << 4) | cur_op);
            cur_op = f_op;
            cur_n = 1;
        }
    }
    if (cur_op == 0) {
        rev.push_back(((uint32_t)(cur_n + 1) << 4) | 0u);
    } else {
        if (cur_n > 0) rev.push_back(((uint32_t)cur_n << 4) | cur_op);
        rev.push_back(1u << 4);
    }
    int L = (int)rev.size();
    if (L > cigar_cap) return -1;
    for (int k = 0; k < L; ++k) cigar_out[k] = rev[L - 1 - k];
    return L;
}

} // namespace

extern "C" {

// single-alignment entry for other native modules (engine.cpp)
int traceback_one_c(const uint8_t* ref, int refLen, const uint8_t* query,
                    int readLen, int score, int gap_open, int gap_ext,
                    int band_width, const int8_t* mat, uint32_t* cigar_out,
                    int cigar_cap) {
    return traceback_one(ref, refLen, query, readLen, score, gap_open,
                         gap_ext, band_width, mat, cigar_out, cigar_cap);
}

// Batched: sequences packed back-to-back.
// ref_data/query_data: concatenated windows; offsets via ref_off/query_off
// (n+1 entries).  scores/bands per job.  cigars written into cigar_out
// (cap per job = cigar_cap), lengths into cigar_len.
int banded_traceback_batch(
    const uint8_t* ref_data, const int64_t* ref_off,
    const uint8_t* query_data, const int64_t* query_off,
    const int32_t* scores, const int32_t* bands,
    int n, int gap_open, int gap_ext, const int8_t* mat,
    uint32_t* cigar_out, int cigar_cap, int32_t* cigar_len) {
    // alignments are independent; partition across hardware threads
    // (survivor batches run to ~100K per 100K reads)
    int nt = (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 8) nt = 8;
    if (n < 256) nt = 1;
    std::vector<int> bads(nt, 0);
    auto work = [&](int t) {
        int lo = (int)((int64_t)n * t / nt);
        int hi = (int)((int64_t)n * (t + 1) / nt);
        for (int k = lo; k < hi; ++k) {
            int refLen = (int)(ref_off[k + 1] - ref_off[k]);
            int readLen = (int)(query_off[k + 1] - query_off[k]);
            int r = traceback_one(
                ref_data + ref_off[k], refLen,
                query_data + query_off[k], readLen,
                scores[k], gap_open, gap_ext, bands[k], mat,
                cigar_out + (size_t)k * cigar_cap, cigar_cap);
            cigar_len[k] = r;
            if (r < 0) ++bads[t];
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < nt; ++t) ths.emplace_back(work, t);
        for (auto& th : ths) th.join();
    }
    int bad = 0;
    for (int b : bads) bad += b;
    return bad;
}

// Pointer-array variant: jobs reference windows in place (per-part
// export buffers) instead of a packed concat -- the Python side then
// never copies window bytes to assemble a batch.
int banded_traceback_ptrs(
    const uint64_t* ref_ptrs, const int32_t* ref_lens,
    const uint64_t* q_ptrs, const int32_t* q_lens,
    const int32_t* scores, const int32_t* bands,
    int n, int gap_open, int gap_ext, const int8_t* mat,
    uint32_t* cigar_out, int cigar_cap, int32_t* cigar_len) {
    int nt = (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 8) nt = 8;
    if (n < 256) nt = 1;
    std::vector<int> bads(nt, 0);
    auto work = [&](int t) {
        int lo = (int)((int64_t)n * t / nt);
        int hi = (int)((int64_t)n * (t + 1) / nt);
        for (int k = lo; k < hi; ++k) {
            int r = traceback_one(
                (const uint8_t*)ref_ptrs[k], ref_lens[k],
                (const uint8_t*)q_ptrs[k], q_lens[k],
                scores[k], gap_open, gap_ext, bands[k], mat,
                cigar_out + (size_t)k * cigar_cap, cigar_cap);
            cigar_len[k] = r;
            if (r < 0) ++bads[t];
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < nt; ++t) ths.emplace_back(work, t);
        for (auto& th : ths) th.join();
    }
    int bad = 0;
    for (int b : bads) bad += b;
    return bad;
}

} // extern "C"
