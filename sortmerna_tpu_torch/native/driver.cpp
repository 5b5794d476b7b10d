// Native traverse driver: the WHOLE per-part align inner loop in C++.
//
// Round-2 profile showed ~75% of align wall was host Python between
// device waves (pass scheduling, window bookkeeping, hit merging, FSM
// glue).  This driver owns all of it: per (index-part, read-batch) it
// runs the multi-pass window search of BOTH strands
// (paralleltraversal.cpp:81-297 semantics), probing windows with the
// threaded C++ prober (probe.cpp) and handing eligible reads to the
// candidate engine's FSMs (engine.cpp).  Python's only job per part is
// the SW wave pump:
//
//     while (n = trav_pump(h)):      # advance until device work pending
//         jobs  = cand_next_jobs(engine)
//         res   = JAX batched Smith-Waterman on the TPU
//         cand_post(engine, res)
//     ... one state/action export at part end ...
//
// Per-read semantics are the exact ports documented in engine.cpp and
// probe.cpp; the pass scheduler mirrors engine/align.py
// _traverse_strand_vec (itself a port of paralleltraversal.cpp:259-297).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

#include "engine_core.hpp"
#include "pool.hpp"

namespace {

using smr::Engine;

// buffer-table slots for trav_create (mirrored in engine/part_driver.py)
enum Buf {
    B_FX_K, B_FX_V, B_FP_K, B_FP_S, B_FP_C,
    B_RX_K, B_RX_S, B_RX_C, B_RX_Z,
    B_RP_K, B_RP_S, B_RP_C,
    B_K19_K, B_K19_V, B_R_IDS, B_COUNTS9,
    B_F19_OFF, B_F19_TI,
    B_R19_OFF, B_R19_TI,
    B_POS_OFF, B_POS_SEQ, B_POS_POS, B_REFS_DATA, B_REFS_OFF,
    B_READS_OFF, B_F03, B_R03, B_F04, B_R04,
    B_STATE5, B_HIT_SEEDS, B_IS_DONE,
    B_ST_OFF, B_ST_SCORES, B_ST_IDXNUMS,
    B_MAT, B_SKIPS,
    B_COUNT
};

// int64 parameter slots
enum Par {
    P_N_READS, P_N_REFS, P_FX_N, P_FP_N, P_RX_N, P_RP_N, P_K19_N,
    P_MINOCCUR, P_FULL_SEARCH, P_THREADS,
    P_NUM_ALIGNMENTS, P_IS_BEST, P_NUM_SEEDS, P_MIN_LIS, P_EDGES,
    P_IS_AS_PERCENT, P_MATCH, P_MINIMAL_SCORE, P_LNWIN,
    P_GAP_OPEN, P_GAP_EXT, P_INDEX_NUM, P_PART_NUM,
    P_NUM_STRANDS, P_FIRST_FORWARD, P_IS_LAST_INDEX, P_IS_LAST_PART,
    P_COUNT
};

struct Driver {
    Engine* eng = nullptr;
    const void* bufs[B_COUNT];
    int64_t ip[P_COUNT];

    int32_t n_reads = 0;
    const int64_t* reads_off = nullptr;
    int64_t base = 0;           // reads_off[0]: a driver may cover a
                                // SUB-RANGE of the concat buffers (the
                                // overlap scheduler splits a batch into
                                // halves sharing the same buffers), so
                                // per-position scratch is base-relative
    int pw = 9;                 // half-window chars (lnwin / 2)
    bool error = false;         // fatal probe error (unsupported pw)
    std::vector<int64_t> lens;

    // pass transition tables (paralleltraversal.cpp:259-283)
    int64_t next_tab[4];
    bool alive_tab[4];
    int64_t shift_tab[4];

    // driver-held per-read state (authoritative for unmanaged reads)
    std::vector<int32_t> hit_seeds;
    std::vector<uint8_t> is_done;
    std::vector<uint8_t> touched;     // traversed in this part

    // per-strand machinery
    int strand_i = 0;
    bool forward = true;
    std::vector<int64_t> p9;          // packed pw-mers per concat position
    std::vector<uint8_t> searched;
    std::vector<int32_t> la;          // live ordinals (ascending)
    std::vector<int32_t> ordinals0;   // this strand's initial ordinals
    std::vector<int8_t> pass_n;
    std::vector<int64_t> win_shift;
    std::vector<std::vector<int64_t>> hit_kids;   // per read, this strand
    std::vector<std::vector<int64_t>> hit_wins;
    std::vector<int32_t> elig;        // current pass's engine items

    enum State { NEED_STRAND, PASS_READY, PASS_ISSUED, DONE };
    State state = NEED_STRAND;

    // probe scratch (reused across passes)
    std::vector<int64_t> w1v, w2v, pb_read, pb_pos, out_win, out_id;
};

static int64_t ilen(const Driver* d, int32_t ord) {
    return d->reads_off[ord + 1] - d->reads_off[ord];
}

// Pack pw-mers at every concat position (pack9_all semantics,
// engine/align.py): values spanning read boundaries are garbage but only
// in-read window starts are ever indexed.
static void pack_p9(Driver* d, const uint8_t* concat03) {
    int64_t total = d->reads_off[d->n_reads] - d->base;
    int64_t n = total - d->pw + 1;
    d->p9.resize(total > 0 ? total : 0);
    if (n <= 0) return;
    const uint64_t mask = (d->pw >= 32) ? ~0ull
                          : ((1ull << (2 * d->pw)) - 1);
    const uint8_t* src = concat03 + d->base;
    uint64_t acc = 0;
    for (int64_t i = 0; i < total; ++i) {
        acc = ((acc << 2) | src[i]) & mask;
        if (i >= d->pw - 1) d->p9[i - d->pw + 1] = (int64_t)acc;
    }
}

static void strand_init(Driver* d) {
    bool single = d->ip[P_NUM_STRANDS] == 1;
    d->forward = single ? d->ip[P_FIRST_FORWARD] != 0 : d->strand_i == 0;
    const uint8_t* concat03 = (const uint8_t*)
        d->bufs[d->forward ? B_F03 : B_R03];
    const uint8_t* concat04 = (const uint8_t*)
        d->bufs[d->forward ? B_F04 : B_R04];
    cand_set_reads(d->eng, concat04);
    cand_set_strand(d->eng, d->forward ? 1 : 0);

    pack_p9(d, concat03);
    d->searched.assign(d->reads_off[d->n_reads] - d->base, 0);
    int64_t lnwin = d->ip[P_LNWIN];
    d->la.clear();
    d->ordinals0.clear();
    for (int32_t i = 0; i < d->n_reads; ++i)
        if (!d->is_done[i] && d->lens[i] >= lnwin) {
            d->la.push_back(i);
            d->ordinals0.push_back(i);
            d->touched[i] = 1;
        }
    d->pass_n.assign(d->n_reads, 0);
    d->win_shift.assign(d->n_reads, d->shift_tab[0]);
    d->hit_kids.assign(d->n_reads, {});
    d->hit_wins.assign(d->n_reads, {});
    d->elig.clear();
}

// Done conditions at strand end (paralleltraversal.cpp:285-297; python
// _apply_done).  Alignment count / max_sw_count come from the engine's
// FSM when the read is managed, from the imported state otherwise.
static void apply_done(Driver* d) {
    const int64_t num_alignments = d->ip[P_NUM_ALIGNMENTS];
    const bool is_best = d->ip[P_IS_BEST] != 0;
    bool is_last_strand = d->strand_i == d->ip[P_NUM_STRANDS] - 1;
    const int32_t* st5 = (const int32_t*)d->bufs[B_STATE5];
    const int64_t* st_off = (const int64_t*)d->bufs[B_ST_OFF];
    for (int32_t ord : d->ordinals0) {
        smr::FSM& f = d->eng->fsms[ord];
        int64_t n_aln = f.managed ? (int64_t)f.scores.size()
                                  : st_off[ord + 1] - st_off[ord];
        int64_t max_sw = f.managed ? f.max_sw_count : st5[ord * 5 + 1];
        if (num_alignments > 0) {
            if ((is_best && num_alignments == max_sw)
                || (!is_best && n_aln == num_alignments))
                d->is_done[ord] = 1;
        } else {
            if (d->ip[P_IS_LAST_INDEX] && d->ip[P_IS_LAST_PART]
                && is_last_strand && n_aln > 0)
                d->is_done[ord] = 1;
        }
    }
}

// Enumerate this pass's unsearched windows, probe them, attribute hits,
// and start the engine FSMs of reads at the seed threshold.
static void run_pass_prefix(Driver* d) {
    const int64_t lnwin = d->ip[P_LNWIN];
    const int64_t pw = d->pw;

    d->w1v.clear(); d->w2v.clear();
    d->pb_read.clear(); d->pb_pos.clear();
    // NOTE: threading this loop (and pack_p9) over P_THREADS was
    // measured SLOWER at the production overlap split (12 slices make
    // each call's work a few ms; spawn + per-thread buffers + concat
    // cost more than the loop).  Keep serial.
    for (int32_t ord : d->la) {
        int64_t shift = d->win_shift[ord];
        int64_t numwin = (d->lens[ord] - lnwin + shift) / shift;
        int64_t off = d->reads_off[ord] - d->base;
        for (int64_t k = 0; k < numwin; ++k) {
            int64_t pos = k * shift;
            if (d->searched[off + pos]) continue;
            d->searched[off + pos] = 1;
            d->w1v.push_back(d->p9[off + pos]);
            d->w2v.push_back(d->p9[off + pos + pw]);
            d->pb_read.push_back(ord);
            d->pb_pos.push_back(pos);
        }
    }
    int64_t nw = (int64_t)d->w1v.size();

    if (nw) {
        int64_t cap = std::max<int64_t>(4 * nw, 1024);
        int64_t n;
        for (;;) {
            d->out_win.resize(cap);
            d->out_id.resize(cap);
            n = probe_windows(
                (const uint64_t*)d->bufs[B_FX_K],
                (const uint32_t*)d->bufs[B_FX_V], d->ip[P_FX_N],
                (const uint64_t*)d->bufs[B_FP_K],
                (const uint32_t*)d->bufs[B_FP_S],
                (const uint32_t*)d->bufs[B_FP_C], d->ip[P_FP_N],
                (const uint64_t*)d->bufs[B_RX_K],
                (const uint32_t*)d->bufs[B_RX_S],
                (const uint32_t*)d->bufs[B_RX_C],
                (const uint32_t*)d->bufs[B_RX_Z], d->ip[P_RX_N],
                (const uint64_t*)d->bufs[B_RP_K],
                (const uint32_t*)d->bufs[B_RP_S],
                (const uint32_t*)d->bufs[B_RP_C], d->ip[P_RP_N],
                (const uint64_t*)d->bufs[B_K19_K],
                (const uint32_t*)d->bufs[B_K19_V], d->ip[P_K19_N],
                (const uint32_t*)d->bufs[B_R_IDS],
                (const uint32_t*)d->bufs[B_COUNTS9],
                (const uint32_t*)d->bufs[B_F19_OFF],
                (const uint64_t*)d->bufs[B_F19_TI],
                (const uint32_t*)d->bufs[B_R19_OFF],
                (const uint64_t*)d->bufs[B_R19_TI],
                d->w1v.data(), d->w2v.data(), nw,
                (int32_t)d->ip[P_MINOCCUR],
                (int32_t)d->ip[P_FULL_SEARCH],
                d->out_win.data(), d->out_id.data(), cap,
                (int32_t)d->ip[P_THREADS], (int32_t)d->pw);
            if (n >= 0) break;
            if (n == INT64_MIN) {   // unsupported-pw sentinel from
                d->error = true;    // probe.cpp, NOT a capacity hint
                return;             // (negating it is signed overflow)
            }
            cap = -n + 16;
        }

        // attribute: one hit_seeds increment per window with >=1 id
        // (paralleltraversal.cpp:242-249); append (kid, win_pos) to the
        // read's accumulated strand hits (probe output is window-ordered,
        // so per-read order matches the sequential scan)
        int64_t prev_w = -1;
        for (int64_t j = 0; j < n; ++j) {
            int64_t w = d->out_win[j];
            int32_t ord = (int32_t)d->pb_read[w];
            if (w != prev_w) { ++d->hit_seeds[ord]; prev_w = w; }
            d->hit_kids[ord].push_back(d->out_id[j]);
            d->hit_wins[ord].push_back(d->pb_pos[w]);
        }
    }

    // eligible reads run their candidate FSMs over the full accumulated
    // strand hits (engine/align.py trav_items semantics)
    const int64_t num_seeds = d->ip[P_NUM_SEEDS];
    d->elig.clear();
    for (int32_t ord : d->la)
        if (d->hit_seeds[ord] >= num_seeds) d->elig.push_back(ord);
    if (!d->elig.empty()) {
        int32_t m = (int32_t)d->elig.size();
        std::vector<int64_t> hit_off(m + 1, 0), kids, wins;
        for (int32_t i = 0; i < m; ++i)
            hit_off[i + 1] = hit_off[i]
                             + (int64_t)d->hit_kids[d->elig[i]].size();
        kids.resize(hit_off[m]);
        wins.resize(hit_off[m]);
        for (int32_t i = 0; i < m; ++i) {
            const auto& hk = d->hit_kids[d->elig[i]];
            const auto& hw = d->hit_wins[d->elig[i]];
            std::copy(hk.begin(), hk.end(), kids.begin() + hit_off[i]);
            std::copy(hw.begin(), hw.end(), wins.begin() + hit_off[i]);
        }
        // state import rows: managed reads carry their FSM state (the
        // engine ignores these rows); unmanaged rows come from the
        // python-imported per-read state
        const int32_t* st5_in = (const int32_t*)d->bufs[B_STATE5];
        const int64_t* st_off_in = (const int64_t*)d->bufs[B_ST_OFF];
        const int32_t* sc_in = (const int32_t*)d->bufs[B_ST_SCORES];
        const int32_t* ix_in = (const int32_t*)d->bufs[B_ST_IDXNUMS];
        std::vector<int32_t> state5(m * 5, 0);
        std::vector<int64_t> st_off(m + 1, 0);
        std::vector<int32_t> scs, ixs;
        for (int32_t i = 0; i < m; ++i) {
            int32_t ord = d->elig[i];
            st_off[i + 1] = st_off[i];
            if (d->eng->fsms[ord].managed) continue;
            std::memcpy(&state5[i * 5], st5_in + ord * 5,
                        5 * sizeof(int32_t));
            int64_t s0 = st_off_in[ord], s1 = st_off_in[ord + 1];
            st_off[i + 1] += s1 - s0;
            scs.insert(scs.end(), sc_in + s0, sc_in + s1);
            ixs.insert(ixs.end(), ix_in + s0, ix_in + s1);
        }
        if (scs.empty()) { scs.push_back(0); ixs.push_back(0); }
        cand_start_batch(d->eng, m, d->elig.data(), hit_off.data(),
                         kids.data(), wins.data(), st_off.data(),
                         scs.data(), ixs.data(), state5.data());
    }
}

// Collect this pass's FSM search flags and advance the pass scheduler
// (paralleltraversal.cpp:259-283 via engine/align.py tables).
static void collect_and_advance(Driver* d) {
    std::vector<int32_t> next;
    next.reserve(d->la.size());
    // reads whose FSM ran and aligned (search=false) stop searching
    size_t ei = 0;
    for (int32_t ord : d->la) {
        bool keep = true;
        while (ei < d->elig.size() && d->elig[ei] < ord) ++ei;
        if (ei < d->elig.size() && d->elig[ei] == ord)
            keep = d->eng->fsms[ord].search;
        if (!keep) continue;
        int8_t p = d->pass_n[ord];
        d->pass_n[ord] = (int8_t)d->next_tab[p];
        if (!d->alive_tab[p]) continue;
        d->win_shift[ord] = d->shift_tab[d->pass_n[ord]];
        next.push_back(ord);
    }
    d->la.swap(next);
    d->elig.clear();
}

}  // namespace

extern "C" {

void* trav_create(const void** bufs, const int64_t* ip) {
    Driver* d = new Driver();
    std::memcpy(d->bufs, bufs, sizeof(d->bufs));
    std::memcpy(d->ip, ip, sizeof(d->ip));
    d->n_reads = (int32_t)ip[P_N_READS];
    d->reads_off = (const int64_t*)bufs[B_READS_OFF];
    d->base = d->n_reads > 0 ? d->reads_off[0] : 0;
    d->pw = (int)(ip[P_LNWIN] / 2);
    d->lens.resize(d->n_reads);
    for (int32_t i = 0; i < d->n_reads; ++i) d->lens[i] = ilen(d, i);

    d->eng = (Engine*)cand_create(
        (const int64_t*)bufs[B_POS_OFF], (const uint32_t*)bufs[B_POS_SEQ],
        (const uint32_t*)bufs[B_POS_POS],
        (const uint8_t*)bufs[B_REFS_DATA], (const int64_t*)bufs[B_REFS_OFF],
        (int32_t)ip[P_N_REFS],
        (const uint8_t*)bufs[B_F04], d->reads_off, d->n_reads,
        (int)ip[P_NUM_ALIGNMENTS], (int)ip[P_IS_BEST],
        (int)ip[P_NUM_SEEDS], (int)ip[P_MIN_LIS], (int)ip[P_EDGES],
        (int)ip[P_IS_AS_PERCENT], (int)ip[P_MATCH],
        (long)ip[P_MINIMAL_SCORE], (int)ip[P_LNWIN],
        (int)ip[P_GAP_OPEN], (int)ip[P_GAP_EXT],
        (int)ip[P_INDEX_NUM], (int)ip[P_PART_NUM],
        (const int8_t*)bufs[B_MAT]);
    d->eng->nthreads = (int)ip[P_THREADS] < 1 ? 1 : (int)ip[P_THREADS];

    // pass transition tables from skiplengths (engine/align.py)
    const int64_t* skips = (const int64_t*)bufs[B_SKIPS];
    for (int p = 0; p < 3; ++p) {
        int q = p;
        if (q == 2) { d->next_tab[p] = 3; d->alive_tab[p] = false; continue; }
        while (q < 3 && skips[q] == skips[std::min(q + 1, 2)] && q + 1 <= 2)
            ++q;
        ++q;
        d->next_tab[p] = q;
        d->alive_tab[p] = q <= 2;
    }
    d->next_tab[3] = 3; d->alive_tab[3] = false;
    for (int p = 0; p < 3; ++p) d->shift_tab[p] = skips[p];
    d->shift_tab[3] = skips[2];

    // import driver-held per-read state
    const int32_t* hs = (const int32_t*)bufs[B_HIT_SEEDS];
    const uint8_t* dn = (const uint8_t*)bufs[B_IS_DONE];
    d->hit_seeds.assign(hs, hs + d->n_reads);
    d->is_done.assign(dn, dn + d->n_reads);
    d->touched.assign(d->n_reads, 0);
    return d;
}

void trav_destroy(void* h) {
    Driver* d = (Driver*)h;
    if (d->eng) cand_destroy(d->eng);
    delete d;
}

void* trav_engine(void* h) { return ((Driver*)h)->eng; }

int32_t trav_strand(void* h) { return ((Driver*)h)->forward ? 1 : 0; }

// Advance the part until device SW work is pending; returns the number
// of pending jobs (0 = part complete).  The caller services jobs via
// cand_next_jobs / cand_post on trav_engine() and pumps again.
int32_t trav_pump(void* h) {
    Driver* d = (Driver*)h;
    for (;;) {
        if (cand_num_active(d->eng) > 0) {
            int32_t n = cand_num_jobs(d->eng);
            if (n > 0) return n;
        }
        switch (d->state) {
        case Driver::NEED_STRAND:
            if (d->strand_i >= (int)d->ip[P_NUM_STRANDS]) {
                d->state = Driver::DONE;
                return 0;
            }
            strand_init(d);
            d->state = Driver::PASS_READY;
            break;
        case Driver::PASS_ISSUED:
            collect_and_advance(d);
            d->state = Driver::PASS_READY;
            break;
        case Driver::PASS_READY:
            if (d->la.empty()) {
                apply_done(d);
                ++d->strand_i;
                d->state = Driver::NEED_STRAND;
                break;
            }
            run_pass_prefix(d);
            if (d->error) return -1;    // unsupported-pw probe sentinel
            d->state = Driver::PASS_ISSUED;
            break;
        case Driver::DONE:
            return 0;
        }
    }
}

// Pump k slice drivers of one part at once on the native pool (pool.hpp):
// out_n[i] = trav_pump(handles[i]).  Workers take slices from a shared
// counter, so a slice with more hits leaves no worker idle, and each
// slice's pump runs single-threaded inside its task.  A lone slice runs
// on the caller with the pool left to its probes and FSM starts.
// Returns the nanoseconds the pool's threads spent on these pumps.
int64_t trav_pump_many(void** handles, int32_t k, int32_t* out_n) {
    std::atomic<int64_t> busy{0};
    if (k <= 0) return 0;
    auto pump = [&](int64_t i) {
        auto t0 = std::chrono::steady_clock::now();
        out_n[i] = trav_pump(handles[i]);
        busy += std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0).count();
    };
    if (k == 1) smr::pool_set_sink(&busy);    // its probes' workers
    smr::pool_for((int)((Driver*)handles[0])->ip[P_THREADS], k, pump);
    smr::pool_set_sink(nullptr);
    return busy.load();
}

// Final per-read export: out[n,8] = best, max_sw_count, is_hit,
// min_index, max_index, hit_seeds, is_done, flags
// (flags bit0 = engine-managed / state dirty, bit1 = traversed here).
void trav_export(void* h, int32_t* out) {
    Driver* d = (Driver*)h;
    for (int32_t i = 0; i < d->n_reads; ++i) {
        smr::FSM& f = d->eng->fsms[i];
        int32_t* r = out + i * 8;
        if (f.managed) {
            r[0] = f.best; r[1] = f.max_sw_count; r[2] = f.is_hit ? 1 : 0;
            r[3] = f.min_index; r[4] = f.max_index;
        } else {
            const int32_t* s5 = (const int32_t*)d->bufs[B_STATE5] + i * 5;
            r[0] = s5[0]; r[1] = s5[1]; r[2] = s5[2];
            r[3] = s5[3]; r[4] = s5[4];
        }
        r[5] = d->hit_seeds[i];
        r[6] = d->is_done[i];
        r[7] = (f.managed ? 1 : 0) | (d->touched[i] ? 2 : 0);
    }
}

}  // extern "C"
