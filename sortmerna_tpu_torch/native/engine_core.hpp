// Shared internals of the native candidate engine (engine.cpp), exposed
// so the traverse driver (driver.cpp) can compose with it in-process:
// the driver owns the per-part pass/strand scheduler and hands eligible
// reads to the engine's FSMs without any Python round-trip.
//
// Everything here is C++-internal to the shared library; the stable
// boundary is still the extern "C" surface in engine.cpp / driver.cpp.

#pragma once

#include <cstdint>
#include <deque>
#include <map>
#include <vector>

namespace smr {

struct Opts {
    int num_alignments, is_best, num_seeds, min_lis, edges, is_as_percent;
    int match_, lnwin, gap_open, gap_ext;
    long minimal_score;
    int index_num, part_num, strand_forward;
    int8_t mat[25];
};

struct Action {
    int32_t read_ord;
    int32_t kind;        // 0 = append, 1 = replace
    int32_t slot;        // replace: which alignment slot
    int32_t first_hit;   // 1 if this made read.is_hit true
    int32_t ref_num;
    int32_t score;
    int32_t rb, re, qb, qe;   // final (offset-corrected) coordinates
    // deferred-traceback window (absolute offsets into refs/reads data):
    // CIGARs are computed lazily for SURVIVING alignments only -- the
    // replace-min churn of best-N bookkeeping (alignment.cpp:420-459)
    // makes eager tracebacks ~3x the surviving count.
    int64_t rw_off, qw_off;
    int32_t rl, ql, band;
    int32_t strand_forward;   // which strand buffer qw_off points into
};

// Speculative SW job.  EVERY window-loop iteration's job geometry is a
// static function of the hit lists: SW scores influence only whether a
// job's result is CONSUMED (heuristic 1 skips, early-stop, best-N
// budget), never its geometry -- the match_set/begin_ref evolution after
// an align attempt is the same pop step whether or not the attempt
// happened (alignment.cpp:486-506 runs unconditionally).  So a read's
// SW jobs can be scored ahead of its walk; the sequential replay then
// consumes exactly the subset the reference would have issued.
//
// Speculation runs in rounds.  A read's record walk waits on one
// unfilled job, the cursor; everything behind it is dead.  Each wave
// the FSM offers the next `round` unfilled jobs from the cursor onward
// (enumerating further candidates as the round reaches past the ones
// enumerated so far), and `round` doubles once that wave is scored.
// A read that stops at its first accepted alignment or its best-N
// budget costs about one round; one that walks every candidate reaches
// full depth in about log2(jobs / first round) waves and scores at most
// about twice what it walks.  Which jobs are scored never changes a
// result: each pair's score is independent of its wave.
struct SpecJob {
    long aq, ar, head, tail, alen;
    uint32_t ref;
    int32_t score = -1, rb = -1, re = -1, qb = -1, qe = -1;
    bool filled = false;
};

// One window-loop iteration, recorded during enumeration so the replay
// never recomputes window geometry or LIS: `push` drives heuristic 1
// (alignment.cpp:239-249), `spec` (>=0) is the SW job the iteration
// issues when its num_seeds/min_lis gates passed.
struct IterRec {
    int32_t spec;      // index into FSM::spec, or -1 (no job this iter)
    uint8_t push;      // did this iteration extend match_set?
};

struct FSM {
    int32_t ord = -1;
    // mutable read state
    int best = 0;
    int max_sw_count = 0;
    bool is_hit = false;
    std::vector<int32_t> scores;     // stored alignment scores (all parts)
    std::vector<int32_t> idxnums;    // their index_num values
    int min_index = 0, max_index = 0;
    bool search = true;              // return value
    // true once this engine has run the read: its own copy of the
    // mutable read state is newer than anything the caller could
    // re-import, so later passes skip the import (the python driver
    // passes dummy state rows for managed reads)
    bool managed = false;
    // candidate machinery
    std::vector<std::pair<uint32_t, uint32_t>> cands;   // (seq, freq)
    size_t k = 0;
    bool is_aligned = false;
    bool is_search_candidates = true;
    std::vector<std::pair<uint32_t, uint32_t>> hits_on_ref;
    size_t it = 0;
    std::deque<std::pair<uint32_t, uint32_t>> match_set;
    int64_t begin_ref = 0, begin_read = 0;
    // sorted (seq,pos,win) triples; per-candidate contiguous subranges
    std::vector<uint64_t> trip;
    std::vector<size_t> cand_begin, cand_end;
    // speculation depth: candidates [0, enum_k) are enumerated (lazily,
    // in candidate order, so each one's records and jobs are those a
    // whole up-front enumeration gives); `round` is the most unfilled
    // jobs the next wave may offer from the cursor
    size_t enum_k = 0;
    size_t round = 0;
    // pending job geometry
    long aq = 0, ar = 0, head = 0, tail = 0, alen = 0;
    uint32_t cur_ref = 0;
    int phase = 0;   // 0: start candidate k, 1: live window-loop top,
                     // 2: awaiting SW result (live path), 3: done,
                     // 4: record walk (waits in-place on unfilled spec)
    std::vector<SpecJob> spec;
    // enumeration records: per-candidate [rec_begin[k], rec_end[k])
    // ranges into recs (valid for k < enum_k); cand_full[k]==0 means the
    // candidate hit the speculation cap and replays through the live
    // path instead.
    std::vector<IterRec> recs;
    std::vector<size_t> rec_begin, rec_end;
    std::vector<uint8_t> cand_full;
    size_t it_rec = 0;
};

struct Engine {
    Opts o;
    // part data
    const int64_t* pos_off;
    const uint32_t* pos_seq;
    const uint32_t* pos_pos;
    const uint8_t* refs_data;
    const int64_t* refs_off;
    int32_t n_refs;
    const uint8_t* reads_data;
    const int64_t* reads_off;
    int32_t n_reads;
    std::vector<FSM> fsms;
    std::vector<int32_t> active;      // indices into fsms with pending job
    // wave emission bookkeeping: (read ordinal, spec index or -1=main)
    std::vector<std::pair<int32_t, int32_t>> emission;
    std::vector<Action> actions;
    // readstats deltas
    int64_t d_num_aligned = 0;
    std::map<int, int64_t> d_matched_per_db;
    // device-work accounting: jobs scored on device vs results actually
    // consumed by a state machine (speculation waste monitor); FSMs left
    // waiting by their start, and (FSM, wave) pairs that offered jobs
    int64_t n_scored = 0, n_consumed = 0;
    int64_t n_starts = 0, n_rounds = 0;
    int nthreads = 1;   // host threads for batched FSM start (--threads)
};

// FSM init + speculation + first advance for one read (engine.cpp).
// Touches only the FSM, so batches can run it from worker threads;
// returns true if the FSM is left waiting on device results.
bool start_one(Engine* e, int32_t ord,
               const int64_t* kids, const int64_t* wins, int32_t n_hits,
               int32_t best, int32_t max_sw_count, int32_t is_hit,
               int32_t n_stored, const int32_t* stored_scores,
               const int32_t* stored_idxnums,
               int32_t min_index, int32_t max_index);

}  // namespace smr

// extern "C" engine surface (engine.cpp) reused by the driver
extern "C" {
int32_t cand_num_active(void* h);
int32_t cand_num_jobs(void* h);
void cand_set_reads(void* h, const uint8_t* reads_data);
void cand_set_strand(void* h, int32_t forward);
void cand_start_batch(void* h, int32_t n, const int32_t* ords,
                      const int64_t* hit_off, const int64_t* kids,
                      const int64_t* wins,
                      const int64_t* st_off, const int32_t* stored_scores,
                      const int32_t* stored_idxnums,
                      const int32_t* state5);
void cand_destroy(void* h);
void* cand_create(const int64_t* pos_off, const uint32_t* pos_seq,
                  const uint32_t* pos_pos,
                  const uint8_t* refs_data, const int64_t* refs_off,
                  int32_t n_refs,
                  const uint8_t* reads_data, const int64_t* reads_off,
                  int32_t n_reads,
                  int num_alignments, int is_best, int num_seeds,
                  int min_lis, int edges, int is_as_percent, int match_,
                  long minimal_score, int lnwin, int gap_open, int gap_ext,
                  int index_num, int part_num, const int8_t* mat);
int64_t probe_windows(
    const uint64_t* fx_k, const uint32_t* fx_v, int64_t fx_n,
    const uint64_t* fp_k, const uint32_t* fp_s, const uint32_t* fp_c,
    int64_t fp_n,
    const uint64_t* rx_k, const uint32_t* rx_s, const uint32_t* rx_c,
    const uint32_t* rx_z, int64_t rx_n,
    const uint64_t* rp_k, const uint32_t* rp_s, const uint32_t* rp_c,
    int64_t rp_n,
    const uint64_t* k19_k, const uint32_t* k19_v, int64_t k19_n,
    const uint32_t* r_ids, const uint32_t* counts9,
    const uint32_t* f19_off, const uint64_t* f19_ti,
    const uint32_t* r19_off, const uint64_t* r19_ti,
    const int64_t* w1a, const int64_t* w2a, int64_t nw,
    int32_t minoccur, int32_t full_search,
    int64_t* out_win, int64_t* out_id, int64_t cap, int32_t threads,
    int32_t pw);
}
