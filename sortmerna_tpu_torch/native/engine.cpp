// Native candidate-selection engine: the per-read LIS/SW-window state
// machines of compute_lis_alignment (alignment.cpp:100-509) with a wave
// interface -- the host-side runtime partner of the device SW kernel.
//
// Per wave:
//   cand_next_jobs()  -> one pending SW job per active read (coordinates
//                        into the concatenated read/ref buffers)
//   [device computes scores + begin/end]
//   cand_post()       -> resume every FSM with its result; accepted
//                        alignments get their CIGAR from the banded
//                        traceback (traceback.cpp semantics) immediately,
//                        and bookkeeping actions (append / replace-min,
//                        first-hit) are recorded for export.
//
// Faithful ports: candidate ordering (freq desc, seq asc,
// alignment.cpp:143-148), best-N budget (165-169), heuristic 1 (239-249),
// LIS (58-98), SW window overhang geometry (283-357), acceptance and
// replace-min bookkeeping (388-473) including the reference's
// reads_matched_per_db replacement quirk (alignment.cpp:454).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <unordered_map>
#include <vector>

#include "engine_core.hpp"
#include "pool.hpp"

using namespace smr;   // Opts/Action/SpecJob/FSM/Engine

extern "C" int traceback_one_c(const uint8_t*, int, const uint8_t*, int,
                               int, int, int, int, const int8_t*,
                               uint32_t*, int);

namespace {

// ---------------------------------------------------------------- LIS
// Longest strictly-increasing run of read positions.  Outcome-equivalent
// to the reference (alignment.cpp:58-98, see ops/lis.py for the
// behavioral contract): patience piles keyed by read position with
// lower_bound placement, a tie on a pile top keeps the earlier entry,
// and the run is rebuilt through predecessor links from the last top.
static void find_lis(const std::deque<std::pair<uint32_t, uint32_t>>& hits,
                     std::vector<uint32_t>& out) {
    out.clear();
    if (hits.empty()) return;
    std::vector<uint32_t> tops;      // read position topping each pile
    std::vector<uint32_t> top_at;    // hit index topping each pile
    std::vector<int32_t> prev(hits.size(), -1);
    for (uint32_t i = 0; i < (uint32_t)hits.size(); ++i) {
        uint32_t q = hits[i].second;
        size_t pile = std::lower_bound(tops.begin(), tops.end(), q)
                      - tops.begin();
        if (pile == tops.size()) {
            tops.push_back(q);
            top_at.push_back(i);
        } else if (q < tops[pile]) {
            tops[pile] = q;
            top_at[pile] = i;
        } else {
            continue;                // tie on the top: earlier entry wins
        }
        if (pile) prev[i] = (int32_t)top_at[pile - 1];
    }
    for (int32_t i = (int32_t)top_at.back(); i >= 0; i = prev[i])
        out.push_back((uint32_t)i);
    std::reverse(out.begin(), out.end());
}

static int read_len(Engine* e, int ord) {
    return (int)(e->reads_off[ord + 1] - e->reads_off[ord]);
}
static int ref_len(Engine* e, int r) {
    return (int)(e->refs_off[r + 1] - e->refs_off[r]);
}

// Build candidate list for a read (alignment.cpp:117-148).
// All (seq, pos, win) triples are materialized once and sorted by
// (seq, pos, win); per-candidate hit lists become contiguous subranges,
// replacing the reference's per-candidate rescan (alignment.cpp:181-201)
// and the frequency map with run-length counting.
static void build_cands(Engine* e, FSM& f,
                        const int64_t* kids, const int64_t* wins,
                        int n_hits) {
    size_t total = 0;
    for (int h = 0; h < n_hits; ++h)
        total += (size_t)(e->pos_off[kids[h] + 1] - e->pos_off[kids[h]]);
    // pack (seq, pos, win) into one u64 key: seq<<40 | pos<<16 | win
    // (pos < 2^24 guaranteed: sequences <= 16M nt per part; win < 2^16
    // for reads <= 64K nt -- larger values fall back to 3-way sort)
    f.trip.clear();
    f.trip.reserve(total);
    bool packable = true;
    for (int h = 0; h < n_hits && packable; ++h)
        packable = wins[h] < (1 << 16);
    for (int h = 0; h < n_hits; ++h) {
        int64_t kid = kids[h];
        uint64_t w = (uint64_t)wins[h];
        for (int64_t j = e->pos_off[kid]; j < e->pos_off[kid + 1]; ++j) {
            uint64_t key = ((uint64_t)e->pos_seq[j] << 40)
                           | ((uint64_t)(e->pos_pos[j] & 0xFFFFFF) << 16)
                           | (w & 0xFFFF);
            f.trip.push_back(key);
        }
    }
    std::sort(f.trip.begin(), f.trip.end());

    f.cands.clear();
    f.cand_begin.clear();
    f.cand_end.clear();
    size_t i = 0;
    std::vector<std::pair<uint32_t, uint32_t>> all;   // (seq, freq)
    std::vector<std::pair<size_t, size_t>> ranges;
    while (i < f.trip.size()) {
        uint32_t seq = (uint32_t)(f.trip[i] >> 40);
        size_t j = i;
        while (j < f.trip.size() && (uint32_t)(f.trip[j] >> 40) == seq)
            ++j;
        if (j - i >= (size_t)e->o.num_seeds) {
            all.emplace_back(seq, (uint32_t)(j - i));
            ranges.emplace_back(i, j);
        }
        i = j;
    }
    std::vector<size_t> order(all.size());
    for (size_t k = 0; k < order.size(); ++k) order[k] = k;
    std::stable_sort(order.begin(), order.end(),
                     [&](size_t a, size_t b) {
                         if (all[a].second == all[b].second)
                             return all[a].first < all[b].first;
                         return all[a].second > all[b].second;
                     });
    for (size_t k : order) {
        f.cands.push_back(all[k]);
        f.cand_begin.push_back(ranges[k].first);
        f.cand_end.push_back(ranges[k].second);
    }
}

// materialize hits_on_ref for candidate j from its sorted subrange
static void fill_hits_on_ref(const FSM& f, size_t j,
                             std::vector<std::pair<uint32_t, uint32_t>>& out) {
    out.clear();
    out.reserve(f.cand_end[j] - f.cand_begin[j]);
    for (size_t i = f.cand_begin[j]; i < f.cand_end[j]; ++i) {
        uint64_t k = f.trip[i];
        out.emplace_back((uint32_t)((k >> 16) & 0xFFFFFF),
                         (uint32_t)(k & 0xFFFF));
    }
}

static void enumerate_through(Engine* e, FSM& f, size_t j);

// Start candidate k: returns true if the candidate loop should proceed
// to the window loop / record walk, false if the whole call is done.
// Record-path candidates skip the match_set machinery entirely.
static bool start_candidate(Engine* e, FSM& f) {
    if (f.k >= f.cands.size() || !f.is_search_candidates) return false;
    uint32_t max_ref = f.cands[f.k].first;
    uint32_t max_occur = f.cands[f.k].second;
    if (max_occur < (uint32_t)e->o.num_seeds) return false;
    if (f.is_aligned && e->o.min_lis > 0 && f.k > 0
        && max_occur < f.cands[f.k - 1].second) {
        if (--f.best < 1) return false;
    }
    f.cur_ref = max_ref;
    enumerate_through(e, f, f.k);
    if (f.cand_full[f.k]) {
        f.it_rec = f.rec_begin[f.k];
        return true;
    }
    // live fallback: hits on this reference, already sorted by (pos, win)
    fill_hits_on_ref(f, f.k, f.hits_on_ref);
    f.it = 0;
    f.match_set.clear();
    f.begin_ref = f.hits_on_ref[0].first;
    f.begin_read = f.hits_on_ref[0].second;
    return true;
}

// SW window geometry (alignment.cpp:283-357)
static void window_geometry(long readlen, long reflen, long lcs_r,
                            long lcs_q, long edges,
                            long& ars, long& aqs, long& head, long& tail,
                            long& alen) {
    head = 0; tail = 0;
    if (lcs_r < lcs_q) {
        ars = 0;
        aqs = lcs_q - lcs_r;
        if (reflen < readlen) {
            tail = 0;
            if (aqs > readlen - reflen)
                alen = reflen - (aqs - (readlen - reflen));
            else
                alen = reflen;
        } else {
            tail = reflen - ars - readlen;
            if (tail > edges - 1) tail = edges;
            alen = readlen + head + tail - aqs;
        }
    } else {
        ars = lcs_r - lcs_q;
        aqs = 0;
        if (ars > edges - 1) head = edges;
        if (ars + readlen > reflen) {
            tail = 0;
            alen = reflen - ars - head;
        } else {
            tail = reflen - ars - readlen;
            if (tail > edges - 1) tail = edges;
            alen = readlen + head + tail;
        }
    }
}

static long edges_of(const Opts& o, int readlen) {
    return o.is_as_percent ? (long)((o.edges / 100.0) * readlen)
                           : (long)o.edges;
}

// One iteration of the window loop up to either an SW job (returns 1,
// geometry stored in FSM) or candidate exhausted (returns 0).
static int window_loop(Engine* e, FSM& f) {
    int readlen = read_len(e, f.ord);
    for (;;) {
        if (f.it >= f.hits_on_ref.size() || !f.is_search_candidates)
            return 0;
        int64_t end_ref_max = f.begin_ref + readlen - f.begin_read
                              - e->o.lnwin + 1;
        bool push = false;
        while (f.it < f.hits_on_ref.size()
               && (int64_t)f.hits_on_ref[f.it].first <= end_ref_max) {
            f.match_set.push_back(f.hits_on_ref[f.it]);
            push = true;
            ++f.it;
        }
        bool do_align = true;
        if (!push && f.is_aligned) do_align = false;   // heuristic 1
        else f.is_aligned = false;

        if (do_align && f.match_set.size() >= (size_t)e->o.num_seeds) {
            std::vector<uint32_t> lis;
            find_lis(f.match_set, lis);
            if (lis.size() >= (size_t)e->o.min_lis) {
                long lcs_r = f.match_set[lis[0]].first;
                long lcs_q = f.match_set[lis[0]].second;
                window_geometry(readlen, ref_len(e, (int)f.cur_ref),
                                lcs_r, lcs_q, edges_of(e->o, readlen),
                                f.ar, f.aq, f.head, f.tail, f.alen);
                return 1;   // job ready
            }
        }
        // pop (alignment.cpp:486-506)
        if (!f.match_set.empty()) f.match_set.pop_front();
        if (f.match_set.empty()) {
            if (f.it < f.hits_on_ref.size()) {
                f.begin_ref = f.hits_on_ref[f.it].first;
                f.begin_read = f.hits_on_ref[f.it].second;
            } else
                return 0;
        } else {
            f.begin_ref = f.match_set.front().first;
            f.begin_read = f.match_set.front().second;
        }
    }
}

// Enumerate EVERY window-loop iteration of candidate j as an IterRec
// (plus an SW SpecJob where the num_seeds / min_lis gates pass),
// mirroring window_loop + the post-align pop step exactly.  The replay
// (phase-4 record walk in advance()) then consumes exactly the subset
// the reference would have issued -- no geometry/LIS recomputation.
// Returns false once the per-read cap is hit; in that case this
// candidate's partial records+jobs are rolled back and the candidate
// falls to the live window-loop path.
static bool enumerate_candidate_jobs(Engine* e, FSM& f, size_t j,
                                     size_t cap) {
    f.rec_begin[j] = f.recs.size();
    f.rec_end[j] = f.recs.size();
    if (j >= f.cands.size()) return true;
    uint32_t max_ref = f.cands[j].first;
    if (f.cands[j].second < (uint32_t)e->o.num_seeds) return true;
    int readlen = read_len(e, f.ord);
    std::vector<std::pair<uint32_t, uint32_t>> hits;
    fill_hits_on_ref(f, j, hits);
    if (hits.empty()) return true;
    size_t spec0 = f.spec.size();
    size_t it = 0;
    std::deque<std::pair<uint32_t, uint32_t>> ms;
    int64_t br = hits[0].first, bq = hits[0].second;
    while (it < hits.size()) {
        int64_t end_ref_max = br + readlen - bq - e->o.lnwin + 1;
        bool push = false;
        while (it < hits.size()
               && (int64_t)hits[it].first <= end_ref_max) {
            ms.push_back(hits[it]);
            push = true;
            ++it;
        }
        IterRec rec{-1, (uint8_t)(push ? 1 : 0)};
        if (ms.size() >= (size_t)e->o.num_seeds) {
            std::vector<uint32_t> lis;
            find_lis(ms, lis);
            if (lis.size() >= (size_t)e->o.min_lis) {
                SpecJob s;
                s.ref = max_ref;
                window_geometry(readlen, ref_len(e, (int)max_ref),
                                ms[lis[0]].first, ms[lis[0]].second,
                                edges_of(e->o, readlen),
                                s.ar, s.aq, s.head, s.tail, s.alen);
                rec.spec = (int32_t)f.spec.size();
                f.spec.push_back(s);
                if (f.spec.size() >= cap) {
                    // roll back the partial candidate
                    f.spec.resize(spec0);
                    f.recs.resize(f.rec_begin[j]);
                    f.rec_end[j] = f.rec_begin[j];
                    return false;
                }
            }
        }
        f.recs.push_back(rec);
        if (!ms.empty()) ms.pop_front();
        if (ms.empty()) {
            if (it < hits.size()) { br = hits[it].first; bq = hits[it].second; }
            else break;
        } else {
            br = ms.front().first;
            bq = ms.front().second;
        }
    }
    f.rec_end[j] = f.recs.size();
    return true;
}

// Speculation depth.  A scored job costs the card about the same
// whether a read applies it or not (a long read's job is about 1,450 x
// 1,460 cells), and the host packs and uploads each one; offered all at
// once, a read's jobs were 97.4% waste in the long-read benchmark (2.6
// applied of about 105 scored a read).  So a read offers SPEC_ROUND0
// jobs from its cursor in its first wave and twice its last round in
// each later wave it still waits.  SPEC_CAP bounds the jobs a read
// enumerates: past it, its remaining candidates replay through the live
// window-loop path, one job a wave.
constexpr size_t SPEC_ROUND0 = 4;
constexpr size_t SPEC_CAP = 8192;

// Enumerate candidates up to and including j, in candidate order; the
// one that hits the cap, and every later one, take the live path.
static void enumerate_through(Engine* e, FSM& f, size_t j) {
    size_t n = f.cands.size();
    while (f.enum_k <= j && f.enum_k < n) {
        if (!enumerate_candidate_jobs(e, f, f.enum_k, SPEC_CAP)) {
            for (size_t m = f.enum_k; m < n; ++m) f.cand_full[m] = 0;
            f.enum_k = n;
            return;
        }
        ++f.enum_k;
    }
}

// The spec job a waiting record walk (phase 4) stands on.
static size_t cursor_of(const FSM& f) {
    return (size_t)f.recs[f.it_rec].spec;
}

// One past the last job of the FSM's next round: its `round` unfilled
// jobs from `cursor` on, enumerating candidates as the round needs
// them; short of that where the read's enumeration runs out.
static size_t round_end(Engine* e, FSM& f, size_t cursor) {
    size_t left = f.round, s = cursor;
    for (;;) {
        for (; s < f.spec.size() && left; ++s)
            if (!f.spec[s].filled) --left;
        if (!left || f.enum_k >= f.cands.size()) return s;
        enumerate_through(e, f, f.enum_k);
    }
}

static void apply_result(Engine* e, FSM& f,
                         long aq, long ar, long head, uint32_t ref,
                         int32_t score, int32_t rb, int32_t re,
                         int32_t qb, int32_t qe);
static void post_result(Engine* e, FSM& f, int32_t score,
                        int32_t rb, int32_t re, int32_t qb, int32_t qe);

// advance an FSM until it has a pending job or is done; the record walk
// (phase 4) consumes filled speculative results inline and waits
// in-place on the first unfilled one.
static void advance(Engine* e, FSM& f) {
    for (;;) {
        if (f.phase == 0) {
            if (!start_candidate(e, f)) { f.phase = 3; return; }
            f.phase = f.cand_full[f.k] ? 4 : 1;
        }
        if (f.phase == 4) {
            size_t end = f.rec_end[f.k];
            while (f.it_rec < end && f.is_search_candidates) {
                const IterRec& r = f.recs[f.it_rec];
                bool do_align = true;
                if (!r.push && f.is_aligned) do_align = false;
                else f.is_aligned = false;
                if (do_align && r.spec >= 0) {
                    SpecJob& s = f.spec[r.spec];
                    if (!s.filled) return;   // wave round-trip; resume here
                    ++f.it_rec;
                    ++e->n_consumed;
                    apply_result(e, f, s.aq, s.ar, s.head, s.ref,
                                 s.score, s.rb, s.re, s.qb, s.qe);
                    continue;
                }
                ++f.it_rec;
            }
            ++f.k;
            f.phase = 0;
            continue;
        }
        if (f.phase == 1) {
            if (window_loop(e, f)) {
                f.phase = 2;
                return;
            }
            ++f.k;
            f.phase = 0;
            continue;
        }
        if (f.phase == 3 || f.phase == 2) return;
    }
}

static int find_min_idx(const std::vector<int32_t>& s) {
    int mi = 0;
    for (size_t i = 0; i < s.size(); ++i)
        if (s[i] < s[mi]) mi = (int)i;
    return mi;
}
static int find_max_idx(const std::vector<int32_t>& s) {
    int mi = 0;
    for (size_t i = 0; i < s.size(); ++i)
        if (s[i] > s[mi]) mi = (int)i;
    return mi;
}

// apply an SW result (alignment.cpp:388-473); geometry is the JOB's
// (aq, ar, head, ref) -- the FSM's own fields on the live path, the
// SpecJob's on the record path.
static void apply_result(Engine* e, FSM& f,
                         long aq, long ar, long head, uint32_t ref,
                         int32_t score, int32_t rb, int32_t re,
                         int32_t qb, int32_t qe) {
    const Opts& o = e->o;
    int readlen = read_len(e, f.ord);
    f.is_aligned = score > o.minimal_score;
    if (f.is_aligned) {
        long max_sw = (long)readlen * o.match_;
        if (score == max_sw) ++f.max_sw_count;

        Action a;
        a.read_ord = f.ord;
        a.ref_num = (int32_t)ref;
        a.score = score;
        a.rb = rb + (int32_t)(ar - head);
        a.re = re + (int32_t)(ar - head);
        a.qb = qb + (int32_t)aq;
        a.qe = qe + (int32_t)aq;
        a.first_hit = 0;
        a.strand_forward = o.strand_forward;

        // deferred traceback window (clipped)
        a.rw_off = e->refs_off[ref] + (ar - head) + rb;
        a.qw_off = e->reads_off[f.ord] + aq + qb;
        a.rl = re - rb + 1;
        a.ql = qe - qb + 1;
        a.band = a.rl > a.ql ? a.rl - a.ql + 1 : a.ql - a.rl + 1;

        if (!f.is_hit) {
            f.is_hit = true;
            a.first_hit = 1;
            e->d_num_aligned++;
            e->d_matched_per_db[o.index_num]++;
        }

        int nal = (int)f.scores.size();
        if (o.num_alignments == 0 || !o.is_best
            || nal < o.num_alignments) {
            a.kind = 0;
            a.slot = nal;
            f.scores.push_back(score);
            f.idxnums.push_back(o.index_num);
        } else if (o.is_best && nal == o.num_alignments
                   && f.scores[f.min_index] < score) {
            if (o.num_alignments > 1 && f.max_index == 0
                && f.min_index == 0) {
                f.min_index = find_min_idx(f.scores);
                f.max_index = find_max_idx(f.scores);
            }
            int mini = f.min_index;
            a.kind = 1;
            a.slot = mini;
            f.scores[mini] = score;
            f.idxnums[mini] = o.index_num;
            if (score > f.scores[f.max_index] && f.scores.size() > 1) {
                f.max_index = mini;
                f.min_index = find_min_idx(f.scores);
            }
            // reference quirk: decrements the NEW alignment's db
            // (alignment.cpp:454)
            e->d_matched_per_db[f.idxnums[mini]]--;
            e->d_matched_per_db[o.index_num]++;
        } else {
            a.kind = 2;   // accepted but not stored (score too low)
        }
        if (a.kind != 2) e->actions.push_back(std::move(a));

        if (o.num_alignments > 0) {
            if (o.is_best) {
                if (o.num_alignments == f.max_sw_count)
                    f.is_search_candidates = false;
            } else if (o.num_alignments == (int)f.scores.size())
                f.is_search_candidates = false;
        }
        f.search = false;
    }
}

// live-path result handler: bookkeeping + the post-align pop step
// (alignment.cpp:486-506); the record path advances its cursor instead.
static void post_result(Engine* e, FSM& f, int32_t score,
                        int32_t rb, int32_t re, int32_t qb, int32_t qe) {
    apply_result(e, f, f.aq, f.ar, f.head, f.cur_ref,
                 score, rb, re, qb, qe);
    // resume window loop: pop step after the align attempt
    if (!f.match_set.empty()) f.match_set.pop_front();
    if (f.match_set.empty()) {
        if (f.it < f.hits_on_ref.size()) {
            f.begin_ref = f.hits_on_ref[f.it].first;
            f.begin_read = f.hits_on_ref[f.it].second;
        } else {
            ++f.k;
            f.phase = 0;
            return;
        }
    } else {
        f.begin_ref = f.match_set.front().first;
        f.begin_read = f.match_set.front().second;
    }
    f.phase = 1;
}

}  // namespace

namespace smr {

// FSM init + first advance for one read, with the enumeration of its
// first round.  Touches ONLY the FSM, so batches can run it from worker
// threads; returns true if the FSM is left waiting on device results.
bool start_one(Engine* e, int32_t ord,
               const int64_t* kids, const int64_t* wins,
               int32_t n_hits,
               int32_t best, int32_t max_sw_count, int32_t is_hit,
               int32_t n_stored, const int32_t* stored_scores,
               const int32_t* stored_idxnums,
               int32_t min_index, int32_t max_index) {
    FSM& f = e->fsms[ord];
    if (f.managed) {
        // carry the engine-authoritative read state through the reset
        FSM nf;
        nf.best = f.best;
        nf.max_sw_count = f.max_sw_count;
        nf.is_hit = f.is_hit;
        nf.scores = std::move(f.scores);
        nf.idxnums = std::move(f.idxnums);
        nf.min_index = f.min_index;
        nf.max_index = f.max_index;
        f = std::move(nf);
        f.managed = true;
    } else {
        f = FSM();
        f.best = best;
        f.max_sw_count = max_sw_count;
        f.is_hit = is_hit != 0;
        f.scores.assign(stored_scores, stored_scores + n_stored);
        f.idxnums.assign(stored_idxnums, stored_idxnums + n_stored);
        f.min_index = min_index;
        f.max_index = max_index;
        f.managed = true;
    }
    f.ord = ord;
    build_cands(e, f, kids, wins, n_hits);
    size_t n = f.cands.size();
    f.rec_begin.assign(n, 0);
    f.rec_end.assign(n, 0);
    f.cand_full.assign(n, 1);
    f.round = SPEC_ROUND0;
    advance(e, f);
    if (f.phase == 4) round_end(e, f, cursor_of(f));
    return f.phase == 2 || f.phase == 4;
}

}  // namespace smr

extern "C" {

void* cand_create(const int64_t* pos_off, const uint32_t* pos_seq,
                  const uint32_t* pos_pos,
                  const uint8_t* refs_data, const int64_t* refs_off,
                  int32_t n_refs,
                  const uint8_t* reads_data, const int64_t* reads_off,
                  int32_t n_reads,
                  int num_alignments, int is_best, int num_seeds,
                  int min_lis, int edges, int is_as_percent, int match_,
                  long minimal_score, int lnwin, int gap_open, int gap_ext,
                  int index_num, int part_num, const int8_t* mat) {
    Engine* e = new Engine();
    e->pos_off = pos_off;
    e->pos_seq = pos_seq;
    e->pos_pos = pos_pos;
    e->refs_data = refs_data;
    e->refs_off = refs_off;
    e->n_refs = n_refs;
    e->reads_data = reads_data;
    e->reads_off = reads_off;
    e->n_reads = n_reads;
    e->o.num_alignments = num_alignments;
    e->o.is_best = is_best;
    e->o.num_seeds = num_seeds;
    e->o.min_lis = min_lis;
    e->o.edges = edges;
    e->o.is_as_percent = is_as_percent;
    e->o.match_ = match_;
    e->o.minimal_score = minimal_score;
    e->o.lnwin = lnwin;
    e->o.gap_open = gap_open;
    e->o.gap_ext = gap_ext;
    e->o.index_num = index_num;
    e->o.part_num = part_num;
    e->o.strand_forward = 1;    // cand_set_strand switches per strand
    std::memcpy(e->o.mat, mat, 25);
    e->fsms.resize(n_reads);
    return e;
}

void cand_destroy(void* h) { delete (Engine*)h; }

// the pool width cand_start_batch uses (--threads)
void cand_set_threads(void* h, int t) {
    ((Engine*)h)->nthreads = t < 1 ? 1 : t;
}

// strand switch (driver.cpp): point the engine at the other strand's
// concatenated 04 buffer and tag subsequent actions with the strand
void cand_set_reads(void* h, const uint8_t* reads_data) {
    ((Engine*)h)->reads_data = reads_data;
}
void cand_set_strand(void* h, int32_t forward) {
    ((Engine*)h)->o.strand_forward = forward;
}

// begin a compute_lis_alignment call for one read
void cand_start(void* h, int32_t ord,
                const int64_t* kids, const int64_t* wins, int32_t n_hits,
                int32_t best, int32_t max_sw_count, int32_t is_hit,
                int32_t n_stored, const int32_t* stored_scores,
                const int32_t* stored_idxnums,
                int32_t min_index, int32_t max_index) {
    Engine* e = (Engine*)h;
    if (start_one(e, ord, kids, wins, n_hits, best, max_sw_count, is_hit,
                  n_stored, stored_scores, stored_idxnums,
                  min_index, max_index)) {
        e->active.push_back(ord);
        ++e->n_starts;
    }
}

// batched cand_start: one call for a whole pass, cut into e->nthreads
// contiguous read slices (--threads; processor.cpp:248-253 is the
// semantic model) run on the native pool (pool.hpp; inline inside a
// pool task).  A slice touches only its own FSMs; `active` is
// assembled in ordinal-sorted order afterward so wave composition is
// deterministic regardless of thread count.  CSR layouts:
//   hits: kids/wins [hit_off[i] .. hit_off[i+1])
//   stored alignment scores/idxnums: [st_off[i] .. st_off[i+1])
//   state: [best, max_sw_count, is_hit, min_index, max_index] x n
void cand_start_batch(void* h, int32_t n, const int32_t* ords,
                      const int64_t* hit_off, const int64_t* kids,
                      const int64_t* wins,
                      const int64_t* st_off, const int32_t* stored_scores,
                      const int32_t* stored_idxnums,
                      const int32_t* state5) {
    Engine* e = (Engine*)h;
    int nt = e->nthreads;
    if (nt > n) nt = n > 0 ? n : 1;

    auto run_slice = [&](int32_t lo, int32_t hi,
                         std::vector<int32_t>& act) {
        for (int32_t i = lo; i < hi; ++i) {
            const int32_t* s5 = state5 + i * 5;
            if (start_one(e, ords[i], kids + hit_off[i], wins + hit_off[i],
                          (int32_t)(hit_off[i + 1] - hit_off[i]),
                          s5[0], s5[1], s5[2],
                          (int32_t)(st_off[i + 1] - st_off[i]),
                          stored_scores + st_off[i],
                          stored_idxnums + st_off[i],
                          s5[3], s5[4]))
                act.push_back(ords[i]);
        }
    };

    std::vector<std::vector<int32_t>> acts(nt);
    pool_for(e->nthreads, nt, [&](int64_t t) {
        run_slice((int32_t)((int64_t)n * t / nt),
                  (int32_t)((int64_t)n * (t + 1) / nt), acts[t]);
    });
    for (auto& act : acts) {
        e->active.insert(e->active.end(), act.begin(), act.end());
        e->n_starts += (int64_t)act.size();
    }
}

// total jobs of the next wave; builds the emission list consumed by
// cand_next_jobs / cand_post.  Record-path FSMs (phase 4) emit one
// round: their next `round` unfilled speculative jobs from the cursor
// on (the job the cursor waits on first; jobs behind it are dead);
// live-path FSMs (phase 2) emit their one pending main job.  Past the
// speculation cap every candidate is live, so a live FSM has no
// speculative job left to offer.
int32_t cand_num_jobs(void* h) {
    Engine* e = (Engine*)h;
    e->emission.clear();
    for (int32_t ord : e->active) {
        FSM& f = e->fsms[ord];
        if (f.phase == 2) {
            e->emission.emplace_back(ord, -1);
            continue;
        }
        size_t c = cursor_of(f), end = round_end(e, f, c);
        for (size_t s = c; s < end; ++s)
            if (!f.spec[s].filled)
                e->emission.emplace_back(ord, (int32_t)s);
    }
    return (int32_t)e->emission.size();
}

// collect pending jobs; returns count (same order as future cand_post)
int32_t cand_next_jobs(void* h, int32_t* job_read,
                       int64_t* q_off, int32_t* q_len,
                       int64_t* r_off, int32_t* r_len,
                       int64_t* minimal) {
    Engine* e = (Engine*)h;
    int32_t n = 0;
    for (auto& em : e->emission) {
        FSM& f = e->fsms[em.first];
        long aq, ar, head, tail, alen;
        uint32_t ref;
        if (em.second < 0) {
            aq = f.aq; ar = f.ar; head = f.head; tail = f.tail;
            alen = f.alen; ref = f.cur_ref;
        } else {
            SpecJob& s = f.spec[em.second];
            aq = s.aq; ar = s.ar; head = s.head; tail = s.tail;
            alen = s.alen; ref = s.ref;
        }
        job_read[n] = em.first;
        q_off[n] = e->reads_off[em.first] + aq;
        q_len[n] = (int32_t)(alen - head - tail);
        r_off[n] = e->refs_off[ref] + (ar - head);
        r_len[n] = (int32_t)alen;
        minimal[n] = e->o.minimal_score;
        ++n;
    }
    return n;
}

// feed SW results (parallel to the last cand_next_jobs output); FSMs
// advance to their next job or completion.  Speculative fills are applied
// before main results so a freshly-arrived wave can be chained through
// without extra rounds.
void cand_post(void* h, int32_t n, const int32_t* scores,
               const int32_t* rb, const int32_t* re,
               const int32_t* qb, const int32_t* qe) {
    Engine* e = (Engine*)h;
    e->n_scored += n;
    for (int32_t i = 0; i < n; ++i) {
        auto& em = e->emission[i];
        if (i == 0 || em.first != e->emission[i - 1].first) {
            // an FSM's jobs lie together in the wave: one round each,
            // and the next round twice as deep
            ++e->n_rounds;
            FSM& f = e->fsms[em.first];
            f.round = std::min(2 * f.round, SPEC_CAP);
        }
        if (em.second >= 0) {
            SpecJob& s = e->fsms[em.first].spec[em.second];
            s.score = scores[i];
            s.rb = rb[i]; s.re = re[i]; s.qb = qb[i]; s.qe = qe[i];
            s.filled = true;
        }
    }
    std::vector<int32_t> prev;
    prev.swap(e->active);
    // live-path main results first (their FSMs re-advance below)
    for (int32_t i = 0; i < n; ++i) {
        auto& em = e->emission[i];
        if (em.second >= 0) continue;
        FSM& f = e->fsms[em.first];
        ++e->n_consumed;
        post_result(e, f, scores[i], rb[i], re[i], qb[i], qe[i]);
    }
    // every previously-active FSM advances: record walks consume their
    // freshly-filled speculative results inline
    for (int32_t ord : prev) {
        FSM& f = e->fsms[ord];
        advance(e, f);
        if (f.phase == 2 || f.phase == 4) e->active.push_back(ord);
    }
    e->emission.clear();
}

// SW jobs scored on the device, results a read's FSM applied, FSMs
// their start left waiting, and (FSM, wave) pairs that offered jobs:
// [n_scored, n_consumed, n_starts, n_rounds]
void cand_sw_counts(void* h, int64_t* out4) {
    Engine* e = (Engine*)h;
    out4[0] = e->n_scored;
    out4[1] = e->n_consumed;
    out4[2] = e->n_starts;
    out4[3] = e->n_rounds;
}

int32_t cand_num_active(void* h) {
    return (int32_t)((Engine*)h)->active.size();
}

// per-read final state: search flag, best, max_sw_count, is_hit
void cand_read_state(void* h, int32_t ord, int32_t* out4) {
    Engine* e = (Engine*)h;
    FSM& f = e->fsms[ord];
    out4[0] = f.search ? 1 : 0;
    out4[1] = f.best;
    out4[2] = f.max_sw_count;
    out4[3] = f.is_hit ? 1 : 0;
    out4[4] = f.min_index;
    out4[5] = f.max_index;
}

// batched variant: one call for a whole item list (the per-ordinal
// ctypes round-trips dominate the python collect stage otherwise)
void cand_read_states_batch(void* h, const int32_t* ords, int64_t n,
                            int32_t* out6 /* n x 6 */) {
    Engine* e = (Engine*)h;
    for (int64_t i = 0; i < n; ++i) {
        FSM& f = e->fsms[ords[i]];
        int32_t* o = out6 + i * 6;
        o[0] = f.search ? 1 : 0;
        o[1] = f.best;
        o[2] = f.max_sw_count;
        o[3] = f.is_hit ? 1 : 0;
        o[4] = f.min_index;
        o[5] = f.max_index;
    }
}

int32_t cand_num_actions(void* h) {
    Engine* e = (Engine*)h;
    // Compact the replace-min churn before export: only the LAST action
    // per (read, slot) shapes the final alignment list (best-N
    // bookkeeping, alignment.cpp:420-459), so superseded appends/
    // replacements never cross into Python -- the export loop, window
    // gather and deferred tracebacks all shrink to survivors.  The
    // first occurrence keeps its kind (an append superseded by a
    // replace must still APPEND at its list position) and position in
    // the list, the last occurrence supplies the payload.
    if (e->actions.size() > 1) {
        std::unordered_map<int64_t, size_t> at;
        at.reserve(e->actions.size() * 2);
        std::vector<Action> out;
        out.reserve(e->actions.size());
        for (auto& a : e->actions) {
            int64_t key = ((int64_t)a.read_ord << 32)
                          | (uint32_t)a.slot;
            auto it = at.find(key);
            if (it == at.end()) {
                at.emplace(key, out.size());
                out.push_back(a);
            } else {
                Action& first = out[it->second];
                int32_t kind = first.kind;
                int32_t fh = first.first_hit | a.first_hit;
                first = a;
                first.kind = kind;
                first.first_hit = fh;
            }
        }
        e->actions.swap(out);
    }
    return (int32_t)e->actions.size();
}

// export actions: fixed int32 fields [n,14] + int64 window offsets [n,2]
void cand_export_actions(void* h, int32_t* fields /*[n,14]*/,
                         int64_t* offs /*[n,2]*/) {
    Engine* e = (Engine*)h;
    for (size_t i = 0; i < e->actions.size(); ++i) {
        const Action& a = e->actions[i];
        int32_t* r = fields + i * 14;
        r[0] = a.read_ord; r[1] = a.kind; r[2] = a.slot; r[3] = a.first_hit;
        r[4] = a.ref_num; r[5] = a.score;
        r[6] = a.rb; r[7] = a.re; r[8] = a.qb; r[9] = a.qe;
        r[10] = a.rl; r[11] = a.ql; r[12] = a.band;
        r[13] = a.strand_forward;
        offs[i * 2] = a.rw_off;
        offs[i * 2 + 1] = a.qw_off;
    }
}

void cand_clear_actions(void* h) { ((Engine*)h)->actions.clear(); }

// readstats deltas: [num_aligned, n_db_entries, (db, delta)...]
int64_t cand_stat_num_aligned(void* h) {
    return ((Engine*)h)->d_num_aligned;
}
int32_t cand_stat_num_dbs(void* h) {
    return (int32_t)((Engine*)h)->d_matched_per_db.size();
}
void cand_stat_dbs(void* h, int32_t* db, int64_t* delta) {
    Engine* e = (Engine*)h;
    int i = 0;
    for (auto& kv : e->d_matched_per_db) {
        db[i] = kv.first;
        delta[i] = kv.second;
        ++i;
    }
}

}  // extern "C"
