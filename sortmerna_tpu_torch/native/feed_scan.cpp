// Native FASTA/FASTQ block scanners for the streaming reads feed.
//
// The feed (io/feed.py) parses ~64MB decompressed blocks into packed
// caches (concatenated seq/header/quality bytes + per-record lengths).
// The numpy scanners spend most of their time in boolean-mask cumsum
// gathers; these single-pass scanners do the same job with memcpy at
// memory speed, letting the pipelined gzip inflate (readfeed.cpp:1138's
// capability) run on the other core.
//
// Semantics mirror feed.py's _scan_fasta/_scan_fastq exactly:
// * lines end at '\n'; a trailing '\r' is stripped; blank lines skipped
// * FASTA: header = line after '>', sequence lines have ' ' stripped;
//   the last record is withheld unless `final` (it may continue in the
//   next block); `consumed` = start of the withheld header line
//   (or end of the last line when final)
// * FASTQ: complete 4-line records; header must start '@', third line
//   '+'; consumed = end of the last complete record's 4th line
//
// Return: consumed bytes (0 = no complete record yet), or a negative
// error code (-1 data before first header, -2 header malformed).

#include <cstdint>
#include <cstring>

namespace {

struct Line {
    const uint8_t* p;
    int64_t len;       // excluding newline and trailing \r
    int64_t start;     // byte offset of line start in buf
    int64_t end_nl;    // byte offset one past the '\n'
};

// iterate complete ('\n'-terminated) lines; returns false at end
struct LineIter {
    const uint8_t* buf;
    int64_t n, pos = 0;
    bool next(Line& out) {
        while (pos < n) {
            const uint8_t* nl = (const uint8_t*)
                std::memchr(buf + pos, '\n', (size_t)(n - pos));
            if (!nl) return false;
            int64_t ls = pos, le = nl - buf;
            pos = le + 1;
            int64_t len = le - ls;
            if (len > 0 && buf[le - 1] == '\r') --len;
            if (len == 0) continue;           // blank line skipped
            out.p = buf + ls;
            out.len = len;
            out.start = ls;
            out.end_nl = pos;
            return true;
        }
        return false;
    }
};

}  // namespace

extern "C" {

// counts out: [n_rec, seq_bytes, hdr_bytes]
int64_t feed_scan_fasta(const uint8_t* buf, int64_t n, int32_t final_,
                        uint8_t* seq_out, int64_t* seq_len,
                        uint8_t* hdr_out, int64_t* hdr_len,
                        int64_t* counts) {
    LineIter it{buf, n};
    Line ln;
    int64_t n_rec = 0, seq_b = 0, hdr_b = 0;
    int64_t cur_seq = 0;             // bytes of the open record
    bool open = false;
    int64_t last_hdr_start = -1;     // for the non-final withhold
    int64_t last_line_end = 0;

    while (it.next(ln)) {
        last_line_end = ln.end_nl;
        if (ln.p[0] == '>') {
            if (open) {
                seq_len[n_rec] = cur_seq;
                seq_b += cur_seq;
                ++n_rec;
            }
            open = true;
            last_hdr_start = ln.start;
            hdr_len[n_rec] = ln.len - 1;
            std::memcpy(hdr_out + hdr_b, ln.p + 1, (size_t)(ln.len - 1));
            hdr_b += ln.len - 1;
            cur_seq = 0;
        } else {
            if (!open) return -1;    // data before first header
            // sequence line, ' ' stripped
            for (int64_t i = 0; i < ln.len; ++i) {
                uint8_t c = ln.p[i];
                if (c != ' ') seq_out[seq_b + cur_seq++] = c;
            }
        }
    }
    if (!open) return 0;
    int64_t consumed;
    if (final_) {
        seq_len[n_rec] = cur_seq;
        seq_b += cur_seq;
        ++n_rec;
        consumed = last_line_end;
    } else {
        if (n_rec == 0) return 0;    // only the (incomplete) last record
        // withhold the open record; its header bytes were already
        // appended -- trim them back (they are the last hdr_b bytes)
        hdr_b -= hdr_len[n_rec];
        consumed = last_hdr_start;
    }
    counts[0] = n_rec;
    counts[1] = seq_b;
    counts[2] = hdr_b;
    return consumed;
}

// counts out: [n_rec, seq_bytes, hdr_bytes, qual_bytes]
int64_t feed_scan_fastq(const uint8_t* buf, int64_t n,
                        uint8_t* seq_out, int64_t* seq_len,
                        uint8_t* hdr_out, int64_t* hdr_len,
                        uint8_t* qual_out, int64_t* qual_len,
                        int64_t* counts) {
    LineIter it{buf, n};
    Line l0, l1, l2, l3;
    int64_t n_rec = 0, seq_b = 0, hdr_b = 0, qual_b = 0;
    int64_t consumed = 0;
    for (;;) {
        LineIter save = it;
        if (!it.next(l0) || !it.next(l1) || !it.next(l2)
            || !it.next(l3)) {
            it = save;
            break;
        }
        if (l0.p[0] != '@') return -2;   // malformed header line
        if (l2.p[0] != '+') return -3;   // missing '+' line
        hdr_len[n_rec] = l0.len - 1;
        std::memcpy(hdr_out + hdr_b, l0.p + 1, (size_t)(l0.len - 1));
        hdr_b += l0.len - 1;
        seq_len[n_rec] = l1.len;
        std::memcpy(seq_out + seq_b, l1.p, (size_t)l1.len);
        seq_b += l1.len;
        qual_len[n_rec] = l3.len;
        std::memcpy(qual_out + qual_b, l3.p, (size_t)l3.len);
        qual_b += l3.len;
        ++n_rec;
        consumed = l3.end_nl;
    }
    counts[0] = n_rec;
    counts[1] = seq_b;
    counts[2] = hdr_b;
    counts[3] = qual_b;
    return consumed;
}

// Per-batch strand encodings in one pass (read.cpp:334-390 semantics,
// see engine/read.py ReadBatch): from the 03 forward buffer (ambiguous
// chars already 0) and the ambiguous-position list, produce
//   rev03  = per-read reversed complement (COMPLEMENT4)
//   fwd04  = fwd03 with ambiguous -> 4
//   rev04  = rev03 with mirrored ambiguous -> 4
// This replaces three 40MB+ numpy passes plus a materialized int64
// reverse permutation on the hot path.
void batch_strands(const uint8_t* fwd03, const int64_t* offs,
                   int64_t n_reads, const int64_t* amb, int64_t n_amb,
                   uint8_t* rev03, uint8_t* fwd04, uint8_t* rev04) {
    static const uint8_t COMP[5] = {3, 2, 1, 0, 4};
    int64_t total = offs[n_reads];
    for (int64_t r = 0; r < n_reads; ++r) {
        int64_t lo = offs[r], hi = offs[r + 1];
        for (int64_t g = lo; g < hi; ++g) {
            uint8_t c = fwd03[g];
            fwd04[g] = c;
            rev03[lo + hi - 1 - g] = COMP[c];
        }
    }
    std::memcpy(rev04, rev03, (size_t)total);
    // ambiguous positions -> 4 (mirrored within their read for rev04);
    // amb is ascending, reads are contiguous: advance the read cursor
    int64_t r = 0;
    for (int64_t k = 0; k < n_amb; ++k) {
        int64_t g = amb[k];
        while (offs[r + 1] <= g) ++r;
        fwd04[g] = 4;
        rev04[offs[r] + offs[r + 1] - 1 - g] = 4;
    }
}

// Batched CIGAR-walk statistics (Read::calc_miss_gap_match,
// read.cpp:547-589) for the report/classification passes: one call per
// (index part) computes (mismatch, gap, match) counts for every stored
// alignment.  q comes from the strand-resolved concatenated 04 buffers
// (read_begin1 indexes the aligned orientation directly).
void cigar_stats_batch(const uint32_t* cigs, const int64_t* cig_off,
                       const uint8_t* refs, const int64_t* ref_w,
                       const uint8_t* f04, const uint8_t* r04,
                       const uint8_t* strand, const int64_t* q_w,
                       int64_t n, int32_t* out3 /* n x 3 */) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* q = refs + ref_w[i];
        const uint8_t* p = (strand[i] ? f04 : r04) + q_w[i];
        int32_t miss = 0, gap = 0, match = 0;
        for (int64_t c = cig_off[i]; c < cig_off[i + 1]; ++c) {
            uint32_t op = cigs[c] & 0xF;
            int32_t ln = (int32_t)(cigs[c] >> 4);
            if (op == 0) {
                int32_t d = 0;
                for (int32_t k = 0; k < ln; ++k)
                    if (q[k] != p[k]) ++d;
                miss += d;
                match += ln - d;
                q += ln;
                p += ln;
            } else if (op == 1) {
                p += ln;
                gap += ln;
            } else {
                q += ln;
                gap += ln;
            }
        }
        int32_t* o = out3 + i * 3;
        o[0] = miss; o[1] = gap; o[2] = match;
    }
}

// Fill one SW upload block (ops/sw_jax.batch_coords_submit layout):
// per row the query and ref windows packed two chars per byte (high
// nibble first) followed by (q_len, r_len, minimal) little-endian
// int32s.  Replaces two [B, L] numpy fancy-gathers + pack per block.
// sel selects the jobs (size-ordered); rows past n_sel are padding
// (q_len = r_len = 1, minimal = 1<<30).  Gathers clamp at the end of
// the data buffer exactly like the numpy fallback's
// min(off + pos, data_len - 1) (sw_jax.gather_rows_u8): a window that
// overruns its buffer repeats the final byte instead of reading OOB.
void sw_fill_block(const uint8_t* q_data, int64_t q_data_len,
                   const int64_t* q_off, const int32_t* q_len,
                   const uint8_t* r_data, int64_t r_data_len,
                   const int64_t* r_off, const int32_t* r_len,
                   const int32_t* minimal,
                   const int64_t* sel, int64_t n_sel,
                   int64_t B, int64_t lq, int64_t lr, uint8_t* buf) {
    const int64_t hq = lq / 2, hr = lr / 2;
    const int64_t row_bytes = hq + hr + 12;
    auto pack = [](const uint8_t* data, int64_t data_len, int64_t off,
                   int64_t len, int64_t lmax, uint8_t* dst) {
        int64_t safe = data_len - off;       // chars before buffer end
        if (safe < 0) safe = 0;
        if (safe > len) safe = len;
        const uint8_t* src = data + off;
        if (safe == len) {                   // normal case: no clamp
            int64_t pairs = len / 2;
            for (int64_t k = 0; k < pairs; ++k)
                dst[k] = (uint8_t)((src[2 * k] << 4) | src[2 * k + 1]);
            if (len & 1)
                dst[pairs] = (uint8_t)(src[len - 1] << 4);
        } else {                             // clamped tail repeats
            const uint8_t last =             //   the final data byte
                data_len > 0 ? data[data_len - 1] : 0;
            auto at = [&](int64_t k) {
                return k < safe ? src[k] : last;
            };
            int64_t pairs = len / 2;
            for (int64_t k = 0; k < pairs; ++k)
                dst[k] = (uint8_t)((at(2 * k) << 4) | at(2 * k + 1));
            if (len & 1)
                dst[pairs] = (uint8_t)(at(len - 1) << 4);
        }
        int64_t used = (len + 1) / 2;
        std::memset(dst + used, 0, (size_t)(lmax / 2 - used));
    };
    for (int64_t i = 0; i < B; ++i) {
        uint8_t* row = buf + i * row_bytes;
        int32_t ints[3];
        if (i < n_sel) {
            int64_t j = sel[i];
            pack(q_data, q_data_len, q_off[j], q_len[j], lq, row);
            pack(r_data, r_data_len, r_off[j], r_len[j], lr, row + hq);
            ints[0] = q_len[j];
            ints[1] = r_len[j];
            ints[2] = minimal[j];
        } else {
            std::memset(row, 0, (size_t)(hq + hr));
            ints[0] = 1;
            ints[1] = 1;
            ints[2] = 1 << 30;
        }
        std::memcpy(row + hq + hr, ints, 12);
    }
}

// Gather accepted-action traceback windows in one pass: ref spans from
// the part's refs concat, read spans from the f04/r04 strand buffer an
// action aligned on.  Replaces two [total_bytes] numpy fancy-gathers
// plus a strand select per part export (engine/part_driver._export).
void gather_action_windows(
    const uint8_t* refs_data, const int64_t* w_roff, const int32_t* r_len,
    const uint8_t* f04, const uint8_t* r04,
    const int64_t* w_qoff, const int32_t* q_len, const uint8_t* fwd,
    int64_t n, const int64_t* r_out, const int64_t* q_out,
    uint8_t* rbuf, uint8_t* qbuf) {
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(rbuf + r_out[i], refs_data + w_roff[i],
                    (size_t)r_len[i]);
        const uint8_t* src = fwd[i] ? f04 : r04;
        std::memcpy(qbuf + q_out[i], src + w_qoff[i],
                    (size_t)q_len[i]);
    }
}

}  // extern "C"
