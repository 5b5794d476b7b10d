// Native scanners for REFERENCE-format index artifacts
// (.bursttrie_N.dat / .pos_N.dat, indexdb.cpp:1939-2084 layout):
// the Python reader (index/refformat.py read_part) walks 2^18 trie
// records and ~1M+ position records per part, which paces a foreign
// workdir cold load at minutes; these single-pass scanners emit the
// same flat arrays in a few hundred ms.  Decoding mirrors
// refformat._walk_trie/_decode_tails exactly (BFS stream, flag-1
// inline child flags, flag-2 bucket payloads; bucket tails packed
// LSB-first over pw+1-depth chars).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
    const uint8_t* d;
    int64_t n;
    int64_t pos = 0;
    bool ok = true;

    uint32_t u32() {
        if (pos + 4 > n) { ok = false; return 0; }
        uint32_t v;
        std::memcpy(&v, d + pos, 4);
        pos += 4;
        return v;
    }
};

// one serialized mini-burst trie: emit (suffix, id) per bucket entry
// in stream order.  Queue entries carry (depth, path) with the path
// packed MSB-first in 2-bit chars.  PW = seed_win_len / 2 (the tail
// holds PW+1-depth chars; <= 28 bits for PW <= 13).
struct QEnt { uint8_t flag; uint8_t depth; uint32_t path; };

template <int PW>
static bool walk_trie(Cursor& c, std::vector<uint32_t>& suf,
                      std::vector<uint32_t>& ids) {
    std::vector<QEnt> q;                 // FIFO via head index
    size_t head = 0;
    if (c.pos + 4 > c.n) return false;
    for (int i = 0; i < 4; ++i)
        q.push_back({c.d[c.pos + i], 1, (uint32_t)i});
    c.pos += 4;
    while (head < q.size()) {
        QEnt e = q[head++];
        if (e.flag == 0) continue;
        if (e.flag == 1) {
            if (c.pos + 4 > c.n) return false;
            for (int i = 0; i < 4; ++i)
                q.push_back({c.d[c.pos + i], (uint8_t)(e.depth + 1),
                             (e.path << 2) | (uint32_t)i});
            c.pos += 4;
        } else if (e.flag == 2) {
            uint32_t size = c.u32();
            if (!c.ok || c.pos + size > c.n || (size & 7)) return false;
            int s = PW + 1 - e.depth;    // tail chars (LSB-first)
            for (uint32_t k = 0; k < size; k += 8) {
                uint32_t tail, id;
                std::memcpy(&tail, c.d + c.pos + k, 4);
                std::memcpy(&id, c.d + c.pos + k + 4, 4);
                uint32_t out = e.path;
                for (int j = 0; j < s; ++j)
                    out = (out << 2) | ((tail >> (2 * j)) & 3);
                suf.push_back(out);
                ids.push_back(id);
            }
            c.pos += size;
        } else {
            return false;
        }
    }
    return true;
}

// Scan a whole .bursttrie_N.dat payload.  Outputs (caller-allocated,
// capacity cap = file_size/8 is a safe bound): F entries as packed
// (L+1)-mers (key << (2*PW+2) | suffix) + ids, R entries as packed
// (L+1)-mers (c0..c(2*PW) rebuilt from the reversed-suffix encoding)
// + ids, both in stream order (== the builder's insertion order).
// Writes the entry counts to counts2[2]; returns 0, or -1 on a
// malformed stream / capacity overflow.
template <int PW>
static int64_t scan_tries_impl(const uint8_t* data, int64_t n_bytes,
                               uint64_t* f19, uint32_t* fid,
                               int64_t capF,
                               uint64_t* r19, uint32_t* rid,
                               int64_t capR, int64_t* counts2) {
    constexpr int64_t HALF = 1ll << (2 * PW);
    Cursor c{data, n_bytes};
    std::vector<uint32_t> suf, ids;
    int64_t nF = 0, nR = 0;
    for (int64_t key = 0; key < HALF; ++key) {
        uint32_t szF = c.u32(), szR = c.u32();
        if (!c.ok) return -1;
        if (szF) {
            suf.clear(); ids.clear();
            if (!walk_trie<PW>(c, suf, ids)) return -1;
            if (nF + (int64_t)suf.size() > capF) return -1;
            for (size_t i = 0; i < suf.size(); ++i) {
                f19[nF] = ((uint64_t)key << (2 * PW + 2)) | suf[i];
                fid[nF] = ids[i];
                ++nF;
            }
        }
        if (szR) {
            suf.clear(); ids.clear();
            if (!walk_trie<PW>(c, suf, ids)) return -1;
            if (nR + (int64_t)suf.size() > capR) return -1;
            for (size_t i = 0; i < suf.size(); ++i) {
                // the R suffix holds c(PW)..c0 (MSB-first); rebuild
                // c0..c(PW) then append this key as the low 2*PW bits
                uint64_t s = suf[i], c_hi = 0;
                for (int k = 0; k < PW + 1; ++k) {
                    c_hi = (c_hi << 2) | (s & 3);
                    s >>= 2;
                }
                r19[nR] = (c_hi << (2 * PW)) | (uint64_t)key;
                rid[nR] = ids[i];
                ++nR;
            }
        }
    }
    counts2[0] = nF;
    counts2[1] = nR;
    return 0;
}

}  // namespace

extern "C" {

// pw = seed_win_len / 2 (the reference handles every even -L in 8..26)
int64_t reffmt_scan_tries(const uint8_t* data, int64_t n_bytes,
                          uint64_t* f19, uint32_t* fid, int64_t capF,
                          uint64_t* r19, uint32_t* rid, int64_t capR,
                          int64_t* counts2, int32_t pw) {
    switch (pw) {
    case 4:  return scan_tries_impl<4>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 5:  return scan_tries_impl<5>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 6:  return scan_tries_impl<6>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 7:  return scan_tries_impl<7>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 8:  return scan_tries_impl<8>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 9:  return scan_tries_impl<9>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 10: return scan_tries_impl<10>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 11: return scan_tries_impl<11>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 12: return scan_tries_impl<12>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    case 13: return scan_tries_impl<13>(data, n_bytes, f19, fid, capF, r19, rid, capR, counts2);
    default: return -1;
    }
}

// Scan a whole .pos_N.dat payload: uint32 n_ids, then per id uint32
// size + size x {uint32 pos, uint32 seq}.  Outputs sizes[n_ids] and
// the flattened pos/seq arrays (capacity cap_pairs).  Returns n_ids,
// or -1 on malformed input / overflow.
int64_t reffmt_scan_pos(const uint8_t* data, int64_t n_bytes,
                        int64_t n_ids_expect, uint32_t* sizes,
                        uint32_t* pos_out, uint32_t* seq_out,
                        int64_t cap_pairs) {
    Cursor c{data, n_bytes};
    uint32_t n_ids = c.u32();
    if (!c.ok || (int64_t)n_ids != n_ids_expect) return -1;
    int64_t total = 0;
    for (uint32_t i = 0; i < n_ids; ++i) {
        uint32_t sz = c.u32();
        if (!c.ok) return -1;
        if (c.pos + 8ll * sz > n_bytes || total + sz > cap_pairs)
            return -1;
        sizes[i] = sz;
        for (uint32_t k = 0; k < sz; ++k) {
            uint32_t p, s;
            std::memcpy(&p, c.d + c.pos, 4);
            std::memcpy(&s, c.d + c.pos + 4, 4);
            c.pos += 8;
            pos_out[total] = p;
            seq_out[total] = s;
            ++total;
        }
    }
    return (int64_t)n_ids;
}

}  // extern "C"
