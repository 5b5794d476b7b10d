"""Reference-compatible on-disk index artifacts.

The reference serializes each index part as four binary files
(indexdb.cpp:1939-2084, loaded by index.cpp:143-354):

* ``<pfx>.kmer_N.dat``     2^lnwin uint32 9-mer occurrence counts
* ``<pfx>.bursttrie_N.dat`` per 9-mer: two uint32 trie sizes, then the
  F and R mini-burst tries as a breadth-first stream -- per node four
  flag bytes; a flag-1 element emits its child's four flags inline, a
  flag-2 element emits uint32 bucket size + bucket payload.  Bucket
  entries are 8 bytes: uint32 tail (remaining chars, 2 bits each,
  LSB-first; indexdb.cpp:208-214) + uint32 id of the 18-mer
  (assigned by the CMPH hash in pass 2, indexdb.cpp:1627-1745).
* ``<pfx>.pos_N.dat``      uint32 n_ids, then per id uint32 size +
  size x {uint32 pos, uint32 seq}
* ``<pfx>.stats``          filesize, fasta name, background freqs,
  full_len, lnwin, numseq, part table, SAM @SQ list
  (indexdb.cpp:2025-2081)

``read_reference_index`` consumes a workdir indexed by the reference
binary and translates it into this package's dense flat-tensor layout
at load (reference ids are arbitrary CMPH values; they are remapped to
the sorted-18-mer ranks the dense tables require, which is behaviorally
neutral -- candidate ordering keys on (frequency, sequence number),
alignment.cpp:143-148).  ``write_reference_index`` produces the same
format from a fasta, replaying the reference's incremental-burst trie
insertion so the produced bytes match the real binary's output
bit-for-bit (see ``_build_trie``), giving round-trip coverage and
workdir portability in both directions.
"""

from __future__ import annotations

import os
import struct
from collections import deque
from typing import List, Tuple

import numpy as np

from .builder import (BuiltIndex, IndexPart, IndexStats, RefSeqMeta,
                      build_part, finish_part, scan_reference,
                      _part_boundaries)

_PW = 9                      # default seed length L=18 (pw = L/2);
                             # readers/writers parameterize over any
                             # even L in 8..26 like the reference


# ---------------------------------------------------------------------------
# .stats


def read_stats(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    o = 0

    def take(fmt):
        nonlocal o
        sz = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, data, o)
        o += sz
        return vals if len(vals) > 1 else vals[0]

    out = {}
    out["fasta_size"] = take("<Q")
    name_len = take("<I")
    out["fasta_path"] = data[o:o + name_len].split(b"\0")[0].decode()
    o += name_len
    out["background_freq"] = np.array(take("<4d"))
    out["full_len"] = take("<Q")
    out["lnwin"] = take("<I")
    out["numseq"] = take("<Q")
    n_parts = take("<H")
    parts = []
    for _ in range(n_parts):
        # index_parts_stats {ulong, ulong, uint32} padded to 24 bytes
        start_part, seq_part_size, numseq_part = \
            struct.unpack_from("<QQI", data, o)
        o += 24
        parts.append((start_part, seq_part_size, numseq_part))
    out["parts"] = parts
    n_sq = take("<I")
    sams = []
    for _ in range(n_sq):
        lid = take("<I")
        sid = data[o:o + lid].decode()
        o += lid
        slen = take("<I")
        sams.append(RefSeqMeta(sid, slen))
    out["sam_sq"] = sams
    return out


def write_stats(path: str, stats: IndexStats,
                parts: List[IndexPart]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", stats.fasta_size))
        name = stats.fasta_path.encode() + b"\0"
        f.write(struct.pack("<I", len(name)))
        f.write(name)
        f.write(struct.pack("<4d", *stats.background_freq))
        f.write(struct.pack("<Q", stats.full_len))
        f.write(struct.pack("<I", stats.seed_win_len))
        f.write(struct.pack("<Q", stats.numseq))
        f.write(struct.pack("<H", len(parts)))
        for p in parts:
            f.write(struct.pack("<QQI4x", p.start_part, p.seq_part_size,
                                p.numseq_part))
        f.write(struct.pack("<I", len(stats.sam_sq)))
        for m in stats.sam_sq:
            sid = m.header.encode()
            f.write(struct.pack("<I", len(sid)) + sid
                    + struct.pack("<I", m.length))


# ---------------------------------------------------------------------------
# burst-trie stream


def _walk_trie(data: bytes, pos: int) -> Tuple[list, int]:
    """Decode one serialized mini-burst trie starting at ``pos``.

    Returns ([(path_chars, tails_u32[k], ids_u32[k]), ...], new_pos) --
    one record per bucket, in breadth-first stream order (bucket entry
    order is the builder's insertion order, which the R-side 0-error
    representative semantics rely on; traverse_bursttrie.cpp:237-262).
    """
    flags = deque(data[pos:pos + 4])
    pos += 4
    paths = deque([(0,), (1,), (2,), (3,)])
    buckets = []
    while flags:
        flag = flags.popleft()
        path = paths.popleft()
        if flag == 0:
            continue
        if flag == 1:
            child = data[pos:pos + 4]
            pos += 4
            for c in range(4):
                flags.append(child[c])
                paths.append(path + (c,))
        elif flag == 2:
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4
            ent = np.frombuffer(data, np.uint32, size // 4,
                                pos).reshape(-1, 2)
            pos += size
            buckets.append((path, ent[:, 0], ent[:, 1]))
        else:
            raise ValueError(f"bad trie flag {flag}")
    return buckets, pos


def _decode_tails(path: Tuple[int, ...], tails: np.ndarray,
                  pw: int = _PW) -> np.ndarray:
    """Full (pw+1)-char suffix strings (MSB-first packed) from a
    bucket: path chars + LSB-first-packed stored tail."""
    depth = len(path)
    s = pw + 1 - depth
    out = np.zeros(len(tails), np.uint32)
    for c in path:
        out = (out << np.uint32(2)) | np.uint32(c)
    t = tails.astype(np.uint32)
    for k in range(s):
        out = (out << np.uint32(2)) | ((t >> np.uint32(2 * k))
                                       & np.uint32(3))
    return out


def _pack_entry_tails(suffix10: np.ndarray, depth: int,
                      pw: int = _PW) -> np.ndarray:
    """Inverse of _decode_tails for a depth-``depth`` bucket."""
    s = pw + 1 - depth
    out = np.zeros(len(suffix10), np.uint32)
    for k in range(s):
        ch = (suffix10 >> np.uint32(2 * (s - 1 - k))) & np.uint32(3)
        out |= ch << np.uint32(2 * k)
    return out


# ---------------------------------------------------------------------------
# reader


def _scan_trie_file(path: str, pw: int = _PW):
    """(f19, fid, r19, rid) entry arrays in stream order -- C++ scanner
    (native/refload.cpp, ~100x the Python walk) with the Python decoder
    as the compiler-less fallback."""
    from .. import native
    lib = native.get_lib()
    if lib is not None:
        tarr = np.fromfile(path, np.uint8)
        cap = len(tarr) // 8 + 16
        f19 = np.empty(cap, np.uint64)
        fid = np.empty(cap, np.uint32)
        r19 = np.empty(cap, np.uint64)
        rid = np.empty(cap, np.uint32)
        cnts = np.zeros(2, np.int64)
        rc = lib.reffmt_scan_tries(
            tarr.ctypes.data, len(tarr),
            f19.ctypes.data, fid.ctypes.data, cap,
            r19.ctypes.data, rid.ctypes.data, cap, cnts.ctypes.data,
            pw)
        if rc != 0:
            raise ValueError(f"malformed bursttrie stream: {path}")
        nF, nR = int(cnts[0]), int(cnts[1])
        return (f19[:nF].copy(), fid[:nF].copy(),
                r19[:nR].copy(), rid[:nR].copy())

    with open(path, "rb") as f:
        tdata = f.read()
    pos = 0
    f19_list, fid_list, r19_list, rid_list = [], [], [], []
    for key in range(1 << (2 * pw)):
        szF, szR = struct.unpack_from("<II", tdata, pos)
        pos += 8
        if szF:
            buckets, pos = _walk_trie(tdata, pos)
            for path_, tails, ids in buckets:
                suf = _decode_tails(path_, tails, pw)
                k19 = (np.uint64(key) << np.uint64(2 * pw + 2)) \
                    | suf.astype(np.uint64)
                f19_list.append(k19)
                fid_list.append(ids)
        if szR:
            buckets, pos = _walk_trie(tdata, pos)
            for path_, tails, ids in buckets:
                # R strings are c(pw)..c0; rebuild c0..c(pw) with this
                # key as the low 2*pw bits
                suf = _decode_tails(path_, tails, pw).astype(np.uint64)
                c_hi = np.zeros(len(suf), np.uint64)   # MSB-first
                for k in range(pw + 1):
                    c_hi = (c_hi << np.uint64(2)) \
                        | ((suf >> np.uint64(2 * k)) & np.uint64(3))
                k19 = (c_hi << np.uint64(2 * pw)) | np.uint64(key)
                r19_list.append(k19)
                rid_list.append(ids)

    def cat(lst, dt):
        return np.concatenate(lst) if lst else np.zeros(0, dt)

    return (cat(f19_list, np.uint64), cat(fid_list, np.uint32),
            cat(r19_list, np.uint64), cat(rid_list, np.uint32))


def _scan_pos_file(path: str):
    """(n_ids, sizes, pos_flat, seq_flat) -- C++ scanner with Python
    fallback; flat arrays are in reference-id record order."""
    from .. import native
    lib = native.get_lib()
    with open(path, "rb") as f:
        head = f.read(4)
    (n_ids,) = struct.unpack("<I", head)
    if lib is not None:
        parr = np.fromfile(path, np.uint8)
        cap = (len(parr) - 4) // 8
        sizes = np.zeros(n_ids, np.uint32)
        pos_flat = np.empty(cap, np.uint32)
        seq_flat = np.empty(cap, np.uint32)
        rc = lib.reffmt_scan_pos(
            parr.ctypes.data, len(parr), n_ids, sizes.ctypes.data,
            pos_flat.ctypes.data, seq_flat.ctypes.data, cap)
        if rc != n_ids:
            raise ValueError(f"malformed pos stream: {path}")
        total = int(sizes.astype(np.int64).sum())
        return (n_ids, sizes.astype(np.int64),
                pos_flat[:total].copy(), seq_flat[:total].copy())

    with open(path, "rb") as f:
        pdata = f.read()
    sizes = np.zeros(n_ids, np.int64)
    pos_l, seq_l = [], []
    o = 4
    for i in range(n_ids):
        (sz,) = struct.unpack_from("<I", pdata, o)
        o += 4
        sizes[i] = sz
        pair = np.frombuffer(pdata, np.uint32, 2 * sz, o).reshape(-1, 2)
        o += 8 * sz
        pos_l.append(pair[:, 0])
        seq_l.append(pair[:, 1])
    pos_flat = np.concatenate(pos_l) if pos_l else np.zeros(0, np.uint32)
    seq_flat = np.concatenate(seq_l) if seq_l else np.zeros(0, np.uint32)
    return n_ids, sizes, pos_flat, seq_flat


def read_part(prefix: str, part_num: int, pw: int = _PW) -> dict:
    """One part's core arrays (builder.build_part output shape) from the
    reference's .kmer/.bursttrie/.pos files."""
    counts = np.fromfile(f"{prefix}.kmer_{part_num}.dat", np.uint32,
                         1 << (2 * pw))
    f19, fid, r19, rid = _scan_trie_file(
        f"{prefix}.bursttrie_{part_num}.dat", pw)
    # R entries append in stream order, so their scan ranks are 0..nR-1
    rscan = np.arange(len(r19), dtype=np.int64)
    n_ids, sizes, pos_flat, seq_flat = _scan_pos_file(
        f"{prefix}.pos_{part_num}.dat")

    # ---- remap arbitrary CMPH ids -> sorted-L-mer ranks
    order_f = np.argsort(f19, kind="stable")
    uk19 = f19[order_f]
    uk19_ids_ref = fid[order_f]
    kmer18 = (uk19 >> np.uint64(2))
    uniq18, first = np.unique(kmer18, return_index=True)
    if len(uniq18) != n_ids:
        raise ValueError(
            f"index inconsistent: {len(uniq18)} unique 18-mers vs "
            f"{n_ids} position ids")
    ref_id_of_rank = uk19_ids_ref[first]      # rank -> reference id
    rank_of_ref = np.zeros(n_ids, np.int64)
    rank_of_ref[ref_id_of_rank] = np.arange(n_ids)

    # reorder the flat position lists from reference-id record order
    # into rank order, fully vectorized (one gather)
    rec_off = np.zeros(n_ids + 1, np.int64)
    np.cumsum(sizes, out=rec_off[1:])
    cnt = sizes[ref_id_of_rank]
    pos_offsets = np.zeros(n_ids + 1, np.int64)
    np.cumsum(cnt, out=pos_offsets[1:])
    total = int(pos_offsets[-1])
    if total:
        within = (np.arange(total, dtype=np.int64)
                  - np.repeat(pos_offsets[:-1], cnt))
        idx = np.repeat(rec_off[:-1][ref_id_of_rank], cnt) + within
        pos_pos = pos_flat[idx]
        pos_seq = seq_flat[idx]
    else:
        pos_pos = np.zeros(0, np.uint32)
        pos_seq = np.zeros(0, np.uint32)

    # R entries sorted by (prefix c2..cL, c1, id) like build_part
    mask_rkey = np.uint64((1 << (4 * pw)) - 1)
    mask_rpref = np.uint64((1 << (4 * pw - 2)) - 1)
    r_rkey = r19 & mask_rkey
    r_rank = rank_of_ref[rid.astype(np.int64)].astype(np.uint32)
    r_sortkey = ((r_rkey & mask_rpref) << np.uint64(2)) \
        | (r_rkey >> np.uint64(4 * pw - 2))
    r_order = np.lexsort((r_rank, r_sortkey))

    return dict(
        kmers18=uniq18,
        pos_offsets=pos_offsets,
        pos_seq=pos_seq,
        pos_pos=pos_pos,
        kmer_counts=counts,
        uk19=uk19,
        uk19_ids=rank_of_ref[uk19_ids_ref.astype(np.int64)].astype(
            np.uint32),
        r_rkey_sorted=r_rkey[r_order],
        r_ids=r_rank[r_order],
        r_scan_sorted=rscan[r_order],
        pw=pw,
    )


def read_reference_index(prefix: str) -> BuiltIndex:
    """A BuiltIndex from a workdir indexed in the reference's format."""
    meta = read_stats(prefix + ".stats")
    lnwin = int(meta["lnwin"])
    if lnwin % 2 or not (8 <= lnwin <= 26):
        raise ValueError(
            f"unsupported seed length {lnwin} in {prefix}.stats "
            "(even 8..26, options.cpp opt_L)")
    pw = lnwin // 2
    stats = IndexStats(
        fasta_path=meta["fasta_path"],
        fasta_size=meta["fasta_size"],
        background_freq=meta["background_freq"],
        full_len=meta["full_len"],
        seed_win_len=meta["lnwin"],
        numseq=int(meta["numseq"]),
        sam_sq=meta["sam_sq"],
    )
    parts: List[IndexPart] = []
    first_seq = 0
    for pn, (start_part, seq_part_size, numseq_part) in \
            enumerate(meta["parts"]):
        part = finish_part(read_part(prefix, pn, pw))
        part.start_part = int(start_part)
        part.seq_part_size = int(seq_part_size)
        part.numseq_part = int(numseq_part)
        part.first_seq = first_seq
        first_seq += int(numseq_part)
        parts.append(part)
    return BuiltIndex(stats=stats, parts=parts)


# ---------------------------------------------------------------------------
# writer


def write_reference_index(fasta_path: str, prefix: str,
                          interval: int = 1, max_pos: int = 10000,
                          max_file_size_mb: float = 3072.0,
                          seed_win_len: int = 2 * _PW) -> None:
    """Index ``fasta_path`` and serialize it in the reference's on-disk
    format under ``prefix`` (drop-in for a reference workdir).

    Tries are grown by replaying the reference's incremental-burst
    insertion (``_build_trie``: insertion-order buckets bursting into
    child nodes at THRESHOLD, indexdb.cpp:222-301), and ids are
    assigned CMPH-CHM first-occurrence order -- the produced bytes
    match the reference's own ``build_index`` output bit-for-bit
    (tests/test_refformat.py vs the compiled tools/refindexer
    fixtures)."""
    if seed_win_len % 2 or not (8 <= seed_win_len <= 26):
        raise ValueError("seed_win_len must be an even integer in 8..26")
    pw = seed_win_len // 2
    metas, bg, full_len, spans, enc_seqs = scan_reference(fasta_path)
    groups = _part_boundaries([m.length for m in metas],
                              max_file_size_mb)
    stats = IndexStats(
        fasta_path=str(fasta_path),
        fasta_size=os.path.getsize(fasta_path),
        background_freq=bg / bg.sum(),
        full_len=full_len,
        seed_win_len=seed_win_len,
        numseq=len(metas),
        sam_sq=metas,
    )
    parts_meta: List[IndexPart] = []
    for pn, group in enumerate(groups):
        core = build_part([enc_seqs[i] for i in group], interval,
                          max_pos, pw=pw)
        core["kmer_counts"].astype(np.uint32).tofile(
            f"{prefix}.kmer_{pn}.dat")

        # The reference's ids are CMPH CHM values over a keys file that
        # appends each unique 18-mer at FIRST OCCURRENCE during the
        # reference scan (indexdb.cpp:1504, get_keys_file) -- CHM is
        # order-preserving, so id == first-occurrence rank.  Reproduce
        # that id space (byte parity with the real binary's artifacts,
        # verified against a refindexer-produced fixture in
        # tests/golden/refidx).
        n_ids = len(core["kmers18"])
        po = core["pos_offsets"]
        first_seq = core["pos_seq"][po[:-1]]
        first_pos = core["pos_pos"][po[:-1]]
        scan2rank = np.lexsort((first_pos, first_seq))  # refid -> rank
        refid_of_rank = np.empty(n_ids, np.int64)
        refid_of_rank[scan2rank] = np.arange(n_ids)

        # per-refid positions (each list stays in scan order)
        with open(f"{prefix}.pos_{pn}.dat", "wb") as f:
            f.write(struct.pack("<I", n_ids))
            for i in range(n_ids):
                rank = int(scan2rank[i])
                lo, hi = int(po[rank]), int(po[rank + 1])
                f.write(struct.pack("<I", hi - lo))
                pair = np.empty((hi - lo, 2), np.uint32)
                pair[:, 0] = core["pos_pos"][lo:hi]
                pair[:, 1] = core["pos_seq"][lo:hi]
                f.write(pair.tobytes())

        uk19 = core["uk19"]
        uids = refid_of_rank[core["uk19_ids"].astype(np.int64)].astype(
            np.uint32)
        half = 1 << (2 * pw)
        keyf = (uk19 >> np.uint64(2 * pw + 2)).astype(np.int64)
        keyr = (uk19 & np.uint64((1 << (2 * pw)) - 1)).astype(np.int64)
        # group indices per key; BOTH trie sides insert at the 19-mer's
        # first scan occurrence, so bucket entry order is scan order
        # within each key (it also carries the R-side 0-error
        # representative semantics, traverse_bursttrie.cpp:237-262)
        scan_order = np.argsort(core["uk19_first"], kind="stable")
        orderF = scan_order[np.argsort(keyf[scan_order], kind="stable")]
        fb = np.searchsorted(keyf[orderF], np.arange(half + 1))
        orderR = scan_order[np.argsort(keyr[scan_order], kind="stable")]
        rb = np.searchsorted(keyr[orderR], np.arange(half + 1))
        with open(f"{prefix}.bursttrie_{pn}.dat", "wb") as f:
            for key in range(half):
                selF = orderF[fb[key]:fb[key + 1]]
                selR = orderR[rb[key]:rb[key + 1]]
                root_f = _build_root(uk19[selF], uids[selF],
                                     reverse=False, pw=pw) \
                    if len(selF) else None
                root_r = _build_root(uk19[selR], uids[selR],
                                     reverse=True, pw=pw) \
                    if len(selR) else None
                f.write(struct.pack("<II", _trie_size(root_f),
                                    _trie_size(root_r)))
                if root_f is not None:
                    f.write(_serialize_trie(root_f))
                if root_r is not None:
                    f.write(_serialize_trie(root_r))

        part = finish_part(core)
        part.start_part = spans[group[0]][0]
        part.seq_part_size = spans[group[-1]][1] - spans[group[0]][0]
        part.numseq_part = len(group)
        part.first_seq = group[0]
        parts_meta.append(part)
    write_stats(prefix + ".stats", stats, parts_meta)


def _trie_size(root: list) -> int:
    """The reference's size field: 4*sizeof(NodeElement)=64 bytes per
    trie NODE plus the raw bucket payload bytes (indexdb.cpp:740 --
    per-bucket u32 length fields and flag bytes are NOT counted; the
    field sizes the in-memory trie, not the stream)."""
    if root is None:
        return 0
    n_nodes, bucket_bytes = _trie_stats(root)
    return 64 * n_nodes + bucket_bytes


def _trie_stats(node: list) -> Tuple[int, int]:
    n_nodes, bucket_bytes = 1, 0
    for el in node:
        if el[0] == 1:
            n, b = _trie_stats(el[1])
            n_nodes += n
            bucket_bytes += b
        elif el[0] == 2:
            bucket_bytes += 8 * len(el[1])
    return n_nodes, bucket_bytes


# bucket burst parameters (indexdb.hpp:57-60, insert_prefix burst rule:
# burst while depth < pread - partialwin - 3 = pw - 2 and
# size > THRESHOLD)
_THRESHOLD = 128


def _build_trie(tails0: np.ndarray, top: np.ndarray,
                ids: np.ndarray, pw: int = _PW) -> list:
    """Faithful replay of the reference's incremental insert_prefix
    (indexdb.cpp:147-310): entries insert one at a time in scan order;
    a bucket whose size exceeds THRESHOLD *on an insert* (and depth <
    pread-partialwin-3) bursts into four children, and the
    redistribution does NOT re-check the threshold -- so a child handed
    >16 entries at burst time legitimately stays a fat bucket until a
    later insert lands on it.  (A top-down "burst iff count > 16" build
    produces a different -- deeper -- shape; byte parity with the real
    binary's artifacts requires the replay.)

    Node: list of 4 elements; element = [flag, payload] with payload a
    list of (tail_lsb_first, id) for flag 2 or a child node for flag 1.
    """
    root = [[0, None] for _ in range(4)]
    max_d = (2 * pw + 1) - pw - 3      # pread - partialwin - 3
    for t, c, i in zip(tails0.tolist(), top.tolist(), ids.tolist()):
        node = root
        depth = 1
        while True:
            el = node[c]
            if el[0] == 1:
                node = el[1]
                c = t & 3
                t >>= 2
                depth += 1
                continue
            break
        if el[0] == 0:
            el[0] = 2
            el[1] = []
        el[1].append((t, i))
        if depth < max_d and len(el[1]) * 8 > _THRESHOLD:
            child = [[0, None] for _ in range(4)]
            for t2, i2 in el[1]:
                cel = child[t2 & 3]
                if cel[0] == 0:
                    cel[0] = 2
                    cel[1] = []
                cel[1].append((t2 >> 2, i2))
            el[0] = 1
            el[1] = child
    return root


def _serialize_trie(root: list) -> bytes:
    """Breadth-first stream exactly as the reference loader consumes it
    (index.cpp:164-316): root's four flags, then per element in BFS
    order -- flag 1 emits its child's four flags inline, flag 2 emits
    uint32 size + bucket payload."""
    out = [bytes(el[0] for el in root)]
    queue = deque([root])
    while queue:
        node = queue.popleft()
        for el in node:
            if el[0] == 1:
                out.append(bytes(c[0] for c in el[1]))
                queue.append(el[1])
            elif el[0] == 2:
                ent = np.asarray(el[1], np.uint32)
                out.append(struct.pack("<I", ent.nbytes))
                out.append(ent.tobytes())
    return b"".join(out)


def _build_root(entries19: np.ndarray, ids: np.ndarray,
                reverse: bool, pw: int = _PW) -> list:
    """In-memory mini-burst trie for one key; entry (insertion) order
    preserved (it carries the 0-error representative semantics)."""
    if reverse:
        suf = np.zeros(len(entries19), np.uint32)
        for k in range(pw + 1):
            suf = (suf << np.uint32(2)) | (
                (entries19 >> np.uint64(2 * pw + 2 * k))
                & np.uint64(3)).astype(np.uint32)
    else:
        suf = (entries19
               & np.uint64((1 << (2 * pw + 2)) - 1)).astype(np.uint32)
    top = (suf >> np.uint32(2 * pw)) & np.uint32(3)  # first suffix char
    tails0 = _pack_entry_tails(
        suf & np.uint32((1 << (2 * pw)) - 1), 1, pw)
    return _build_trie(tails0, top, ids.astype(np.uint32), pw)
