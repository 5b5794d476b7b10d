"""Dense flat-tensor k-mer index builder (host side, numpy).

This replaces the reference's burst-trie index (indexdb.cpp:1119-2094) with a
TPU-friendly layout.  The *semantics* indexed are identical; the *layout* is
redesigned for O(1) bounded-gather lookups on device instead of
pointer-chasing trie traversal.

Reference semantics being reproduced
------------------------------------
For every 19-mer window ``c0..c18`` placed at stride ``interval`` on every
reference sequence of a part (indexdb.cpp:1460-1542):

* the *forward* trie maps 9-mer prefix ``c0..c8`` -> 10-char tail
  ``c9..c18``;  seed search consumes only the first 9 tail chars, i.e. the
  18-mer ``c0..c17`` (traverse_bursttrie.cpp:184 ``s = partialwin - depth``).
* the *reverse* trie maps 9-mer suffix ``c10..c18`` -> reversed 10-char tail
  ``c9..c0``; search consumes ``c9..c1``, i.e. the 18 chars ``c1..c18``.
* a *unique 18-mer* ``c0..c17`` gets one id; a positions table records up to
  ``max_pos`` (seq, window-start) occurrences per id (indexdb.cpp:318-349).
  Both trie senses carry the id of 18-mer ``c0..c17`` (indexdb.cpp:1720-1723).
* a 2^18 table counts 9-mer occurrences with the "incremented-by-forward"
  rule (indexdb.cpp:1466-1472).

Dense layout produced here (per index part)
-------------------------------------------
ids are assigned by ascending packed 18-mer value (the reference's CMPH CHM
hash assigns arbitrary ids; id order is behaviorally neutral -- candidate
ordering uses (frequency, reference number), alignment.cpp:143-148).

* ``kmers18``       uint64[n]   sorted packed 18-mers (c0 most significant);
                                index == id.
* ``pos_offsets``   int64[n+1]  CSR offsets into the positions arrays.
* ``pos_seq``       uint32[P]   sequence ordinal within the part.
* ``pos_pos``       uint32[P]   window start position on the sequence.
* ``kmer_counts``   uint32[2^18] 9-mer occurrence counts.
* F-side acceptance tables (subsearch 1a, paralleltraversal.cpp:163-185):
    - exact:   hash  (18-mer key)        -> id
    - prefix:  hash  (17-mer key c0..c16)-> (start,count) range of ids
      (ids are contiguous per 17-mer prefix because ids are sorted).
* R-side acceptance tables (subsearch 1b, paralleltraversal.cpp:217-238):
  R entries correspond to unique 19-mers; entry key packs ``c1..c18`` with
  c1 most significant so that the 17-char search prefix ``c2..c18`` is the
  low 34 bits:  rkey = pack(c1..c18); rprefix = rkey & (4^17-1).
    - ``r_ids``  uint32[m]  ids sorted by (rkey, id)
    - exact:   hash (rkey 36 bits)  -> (start,count) into r_ids  (<=4)
    - prefix:  hash (rprefix 34 bits)-> (start,count) into r_ids (<=16)

Hash tables are open-addressing with linear probing (see hashtab.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..constants import MAP_NT, SEED_WIN_LEN
from ..io.fastx import iter_fastx
from .hashtab import build_hash_u64


@dataclass
class RefSeqMeta:
    header: str       # header without '>' as stored for SAM @SQ (first token)
    length: int


@dataclass
class IndexPart:
    """Flat tensors for one index part."""
    # id space
    kmers18: np.ndarray        # uint64[n], sorted
    pos_offsets: np.ndarray    # int64[n+1]
    pos_seq: np.ndarray        # uint32[P]
    pos_pos: np.ndarray        # uint32[P]
    kmer_counts: np.ndarray    # uint32[2^18]
    # F acceptance
    f_exact_keys: np.ndarray   # uint64[HF]
    f_exact_vals: np.ndarray   # uint32[HF] (id)
    f_pref_keys: np.ndarray    # uint64[HFP]
    f_pref_start: np.ndarray   # uint32[HFP]
    f_pref_count: np.ndarray   # uint32[HFP]
    # R acceptance
    r_ids: np.ndarray          # uint32[m]
    r_exact_keys: np.ndarray   # uint64[HR]
    r_exact_start: np.ndarray  # uint32[HR]
    r_exact_count: np.ndarray  # uint32[HR]
    r_exact_zero: np.ndarray   # uint32[HR]  0-error representative id
    r_pref_keys: np.ndarray    # uint64[HRP]
    r_pref_start: np.ndarray   # uint32[HRP]
    r_pref_count: np.ndarray   # uint32[HRP]
    # 19-mer membership (insertion-case probes)
    k19_keys: np.ndarray       # uint64[HK]
    k19_vals: np.ndarray       # uint32[HK] (id of the 18-mer prefix)
    # bucket-scan tables (unique 19-mers per 9-mer half key)
    f19_offsets: np.ndarray    # uint32[2^18+1]
    f19_tails: np.ndarray      # uint32[n19] packed c9..c18 (20 bits)
    f19_ids: np.ndarray        # uint32[n19]
    r19_offsets: np.ndarray    # uint32[2^18+1]
    r19_tails: np.ndarray      # uint32[n19] packed (c9..c1)<<2 | c0
    r19_ids: np.ndarray        # uint32[n19]
    # part metadata (index_parts_stats, indexdb.hpp:108)
    start_part: int = 0        # byte offset of first sequence of the part
    seq_part_size: int = 0     # bytes of raw reference in the part
    numseq_part: int = 0       # number of sequences in the part
    first_seq: int = 0         # global ordinal of the part's first sequence
    seed_win_len: int = 18     # L; all bit-widths derive from pw = L/2

    @property
    def num_ids(self) -> int:
        return int(self.kmers18.shape[0])


@dataclass
class IndexStats:
    """Equivalent of the '.stats' artifact (indexdb.cpp:2025-2081)."""
    fasta_path: str
    fasta_size: int
    background_freq: np.ndarray     # float64[4], normalized
    full_len: int                   # total reference length
    seed_win_len: int
    numseq: int
    sam_sq: List[RefSeqMeta] = field(default_factory=list)


@dataclass
class BuiltIndex:
    stats: IndexStats
    parts: List[IndexPart]


def encode_seq_index(seq: str) -> np.ndarray:
    """Encode with the index-builder alphabet (MAP_NT, indexdb.cpp:83)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return MAP_NT[raw]


def pack_2bit(enc: np.ndarray, starts: np.ndarray, length: int,
              step: int = 1) -> np.ndarray:
    """Pack ``length`` chars beginning at each start (MSB first) -> uint64.

    ``step`` may be -1 to pack walking backwards (used for the R sense).
    """
    out = np.zeros(starts.shape, dtype=np.uint64)
    idx = starts.astype(np.int64)
    for k in range(length):
        out = (out << np.uint64(2)) | enc[idx + k * step].astype(np.uint64)
    return out


def _estimated_seq_mem_mb(seq_len: int, pread: int) -> float:
    """Memory estimate per sequence driving part splits (indexdb.cpp:1384)."""
    return (seq_len - pread + 1) * 9.5e-6


def scan_reference(fasta_path: str, pread: int = 19):
    """Pass 0: headers, lengths, background freqs (indexdb.cpp:1186-1263).

    Returns (seq_metas, background_counts[4], full_len, seq_byte_spans,
    sequences-as-encoded-arrays).  Sequences shorter than 19 nt are an error
    (indexdb.cpp:1254-1260).
    """
    metas: List[RefSeqMeta] = []
    bg = np.zeros(4, dtype=np.float64)
    full_len = 0
    enc_seqs: List[np.ndarray] = []
    spans: List[Tuple[int, int]] = []   # (start_byte, end_byte) per sequence

    # We need byte offsets of each record for part metadata; read raw.
    with open(fasta_path, "rb") as f:
        data = f.read()
    if not data.startswith(b">"):
        raise ValueError(
            "Each read header of the database fasta file must begin with '>'")
    # find record starts
    starts = [0]
    pos = data.find(b"\n>")
    while pos != -1:
        starts.append(pos + 1)
        pos = data.find(b"\n>", pos + 1)
    starts.append(len(data))

    for i in range(len(starts) - 1):
        s, e = starts[i], starts[i + 1]
        rec = data[s:e]
        nl = rec.find(b"\n")
        header_full = rec[1:nl].decode("ascii", "replace")
        # SAM @SQ keeps header up to first space/tab (indexdb.cpp:1224-1233)
        header = header_full.split(" ")[0].split("\t")[0]
        seq_bytes = rec[nl + 1:].replace(b"\n", b"").replace(b"\r", b"") \
                                .replace(b" ", b"")
        seq_len = len(seq_bytes)
        if seq_len < pread:
            raise ValueError(
                f"At least one of your sequences is shorter than the seed "
                f"length {pread}, please filter out all sequences shorter "
                f"than {pread} to continue index construction.")
        raw = np.frombuffer(seq_bytes, dtype=np.uint8)
        # background freq counts every non-'N' char via map_nt
        # (indexdb.cpp:1241-1244)
        non_n = raw[raw != ord("N")]
        np.add.at(bg, MAP_NT[non_n].astype(np.int64), 1.0)
        metas.append(RefSeqMeta(header, seq_len))
        enc_seqs.append(MAP_NT[raw])
        spans.append((s, e))
        full_len += seq_len

    return metas, bg, full_len, spans, enc_seqs


def _part_boundaries(seq_lens: List[int], max_file_size_mb: float,
                     pread: int = 19) -> List[List[int]]:
    """Split sequences into parts by the memory-budget rule
    (indexdb.cpp:1384-1426).  Sequences too large on their own are skipped
    with a warning.  Returns a list of lists of sequence ordinals."""
    parts: List[List[int]] = []
    cur: List[int] = []
    size = 0.0
    for i, ln in enumerate(seq_lens):
        est = _estimated_seq_mem_mb(ln, pread)
        if est > max_file_size_mb:
            import sys
            print(f"  WARNING: the index for sequence #{i} will not fit into "
                  f"{max_file_size_mb} Mbytes memory, it will be skipped.",
                  file=sys.stderr)
            continue
        if size + est > max_file_size_mb and cur:
            parts.append(cur)
            cur = []
            size = 0.0
        cur.append(i)
        size += est
    if cur:
        parts.append(cur)
    return parts


def build_part(enc_seqs: List[np.ndarray], interval: int, max_pos: int,
               pw: int = 9) -> dict:
    """Core numpy pass over one part's sequences.

    Produces the sorted unique-L-mer id space, positions CSR, half-mer
    counts and the F/R acceptance source arrays.  ``pw`` = L/2; window
    char indices below are written for the default L=18 (c0..c18) but
    all widths derive from pw.
    """
    pread = 2 * pw + 1
    half_space = 1 << (2 * pw)
    mask_half = np.uint64((1 << (2 * pw)) - 1)
    mask_rkey = np.uint64((1 << (4 * pw)) - 1)          # c1..c18
    mask_rpref = np.uint64((1 << (4 * pw - 2)) - 1)     # c2..c18
    win_k19 = []        # packed c0..c18 (2L+2 bits) per window
    win_seq = []
    win_pos = []

    for si, enc in enumerate(enc_seqs):
        L = len(enc)
        numwin = (L - pread + interval) // interval
        starts = (np.arange(numwin, dtype=np.int64) * interval)
        win_k19.append(pack_2bit(enc, starts, pread))
        win_seq.append(np.full(numwin, si, dtype=np.uint32))
        win_pos.append(starts.astype(np.uint32))

    k19_all = np.concatenate(win_k19)
    seq_all = np.concatenate(win_seq)
    pos_all = np.concatenate(win_pos)
    # derived packings: 18-mer = c0..c17, rkey = c1..c18, 9-mer halves
    kmer18 = k19_all >> np.uint64(2)
    rkey_all = k19_all & mask_rkey
    keyf_all = (kmer18 >> np.uint64(2 * pw)).astype(np.uint32)   # c0..c8
    keyr_all = (k19_all & mask_half).astype(np.uint32)           # c10..c18

    # ---- unique 18-mer ids (sorted ascending), positions CSR -------------
    order = np.argsort(kmer18, kind="stable")   # stable = scan order per kmer
    k_sorted = kmer18[order]
    uniq, first_idx, counts = np.unique(
        k_sorted, return_index=True, return_counts=True)
    n = uniq.shape[0]

    # positions per id, capped at max_pos keeping scan order
    # (add_kmer_to_table, indexdb.cpp:318-349)
    capped = counts if max_pos == 0 else np.minimum(counts, max_pos)
    pos_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(capped, out=pos_offsets[1:])
    total_pos = int(pos_offsets[-1])
    # within-group offsets without a Python loop
    within = np.arange(total_pos, dtype=np.int64) - np.repeat(
        pos_offsets[:-1], capped)
    take = np.repeat(first_idx.astype(np.int64), capped) + within
    sel = order[take]
    pos_seq = seq_all[sel].astype(np.uint32)
    pos_pos = pos_all[sel].astype(np.uint32)

    # ---- 9-mer counts with incremented-by-forward rule -------------------
    # (indexdb.cpp:1466-1472): count[key_f]++ always; count[key_r]++ only
    # while key_r has not yet occurred as a key_f earlier in the part scan.
    counts9 = np.zeros(half_space, dtype=np.int64)
    np.add.at(counts9, keyf_all.astype(np.int64), 1)
    first_f = np.full(half_space, np.iinfo(np.int64).max, dtype=np.int64)
    scan_idx = np.arange(keyf_all.shape[0], dtype=np.int64)
    np.minimum.at(first_f, keyf_all.astype(np.int64), scan_idx)
    r_before = scan_idx < first_f[keyr_all.astype(np.int64)]
    np.add.at(counts9, keyr_all[r_before].astype(np.int64), 1)
    kmer_counts = counts9.astype(np.uint32)

    # ---- unique 19-mers: R entries and the 19-mer membership table -------
    # Each unique 19-mer contributes one R-trie entry (keyed c1..c18) and
    # one 19-mer membership record (for the insertion-case probes).  The
    # first-occurrence scan index reproduces trie bucket insertion order,
    # needed for the reverse-sense 0-error representative
    # (traverse_bursttrie.cpp:237-262: the first entry reaching the 0-error
    # state wins and clears all other hits).
    uk19, first19 = np.unique(k19_all, return_index=True)
    ids_per_uk19 = np.searchsorted(uniq, uk19 >> np.uint64(2)).astype(np.uint32)

    r_entry_rkey = uk19 & mask_rkey
    r_entry_id = ids_per_uk19
    r_entry_scan = first19.astype(np.int64)
    # Sort R entries so BOTH the 18-char exact groups (c1..c18) and the
    # 17-char prefix groups (c2..c18) are contiguous: order by
    # (prefix, c1, id).  rkey packs c1 as the most significant char, so
    # prefix = rkey & MASK34 and c1 = rkey >> 34.
    r_sortkey = ((r_entry_rkey & mask_rpref) << np.uint64(2)) \
        | (r_entry_rkey >> np.uint64(4 * pw - 2))
    r_order = np.lexsort((r_entry_id, r_sortkey))

    return dict(
        kmers18=uniq,
        pos_offsets=pos_offsets,
        pos_seq=pos_seq,
        pos_pos=pos_pos,
        kmer_counts=kmer_counts,
        uk19=uk19,
        uk19_ids=ids_per_uk19,
        uk19_first=first19.astype(np.int64),   # first-occurrence scan idx
        r_rkey_sorted=r_entry_rkey[r_order],
        r_ids=r_entry_id[r_order].astype(np.uint32),
        r_scan_sorted=r_entry_scan[r_order],
        pw=pw,
    )


def _ranges_from_sorted(keys_sorted: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group a sorted key array -> (unique_keys, start, count)."""
    uniq, start, count = np.unique(
        keys_sorted, return_index=True, return_counts=True)
    return uniq, start.astype(np.uint32), count.astype(np.uint32)


def finish_part(core: dict) -> IndexPart:
    """Build the device hash tables from the core arrays."""
    kmers18 = core["kmers18"]
    n = kmers18.shape[0]
    pw = core.get("pw", 9)
    half_space = 1 << (2 * pw)
    mask_rpref = np.uint64((1 << (4 * pw - 2)) - 1)

    # F exact: 18-mer -> id (== rank)
    f_exact_keys, f_exact_vals = build_hash_u64(
        kmers18, np.arange(n, dtype=np.uint32))

    # F prefix: 17-mer (c0..c16) = kmer18 >> 2 -> contiguous id range
    fp, fp_start, fp_count = _ranges_from_sorted(kmers18 >> np.uint64(2))
    f_pref_keys, f_pref_vals = build_hash_u64(
        fp, np.stack([fp_start, fp_count], axis=1))

    # R entries arrive sorted by (prefix c2..c18, c1, id): both the exact
    # (c1..c18) groups and the prefix (c2..c18) groups are contiguous.
    r_rkey_sorted = core["r_rkey_sorted"]

    # R exact: rkey (c1..c18) -> range into r_ids.  np.unique would re-sort,
    # so group manually on the already-grouped array.
    change = np.ones(r_rkey_sorted.shape[0], dtype=bool)
    if r_rkey_sorted.shape[0]:
        change[1:] = r_rkey_sorted[1:] != r_rkey_sorted[:-1]
    rk_start = np.flatnonzero(change).astype(np.uint32)
    rk = r_rkey_sorted[rk_start.astype(np.int64)]
    rk_count = np.diff(
        np.append(rk_start, r_rkey_sorted.shape[0])).astype(np.uint32)
    # 0-error representative per exact group: member with min scan index
    # (reproduces trie bucket insertion order, see build_part).
    r_scan = core["r_scan_sorted"]
    group_of = np.repeat(np.arange(rk.shape[0]), rk_count.astype(np.int64))
    zero_rep = np.zeros(rk.shape[0], dtype=np.uint32)
    if rk.shape[0]:
        best_scan = np.full(rk.shape[0], np.iinfo(np.int64).max, np.int64)
        np.minimum.at(best_scan, group_of, r_scan)
        is_best = r_scan == best_scan[group_of]
        # first 'best' member per group wins
        first_best = np.zeros(rk.shape[0], dtype=np.int64)
        rev_idx = np.flatnonzero(is_best)[::-1]
        first_best[group_of[rev_idx]] = rev_idx
        zero_rep = core["r_ids"][first_best].astype(np.uint32)
    r_exact_keys, r_exact_vals = build_hash_u64(
        rk, np.stack([rk_start, rk_count, zero_rep], axis=1))

    # R prefix: (c2..c18) = rkey & mask_rpref -> range into r_ids
    rp_all = r_rkey_sorted & mask_rpref
    changep = np.ones(rp_all.shape[0], dtype=bool)
    if rp_all.shape[0]:
        changep[1:] = rp_all[1:] != rp_all[:-1]
    rp_start = np.flatnonzero(changep).astype(np.uint32)
    rp = rp_all[rp_start.astype(np.int64)]
    rp_count = np.diff(
        np.append(rp_start, rp_all.shape[0])).astype(np.uint32)
    r_pref_keys, r_pref_vals = build_hash_u64(
        rp, np.stack([rp_start, rp_count], axis=1))

    # 19-mer membership hash: packed c0..c18 -> id of 18-mer c0..c17
    k19_keys, k19_vals = build_hash_u64(core["uk19"], core["uk19_ids"])

    # ---- bucket-scan tables: unique 19-mers grouped per 9-mer half.
    # The fast path scans a half-key's bucket applying the closed-form
    # d<=1 acceptance to each 10-char tail (seed_math.accept_tail) --
    # cheaper than the 146-probe enumeration whenever the bucket is small
    # (avg bucket = n_19mers / 2^18).
    uk19 = core["uk19"]
    # F: sorted k19 is already grouped by keyf (top 2pw bits)
    f19_keys = (uk19 >> np.uint64(2 * pw + 2)).astype(np.int64)
    f19_offsets = np.searchsorted(
        f19_keys, np.arange(half_space + 1, dtype=np.int64)).astype(
            np.uint32)
    f19_tails = (uk19 & np.uint64((1 << (2 * pw + 2)) - 1)).astype(
        np.uint32)
    f19_ids = core["uk19_ids"]
    # R: key = c10..c18 (low 2pw bits); tail word = (c9..c1 packed MSB
    # first) << 2 | c0
    keyr_all = (uk19 & np.uint64((1 << (2 * pw)) - 1)).astype(np.int64)
    c0 = (uk19 >> np.uint64(4 * pw)).astype(np.uint32)
    mid9 = ((uk19 >> np.uint64(2 * pw))
            & np.uint64((1 << (2 * pw)) - 1)).astype(
        np.int64)  # c1..c9 packed with c1 MSB
    from ..ops.seed_probe import rev_pack
    w9r = rev_pack(mid9, pw).astype(np.uint32)   # c9..c1 packed MSB first
    r19_tails_all = (w9r << np.uint32(2)) | c0
    order_r = np.argsort(keyr_all, kind="stable")
    r19_offsets = np.searchsorted(
        keyr_all[order_r], np.arange(half_space + 1, dtype=np.int64)
    ).astype(np.uint32)
    r19_tails = r19_tails_all[order_r]
    r19_ids = core["uk19_ids"][order_r]

    return IndexPart(
        kmers18=kmers18,
        pos_offsets=core["pos_offsets"],
        pos_seq=core["pos_seq"],
        pos_pos=core["pos_pos"],
        kmer_counts=core["kmer_counts"],
        f_exact_keys=f_exact_keys,
        f_exact_vals=f_exact_vals,
        f_pref_keys=f_pref_keys,
        f_pref_start=f_pref_vals[:, 0].copy(),
        f_pref_count=f_pref_vals[:, 1].copy(),
        r_ids=core["r_ids"],
        r_exact_keys=r_exact_keys,
        r_exact_start=r_exact_vals[:, 0].copy(),
        r_exact_count=r_exact_vals[:, 1].copy(),
        r_exact_zero=r_exact_vals[:, 2].copy(),
        r_pref_keys=r_pref_keys,
        r_pref_start=r_pref_vals[:, 0].copy(),
        r_pref_count=r_pref_vals[:, 1].copy(),
        k19_keys=k19_keys,
        k19_vals=k19_vals,
        f19_offsets=f19_offsets,
        f19_tails=f19_tails,
        f19_ids=f19_ids,
        r19_offsets=r19_offsets,
        r19_tails=r19_tails,
        r19_ids=r19_ids,
        seed_win_len=2 * pw,
    )


def build_index(fasta_path: str,
                interval: int = 1,
                max_pos: int = 10000,
                max_file_size_mb: float = 3072.0,
                seed_win_len: int = SEED_WIN_LEN) -> BuiltIndex:
    """Build the full index for one reference fasta (all parts).

    seed_win_len: -L, a positive even integer 8..26 (options.cpp opt_L);
    every table width derives from pw = L/2.
    """
    if seed_win_len % 2 or not (8 <= seed_win_len <= 26):
        raise ValueError("seed_win_len must be an even integer in 8..26")
    pw = seed_win_len // 2
    metas, bg, full_len, spans, enc_seqs = scan_reference(
        fasta_path, pread=seed_win_len + 1)
    total = bg.sum()
    stats = IndexStats(
        fasta_path=str(fasta_path),
        fasta_size=os.path.getsize(fasta_path),
        background_freq=bg / total,
        full_len=full_len,
        seed_win_len=seed_win_len,
        numseq=len(metas),
        sam_sq=metas,
    )

    parts: List[IndexPart] = []
    groups = _part_boundaries([m.length for m in metas], max_file_size_mb,
                              pread=seed_win_len + 1)
    for gi, group in enumerate(groups):
        core = build_part([enc_seqs[i] for i in group], interval, max_pos,
                          pw=pw)
        part = finish_part(core)
        part.start_part = spans[group[0]][0]
        part.seq_part_size = spans[group[-1]][1] - spans[group[0]][0]
        part.numseq_part = len(group)
        part.first_seq = group[0]
        parts.append(part)

    return BuiltIndex(stats=stats, parts=parts)
