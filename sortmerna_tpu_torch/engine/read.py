"""Read model: encodings, strand handling and per-read alignment state.

Mirrors the reference Read class (read.cpp/read.hpp):

* 03 encoding for index search: ambiguous chars -> 0, positions recorded
  (seqToIntStr, read.cpp:334-347)
* 04 encoding for Smith-Waterman: ambiguous chars -> 4 (flip34,
  read.cpp:379-...)
* reverse complement operates on the 03 sequence with the 0..4 complement
  table; ambiguous positions are mirrored (revIntStr read.cpp:350-357)
* read ids are "{readfile_idx}_{read_num}" (read.cpp:616-650)
* alignment bookkeeping persisted across index parts / task runs
  (toBinString/load_db, read.cpp:429-539)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..constants import COMPLEMENT4, NT_TABLE


@dataclass(slots=True)
class Alignment:
    """One accepted alignment (s_align2, ssw.hpp:44-55).

    slots=True: the align export path constructs one of these per
    accepted alignment (100K+ per large batch); slots cut both the
    per-object memory and the construction/attribute cost."""
    index_num: int
    part: int
    ref_num: int          # ordinal within the part's references buffer
    read_begin1: int
    read_end1: int
    ref_begin1: int
    ref_end1: int
    readlen: int
    score1: int
    strand: bool          # True: aligned on the forward strand
    cigar: List[int] = field(default_factory=list)   # packed len<<4|op
    # deferred traceback: (ref_window u8, read_window u8, band); CIGARs
    # for engine-produced alignments are materialized in one batched
    # native call for SURVIVORS only (run.materialize_cigars)
    tb: object = None
    # cached (miss, gap, match, idr, cov) from the batched CIGAR-stats
    # pass (reports/cigar_stats.py); calc_miss_gap_match consults this
    mgm: object = None


@dataclass
class ReadState:
    """Persistent per-read alignment state (the KVDB blob equivalent,
    read.cpp:429-462)."""
    last_index: int = 0
    last_part: int = 0
    c_yid_ycov: int = 0
    n_yid_ncov: int = 0
    n_nid_ycov: int = 0
    n_denovo: int = 0
    is_done: bool = False
    is_hit: bool = False
    is_new_hit: bool = False
    null_align_output: bool = False
    max_sw_count: int = 0
    num_alignments: int = 0
    hit_seeds: int = 0
    alignments: List[Alignment] = field(default_factory=list)
    min_index: int = 0
    max_index: int = 0
    # volatile (not persisted):
    best: int = 0


class ReadSeq:
    """Sequence views of one read (no mutation juggling: both strands are
    precomputed on demand)."""

    __slots__ = ("header", "sequence", "quality", "readfile_idx", "read_num",
                 "is_fastq", "_f03", "_amb", "_r03", "_f04", "_r04")

    def __init__(self, header: str, sequence: str,
                 quality: Optional[str], readfile_idx: int, read_num: int):
        self.header = header
        self.sequence = sequence
        self.quality = quality
        self.readfile_idx = readfile_idx
        self.read_num = read_num
        self.is_fastq = quality is not None
        self._f03 = None
        self._amb = None
        self._r03 = None
        self._f04 = None
        self._r04 = None

    @property
    def id(self) -> str:
        return f"{self.readfile_idx}_{self.read_num}"

    def __len__(self) -> int:
        return len(self.sequence)

    @property
    def seq_id(self) -> str:
        return self.header.split(" ", 1)[0].split("\t", 1)[0]

    def _encode(self):
        raw = np.frombuffer(self.sequence.encode("ascii"), dtype=np.uint8)
        enc = NT_TABLE[raw]
        self._amb = np.flatnonzero(enc == 4)
        f03 = enc.copy()
        f03[self._amb] = 0
        self._f03 = f03

    @property
    def fwd03(self) -> np.ndarray:
        if self._f03 is None:
            self._encode()
        return self._f03

    @property
    def ambiguous(self) -> np.ndarray:
        if self._amb is None:
            self._encode()
        return self._amb

    @property
    def rev03(self) -> np.ndarray:
        """Reverse complement in 03 encoding (ambiguous chars were 0 and
        complement to 3, reproducing revIntStr on the 03 string)."""
        if self._r03 is None:
            self._r03 = COMPLEMENT4[self.fwd03[::-1]]
        return self._r03

    @property
    def fwd04(self) -> np.ndarray:
        if self._f04 is None:
            f = self.fwd03.copy()
            f[self.ambiguous] = 4
            self._f04 = f
        return self._f04

    @property
    def rev04(self) -> np.ndarray:
        """Reverse strand in 04: revcomp with mirrored ambiguous -> 4
        (flip34 with reversed=True, read.cpp:384-390)."""
        if self._r04 is None:
            r = self.rev03.copy()
            if self.ambiguous.size:
                L = len(self.sequence)
                r[L - 1 - self.ambiguous] = 4
            self._r04 = r
        return self._r04

    def strand03(self, forward: bool) -> np.ndarray:
        return self.fwd03 if forward else self.rev03

    def strand04(self, forward: bool) -> np.ndarray:
        return self.fwd04 if forward else self.rev04


class ReadBatch:
    """Packed view of a batch of reads: one concatenated encoding buffer
    per (encoding, strand), built with bulk array ops instead of 4 x N
    per-read property calls.  The hot align path (traverse_strand +
    the native candidate engine) reads exclusively from here; ReadSeq
    objects stay authoritative for reports/REPL.

    Encodings follow read.cpp: 03 has ambiguous chars as 0 (positions
    kept), 04 as 4; the reverse strand is the complement of the reversed
    03 string with ambiguous positions mirrored (revIntStr read.cpp:350,
    flip34 read.cpp:379)."""

    __slots__ = ("n", "lens", "offs", "fwd03", "amb",
                 "_rev03", "_fwd04", "_rev04", "_fr04", "_revperm")

    def __init__(self, reads: List["ReadSeq"]):
        n = len(reads)
        lens = np.fromiter((len(r) for r in reads), np.int64, count=n)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        joined = "".join(r.sequence for r in reads)
        raw = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)
        self._init_from(raw, offs, lens)

    @classmethod
    def from_packed(cls, data_u8: np.ndarray, offs: np.ndarray
                    ) -> "ReadBatch":
        """Build directly from a packed (ascii bytes, offsets) slice
        (io/feed.py ReadFeed.packed_slice) -- no per-read objects."""
        self = object.__new__(cls)
        offs = np.ascontiguousarray(offs, dtype=np.int64)
        self._init_from(np.asarray(data_u8), offs, np.diff(offs))
        return self

    def _init_from(self, raw: np.ndarray, offs: np.ndarray,
                   lens: np.ndarray) -> None:
        self.n = len(offs) - 1
        self.lens = lens
        self.offs = offs
        enc = NT_TABLE[raw]
        self.amb = np.flatnonzero(enc == 4)
        enc[self.amb] = 0
        self.fwd03 = enc
        self._rev03 = None
        self._fwd04 = None
        self._rev04 = None
        self._fr04 = None
        self._revperm = None

    def ensure_strands(self) -> None:
        """Fill all strand-encoding caches in one native pass
        (native/feed_scan.cpp batch_strands) -- avoids three large
        numpy passes plus the materialized reverse permutation.  Falls
        back to the lazy numpy properties without the native lib."""
        if (self._rev03 is not None and self._fwd04 is not None
                and self._rev04 is not None):
            return
        from .. import native
        lib = native.get_lib()
        if lib is None:
            self.concat03(False)
            self.concat04(True)
            self.concat04(False)
            return
        total = int(self.offs[-1])
        rev03 = np.empty(total, np.uint8)
        # both 04 strands back onto ONE allocation (fwd = [:total],
        # rev = [total:]): SW jobs of either strand can then address a
        # shared buffer (q_off + total for reverse), which lets the
        # overlap scheduler concatenate waves ACROSS strands into one
        # device call
        fr04 = np.empty(2 * total, np.uint8)
        fwd04 = fr04[:total]
        rev04 = fr04[total:]
        fwd03 = np.ascontiguousarray(self.fwd03)
        offs = np.ascontiguousarray(self.offs, np.int64)
        amb = np.ascontiguousarray(self.amb, np.int64)
        lib.batch_strands(fwd03.ctypes.data, offs.ctypes.data, self.n,
                          amb.ctypes.data, len(amb),
                          rev03.ctypes.data, fwd04.ctypes.data,
                          rev04.ctypes.data)
        self._rev03, self._fwd04, self._rev04 = rev03, fwd04, rev04
        self._fr04 = fr04

    @property
    def revperm(self) -> np.ndarray:
        """Permutation reversing every read segment in place:
        perm[g] = offs[i] + offs[i+1] - 1 - g for g in read i."""
        if self._revperm is None:
            ends = np.repeat(self.offs[:-1] + self.offs[1:] - 1, self.lens)
            self._revperm = ends - np.arange(int(self.offs[-1]),
                                             dtype=np.int64)
        return self._revperm

    def concat03(self, forward: bool) -> np.ndarray:
        if forward:
            return self.fwd03
        if self._rev03 is None:
            self._rev03 = COMPLEMENT4[self.fwd03[self.revperm]]
        return self._rev03

    def concat04(self, forward: bool) -> np.ndarray:
        if forward:
            if self._fwd04 is None:
                f = self.fwd03.copy()
                f[self.amb] = 4
                self._fwd04 = f
            return self._fwd04
        if self._rev04 is None:
            r = self.concat03(False).copy()
            if self.amb.size:
                r[self.revperm[self.amb]] = 4
            self._rev04 = r
        return self._rev04

    @property
    def fr04(self) -> np.ndarray:
        """Both 04 strand encodings in one contiguous buffer
        (forward at [:total], reverse at [total:]) -- the shared
        q_data for cross-strand SW wave grouping.  ensure_strands'
        native path builds the 04 caches directly as views of this
        buffer; the numpy fallback assembles it on first use."""
        if self._fr04 is None:
            total = int(self.offs[-1])
            buf = np.empty(2 * total, np.uint8)
            buf[:total] = self.concat04(True)
            buf[total:] = self.concat04(False)
            self._fr04 = buf
            self._fwd04 = buf[:total]
            self._rev04 = buf[total:]
        return self._fr04
