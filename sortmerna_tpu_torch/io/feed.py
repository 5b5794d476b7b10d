"""Streaming reads feed: block-scanned parse into packed array caches.

The reference's Readfeed (readfeed.cpp, 1975 LoC) gives each worker
thread a record-aligned byte range of the input and re-seeks those
ranges for every index part (build_chunk_offsets readfeed.cpp:1104-1282,
rewind_in :911).  The TPU-native equivalent is shaped around batched
array processing instead of per-thread getline loops:

* one streaming pass per input file parses records with VECTORIZED
  newline scanning over ~64 MB decompressed blocks (numpy, C speed) and
  writes a packed cache: concatenated sequence/header/quality bytes +
  int64 offsets, as .npy files under workdir/readb;
* gzip inflation uses zlib's C decompressor (GIL-released), with files
  decompressed in parallel threads (the rapidgzip-equivalent capability,
  readfeed.cpp:1138-1142, bounded by host core count);
* every later consumer (align batches, report passes, rewinds across
  index parts) mmaps the cache and slices packed batches directly --
  a "rewind" is just re-slicing, no re-parse, no per-read objects.

Read identity and ordering follow the reference: ids are
``{file_idx}_{read_num}`` and paired files interleave fwd/rev
(processor.cpp:161).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .fastx import sniff_format
from ..engine.read import ReadSeq

_BLOCK = 64 << 20
_NL = 10
_CR = 13


# ---------------------------------------------------------------------------
# block-wise decompressed byte stream


def _iter_blocks(path: str, zipped: bool) -> Iterator[bytes]:
    with open(path, "rb") as f:
        if not zipped:
            while True:
                b = f.read(_BLOCK)
                if not b:
                    return
                yield b
            return
        d = zlib.decompressobj(47)
        while True:
            raw = f.read(_BLOCK // 4)
            if not raw:
                break
            out = d.decompress(raw)
            if out:
                yield out
            # concatenated gzip members (bgzf etc.)
            while d.eof and d.unused_data:
                tail = d.unused_data
                d = zlib.decompressobj(47)
                out = d.decompress(tail)
                if out:
                    yield out
        out = d.flush()
        if out:
            yield out


def _prefetch_blocks(it: Iterator[bytes], depth: int = 4
                     ) -> Iterator[bytes]:
    """Run a block iterator in a producer thread with a bounded queue.

    For a gzipped file this pipelines zlib inflation (C code, GIL
    released) against the numpy record scan in the consumer -- the
    single-large-.gz analogue of the reference's parallel decompressor
    (readfeed.cpp:1138-1142) on a 2-core host: decompress and parse run
    on separate cores instead of alternating on one."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for b in it:
                q.put(b)
            q.put(_END)
        except BaseException as e:   # surfaced in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


# ---------------------------------------------------------------------------
# vectorized record scanners
#
# Both scanners consume a block that STARTS at a record boundary and
# return (parsed arrays, bytes consumed).  The caller carries the
# unconsumed tail into the next block.


class _Acc:
    """Append-only packed accumulator (bytes + per-record lengths)."""

    def __init__(self):
        self.bufs: List[np.ndarray] = []
        self.lens: List[np.ndarray] = []

    def add(self, data: np.ndarray, lens: np.ndarray):
        self.bufs.append(data)
        self.lens.append(lens)

    def concat(self) -> Tuple[np.ndarray, np.ndarray]:
        data = (np.concatenate(self.bufs) if self.bufs
                else np.zeros(0, np.uint8))
        lens = (np.concatenate(self.lens) if self.lens
                else np.zeros(0, np.int64))
        offs = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        return data, offs


def _gather_ranges(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray
                   ) -> np.ndarray:
    """Concatenate buf[starts[i]:starts[i]+lens[i]] for all i.

    Ranges are sorted and non-overlapping (line spans), so a +1/-1
    boundary diff + cumsum yields a keep-mask in O(len(buf)); the boolean
    gather is a single SIMD pass (~5x faster than index-array gathers)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.uint8)
    d = np.zeros(len(buf) + 1, dtype=np.int8)
    d[starts] += 1          # starts are distinct
    d[starts + lens] -= 1   # ends are distinct (may coincide with starts)
    mask = np.cumsum(d[:-1], dtype=np.int8).view(bool)
    return buf[mask]


def _line_table(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """(starts, ends, nl_pos) of complete lines in buf; ends exclude
    trailing \\r."""
    nl = np.flatnonzero(buf == _NL)
    starts = np.empty(len(nl), dtype=np.int64)
    if len(nl):
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
    ends = nl.copy()
    if len(nl):
        has_cr = ends > starts
        cr = np.zeros(len(nl), dtype=bool)
        cr[has_cr] = buf[ends[has_cr] - 1] == _CR
        ends[cr] -= 1
    return starts, ends, nl


def _nonempty_lines(buf: np.ndarray):
    """Line table with blank lines dropped (the reference's readers skip
    them, fastx.py _iter_fasta/_iter_fastq)."""
    starts, ends, nl = _line_table(buf)
    keep = ends > starts
    return starts[keep], ends[keep], nl[keep]


def _scan_fastq(buf: np.ndarray):
    """Parse complete 4-line records from buf.  Returns
    (hdr_data, hdr_lens, seq_data, seq_lens, qual_data, qual_lens,
    consumed_bytes)."""
    starts, ends, nl = _nonempty_lines(buf)
    nrec = len(nl) // 4
    if nrec == 0:
        return None
    consumed = int(nl[nrec * 4 - 1]) + 1
    s = starts[:nrec * 4].reshape(nrec, 4)
    e = ends[:nrec * 4].reshape(nrec, 4)
    if not (buf[s[:, 0]] == ord("@")).all():
        raise ValueError("malformed FASTQ: header line not starting '@'")
    if not (buf[s[:, 2]] == ord("+")).all():
        raise ValueError("malformed FASTQ record: missing '+' line")
    hdr = _gather_ranges(buf, s[:, 0] + 1, e[:, 0] - s[:, 0] - 1)
    seq = _gather_ranges(buf, s[:, 1], e[:, 1] - s[:, 1])
    qual = _gather_ranges(buf, s[:, 3], e[:, 3] - s[:, 3])
    return (hdr, (e[:, 0] - s[:, 0] - 1), seq, (e[:, 1] - s[:, 1]),
            qual, (e[:, 3] - s[:, 3]), consumed)


def _scan_fasta(buf: np.ndarray, final: bool):
    """Parse complete records (header + following sequence lines).

    The last record is only complete when ``final``; otherwise it is
    left for the carry tail.  Returns (hdr_data, hdr_lens, seq_data,
    seq_lens, consumed)."""
    starts, ends, nl = _nonempty_lines(buf)
    if len(nl) == 0:
        return None
    is_hdr = buf[starts] == ord(">")
    hdr_idx = np.flatnonzero(is_hdr)
    if len(hdr_idx) == 0:
        raise ValueError("malformed FASTA: no '>' header line")
    if hdr_idx[0] != 0:
        raise ValueError("malformed FASTA: data before first header")
    if final:
        nrec = len(hdr_idx)
        last_line = len(nl)             # exclusive
        consumed = int(nl[-1]) + 1
    else:
        nrec = len(hdr_idx) - 1
        if nrec == 0:
            return None
        last_line = int(hdr_idx[nrec])
        consumed = int(starts[hdr_idx[nrec]])
    hs, he = starts[hdr_idx[:nrec]], ends[hdr_idx[:nrec]]
    hdr = _gather_ranges(buf, hs + 1, he - hs - 1)
    hdr_lens = he - hs - 1
    # sequence lines: non-header lines before last_line, attributed to
    # the most recent header
    line_rec = np.cumsum(is_hdr[:last_line]) - 1
    li = np.flatnonzero(~is_hdr[:last_line])
    line_lens = ends[li] - starts[li]
    sdat = _gather_ranges(buf, starts[li], line_lens)
    if sdat.size and (sdat == ord(" ")).any():
        keep = sdat != ord(" ")
        seg = np.repeat(np.arange(len(li)), line_lens)
        line_lens = np.bincount(seg[keep], minlength=len(li)).astype(
            np.int64)
        sdat = sdat[keep]
    seq_lens = np.bincount(line_rec[li], weights=line_lens,
                           minlength=nrec).astype(np.int64)
    return hdr, hdr_lens, sdat, seq_lens, consumed


def _scan_fasta_native(buf: np.ndarray, final: bool, lib):
    """C++ single-pass scanner (native/feed_scan.cpp); same contract as
    _scan_fasta (tests assert identical cache bytes)."""
    n = len(buf)
    cap = n // 2 + 2
    seq_out = np.empty(n, np.uint8)
    hdr_out = np.empty(n, np.uint8)
    seq_len = np.empty(cap, np.int64)
    hdr_len = np.empty(cap, np.int64)
    counts = np.zeros(3, np.int64)
    buf = np.ascontiguousarray(buf)
    consumed = lib.feed_scan_fasta(
        buf.ctypes.data, n, int(final),
        seq_out.ctypes.data, seq_len.ctypes.data,
        hdr_out.ctypes.data, hdr_len.ctypes.data, counts.ctypes.data)
    if consumed == -1:
        raise ValueError("malformed FASTA: data before first header")
    if consumed < 0:
        raise ValueError("malformed FASTA block")
    nrec = int(counts[0])
    if nrec == 0:
        return None
    return (hdr_out[:counts[2]].copy(), hdr_len[:nrec].copy(),
            seq_out[:counts[1]].copy(), seq_len[:nrec].copy(),
            int(consumed))


def _scan_fastq_native(buf: np.ndarray, lib):
    """C++ single-pass FASTQ scanner; same contract as _scan_fastq."""
    n = len(buf)
    cap = n // 4 + 2
    seq_out = np.empty(n, np.uint8)
    hdr_out = np.empty(n, np.uint8)
    qual_out = np.empty(n, np.uint8)
    seq_len = np.empty(cap, np.int64)
    hdr_len = np.empty(cap, np.int64)
    qual_len = np.empty(cap, np.int64)
    counts = np.zeros(4, np.int64)
    buf = np.ascontiguousarray(buf)
    consumed = lib.feed_scan_fastq(
        buf.ctypes.data, n,
        seq_out.ctypes.data, seq_len.ctypes.data,
        hdr_out.ctypes.data, hdr_len.ctypes.data,
        qual_out.ctypes.data, qual_len.ctypes.data, counts.ctypes.data)
    if consumed == -2:
        raise ValueError("malformed FASTQ: header line not starting '@'")
    if consumed == -3:
        raise ValueError("malformed FASTQ record: missing '+' line")
    if consumed < 0:
        raise ValueError("malformed FASTQ block")
    nrec = int(counts[0])
    if nrec == 0:
        return None
    return (hdr_out[:counts[2]].copy(), hdr_len[:nrec].copy(),
            seq_out[:counts[1]].copy(), seq_len[:nrec].copy(),
            qual_out[:counts[3]].copy(), qual_len[:nrec].copy(),
            int(consumed))


# ---------------------------------------------------------------------------
# per-file packed cache


_CACHE_FIELDS = ("seq", "seq_off", "hdr", "hdr_off", "qual", "qual_off")


class PackedReadsFile:
    """Packed arrays of one reads file (mmap-backed after build)."""

    def __init__(self, cache_dir: str, src_path: str, file_idx: int):
        self.src = src_path
        self.dir = os.path.join(cache_dir, "f%d" % file_idx)
        self.meta: dict = {}
        self.seq = self.seq_off = None
        self.hdr = self.hdr_off = None
        self.qual = self.qual_off = None

    # -- build ---------------------------------------------------------

    def _meta_path(self):
        return os.path.join(self.dir, "meta.json")

    def is_valid(self) -> bool:
        mp = self._meta_path()
        if not os.path.exists(mp):
            return False
        try:
            with open(mp) as f:
                meta = json.load(f)
            st = os.stat(self.src)
            return (meta.get("src_size") == st.st_size
                    and meta.get("src_mtime") == st.st_mtime_ns)
        except (OSError, ValueError):
            return False

    def build(self) -> None:
        is_fastq, zipped = sniff_format(self.src)
        os.makedirs(self.dir, exist_ok=True)
        from .. import native
        lib = native.get_lib()
        if lib is not None and os.environ.get("SMR_FEED_NUMPY"):
            lib = None           # test hook: force the numpy scanners
        hdr_acc, seq_acc, qual_acc = _Acc(), _Acc(), _Acc()
        tail = b""
        blocks = _prefetch_blocks(_iter_blocks(self.src, zipped))
        done = False
        while not done:
            chunk = next(blocks, None)
            if chunk is None:
                done = True
                if not tail:
                    break
                buf = np.frombuffer(tail, dtype=np.uint8)
                if buf.size and buf[-1] != _NL:      # unterminated line
                    buf = np.concatenate(
                        [buf, np.array([_NL], np.uint8)])
            else:
                data = tail + chunk if tail else chunk
                buf = np.frombuffer(data, dtype=np.uint8)
            if is_fastq:
                got = (_scan_fastq_native(buf, lib) if lib is not None
                       else _scan_fastq(buf))
                if got is None:
                    tail = buf.tobytes()
                    continue
                h, hl, s, sl, q, ql, consumed = got
                qual_acc.add(q, ql)
            else:
                got = (_scan_fasta_native(buf, done, lib)
                       if lib is not None else _scan_fasta(buf, final=done))
                if got is None:
                    tail = buf.tobytes()
                    continue
                h, hl, s, sl, consumed = got
            hdr_acc.add(h, hl)
            seq_acc.add(s, sl)
            tail = buf[consumed:].tobytes()
        if tail.strip():
            raise ValueError(f"{self.src}: trailing unparsed data")

        seq, seq_off = seq_acc.concat()
        hdr, hdr_off = hdr_acc.concat()
        np.save(os.path.join(self.dir, "seq.npy"), seq)
        np.save(os.path.join(self.dir, "seq_off.npy"), seq_off)
        np.save(os.path.join(self.dir, "hdr.npy"), hdr)
        np.save(os.path.join(self.dir, "hdr_off.npy"), hdr_off)
        if is_fastq:
            qual, qual_off = qual_acc.concat()
            np.save(os.path.join(self.dir, "qual.npy"), qual)
            np.save(os.path.join(self.dir, "qual_off.npy"), qual_off)
        lens = np.diff(seq_off)
        st = os.stat(self.src)
        self.meta = {
            "src": self.src, "src_size": st.st_size,
            "src_mtime": st.st_mtime_ns,
            "is_fastq": is_fastq, "zipped": zipped,
            "n": int(len(lens)),
            "total_len": int(lens.sum()) if len(lens) else 0,
            "min_len": int(lens.min()) if len(lens) else 0,
            "max_len": int(lens.max()) if len(lens) else 0,
        }
        with open(self._meta_path(), "w") as f:
            json.dump(self.meta, f)

    def load(self) -> None:
        with open(self._meta_path()) as f:
            self.meta = json.load(f)
        # np.asarray strips the np.memmap subclass into a plain ndarray
        # VIEW over the same mapping (no copy; pages stay lazy): memmap
        # slicing pays ~2.7us of subclass __array_finalize__ per access,
        # which dominated the report sweeps (800K+ slices per 100K
        # reads)
        mm = lambda name: np.asarray(np.load(
            os.path.join(self.dir, name), mmap_mode="r"))
        self.seq = mm("seq.npy")
        self.seq_off = mm("seq_off.npy")
        self.hdr = mm("hdr.npy")
        self.hdr_off = mm("hdr_off.npy")
        if self.meta["is_fastq"]:
            self.qual = mm("qual.npy")
            self.qual_off = mm("qual_off.npy")

    # -- access --------------------------------------------------------

    @property
    def n(self) -> int:
        return self.meta["n"]

    def record(self, i: int, file_idx: int) -> ReadSeq:
        h = bytes(self.hdr[self.hdr_off[i]:self.hdr_off[i + 1]]).decode(
            "ascii")
        s = bytes(self.seq[self.seq_off[i]:self.seq_off[i + 1]]).decode(
            "ascii")
        q = None
        if self.qual is not None:
            q = bytes(self.qual[self.qual_off[i]:self.qual_off[i + 1]]
                      ).decode("ascii")
        return ReadSeq(h, s, q, file_idx, i)


class ReadFeed:
    """All reads files of a run, in the reference's processing order
    (paired files interleaved fwd/rev)."""

    def __init__(self, reads_files: Sequence[str], cache_dir: str,
                 threads: int = 2):
        self.files = [PackedReadsFile(cache_dir, p, i)
                      for i, p in enumerate(reads_files)]
        build = [pf for pf in self.files if not pf.is_valid()]
        if build:
            if threads > 1 and len(build) > 1:
                errs: List[BaseException] = []

                def worker(pf):
                    try:
                        pf.build()
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)
                ts = [threading.Thread(target=worker, args=(pf,))
                      for pf in build]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                if errs:
                    raise errs[0]
            else:
                for pf in build:
                    pf.build()
        for pf in self.files:
            pf.load()
        self.paired = len(self.files) == 2
        if self.paired and self.files[0].n != self.files[1].n:
            raise ValueError("paired reads files have different counts")
        self.n = sum(pf.n for pf in self.files)

    # -- stats ----------------------------------------------------------

    @property
    def total_len(self) -> int:
        return sum(pf.meta["total_len"] for pf in self.files)

    @property
    def min_len(self) -> int:
        return min((pf.meta["min_len"] for pf in self.files
                    if pf.n), default=0)

    @property
    def max_len(self) -> int:
        return max((pf.meta["max_len"] for pf in self.files
                    if pf.n), default=0)

    # -- access ----------------------------------------------------------

    def loc(self, g: int) -> Tuple[int, int]:
        """global ordinal -> (file_idx, read_num)."""
        if self.paired:
            return g & 1, g >> 1
        return 0, g

    def readseq(self, g: int) -> ReadSeq:
        fi, num = self.loc(g)
        return self.files[fi].record(num, fi)

    def packed_slice(self, lo: int, hi: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(seq_bytes_concat, offsets) for global range [lo, hi)."""
        if not self.paired:
            pf = self.files[0]
            o = pf.seq_off
            data = np.asarray(pf.seq[o[lo]:o[hi]])
            offs = (o[lo:hi + 1] - o[lo]).astype(np.int64)
            return data, offs
        # interleaved: rows lo..hi over two caches
        g = np.arange(lo, hi, dtype=np.int64)
        fi = (g & 1).astype(np.int64)
        num = g >> 1
        offA, offB = self.files[0].seq_off, self.files[1].seq_off
        starts = np.where(fi == 0, offA[num], offB[num])
        lens = np.where(fi == 0, offA[num + 1], offB[num + 1]) - starts
        offs = np.zeros(len(g) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        total = int(offs[-1])
        data = np.empty(total, dtype=np.uint8)
        idx = np.repeat(starts, lens) + (
            np.arange(total, dtype=np.int64)
            - np.repeat(offs[:-1], lens))
        a_mask = np.repeat(fi == 0, lens)
        data[a_mask] = np.asarray(self.files[0].seq)[idx[a_mask]]
        data[~a_mask] = np.asarray(self.files[1].seq)[idx[~a_mask]]
        return data, offs


class LazyReads(Sequence):
    """List-like view over a ReadFeed materializing ReadSeq on demand.

    Slicing returns another LazyReads view (no materialization);
    __getitem__ builds one ReadSeq from the packed cache.  Callers on
    the hot path use the packed arrays (ReadFeed.packed_slice) instead."""

    def __init__(self, feed: ReadFeed, lo: int = 0,
                 hi: Optional[int] = None):
        self.feed = feed
        self.lo = lo
        self.hi = feed.n if hi is None else hi

    def __len__(self) -> int:
        return self.hi - self.lo

    def packed_slice(self, lo: int, hi: int):
        """Packed (bytes, offsets) of view-relative range [lo, hi)."""
        return self.feed.packed_slice(self.lo + lo,
                                      min(self.lo + hi, self.hi))

    def ids(self) -> List[str]:
        """All read ids ('{file_idx}_{read_num}', read.cpp:616-650)
        without materializing ReadSeq objects."""
        loc = self.feed.loc
        return ["%d_%d" % loc(g) for g in range(self.lo, self.hi)]

    def __getitem__(self, i):
        n = self.hi - self.lo
        if isinstance(i, slice):
            start, stop, step = i.indices(n)
            if step != 1:
                return [self.feed.readseq(self.lo + g)
                        for g in range(start, stop, step)]
            return LazyReads(self.feed, self.lo + start, self.lo + stop)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self.feed.readseq(self.lo + i)


class CachedReads(Sequence):
    """Memoizing wrapper over a reads sequence for the REPORT phase.

    The postprocess + report passes sweep the reads ~5x (fastx,
    blast/sam per part, denovo per part, otu per part); LazyReads
    materializes a fresh ReadSeq -- and re-derives its lazy encodings
    -- on every access.  Caching per ordinal keeps one object alive
    across all sweeps so headers/sequences decode once and the 03/04
    encodings compute once.  Memory is ~1KB/read touched, so callers
    gate this on read count (engine.run._report_reads)."""

    def __init__(self, inner):
        self.inner = inner
        self._cache = [None] * len(inner)

    def __len__(self) -> int:
        return len(self.inner)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        v = self._cache[i]
        if v is None:
            v = self._cache[i] = self.inner[i]
        return v
