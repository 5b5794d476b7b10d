"""FASTA/FASTQ readers and writers with transparent gzip support.

Capabilities mirrored from the reference reads feed (readfeed.cpp):

* format sniffing (gzip magic + first record char), readfeed.cpp:1393-1471
* reads are identified as ``"{readfile_idx}_{read_num}"`` (read.cpp:616-650)
* record iteration skips blank lines; FASTA sequences may span multiple
  lines; FASTQ records are strictly 4 lines in reads files.

The readers here are plain Python generators; the engine consumes them in
large batches so the per-record overhead is amortized.  A native (C++)
chunked feeder can replace this layer without changing call sites.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple


GZIP_MAGIC = b"\x1f\x8b"


@dataclass
class FastxRecord:
    header: str          # full header line without the leading '>' or '@'
    sequence: str
    quality: Optional[str] = None   # None for FASTA

    @property
    def is_fastq(self) -> bool:
        return self.quality is not None

    @property
    def seq_id(self) -> str:
        """Header up to the first whitespace (read.cpp getSeqId:371-377)."""
        return self.header.split(" ", 1)[0].split("\t", 1)[0]


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == GZIP_MAGIC


def open_maybe_gzip(path: str, mode: str = "rt"):
    if "r" in mode and is_gzip(path):
        return gzip.open(path, mode)
    if "w" in mode and str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def sniff_format(path: str) -> Tuple[bool, bool]:
    """Return (is_fastq, is_gzipped) by peeking at the first record char.

    Mirrors Readfeed::define_format (readfeed.cpp:1393-1471).
    """
    zipped = is_gzip(path)
    opener = gzip.open if zipped else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line[0] == "@":
                return True, zipped
            if line[0] == ">":
                return False, zipped
            raise ValueError(
                f"{path}: first record does not start with '>' or '@'")
    raise ValueError(f"{path}: empty file")


def iter_fastx(path: str) -> Iterator[FastxRecord]:
    """Iterate records from a FASTA or FASTQ file (optionally gzipped)."""
    is_fastq, _ = sniff_format(path)
    with open_maybe_gzip(path, "rt") as f:
        if is_fastq:
            yield from _iter_fastq(f)
        else:
            yield from _iter_fasta(f)


def _iter_fasta(f) -> Iterator[FastxRecord]:
    header = None
    seq_parts: List[str] = []
    for line in f:
        line = line.rstrip("\r\n")
        if not line:
            continue
        if line[0] == ">":
            if header is not None:
                yield FastxRecord(header, "".join(seq_parts))
            header = line[1:]
            seq_parts = []
        else:
            seq_parts.append(line.replace(" ", ""))
    if header is not None:
        yield FastxRecord(header, "".join(seq_parts))


def _iter_fastq(f) -> Iterator[FastxRecord]:
    while True:
        header = f.readline()
        if not header:
            return
        header = header.rstrip("\r\n")
        if not header:
            continue
        if header[0] != "@":
            raise ValueError(f"malformed FASTQ header: {header!r}")
        seq = f.readline().rstrip("\r\n")
        plus = f.readline()
        if not plus.startswith("+"):
            raise ValueError("malformed FASTQ record: missing '+' line")
        qual = f.readline().rstrip("\r\n")
        yield FastxRecord(header[1:], seq, qual)


def count_reads(path: str) -> Tuple[int, int, int, int]:
    """Single pass over a reads file.

    Returns (num_reads, total_len, min_len, max_len) -- the statistics the
    reference collects in Readfeed::count_reads_parallel
    (readfeed.cpp:1486-1663) feeding Readstats/Gumbel.
    """
    n = 0
    total = 0
    mn = 1 << 62
    mx = 0
    for rec in iter_fastx(path):
        n += 1
        l = len(rec.sequence)
        total += l
        mn = min(mn, l)
        mx = max(mx, l)
    if n == 0:
        mn = 0
    return n, total, mn, mx


def format_record(rec: FastxRecord) -> str:
    if rec.is_fastq:
        return f"@{rec.header}\n{rec.sequence}\n+\n{rec.quality}\n"
    return f">{rec.header}\n{rec.sequence}\n"


class FastxWriter:
    """Buffered fasta/fastq writer, optionally gzipped (report.cpp:44-54)."""

    def __init__(self, path: str, zip_out: bool = False):
        self.path = str(path) + (".gz" if zip_out and not str(path).endswith(".gz") else "")
        self.zip_out = zip_out
        if zip_out:
            self._f = gzip.open(self.path, "wt")
        else:
            self._f = open(self.path, "wt")

    def write_record(self, rec: FastxRecord) -> None:
        self._f.write(format_record(rec))

    def write(self, s: str) -> None:
        self._f.write(s)

    def close(self) -> None:
        self._f.close()
