"""Index artifact persistence: the '.kmer/.bursttrie/.pos/.stats' file
family of the reference (indexdb.cpp:1939-2084) replaced by one .npz per
part plus a JSON stats sidecar.

Artifacts live in workdir/idx and are keyed by the reference fasta path
hash + build parameters (the reference derives file names from a hash of
the fasta path, util.cpp:216-220 / index.cpp:76).  Beside each part
directory ``<key>.part<i>`` lies ``<key>.refs<i>``: the part's reference
sequences in the alignment encoding, written by the first job that reads
them and mapped by every later one (``part_refs``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import mmap
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from .builder import BuiltIndex, IndexPart, IndexStats, RefSeqMeta, \
    build_index

_PART_FIELDS = [f.name for f in dataclasses.fields(IndexPart)
                if f.name not in ("start_part", "seq_part_size",
                                  "numseq_part", "first_seq")]


def index_key(fasta_path: str, interval: int, max_pos: int,
              max_file_size_mb: float, seed_win_len: int = 18) -> str:
    """Artifact cache key.  BUMP the version tag below whenever the
    on-disk layout changes (_PART_FIELDS, array dtypes, meta schema):
    the test suite shares a PERSISTENT cache dir across sessions
    (tests/conftest.py _shared_index_cache), so a layout change without
    a version bump would load stale artifacts."""
    st = os.stat(fasta_path)
    h = hashlib.sha1()
    h.update(str(os.path.abspath(fasta_path)).encode())
    h.update(f"{st.st_size}:{st.st_mtime_ns}:{interval}:{max_pos}:"
             f"{max_file_size_mb}:{seed_win_len}:v3".encode())
    return h.hexdigest()[:16]


def save_index(built: BuiltIndex, idx_dir: str, key: str) -> None:
    """Persist the dense index.  Write order makes concurrent/crashed
    writers safe: part dirs are written under temp names and renamed,
    and the ``.stats.json`` that GATES loading lands last via an atomic
    replace -- a reader either sees a complete artifact or none, and
    two processes building the same key race benignly (identical
    content; the rename loser discards its copy)."""
    os.makedirs(idx_dir, exist_ok=True)
    stats = built.stats
    meta = {
        "fasta_path": stats.fasta_path,
        "fasta_size": stats.fasta_size,
        "background_freq": stats.background_freq.tolist(),
        "full_len": stats.full_len,
        "seed_win_len": stats.seed_win_len,
        "numseq": stats.numseq,
        "sam_sq": [[m.header, m.length] for m in stats.sam_sq],
        "num_parts": len(built.parts),
        "parts_meta": [[p.start_part, p.seq_part_size, p.numseq_part,
                        p.first_seq] for p in built.parts],
    }
    for i, p in enumerate(built.parts):
        pdir = os.path.join(idx_dir, f"{key}.part{i}")
        if os.path.isdir(pdir):
            continue                      # another writer finished it
        tmp = f"{pdir}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        # one .npy per array, mmap-loadable (np.load of .npz decompresses
        # through zipfile and is ~50x slower for GB-scale indexes)
        for name in _PART_FIELDS:
            np.save(os.path.join(tmp, name + ".npy"), getattr(p, name))
        try:
            os.rename(tmp, pdir)
        except OSError:                   # lost the race; same content
            shutil.rmtree(tmp, ignore_errors=True)
    tmp_stats = os.path.join(idx_dir, f"{key}.stats.json.{os.getpid()}")
    with open(tmp_stats, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_stats, os.path.join(idx_dir, f"{key}.stats.json"))


def load_index(idx_dir: str, key: str) -> Optional[BuiltIndex]:
    stats_path = os.path.join(idx_dir, f"{key}.stats.json")
    if not os.path.exists(stats_path):
        return None
    with open(stats_path) as f:
        meta = json.load(f)
    stats = IndexStats(
        fasta_path=meta["fasta_path"],
        fasta_size=meta["fasta_size"],
        background_freq=np.asarray(meta["background_freq"]),
        full_len=meta["full_len"],
        seed_win_len=meta["seed_win_len"],
        numseq=meta["numseq"],
        sam_sq=[RefSeqMeta(h, l) for h, l in meta["sam_sq"]],
    )
    parts: List[IndexPart] = []
    for i in range(meta["num_parts"]):
        pdir = os.path.join(idx_dir, f"{key}.part{i}")
        if not os.path.isdir(pdir):
            return None
        kw = {}
        for name in _PART_FIELDS:
            f = os.path.join(pdir, name + ".npy")
            if not os.path.exists(f):
                return None
            kw[name] = np.load(f, mmap_mode="r")
        part = IndexPart(**kw)
        (part.start_part, part.seq_part_size, part.numseq_part,
         part.first_seq) = meta["parts_meta"][i]
        part.seed_win_len = meta["seed_win_len"]
        parts.append(part)
    return BuiltIndex(stats=stats, parts=parts)


def release_pages(part: IndexPart) -> None:
    """Drop a mapped part's pages from the process's resident set once
    its pass is done.  The file's pages stay in the page cache and a
    later read faults them back in, so nothing changes but the memory
    held: a job over several databases holds the pages of the part it
    searches, as sortmerna holds one index part at a time, not those of
    every part searched before.  Arrays not mapped from disk are left
    as they are."""
    for name in _PART_FIELDS:
        m = getattr(getattr(part, name), "_mmap", None)
        if m is not None:
            m.madvise(mmap.MADV_DONTNEED)


class PartRefs:
    """One index part's reference sequences in the alignment encoding
    (NT_TABLE: ambiguous -> 4), back to back: member ``i`` is
    ``data[off[i]:off[i + 1]]``, and ``refs[i]`` is that view.  The
    native engine takes ``data`` and ``off`` as they are; the Python
    paths index members.  ``headers`` (each member's FASTA header line
    without its '>') are read on first use: the align pass reads none."""

    __slots__ = ("data", "off", "_headers", "_headers_path", "_maps")

    def __init__(self, data: np.ndarray, off: np.ndarray,
                 headers: Optional[List[str]] = None,
                 headers_path: Optional[str] = None, maps=()):
        self.data = data
        self.off = off
        self._headers = headers
        self._headers_path = headers_path
        self._maps = maps           # the mmaps behind data and off

    @classmethod
    def from_members(cls, seqs: List[np.ndarray],
                     headers: List[str]) -> "PartRefs":
        """The flat form of ``load_part_refs``'s per-member arrays."""
        off = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, seqs), np.int64, len(seqs)),
                  out=off[1:])
        data = np.concatenate(seqs).astype(np.uint8, copy=False) \
            if seqs else np.zeros(0, np.uint8)
        return cls(data, off, headers)

    def __len__(self) -> int:
        return len(self.off) - 1

    def __getitem__(self, i) -> np.ndarray:
        return self.data[self.off[i]:self.off[i + 1]]

    @property
    def headers(self) -> List[str]:
        if self._headers is None:
            with open(self._headers_path, encoding="utf-8",
                      newline="") as f:
                self._headers = f.read().split("\n")[:-1]
        return self._headers

    @property
    def mapped(self) -> bool:
        return bool(self._maps)

    def release(self) -> None:
        """Drop mapped pages from the resident set, as ``release_pages``
        does for an index part; a later read faults them back in."""
        for m in self._maps:
            m.madvise(mmap.MADV_DONTNEED)


_REFS_FILES = ("seq.npy", "off.npy", "headers.txt")


def _map_refs(rdir: str, numseq: int) -> Optional[PartRefs]:
    """The sidecar ``rdir`` mapped, or None where it is absent, lacks a
    file or does not hold ``numseq`` members."""
    seq_p, off_p, hdr_p = (os.path.join(rdir, n) for n in _REFS_FILES)
    if not all(os.path.isfile(p) for p in (seq_p, off_p, hdr_p)):
        return None
    try:
        data = np.load(seq_p, mmap_mode="r")
        off = np.load(off_p, mmap_mode="r")
    except (OSError, ValueError, EOFError):
        return None
    if (data.dtype != np.uint8 or off.dtype != np.int64
            or off.shape != (numseq + 1,) or off[0] != 0
            or off[-1] != len(data)):
        return None
    # plain views: a slice of a memmap pays its Python __array_finalize__
    return PartRefs(np.asarray(data), np.asarray(off), headers_path=hdr_p,
                    maps=(data._mmap, off._mmap))


def _write_refs(rdir: str, refs: PartRefs) -> bool:
    """Write the sidecar as ``save_index`` writes a part: under a
    temporary name, then renamed into place, so a reader finds all of it
    or none.  A directory left there missing a file is replaced.  False
    where the index directory cannot take it."""
    tmp = f"{rdir}.tmp.{os.getpid()}"
    try:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.save(os.path.join(tmp, _REFS_FILES[0]), refs.data)
        np.save(os.path.join(tmp, _REFS_FILES[1]), refs.off)
        with open(os.path.join(tmp, _REFS_FILES[2]), "w", encoding="utf-8",
                  newline="") as f:
            f.write("".join(h + "\n" for h in refs.headers))
        shutil.rmtree(rdir, ignore_errors=True)
        os.rename(tmp, rdir)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        return os.path.isdir(rdir)      # another writer's landed first
    return True


def part_refs(opts, built: BuiltIndex, idx_num: int, part_num: int,
              held: Dict) -> PartRefs:
    """The references of part ``part_num`` of database ``idx_num``
    (``opts.ref_files[idx_num]``, indexed as ``built``), for the align
    pass or a report sweep; ``held`` keeps them for the job's later
    sweeps.

    With an index directory they are mapped from the part's sidecar
    there, ``<key>.refs<part_num>``, or parsed from the FASTA and written
    there, then mapped: the key covers the FASTA's path, size and mtime,
    so a sidecar is never stale.  A parse with no index directory to
    take it stays in memory for the job.  While spans are on each call
    counts one ``ref_parsed`` where it parsed or holds a parse, else one
    ``ref_mapped``."""
    from ..util import tally, timers_enabled
    refs = held.get((idx_num, part_num))
    parsed = False
    if refs is None:
        part = built.parts[part_num]
        fasta = opts.ref_files[idx_num]
        rdir = os.path.join(opts.idx_dir, "%s.refs%d" % (index_key(
            fasta, opts.interval, opts.max_pos, opts.max_file_size,
            opts.seed_win_len), part_num)) if opts.idx_dir else None
        if rdir is not None:
            refs = _map_refs(rdir, part.numseq_part)
        if refs is None:
            from ..engine.align import load_part_refs
            parsed = True
            refs = PartRefs.from_members(*load_part_refs(
                fasta, part.first_seq, part.numseq_part,
                start_byte=part.start_part))
            if rdir is not None and _write_refs(rdir, refs):
                # held mapped: each sweep releases its pages
                refs = _map_refs(rdir, part.numseq_part) or refs
        held[(idx_num, part_num)] = refs
    if timers_enabled():
        tally("ref_parsed" if parsed or not refs.mapped else "ref_mapped")
    return refs


def from_numpy_parts(parts: List[Dict[str, Any]], stats) -> BuiltIndex:
    """A BuiltIndex from plain arrays: one dict per part holding the
    IndexPart fields (arrays, plus the integer part metadata), and the
    IndexStats fields as a mapping (``sam_sq`` entries need ``header`` and
    ``length``).  This is how an index built by another process -- the
    JAX package's, say -- crosses over without touching disk."""
    d = dict(stats)
    stats = IndexStats(
        fasta_path=d["fasta_path"], fasta_size=int(d["fasta_size"]),
        background_freq=np.asarray(d["background_freq"]),
        full_len=int(d["full_len"]), seed_win_len=int(d["seed_win_len"]),
        numseq=int(d["numseq"]),
        sam_sq=[RefSeqMeta(m.header, m.length) for m in d["sam_sq"]])
    fields = {f.name for f in dataclasses.fields(IndexPart)}
    built = []
    for pd in parts:
        unknown = set(pd) - fields
        if unknown:
            raise ValueError(f"unknown IndexPart fields: {sorted(unknown)}")
        kw = {k: np.asarray(pd[k]) for k in _PART_FIELDS
              if k != "seed_win_len"}
        part = IndexPart(**kw)
        for k in ("start_part", "seq_part_size", "numseq_part",
                  "first_seq", "seed_win_len"):
            if k in pd:
                setattr(part, k, int(pd[k]))
        built.append(part)
    return BuiltIndex(stats=stats, parts=built)


def find_reference_artifacts(fasta_path: str,
                             idx_dir: str) -> Optional[str]:
    """Prefix of reference-format index files for this fasta in
    ``idx_dir`` (a workdir indexed by the reference binary), or None.

    The reference names its artifacts ``<string-hash>.{stats,*.dat}``
    (index.cpp:76); the ``.stats`` payload records the fasta it was
    built from, which is what we match on (basename -- workdirs move
    between machines)."""
    import glob

    from .refformat import read_stats
    base = os.path.basename(fasta_path)
    for stats_path in glob.glob(os.path.join(idx_dir, "*.stats")):
        try:
            meta = read_stats(stats_path)
        except (ValueError, IndexError, OSError, UnicodeDecodeError):
            continue
        if os.path.basename(meta.get("fasta_path", "")) == base:
            prefix = stats_path[:-len(".stats")]
            if os.path.exists(prefix + ".kmer_0.dat"):
                return prefix
    return None


def build_or_load(fasta_path: str, idx_dir: Optional[str],
                  interval: int = 1, max_pos: int = 10000,
                  max_file_size_mb: float = 3072.0,
                  seed_win_len: int = 18) -> BuiltIndex:
    if idx_dir:
        key = index_key(fasta_path, interval, max_pos, max_file_size_mb,
                        seed_win_len)
        cached = load_index(idx_dir, key)
        if cached is not None:
            return cached
        # drop-in reuse of a workdir indexed by the REFERENCE binary
        # (.kmer_N/.bursttrie_N/.pos_N/.stats, index.cpp:145-354);
        # the artifact's recorded seed length must match the run's
        ref_pfx = find_reference_artifacts(fasta_path, idx_dir)
        if ref_pfx is not None:
            from ..util import INFO
            from .refformat import read_reference_index, read_stats
            if int(read_stats(ref_pfx + ".stats")["lnwin"]) \
                    == seed_win_len:
                INFO(f"loading reference-format index {ref_pfx}.*")
                built = read_reference_index(ref_pfx)
                # cache the converted dense layout so later runs skip
                # the trie scan
                save_index(built, idx_dir, key)
                return built
    built = build_index(fasta_path, interval, max_pos, max_file_size_mb,
                        seed_win_len=seed_win_len)
    if idx_dir:
        save_index(built, idx_dir, key)
    return built
