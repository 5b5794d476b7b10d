"""Index artifact persistence: the '.kmer/.bursttrie/.pos/.stats' file
family of the reference (indexdb.cpp:1939-2084) replaced by one .npz per
part plus a JSON stats sidecar.

Artifacts live in workdir/idx and are keyed by the reference fasta path
hash + build parameters (the reference derives file names from a hash of
the fasta path, util.cpp:216-220 / index.cpp:76).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
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
            import shutil
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
